"""The port's TCN decode (plain passes on the CPU) against bonito_tpu's
Pallas TCN kernels in interpret mode and its lax.scan oracle, at
state_len 3 (S=64, R=16). Sequences and moves are identical; qstrings
may differ by one phred step (the posterior sums run in another order)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.ops import decode as jdecode
from bonito_tpu.ops import decode_pallas
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops import decode

ALPHABET = ["N", "A", "C", "G", "T"]
STATE_LEN = 3
N, T = 8, 24
QSCALE, QBIAS = 1.05, 0.2


def _moves(seed, ties=False):
    """[T, S*nb, N] f32 move scores; with ``ties`` they sit on a coarse
    grid so argmax and stay-vs-move comparisons tie often."""
    S = 4 ** STATE_LEN
    rng = np.random.default_rng(seed)
    mv = 3.0 * rng.normal(size=(T, S * 4, N))
    if ties:
        mv = np.round(mv)
    return mv.astype(np.float32)


def _assert_same(out, ref):
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    dq = (np.asarray(out["qstring"], np.int32)
          - np.asarray(ref["qstring"], np.int32))
    assert np.abs(dq).max() <= 1


def _port(out):
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("ties", [False, True])
def test_tcn_decode_matches_pallas_interpret(ties):
    mv = _moves(1 + ties, ties)
    blank = 2.0
    ref = decode_pallas.viterbi_decode_tcn(
        JaxCRF(STATE_LEN, ALPHABET), jnp.asarray(mv), blank, qscale=QSCALE,
        qbias=QBIAS, interpret=True)
    out = decode.viterbi_decode_tcn(CTC_CRF(STATE_LEN, ALPHABET),
                                    torch.from_numpy(mv), blank,
                                    qscale=QSCALE, qbias=QBIAS)
    _assert_same(_port(out), ref)
    assert 0 < np.asarray(ref["moves"]).mean() < 1  # a mix of stays/moves


@pytest.mark.parametrize("ties", [False, True])
def test_tcn_decode_matches_scan(ties):
    mv = _moves(3 + ties, ties)
    blank = 1.0 if ties else 2.0
    jsd = JaxCRF(STATE_LEN, ALPHABET)
    ref = jdecode.viterbi_decode_scan(
        jsd, jdecode.tcn_to_scores(jsd, jnp.asarray(mv), blank),
        qscale=QSCALE, qbias=QBIAS)
    out = decode.viterbi_decode_tcn(CTC_CRF(STATE_LEN, ALPHABET),
                                    torch.from_numpy(mv), blank,
                                    qscale=QSCALE, qbias=QBIAS)
    _assert_same(_port(out), ref)


def test_plain_full_scores_match_scan():
    """viterbi_decode over full scores with a stay plane that is
    not constant."""
    S = 4 ** STATE_LEN
    rng = np.random.default_rng(5)
    scores = (2.0 * rng.normal(size=(N, T, S * 5))).astype(np.float32)
    ref = jdecode.viterbi_decode_scan(JaxCRF(STATE_LEN, ALPHABET),
                                      jnp.asarray(scores), qscale=QSCALE,
                                      qbias=QBIAS)
    out = decode.viterbi_decode(CTC_CRF(STATE_LEN, ALPHABET),
                                      torch.from_numpy(scores),
                                      qscale=QSCALE, qbias=QBIAS)
    _assert_same(_port(out), ref)


def test_tcn_to_scores_matches_jax():
    mv = _moves(6)
    jsd = JaxCRF(STATE_LEN, ALPHABET)
    ref = np.asarray(jdecode.tcn_to_scores(jsd, jnp.asarray(mv), 2.0))
    out = decode.tcn_to_scores(CTC_CRF(STATE_LEN, ALPHABET),
                               torch.from_numpy(mv), 2.0)
    np.testing.assert_array_equal(out.numpy(), ref)


def test_frame_major_view_decodes_like_a_copy():
    """The decode reads [N, T, Cm] memory: a [T, Cm, N] view of it (what
    Model.forward_tcn returns) and a contiguous copy decode alike."""
    mv = torch.from_numpy(_moves(7))
    view = mv.permute(2, 0, 1).contiguous().permute(1, 2, 0)
    sd = CTC_CRF(STATE_LEN, ALPHABET)
    a = decode.viterbi_decode_tcn(sd, mv, 2.0)
    b = decode.viterbi_decode_tcn(sd, view, 2.0)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)


def test_to_str_matches_jax():
    codes = np.array([0, 1, 2, 0, 3, 4, 0], np.uint8)
    assert decode.to_str(codes) == jdecode.to_str(codes) == "ACGT"
    q = np.array([0, 40, 0, 50], np.uint8)
    assert (decode.to_str(q, qstring=True)
            == jdecode.to_str(q, qstring=True) == "(2")
