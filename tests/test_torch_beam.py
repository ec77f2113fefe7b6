"""The port's beam decode (``ops.beam_device``, plain torch as it is plain
XLA in bonito_tpu) on the CPU against bonito_tpu's ``beam_search_device``:
widths 1, 4 and 32, scores with and without ties, ``scale``/``offset`` and
the qscore calibration. Sequences and moves identical, qstrings within one
phred step (the softmax sums run in another order). The beam inside the
whole basecall: ``tests/test_torch_reverse.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.ops import decode as jdecode
from bonito_tpu.ops.beam_device import beam_search_device as jax_beam
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops.beam_device import beam_search_device

ALPHABET = ["N", "A", "C", "G", "T"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores(seed, state_len, N, T, ties):
    """Full f32 scores; with ``ties`` on a grid of integers, so that beams
    and merged hypotheses tie often."""
    rng = np.random.default_rng(seed)
    x = 3.0 * rng.normal(size=(N, T, 5 * 4 ** state_len))
    return (np.round(x) if ties else x).astype(np.float32)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("state_len,width,scale,offset", [
    (3, 1, 1.0, 0.0), (3, 4, 1.5, 0.3), (3, 32, 1.0, 0.0), (2, 32, 0.5, -0.2)])
def test_beam_matches_bonito_tpu(state_len, width, scale, offset, ties):
    x = _scores(state_len + width + ties, state_len, 6, 50, ties)
    kw = dict(beam_width=width, scale=scale, offset=offset, qscale=1.05,
              qbias=0.2)
    ref = jax_beam(JaxCRF(state_len, ALPHABET), jnp.asarray(x), **kw)
    out = beam_search_device(CTC_CRF(state_len, ALPHABET),
                             torch.from_numpy(x), **kw)
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    dq = out["qstring"].numpy().astype(int) - np.asarray(ref["qstring"])
    assert np.abs(dq).max() <= 1
    assert 0.05 < out["moves"].numpy().mean() < 0.95


def test_beam_search_wrapper_and_a_narrow_cut():
    """``beam_search_device`` does what bonito_tpu's ``ops.decode`` wrapper
    does (bf16 scores are read in f32), and a beam_cut that drops most
    beams every frame still decodes as bonito_tpu's does."""
    x = _scores(9, 3, 4, 40, False)
    b16 = torch.from_numpy(x).to(torch.bfloat16)
    ref = jdecode.beam_search(JaxCRF(3, ALPHABET),
                              jnp.asarray(b16.float().numpy()),
                              beam_width=8, beam_cut=2.0)
    out = beam_search_device(CTC_CRF(3, ALPHABET), b16, beam_width=8,
                             beam_cut=2.0)
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    dq = out["qstring"].numpy().astype(int) - np.asarray(ref["qstring"])
    assert np.abs(dq).max() <= 1
