"""The port's full-score basecall on the CPU against bonito_tpu: the
reverse strand (``reverse=True``, the basecaller's ``--revcomp``) and the
beam decode (``decoder="beam"``). ``seqdist.reverse_complement`` bit for
bit, the plain versions of kernels M and Q (``viterbi_decode`` on a CPU
tensor) against bonito_tpu's Pallas decode in interpret mode and its scan,
``decode_batch``, the reverse stitch, and the slice as a whole on an
LSTM-CRF directory (reverse, beam, both; both ``quantize`` values) and on
a sup directory. The beam itself: ``tests/test_torch_beam.py``.

Decodes: sequences and moves identical, qstrings within one phred step
(the posterior sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonito_tpu.ops.lstm as jax_ops_lstm
from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu import util as jutil
from bonito_tpu.crf.basecall import basecall as jax_basecall
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.models import transformer_crf_config as jax_sup_config
from bonito_tpu.ops import decode as jdecode
from bonito_tpu.ops import decode_pallas
from bonito_tpu.ops import lstm_pallas as jpallas
from bonito_tpu.transformer import model as jtransformer
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu_torch import checkpoint, util
from bonito_tpu_torch.crf.basecall import basecall, make_compute_fn
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops import decode, decode_full_cuda
from bonito_tpu_torch.util import load_model

ALPHABET = ["N", "A", "C", "G", "T"]
QSCALE, QBIAS = 1.05, 0.2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scores(seed, state_len, N, T, ties=False, scale=2.0):
    """Full f32 scores [N, T, S*5]; with ``ties`` on a coarse grid, so that
    argmax and stay-against-move comparisons tie often."""
    rng = np.random.default_rng(seed)
    x = scale * rng.normal(size=(N, T, 5 * 4 ** state_len))
    if ties:
        x = np.round(x)
    return x.astype(np.float32)


def _assert_same(out, ref):
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    dq = (np.asarray(out["qstring"], np.int32)
          - np.asarray(ref["qstring"], np.int32))
    assert np.abs(dq).max() <= 1


def _port(out):
    return {k: v.numpy() for k, v in out.items()}


# ---------------------------------------------------------------------------
# reverse_complement, the decode, decode_batch, stitch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state_len", [2, 3, 5])
def test_reverse_complement_is_bonito_tpu_s(state_len):
    """Bit for bit (a permutation of the entries), bf16 too, and an
    involution."""
    x = _scores(state_len, state_len, 2, 7)
    ref = np.asarray(JaxCRF(state_len, ALPHABET).reverse_complement(
        jnp.asarray(x)))
    sd = CTC_CRF(state_len, ALPHABET)
    out = sd.reverse_complement(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(
        sd.reverse_complement(out).numpy(), x)
    b16 = torch.from_numpy(x).to(torch.bfloat16)
    assert torch.equal(sd.reverse_complement(b16),
                       out.to(torch.bfloat16))


@pytest.mark.parametrize("state_len", [1, 2, 3, 4, 5])
def test_reverse_index_map_is_reverse_complement(state_len):
    """The map kernels M and Q read the reverse strand through
    (``rc_columns``: csrc/crf_frames.cuh's RevFullFrame, decode_ring.cuh's
    FullRows) equals ``seqdist.reverse_complement`` and bonito_tpu's,
    column for column and frame for frame: every entry distinct, so each
    column of each reverse frame names its forward entry."""
    S = 4 ** state_len
    N, T = 2, 7
    x = torch.arange(N * T * 5 * S, dtype=torch.float64).reshape(N, T, 5 * S)
    ref = CTC_CRF(state_len, ALPHABET).reverse_complement(x)
    cols = decode_full_cuda.rc_columns(S)
    assert sorted(cols.tolist()) == list(range(5 * S))
    for t in range(T):
        assert torch.equal(x[:, T - 1 - t, cols], ref[:, t])
    assert torch.equal(decode_full_cuda.reverse_scores(x), ref)
    jref = JaxCRF(state_len, ALPHABET).reverse_complement(
        jnp.asarray(x.numpy().astype(np.float32)))
    np.testing.assert_array_equal(
        decode_full_cuda.reverse_scores(x).numpy().astype(np.float32),
        np.asarray(jref))


@pytest.mark.parametrize("state_len", [1, 2, 3])
def test_reverse_entry_plain_is_the_decode_of_the_copy(state_len):
    """``viterbi_decode(..., reverse=True)`` on a CPU tensor (the plain
    versions of the in-place entry) is bonito_tpu's decode of
    ``reverse_complement(scores)``, and the plain passes equal those on the
    copy: move_in and choices in the forward strand's order of states
    (``rc_states``), the rest as they are."""
    x = _scores(40 + state_len, state_len, 6, 23)
    sd = CTC_CRF(state_len, ALPHABET)
    q = dict(qscale=QSCALE, qbias=QBIAS)
    xt = torch.from_numpy(x)
    rc = sd.reverse_complement(xt)
    fwd = decode_full_cuda.full_forward_plain(xt, reverse=True)
    ref_fwd = decode_full_cuda.full_forward_plain(rc)
    cols = decode_full_cuda.rc_states(4 ** state_len)
    assert torch.equal(fwd[0], ref_fwd[0][..., cols])
    assert torch.equal(fwd[1], ref_fwd[1][..., cols])
    for a, b in zip(fwd[2:], ref_fwd[2:]):
        assert torch.equal(a, b)
    out = decode_full_cuda.full_backward_plain(xt, *fwd, reverse=True, **q)
    ref = decode_full_cuda.full_backward_plain(rc, *ref_fwd, **q)
    for k in out:
        assert torch.equal(out[k], ref[k])
    got = _port(decode.viterbi_decode(sd, xt, reverse=True, **q))
    jsd = JaxCRF(state_len, ALPHABET)
    scan = jdecode.viterbi_decode_scan(
        jsd, jsd.reverse_complement(jnp.asarray(x)), **q)
    _assert_same(got, scan)
    assert 0.05 < got["moves"].mean() < 0.95


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("state_len", [2, 3])
def test_full_decode_matches_pallas_interpret_and_scan(state_len, ties):
    """``viterbi_decode`` on a CPU tensor (the plain M + Q) against
    ``viterbi_decode_pallas`` in interpret mode and ``viterbi_decode_scan``.
    T = 23 is no multiple of the TPU kernel's 4 frames per grid step, so
    its padded frames are in play."""
    x = _scores(10 * state_len + ties, state_len, 8, 23, ties)
    jsd = JaxCRF(state_len, ALPHABET)
    assert decode_pallas._block_k(4 ** state_len, 8, 4) == 4
    q = dict(qscale=QSCALE, qbias=QBIAS)
    pallas = decode_pallas.viterbi_decode_pallas(jsd, jnp.asarray(x),
                                                 interpret=True, **q)
    scan = jdecode.viterbi_decode_scan(jsd, jnp.asarray(x), **q)
    out = _port(decode.viterbi_decode(CTC_CRF(state_len, ALPHABET),
                                      torch.from_numpy(x), **q))
    _assert_same(out, pallas)
    _assert_same(out, scan)
    assert 0.05 < out["moves"].mean() < 0.95  # a mix of stays and moves


def test_reverse_decode_is_the_shifted_reverse_complement():
    """The property ``tests/test_seqdist.py`` pins for bonito_tpu, on the
    port's decode: the reverse strand's call is the reverse complement of
    the forward call, shifted by state_len (the reverse strand emits the
    dropped digit of each k-mer, so the last state_len bases of the
    reverse call depend on context outside the window)."""
    sd = CTC_CRF(2, ALPHABET)
    x = torch.from_numpy(_scores(2, 2, 16, 40, scale=3.0))
    fwd = sd.path_to_str
    comp = dict(zip("ACGT", "TGCA"))
    k = sd.state_len
    a = decode.viterbi_decode(sd, x)["sequence"].numpy()
    b = decode.viterbi_decode(sd, sd.reverse_complement(x))[
        "sequence"].numpy()
    for pa, pb in zip(a, b):
        f, r = fwd(pa), fwd(pb)
        expect = "".join(comp[c] for c in reversed(f))
        assert len(r) == len(f) > 2 * k
        assert r[:len(r) - k] == expect[k:]


def test_decode_batch_matches_bonito_tpu():
    cfg = lstm_crf_config(features=32, num_layers=1, state_len=2)
    jm = JaxModel(cfg)
    pm = Model(cfg)
    x = _scores(4, 2, 3, 30)
    ref = jm.decode_batch(jnp.asarray(x))
    assert pm.decode_batch(x) == pm.decode_batch(torch.from_numpy(x)) == ref
    assert pm.decode(torch.from_numpy(x[1])) == jm.decode(jnp.asarray(x[1]))
    assert all(len(s) > 5 for s in ref)


@pytest.mark.parametrize("length", [9000, 9500, 12345])
def test_reverse_stitch_matches_bonito_tpu(length):
    chunksize, overlap, stride = 2000, 400, 5
    sig = np.arange(length, dtype=np.float32)
    chunks = util.chunk(sig, chunksize, overlap)
    frames = np.stack([c[::stride] for c in chunks])[..., None] * [1, -1]
    for reverse in (False, True):
        ref = jutil.stitch(frames, chunksize, overlap, length, stride,
                           reverse=reverse)
        out = util.stitch(frames, chunksize, overlap, length, stride,
                          reverse=reverse)
        np.testing.assert_array_equal(out, np.asarray(ref))


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


def _reads(seed, lengths):
    rng = np.random.default_rng(seed)
    return [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
            for i, n in enumerate(lengths)]


def _jax_fused_route(x, w_ih, w_hh_q, scales, b, reverse=False, w_ih_q=None,
                     ih_scales=None, out_int8=False):
    """bonito_tpu's lstm_int8 as it runs on a TPU (its fused int8 branch),
    with the Pallas kernel in interpret mode."""
    if x.dtype == jnp.int8:
        xq, sx = x, jnp.float32(1.0 / 127.0)
    else:
        xf = x.astype(jnp.float32)
        sx = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-8) / 127.0
        xq = jnp.round(xf / sx).astype(jnp.int8)
    return jpallas.lstm_pallas_int8_fused(
        xq, w_ih_q, w_hh_q, ih_scales * sx, scales, b, reverse=reverse,
        interpret=True, block_k=2, out_int8=out_int8)


def lstm_dir(path, quantize, blank_score=2.0):
    """A small LSTM-CRF directory written by bonito_tpu (H 96, state_len 3,
    stride 5), the CRF weight x 10 so that a random model calls bases.

    The seed matters when quantised: the f32 convolutions of the two
    packages differ in the last bit, and layer 0 quantises their output
    dynamically, so a value on a rounding edge moves an int8 input by a
    step and the h it feeds with it. For most seeds that happens in these
    reads (seeds 0 to 4: 2% to 10% of the full scores then differ, by up to
    0.11). With seed 14 it does not, so the decodes can be held identical,
    and the model calls all four letters on both strands and in the beam."""
    cfg = lstm_crf_config(features=96, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=1000, overlap=200,
                          blank_score=blank_score)
    cfg["basecaller"]["quantize"] = quantize
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(14))
    crf = str(next(i for i, layer in enumerate(cfg["encoder"]["sublayers"])
                   if layer["type"] == "linearcrfencoder"))
    if blank_score is None:  # TOML has no null: a learned blank names none
        del cfg["encoder"]["sublayers"][int(crf)]["blank_score"]
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 10
    jconfig.save_config(cfg, path / "config.toml")
    jckpt.save_params(path / "weights_1.npz", m.params)
    return path


def compare_slice(tmp_path, monkeypatch, quantize, blank_score=2.0, **kw):
    """load_model + basecall(**kw) of ``lstm_dir`` in both packages, f32,
    with bonito_tpu on its fused int8 route when quantised: identical per
    read."""
    monkeypatch.setattr(jax_ops_lstm, "lstm_int8", _jax_fused_route)
    d = lstm_dir(tmp_path, quantize, blank_score)
    jm = jax_load_model(d, half=False, fuse_bn=True, quantize=None)
    pm = load_model(d, half=False, fuse_bn=True, quantize=None, device="cpu",
                    route="fused" if quantize else None)
    reads = _reads(4, [700, 2400, 5100])
    geometry = dict(chunksize=1000, overlap=200, batchsize=8)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads),
                                                     **geometry, **kw)}
    out = {r.read_id: res for r, res in basecall(pm, iter(reads),
                                                 **geometry, **kw)}
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
        dq = (np.frombuffer(out[rid]["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(ref[rid]["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert sum(len(r["sequence"]) for r in out.values()) > 1000
    return out


@pytest.mark.parametrize("kw", [dict(reverse=True), dict(decoder="beam"),
                                dict(reverse=True, decoder="beam")],
                         ids=["reverse", "beam", "reverse-beam"])
@pytest.mark.parametrize("quantize", [False, True])
def test_full_score_slice_matches_bonito_tpu(tmp_path, monkeypatch, quantize,
                                             kw):
    """The reverse strand through kernels M and Q's plain versions, and the
    beam decode on either strand."""
    out = compare_slice(tmp_path, monkeypatch, quantize, **kw)
    assert len(set("".join(r["sequence"] for r in out.values()))) == 4


@pytest.mark.parametrize("quantize", [False, True])
def test_make_compute_fn_reverse_matches_bonito_tpu(tmp_path, monkeypatch,
                                                    quantize):
    """The device step of the reverse strand (``make_compute_fn(...,
    reverse=True)``, the in-place entry's plain versions on the CPU) against
    bonito_tpu's (``model(x)``, ``reverse_complement``, its Pallas decode
    in interpret mode) on a full batch and a ragged one of ``lstm_dir``'s
    chunks: the per-frame arrays identical, qualities within a step."""
    from bonito_tpu.crf.basecall import make_compute_fn as jax_compute_fn
    monkeypatch.setattr(jax_ops_lstm, "lstm_int8", _jax_fused_route)
    d = lstm_dir(tmp_path, quantize)
    jm = jax_load_model(d, half=False, fuse_bn=True, quantize=None)
    pm = load_model(d, half=False, fuse_bn=True, quantize=None, device="cpu",
                    route="fused" if quantize else None)
    reads = _reads(8, [8 * 1000])
    batch = util.chunk(reads[0].signal, 1000, 200)[:8]
    assert batch.shape == (8, 1000)
    port = make_compute_fn(pm, 8, 1000, reverse=True)
    ref = jax_compute_fn(jm, 8, 1000, reverse=True)
    for n in (8, 5):
        out, want = port(batch[:n]), ref(batch[:n])
        for k in ("sequence", "moves"):
            np.testing.assert_array_equal(out[k], want[k])
        dq = out["qstring"].astype(int) - want["qstring"].astype(int)
        assert np.abs(dq).max() <= 1
        assert out["moves"].shape == (n, 200) and out["moves"].mean() > 0.05


def test_learned_blank_decodes_its_full_scores(tmp_path, monkeypatch):
    """A head that learns its stay scores (no fixed blank) has no TCN split:
    the forward strand too decodes the full scores, as in bonito_tpu, and a
    forced TCN route raises."""
    out = compare_slice(tmp_path, monkeypatch, False, blank_score=None)
    assert len(set("".join(r["sequence"] for r in out.values()))) >= 2
    pm = load_model(tmp_path, half=False, device="cpu")
    assert pm.forward_tcn(torch.zeros(1, 1000, 1)) is None
    compute = make_compute_fn(pm, 8, 1000, head_route="tcn")
    with pytest.raises(ValueError, match="no fixed blank"):
        compute(np.zeros((1, 1000)))


def test_reverse_sup_slice_matches_bonito_tpu(tmp_path):
    """A small sup-geometry directory (3 layers of d 64, 64 states), f32,
    on the local attention route (bonito_tpu's on the CPU): identical per
    read."""
    cfg = jax_sup_config(d_model=64, nhead=4, depth=3, dim_feedforward=128,
                         state_len=3, batchsize=8, chunksize=2400,
                         overlap=240)
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(5))
    jconfig.save_config(cfg, tmp_path / "config.toml")
    jckpt.save_params(tmp_path / "weights_1.npz", jm.params)
    reads = _reads(6, [1500, 5000, 9000])
    kw = dict(chunksize=2400, overlap=240, batchsize=8, reverse=True)
    jm = jax_load_model(tmp_path, half=False, fuse_bn=True)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    pm = load_model(tmp_path, half=False, fuse_bn=True, device="cpu",
                    attn_route="local")
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw)}
    assert out.keys() == ref.keys()
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
    assert sum(len(r["sequence"]) for r in out.values()) > 500


def test_checkpoint_carries_a_model_for_decode_batch():
    """decode_batch on a model's own forward: the port with bonito_tpu's
    weights carried across decodes as bonito_tpu does."""
    cfg = lstm_crf_config(features=32, num_layers=1, state_len=2, stride=5)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(1))
    _, (crf, _), _ = jm.decode_head()
    jm.params["encoder"][crf]["w"] = jm.params["encoder"][crf]["w"] * 10
    pm = checkpoint.params_from_jax(
        Model(cfg), jax.tree.map(np.asarray, jm.params))
    x = np.random.default_rng(2).normal(size=(2, 600, 1)).astype(np.float32)
    with torch.no_grad():
        out = pm.decode_batch(pm(torch.from_numpy(x)))
    ref = jm.decode_batch(jm.apply(jm.params, jnp.asarray(x)))
    assert out == ref and sum(map(len, ref)) > 10
