"""The port's fused-head decode at 1024 states on the CPU against
bonito_tpu: the plain version of kernels GW and JW against
``viterbi_decode_tcn_fused`` in interpret mode and the scan oracle,
``forward_tcn_head`` of an LSTM-CRF of hac's geometry (f32 and int8) and
of a transformer with its upsample folded into two phases, the slice as a
whole (``basecall(..., head_route="fused")`` against bonito_tpu's basecall
under ``BONITO_TPU_FUSED_HEAD=1``), the product taken once a decode and
handed from GW to JW, a plain model of GW's head product's row and column
map, the wrapper's gate and the weights' layout that the earlier GW and JW
read.

f32 throughout: the plain versions are the kernels' arithmetic with the
move scores in f32, as bonito_tpu's kernel and scan have them. Decodes:
sequences and moves identical, qstrings within one phred step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonito_tpu.ops.lstm as jax_ops_lstm
from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
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
from bonito_tpu_torch.crf.basecall import basecall
from bonito_tpu_torch.crf.model import HeadSplit
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops import decode, decode_fused_cuda
from bonito_tpu_torch.util import load_model

ALPHABET = ["N", "A", "C", "G", "T"]
STATE_LEN = 5  # S = 1024: hac's and sup's state space
Q = dict(qscale=1.05, qbias=0.2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_same_decode(out, ref):
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(np.asarray(out[k]), np.asarray(ref[k]))
    dq = (np.asarray(out["qstring"], np.int32)
          - np.asarray(ref["qstring"], np.int32))
    assert np.abs(dq).max() <= 1


# ---------------------------------------------------------------------------
# (a) the plain fused-head decode at S 1024
# ---------------------------------------------------------------------------

def _head(seed, U, Th, N=8, H=32, tanh=True):
    """A random head split of 1024 states: tanh * 5 with a bias (sup's
    kind), or the linear head clamped to +-5 (hac's)."""
    S = 4 ** STATE_LEN
    rng = np.random.default_rng(seed)
    h = np.tanh(rng.normal(size=(Th, N, H))).astype(np.float32)
    gain = 0.5 if tanh else 3.0  # both give a mix of stays and moves
    wT = (gain * rng.normal(size=(U, 4 * S, H)) / np.sqrt(H)).astype(
        np.float32)
    bias = (0.3 * rng.normal(size=(U, 4 * S)).astype(np.float32) if tanh
            else None)
    ops = dict(act_tanh=tanh, scale=5.0 if tanh else 1.0,
               cmin=None if tanh else -5.0, cmax=None if tanh else 5.0)
    return h, wT, bias, ops


@pytest.mark.parametrize("U,Th,tanh", [(1, 12, False), (2, 6, True),
                                       (2, 7, True)],
                         ids=["hac-head", "sup-head", "sup-head-ragged"])
def test_wide_decode_plain_matches_pallas_interpret_and_scan(U, Th, tanh):
    """bonito_tpu's kernel takes K = 2 encoder frames a grid step here, so
    Th = 7 pads a frame; GW and JW take 8 / U at a time."""
    h, wT, bias, ops = _head(U * 100 + Th, U, Th, tanh=tanh)
    blank = 2.0
    jsd = JaxCRF(STATE_LEN, ALPHABET)
    assert decode_pallas._block_k_fused(1024, 8, 4, U, 32) == 2
    h_tcn = jnp.asarray(h.transpose(0, 2, 1))  # bonito_tpu's [T/U, H, N]
    jbias = None if bias is None else jnp.asarray(bias)
    kernel = decode_pallas.viterbi_decode_tcn_fused(
        jsd, h_tcn, jnp.asarray(wT), jbias, blank, **ops, **Q,
        interpret=True)
    jmv = jdecode.tcn_from_head(h_tcn, jnp.asarray(wT), jbias, **ops)
    scan = jdecode.viterbi_decode_scan(
        jsd, jdecode.tcn_to_scores(jsd, jmv, blank), **Q)
    head = HeadSplit(_t(h), _t(wT), None if bias is None else _t(bias),
                     ops["act_tanh"], ops["scale"], ops["cmin"], ops["cmax"],
                     blank)
    np.testing.assert_allclose(decode.tcn_from_head(head).numpy(),
                               np.asarray(jmv), rtol=1e-5, atol=1e-5)
    counts = [f.launches for f in (
        decode_fused_cuda.tcn_fused_forward,
        decode_fused_cuda.tcn_fused_backward,
        decode_fused_cuda.tcn_fused_forward_wide,
        decode_fused_cuda.tcn_fused_backward_wide)]
    out = decode.viterbi_decode_head(CTC_CRF(STATE_LEN, ALPHABET), head, **Q)
    assert counts == [f.launches for f in (  # a CPU head launches nothing
        decode_fused_cuda.tcn_fused_forward,
        decode_fused_cuda.tcn_fused_backward,
        decode_fused_cuda.tcn_fused_forward_wide,
        decode_fused_cuda.tcn_fused_backward_wide)]
    assert out["sequence"].shape == (8, U * Th)
    out = {k: v.numpy() for k, v in out.items()}
    _assert_same_decode(out, kernel)
    _assert_same_decode(out, scan)
    assert 0 < out["moves"].mean() < 1  # a mix of stays and moves


def test_wide_wrappers_take_the_plain_versions_on_the_cpu():
    h, wT, bias, ops = _head(5, 2, 5)
    head = HeadSplit(_t(h), _t(wT), _t(bias), ops["act_tanh"], ops["scale"],
                     ops["cmin"], ops["cmax"], 2.0)
    fwd = decode_fused_cuda.tcn_fused_forward_wide(head)
    ref = decode_fused_cuda.tcn_fused_forward_plain(head)
    for a, b in zip(fwd, ref):
        assert torch.equal(a, b)
    out = decode_fused_cuda.tcn_fused_backward_wide(head, *fwd, **Q)
    want = decode_fused_cuda.tcn_fused_backward_plain(head, *ref, **Q)
    assert all(torch.equal(out[k], want[k]) for k in want)


@pytest.mark.parametrize("state_len", [5, 3], ids=["S1024", "S64"])
def test_fused_route_takes_the_head_product_once(monkeypatch, state_len):
    """``viterbi_decode_head`` on the CPU takes the move scores once
    (``move_buffer``'s tensor, written by the forward pass and read by the
    backward pass) and decodes as the two plain passes, each of which
    takes them itself, do: bit for bit."""
    S = 4 ** state_len
    rng = np.random.default_rng(S)
    h = np.tanh(rng.normal(size=(6, 4, 32))).astype(np.float32)
    wT = (0.5 * rng.normal(size=(2, 4 * S, 32)) / np.sqrt(32)).astype(
        np.float32)
    bias = (0.3 * rng.normal(size=(2, 4 * S))).astype(np.float32)
    head = HeadSplit(_t(h), _t(wT), _t(bias), True, 5.0, None, None, 2.0)
    fwd = decode_fused_cuda.tcn_fused_forward_plain(head)
    want = decode_fused_cuda.tcn_fused_backward_plain(head, *fwd, **Q)
    plain = decode_fused_cuda.head_moves_plain
    calls = []

    def counted(hd):
        calls.append(1)
        return plain(hd)
    monkeypatch.setattr(decode_fused_cuda, "head_moves_plain", counted)
    out = decode.viterbi_decode_head(CTC_CRF(state_len, ALPHABET), head, **Q)
    assert len(calls) == 1
    assert all(torch.equal(out[k], want[k]) for k in want)


def test_wide_wrappers_hand_the_moves_over_on_the_cpu():
    """GW's ``moves_out`` receives ``head_moves_plain``'s tensor, which
    JW's ``moves`` then reads; ``head_product`` on the CPU is the plain
    version."""
    h, wT, bias, ops = _head(6, 2, 5)
    head = HeadSplit(_t(h), _t(wT), _t(bias), ops["act_tanh"], ops["scale"],
                     ops["cmin"], ops["cmax"], 2.0)
    moves = decode_fused_cuda.move_buffer(head)
    assert moves.shape == (8, 10, 4096) and moves.dtype == torch.float32
    fwd = decode_fused_cuda.tcn_fused_forward_wide(head, moves_out=moves)
    want = decode_fused_cuda.head_moves_plain(head)
    assert torch.equal(moves, want)
    assert torch.equal(decode_fused_cuda.head_product(head), want)
    ref = decode_fused_cuda.tcn_fused_forward_plain(head)
    assert all(torch.equal(a, b) for a, b in zip(fwd, ref))
    out = decode_fused_cuda.tcn_fused_backward_wide(head, *fwd, **Q,
                                                    moves=moves)
    ref = decode_fused_cuda.tcn_fused_backward_plain(head, *ref, **Q)
    assert all(torch.equal(out[k], ref[k]) for k in ref)


@pytest.mark.parametrize("N,Th,U,H,tanh", [(3, 5, 2, 32, True),
                                           (2, 70, 1, 48, False),
                                           (1, 1, 1, 16, False)])
def test_head_product_map_gives_head_moves_plain(N, Th, U, H, tanh):
    """A plain model of GW's head product (csrc/head_product.cu): the GEMM
    of M = N * Th rows, row m = n * Th + th reading h[th, n], and U * 4S
    columns, column p * 4S + c reading wT[p, c], cut into 128-row tiles
    (rows past M load row M - 1 and are not stored), each output one f32
    sum over k in order, then bias, tanh, scale and clamp. Row-major it is
    ``head_moves_plain``'s [N, T, 4S] tensor of frame t = th * U + p, bit
    for bit, ragged row tiles among the shapes."""
    rng = np.random.default_rng(N * Th + H)
    S = 1024
    h = torch.from_numpy(np.tanh(rng.normal(size=(Th, N, H))).astype(
        np.float32)).to(torch.bfloat16)
    wT = torch.from_numpy((3.0 * rng.normal(size=(U, 4 * S, H))
                           / np.sqrt(H)).astype(np.float32)).to(
                               torch.bfloat16)
    bias = (torch.from_numpy((0.3 * rng.normal(size=(U, 4 * S))).astype(
        np.float32)) if tanh else None)
    head = HeadSplit(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                     None if tanh else -5.0, None if tanh else 5.0, 2.0)
    M, cols = N * Th, U * 4 * S
    hf = h.float().numpy()
    w = wT.float().numpy().reshape(cols, H)
    out = np.full((M, cols), np.nan, np.float32)
    for m0 in range(0, M, 128):
        rows = np.minimum(np.arange(m0, m0 + 128), M - 1)
        a = hf[rows % Th, rows // Th]                  # [128, H]
        acc = np.zeros((128, cols), np.float32)
        for k in range(H):  # products of bf16 values are exact in f32
            acc = acc + a[:, k, None] * w[None, :, k]
        keep = slice(0, min(128, M - m0))
        out[m0:m0 + 128][keep] = acc[keep]
    z = torch.from_numpy(out)
    if bias is not None:
        z = z + bias.reshape(cols)
    if tanh:
        z = torch.tanh(z)
    if head.scale != 1.0:
        z = z * head.scale
    if head.cmin is not None:
        z = torch.clamp(z, head.cmin, head.cmax)
    want = decode_fused_cuda.head_moves_plain(head)
    assert want.shape == (N, Th * U, 4 * S)
    assert torch.equal(z.reshape(N, Th * U, 4 * S).view(torch.int32),
                       want.view(torch.int32))


# ---------------------------------------------------------------------------
# (b) the gate, and the fragment layout GW and JW read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,H,U,want", [
    (1024, 1024, 1, ("GW", "JW")), (1024, 512, 2, ("GW", "JW")),
    (512, 256, 1, ("GW", "JW")), (64, 96, 1, ("G", "J")),
    (256, 256, 3, ("G", "J"))])
def test_kernels_for_takes_hac_and_sup_heads(S, H, U, want):
    assert decode_fused_cuda.kernels_for(S, H, U) == want


@pytest.mark.parametrize("S,H,U,limit", [
    (2048, 1024, 1, "power of two from 4 to 1024"),
    (1024, 1000, 1, "multiple of 16"), (64, 40, 1, "multiple of 16"),
    (1024, 2048, 1, "H up to 1024"), (1024, 512, 4, r"U in \(1, 2\)"),
    (128, 512, 1, "H up to 256"), (768, 512, 1, "power of two")])
def test_kernels_for_names_the_limit_it_refuses(S, H, U, limit):
    with pytest.raises(ValueError, match=limit):
        decode_fused_cuda.kernels_for(S, H, U)


def test_k_major_is_the_order_the_wide_kernels_read():
    """Run k4 of row m of phase p, four consecutive k, at [p, k4, m]."""
    U, Cm, H = 2, 64, 48
    w = torch.arange(U * Cm * H, dtype=torch.float32).reshape(U, Cm, H)
    out = decode_fused_cuda.k_major(w)
    assert out.shape == (U, H // 4, Cm, 4) and out.is_contiguous()
    p, k4, m, i = np.meshgrid(np.arange(U), np.arange(H // 4), np.arange(Cm),
                              np.arange(4), indexing="ij")
    assert torch.equal(out, w[p, m, 4 * k4 + i])


def test_head_moves_plain_sums_k_in_order():
    """One f32 rounding per product added, k ascending: the sum GW and JW
    take (their bf16 products are exact in f32)."""
    h, wT, bias, ops = _head(3, 2, 4, N=3, H=48)
    head = HeadSplit(_t(h).to(torch.bfloat16), _t(wT).to(torch.bfloat16),
                     _t(bias), False, 1.0, None, None, 2.0)
    hf, wf = head.h.float().numpy(), head.wT.float().numpy()
    z = np.zeros((3, 4, 2, 4096), np.float32)
    for k in range(48):
        z = z + hf.transpose(1, 0, 2)[:, :, None, None, k] * wf[None, None, :,
                                                               :, k]
    z = z + bias
    out = decode_fused_cuda.head_moves_plain(head)
    np.testing.assert_array_equal(out.numpy(), z.reshape(3, 8, 4096))


# ---------------------------------------------------------------------------
# (c) forward_tcn_head at S 1024, and (d) the slice as a whole
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


def _lstm_dir(path, quantize):
    """hac's geometry at a small width: 3 convs, 2 LSTM layers of 32,
    state_len 5 (1024 states), stride 6, the Clamp +-5 head; the CRF
    weight x 6 so that a random model calls bases (x 5 and below: one
    letter or none; x 6: all four on 70% of the frames, with runs of stays
    and of one base; x 10: a homopolymer). Written by bonito_tpu.
    Seed 14, as for the other int8 slice tests: the two packages' f32
    convolutions differ in the last bit, and layer 0 quantises their
    output dynamically, so for most seeds some int8 input lies on a
    rounding edge (ROADMAP Queue 3, limits)."""
    cfg = lstm_crf_config(features=32, num_layers=2, state_len=STATE_LEN,
                          stride=6, batchsize=8, chunksize=1200, overlap=240)
    cfg["basecaller"]["quantize"] = quantize
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(14))
    _, (crf, _), _ = m.decode_head()
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 6
    jconfig.save_config(cfg, path / "config.toml")
    jckpt.save_params(path / "weights_1.npz", m.params)
    return path


def _sup_dir(path):
    """sup's geometry at a small width: 5 convs, 2 layers of d 64 (4 heads
    of 16), the x 2 LinearUpsample, state_len 5, the tanh x 5 head with a
    bias. Written by bonito_tpu."""
    cfg = jax_sup_config(d_model=64, nhead=4, depth=2, dim_feedforward=128,
                         state_len=STATE_LEN, batchsize=8, chunksize=2400,
                         overlap=240)
    m = jtransformer.Model(cfg)
    m.init(jax.random.PRNGKey(5))
    jconfig.save_config(cfg, path / "config.toml")
    jckpt.save_params(path / "weights_1.npz", m.params)
    return path


def _pair(tmp_path, monkeypatch, kind):
    """The directory loaded by both packages in f32, bonito_tpu's int8 LSTM
    on its fused route (the TPU's) and the port's likewise, the port's
    transformer on the local attention route (bonito_tpu's on the CPU)."""
    monkeypatch.setattr(jax_ops_lstm, "lstm_int8", _jax_fused_route)
    if kind == "sup":
        d = _sup_dir(tmp_path)
        kw = dict(attn_route="local")
    else:
        d = _lstm_dir(tmp_path, kind == "int8")
        kw = dict(route="fused") if kind == "int8" else {}
    jm = jax_load_model(d, half=False, fuse_bn=True, quantize=None)
    pm = load_model(d, half=False, fuse_bn=True, quantize=None, device="cpu",
                    **kw)
    return jm, pm


@pytest.mark.parametrize("kind", ["f32", "int8", "sup"])
def test_forward_tcn_head_at_1024_states_matches_jax(tmp_path, monkeypatch,
                                                     kind):
    """The split and its decode: an LSTM chain (int8: h dequantised from
    the last layer's int8 output) and a transformer whose upsample folds
    into two phases."""
    jm, pm = _pair(tmp_path, monkeypatch, kind)
    T = 1200 if kind != "sup" else 2400
    x = np.random.default_rng(9).normal(size=(3, T, 1)).astype(np.float32)
    jhead = jm.forward_tcn_head(jm.params, jnp.asarray(x))
    with torch.no_grad():
        head = pm.forward_tcn_head(_t(x))
    U = 2 if kind == "sup" else 1
    H = 64 if kind == "sup" else 32
    assert head.h.shape == (T // 6 // U, 3, H)
    assert head.wT.shape == (U, 4096, H)
    assert (head.bias is None) == (kind != "sup") == (jhead.bias is None)
    np.testing.assert_allclose(head.h.numpy(),
                               np.asarray(jhead.h_tcn).transpose(0, 2, 1),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(head.wT.numpy(), np.asarray(jhead.wT),
                               rtol=2e-5, atol=2e-5)
    if head.bias is not None:
        np.testing.assert_allclose(head.bias.numpy(), np.asarray(jhead.bias),
                                   rtol=2e-5, atol=2e-5)
    assert (head.act_tanh, head.scale, head.cmin, head.cmax, head.blank) == (
        jhead.act_tanh, jhead.scale, jhead.cmin, jhead.cmax, jhead.blank)
    out = decode.viterbi_decode_head(pm.seqdist, head, **Q)
    ref = jdecode.viterbi_decode_head(jm.seqdist, jhead, **Q)
    _assert_same_decode({k: v.numpy() for k, v in out.items()}, ref)
    assert 0 < out["moves"].float().mean() < 1


@pytest.mark.parametrize("kind", ["f32", "int8", "sup"])
def test_fused_route_basecall_matches_bonito_tpu(tmp_path, monkeypatch, kind):
    """load_model + basecall(..., head_route="fused") per read, against
    bonito_tpu's basecall with BONITO_TPU_FUSED_HEAD=1 (on the CPU its
    tcn_from_head + the scan: the same function). Sequences and moves
    identical, qstrings within one phred step."""
    monkeypatch.setenv("BONITO_TPU_FUSED_HEAD", "1")
    jm, pm = _pair(tmp_path, monkeypatch, kind)
    bc = pm.config["basecaller"]
    kw = dict(chunksize=bc["chunksize"], overlap=bc["overlap"], batchsize=8)
    reads = _reads(4, [700, 2600, 6100] if kind != "sup"
                   else [1500, 5000, 9000])
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw,
                                                 head_route="fused")}
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
        dq = (np.frombuffer(out[rid]["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(ref[rid]["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert len(set("".join(r["sequence"] for r in out.values()))) == 4
