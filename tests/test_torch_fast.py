"""The port's fast path on the CPU against bonito_tpu: the plain version
of kernel F against ``lstm_pallas_fused`` in interpret mode and the scan,
the plain fused-head decode (kernels G and J) against
``viterbi_decode_tcn_fused`` in interpret mode and the scan oracle,
``forward_tcn_head`` (with the LinearUpsample fold), the goldens
``fused_head_decode`` and ``fast_shipped_shape``, the ``lstm`` gate, and
the slice as a whole: ``basecall`` of a fast-geometry model against
bonito_tpu's on its default routes.

f32 throughout unless a test says bf16: on the CPU bonito_tpu's bf16
scan carries c in bf16, which no kernel does, so bf16 is compared with
the Pallas kernels in interpret mode only."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu import nn as jnn
from bonito_tpu.crf.basecall import basecall as jax_basecall
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.crf.model import SeqdistModel as JaxSeqdistModel
from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.models import get_config, lstm_crf_config
from bonito_tpu.ops import decode as jdecode
from bonito_tpu.ops import decode_pallas
from bonito_tpu.ops import lstm_pallas as jpallas
from bonito_tpu.ops.lstm import lstm_scan
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu_torch import checkpoint, nn
from bonito_tpu_torch.crf.basecall import basecall, make_compute_fn
from bonito_tpu_torch.crf.model import HeadSplit, Model, SeqdistModel
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.models import MODELS
from bonito_tpu_torch.ops import decode, int8
from bonito_tpu_torch.ops.lstm import int8_route, lstm, lstm_int8, small_h
from bonito_tpu_torch.ops.lstm_cuda import lstm_recurrence_plain
from bonito_tpu_torch.ops.lstm_fused_cuda import lstm_fused, lstm_fused_plain
from bonito_tpu_torch.util import load_model

ALPHABET = ["N", "A", "C", "G", "T"]
BF16_STEP = 2.0 ** -8  # one bf16 step of |h| in [0.5, 1)
GOLDEN = Path(__file__).parent / "golden"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# (a) kernel F's plain version
# ---------------------------------------------------------------------------

def _layer(seed, N, T, C, H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, T, C)).astype(np.float32)
    w_ih = (rng.normal(size=(C, 4 * H)) / np.sqrt(C)).astype(np.float32)
    w_hh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (0.5 * rng.normal(size=4 * H)).astype(np.float32)
    return x, w_ih, w_hh, b


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("H", [96, 32])
def test_fused_lstm_plain_matches_pallas_interpret_and_scan(H, reverse, bias):
    """f32 at 1e-4, the tolerance of bonito_tpu's own test of the kernel
    (tests/test_lstm.py). T = 13 is no multiple of the Pallas kernel's
    block of 8 steps, so that side pads; the port's result depends on no
    blocking."""
    N, T = 8, 13
    x, w_ih, w_hh, b = _layer(H + reverse, N, T, H, H)
    jb = jnp.asarray(b) if bias else None
    args = (jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh), jb)
    out = lstm_fused_plain(_t(x).transpose(0, 1), _t(w_ih), _t(w_hh),
                           _t(b) if bias else None, reverse=reverse)
    out = out.transpose(0, 1).numpy()
    for ref in (jpallas.lstm_pallas_fused(*args, reverse=reverse,
                                          interpret=True),
                lstm_scan(*args, reverse=reverse)):
        np.testing.assert_allclose(out, np.asarray(ref), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_lstm_plain_bf16_keeps_xw_in_f32(reverse):
    """bf16: within one bf16 step of the Pallas kernel in interpret mode
    (both round h to bf16 each step; a rounding may flip). Projection +
    the plain version of kernel A, which rounds xw to bf16, is further
    from it than the plain version of F is: that rounding is the
    arithmetic that sets the two routes apart."""
    N, T, H = 8, 13, 96
    x, w_ih, w_hh, b = _layer(5, N, T, H, H)
    bf = lambda a: _t(a).to(torch.bfloat16)
    jbf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    ref = np.asarray(jpallas.lstm_pallas_fused(
        jbf(x), jbf(w_ih), jbf(w_hh), jbf(b), reverse=reverse,
        interpret=True).astype(jnp.float32))
    xt = bf(x).transpose(0, 1)
    out = lstm_fused_plain(xt, bf(w_ih), bf(w_hh), bf(b), reverse=reverse)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.transpose(0, 1).float().numpy() - ref)
    assert err.max() <= BF16_STEP
    xw = (torch.matmul(xt, bf(w_ih)) + bf(b)).contiguous()
    via_a = lstm_recurrence_plain(xw, bf(w_hh), reverse=reverse)
    err_a = np.abs(via_a.transpose(0, 1).float().numpy() - ref)
    assert err_a.mean() > 2 * err.mean()


# ---------------------------------------------------------------------------
# (b) the plain fused-head decode
# ---------------------------------------------------------------------------

def _head(seed, U, Th, state_len=3, N=8, H=32, tanh=True):
    """A random head split: tanh * 5 with a bias, or (``tanh=False``) the
    linear head clamped to +-5 of the hac and fast configs."""
    S = 4 ** state_len
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


def _port_head(h, wT, bias, ops, blank=2.0):
    return HeadSplit(_t(h), _t(wT), None if bias is None else _t(bias),
                     ops["act_tanh"], ops["scale"], ops["cmin"], ops["cmax"],
                     blank)


def _assert_same_decode(out, ref):
    """The contract of bonito_tpu's fused-head tests: sequence and moves
    identical, qstring within one phred step."""
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    dq = out["qstring"].numpy().astype(int) - np.asarray(ref["qstring"], int)
    assert np.abs(dq).max() <= 1
    assert 0 < out["moves"].float().mean() < 1  # a mix of stays and moves


@pytest.mark.parametrize("U,Th,tanh", [(1, 24, True), (1, 25, True),
                                       (2, 12, True), (2, 13, True),
                                       (1, 25, False)])
def test_fused_decode_plain_matches_pallas_interpret_and_scan(U, Th, tanh):
    h, wT, bias, ops = _head(U * 100 + Th, U, Th, tanh=tanh)
    blank, q = 2.0, dict(qscale=1.05, qbias=0.2)
    jsd = JaxCRF(3, ALPHABET)
    h_tcn = jnp.asarray(h.transpose(0, 2, 1))  # bonito_tpu's [T/U, H, N]
    jbias = None if bias is None else jnp.asarray(bias)
    kernel = decode_pallas.viterbi_decode_tcn_fused(
        jsd, h_tcn, jnp.asarray(wT), jbias, blank, **ops, **q,
        interpret=True)
    jmv = jdecode.tcn_from_head(h_tcn, jnp.asarray(wT), jbias, **ops)
    scan = jdecode.viterbi_decode_scan(
        jsd, jdecode.tcn_to_scores(jsd, jmv, blank), **q)
    head = _port_head(h, wT, bias, ops, blank)
    mv = decode.tcn_from_head(head)
    assert mv.shape == (U * Th, 256, 8)
    np.testing.assert_allclose(mv.numpy(), np.asarray(jmv), rtol=1e-5,
                               atol=1e-5)
    out = decode.viterbi_decode_head(CTC_CRF(3, ALPHABET), head, **q)
    assert out["sequence"].shape == (8, U * Th)
    _assert_same_decode(out, kernel)
    _assert_same_decode(out, scan)


# ---------------------------------------------------------------------------
# (c) forward_tcn_head
# ---------------------------------------------------------------------------

def _assert_head_matches(head, jhead, tol=2e-5):
    np.testing.assert_allclose(head.h.numpy(),
                               np.asarray(jhead.h_tcn).transpose(0, 2, 1),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(head.wT.numpy(), np.asarray(jhead.wT),
                               rtol=tol, atol=tol)
    if jhead.bias is None:
        assert head.bias is None
    else:
        np.testing.assert_allclose(head.bias.numpy(), np.asarray(jhead.bias),
                                   rtol=tol, atol=tol)
    assert (head.act_tanh, head.scale, head.cmin, head.cmax, head.blank) == (
        jhead.act_tanh, jhead.scale, jhead.cmin, jhead.cmax, jhead.blank)


def _fast_pair(num_layers=2, seed=21, **kw):
    cfg = lstm_crf_config(features=96, num_layers=num_layers, state_len=3,
                          stride=5, batchsize=8, chunksize=1000, overlap=200,
                          **kw)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(seed))
    _, (crf, _), _ = jm.decode_head()
    jm.params["encoder"][crf]["w"] = jm.params["encoder"][crf]["w"] * 5
    return cfg, jm, checkpoint.params_from_jax(Model(cfg), _np(jm.params))


def test_forward_tcn_head_matches_jax_for_an_lstm_crf_model():
    _, jm, pm = _fast_pair(blank_score=7.0)  # outside the Clamp: clipped
    x = np.random.default_rng(22).normal(size=(3, 400, 1)).astype(np.float32)
    jhead = jm.forward_tcn_head(jm.params, jnp.asarray(x))
    with torch.no_grad():
        head = pm.forward_tcn_head(_t(x))
        mv, blank = pm.forward_tcn(_t(x))
    assert head.h.shape == (80, 3, 96) and head.wT.shape == (1, 256, 96)
    assert head.blank == blank == 5.0 and head.bias is None
    _assert_head_matches(head, jhead)
    np.testing.assert_allclose(decode.tcn_from_head(head).numpy(),
                               mv.numpy(), rtol=1e-5, atol=1e-5)


def _upsample_encoders(mod, crf_kw):
    return mod.Serial([
        mod.Convolution(1, 32, 5, stride=2, padding=2, activation="swish"),
        mod.LSTM(32, 32, reverse=True), mod.LSTM(32, 32),
        mod.LinearUpsample(32, 2),
        mod.LinearCRFEncoder(32, 4, 3, **crf_kw)])


def test_forward_tcn_head_folds_a_linear_upsample():
    """A hand-built encoder ending in LinearUpsample(2) + a tanh * 5 head
    with a bias: the upsample folds into one weight per phase."""
    crf_kw = dict(bias=True, scale=5.0, activation="tanh", blank_score=2.0)
    jenc = _upsample_encoders(jnn, crf_kw)
    jm = JaxSeqdistModel(jenc, JaxCRF(3, ALPHABET))
    jm.init(jax.random.PRNGKey(23))
    rng = np.random.default_rng(24)
    p = jm.params["encoder"]
    p["3"]["b"] = jnp.asarray(rng.normal(size=64).astype(np.float32))
    p["4"]["b"] = jnp.asarray(rng.normal(size=256).astype(np.float32))
    p["4"]["w"] = p["4"]["w"] * 3
    pm = SeqdistModel(_upsample_encoders(nn, crf_kw), CTC_CRF(3, ALPHABET))
    checkpoint.params_from_jax(pm, _np(jm.params))
    assert pm.stride == jm.stride == 1
    x = rng.normal(size=(2, 60, 1)).astype(np.float32)
    jhead = jm.forward_tcn_head(jm.params, jnp.asarray(x))
    jmv, jblank = jm.forward_tcn(jm.params, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(pm(_t(x)).numpy(),
                                   np.asarray(jm.forward(jnp.asarray(x))),
                                   rtol=2e-4, atol=2e-4)
        head = pm.forward_tcn_head(_t(x))
        mv, blank = pm.forward_tcn(_t(x))
    assert head.h.shape == (30, 2, 32) and head.wT.shape == (2, 256, 32)
    assert head.bias.shape == (2, 256) and blank == jblank
    _assert_head_matches(head, jhead)
    for got in (decode.tcn_from_head(head), mv):
        assert got.shape == (60, 256, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(jmv), rtol=1e-5,
                                   atol=1e-5)


def test_forward_tcn_head_is_none_where_bonito_tpu_s_is():
    """No fixed blank; an unbounded head (neither tanh nor a Clamp)."""
    for kw in (dict(blank_score=None), dict(clamp=None)):
        cfg = lstm_crf_config(features=32, num_layers=1, state_len=2,
                              stride=5, **kw)
        jm = JaxModel(cfg)
        jm.init(jax.random.PRNGKey(0))
        pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
        x = np.zeros((1, 50, 1), np.float32)
        assert jm.forward_tcn_head(jm.params, jnp.asarray(x)) is None
        with torch.no_grad():
            assert pm.forward_tcn_head(_t(x)) is None
        if kw.get("clamp", 5.0) is None:  # the default route falls to TCN
            out = make_compute_fn(pm, 1, 50)(x[..., 0])
            assert out["sequence"].shape == (1, 10)
            with pytest.raises(ValueError, match="cannot be split"):
                make_compute_fn(pm, 1, 50, head_route="fused")(x[..., 0])
    with pytest.raises(ValueError, match="head_route"):
        make_compute_fn(pm, 1, 50, head_route="scan")


# ---------------------------------------------------------------------------
# (d) goldens
# ---------------------------------------------------------------------------

def _strings(out):
    return {"sequences": [decode.to_str(s) for s in out["sequence"].numpy()],
            "qstrings": [decode.to_str(q, qstring=True)
                         for q in out["qstring"].numpy()]}


def test_fused_head_golden_reproduced():
    """tests/golden/fused_head_decode.json (tests/test_golden.py:
    compute_fused_head_case) through the port's forward_tcn_head +
    viterbi_decode_head, the JAX model's weights carried across."""
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=2, stride=5,
                          scaling_strategy="quantile")
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(42))
    jm.params["encoder"]["6"]["w"] = jm.params["encoder"]["6"]["w"] * 30
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    signal = np.random.default_rng(42).normal(size=(3, 1000)).astype(
        np.float32)
    with torch.no_grad():
        head = pm.forward_tcn_head(_t(signal)[..., None])
        out = decode.viterbi_decode_head(pm.seqdist, head, qscale=1.05,
                                         qbias=0.2)
    assert _strings(out) == json.loads(
        (GOLDEN / "fused_head_decode.json").read_text())


def test_fast_shipped_shape_golden_reproduced():
    """tests/golden/fast_shipped_shape.json (compute_fast_shipped_case: the
    shipped fast geometry through the TCN route), and the port's own fast
    entries against bonito_tpu's."""
    name = "dna_r10.4.1_e8.2_400bps_fast@v4.3"
    cfg = get_config(name)
    for key in (name, "rna004_130bps_fast@v3.0.1"):
        mine, theirs = MODELS[key](), get_config(key)
        assert mine.pop("model") == {"package": "bonito.crf"}
        assert theirs.pop("model") == {"package": "bonito_tpu.crf"}
        assert mine == theirs
    assert cfg["basecaller"] == {"batchsize": 1024, "chunksize": 6000,
                                 "overlap": 500, "quantize": True}
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(77))
    _, (crf, _), _ = jm.decode_head()
    jm.params["encoder"][crf]["w"] = jm.params["encoder"][crf]["w"] * 5
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    signal = np.random.default_rng(77).normal(size=(2, 1000)).astype(
        np.float32)
    with torch.no_grad():
        mv, blank = pm.forward_tcn(_t(signal)[..., None])
        out = decode.viterbi_decode_tcn(pm.seqdist, mv, blank)
    assert _strings(out) == json.loads(
        (GOLDEN / "fast_shipped_shape.json").read_text())


# ---------------------------------------------------------------------------
# (f) the gate, and the dequantised small-H route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C,H", [(96, 96), (32, 32), (16, 256), (96, 272),
                                 (1024, 1024), (96, 1024), (1024, 96),
                                 (24, 64), (64, 24)])
def test_lstm_gate_is_bonito_tpu_s_small_h_gate(C, H, monkeypatch):
    """``lstm`` runs kernel F's plain version exactly where
    ``supported_fused`` says yes by H and C -- except that F tiles C and H
    by 16 where the TPU kernel tiles by 8 -- and projection + kernel A's
    elsewhere. The quantised layer's default route follows the same gate."""
    N, T = 8, 3
    jax_says = bool(jpallas.supported_fused(
        jnp.zeros((N, T, C)), jnp.zeros((H, 4 * H)), require_tpu=False))
    assert small_h(C, H) == (jax_says and C % 16 == 0 and H % 16 == 0)
    assert jax_says == (H <= 256)
    import bonito_tpu_torch.ops.lstm as ops_lstm
    calls = []
    for name in ("lstm_fused", "lstm_recurrence"):
        fn = getattr(ops_lstm, name)
        monkeypatch.setattr(ops_lstm, name, lambda *a, _n=name, _f=fn, **k:
                            (calls.append(_n), _f(*a, **k))[1])
    out = lstm(torch.zeros(N, T, C), torch.zeros(C, 4 * H),
               torch.zeros(H, 4 * H), None)
    assert out.shape == (N, T, H)
    assert calls == ["lstm_fused" if small_h(C, H) else "lstm_recurrence"]
    q = torch.zeros(C, 4 * H, dtype=torch.int8)
    route = int8_route(torch.zeros(N, T, C), torch.zeros(
        H, 4 * H, dtype=torch.int8), q)
    assert (route == "dequant") == small_h(C, H)


@pytest.mark.parametrize("reverse", [False, True])
def test_dequant_route_is_bonito_tpu_s_small_h_branch(reverse):
    """A quantised H = 96 layer with a float input: the default route is
    ``dequant``, the dequantised weights through kernel F -- what
    bonito_tpu's ``lstm_int8`` does on a TPU (ops/lstm.py:119-122),
    computed here by hand with the Pallas kernel in interpret mode."""
    N, T, H = 8, 13, 96
    x, w_ih, w_hh, b = _layer(31, N, T, H, H)
    w_hh_q, scales = int8.quantize_whh(w_hh)
    w_ih_q, ih_scales = int8.quantize_cols(w_ih)
    jx = jnp.asarray(x)
    w_ih_d = (jnp.asarray(w_ih_q).astype(jnp.float32)
              * jnp.asarray(ih_scales)).astype(jx.dtype)
    w_hh_d = (jnp.asarray(w_hh_q).astype(jnp.float32) * jnp.asarray(scales)
              * 127.0).astype(jx.dtype)
    ref = np.asarray(jpallas.lstm_pallas_fused(
        jx, w_ih_d, w_hh_d, jnp.asarray(b), reverse=reverse, interpret=True))
    assert int8_route(_t(x), _t(w_hh_q), _t(w_ih_q)) == "dequant"
    out = lstm_int8(_t(x), None, _t(w_hh_q), _t(scales), _t(b),
                    reverse=reverse, w_ih_q=_t(w_ih_q),
                    ih_scales=_t(ih_scales), out_int8=True)
    assert out.dtype == torch.float32  # int8 h only on the fused int8 route
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


def test_fused_lstm_wrapper_takes_the_plain_version_on_the_cpu():
    x, w_ih, w_hh, b = _layer(32, 4, 5, 16, 16)
    args = (_t(x).transpose(0, 1), _t(w_ih), _t(w_hh), _t(b))
    before = lstm_fused.launches
    torch.testing.assert_close(lstm_fused(*args, reverse=True),
                               lstm_fused_plain(*args, reverse=True),
                               rtol=0, atol=0)
    assert lstm_fused.launches == before  # counts kernel launches only


# ---------------------------------------------------------------------------
# (e) the slice as a whole
# ---------------------------------------------------------------------------

class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


@pytest.fixture(scope="module")
def fast_dir(tmp_path_factory):
    """The fast geometry (features 96, 5 layers, state_len 3, stride 5) at
    a small batch and chunk; its config says quantize=true, as shipped."""
    d = tmp_path_factory.mktemp("fast")
    cfg, jm, _ = _fast_pair(num_layers=5, seed=0)
    assert cfg["basecaller"]["quantize"] is True
    jconfig.save_config(cfg, d / "config.toml")
    jckpt.save_params(d / "weights_1.npz", jm.params)
    return d


@pytest.mark.parametrize("quantize", [False, None])
def test_fast_basecall_matches_bonito_tpu_default_routes(fast_dir, quantize,
                                                         monkeypatch):
    """load_model + basecall, f32, each package on its own defaults: the
    fused-head decode (S = 64) and, for the shipped quantize=true, the
    dequantised weights through the small-H LSTM. Sequences and moves
    identical per read, qstrings within one phred step."""
    monkeypatch.delenv("BONITO_TPU_FUSED_HEAD", raising=False)
    jm = jax_load_model(fast_dir, half=False, fuse_bn=True, quantize=quantize)
    pm = load_model(fast_dir, half=False, fuse_bn=True, quantize=quantize,
                    device="cpu")
    lstms = [m for m in pm.encoder.modules() if isinstance(m, nn.LSTM)]
    assert len(lstms) == 5
    assert all(m.quantized == (quantize is None) for m in lstms)
    rng = np.random.default_rng(4)
    reads = [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
             for i, n in enumerate([700, 2400, 5100])]
    kw = dict(chunksize=1000, overlap=200, batchsize=8)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw)}
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
        dq = (np.frombuffer(out[rid]["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(ref[rid]["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert sum(len(r["sequence"]) for r in out.values()) > 0
    if quantize is False:
        # in f32 the two head routes do the same arithmetic (quantised, the
        # TCN route's head runs in int8 and the fused head's in float)
        tcn = {r.read_id: res for r, res in basecall(
            pm, iter(reads[:2]), **kw, head_route="tcn")}
        for rid in tcn:
            assert tcn[rid]["sequence"] == out[rid]["sequence"]
