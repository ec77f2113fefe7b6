"""The port's int8 route on the CPU against bonito_tpu: the weight
quantisers bit for bit, the plain versions of kernels D and E against the
Pallas int8 kernels in interpret mode, the ``lstm_int8`` routes,
``Model.quantize``, the load order, the int8 golden, and the slice as a
whole (forward_tcn and basecall) against bonito_tpu made to take its
fused int8 TPU route in interpret mode.

Tolerances are in int8 steps of 1/127: both sides do the same exact
integer products and the same f32 operations in the same order, so they
agree bit for bit except where tanh/exp differ in the last bit between
XLA and torch and an h lands within that of a half step."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bonito_tpu.ops.lstm as jax_ops_lstm
from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu import nn as jnn
from bonito_tpu.crf.basecall import basecall as jax_basecall
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.ops import lstm_pallas as jpallas
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu_torch import checkpoint, nn
from bonito_tpu_torch.crf.basecall import basecall
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.ops import int8
from bonito_tpu_torch.ops.decode import to_str, viterbi_decode
from bonito_tpu_torch.ops.lstm import int8_route, lstm_int8
from bonito_tpu_torch.ops.lstm_int8_cuda import (
    lstm_int8_fused, lstm_int8_recurrence)
from bonito_tpu_torch.util import load_model

STEP = 1.0 / 127.0
BF16_STEP = 2.0 ** -8  # one bf16 step of |h| in [0.5, 1)
GOLDEN_INT8 = Path(__file__).parent / "golden" / "int8_decode.json"


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


def _layer(seed, N, T, C, H):
    """x [N, T, C] and a layer's float weights, then both packages'
    quantised forms of them (equal, see the first tests)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, T, C)).astype(np.float32)
    w_ih = (rng.normal(size=(C, 4 * H)) / np.sqrt(C)).astype(np.float32)
    w_hh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (0.5 * rng.normal(size=4 * H)).astype(np.float32)
    w_hh_q, scales = int8.quantize_whh(w_hh)
    w_ih_q, ih_scales = int8.quantize_cols(w_ih)
    return x, w_ih, b, w_hh_q, scales, w_ih_q, ih_scales


# ---------------------------------------------------------------------------
# weight quantisers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fn", ["quantize_cols", "quantize_whh"])
@pytest.mark.parametrize("shape", [(16, 64), (128, 512)])
def test_weight_quantisers_equal_bonito_tpu_bit_for_bit(fn, shape):
    rng = np.random.default_rng(shape[0])
    w = rng.normal(size=shape).astype(np.float32)
    w[:, 3] = 0  # an all-zero column takes scale 1
    w[2, 5] = 10 * np.abs(w).max()
    w_q, s = getattr(int8, fn)(w)
    jw_q, js = getattr(jpallas, fn)(w)
    assert w_q.dtype == np.int8 and s.dtype == np.float32
    assert s.shape == (1, shape[1])
    np.testing.assert_array_equal(w_q, np.asarray(jw_q))
    np.testing.assert_array_equal(s, np.asarray(js))
    assert s[0, 3] == (1.0 if fn == "quantize_cols" else np.float32(1 / 127))
    assert not w_q[:, 3].any() and np.abs(w_q).max() == 127


# ---------------------------------------------------------------------------
# plain D and E against the Pallas kernels in interpret mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out_int8", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,C,H", [(8, 13, 32, 32), (8, 7, 128, 128)])
def test_plain_fused_matches_pallas_interpret(N, T, C, H, reverse, out_int8):
    """T is no multiple of block_k=4, so the Pallas side pads."""
    x, _, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(N + T + H, N, T, C, H)
    sx = np.float32(np.abs(x).max() / 127.0)
    x_q = np.round(x / sx).astype(np.int8)
    ref = np.asarray(jpallas.lstm_pallas_int8_fused(
        jnp.asarray(x_q), jnp.asarray(w_ih_q), jnp.asarray(w_hh_q),
        jnp.asarray(ih_scales * sx), jnp.asarray(scales), jnp.asarray(b),
        reverse=reverse, interpret=True, block_k=4, out_int8=out_int8))
    out = lstm_int8_fused(
        _t(x_q).transpose(0, 1), _t(w_ih_q), _t(w_hh_q), _t(ih_scales * sx),
        _t(scales), _t(b), reverse=reverse, out_int8=out_int8).transpose(0, 1)
    assert out.shape == ref.shape
    if out_int8:
        assert out.dtype == torch.int8 and ref.dtype == np.int8
        diff = np.abs(out.numpy().astype(int) - ref.astype(int))
        assert diff.max() <= 1            # one int8 step
        assert (diff == 0).mean() >= 0.99
    else:
        assert out.dtype == torch.bfloat16
        diff = np.abs(out.float().numpy() - ref.astype(np.float32))
        assert diff.max() <= STEP + BF16_STEP


@pytest.mark.parametrize("quantized_projection", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_recurrence_matches_pallas_interpret(reverse,
                                                   quantized_projection):
    N, T, C, H = 8, 11, 32, 32
    x, w_ih, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(5, N, T, C, H)
    kw = (dict(w_ih_q=jnp.asarray(w_ih_q), ih_scales=jnp.asarray(ih_scales))
          if quantized_projection else {})
    ref = np.asarray(jpallas.lstm_pallas_int8(
        jnp.asarray(x), None if quantized_projection else jnp.asarray(w_ih),
        jnp.asarray(w_hh_q), jnp.asarray(scales), jnp.asarray(b),
        reverse=reverse, interpret=True, **kw))
    out = lstm_int8(
        _t(x), None if quantized_projection else _t(w_ih), _t(w_hh_q),
        _t(scales), _t(b), reverse=reverse, route="two_stage",
        **({"w_ih_q": _t(w_ih_q), "ih_scales": _t(ih_scales)}
           if quantized_projection else {}))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert np.abs(out.numpy() - ref).max() <= 2 * STEP


def test_recurrence_carries_h_as_its_int8_rounding():
    """Kernel E's step reads only round(h * 127) of the h it carries: the
    recurrence equals the fused one over a projection made outside."""
    N, T, C, H = 4, 9, 16, 16
    x, _, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(6, N, T, C, H)
    xt = _t(x).transpose(0, 1)
    x_q, step = int8.quantize_dynamic(xt)
    fused = lstm_int8_fused(x_q, _t(w_ih_q), _t(w_hh_q), _t(ih_scales) * step,
                            _t(scales), _t(b), out_int8=True)
    xw = int8.project_int8(xt, _t(w_ih_q), _t(ih_scales), _t(b),
                           torch.float32)
    h = lstm_int8_recurrence(xw, _t(w_hh_q), _t(scales))
    torch.testing.assert_close(int8.quantize_h(h), fused, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the dispatcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True])
def test_dequant_route_matches_bonito_tpu_on_the_cpu(reverse):
    """Off the TPU bonito_tpu's lstm_int8 is its dequantised scan."""
    N, T, C, H = 8, 12, 32, 32
    x, _, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(7, N, T, C, H)
    ref = np.asarray(jax_ops_lstm.lstm_int8(
        jnp.asarray(x), None, jnp.asarray(w_hh_q), jnp.asarray(scales),
        jnp.asarray(b), reverse=reverse, w_ih_q=jnp.asarray(w_ih_q),
        ih_scales=jnp.asarray(ih_scales)))
    out = lstm_int8(_t(x), None, _t(w_hh_q), _t(scales), _t(b),
                    reverse=reverse, w_ih_q=_t(w_ih_q),
                    ih_scales=_t(ih_scales), route="dequant")
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route,out_int8,dtype", [
    ("fused", True, torch.int8), ("fused", False, torch.bfloat16),
    ("two_stage", True, torch.bfloat16), ("dequant", True, torch.bfloat16)])
def test_every_route_takes_an_int8_input(route, out_int8, dtype):
    """An int8 x is a previous layer's round(h * 127); only the fused
    route emits one, the others dequantise to bf16 and stay close to it."""
    N, T, H = 4, 10, 32
    _, _, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(8, N, T, H, H)
    h_prev = np.random.default_rng(8).integers(-127, 128, (N, T, H))
    args = (_t(h_prev.astype(np.int8)), None, _t(w_hh_q), _t(scales), _t(b))
    kw = dict(w_ih_q=_t(w_ih_q), ih_scales=_t(ih_scales))
    out = lstm_int8(*args, **kw, out_int8=out_int8, route=route)
    assert out.dtype == dtype and out.shape == (N, T, H)
    ref = lstm_int8(*args, **kw, out_int8=False, route="fused").float()
    got = out.float() * STEP if dtype == torch.int8 else out.float()
    assert (got - ref).abs().max() <= 0.05


def test_default_route_and_rejections():
    q = torch.zeros(8, 8, dtype=torch.int8)

    def route(H, C=None, dtype=torch.bfloat16, w_ih_q=q):
        return int8_route(torch.zeros(2, 3, C or H, dtype=dtype),
                          torch.zeros(H, 4 * H, dtype=torch.int8), w_ih_q)
    assert route(1024) == "fused"                    # hac
    assert route(1024, dtype=torch.int8) == "fused"  # chained
    assert route(96) == "dequant"                    # fast: through kernel F
    assert route(96, dtype=torch.int8) == "fused"
    assert route(1024, C=1000) == "two_stage"        # C off the int8 tiles
    assert route(1024, w_ih_q=None) == "two_stage"   # float projection
    x, _, b, w_hh_q, scales, w_ih_q, ih_scales = _layer(9, 2, 3, 16, 16)
    with pytest.raises(ValueError, match="route"):
        lstm_int8(_t(x), None, _t(w_hh_q), _t(scales), _t(b), route="scan")
    with pytest.raises(ValueError, match="route"):
        Model(_small_cfg()).quantize(route="scan")
    with pytest.raises(ValueError, match="w_ih_q"):
        lstm_int8(_t(x), _t(x), _t(w_hh_q), _t(scales), _t(b), route="fused")
    with pytest.raises(TypeError, match="int8"):
        lstm_int8_fused(_t(x), _t(w_ih_q), _t(w_hh_q), _t(ih_scales),
                        _t(scales), _t(b))


# ---------------------------------------------------------------------------
# Model.quantize
# ---------------------------------------------------------------------------

def _lstms(model):
    return [m for m in model.encoder.modules() if isinstance(m, nn.LSTM)]


def _head(model):
    return model.decode_head()[1][1]


@pytest.mark.parametrize("num_layers,features", [(5, 64), (3, 32)])
def test_quantize_marks_the_int8_chain_and_the_head(num_layers, features):
    """As bonito_tpu's tests of Model.quantize: every LSTM that feeds
    another or the head chains int8, the head carries int8 weights beside
    the float ones, and the forward still runs."""
    cfg = lstm_crf_config(features=features, num_layers=num_layers,
                          state_len=2, stride=5)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(0))
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    jm.quantize()
    assert pm.quantize() is pm
    jl = [l for l in jm.encoder.sublayers if isinstance(l, jnn.LSTM)]
    assert [l.int8_out for l in _lstms(pm)] == [True] * num_layers == [
        getattr(l, "int8_out", False) for l in jl]
    head = _head(pm)
    assert head.w_q.dtype == torch.int8 and head.w.dtype == torch.float32
    for m in _lstms(pm):
        assert m.quantized and m.w_hh is None and m.w_ih is None
        assert m.w_hh_q.dtype == m.w_ih_q.dtype == torch.int8
        assert m.b.dtype == torch.float32
    # the quantised trees agree key by key, bit for bit
    flat = checkpoint._flatten(_np(jm.params))
    state = pm.state_dict()
    assert set(flat) == set(state)
    for k in ("encoder.4.w_hh_q", "encoder.4.scales", "encoder.5.w_ih_q",
              "encoder.5.ih_scales", f"encoder.{4 + num_layers}.w_q",
              f"encoder.{4 + num_layers}.w_s"):
        np.testing.assert_array_equal(state[k].numpy(), flat[k])
    pm.to_bf16()  # leaves the int8 forms, their scales and b alone
    assert _lstms(pm)[0].scales.dtype == _lstms(pm)[0].b.dtype == torch.float32
    assert head.w_s.dtype == torch.float32 and head.w.dtype == torch.bfloat16
    with torch.no_grad():
        out = pm(torch.ones(1, 100, 1, dtype=torch.bfloat16))
    assert torch.isfinite(out.float()).all()
    with pytest.raises(ValueError, match="quantised"):
        checkpoint.save_params("unused.npz", pm)


def test_glue_between_lstm_and_head_keeps_the_chain():
    enc = nn.Serial([nn.LSTM(16, 16), nn.Permute([1, 0, 2]), nn.LSTM(16, 16),
                     nn.Permute([1, 0, 2]),
                     nn.LinearCRFEncoder(16, 4, 2, blank_score=2.0),
                     nn.LSTM(16, 16), nn.Tanh(), nn.LSTM(16, 16)])
    enc.init_(np.random.default_rng(0))
    from bonito_tpu_torch.crf.model import SeqdistModel
    from bonito_tpu_torch.crf.seqdist import CTC_CRF
    m = SeqdistModel(enc, CTC_CRF(2, ["N", "A", "C", "G", "T"])).quantize()
    assert [l.int8_out for l in _lstms(m)] == [True, True, False, False]
    assert enc.get_submodule("4").w_q is not None


# ---------------------------------------------------------------------------
# load order, carried parameters, golden
# ---------------------------------------------------------------------------

def _small_cfg(**kw):
    return lstm_crf_config(**{**dict(features=32, num_layers=2, state_len=3,
                                     stride=5, batchsize=8, chunksize=1000,
                                     overlap=200), **kw})


def _jax_dir(path, cfg, seed=0):
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(seed))
    _, (crf, _), _ = m.decode_head()
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 5
    jconfig.save_config(cfg, path / "config.toml")
    jckpt.save_params(path / "weights_1.npz", m.params)
    return path


def test_load_quantises_after_the_bf16_cast(tmp_path):
    """half=True, quantize=None on a config that says quantize=true: the
    int8 weights and scales equal bonito_tpu's load of the same directory
    bit for bit — they are those of the bf16-rounded weights, which
    differ from the f32 weights' in many entries."""
    d = _jax_dir(tmp_path, _small_cfg())
    jm = jax_load_model(d, half=True, quantize=None)
    pm = load_model(d, half=True, quantize=None, device="cpu")
    assert pm.config["basecaller"]["quantize"] is True
    flat = checkpoint._flatten(_np(jm.params))
    state = pm.state_dict()
    quantised = [k for k in flat if k.rsplit(".", 1)[1] in (
        "w_hh_q", "scales", "w_ih_q", "ih_scales", "w_q", "w_s")]
    assert len(quantised) == 2 * 4 + 2
    for k in quantised:
        np.testing.assert_array_equal(state[k].numpy(), flat[k], err_msg=k)
    for k in ("encoder.4.b", "encoder.5.b"):  # bf16-rounded, held as f32
        assert state[k].dtype == torch.float32
        np.testing.assert_array_equal(state[k].numpy(),
                                      flat[k].astype(np.float32))
    f32 = load_model(d, half=False, quantize=None, device="cpu").state_dict()
    assert any(not torch.equal(f32[k], state[k]) for k in quantised)
    assert not load_model(d, half=True, device="cpu").encoder.get_submodule(
        "4").quantized  # quantize=False stays the argument's default


def _golden_pair():
    """tests/test_golden.py's build_case, quantised by bonito_tpu, and the
    port's model with that quantised tree carried across."""
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=2, stride=5,
                          clamp=None, scaling_strategy="quantile")
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(42))
    jm.params["encoder"]["6"]["w"] = jm.params["encoder"]["6"]["w"] * 30
    jm.quantize()
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    signal = np.random.default_rng(42).normal(size=(3, 1000)).astype(
        np.float32)
    return jm, pm, signal


def test_int8_golden_reproduced_on_the_dequant_route():
    """tests/golden/int8_decode.json is bonito_tpu's CPU route: the
    dequantised scan feeding the int8 head."""
    _, pm, signal = _golden_pair()
    assert all(m.quantized for m in _lstms(pm)) and _head(pm).w_q is not None
    pm.quantize(route="dequant")  # weights stay; marks chains and the route
    assert all(m.int8_out for m in _lstms(pm))
    with torch.no_grad():
        scores = pm(_t(signal)[..., None])
        out = viterbi_decode(pm.seqdist, scores, qscale=1.05, qbias=0.2)
    golden = json.loads(GOLDEN_INT8.read_text())
    assert [to_str(s) for s in out["sequence"].numpy()] == golden["sequences"]
    assert [to_str(q, qstring=True)
            for q in out["qstring"].numpy()] == golden["qstrings"]


# ---------------------------------------------------------------------------
# the slice as a whole against bonito_tpu's fused int8 route
# ---------------------------------------------------------------------------

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


class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


def test_int8_slice_matches_bonito_tpu_fused_route(tmp_path, monkeypatch):
    """load_model(quantize=None) + forward_tcn + basecall, f32 compute,
    both packages on the fused int8 LSTM route, the int8 head and the TCN
    decode. Observed at this size: the move scores after the Clamp are
    equal (max difference 0.0), sequences and moves identical on every
    read. The scores' tolerance stays 0.05, the size of what one flipped
    int8 step of h can do (a score moves by about |w| / 127), because
    another libm may round a tanh the other way."""
    monkeypatch.setattr(jax_ops_lstm, "lstm_int8", _jax_fused_route)
    monkeypatch.setenv("BONITO_TPU_FUSED_HEAD", "0")
    d = _jax_dir(tmp_path, _small_cfg(num_layers=3))
    jm = jax_load_model(d, half=False, fuse_bn=True, quantize=None)
    pm = load_model(d, half=False, fuse_bn=True, quantize=None, device="cpu",
                    route="fused")
    assert [m.int8_route for m in _lstms(pm)] == ["fused"] * 3
    x = np.random.default_rng(3).normal(size=(4, 500, 1)).astype(np.float32)
    jmv, jblank = jm.forward_tcn(jm.params, jnp.asarray(x))
    with torch.no_grad():
        mv, blank = pm.forward_tcn(_t(x))
    assert blank == jblank and mv.shape == jmv.shape
    assert mv.dtype == torch.float32
    err = np.abs(mv.numpy() - np.asarray(jmv)).max()
    assert err <= 0.05, err

    rng = np.random.default_rng(4)
    reads = [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
             for i, n in enumerate([700, 2400, 5100])]
    kw = dict(chunksize=1000, overlap=200, batchsize=8)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw,
                                                 head_route="tcn")}
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
        dq = (np.frombuffer(out[rid]["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(ref[rid]["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert sum(len(r["sequence"]) for r in out.values()) > 0


def test_make_contiguous_keeps_the_int8_chain(tmp_path, monkeypatch):
    """MakeContiguous (layout glue of torch-layout configs) between two
    quantised LSTMs of a model built from a dict: the first still emits
    int8 h, as bonito_tpu marks it, and the slice gives bonito_tpu's
    moves on its fused int8 route (f32, as
    test_int8_slice_matches_bonito_tpu_fused_route)."""
    monkeypatch.setattr(jax_ops_lstm, "lstm_int8", _jax_fused_route)
    monkeypatch.setenv("BONITO_TPU_FUSED_HEAD", "0")
    cfg = _small_cfg(num_layers=2)
    layers = cfg["encoder"]["sublayers"]
    first = next(i for i, l in enumerate(layers) if l["type"] == "lstm")
    layers.insert(first + 1, {"type": "makecontiguous"})
    d = _jax_dir(tmp_path, cfg)
    jm = jax_load_model(d, half=False, fuse_bn=True, quantize=None)
    pm = load_model(d, half=False, fuse_bn=True, quantize=None, device="cpu",
                    route="fused")
    assert isinstance(pm.encoder.get_submodule(str(first + 1)),
                      nn.MakeContiguous)
    jl = [l for l in jm.encoder.sublayers if isinstance(l, jnn.LSTM)]
    assert [l.int8_out for l in _lstms(pm)] == [
        getattr(l, "int8_out", False) for l in jl] == [True, True]
    x = np.random.default_rng(3).normal(size=(4, 500, 1)).astype(np.float32)
    jmv, _ = jm.forward_tcn(jm.params, jnp.asarray(x))
    with torch.no_grad():
        mv, _ = pm.forward_tcn(_t(x))
    err = np.abs(mv.numpy() - np.asarray(jmv)).max()
    assert err <= 0.05, err
    rng = np.random.default_rng(4)
    reads = [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
             for i, n in enumerate([700, 2400])]
    kw = dict(chunksize=1000, overlap=200, batchsize=8)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw,
                                                 head_route="tcn")}
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        assert out[rid]["sequence"] == ref[rid]["sequence"]
        np.testing.assert_array_equal(out[rid]["moves"], ref[rid]["moves"])
    assert sum(len(r["sequence"]) for r in out.values()) > 0
