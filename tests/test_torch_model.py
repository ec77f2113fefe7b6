"""Layer-by-layer parity of the port with bonito_tpu under
``params_from_jax`` (f32, tolerance 2e-4 as bonito_tpu's own CRF-encoder
suite), checkpoint interchange, ``load_model`` on the CPU, and the
full-width hac golden reproduced by the port alone."""

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
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.models import lstm_crf_config as jax_lstm_crf_config
from bonito_tpu_torch import checkpoint, nn
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.ops.decode import to_str, viterbi_decode_tcn
from bonito_tpu_torch.util import load_model

TOL = 2e-4
GOLDEN_HAC = Path(__file__).parent / "golden" / "hac_shipped_shape.json"


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_pool():
    """The suite runs test files side by side in worker processes that
    use every core already. bonito_tpu's hac init runs its QRs through
    scipy's OpenBLAS, whose idle threads spin: with a pool of its own per
    worker the init took 120 s instead of 7 s on a loaded host."""
    import scipy.linalg.cython_lapack  # noqa: F401 (the library JAX's QR uses)
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _x(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _close(port_out, jax_out):
    np.testing.assert_allclose(port_out.detach().numpy(), np.asarray(jax_out),
                               rtol=TOL, atol=TOL)


def _conv_pair(stride=1):
    kw = dict(insize=4, size=8, winlen=5, stride=stride, padding=2,
              activation="swish", norm="batchnorm")
    jl = jnn.Convolution(**kw)
    p = _np(jl.init_params(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    p["b"] = rng.normal(size=8).astype(np.float32)
    p["norm"] = {"scale": rng.uniform(0.5, 1.5, 8).astype(np.float32),
                 "bias": rng.normal(size=8).astype(np.float32),
                 "mean": rng.normal(size=8).astype(np.float32),
                 "var": rng.uniform(0.5, 2.0, 8).astype(np.float32)}
    return jl, p, checkpoint.params_from_jax(nn.Convolution(**kw), p)


@pytest.mark.parametrize("stride", [1, 3])
def test_convolution_with_batchnorm(stride):
    jl, p, pl = _conv_pair(stride)
    x = _x(3, (2, 30, 4))
    _close(pl(torch.from_numpy(x)), jl.apply(p, jnp.asarray(x)))


def test_convolution_fuse_bn():
    jl, p, pl = _conv_pair()
    x = _x(4, (2, 30, 4))
    unfused = pl(torch.from_numpy(x))
    nn.fuse_bn(pl)
    assert pl.norm is None
    jp = jnn.fuse_bn(jl, {k: dict(v) if isinstance(v, dict) else v
                          for k, v in p.items()})
    np.testing.assert_array_equal(pl.w.detach().numpy(),
                                  np.asarray(jp["w"]).transpose(2, 1, 0))
    np.testing.assert_array_equal(pl.b.detach().numpy(), np.asarray(jp["b"]))
    fused = pl(torch.from_numpy(x))
    _close(fused, jl.apply(jp, jnp.asarray(x)))
    torch.testing.assert_close(fused, unfused, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer(reverse):
    jl = jnn.LSTM(32, 16, reverse=reverse)
    p = _np(jl.init_params(jax.random.PRNGKey(5)))
    pl = checkpoint.params_from_jax(nn.LSTM(32, 16, reverse=reverse), p)
    x = _x(6, (4, 11, 16))
    _close(pl(torch.from_numpy(x)), jl.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("scale,activation", [(None, None), (5.0, "tanh")])
def test_crf_head_and_clamp(scale, activation):
    kw = dict(insize=16, n_base=4, state_len=2, bias=True, scale=scale,
              activation=activation, blank_score=2.0)
    jl = jnn.LinearCRFEncoder(**kw)
    p = _np(jl.init_params(jax.random.PRNGKey(7)))
    p["w"] = p["w"] * 4
    p["b"] = np.random.default_rng(8).normal(size=p["b"].shape).astype(
        np.float32)
    pl = checkpoint.params_from_jax(nn.LinearCRFEncoder(**kw), p)
    x = _x(9, (2, 5, 16))
    out = pl(torch.from_numpy(x))
    ref = jl.apply(p, jnp.asarray(x))
    _close(out, ref)
    _close(nn.Clamp(-5.0, 5.0)(out), jnn.Clamp(-5.0, 5.0).apply({}, ref))


def _small_pair(seed=11):
    cfg = jax_lstm_crf_config(features=32, num_layers=3, state_len=3,
                              stride=5, chunksize=1000, overlap=200)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(seed))
    _, (crf, _), _ = jm.decode_head()
    jm.params["encoder"][crf]["w"] = jm.params["encoder"][crf]["w"] * 5
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    return cfg, jm, pm


def test_forward_and_forward_tcn_match_jax():
    _, jm, pm = _small_pair()
    x = _x(12, (2, 500, 1))
    with torch.no_grad():
        _close(pm(torch.from_numpy(x)), jm.forward(jnp.asarray(x)))
        mv, blank = pm.forward_tcn(torch.from_numpy(x))
    jmv, jblank = jm.forward_tcn(jm.params, jnp.asarray(x))
    assert blank == jblank
    assert mv.shape == jmv.shape
    _close(mv, jmv)


def test_params_round_trip_through_jax_npz(tmp_path):
    """The port writes bonito_tpu's npz format; bonito_tpu reads it back
    to the same tree, and the port reads bonito_tpu's."""
    _, jm, pm = _small_pair()
    checkpoint.save_params(tmp_path / "port.npz", pm)
    back = _np(jckpt.load_params(tmp_path / "port.npz"))
    flat_j = checkpoint._flatten(_np(jm.params))
    flat_b = checkpoint._flatten(back)
    assert flat_j.keys() == flat_b.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_b[k], flat_j[k])
    jckpt.save_params(tmp_path / "jax.npz", jm.params)
    again = checkpoint.params_from_jax(
        Model(pm.config), checkpoint.load_params(tmp_path / "jax.npz"))
    for (k, a), (_, b) in zip(pm.state_dict().items(),
                              again.state_dict().items()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


def test_params_from_jax_rejects_a_mismatch():
    _, jm, pm = _small_pair()
    flat = checkpoint._flatten(_np(jm.params))
    flat.pop("encoder.4.w_hh")
    with pytest.raises(KeyError, match="encoder.4.w_hh"):
        checkpoint.params_from_jax(pm, flat)


def test_load_model_on_cpu(tmp_path):
    """A directory written by bonito_tpu loads in the port (package name
    mapped, chunksize/overlap rounded to the stride, BN fused)."""
    cfg, jm, _ = _small_pair()
    cfg["basecaller"]["quantize"] = False
    jconfig.save_config(cfg, tmp_path / "config.toml")
    jckpt.save_params(tmp_path / "weights_1.npz", jm.params)
    m = load_model(tmp_path, half=False, fuse_bn=True, device="cpu")
    assert m.config["basecaller"]["chunksize"] == 1000
    assert m.config["basecaller"]["overlap"] == 200
    assert all(l.norm is None for l in m.encoder.modules()
               if isinstance(l, nn.Convolution))
    x = _x(13, (2, 500, 1))
    with torch.no_grad():
        _close(m(torch.from_numpy(x)), jm.forward(jnp.asarray(x)))
    cfg["basecaller"]["quantize"] = True  # the shipped configs' default
    jconfig.save_config(cfg, tmp_path / "config.toml")
    q = load_model(tmp_path, half=False, quantize=None, device="cpu")
    lstms = [l for l in q.encoder.modules() if isinstance(l, nn.LSTM)]
    assert len(lstms) == 3 and all(l.quantized and l.int8_out for l in lstms)
    assert all(l.w_hh_q.dtype == l.w_ih_q.dtype == torch.int8 for l in lstms)
    assert q.decode_head()[1][1].w_q.dtype == torch.int8
    with torch.no_grad():  # H=32 takes the dequantised small-H route
        out = q(torch.from_numpy(x))
    assert out.shape == (2, 100, 64 * 5)
    assert (out - m(torch.from_numpy(x))).abs().max() < 0.5


def test_load_model_quantises_the_shipped_hac_geometry(tmp_path):
    """quantize=None on a full-width hac directory (the config's default is
    quantize=true): five LSTMs with int8 weights, all chained int8 (four
    feed an LSTM, the last the head), and an int8 head beside the float."""
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.models import lstm_crf_config
    cfg = lstm_crf_config()
    assert cfg["basecaller"]["quantize"] is True
    save_config(cfg, tmp_path / "config.toml")
    checkpoint.save_params(tmp_path / "weights_1.npz", Model(cfg).init(3))
    m = load_model(tmp_path, quantize=None, device="cpu")
    lstms = [l for l in m.encoder.modules() if isinstance(l, nn.LSTM)]
    assert [l.int8_out for l in lstms] == [True] * 5
    for l in lstms:
        assert l.quantized and l.int8_route is None
        assert l.w_hh_q.dtype == l.w_ih_q.dtype == torch.int8
        assert l.w_hh_q.shape == l.w_ih_q.shape == (1024, 4096)
        assert l.scales.dtype == l.ih_scales.dtype == l.b.dtype == torch.float32
    head = m.decode_head()[1][1]
    assert head.w_q.dtype == torch.int8 and head.w_q.shape == (1024, 4096)
    assert head.w_s.shape == (1, 4096) and head.w.dtype == torch.bfloat16
    assert m.compute_dtype == torch.bfloat16


def test_hac_full_width_golden():
    """The shipped hac geometry (1024 features, S=1024, stride 6, Clamp
    head) reproduces tests/golden/hac_shipped_shape.json through the
    port's forward_tcn + decode, with the weights of the golden's JAX
    model carried across in f32."""
    cfg = jax_lstm_crf_config(scaling_strategy="quantile")
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(99))
    _, (crf, _), _ = jm.decode_head()
    jm.params["encoder"][crf]["w"] = jm.params["encoder"][crf]["w"] * 5
    pm = checkpoint.params_from_jax(Model(cfg), _np(jm.params))
    signal = np.random.default_rng(99).normal(size=(2, 600)).astype(
        np.float32)
    with torch.no_grad():
        mv, blank = pm.forward_tcn(torch.from_numpy(signal)[..., None])
        out = viterbi_decode_tcn(pm.seqdist, mv, blank, qscale=1.05,
                                 qbias=0.2)
    golden = json.loads(GOLDEN_HAC.read_text())
    assert [to_str(s) for s in out["sequence"].numpy()] == golden["sequences"]
    for q, g in zip(out["qstring"].numpy(), golden["qstrings"]):
        got = np.frombuffer(to_str(q, qstring=True).encode(), np.uint8)
        want = np.frombuffer(g.encode(), np.uint8)
        assert got.shape == want.shape
        assert np.abs(got.astype(int) - want).max() <= 1
