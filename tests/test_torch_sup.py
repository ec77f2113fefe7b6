"""The port's transformer-CRF (sup) path on the CPU against bonito_tpu:
every module of the family with carried weights, the checkpoint converter
both ways, the goldens ``transformer_decode`` and ``sup_shipped_shape``
(full width, batch 1), and the slice as a whole: ``load_model`` +
``basecall`` of a small sup-geometry directory on both attention routes.

bonito_tpu takes its fused attention kernel on a TPU only; where a test
compares that route, it forces it from here, in interpret mode."""

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
from bonito_tpu.models import get_config
from bonito_tpu.models import transformer_crf_config as jax_sup_config
from bonito_tpu.ops import attention_pallas as jpallas
from bonito_tpu.transformer import model as jtransformer
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu_torch import checkpoint, nn
from bonito_tpu_torch.crf.basecall import basecall, make_compute_fn
from bonito_tpu_torch.crf.model import SeqdistModel
from bonito_tpu_torch.models import MODELS, transformer_crf_config
from bonito_tpu_torch.ops import decode
from bonito_tpu_torch.transformer import model as transformer
from bonito_tpu_torch.transformer.model import set_attn_route
from bonito_tpu_torch.util import load_model, load_symbol

GOLDEN = Path(__file__).parent / "golden"
SMALL = dict(d_model=64, nhead=4, depth=3, dim_feedforward=128, state_len=3,
             batchsize=8, chunksize=2400, overlap=240)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fused(monkeypatch):
    """bonito_tpu on its fused attention kernel, in interpret mode."""
    kernel, gate = (jpallas.fused_rotary_window_attention,
                    jpallas.fused_supported)
    monkeypatch.setattr(
        jpallas, "fused_rotary_window_attention",
        lambda qkv, cos, sin, window, block=128, interpret=False,
        t_real=None: kernel(qkv, cos, sin, window, block, True, t_real))
    monkeypatch.setattr(
        jpallas, "fused_supported",
        lambda qkv, window, rotary_dim, block=128, require_tpu=True:
        gate(qkv, window, rotary_dim, block, False))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _fill(module, params):
    """Carry a bonito_tpu parameter (sub)tree into a port module."""
    flat = checkpoint._flatten(_np(params))
    state = module.state_dict()
    assert set(flat) == set(state)
    with torch.no_grad():
        for k, v in state.items():
            v.copy_(_t(flat[k]))
    return module


def _pair(seed=3, **kw):
    cfg = jax_sup_config(**{**SMALL, **kw})
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(seed))
    pm = checkpoint.params_from_jax(transformer.Model(cfg), _np(jm.params))
    return cfg, jm, pm


# ---------------------------------------------------------------------------
# modules, f32, weights carried across: 2e-4
# ---------------------------------------------------------------------------

def test_rmsnorm_and_gated_mlp_match_bonito_tpu():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 50, 64)).astype(np.float32) * 3
    jn = jtransformer.RMSNorm(64)
    scale = rng.normal(size=64).astype(np.float32)
    pn = _fill(transformer.RMSNorm(64), {"scale": scale})
    np.testing.assert_allclose(
        pn(_t(x)).detach().numpy(),
        np.asarray(jn.apply({"scale": jnp.asarray(scale)}, jnp.asarray(x))),
        atol=2e-5)
    out16 = pn(_t(x).to(torch.bfloat16))
    assert out16.dtype == torch.bfloat16  # f32 inside, the input's type out
    jf = jtransformer.GatedMlp(64, 128)
    p = jf.init_params(jax.random.PRNGKey(1))
    pf = _fill(transformer.GatedMlp(64, 128), p)
    np.testing.assert_allclose(pf(_t(x)).detach().numpy(),
                               np.asarray(jf.apply(p, jnp.asarray(x))),
                               atol=2e-4)
    assert transformer.deepnorm_params(18) == jtransformer.deepnorm_params(18)


@pytest.mark.parametrize("T,window,rotary_dim", [
    (300, (127, 128), None), (256, (63, 64), 16), (130, None, None)])
def test_attention_layer_local_route_matches_bonito_tpu(T, window, rotary_dim):
    """apply_rotary + attend: what bonito_tpu computes on the CPU."""
    x = np.random.default_rng(T).normal(size=(2, T, 64)).astype(np.float32)
    kw = dict(qkv_bias=True, out_bias=True, rotary_dim=rotary_dim,
              attn_window=window)
    ja = jtransformer.MultiHeadAttention(64, 4, **kw)
    p = ja.init_params(jax.random.PRNGKey(2))
    p["qkv_b"] = jnp.asarray(
        np.random.default_rng(1).normal(size=192).astype(np.float32))
    pa = _fill(transformer.MultiHeadAttention(64, 4, **kw), p)
    pa.attn_route = "local"
    assert pa.route(torch.empty(2, T, 3, 4, 16)) == "local"
    np.testing.assert_allclose(pa(_t(x)).detach().numpy(),
                               np.asarray(ja.apply(p, jnp.asarray(x))),
                               atol=2e-4)


@pytest.mark.parametrize("T,rotary_dim", [(300, None), (256, 16)])
def test_attention_layer_fused_route_matches_bonito_tpu(T, rotary_dim,
                                                        jax_fused):
    """The default route where the fused kernel takes the shape. Both
    sides round q, k, v and p to bf16 inside, in an f32 model too; a
    rounding can flip between them, so 2e-3 here and not 2e-4."""
    x = np.random.default_rng(T).normal(size=(2, T, 64)).astype(np.float32)
    kw = dict(rotary_dim=rotary_dim, attn_window=(127, 128))
    ja = jtransformer.MultiHeadAttention(64, 4, **kw)
    p = ja.init_params(jax.random.PRNGKey(2))
    pa = _fill(transformer.MultiHeadAttention(64, 4, **kw), p)
    assert pa.attn_route is None
    assert pa.route(torch.empty(2, T, 3, 4, 16)) == "fused"
    ref = np.asarray(ja.apply(p, jnp.asarray(x)))
    out = pa(_t(x)).detach().numpy()
    np.testing.assert_allclose(out, ref, atol=2e-3)
    pa.attn_route = "local"
    exact = pa(_t(x)).detach().numpy()
    assert 1e-5 < np.abs(out - exact).max() < 2e-2  # the routes do differ


def test_attention_route_by_shape_and_by_name():
    """A head the fused kernel rejects (D = 40: rotary_dim 40 is no
    multiple of 16) takes the local route by default; the only route to
    name is the local one."""
    a = transformer.MultiHeadAttention(320, 8, attn_window=(127, 128))
    assert a.route(torch.empty(1, 50, 3, 8, 40)) == "local"
    b = transformer.MultiHeadAttention(64, 4, attn_window=(127, 128))
    qkv = torch.empty(1, 50, 3, 4, 16)
    assert b.route(qkv) == "fused"
    assert set_attn_route(b, "local").route(qkv) == "local"
    for name in ("fused", "flash"):
        with pytest.raises(ValueError, match="attn_route"):
            set_attn_route(b, name)
    assert set_attn_route(b, None).attn_route is None
    assert b.route(qkv) == "fused"


def test_encoder_layer_and_stack_match_bonito_tpu():
    """A Stack of two layers behind a conv, then one layer alone."""
    alpha, beta = jtransformer.deepnorm_params(2)
    spec = {"type": "transformerencoderlayer", "d_model": 64, "nhead": 4,
            "dim_feedforward": 128, "deepnorm_alpha": alpha,
            "deepnorm_beta": beta, "attn_window": [31, 32]}
    tree = {"type": "serial", "sublayers": [
        {"type": "convolution", "insize": 1, "size": 64, "winlen": 5,
         "stride": 2, "padding": 2, "activation": "swish"},
        {"type": "stack", "depth": 2, "layer": spec}]}
    jenc, penc = jnn.from_dict(tree), nn.from_dict(tree)
    assert nn.to_dict(penc) == jnn.to_dict(jenc)
    p = jenc.init_params(jax.random.PRNGKey(4))
    checkpoint.params_from_jax(penc, _np(p))
    set_attn_route(penc, "local")
    x = np.random.default_rng(5).normal(size=(2, 240, 1)).astype(np.float32)
    stack = getattr(penc, "1")
    out = penc(_t(x)).detach()
    assert out.shape == (2, 120, 64)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jenc.apply(p, jnp.asarray(x))),
                               atol=2e-4)
    layer = getattr(stack, "0")
    h = np.random.default_rng(6).normal(size=(2, 90, 64)).astype(np.float32)
    np.testing.assert_allclose(
        layer(_t(h)).detach().numpy(),
        np.asarray(jenc.sublayers[1].sublayers[0].apply(
            p["1"]["0"], jnp.asarray(h))), atol=2e-4)


def test_stack_pins_its_input_once():
    """The pin runs once, at the stack's input, and hands the layers a
    contiguous tensor; a stack of layers that do not ask has none."""
    from bonito_tpu_torch.ops import relayout
    calls = []
    orig = nn.pin_layout
    try:
        nn.pin_layout = lambda x: (calls.append(x.is_contiguous()), orig(x))[1]
        alpha, beta = transformer.deepnorm_params(2)
        stack = nn.Stack([transformer.TransformerEncoderLayer(
            32, 2, 64, alpha, beta, [7, 8]) for _ in range(2)])
        stack.init_(np.random.default_rng(0))
        x = torch.randn(2, 32, 20).transpose(1, 2)
        assert stack(x).shape == (2, 20, 32) and calls == [False]
        assert nn.Stack([nn.Tanh(), nn.Tanh()])(x).shape == (2, 20, 32)
        assert calls == [False]
    finally:
        nn.pin_layout = orig
    assert relayout.pin_layout.launches == 0  # the CPU runs the plain version


def test_whole_small_encoder_matches_bonito_tpu():
    """conv x 5, 3 layers, upsample, CRF head; f32. The local route at
    2e-3 (the tolerance of bonito_tpu's transformer parity tests is 2e-3
    to 4e-3); strides, names and config round-trip as bonito_tpu's."""
    cfg, jm, pm = _pair()
    assert isinstance(pm, SeqdistModel) and pm.stride == jm.stride == 6
    assert pm.to_dict()["encoder"] == jm.to_dict()["encoder"]
    assert {"encoder.conv.0.w", "encoder.transformer_encoder.2.self_attn.wqkv",
            "encoder.upsample.w", "encoder.crf.w"} <= set(pm.state_dict())
    x = np.random.default_rng(7).normal(size=(2, 1800, 1)).astype(np.float32)
    ref = np.asarray(jm.forward(jnp.asarray(x)))
    with torch.no_grad():
        out = set_attn_route(pm, "local")(_t(x)).numpy()
        mv, blank = pm.forward_tcn(_t(x))
    assert out.shape == ref.shape == (2, 300, 64 * 5)
    np.testing.assert_allclose(out, ref, atol=2e-3)
    jmv, jblank = jm.forward_tcn(jm.params, jnp.asarray(x))
    assert blank == jblank == 2.0 and mv.shape == (300, 256, 2)
    np.testing.assert_allclose(mv.numpy(), np.asarray(jmv), atol=2e-3)


# ---------------------------------------------------------------------------
# configs, init, checkpoints, what waits
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["dna_r10.4.1_e8.2_400bps_sup@v5.0",
                                  "rna004_130bps_sup@v5.0"])
def test_sup_configs_are_bonito_tpu_s(name):
    mine, theirs = MODELS[name](), get_config(name)
    assert mine["model"].pop("package") == "bonito.transformer"
    assert theirs["model"].pop("package") == "bonito_tpu.transformer"
    assert mine == theirs
    assert "quantize" not in mine["basecaller"]
    assert mine["basecaller"] == {"batchsize": 128, "chunksize": 12000,
                                  "overlap": 600}
    for package in ("bonito.transformer", "bonito_tpu.transformer"):
        assert load_symbol({"model": {"package": package}},
                           "Model") is transformer.Model


def test_init_draws_deepnorm_scaled_weights_from_the_seed():
    cfg = transformer_crf_config(**SMALL)
    a, b = (transformer.Model(cfg).init(11) for _ in range(2))
    c = transformer.Model(cfg).init(12)
    wa = a.state_dict()["encoder.transformer_encoder.1.self_attn.wqkv"]
    assert torch.equal(wa, b.state_dict()[
        "encoder.transformer_encoder.1.self_attn.wqkv"])
    assert not torch.equal(wa, c.state_dict()[
        "encoder.transformer_encoder.1.self_attn.wqkv"])
    beta = cfg["model"]["encoder"]["transformer_encoder"]["layer"][
        "deepnorm_beta"]
    d = 64
    qk, v = wa[:, :2 * d], wa[:, 2 * d:]
    np.testing.assert_allclose(qk.std().item(), (2 / (3 * d)) ** 0.5, rtol=0.1)
    np.testing.assert_allclose(v.std().item(), beta * (2 / (2 * d)) ** 0.5,
                               rtol=0.1)
    assert (a.state_dict()["encoder.transformer_encoder.0.norm1.scale"]
            == 1).all()


def test_checkpoint_round_trip_both_ways(tmp_path):
    """params_from_jax takes every key of a sup tree and leaves none; a
    directory the port writes loads in bonito_tpu and scores the same."""
    cfg, jm, pm = _pair(seed=8)
    flat = checkpoint._flatten(_np(jm.params))
    assert set(flat) == set(pm.state_dict())
    w = flat["encoder.conv.2.w"]                        # [W, I, O] there
    assert w.shape == (9, 64, 128)
    np.testing.assert_array_equal(
        pm.state_dict()["encoder.conv.2.w"].numpy(), w.transpose(2, 1, 0))
    with pytest.raises(KeyError, match="missing"):
        checkpoint.params_from_jax(
            transformer.Model(cfg),
            {k: v for k, v in flat.items() if "norm2" not in k})
    with pytest.raises(KeyError, match="unexpected"):
        checkpoint.params_from_jax(transformer.Model(cfg),
                                   {**flat, "encoder.crf.b": np.zeros(256)})
    from bonito_tpu_torch.config import save_config
    port_cfg = transformer_crf_config(**SMALL)
    save_config(port_cfg, tmp_path / "config.toml")
    checkpoint.save_params(tmp_path / "weights_1.npz", pm)
    back = jax_load_model(tmp_path, half=False)
    x = np.random.default_rng(9).normal(size=(1, 1200, 1)).astype(np.float32)
    np.testing.assert_allclose(np.asarray(back.forward(jnp.asarray(x))),
                               np.asarray(jm.forward(jnp.asarray(x))),
                               atol=1e-6)
    again = load_model(tmp_path, half=False, device="cpu")
    for k, v in pm.state_dict().items():
        assert torch.equal(v, again.state_dict()[k])


def test_quantize_of_a_transformer_model_waits_and_says_so(tmp_path):
    cfg, jm, _ = _pair()
    jconfig.save_config(cfg, tmp_path / "config.toml")
    jckpt.save_params(tmp_path / "weights_1.npz", jm.params)
    with pytest.raises(NotImplementedError, match="amax"):
        load_model(tmp_path, quantize=True, device="cpu")
    m = load_model(tmp_path, quantize=None, device="cpu")  # no key: bf16
    assert m.compute_dtype == torch.bfloat16
    assert m.config["basecaller"]["chunksize"] == 2400
    assert m.config["basecaller"]["overlap"] == 240


def test_from_dict_names_what_is_still_unported():
    """An unknown type raises; reverse, once unported, builds now."""
    with pytest.raises(NotImplementedError, match="unknown layer type"):
        nn.from_dict({"type": "no-such-layer", "sublayers": []})
    layer = nn.from_dict({"type": "reverse", "sublayers": []})
    assert isinstance(layer, nn.Reverse) and nn.to_dict(layer) == {
        "type": "reverse", "sublayers": []}


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _strings(out):
    return {"sequences": [decode.to_str(s) for s in out["sequence"].numpy()],
            "qstrings": [decode.to_str(q, qstring=True)
                         for q in out["qstring"].numpy()]}


def _assert_golden(got, name, bases_off=0):
    """Sequences identical but for ``bases_off`` substituted bases in all,
    qstrings within one phred step at the bases that agree."""
    want = json.loads((GOLDEN / name).read_text())
    assert [len(s) for s in got["sequences"]] == [
        len(s) for s in want["sequences"]]
    off = 0
    for key in ("sequences", "qstrings"):
        for a, b in zip(got[key], want[key]):
            a, b = (np.frombuffer(s.encode(), np.uint8).astype(int)
                    for s in (a, b))
            if key == "sequences":
                same = a == b
                off += int((~same).sum())
            else:
                assert np.abs(a - b)[same].max(initial=0) <= 1
    assert off <= bases_off


def test_transformer_decode_golden_reproduced():
    """tests/golden/transformer_decode.json (tests/test_golden.py:
    compute_transformer_case): full scores + the scan decode. The case
    multiplies the CRF weight by 30, so 70% of its scores sit on tanh's
    saturation at +-5 and paths tie: with bonito_tpu's own scores the
    port's decode gives the golden exactly, with the port's scores (4e-4
    away after the x 30) one base of the 500 is another letter. Pinned:
    moves identical, at most that one base."""
    cfg = jax_sup_config(d_model=64, nhead=2, depth=2, dim_feedforward=128,
                         state_len=2, conv_stride=12, attn_window=(15, 16))
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(7))
    jm.params["encoder"]["crf"]["w"] = jm.params["encoder"]["crf"]["w"] * 30
    pm = checkpoint.params_from_jax(transformer.Model(cfg), _np(jm.params))
    set_attn_route(pm, "local")
    signal = np.random.default_rng(7).normal(size=(2, 1536)).astype(np.float32)
    jscores = np.asarray(jm.forward(jnp.asarray(signal)[..., None]))
    with torch.no_grad():
        scores = pm(_t(signal)[..., None])
        out = decode.viterbi_decode(pm.seqdist, scores)
        exact = decode.viterbi_decode(pm.seqdist, _t(jscores))
    np.testing.assert_allclose(scores.numpy(), jscores, atol=2e-3)
    _assert_golden(_strings(exact), "transformer_decode.json")
    _assert_golden(_strings(out), "transformer_decode.json", bases_off=1)


def test_sup_shipped_shape_golden_reproduced():
    """tests/golden/sup_shipped_shape.json (compute_sup_shipped_case): the
    shipped sup geometry, 18 layers of d 512, batch 1, 2400 samples, f32,
    through forward_tcn + the TCN decode on the local attention route,
    which is what bonito_tpu computes on the CPU."""
    cfg = jax_sup_config()
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(123))
    pm = checkpoint.params_from_jax(transformer.Model(cfg), _np(jm.params))
    set_attn_route(pm, "local")
    assert pm.stride == 6 and pm.seqdist.n_states == 1024
    signal = np.random.default_rng(123).normal(size=(1, 2400)).astype(
        np.float32)
    with torch.no_grad():
        mv, blank = pm.forward_tcn(_t(signal)[..., None])
        assert mv.shape == (400, 4096, 1)
        out = decode.viterbi_decode_tcn(pm.seqdist, mv, blank, qscale=1.0,
                                        qbias=0.0)
    _assert_golden(_strings(out), "sup_shipped_shape.json")


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------

class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


@pytest.fixture(scope="module")
def sup_dir(tmp_path_factory):
    """A sup-geometry directory written by bonito_tpu: 5 convs, 3 layers of
    d 64 with 4 heads (D 16), window (127, 128), upsample, 64-state CRF."""
    d = tmp_path_factory.mktemp("sup")
    cfg = jax_sup_config(**SMALL)
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(5))
    jconfig.save_config(cfg, d / "config.toml")
    jckpt.save_params(d / "weights_1.npz", jm.params)
    return d


def _reads():
    rng = np.random.default_rng(4)
    return [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
            for i, n in enumerate([1500, 5000, 9000, 20000])]


def _compare(out, ref):
    """(frames whose move differs, all frames, reads whose sequence
    differs); qstrings within one step wherever the sequence agrees."""
    n_diff = n_all = n_seq = 0
    for rid in ref:
        got, want = out[rid], ref[rid]
        assert got["stride"] == want["stride"] == 6
        n_all += len(want["moves"])
        n_diff += int((got["moves"] != want["moves"]).sum())
        if got["sequence"] != want["sequence"]:
            n_seq += 1
            continue
        dq = (np.frombuffer(got["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(want["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    return n_diff, n_all, n_seq


# moves that may differ in bf16, of 5916 frames: bonito_tpu's bf16 on the
# CPU rounds elsewhere than torch's from the first convolution on (40% of
# the conv outputs differ by a bf16 step), so near-ties fall otherwise.
# Seen: 41 (local) and 43 (fused).
BF16_FRAMES = 60


@pytest.mark.parametrize("half", [False, True])
@pytest.mark.parametrize("route", ["local", "fused"])
def test_sup_basecall_matches_bonito_tpu(sup_dir, route, half, request):
    """load_model + basecall per read. ``attn_route="local"`` at load against
    bonito_tpu's CPU default; the default route (fused by shape) against
    bonito_tpu forced onto its fused kernel in interpret mode. f32:
    sequences and moves identical, qstrings within one step. bf16: at most
    BF16_FRAMES of the frames (1%) differ."""
    if route == "fused":
        request.getfixturevalue("jax_fused")
    kw = dict(chunksize=2400, overlap=240, batchsize=8)
    reads = _reads()
    jm = jax_load_model(sup_dir, half=half, fuse_bn=True)
    ref = {r.read_id: res for r, res in jax_basecall(jm, iter(reads), **kw)}
    pm = load_model(sup_dir, half=half, fuse_bn=True, device="cpu",
                    attn_route="local" if route == "local" else None)
    attn = [m for m in pm.modules() if hasattr(m, "attn_route")]
    assert len(attn) == 3
    out = {r.read_id: res for r, res in basecall(pm, iter(reads), **kw)}
    assert all(m.attn_route == (route if route == "local" else None)
               and m.route(torch.empty(1, 9, 3, 4, 16)) == route
               for m in attn)
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    n_diff, n_all, n_seq = _compare(out, ref)
    assert n_all == 5916
    assert sum(len(r["sequence"]) for r in out.values()) > 1000
    if half:
        assert n_diff <= BF16_FRAMES
    else:
        assert n_diff == 0 and n_seq == 0


def test_compute_fn_runs_the_tcn_decode_for_a_1024_state_head(sup_dir):
    """S = 64 here takes the fused head by default; the shipped S = 1024
    takes the TCN route (``use_fused_head``). Both run on a sup model."""
    pm = load_model(sup_dir, half=False, device="cpu", attn_route="local")
    assert decode.use_fused_head(pm.seqdist)
    x = np.random.default_rng(1).normal(size=(2, 2400))
    a = make_compute_fn(pm, 8, 2400, head_route="tcn")(x)
    b = make_compute_fn(pm, 8, 2400)(x)
    assert a["sequence"].shape == (2, 400)
    np.testing.assert_array_equal(a["sequence"], b["sequence"])
    full = transformer.Model(transformer_crf_config(depth=1))
    assert not decode.use_fused_head(full.seqdist)
