"""Upstream bonito's ``weights_N.tar`` checkpoints in the port, on the CPU,
against bonito_tpu: the import (``checkpoint.import_torch_checkpoint``)
and export (``export_state_dict``) for a narrow model of each family
(hac-like, fast-like, sup, conv-CTC and the old-style parametric
``[encoder]``), the edge cases of the key matching, an independent torch
model under upstream's key names, the layer types this slice adds
(ReLU, GELU, Reverse, Linear), the old-style model's forward and basecall,
and which file ``get_last_checkpoint`` and ``load_model(weights=N)`` pick.

Every tensor of the port's model is drawn from a seed (BatchNorm
statistics and affine terms too, so that a permutation of any of them
shows) and carried to bonito_tpu through a ``.npz``. The ``.tar`` files
are bonito_tpu's own export (``bonito_tpu.cli.export._torch_state_dict``)
with a nonzero ``bias_hh_l0`` given to each LSTM, as upstream's trainer
writes them.

Tolerances: the import and export are exact (rtol 0); the layers' forward
1e-6 of bonito_tpu's (LAYER_TOL); the old-style forward 2e-4 and the
independent torch model's scores 2e-4 (the CRF encoders' tolerance,
ROADMAP); the old-style basecall records identical, qstrings within one
phred step, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import nn as jnn
from bonito_tpu.cli import export as jexport
from bonito_tpu.crf.basecall import basecall as jax_basecall
from bonito_tpu.util import get_last_checkpoint as jax_last_checkpoint
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu.util import load_symbol as jax_load_symbol
from bonito_tpu_torch import checkpoint, nn
from bonito_tpu_torch.cli import export
from bonito_tpu_torch.config import save_config
from bonito_tpu_torch.crf.basecall import basecall
from bonito_tpu_torch.models import (conv_ctc_config, lstm_crf_config,
                                     rnn_crf_config, transformer_crf_config)
from bonito_tpu_torch.util import get_last_checkpoint, load_model, load_symbol

LAYER_TOL = 1e-6
SCORE_TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _narrow_ctc():
    cfg = conv_ctc_config(batchsize=4, chunksize=600, overlap=120)
    for b in cfg["block"]:
        b["filters"] = max(16, b["filters"] // 16)
        b["repeat"] = min(b["repeat"], 2)
    return cfg


FAMILIES = {
    "hac": lambda: lstm_crf_config(features=64, num_layers=2, state_len=2,
                                   stride=5),
    "fast": lambda: lstm_crf_config(features=32, num_layers=3, state_len=3,
                                    stride=5),
    "sup": lambda: transformer_crf_config(
        d_model=64, nhead=4, depth=3, dim_feedforward=128, state_len=3,
        batchsize=8, chunksize=2400, overlap=240),
    "ctc": _narrow_ctc,
    "old": lambda: rnn_crf_config(features=64, state_len=3),
}


def randomize(model, seed):
    """Every tensor of ``model`` from ``seed`` (variances in [1, 1.3))."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            d = (1 + 0.3 * rng.random(v.shape) if k.endswith(".var")
                 else rng.normal(size=v.shape))
            v.copy_(torch.from_numpy(d.astype(np.float32)))
    return model


def port_model(cfg):
    return load_symbol(cfg, "Model")(cfg)


def pair(family, tmp_path, seed=1, init=False):
    """(config, the port's model, bonito_tpu's model) with one set of
    weights: ``randomize``'s, or with ``init`` the model's own scheme (a
    forward through LSTMs of normal draws is chaotic: the packages' last
    bits grow to the whole range within a layer)."""
    cfg = FAMILIES[family]()
    pm = (port_model(cfg).init(seed) if init
          else randomize(port_model(cfg), seed))
    checkpoint.save_params(tmp_path / "pair.npz", pm)
    jm = jax_load_symbol(cfg, "Model")(cfg)
    jm.params = jckpt.load_params(str(tmp_path / "pair.npz"))
    return cfg, pm, jm


def upstream_state(jm, seed=7):
    """bonito_tpu's export of ``jm`` with a nonzero bias_hh_l0 for each
    LSTM, as upstream's trainer leaves it."""
    state = jexport._torch_state_dict(jm)
    rng = np.random.default_rng(seed)
    for k in state:
        if k.endswith("bias_hh_l0"):
            state[k] = torch.from_numpy(
                rng.normal(size=state[k].shape).astype(np.float32))
    return state


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_flat_equal(got, want):
    assert list(got) and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def port_state(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------------
# import and export against bonito_tpu, every family: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", list(FAMILIES))
def test_import_equals_bonito_tpus(family, tmp_path):
    cfg, pm, jm = pair(family, tmp_path)
    state = upstream_state(jm)
    tar = tmp_path / "weights_1.tar"
    torch.save(state, tar)
    got = checkpoint.import_torch_checkpoint(tar, port_model(cfg))
    want = checkpoint.params_from_jax(
        port_model(cfg), numpy_tree(jckpt.import_torch_checkpoint(
            str(tar), jm)))
    assert_flat_equal(got, port_state(want))
    # the conv weights kept upstream's [O, I, W]; each LSTM's b is the sum
    # of its two biases, no longer the bias_ih it was exported as
    for k in checkpoint._conv_weight_keys(pm):
        np.testing.assert_array_equal(got[k], pm.state_dict()[k].numpy())
    for name, m in pm.named_modules():
        if isinstance(m, nn.LSTM):
            assert not np.array_equal(got[f"{name}.b"], m.b.detach().numpy())
    loaded = checkpoint.load_weights(tar, port_model(cfg))
    assert_flat_equal(port_state(loaded), got)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_export_equals_bonito_tpus(family, tmp_path):
    cfg, pm, jm = pair(family, tmp_path)
    for root in ("encoder", "decoder"):
        if getattr(pm, root, None) is None:
            continue
        got = checkpoint.export_state_dict(getattr(pm, root), prefix=root)
        want = jckpt.export_state_dict(getattr(jm, root), jm.params[root],
                                       prefix=root)
        assert list(got) == list(want)
        assert_flat_equal(got, {k: np.asarray(v) for k, v in want.items()})
    assert_flat_equal({k: v.numpy() for k, v in
                       export.torch_state_dict(pm).items()},
                      {k: v.numpy() for k, v in
                       jexport._torch_state_dict(jm).items()})


@pytest.mark.parametrize("family", list(FAMILIES))
def test_tar_round_trips_both_ways(family, tmp_path):
    """The port's .tar imports in bonito_tpu as its own weights, and in the
    port as the model it came from (zeroed bias_hh twins)."""
    cfg, pm, jm = pair(family, tmp_path)
    tar = tmp_path / "weights_2.tar"
    torch.save(export.torch_state_dict(pm), tar)
    back = jckpt.import_torch_checkpoint(str(tar), jm)
    assert_flat_equal(checkpoint._flatten(numpy_tree(back)),
                      checkpoint._flatten(numpy_tree(jm.params)))
    assert_flat_equal(checkpoint.import_torch_checkpoint(tar, port_model(cfg)),
                      port_state(pm))


def test_export_copies_the_tensors(tmp_path):
    """The exported arrays are the model's values, not views of its
    parameters: changing the model afterwards leaves them as they were."""
    _, pm, _ = pair("hac", tmp_path)
    state = checkpoint.export_state_dict(pm.encoder, prefix="encoder")
    kept = {k: v.copy() for k, v in state.items()}
    with torch.no_grad():
        for p in pm.parameters():
            p.add_(1.0)
    assert_flat_equal(state, kept)
    assert all(v.flags["C_CONTIGUOUS"] for v in state.values())


# ---------------------------------------------------------------------------
# the key matching's edge cases, as bonito_tpu behaves
# ---------------------------------------------------------------------------

def _both(state, cfg, jm, tmp_path, name="weights_3.tar"):
    tar = tmp_path / name
    torch.save(state, tar)
    got = checkpoint.import_torch_checkpoint(tar, port_model(cfg))
    want = checkpoint._flatten(numpy_tree(jckpt.import_torch_checkpoint(
        str(tar), jm)))
    return got, want


def test_module_prefixes_and_num_batches_tracked_go(tmp_path):
    cfg, pm, jm = pair("hac", tmp_path)
    state = upstream_state(jm)
    clean, _ = _both(state, cfg, jm, tmp_path, "clean.tar")
    dirty = {f"module.{k}": v for k, v in state.items()}
    for i in range(3):
        dirty[f"module.encoder.{i}.norm.bn.num_batches_tracked"] = (
            torch.tensor(12, dtype=torch.long))
    got, want = _both(dirty, cfg, jm, tmp_path)
    assert_flat_equal(got, clean)
    np.testing.assert_array_equal(got["encoder.0.w"],
                                  want["encoder.0.w"].transpose(2, 1, 0))
    assert not any("num_batches" in k for k in got)


def test_renamed_keys_pair_as_bonito_tpus(tmp_path):
    cfg, pm, jm = pair("old", tmp_path)
    state = upstream_state(jm)
    clean, _ = _both(state, cfg, jm, tmp_path, "clean.tar")
    renamed = {k.replace("encoder.", "model.layers."): v
               for k, v in state.items()}
    got, want = _both(renamed, cfg, jm, tmp_path)
    assert_flat_equal(got, clean)
    # bonito_tpu's pairs the same tensors (its conv weights are [W, I, O])
    conv = checkpoint._conv_weight_keys(pm)
    assert_flat_equal(got, {k: v.transpose(2, 1, 0) if k in conv else v
                            for k, v in want.items()})


def test_a_count_mismatch_raises_key_error_in_both(tmp_path):
    cfg, _, jm = pair("hac", tmp_path)
    state = upstream_state(jm)
    del state["encoder.4.rnn.weight_hh_l0"]
    tar = tmp_path / "weights_1.tar"
    torch.save(state, tar)
    with pytest.raises(KeyError) as want:
        jckpt.import_torch_checkpoint(str(tar), jm)
    with pytest.raises(KeyError) as got:
        checkpoint.import_torch_checkpoint(tar, port_model(cfg))
    assert str(got.value) == str(want.value)
    assert "rnn.weight_hh_l0: need 2, found 1" in str(got.value)


def test_a_shape_mismatch_raises_value_error_in_both(tmp_path):
    cfg, _, jm = pair("hac", tmp_path)
    state = upstream_state(jm)
    w = state["encoder.6.linear.weight"]
    state["encoder.6.linear.weight"] = torch.zeros(w.shape[0] + 4, w.shape[1])
    tar = tmp_path / "weights_1.tar"
    torch.save(state, tar)
    with pytest.raises(ValueError) as want:
        jckpt.import_torch_checkpoint(str(tar), jm)
    with pytest.raises(ValueError) as got:
        checkpoint.import_torch_checkpoint(tar, port_model(cfg))
    assert str(got.value) == str(want.value)
    assert "shape mismatch at .encoder.6.w" in str(got.value)


def test_a_key_the_model_lacks_warns_in_both(tmp_path, monkeypatch, capsys):
    """An entry whose port key the model has no tensor for is reported on
    stderr, with bonito_tpu's words, and the import goes on."""
    cfg, _, jm = pair("hac", tmp_path)
    tar = tmp_path / "weights_1.tar"
    torch.save(upstream_state(jm), tar)
    for mod, crf in ((checkpoint, checkpoint.nn.LinearCRFEncoder),
                     (jckpt, jnn.LinearCRFEncoder)):
        real = mod._expected_torch_params

        def more(layer, path, real=real, crf=crf):
            out = real(layer, path)
            if isinstance(layer, crf):
                out.append((f"{path}.linear.weight", f"{path}.extra",
                            out[0][2]))
            return out
        monkeypatch.setattr(mod, "_expected_torch_params", more)
    capsys.readouterr()
    jckpt.import_torch_checkpoint(str(tar), jm)
    want = capsys.readouterr().err
    got_params = checkpoint.import_torch_checkpoint(tar, port_model(cfg))
    got = capsys.readouterr().err
    assert got == want
    assert "imported parameter .encoder.6.extra has no counterpart" in got
    assert "encoder.6.extra" in got_params


# ---------------------------------------------------------------------------
# an independent torch model under upstream's key names: 2e-4
# ---------------------------------------------------------------------------

class _RefBatchNorm(torch.nn.Module):
    """Upstream's BatchNorm wraps a torch module named ``bn``."""

    def __init__(self, n):
        super().__init__()
        self.bn = torch.nn.BatchNorm1d(n)

    def forward(self, x):
        return self.bn(x)


class TorchHacLike(torch.nn.Module):
    """Upstream's hac architecture in plain torch.nn at narrow width:
    conv + BatchNorm + swish twice, conv + BatchNorm + tanh at stride 5,
    LSTMs forward then reversed (both biases nonzero), the tanh CRF head
    scaled by 5."""

    def __init__(self, features=64, state_len=2):
        super().__init__()

        def conv_block(cin, cout, k, stride, act):
            m = torch.nn.Module()
            m.conv = torch.nn.Conv1d(cin, cout, k, stride=stride,
                                     padding=k // 2)
            m.norm = _RefBatchNorm(cout)
            m.act = act
            return m

        self.blocks = torch.nn.ModuleList([
            conv_block(1, 16, 5, 1, torch.nn.functional.silu),
            conv_block(16, 16, 5, 1, torch.nn.functional.silu),
            conv_block(16, features, 19, 5, torch.tanh)])
        self.rnn1 = torch.nn.LSTM(features, features)
        self.rnn2 = torch.nn.LSTM(features, features)
        self.linear = torch.nn.Linear(features, 4 ** (state_len + 1),
                                      bias=False)

    def forward(self, x):
        h = x.permute(0, 2, 1)
        for b in self.blocks:
            h = b.act(b.norm(b.conv(h)))
        h = h.permute(2, 0, 1)
        h, _ = self.rnn1(h)
        h, _ = self.rnn2(h.flip(0))
        h = h.flip(0)
        scores = torch.tanh(self.linear(h)) * 5.0
        N = scores.shape[1]
        moves = scores.permute(1, 0, 2).reshape(N, -1, scores.shape[2] // 4, 4)
        blanks = torch.full(moves.shape[:-1] + (1,), 2.0)
        return torch.cat([blanks, moves], -1).reshape(N, moves.shape[1], -1)

    def upstream_state(self):
        """The state dict under upstream's serialised-encoder names."""
        sd = self.state_dict()
        out = {}
        for i in range(3):
            for k, v in sd.items():
                if k.startswith(f"blocks.{i}."):
                    out[k.replace(f"blocks.{i}.", f"encoder.{i}.")] = v
        for name, idx in (("rnn1", 4), ("rnn2", 5)):
            for s in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                      "bias_hh_l0"):
                out[f"encoder.{idx}.rnn.{s}"] = sd[f"{name}.{s}"]
        out["encoder.6.linear.weight"] = sd["linear.weight"]
        return out


def test_scores_match_an_independent_torch_model(tmp_path):
    torch.manual_seed(0)
    ref = TorchHacLike().eval()
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                m.running_mean.normal_(0, 0.1)
                m.running_var.uniform_(1.0, 1.3)
                m.weight.normal_(1.0, 0.1)
                m.bias.normal_(0, 0.1)
        assert ref.rnn1.bias_hh_l0.abs().min() > 0
    torch.save(ref.upstream_state(), tmp_path / "weights_1.tar")
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=2, stride=5,
                          scale=5.0, clamp=None)
    cfg["basecaller"]["quantize"] = False
    save_config(cfg, tmp_path / "config.toml")
    model = load_model(tmp_path, half=False, device="cpu")
    x = np.random.default_rng(0).normal(size=(2, 400, 1)).astype(np.float32)
    with torch.no_grad():
        want = ref(torch.from_numpy(x)).numpy()
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 80, 80)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


# ---------------------------------------------------------------------------
# the layer types: round trips, and the forward within 1e-6
# ---------------------------------------------------------------------------

def _fill(module, params):
    flat = checkpoint._flatten(numpy_tree(params))
    assert set(flat) == set(module.state_dict())
    return checkpoint.params_from_jax(module, flat)


LAYERS = {
    "relu": {"type": "relu"},
    "gelu": {"type": "gelu"},
    "linear": {"type": "linear", "in_features": 32, "out_features": 48},
    "linear-no-bias": {"type": "linear", "in_features": 32,
                       "out_features": 16, "bias": False},
    "reverse-lstm": {"type": "reverse", "sublayers": {
        "type": "lstm", "size": 32, "insize": 32, "bias": True,
        "reverse": False}},
    "reverse-serial": {"type": "reverse", "sublayers": [
        {"type": "linear", "in_features": 32, "out_features": 32},
        {"type": "tanh"},
        {"type": "lstm", "size": 32, "insize": 32, "bias": True,
         "reverse": True}]},
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_layer_matches_bonito_tpus(name):
    spec = LAYERS[name]
    jl, pl = jnn.from_dict(spec), nn.from_dict(spec)
    assert nn.to_dict(pl) == jnn.to_dict(jl)
    assert nn.to_dict(nn.from_dict(nn.to_dict(pl))) == nn.to_dict(pl)
    params = jl.init_params(jax.random.PRNGKey(3))
    if "bias" not in name:
        # a nonzero bias, so that it counts
        params = jax.tree_util.tree_map_with_path(
            lambda p, v: v + 0.1 if p[-1].key == "b" else v, params)
    pl = _fill(pl, params)
    x = np.random.default_rng(4).normal(size=(2, 40, 32)).astype(np.float32)
    want = np.asarray(jl.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = pl(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_TOL)


def test_gelu_is_the_tanh_form():
    """bonito_tpu's GELU (jax.nn.gelu's default) is the tanh approximation;
    upstream's exact erf form differs from it."""
    x = torch.linspace(-4, 4, 801)
    got = nn.GELU()(x)
    tanh_form = 0.5 * x * (1 + torch.tanh(
        np.sqrt(2 / np.pi) * (x + 0.044715 * x ** 3)))
    torch.testing.assert_close(got, tanh_form, rtol=0, atol=1e-6)
    erf_form = torch.nn.functional.gelu(x)
    assert (got - erf_form).abs().max() > 1e-4
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()))),
        rtol=0, atol=LAYER_TOL)


def test_relu_and_gelu_as_a_convolution_activation():
    for act in ("relu", "gelu"):
        spec = {"type": "convolution", "insize": 1, "size": 8, "winlen": 5,
                "padding": 2, "activation": act}
        assert nn.to_dict(nn.from_dict(spec))["activation"] == act


def test_unknown_layer_type_raises():
    with pytest.raises(NotImplementedError, match="unknown layer type"):
        nn.from_dict({"type": "no-such-layer"})


# ---------------------------------------------------------------------------
# the old-style parametric encoder
# ---------------------------------------------------------------------------

def test_old_style_forward_matches_bonito_tpus(tmp_path):
    cfg, pm, jm = pair("old", tmp_path, seed=2, init=True)
    kinds = [type(m).__name__ for m in pm.encoder.children()]
    assert kinds == ["Convolution"] * 3 + ["Permute"] + ["LSTM"] * 5 + [
        "LinearCRFEncoder"]
    assert [m.reverse for m in pm.encoder.children()
            if isinstance(m, nn.LSTM)] == [True, False, True, False, True]
    assert pm.stride == 5 and getattr(pm.encoder, "9").blank_score == 2.0
    x = np.random.default_rng(2).normal(size=(2, 1000, 1)).astype(np.float32)
    want = np.asarray(jm.forward(jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 200, 320)
    np.testing.assert_allclose(got, want, rtol=0, atol=SCORE_TOL)


class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


def test_old_style_basecall_matches_bonito_tpus(tmp_path, monkeypatch):
    """load_model + basecall of an old-style .tar directory in f32, both
    packages on the TCN route."""
    cfg = rnn_crf_config(features=64, state_len=3, batchsize=4,
                         chunksize=1000, overlap=200, quantize=False)
    pm = port_model(cfg).init(5)
    with torch.no_grad():
        getattr(pm.encoder, "9").w.mul_(5)
    save_config(cfg, tmp_path / "config.toml")
    torch.save(export.torch_state_dict(pm), tmp_path / "weights_1.tar")
    monkeypatch.setenv("BONITO_TPU_FUSED_HEAD", "0")
    rng = np.random.default_rng(0)
    reads = [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
             for i, n in enumerate([700, 2400, 5100])]
    kw = dict(chunksize=1000, overlap=200, batchsize=4)
    want = {r.read_id: res for r, res in jax_basecall(
        jax_load_model(tmp_path, half=False, fuse_bn=True), iter(reads), **kw)}
    got = {r.read_id: res for r, res in basecall(
        load_model(tmp_path, half=False, fuse_bn=True, device="cpu"),
        iter(reads), head_route="tcn", **kw)}
    assert got.keys() == want.keys() == {r.read_id for r in reads}
    for rid in want:
        assert got[rid]["sequence"] == want[rid]["sequence"]
        np.testing.assert_array_equal(got[rid]["moves"], want[rid]["moves"])
        dq = (np.frombuffer(got[rid]["qstring"].encode(), np.uint8)
              .astype(int) - np.frombuffer(want[rid]["qstring"].encode(),
                                           np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert sum(len(r["sequence"]) for r in got.values()) > 0


# ---------------------------------------------------------------------------
# which file loads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("files,latest", [
    (("1.npz", "2.tar"), "2.tar"),
    (("2.npz", "1.tar"), "2.npz"),
    (("1.npz", "1.tar"), "1.tar"),      # a tie: the .tar
    (("3.npz", "3.tar", "10.npz"), "10.npz"),
    (("3.tar",), "3.tar"),
])
def test_the_checkpoint_picked_is_bonito_tpus(files, latest, tmp_path):
    """Each file holds other weights, so the one that loads shows."""
    cfg = FAMILIES["hac"]()
    cfg["basecaller"]["quantize"] = False
    save_config(cfg, tmp_path / "config.toml")
    models = {}
    for i, name in enumerate(files):
        m = randomize(port_model(cfg), 10 + i)
        models[name] = m
        if name.endswith(".npz"):
            checkpoint.save_params(tmp_path / f"weights_{name}", m)
        else:
            torch.save(export.torch_state_dict(m),
                       tmp_path / f"weights_{name}")
    assert get_last_checkpoint(tmp_path) == jax_last_checkpoint(tmp_path)
    assert get_last_checkpoint(tmp_path).endswith(f"weights_{latest}")

    def loaded(**kw):
        return port_state(load_model(tmp_path, half=False, device="cpu",
                                     **kw))
    assert_flat_equal(loaded(), port_state(models[latest]))
    for n in {name.split(".")[0] for name in files}:
        # weights=N: the .npz first, then the .tar, as bonito_tpu's
        pick = f"{n}.npz" if f"{n}.npz" in files else f"{n}.tar"
        assert_flat_equal(loaded(weights=int(n)), port_state(models[pick]))
    with pytest.raises(FileNotFoundError, match="weights_7"):
        load_model(tmp_path, weights=7, device="cpu")
