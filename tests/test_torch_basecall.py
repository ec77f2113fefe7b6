"""End to end on the CPU: the port's load_model + basecall against
bonito_tpu's on one small LSTM-CRF model directory (features 96,
state_len 3, f32), the same reads, the int8 signal wire on in both."""

import jax
import numpy as np
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu.crf.basecall import basecall as jax_basecall
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.util import load_model as jax_load_model
from bonito_tpu_torch.crf.basecall import basecall
from bonito_tpu_torch.util import load_model

CHUNK, OVERLAP, BATCH = 1000, 200, 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeRead:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    cfg = lstm_crf_config(features=96, num_layers=3, state_len=3, stride=5,
                          batchsize=BATCH, chunksize=CHUNK, overlap=OVERLAP)
    cfg["basecaller"]["quantize"] = False
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(0))
    _, (crf, _), _ = m.decode_head()
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 5
    jconfig.save_config(cfg, d / "config.toml")
    jckpt.save_params(d / "weights_1.npz", m.params)
    return d


@pytest.fixture(scope="module")
def reads():
    rng = np.random.default_rng(0)
    # a short read (one padded chunk), and reads over several batches
    lengths = [700, 2400, 5100, 9300]
    return [FakeRead(f"r{i}", rng.normal(size=n).astype(np.float32))
            for i, n in enumerate(lengths)]


def _run(fn, model, reads, **kw):
    return {r.read_id: res for r, res in fn(
        model, iter(reads), chunksize=CHUNK, overlap=OVERLAP,
        batchsize=BATCH, **kw)}


def test_basecall_matches_bonito_tpu(model_dir, reads, monkeypatch):
    # both packages on the same route: the TCN head + TCN decode
    monkeypatch.setenv("BONITO_TPU_FUSED_HEAD", "0")
    ref = _run(jax_basecall,
               jax_load_model(model_dir, half=False, fuse_bn=True), reads)
    out = _run(basecall,
               load_model(model_dir, half=False, fuse_bn=True, device="cpu"),
               reads, head_route="tcn")
    assert out.keys() == ref.keys() == {r.read_id for r in reads}
    for rid in ref:
        got, want = out[rid], ref[rid]
        assert got["stride"] == want["stride"] == 5
        assert got["sequence"] == want["sequence"]
        np.testing.assert_array_equal(got["moves"], want["moves"])
        assert len(got["sequence"]) == got["moves"].sum() == len(got["qstring"])
        dq = (np.frombuffer(got["qstring"].encode(), np.uint8).astype(int)
              - np.frombuffer(want["qstring"].encode(), np.uint8))
        assert np.abs(dq).max(initial=0) <= 1
    assert sum(len(r["sequence"]) for r in out.values()) > 0


def test_prepare_pads_a_ragged_batch(model_dir):
    from bonito_tpu_torch.crf.basecall import make_compute_fn
    m = load_model(model_dir, half=False, device="cpu")
    compute = make_compute_fn(m, BATCH, CHUNK)
    batch = np.random.default_rng(1).normal(size=(3, CHUNK))
    n, x, scale = compute.prepare(batch)
    assert n == 3 and x.dtype == np.int8 and x.shape == (BATCH, CHUNK)
    assert not x[3:].any() and (scale[3:] == 1).all()
    np.testing.assert_allclose(np.abs(x[:3]).max(axis=1), 127)
    out = compute.fetch(compute.dispatch((n, x, scale)))
    assert out["sequence"].shape == (3, CHUNK // 5)


def test_unported_routes_raise(model_dir):
    """What still raises: a decoder that does not exist, and a head route
    forced onto the full-score decodes (the reverse strand and the beam
    read ``model(x)``, not a head route)."""
    from bonito_tpu_torch.crf.basecall import make_compute_fn
    m = load_model(model_dir, half=False, device="cpu")
    with pytest.raises(ValueError, match="decoder"):
        make_compute_fn(m, BATCH, CHUNK, decoder="greedy")
    for kw in (dict(reverse=True), dict(decoder="beam")):
        for route in ("fused", "tcn"):
            with pytest.raises(ValueError, match="head_route"):
                make_compute_fn(m, BATCH, CHUNK, head_route=route, **kw)
    with pytest.raises(ValueError, match="head_route"):
        make_compute_fn(m, BATCH, CHUNK, head_route="dense")
    for kw in (dict(reverse=True), dict(decoder="beam")):
        out = make_compute_fn(m, BATCH, CHUNK, **kw)(
            np.random.default_rng(2).normal(size=(2, CHUNK)))
        assert out["sequence"].shape == (2, CHUNK // 5)
