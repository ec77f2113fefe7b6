"""The port's ``download``, ``export`` and ``view`` on upstream-form
directories, on the CPU, against bonito_tpu's CLIs: the same tables
printed, the same ``.npz`` written from a ``file://`` zip holding a
``config.toml`` and a ``weights_1.tar``, the same files exported in the
three formats (the names, the arrays, the scripted ``.tensor`` archives
read back with ``torch.jit.load``, the cleaned ``config.toml``), and the
old-style model's parameter count. Every comparison is exact."""

import io
import zipfile
from contextlib import redirect_stderr, redirect_stdout

import numpy as np
import pytest
import torch

from bonito_tpu.cli import download as jdownload
from bonito_tpu.cli import export as jexport
from bonito_tpu.cli import view as jview
from bonito_tpu_torch import checkpoint
from bonito_tpu_torch.cli import download, export, main as cli_main, view
from bonito_tpu_torch.config import load_config, save_config
from bonito_tpu_torch.models import (conv_ctc_config, lstm_crf_config,
                                     rnn_crf_config)
from bonito_tpu_torch.util import load_symbol

NAME = "dna_r10.4.1_e8.2_400bps_hac@v4.3.0"


@pytest.fixture(autouse=True, scope="module")
def one_thread_per_pool():
    """The suite runs test files side by side in worker processes that use
    every core already. bonito_tpu's ``view`` initialises the old-style
    model, whose orthogonal LSTM weights are QRs through scipy's OpenBLAS:
    its idle threads spin, and with a pool of its own per worker the view
    test took 390 s instead of 7 s on a loaded host."""
    import scipy.linalg.cython_lapack  # noqa: F401 (the library JAX's QR uses)
    from threadpoolctl import threadpool_limits
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def randomize(model, seed):
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for k, v in model.state_dict().items():
            d = (1 + 0.3 * rng.random(v.shape) if k.endswith(".var")
                 else rng.normal(size=v.shape))
            v.copy_(torch.from_numpy(d.astype(np.float32)))
    return model


def clamped_config():
    """hac-like at narrow width with a Clamp after each convolution (the
    v4.0-v4.2 layout), for the export's renumbering."""
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=2, stride=5)
    subs = []
    for layer in cfg["encoder"]["sublayers"]:
        subs.append(layer)
        if layer["type"] == "convolution":
            subs.append({"type": "clamp", "min": -3.5, "max": 3.5})
    cfg["encoder"]["sublayers"] = subs
    return cfg


def narrow_ctc_config():
    cfg = conv_ctc_config(batchsize=4, chunksize=600, overlap=120)
    for b in cfg["block"]:
        b["filters"] = max(16, b["filters"] // 16)
        b["repeat"] = min(b["repeat"], 2)
    return cfg


CONFIGS = {"clamped": clamped_config,
           "old": lambda: rnn_crf_config(features=64, state_len=3),
           "ctc": narrow_ctc_config}


def model_dir(path, cfg, seed=1, tar=False):
    """A model directory of random weights: ``weights_1.npz``, or the
    upstream form (``weights_1.tar`` with a nonzero bias_hh_l0 on each
    LSTM, the keys under ``module.``) with ``tar``."""
    path.mkdir(parents=True)
    model = randomize(load_symbol(cfg, "Model")(cfg), seed)
    save_config(cfg, path / "config.toml")
    if not tar:
        checkpoint.save_params(path / "weights_1.npz", model)
        return path
    state = export.torch_state_dict(model)
    rng = np.random.default_rng(seed + 1)
    for k in state:
        if k.endswith("bias_hh_l0"):
            state[k] = torch.from_numpy(
                rng.normal(size=state[k].shape).astype(np.float32))
    torch.save({f"module.{k}": v for k, v in state.items()},
               path / "weights_1.tar")
    return path


def run(main, argparser, argv):
    """(stdout, stderr) of one CLI's ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        main(argparser().parse_args(argv))
    return out.getvalue(), err.getvalue()


# ---------------------------------------------------------------------------
# download
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("table", ["--models", "--training"])
def test_download_lists_bonito_tpus_tables(table, capsys):
    want = run(jdownload.main, jdownload.argparser, [table, "--list"])
    got = run(download.main, download.argparser, [table, "--list"])
    assert got == want
    assert got[0].count("\n") == len(
        download.models if table == "--models" else download.training)
    cli_main(["download", table, "--list"])
    assert capsys.readouterr().out == want[0]


@pytest.fixture
def archive(tmp_path):
    """A ``file://`` URL whose ``NAME.zip`` holds an upstream-form hac-like
    directory (``bonito.crf``, ``weights_1.tar`` only)."""
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=2, stride=5)
    src = model_dir(tmp_path / "src" / NAME, cfg, tar=True)
    site = tmp_path / "site"
    site.mkdir()
    with zipfile.ZipFile(site / f"{NAME}.zip", "w") as zf:
        for f in sorted(src.iterdir()):
            zf.write(f, f"{NAME}/{f.name}")
    return f"file://{site}/"


def test_download_writes_bonito_tpus_npz(archive, tmp_path, monkeypatch):
    monkeypatch.setattr(download, "__url__", archive)
    monkeypatch.setattr(jdownload, "__url__", archive)
    argv = ["--models", "--select", NAME, "--out_dir"]
    _, want_err = run(jdownload.main, jdownload.argparser,
                      argv + [str(tmp_path / "jax")])
    _, got_err = run(download.main, download.argparser,
                     argv + [str(tmp_path / "port")])
    assert got_err == want_err.replace(str(tmp_path / "jax"),
                                       str(tmp_path / "port"))
    assert "converted weights_1.tar -> weights_1.npz" in got_err
    got_dir, want_dir = tmp_path / "port" / NAME, tmp_path / "jax" / NAME
    assert sorted(p.name for p in got_dir.iterdir()) == sorted(
        p.name for p in want_dir.iterdir()) == [
        "config.toml", "weights_1.npz", "weights_1.tar"]
    assert not (tmp_path / "port" / f"{NAME}.zip").exists()
    with np.load(got_dir / "weights_1.npz") as got, \
            np.load(want_dir / "weights_1.npz") as want:
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        flat = {k: got[k] for k in got.files}
    # the .npz is the import of the .tar
    config = load_config(got_dir / "config.toml")
    model = load_symbol(config, "Model")
    imported = checkpoint.import_torch_checkpoint(
        got_dir / "weights_1.tar", model(config))
    via_npz = checkpoint.params_from_jax(model(config), flat)
    for k, v in via_npz.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), imported[k], err_msg=k)
    # a second run keeps what is there; --force fetches it again
    _, err = run(download.main, download.argparser,
                 argv + [str(tmp_path / "port")])
    assert f"skipping {NAME} (exists)" in err
    _, err = run(download.main, download.argparser,
                 argv + [str(tmp_path / "port"), "--force"])
    assert "converted weights_1.tar" in err


def test_a_failed_fetch_reports_and_returns_none(tmp_path, monkeypatch):
    url = f"file://{tmp_path}/nothing-here/"
    monkeypatch.setattr(download, "__url__", url)
    monkeypatch.setattr(jdownload, "__url__", url)
    err = io.StringIO()
    with redirect_stderr(err):
        want = jdownload.Downloader(tmp_path / "jax").download(NAME)
    want_err = err.getvalue()
    err = io.StringIO()
    with redirect_stderr(err):
        got = download.Downloader(tmp_path / "port").download(NAME)
    assert got is None and want is None
    assert err.getvalue() == want_err
    assert "> error: download failed" in err.getvalue()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------

def _read(path):
    if path.suffix == ".tensor":
        return dict(torch.jit.load(str(path)).named_parameters())["0"] \
            .detach().numpy()
    if path.suffix == ".npy":
        return np.load(path)
    return path.read_text()


@pytest.mark.parametrize("name,fmt", [
    ("clamped", "dorado"), ("clamped", "npy"), ("clamped", "torch"),
    ("old", "dorado"), ("old", "torch"), ("ctc", "torch")])
def test_export_writes_bonito_tpus_files(name, fmt, tmp_path):
    src = model_dir(tmp_path / "model", CONFIGS[name]())
    run(jexport.main, jexport.argparser,
        [str(src), "--output", str(tmp_path / "jax"), "--format", fmt])
    run(export.main, export.argparser,
        [str(src), "--output", str(tmp_path / "port"), "--format", fmt,
         "--device", "cpu"])
    got = sorted(p.name for p in (tmp_path / "port").iterdir())
    want = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert got == want and "config.toml" in got
    if fmt == "torch":
        assert got == ["config.toml", "weights_1.tar"]
        a = torch.load(tmp_path / "port" / "weights_1.tar", weights_only=True)
        b = torch.load(tmp_path / "jax" / "weights_1.tar", weights_only=True)
        assert list(a) == list(b)
        for k in b:
            assert torch.equal(a[k], b[k]), k
    else:
        for f in got:
            np.testing.assert_equal(_read(tmp_path / "port" / f),
                                    _read(tmp_path / "jax" / f), err_msg=f)
    assert ((tmp_path / "port" / "config.toml").read_text()
            == (tmp_path / "jax" / "config.toml").read_text())
    if name == "clamped" and fmt != "torch":
        # the Clamps after the convolutions are not counted: the LSTMs
        # (encoder layers 7 and 8 with them) are named 4 and 5
        assert {f"{i}.rnn.weight_ih_l0.{'npy' if fmt == 'npy' else 'tensor'}"
                for i in (4, 5)} <= set(got)
        assert not any(f.startswith(("7.", "8.")) for f in got)


def test_dorado_tensors_are_the_fused_state(tmp_path):
    """Each .tensor holds the BatchNorm-fused model's tensor in upstream's
    layout."""
    from bonito_tpu_torch import nn
    from bonito_tpu_torch.util import load_model
    src = model_dir(tmp_path / "model", CONFIGS["old"]())
    cli_main(["export", str(src), "--output", str(tmp_path / "out"),
              "--device", "cpu"])
    model = load_model(src, half=False, device="cpu")
    nn.fuse_bn(model.encoder)
    state = checkpoint.export_state_dict(model.encoder)
    files = sorted(p.stem for p in (tmp_path / "out").glob("*.tensor"))
    assert files == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(
            _read(tmp_path / "out" / f"{k}.tensor"), v, err_msg=k)


# ---------------------------------------------------------------------------
# view
# ---------------------------------------------------------------------------

def test_view_counts_the_old_style_model_as_bonito_tpu(tmp_path):
    save_config(rnn_crf_config(), tmp_path / "config.toml")
    want, _ = run(jview.main, jview.argparser, [str(tmp_path)])
    got, _ = run(view.main, view.argparser, [str(tmp_path)])
    total = [line for line in got.splitlines() if line.startswith("total")]
    assert total == [line for line in want.splitlines()
                     if line.startswith("total")]
    assert "LSTM(size=768, insize=768, bias=True, reverse=True)" in got
