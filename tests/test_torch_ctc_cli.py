"""The conv-CTC family end to end on the CPU against bonito_tpu: the port's
``ctc.basecall`` against bonito_tpu's on the same Reads, ``python -m
bonito_tpu_torch basecaller`` on a conv-CTC directory (written by
bonito_tpu) to fastq, SAM and BAM against bonito_tpu's CLI, the readers on
this config (no ``scaling``: quantile scaling) for pod5 and fast5,
``evaluate`` on a conv-CTC and a small LSTM-CRF directory against
bonito_tpu's ``--output-dir`` files, ``view`` against bonito_tpu's count
for every ``MODELS`` entry, and one ``train`` epoch.

Both packages in f32 (bonito_tpu's CLI through its module's ``load_model``
with ``half=False``, as tests/test_torch_basecaller_cli.py). The model is
tests/test_torch_ctc.py's narrow one (``model_pair``: bonito_tpu's tree,
BatchNorm statistics of a random batch). Calls are compared record for
record: sequences, moves, ``mv`` and every tag identical; qstrings within
one phred step (ROADMAP's rule; seen identical)."""

import uuid

import jax
import numpy as np
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu import fast5 as jf5
from bonito_tpu import pod5 as jpod5
from bonito_tpu.cli import basecaller as jax_cli
from bonito_tpu.cli import evaluate as jax_evaluate
from bonito_tpu.cli import view as jax_view
from bonito_tpu.crf.model import Model as JaxCRFModel
from bonito_tpu.ctc import basecall as jax_ctc_basecall
from bonito_tpu.models import MODELS as JAX_MODELS
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.util import load_symbol as jax_load_symbol
from bonito_tpu_torch import nn, pod5 as tpod5
from bonito_tpu_torch.cli import basecaller as port_cli
from bonito_tpu_torch.cli import evaluate as port_evaluate
from bonito_tpu_torch.cli import main as cli_main
from bonito_tpu_torch.ctc import basecall as port_ctc_basecall
from bonito_tpu_torch.models import MODELS
from bonito_tpu_torch.util import load_model

from test_torch_basecaller_cli import COMPARE, qual_close, run_cli
from test_torch_ctc import model_pair, narrow_config
from test_torch_reader import same_reads, write_fast5

BATCH, CHUNK, OVERLAP = 4, 600, 120
LENGTHS = [2500, 400, 1700, 3300, 900]  # the second shorter than a chunk


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def f32():
    """Both CLIs load their model in f32."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_cli, port_cli):
            load = mod.load_model
            mp.setattr(mod, "load_model",
                       lambda *a, _load=load, **k: _load(*a, **{**k,
                                                               "half": False}))
        yield


def pod5_records(seed):
    rng = np.random.default_rng(seed)
    records = []
    for i, n in enumerate(LENGTHS):
        adc = np.rint(rng.normal(size=n) * 60 + 500)
        records.append({
            "read_id": str(uuid.UUID(int=2000 + i)),
            "signal": adc.astype(np.int16), "calibration_scale": 0.2,
            "calibration_offset": -10.0, "channel": 3 + i, "well": 1 + i % 4,
            "read_number": 50 + i, "start": 4000 * i})
    return records


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctc_cli")
    cfg = narrow_config()
    cfg["basecaller"] = {"batchsize": BATCH, "chunksize": CHUNK,
                         "overlap": OVERLAP}
    jm, pm = model_pair(cfg, seed=11)
    model = root / "model"
    model.mkdir()
    jconfig.save_config(cfg, model / "config.toml")
    jckpt.save_params(model / "weights_1.npz", jm.params)
    reads = root / "reads"
    reads.mkdir()
    records = pod5_records(5)
    jpod5.write_pod5(reads / "a.pod5", records[:3])
    jpod5.write_pod5(reads / "b.pod5", records[3:], compress=False)
    return {"root": root, "model": model, "reads": reads, "jm": jm,
            "cfg": cfg}


class Read:
    def __init__(self, read_id, signal):
        self.read_id, self.signal = read_id, signal


def reads_of(seed):
    rng = np.random.default_rng(seed)
    return [Read(f"r{i}", rng.normal(size=n).astype(np.float32))
            for i, n in enumerate(LENGTHS)]


def hold_results(out, ref):
    assert [r.read_id for r, _ in out] == [r.read_id for r, _ in ref]
    n_bases = 0
    for (_, a), (_, b) in zip(out, ref):
        assert a.keys() == b.keys()
        assert a["sequence"] == b["sequence"] and a["stride"] == b["stride"]
        if b["qstring"] == "*":
            assert a["qstring"] == "*"
        else:
            qual_close(a["qstring"], b["qstring"])
        assert (a["moves"] is None) == (b["moves"] is None)
        if b["moves"] is not None:
            np.testing.assert_array_equal(a["moves"], b["moves"])
        np.testing.assert_allclose(a["mean_qscore"], b["mean_qscore"],
                                   rtol=1e-6)
        n_bases += len(a["sequence"])
    return n_bases


CALLS = {
    "beam": {},
    "greedy": {"beamsize": 1},
    "qscores": {"qscores": True},
    "rna": {"rna": True},
    "rna-qscores": {"rna": True, "qscores": True, "beamsize": 3},
}


@pytest.mark.parametrize("case", list(CALLS))
def test_basecall_equals_bonito_tpu_s(case, dirs):
    kw = dict(chunksize=CHUNK, overlap=OVERLAP, batchsize=BATCH,
              **CALLS[case])
    ref = list(jax_ctc_basecall.basecall(dirs["jm"], reads_of(1), **kw))
    model = load_model(dirs["model"], half=False, device="cpu")
    out = list(port_ctc_basecall.basecall(model, reads_of(1), **kw))
    assert hold_results(out, ref) > 100
    short = dict(out)[next(r for r, _ in out if r.read_id == "r1")]
    assert len(short["sequence"]) <= LENGTHS[1] // 3   # its own frames only
    if not (kw.get("qscores") or kw.get("beamsize") == 1):
        assert all(r["moves"] is None and r["qstring"] == "*"
                   for _, r in out)


def test_decode_processes_and_a_failing_beam(dirs, monkeypatch):
    """``BONITO_TPU_DECODE_PROCS``: the decode in one spawned process gives
    the threads' calls. A fault in the beam raises (bonito_tpu's basecall
    keeps the greedy call)."""
    model = load_model(dirs["model"], half=False, device="cpu")
    kw = dict(chunksize=CHUNK, overlap=OVERLAP, batchsize=BATCH)
    ref = list(port_ctc_basecall.basecall(model, reads_of(2), **kw))
    monkeypatch.setenv("BONITO_TPU_DECODE_PROCS", "1")
    hold_results(list(port_ctc_basecall.basecall(model, reads_of(2), **kw)),
                 ref)
    monkeypatch.delenv("BONITO_TPU_DECODE_PROCS")

    def broken(*a, **k):
        raise RuntimeError("beam fault")
    monkeypatch.setattr("bonito_tpu_torch.ctc.model.beam_search_ctc", broken)
    with pytest.raises(RuntimeError, match="beam fault"):
        list(port_ctc_basecall.basecall(model, reads_of(2), **kw))


def test_load_model_keeps_the_blocks_batchnorm_and_skips_quantize(dirs):
    model = load_model(dirs["model"], chunksize=4000, overlap=500,
                       quantize=True, fuse_bn=True, device="cpu")
    bc = model.config["basecaller"]
    assert (bc["chunksize"], bc["overlap"]) == (3999, 498)
    assert model.compute_dtype == torch.bfloat16
    state = model.state_dict()
    assert state["encoder.1.bn0.mean"].dtype == torch.float32
    assert state["encoder.1.conv0.w_depth"].dtype == torch.bfloat16
    ref = jckpt.load_params(dirs["model"] / "weights_1.npz")
    np.testing.assert_array_equal(state["encoder.2.bn1.var"].numpy(),
                                  ref["encoder"]["2"]["bn1"]["var"])


# ---------------------------------------------------------------------------
# the basecaller CLI and the readers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ext", ["fastq", "sam", "bam"])
def test_basecaller_cli_equals_bonito_tpu_s(ext, dirs, f32, tmp_path):
    argv = [str(dirs["model"]), str(dirs["reads"]), "--n-proc", "1"]
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    ref = tmp_path / "jax" / f"out.{ext}"
    out = tmp_path / "port" / f"out.{ext}"
    run_cli(jax_cli, argv, ref)
    err = run_cli(port_cli, argv + ["--device", "cpu"], out)
    assert COMPARE[ext](ref.read_bytes(), out.read_bytes()) == len(LENGTHS)
    assert "completed reads: 5" in err and "samples per second" in err
    assert ((out.parent / "out_summary.tsv").read_text()
            == (ref.parent / "out_summary.tsv").read_text())
    text = out.read_bytes()
    if ext == "fastq":  # the greedy decode, with its qualities
        quals = text.decode().splitlines()[3::4]
        assert all(q and q != "*" for q in quals)
    elif ext == "sam":  # the beam: qstring '*', no moves
        rows = [r.split("\t") for r in text.decode().splitlines()
                if not r.startswith("@")]
        assert all(r[10] == "*" and not any(t.startswith("mv:") for t in r)
                   for r in rows)


def test_beam_and_revcomp_flags_warn(dirs, f32, tmp_path):
    out = tmp_path / "out.sam"
    err = run_cli(port_cli, [str(dirs["model"]), str(dirs["reads"]),
                             "--n-proc", "1", "--device", "cpu", "--beam",
                             "--revcomp"], out)
    assert "--beam has no effect" in err and "--revcomp has no effect" in err


def reader_args(cfg):
    """The CLI's reader arguments for a config."""
    scaling = cfg.get("scaling")
    norm = (cfg.get("standardisation")
            if (scaling or {}).get("strategy") == "pa"
            else cfg.get("normalisation"))
    return {"scaling_strategy": scaling, "norm_params": norm}


def test_readers_on_this_config_are_bonito_tpu_s(dirs, tmp_path):
    kw = reader_args(dirs["cfg"])
    assert kw == {"scaling_strategy": None, "norm_params": None}
    same_reads(list(jpod5.get_reads(dirs["reads"], n_proc=0, **kw)),
               list(tpod5.get_reads(dirs["reads"], n_proc=0, **kw)))
    from bonito_tpu_torch import fast5 as tf5
    rng = np.random.default_rng(3)
    write_fast5(tmp_path / "a.fast5", [
        (str(uuid.UUID(int=3000 + i)),
         np.rint(rng.normal(size=n) * 60 + 500).astype(np.int16))
        for i, n in enumerate(LENGTHS)])
    ref = list(jf5.get_reads(tmp_path, n_proc=0, **kw))
    assert len(ref) == len(LENGTHS)
    same_reads(ref, list(tf5.get_reads(tmp_path, n_proc=0, **kw)))


# ---------------------------------------------------------------------------
# evaluate
# ---------------------------------------------------------------------------

def npy_dir(path, rows, chunk, L=60, seed=4):
    rng = np.random.default_rng(seed)
    path.mkdir()
    lengths = rng.integers(L // 2, L + 1, rows)
    refs = rng.integers(1, 5, (rows, L))
    refs[np.arange(L)[None] >= lengths[:, None]] = 0
    np.save(path / "chunks.npy",
            rng.normal(size=(rows, chunk)).astype(np.float16))
    np.save(path / "references.npy", refs.astype(np.uint8))
    np.save(path / "reference_lengths.npy", lengths.astype(np.uint16))
    return path


@pytest.fixture(scope="module")
def lstm_dir(tmp_path_factory):
    """tests/test_torch_basecaller_cli.py's LSTM-CRF directory (H 96, two
    layers, seed 14, the CRF weight x 10, quantize false)."""
    model = tmp_path_factory.mktemp("lstm") / "model"
    model.mkdir()
    cfg = lstm_crf_config(features=96, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=1000, overlap=200)
    cfg["basecaller"]["quantize"] = False
    m = JaxCRFModel(cfg)
    m.init(jax.random.PRNGKey(14))
    crf = str(next(i for i, layer in enumerate(cfg["encoder"]["sublayers"])
                   if layer["type"] == "linearcrfencoder"))
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 10
    jconfig.save_config(cfg, model / "config.toml")
    jckpt.save_params(model / "weights_1.npz", m.params)
    return model


def run_evaluate(cli, model, data, out, extra):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(cli.argparser().parse_args(
            [str(model), "--directory", str(data), "--output-dir", str(out),
             "--chunks", "10", "--batchsize", "4", *extra]))
    return buf.getvalue()


def report(text):
    """The report's lines but its time and rate."""
    return [line for line in text.splitlines() if line.startswith("* ")
            and not line.startswith(("* time", "* samples/s"))]


@pytest.mark.parametrize("family, extra", [
    ("ctc", []), ("ctc", ["--standardise", "--dataset", "train",
                          "--beamsize", "1"]),
    ("lstm", [])], ids=["ctc", "ctc-train-greedy", "lstm-crf"])
def test_evaluate_equals_bonito_tpu_s(family, extra, dirs, lstm_dir,
                                      tmp_path):
    model = dirs["model"] if family == "ctc" else lstm_dir
    data = npy_dir(tmp_path / "data", 40, 900 if family == "ctc" else 1000)
    ref = run_evaluate(jax_evaluate, model, data, tmp_path / "jax", extra)
    out = run_evaluate(port_evaluate, model, data, tmp_path / "port",
                       extra + ["--device", "cpu"])
    assert report(out) == report(ref)
    assert "* num_chunks      10" in out
    for name in ("seqs.fasta", "refs.fasta", "summ.txt"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    seqs = (tmp_path / "port" / "seqs.fasta").read_text().splitlines()[1::2]
    assert sum(map(len, seqs)) > 100


class ReachedData(Exception):
    """What the patched ``load_data`` raises: evaluate got past the model."""


def test_evaluate_reaches_load_data_for_an_f32_lstm_crf_on_the_card(lstm_dir):
    """On the card an f32 LSTM runs kernel A's or F's f32 instance: evaluate
    loads the LSTM-CRF model in f32 (half=False, as bonito_tpu's) and goes
    on to read its data, where it raised before."""
    loaded = []

    def load(*a, **k):
        loaded.append((k["half"], load_model(*a, **{**k, "device": "cpu"})))
        return loaded[-1][1]

    def reach(*a):
        raise ReachedData

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_evaluate, "resolve_device",
                   lambda d: torch.device("cuda"))
        mp.setattr(port_evaluate, "load_model", load)
        mp.setattr(port_evaluate, "load_data", reach)
        with pytest.raises(ReachedData):
            port_evaluate.main(port_evaluate.argparser().parse_args(
                [str(lstm_dir), "--directory", "nowhere"]))
    (half, model), = loaded
    assert half is False
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert any(isinstance(m, nn.LSTM) for m in model.modules())


# ---------------------------------------------------------------------------
# view and train
# ---------------------------------------------------------------------------

def jax_count(name, capsys, monkeypatch):
    """bonito_tpu's view count of a MODELS entry: its CLI with the model's
    ``init`` run under ``jax.eval_shape`` (the count reads shapes only;
    a hac init takes seconds). Its CLI raises on the conv-CTC family (its
    tree printer asks a Block for a registry name), so that count is its
    view's rule on the parameter tree."""
    cfg = JAX_MODELS[name]()
    real = jax_load_symbol(cfg, "Model")

    def make(config):
        model = real(config)
        init = model.init
        model.init = lambda key=None: jax.eval_shape(
            lambda: init(jax.random.PRNGKey(0)))
        return model
    monkeypatch.setattr(jax_view, "load_symbol", lambda c, s: make)
    if cfg["model"]["package"].endswith("ctc"):
        with pytest.raises(AttributeError, match="name"):
            jax_view.main(jax_view.argparser().parse_args([name]))
        capsys.readouterr()
        tree = make(cfg).init()

        def count(t):
            return sum(count(v) if isinstance(v, dict)
                       else 0 if k in ("mean", "var") else int(np.prod(v.shape))
                       for k, v in t.items())
        return count(tree)
    jax_view.main(jax_view.argparser().parse_args([name]))
    line = capsys.readouterr().out.splitlines()[-1]
    return int(line.split(":")[1].replace(",", ""))


@pytest.mark.parametrize("name", list(MODELS))
def test_view_counts_are_bonito_tpu_s(name, capsys, monkeypatch):
    assert set(MODELS) == set(JAX_MODELS)
    ref = jax_count(name, capsys, monkeypatch)
    cli_main(["view", name])
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "total parameters: " + "{:,}".format(ref)
    assert lines[0].startswith("(encoder) ")


def test_view_of_a_directory_and_a_config_file(dirs, capsys):
    cli_main(["view", str(dirs["model"])])
    a = capsys.readouterr().out
    cli_main(["view", str(dirs["model"] / "config.toml")])
    assert capsys.readouterr().out == a
    assert "TCSConv(" in a and "(res_bn) BatchNorm(" in a


def test_train_cli_epoch(dirs, tmp_path):
    data = npy_dir(tmp_path / "data", 24, CHUNK, L=40)
    work = tmp_path / "work"
    cli_main(["train", str(work), "--config",
              str(dirs["model"] / "config.toml"), "--directory", str(data),
              "--device", "cpu", "--batch", "4", "--epochs", "1",
              "--valid-chunks", "4", "--chunks", "8"])
    assert (work / "weights_1.npz").exists()
    header, row = (work / "training.csv").read_text().splitlines()
    fields = dict(zip(header.split(","), row.split(",")))
    assert np.isfinite(float(fields["validation_loss"]))
    assert 0 <= float(fields["validation_mean"]) <= 100
    model = load_model(work, half=False, device="cpu")
    assert model.config["model"]["package"].endswith("ctc")
