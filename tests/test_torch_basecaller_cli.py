"""``python -m bonito_tpu_torch basecaller`` on the CPU against bonito_tpu's
CLI: the same small LSTM-CRF directory (written by bonito_tpu) and pod5
directory (written by bonito_tpu's ``write_pod5``), both CLIs in this
process with stdout on a file named for the format, both models in f32
(``load_model`` wrapped with ``half=False``: bf16 is not comparable on the
CPU, ROADMAP Queue 3). fastq, SAM and BAM record for record: sequences,
``mv`` and every other tag identical, qstrings within one phred step, the
summary TSV equal; and the same with ``--reference``, ``--revcomp``,
``--read-ids`` with and without ``--skip``, ``--max-reads``,
``--min-qscore``, ``--no-trim``, ``--save-ctc``, ``--beam`` and ``--rna``
(the result dict of the port's ``basecall`` and ``fmt`` on each). The
refusals (``--distributed``, no card) raise before a model loads;
a published model name is downloaded (from a ``file://`` zip) and
basecalls as in bonito_tpu's CLI; a conv-CTC directory basecalls (held
against bonito_tpu in tests/test_torch_ctc_cli.py).

The model is ``tests/test_torch_reverse.py``'s ``lstm_dir`` (H 96, two
layers, seed 14, the CRF weight x 10, quantize=false). The reads' seed
matters: the two packages' f32 encoders differ in the last bits (3e-6 to
5e-5 on these scores, with the order of the CPU's sums), and where two
paths of this random model tie that closely the decode takes the other
one. Seeds 1 and 2 of these reads meet such a tie, in ``--beam`` (both)
and ``--revcomp`` (seed 2, under one torch thread); seed 5 meets none. On
identical scores the decodes agree (``tests/test_torch_beam.py``,
``tests/test_torch_reverse.py``)"""

import io
import os
import sys
import uuid

import jax
import numpy as np
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu.cli import basecaller as jax_cli
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.pod5 import write_pod5
from bonito_tpu_torch.cli import basecaller as port_cli
from bonito_tpu_torch.cli import main as cli_main

from bam_records import parse_bam

READ_SEED = 5
LENGTHS = [700, 2400, 5100, 3000, 1600]
ADAPTER = 300  # samples of a raised level at the start of some reads


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


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    model = root / "model"
    model.mkdir()
    cfg = lstm_crf_config(features=96, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=1000, overlap=200)
    cfg["basecaller"]["quantize"] = False
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(14))
    crf = str(next(i for i, layer in enumerate(cfg["encoder"]["sublayers"])
                   if layer["type"] == "linearcrfencoder"))
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 10
    jconfig.save_config(cfg, model / "config.toml")
    jckpt.save_params(model / "weights_1.npz", m.params)

    reads = root / "reads"
    reads.mkdir()
    rng = np.random.default_rng(READ_SEED)
    records = []
    for i, n in enumerate(LENGTHS):
        pa = 90 + 23 * rng.normal(size=n)  # the config's pa standardisation
        if i % 2:
            pa[:ADAPTER] += 150  # a peak the trim cuts away
        scale, offset = 0.2, -12.0
        records.append({
            "read_id": str(uuid.UUID(int=1000 + i)),
            "signal": np.rint(pa / scale - offset).astype(np.int16),
            "calibration_scale": scale, "calibration_offset": offset,
            "channel": 10 + i, "well": 1 + i % 4, "read_number": 100 + i,
            "start": 5000 * i})
    write_pod5(reads / "a.pod5", records[:3])
    write_pod5(reads / "b.pod5", records[3:], compress=False,
               run_info={"acquisition_id": "run1", "sample_id": "s1"})
    ids = root / "ids.txt"
    ids.write_text(f"{records[1]['read_id']}\n{records[4]['read_id']}\n")
    return {"root": root, "model": model, "reads": reads, "ids": ids}


def run_cli(cli, argv, out):
    """Run ``cli.main`` with fd 1 on ``out`` (the format comes from its
    name) and its summary into ``out``'s directory; stderr's text."""
    saved = os.dup(1)
    stdout, stderr = sys.stdout, sys.stderr
    err = io.StringIO()
    with open(out, "wb") as f:
        os.dup2(f.fileno(), 1)
        sys.stdout = io.TextIOWrapper(io.BufferedWriter(
            io.FileIO(1, "w", closefd=False)))
        sys.stderr = err
        try:
            cli.main(cli.argparser().parse_args(
                argv + ["--output-dir", str(out.parent)]))
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            sys.stdout, sys.stderr = stdout, stderr
    return err.getvalue()


@pytest.fixture(scope="module")
def jax_runs(dirs, f32):
    """bonito_tpu's CLI, run once per (format, options)."""
    runs = {}

    def get(ext, extra):
        key = (ext, tuple(extra))
        if key not in runs:
            out = dirs["root"] / f"jax{len(runs)}" / f"out.{ext}"
            out.parent.mkdir()
            argv = [str(dirs["model"]), str(dirs["reads"]), "--n-proc", "1"]
            run_cli(jax_cli, argv + list(extra), out)
            runs[key] = out
        return runs[key]
    return get


@pytest.fixture(scope="module")
def reference(dirs, jax_runs):
    """A FASTA of bonito_tpu's calls, every other one reverse
    complemented, each read its own contig."""
    lines = jax_runs("fastq", []).read_text().splitlines()
    comp = str.maketrans("ACGT", "TGCA")
    path = dirs["root"] / "ref.fasta"
    with open(path, "w") as f:
        for i in range(0, len(lines), 4):
            seq = lines[i + 1]
            if (i // 4) % 2:
                seq = seq.translate(comp)[::-1]
            f.write(f">ctg{i // 4}\n{seq}\n")
    return path


def qual_close(a, b):
    """Two qstrings of one length within one phred step."""
    assert len(a) == len(b)
    if a == b:
        return
    d = (np.frombuffer(a.encode(), np.uint8).astype(int)
         - np.frombuffer(b.encode(), np.uint8))
    assert np.abs(d).max() <= 1


def compare_pg(a, b):
    """@PG lines: equal but for PN, VN and CL."""
    keep = lambda line: [f for f in line.split("\t")
                         if f[:3] not in ("PN:", "VN:", "CL:")]
    assert keep(a) == keep(b)


def compare_fastq(a, b):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb) and len(la) % 4 == 0
    for i in range(0, len(la), 4):
        assert la[i:i + 3] == lb[i:i + 3]  # id and tags, sequence, '+'
        qual_close(la[i + 3], lb[i + 3])
    return len(la) // 4


def compare_sam(a, b):
    la, lb = a.splitlines(), b.splitlines()
    assert len(la) == len(lb)
    n = 0
    for x, y in zip(la, lb):
        if x.startswith("@PG"):
            compare_pg(x, y)
        elif x.startswith("@"):
            assert x == y
        else:
            fx, fy = x.split("\t"), y.split("\t")
            assert fx[:10] == fy[:10] and fx[11:] == fy[11:]
            qual_close(fx[10], fy[10])
            n += 1
    return n


def compare_bam(a, b):
    ta, ra, reca = parse_bam(a)
    tb, rb, recb = parse_bam(b)
    assert ra == rb
    compare_sam(ta, tb)
    assert len(reca) == len(recb)
    for x, y in zip(reca, recb):
        assert x[:4] == y[:4] and x[5] == y[5]
        qual_close(x[4], y[4])
    return len(reca)


def compare_cram(a, b, reference=None):
    """Both CRAMs through bonito_tpu's ``CramReader`` (with the FASTA of a
    reference-based one): the header as ``compare_sam``'s, every field and
    tag of each record equal, qstrings within one phred step."""
    from bonito_tpu.cram import CramReader
    ra, rb = CramReader(a, reference=reference), CramReader(b,
                                                            reference=reference)
    compare_sam(ra.header_text, rb.header_text)
    la, lb = list(ra), list(rb)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert (x.name, x.seq, x.flag, x.ref_id, x.pos, x.mapq, x.cigar,
                x.tags) == (y.name, y.seq, y.flag, y.ref_id, y.pos, y.mapq,
                            y.cigar, y.tags)
        qual_close(x.qual, y.qual)
    return len(la)


COMPARE = {"fastq": lambda a, b: compare_fastq(a.decode(), b.decode()),
           "sam": lambda a, b: compare_sam(a.decode(), b.decode()),
           "bam": compare_bam, "cram": compare_cram}

CASES = {
    "fastq": ("fastq", [], 5),
    "sam": ("sam", [], 5),
    "bam": ("bam", [], 5),
    "bam-two-readers": ("bam", ["--n-proc", "2"], 5),
    "reference-sam": ("sam", ["--reference", "REF"], 5),
    "reference-bam": ("bam", ["--reference", "REF"], 5),
    "cram": ("cram", [], 5),
    "reference-cram": ("cram", ["--reference", "REF"], 5),
    "revcomp": ("sam", ["--revcomp"], 5),
    "read-ids": ("sam", ["--read-ids", "IDS"], 2),
    "read-ids-skip": ("bam", ["--read-ids", "IDS", "--skip"], 3),
    "max-reads": ("fastq", ["--max-reads", "2"], 2),
    "min-qscore": ("sam", ["--min-qscore", "2"], 0),
    "no-trim": ("bam", ["--no-trim"], 5),
    "beam": ("sam", ["--beam"], 5),
    "rna": ("fastq", ["--rna"], 5),
    "save-ctc": ("sam", ["--reference", "REF", "--save-ctc",
                         "--ctc-min-accuracy", "0.5",
                         "--ctc-min-coverage", "0.5"], None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_port_cli_equals_bonito_tpu_cli(case, dirs, jax_runs, reference,
                                        f32, tmp_path):
    ext, extra, n_records = CASES[case]
    extra = [str(reference) if a == "REF" else str(dirs["ids"]) if a == "IDS"
             else a for a in extra]
    # bonito_tpu's single reader process: its worker processes would fork
    # this threaded process; the port's readers are spawned
    jax_extra = [a for i, a in enumerate(extra)
                 if "--n-proc" not in extra[max(i - 1, 0):i + 1]]
    ref = jax_runs(ext, jax_extra)
    out = tmp_path / f"out.{ext}"
    argv = [str(dirs["model"]), str(dirs["reads"]), "--device", "cpu"]
    err = run_cli(port_cli, argv + (["--n-proc", "1"] if "--n-proc" not in
                                     extra else []) + extra, out)
    fasta = ({"reference": str(reference)}
             if ext == "cram" and "--reference" in extra else {})
    n = COMPARE[ext](ref.read_bytes(), out.read_bytes(), **fasta)
    if n_records is not None:
        assert n == n_records
    assert f"> completed reads: " in err and "samples per second" in err
    summary = out.parent / "out_summary.tsv"
    ref_summary = ref.parent / "out_summary.tsv"
    assert summary.exists() == ref_summary.exists() == bool(n)
    if n:
        assert summary.read_text() == ref_summary.read_text()
        assert len(summary.read_text().splitlines()) == n + 1
    if case == "save-ctc":
        assert n > 0
        for name in ("chunks", "references", "reference_lengths"):
            np.testing.assert_array_equal(np.load(out.parent / f"{name}.npy"),
                                          np.load(ref.parent / f"{name}.npy"))
    if case.startswith("reference"):
        text = out.read_bytes()
        if ext == "bam":
            _, _, records = parse_bam(text)
            mapped = sum(r[0][0] >= 0 for r in records)
        elif ext == "cram":
            from bonito_tpu.cram import CramReader
            mapped = sum(r.ref_id >= 0 for r in CramReader(
                text, reference=str(reference)))
        else:
            mapped = sum(line.split("\t")[2] != "*" for line in
                         text.decode().splitlines() if line[0] != "@")
        assert mapped > 0


@pytest.mark.parametrize("argv, match", [
    (["--distributed"], "item 12"),
    (["--device", "cpu", "OUT.cram"], None),
])
def test_refusals_name_their_item(argv, match, dirs, f32, tmp_path):
    """``--distributed`` raises, naming its ROADMAP item; a ``.cram``
    stdout, refused before CRAM was ported (item 14), now writes a file
    that bonito_tpu's ``CramReader`` reads."""
    out = tmp_path / ("out.cram" if "OUT.cram" in argv else "out.sam")
    argv = [str(dirs["model"]), str(dirs["reads"]), "--n-proc", "1"] + [
        a for a in argv if a != "OUT.cram"]
    if match is None:
        from bonito_tpu.cram import CramReader
        run_cli(port_cli, argv, out)
        assert len(list(CramReader(out.read_bytes()))) == len(LENGTHS)
        return
    with pytest.raises(NotImplementedError, match=match):
        run_cli(port_cli, argv, out)


def test_download_and_ctc_directory_refused(dirs, f32, tmp_path,
                                            monkeypatch):
    """A published name with no directory is downloaded (here from a
    ``file://`` zip of the test model in upstream's form: config.toml and
    weights_1.tar) and basecalls as bonito_tpu's CLI does on the same
    name; a conv-CTC directory basecalls."""
    import zipfile
    from bonito_tpu import util as jutil
    from bonito_tpu.cli import download as jdownload
    from bonito_tpu_torch import util
    from bonito_tpu_torch.cli import download
    from bonito_tpu_torch.cli.export import torch_state_dict
    from bonito_tpu_torch.util import load_model
    name = "dna_r10.4.1_e8.2_400bps_hac@v5.0.0"
    model = load_model(dirs["model"], half=False, device="cpu")
    site = tmp_path / "site"
    site.mkdir()
    torch.save(torch_state_dict(model), tmp_path / "weights_1.tar")
    with zipfile.ZipFile(site / f"{name}.zip", "w") as zf:
        zf.write(dirs["model"] / "config.toml", f"{name}/config.toml")
        zf.write(tmp_path / "weights_1.tar", f"{name}/weights_1.tar")
    for mod in (download, jdownload):
        monkeypatch.setattr(mod, "__url__", f"file://{site}/")
    monkeypatch.setattr(util, "__models_dir__", tmp_path / "port_models")
    monkeypatch.setattr(jutil, "__models_dir__", tmp_path / "jax_models")
    ref = tmp_path / "jax" / "out.sam"
    ref.parent.mkdir()
    run_cli(jax_cli, [name, str(dirs["reads"]), "--n-proc", "1"], ref)
    out = tmp_path / "port" / "out.sam"
    out.parent.mkdir()
    err = run_cli(port_cli, [name, str(dirs["reads"]), "--device", "cpu",
                             "--n-proc", "1"], out)
    assert "> downloading model" in err
    assert sorted(p.name for p in (tmp_path / "port_models" / name).iterdir()
                  ) == ["config.toml", "weights_1.npz", "weights_1.tar"]
    assert COMPARE["sam"](ref.read_bytes(), out.read_bytes()) == 5
    # a conv-CTC directory (bonito_tpu's package name) basecalls now
    from bonito_tpu_torch import checkpoint as tckpt
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.ctc.model import Model as CTCModel
    from bonito_tpu_torch.models import conv_ctc_config
    ctc = tmp_path / "ctc"
    ctc.mkdir()
    cfg = conv_ctc_config(batchsize=4, chunksize=600, overlap=120)
    cfg["model"]["package"] = "bonito_tpu.ctc"
    cfg["block"] = [dict(b, filters=16, repeat=1) for b in cfg["block"][:3]]
    save_config(cfg, ctc / "config.toml")
    tckpt.save_params(ctc / "weights_1.npz", CTCModel(cfg).init(0))
    out = tmp_path / "out.sam"
    err = run_cli(port_cli, [str(ctc), str(dirs["reads"]), "--device", "cpu",
                             "--n-proc", "1"], out)
    assert "completed reads: 5" in err
    assert len([line for line in out.read_text().splitlines()
                if not line.startswith("@")]) == 5


def test_no_card_raises_unless_the_cpu_is_asked(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli_main(["basecaller", str(dirs["model"]), str(dirs["reads"])])
