"""The port's writers against bonito_tpu's: ``sam_header`` (the @PG line
may differ only in PN, VN and CL), ``sam_record`` unmapped and on either
strand, ``encode_moves``, ``summary_row`` (with and without an
alignment), ``write_fastq`` and ``biofmt`` give equal strings; ``Writer``
writes equal SAM, fastq and BAM (equal after BGZF decompression, ending
in the EOF block) from the same results, with the min-qscore and
zero-length rejections and the summary TSV; ``CTCWriter`` writes equal
npy outputs; ``Aligner`` maps alike."""

import gzip
import io
import os
import struct
import sys
import uuid

import numpy as np
import pytest

from bonito_tpu import aligner as jaligner
from bonito_tpu import io as jio
from bonito_tpu import reader as jreader
from bonito_tpu_torch import aligner as taligner
from bonito_tpu_torch import io as tio
from bonito_tpu_torch import reader as treader
from bonito_tpu_torch.util import mean_qscore_from_qstring, revcomp

from bam_records import EOF_BLOCK



def mapping(mod, strand, seqlen):
    return mod.Mapping(ctg="chr1", r_st=100, r_en=100 + seqlen - 4,
                       q_st=2, q_en=seqlen - 1, strand=strand, mapq=37,
                       cigar_str=f"{seqlen - 8}=1X1I2D", NM=4, MD="5^AC3",
                       ref_seq="ACGT" * 3)


def read(mod, i, n=3000):
    r = mod.Read()
    r.read_id = str(uuid.UUID(int=i + 1))
    r.run_id, r.filename, r.sample_rate = "run7", "x.pod5", 5000
    r.channel, r.mux, r.start, r.duration = 10 + i, 2, 1.5 + i, n / 5000
    r.num_samples, r.trimmed_samples = n, 40 * i
    r.signal = np.linspace(-1, 1, n - 40 * i).astype(np.float32)
    r.start_time, r.shift, r.scale = "2026-01-01T00:00:01.000+00:00", 90.0, 23.0
    return r


def results(seed, n_reads=6):
    """(i, result) of random calls: one empty, some of low quality."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        frames = 0 if i == 3 else int(rng.integers(50, 400))
        moves = (rng.random(frames) < 0.4).astype(np.uint8)
        n = int(moves.sum())
        seq = "".join(rng.choice(list("ACGT"), n))
        lo = 3 if i == 4 else 10
        qstring = "".join(chr(33 + q) for q in rng.integers(lo, lo + 20, n))
        out.append((i, {"sequence": seq, "qstring": qstring, "moves": moves,
                        "stride": 6}))
    return out


def test_sam_header_and_records_are_bonito_tpu_s():
    groups = ["@RG\tID:run7_m\tPL:ONT", "@RG\tID:run8_m\tPL:ONT"]
    sq = [("chr1", 5000), ("chr2", 300)]
    a = tio.sam_header(groups, sq, margs=["m", "r"]).splitlines()
    b = jio.sam_header(groups, sq, margs=["m", "r"]).splitlines()
    assert a[0] == b[0] and a[2:] == b[2:]
    keep = lambda line: [f for f in line.split("\t")
                         if f[:3] not in ("PN:", "VN:", "CL:")]
    assert keep(a[1]) == keep(b[1]) and "PN:bonito_tpu_torch" in a[1]
    assert "CL:bonito_tpu_torch m r" in a[1]
    rng = np.random.default_rng(1)
    seq = "".join(rng.choice(list("ACGTN"), 60))
    qs = "".join(chr(33 + q) for q in rng.integers(0, 40, 60))
    tags = ["RG:Z:run7", "qs:i:12", tio.ArrayTag("mv", "c", [6, 1, 0, 1])]
    jtags = ["RG:Z:run7", "qs:i:12", jio.ArrayTag("mv", "c", [6, 1, 0, 1])]
    assert tio.sam_record("r1", seq, qs, tags=tags) == \
        jio.sam_record("r1", seq, qs, tags=jtags)
    for strand in (1, -1):
        assert tio.sam_record("r1", seq, qs, mapping(taligner, strand, 60),
                              tags) == \
            jio.sam_record("r1", seq, qs, mapping(jaligner, strand, 60), jtags)
    assert revcomp("ACGTNRY") == "RYNACGT"
    moves = rng.integers(0, 2, 500)
    assert tio.encode_moves(moves, 6) == jio.encode_moves(moves, 6)
    assert mean_qscore_from_qstring(qs) == \
        __import__("bonito_tpu.util").util.mean_qscore_from_qstring(qs)


@pytest.mark.parametrize("aligned", [None, False, 1, -1])
def test_summary_row_is_bonito_tpu_s(aligned):
    m = (aligned if aligned in (None, False) else
         (mapping(taligner, aligned, 80), mapping(jaligner, aligned, 80)))
    a = tio.summary_row(read(treader, 2), 80, 11.5,
                        alignment=m[0] if isinstance(m, tuple) else m)
    b = jio.summary_row(read(jreader, 2), 80, 11.5,
                        alignment=m[1] if isinstance(m, tuple) else m)
    assert a == b
    assert tio.summary_field_names(bool(aligned)) == \
        jio.summary_field_names(bool(aligned))


def test_write_fastq_is_bonito_tpu_s():
    a, b = io.StringIO(), io.StringIO()
    tio.write_fastq("r1", "ACGT", "!!#$", fd=a, tags=["qs:i:2", "ch:i:3"])
    jio.write_fastq("r1", "ACGT", "!!#$", fd=b, tags=["qs:i:2", "ch:i:3"])
    assert a.getvalue() == b.getvalue()


def _redirect(path, fn):
    """fn() with fd 1 and sys.stdout on ``path`` (biofmt and
    summary_file read the redirect's name)."""
    saved, stdout = os.dup(1), sys.stdout
    with open(path, "wb") as f:
        os.dup2(f.fileno(), 1)
        sys.stdout = io.TextIOWrapper(io.BufferedWriter(
            io.FileIO(1, "w", closefd=False)))
        try:
            out = fn()
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            sys.stdout = stdout
    return out


def write_both(tmp_path, ext, min_qscore, writer="Writer", **kw):
    """The same results through both packages' writer; (output bytes,
    summary text, rejections, log) of each."""
    out = []
    for name, mod, rmod in (("j", jio, jreader), ("t", tio, treader)):
        d = tmp_path / name
        d.mkdir()
        items = [(read(rmod, i), res) for i, res in results(3)]

        def run():
            fmt = mod.biofmt(aligned=False)
            assert fmt.name == ext
            w = getattr(mod, writer)(fmt.mode, iter(items), groups=[
                "@RG\tID:run7_m"], group_key="m", min_qscore=min_qscore,
                output_dir=str(d), **kw)
            w.start()
            return w.stop(), w.log
        rejected, log = _redirect(d / f"out.{ext}", run)
        summary = d / "out_summary.tsv"
        out.append(((d / f"out.{ext}").read_bytes(),
                    summary.read_text() if summary.exists() else None,
                    dict(rejected), log))
    return out


@pytest.mark.parametrize("ext", ["sam", "fastq", "bam"])
@pytest.mark.parametrize("min_qscore", [0, 12])
def test_writer_is_bonito_tpu_s(tmp_path, ext, min_qscore):
    (ja, js, jr, jl), (ta, ts, tr, tl) = write_both(tmp_path, ext, min_qscore)
    assert tr == jr and tl == jl and ts == js
    assert tr["zero length"] == 1
    assert tr.get(f"qscore < {min_qscore}", 0) == (1 if min_qscore else 0)
    if ext == "bam":
        assert ta.endswith(EOF_BLOCK)
        ja, ta = gzip.decompress(ja), gzip.decompress(ta)
        assert ta[:4] == ja[:4] == b"BAM\x01"
        # the header text (its @PG line differs), then the rest unchanged
        (n,), (m,) = struct.unpack_from("<i", ta, 4), struct.unpack_from(
            "<i", ja, 4)
        ta, ja = (ta[8:8 + n], ta[8 + n:]), (ja[8:8 + m], ja[8 + m:])
        assert ta[1] == ja[1]
        ta, ja = ta[0], ja[0]
    keep = lambda data: [line for line in data.split(b"\n")
                         if b"@PG" not in line]
    assert keep(ta) == keep(ja)
    assert b"PN:bonito_tpu_torch" in ta or ext == "fastq"


def test_writer_refuses_cram(tmp_path):
    """CRAM is written now (mode ``wc``): no record, then one, each read
    back by bonito_tpu's ``CramReader``; the summary goes to ``tmp_path``."""
    from bonito_tpu.cram import CramReader
    fd = io.BytesIO()
    w = tio.Writer("wc", iter([]), fd=fd, output_dir=tmp_path)
    w.start()
    w.stop()
    assert list(CramReader(fd.getvalue())) == []

    class Read:
        read_id, run_id, signal = "r", "run", np.zeros(60, np.int16)
    fd = io.BytesIO()
    w = tio.Writer("wc", iter([(Read(), {"sequence": "ACGTA",
                                         "qstring": "+++++"})]),
                   fd=fd, output_dir=tmp_path)
    w.start()
    w.stop()
    (rec,) = CramReader(fd.getvalue())
    assert (rec.name, rec.seq, rec.qual) == ("r", "ACGTA", "+++++")


class _Aligner:
    """An aligner-like object without the index (no @SQ): the results
    carry their mappings."""


def test_ctc_writer_is_bonito_tpu_s(tmp_path):
    outs = []
    for name, mod, amod, rmod in (("j", jio, jaligner, jreader),
                                  ("t", tio, taligner, treader)):
        d = tmp_path / name
        d.mkdir()
        rng = np.random.default_rng(4)
        items = []
        for i in range(8):
            r = read(rmod, i, 1000 + 40 * i)
            n = 40 + i
            seq = "".join(rng.choice(list("ACGT"), n))
            m = amod.Mapping(ctg="chr1", r_st=0, r_en=n, q_st=0,
                             q_en=n - (i == 5) * 20,
                             strand=1 if i % 2 else -1, mapq=60,
                             cigar_str=f"{n}=" if i != 6 else f"{n - 9}=9X",
                             NM=0 if i != 6 else 9, MD="",
                             ref_seq=seq if i != 7 else "N" + seq[1:])
            items.append((r, {"sequence": seq, "qstring": "5" * n,
                              "mapping": m if i != 2 else None}))

        def run():
            w = mod.CTCWriter("w", iter(items), _Aligner(), fd=sys.stdout,
                              output_dir=str(d), min_accuracy=0.9,
                              min_coverage=0.9)
            w.start()
            return w.stop()
        rejected = _redirect(d / "out.sam", run)
        outs.append((dict(rejected), {
            k: np.load(d / f"{k}.npy") for k in
            ("chunks", "references", "reference_lengths")},
            (d / "out.sam").read_text().splitlines()[2:]))
    (jr, jn, js), (tr, tn, ts) = outs
    assert tr == jr and set(tr) == {"unmapped", "low coverage",
                                    "low accuracy", "N in reference"}
    assert ts == js and len(ts) == 4
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])
        assert tn[k].dtype == jn[k].dtype


def test_aligner_maps_alike(tmp_path):
    rng = np.random.default_rng(5)
    contigs = ["".join(rng.choice(list("ACGT"), n)) for n in (3000, 2000)]
    fasta = tmp_path / "ref.fasta"
    fasta.write_text("".join(f">c{i} desc\n{s[:1000]}\n{s[1000:]}\n"
                             for i, s in enumerate(contigs)))
    a, b = taligner.Aligner(str(fasta)), jaligner.Aligner(str(fasta))
    assert a.seq_names_lengths() == b.seq_names_lengths()
    queries = [contigs[0][200:1400], revcomp(contigs[1][50:900]),
               contigs[1][:300][:150] + "ACGT" + contigs[1][300:600],
               "".join(rng.choice(list("ACGT"), 500)), ""]
    as_dict = lambda m: None if m is None else vars(m)
    for q in queries:
        assert as_dict(a.map(q)) == as_dict(b.map(q))
    assert a.map(queries[0]).ctg == "c0" and a.map(queries[1]).strand == -1
    items = [(read(treader, i), {"sequence": q}) for i, q in
             enumerate(queries)]
    mapped = list(taligner.align_map(a, iter(items), n_thread=2))
    assert [m["mapping"] for _, m in mapped] == [a.map(q) for q in queries]
    with pytest.raises(ValueError, match="mmi"):
        taligner.Aligner(str(tmp_path / "ref.mmi"))
