"""The port's ``duplex`` (``bonito_tpu_torch.duplex``, ``bam_reader``,
``io.DuplexWriter``, ``cli/duplex.py``) on the CPU against bonito_tpu's:
``adj_qscores``, ``trim_while``, ``compute_consensus`` and
``call_basespace_duplex`` on random pairs; ``ReadIndexedBam`` over BAM,
SAM, gzipped SAM and CRAM files the port writes (reverse-strand records
turned back, secondary and supplementary ones skipped); and the CLI's
fastq, SAM, BAM and CRAM with their summaries, from each input format,
with ``--reference`` and on spawned workers, equal to bonito_tpu's CLI.
Every comparison is exact."""

import gzip
import io
import os
import sys

import numpy as np
import pytest

from bonito_tpu import bam_reader as jbam_reader
from bonito_tpu import cram as jcram
from bonito_tpu import duplex as jduplex
from bonito_tpu.cli import duplex as jcli
from bonito_tpu_torch import bam_reader, duplex
from bonito_tpu_torch.bam import BAMWriter
from bonito_tpu_torch.cli import duplex as port_cli
from bonito_tpu_torch.cram import CramWriter
from bonito_tpu_torch.util import revcomp

from bam_records import parse_bam

BASES = np.array(list("ACGT"))


def rand_seq(rng, n):
    return "".join(rng.choice(BASES, size=n))


def rand_qual(rng, n):
    return "".join(chr(33 + int(q)) for q in rng.integers(2, 45, n))


def mutate(rng, seq, rate=0.05):
    """``seq`` with substitutions, insertions and deletions at ``rate``."""
    out = []
    for base in seq:
        r = rng.random()
        if r < rate / 3:
            continue
        if r < 2 * rate / 3:
            out.append(rng.choice(BASES))
        elif r < rate:
            out.append(base)
            out.append(rng.choice(BASES))
            continue
        out.append(base)
    return "".join(out)


def pair(rng, n):
    """A template and its complement strand: the reverse complement of a
    mutated copy, each with its own qualities."""
    t = rand_seq(rng, n)
    c = revcomp(mutate(rng, t))
    return (duplex.SeqRecord("t", t, rand_qual(rng, len(t))),
            duplex.SeqRecord("c", c, rand_qual(rng, len(c))))


@pytest.mark.parametrize("qshift", [-1, 0, 1, 3])
@pytest.mark.parametrize("seed", [1, 2])
def test_adj_qscores_equals_bonito_tpus(seed, qshift):
    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(BASES, 300, p=[0.6, 0.2, 0.1, 0.1]))
    q = rng.integers(0, 50, 300).astype(np.float32)
    for window, hps in ((5, 2), (1, 3), (3, 5)):
        np.testing.assert_array_equal(
            duplex.adj_qscores(q, seq, qshift, window, hps),
            jduplex.adj_qscores(q, seq, qshift, window, hps))


@pytest.mark.parametrize("cigar", [
    "3X2=20=1X30=", "12=", "5I11=2D40=3X", "40=1X2=9X", "", "3D2I",
    "11=5X10=12I"])
def test_trim_while_equals_bonito_tpus(cigar):
    ops = duplex.cigartuples_from_string(cigar)
    assert ops == jduplex.cigartuples_from_string(cigar)
    for from_end in (False, True):
        for num_match in (11, 3):
            assert (duplex.trim_while(ops, from_end, num_match)
                    == jduplex.trim_while(ops, from_end, num_match))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_compute_consensus_equals_bonito_tpus(seed):
    rng = np.random.default_rng(seed)
    t, c = pair(rng, 400)
    cigar = duplex.duplex_align(t.sequence, revcomp(c.sequence))
    assert cigar == jduplex.duplex_align(t.sequence, revcomp(c.sequence))
    tq = rng.integers(0, 50, len(t.sequence)).astype(np.float32)
    cq = rng.integers(0, 50, len(c.sequence)).astype(np.float32)
    args = (cigar, t.sequence, tq, revcomp(c.sequence), cq)
    assert duplex.compute_consensus(*args) == jduplex.compute_consensus(*args)


@pytest.mark.parametrize("n", [30, 500, 2000])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_call_basespace_duplex_equals_bonito_tpus(seed, n):
    rng = np.random.default_rng(seed + n)
    t, c = pair(rng, n)
    out = duplex.call_basespace_duplex(t, c)
    assert out == jduplex.call_basespace_duplex(jduplex.SeqRecord(*t),
                                                jduplex.SeqRecord(*c))
    if n > 30:
        assert len(out["sequence"]) > n // 2


class Mapping:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def reads(seed=4, n=6):
    """(name, sequence, qstring) of duplex pairs: each template and, as
    ``<name>_c``, its complement strand; one unpaired read."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t, c = pair(rng, int(rng.integers(200, 900)))
        out += [(f"r{i}", t.sequence, t.qstring),
                (f"r{i}_c", c.sequence, c.qstring)]
    out.append(("lone", rand_seq(rng, 50), rand_qual(rng, 50)))
    return out


def write_inputs(directory, records):
    """The records as BAM (``r1`` mapped to the reverse strand), CRAM,
    SAM and gzipped SAM (with a secondary and a supplementary record and
    a read without qualities), the forms ``ReadIndexedBam`` reads."""
    paths = {}
    header = "@HD\tVN:1.6\tSO:unknown\n@SQ\tSN:chr1\tLN:5000\n"
    for ext, writer in (("bam", BAMWriter), ("cram", CramWriter)):
        paths[ext] = directory / f"in.{ext}"
        with open(paths[ext], "wb") as f:
            w = writer(f, header, [("chr1", 5000)])
            for name, seq, qual in records:
                mapping = None
                if name == "r1":  # stored reverse complemented, flag 16
                    mapping = Mapping(
                        ctg="chr1", r_st=10, r_en=10 + len(seq), q_st=0,
                        q_en=len(seq), mapq=60, strand=-1,
                        cigar_str=f"{len(seq)}M", NM=0, MD=str(len(seq)),
                        ref_seq=revcomp(seq))
                w.write(name, seq, qual, mapping=mapping)
            w.close()
    lines = [header.rstrip("\n")]
    for name, seq, qual in records:
        flag, s, q = (16, revcomp(seq), qual[::-1]) if name == "r2" else (
            4, seq, qual)
        lines.append(f"{name}\t{flag}\t*\t0\t0\t*\t*\t0\t0\t{s}\t{q}")
    lines.append(f"r0\t256\t*\t0\t0\t*\t*\t0\t0\tACGT\t!!!!")
    lines.append(f"r3\t2048\t*\t0\t0\t*\t*\t0\t0\tGGGG\t!!!!")
    lines.append("noqual\t4\t*\t0\t0\t*\t*\t0\t0\tACGTACGT\t*")
    paths["sam"] = directory / "in.sam"
    paths["sam"].write_text("\n".join(lines) + "\n")
    paths["sam.gz"] = directory / "in.sam.gz"
    paths["sam.gz"].write_bytes(gzip.compress(paths["sam"].read_bytes()))
    return paths


@pytest.mark.parametrize("fmt", ["bam", "cram", "sam", "sam.gz"])
def test_read_indexed_bam_equals_bonito_tpus(fmt, tmp_path):
    records = reads()
    path = write_inputs(tmp_path, records)[fmt]
    port, jax = bam_reader.ReadIndexedBam(path), jbam_reader.ReadIndexedBam(
        path)
    assert port.read_ids == jax.read_ids
    assert len(port) == len(jax) >= len(records)
    for read_id in jax.read_ids:
        assert tuple(port.get_record(read_id)) == tuple(
            jax.get_record(read_id))
    for name, seq, qual in records:  # reverse-strand records turned back
        assert tuple(port.get_record(name)) == (name, seq, qual)
    assert "missing" not in port
    with pytest.raises(KeyError):
        port.get_record("missing")


def run(cli, argv, out):
    """``cli.main`` with fd 1 on ``out`` (its name picks the format; the
    summary is written beside it); stderr's text."""
    saved = os.dup(1)
    stdout, stderr = sys.stdout, sys.stderr
    err = io.StringIO()
    with open(out, "wb") as f:
        os.dup2(f.fileno(), 1)
        sys.stdout = io.TextIOWrapper(io.BufferedWriter(
            io.FileIO(1, "w", closefd=False)))
        sys.stderr = err
        try:
            cli.main(cli.argparser().parse_args(argv))
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            sys.stdout, sys.stderr = stdout, stderr
    return err.getvalue()


def without_pg(data):
    return b"\n".join(line for line in data.split(b"\n")
                      if not line.startswith(b"@PG"))


CASES = {
    "bam-fastq": ("bam", "fastq", []),
    "bam-sam": ("bam", "sam", []),
    "cram-sam": ("cram", "sam", []),
    "sam-fastq": ("sam", "fastq", []),
    "samgz-sam": ("sam.gz", "sam", []),
    "bam-bam": ("bam", "bam", []),
    "sam-cram": ("sam", "cram", []),
    "no-header": ("bam", "fastq", ["--no-header"]),
    "min-qscore": ("bam", "sam", ["--min-qscore", "12"]),
    "reference-sam": ("bam", "sam", ["--reference", "REF"]),
    "reference-cram": ("cram", "cram", ["--reference", "REF"]),
    "two-workers": ("cram", "fastq", ["--threads", "2"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_duplex_cli_equals_bonito_tpus(case, tmp_path):
    src, ext, extra = CASES[case]
    records = reads()
    paths = write_inputs(tmp_path, records)
    pairs = [(f"r{i}", f"r{i}_c") for i in range(6)] + [
        ("r0", "missing"), ("noqual", "r1_c")]
    pairs_file = tmp_path / "pairs.txt"
    body = "".join(f"{a}\t{b}\n" for a, b in pairs)
    pairs_file.write_text(body if "--no-header" in extra
                          else "template complement\n" + body)
    ref = tmp_path / "ref.fasta"
    ref.write_text("".join(f">{name}\n{seq}\n" for name, seq, _ in records
                           if not name.endswith("_c")))
    extra = [str(ref) if a == "REF" else a for a in extra]
    argv = [str(paths[src]), str(pairs_file)]
    # bonito_tpu's consensus in this process (its workers would fork this
    # threaded one); the port's workers are spawned
    plain = [a for i, a in enumerate(extra)
             if "--threads" not in extra[max(i - 1, 0):i + 1]]
    outs = {}
    for name, cli, more in (
            ("jax", jcli, plain + ["--threads", "0"]),
            ("port", port_cli,
             extra if "--threads" in extra else extra + ["--threads", "0"])):
        (tmp_path / name).mkdir()
        outs[name] = tmp_path / name / f"out.{ext}"
        err = run(cli, argv + more, outs[name])
    assert "> duplex reads:" in err
    data = {k: v.read_bytes() for k, v in outs.items()}
    if ext == "bam":
        (t_port, r_port, rec_port), (t_jax, r_jax, rec_jax) = (
            parse_bam(data["port"]), parse_bam(data["jax"]))
        assert without_pg(t_port.encode()) == without_pg(t_jax.encode())
        assert (r_port, rec_port) == (r_jax, rec_jax)
        n = len(rec_port)
    elif ext == "cram":
        kw = {"reference": str(ref)} if "--reference" in extra else {}
        port, jax = (list(jcram.CramReader(data[k], **kw))
                     for k in ("port", "jax"))
        assert [(r.name, r.seq, r.qual, r.flag, r.pos, r.tags) for r in port] \
            == [(r.name, r.seq, r.qual, r.flag, r.pos, r.tags) for r in jax]
        n = len(port)
    else:
        assert without_pg(data["port"]) == without_pg(data["jax"])
        lines = data["port"].decode().splitlines()
        n = (len(lines) // 4 if ext == "fastq"
             else sum(not line.startswith("@") for line in lines))
    assert n == (3 if "--min-qscore" in extra else 6)  # mean q 11.5-12.9
    summaries = [(tmp_path / k / "out_summary.tsv").read_text()
                 for k in ("port", "jax")]
    assert summaries[0] == summaries[1]
    assert len(summaries[0].splitlines()) == n + 1


def test_duplex_cli_refuses_an_mmi(tmp_path):
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("template complement\n")
    with pytest.raises(SystemExit):
        run(port_cli, ["in.bam", str(pairs), "--reference", "ref.mmi"],
            tmp_path / "out.sam")
