"""The port's CRAM output (``bonito_tpu_torch.cram``, ``rans``) against
bonito_tpu's on the CPU: the rANS coder's bytes for orders 0 and 1 (the
Python coder and the native library), the ``CramWriter``'s bytes on the
same records, referenceless and reference-based and with rANS blocks, each
package's ``CramReader`` on the other's files, and ``io.Writer`` in mode
``wc``. The basecaller CLI's ``.cram`` is held against bonito_tpu's CLI in
``tests/test_torch_basecaller_cli.py``. Every comparison is exact."""

import io
import re

import numpy as np
import pytest

from bonito_tpu import cram as jcram
from bonito_tpu import io as jio
from bonito_tpu import rans as jrans
from bonito_tpu_torch import cram, rans
from bonito_tpu_torch import io as tio
from bonito_tpu_torch.bam import ArrayTag


def rans_cases():
    rng = np.random.default_rng(3)
    return [
        b"", b"A", b"ACG", b"ACGT" * 500,
        bytes(rng.integers(0, 256, 4096, dtype=np.uint8)),
        bytes(rng.integers(65, 70, 3333, dtype=np.uint8)),
        bytes(rng.normal(40, 6, 5000).clip(0, 93).astype(np.uint8) + 33),
        bytes(999),
    ]


@pytest.mark.parametrize("case", range(len(rans_cases())))
@pytest.mark.parametrize("order", [0, 1])
def test_rans_bytes_equal_bonito_tpus(order, case):
    data = rans_cases()[case]
    want = jrans.compress(data, order)
    assert rans.compress(data, order) == want
    assert rans.compress_auto(data, order) == want  # the native library
    assert rans.uncompress(want, len(data)) == data
    assert rans.uncompress_auto(want, len(data)) == data
    assert jrans.uncompress(rans.compress_auto(data, order), len(data)) == data


class Mapping:
    """What the CRAM writer and the summary read of an aligner's mapping."""

    def __init__(self, **kw):
        self.__dict__.update(kw)
        self.cigar_counts = {}
        for n, op in re.findall(r"(\d+)([MIDNSHP=X])", self.cigar_str):
            self.cigar_counts[op] = self.cigar_counts.get(op, 0) + int(n)


REF = ("ACGTACGTAACCGGTTACGTACGTAACCGGTTACGTACGTAACCGGTTACGTACGTAACC"
       "TTGACCATGGCAATCGGATCCATTGAGCTAGGCTTAACGCGTAGCATCGATCGGCTAAGTC")
HDR = ("@HD\tVN:1.6\tSO:unknown\n"
       f"@SQ\tSN:chr1\tLN:{len(REF)}\n"
       "@RG\tID:run0_model\tSM:s\n")
COMP = str.maketrans("ACGT", "TGCA")


def records(rng):
    """Unmapped reads with every tag type the basecaller writes, and
    mapped ones on both strands with substitutions, an insertion and a
    deletion, each with its mapping (``ref_seq``, the reference span, as
    the aligner gives it)."""
    out = []
    for i in range(6):
        n = int(rng.integers(20, 300))
        seq = "".join(rng.choice(list("ACGT"), n))
        qual = "".join(chr(33 + int(q)) for q in rng.integers(1, 50, n))
        tags = ["RG:Z:run0_model", f"qs:i:{int(rng.integers(1, 40))}",
                f"ns:i:{n * 6}", "ts:i:0",
                ArrayTag("mv", "c", np.concatenate(
                    [[6], rng.integers(0, 2, n)]).astype(np.int8))]
        out.append((f"read{i}", seq, qual, None, tags))
    span = REF[4:24]
    seq = span[:3] + "G" + span[4:8] + "AA" + span[8:14] + span[16:]
    out.append(("sub-ins-del", seq, "I" * len(seq), Mapping(
        ctg="chr1", r_st=4, r_en=24, q_st=0, q_en=len(seq), mapq=50,
        strand=1, cigar_str="8M2I6M2D4M", NM=5, MD="", ref_seq=span),
        ["RG:Z:run0_model"]))
    span = REF[30:70]
    out.append(("exact", span, "5" * len(span), Mapping(
        ctg="chr1", r_st=30, r_en=70, q_st=0, q_en=40, mapq=60, strand=1,
        cigar_str="40M", NM=0, MD="40", ref_seq=span), []))
    span = REF[60:96]
    read = span.translate(COMP)[::-1]
    read = read[:5] + ("A" if read[5] != "A" else "C") + read[6:]
    out.append(("reverse", "TT" + read, "+" * (len(read) + 2), Mapping(
        ctg="chr1", r_st=60, r_en=96, q_st=2, q_en=len(read) + 2, mapq=40,
        strand=-1, cigar_str=f"{len(read)}M", NM=1, MD="", ref_seq=span),
        ["qs:i:12"]))
    return out


def write(module, recs, **kw):
    buf = io.BytesIO()
    w = module.CramWriter(buf, HDR, [("chr1", len(REF))], **kw)
    for name, seq, qual, mapping, tags in recs:
        w.write(name, seq, qual, mapping=mapping, tags=tags)
    w.close()
    return buf.getvalue()


def fields(recs):
    return [(r.name, r.seq, r.qual, r.flag, r.ref_id, r.pos, r.mapq,
             list(r.cigar), list(r.tags)) for r in recs]


MODES = {"referenceless": {}, "reference-based": {"reference_based": True},
         "rans0": {"codec": "rans0"},
         "rans1-reference-based": {"codec": "rans1",
                                   "reference_based": True},
         "small-containers": {"records_per_container": 3}}


@pytest.mark.parametrize("mode", list(MODES))
def test_cram_writer_bytes_equal_bonito_tpus(mode):
    kw = MODES[mode]
    recs = records(np.random.default_rng(7))
    assert write(cram, recs, **kw) == write(jcram, recs, **kw)


@pytest.mark.parametrize("mode", list(MODES))
def test_each_reader_reads_the_others_file(mode):
    kw = MODES[mode]
    recs = records(np.random.default_rng(8))
    ref = {"reference": {"chr1": REF}} if kw.get("reference_based") else {}
    port, jax = write(cram, recs, **kw), write(jcram, recs, **kw)
    want = fields(jcram.CramReader(jax, **ref))
    assert fields(cram.CramReader(jax, **ref)) == want
    assert fields(jcram.CramReader(port, **ref)) == want
    assert [r[:3] for r in want] == [
        (n, s if m is None or m.strand == 1 else s.translate(COMP)[::-1],
         q if m is None or m.strand == 1 else q[::-1])
        for n, s, q, m, _ in recs]


def test_reference_based_cram_needs_the_fasta(tmp_path):
    recs = records(np.random.default_rng(9))
    data = write(cram, recs, reference_based=True)
    with pytest.raises(ValueError, match="reference-based CRAM"):
        list(cram.CramReader(data))
    fasta = tmp_path / "ref.fasta"
    fasta.write_text(f">chr1\n{REF}\n")
    assert (fields(cram.CramReader(data, reference=str(fasta)))
            == fields(jcram.CramReader(data, reference={"chr1": REF})))


class Read:
    def __init__(self, read_id, n):
        self.read_id = read_id
        self.signal = np.zeros(n, np.int16)
        self.run_id = "run0"


@pytest.mark.parametrize("aligned", [False, True], ids=["unaligned",
                                                        "aligned"])
def test_io_writer_writes_bonito_tpus_cram(aligned, tmp_path):
    """``io.Writer`` in mode ``wc``: referenceless without an aligner,
    reference-based with one (the mappings carry the reference span), and
    the records and header bonito_tpu's Writer writes."""
    recs = records(np.random.default_rng(10))
    items = [(Read(name, 6 * len(seq)),
              {"sequence": seq, "qstring": qual, "mean_qscore": 20.0,
               "mapping": mapping if aligned else None})
             for name, seq, qual, mapping, _ in recs]
    aligner = None
    if aligned:
        class Aligner:
            def seq_names_lengths(self):
                return [("chr1", len(REF))]
        aligner = Aligner()
    out = {}
    for name, module in (("port", tio), ("jax", jio)):
        (tmp_path / name).mkdir()
        fd = io.BytesIO()
        w = module.Writer("wc", iter(items), aligner=aligner, fd=fd,
                          output_dir=tmp_path / name)
        w.start()
        w.stop()
        out[name] = fd.getvalue()
    ref = {"reference": {"chr1": REF}} if aligned else {}
    port = jcram.CramReader(out["port"], **ref)
    jax = jcram.CramReader(out["jax"], **ref)
    assert fields(port) == fields(jax)
    keep = lambda text: [line for line in text.splitlines()
                         if not line.startswith("@PG")]
    assert keep(port.header_text) == keep(jax.header_text)
    assert len(fields(jcram.CramReader(out["port"], **ref))) == len(recs)
