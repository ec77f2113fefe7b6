"""
The basecaller's ``--reference`` stage, bonito_tpu's
(``bonito_tpu/aligner.py``) copied: an Aligner indexes a FASTA once, worker
threads map each basecalled read and attach the mapping to its result, in
upstream bonito's role for mappy (bonito/aligner.py:11-56). The mapper is
the repository's minimiser-chaining one (``native/mapper/mapper.cpp``,
built with g++ at first use; a failed build raises).
"""

import ctypes
import gzip
import sys
import threading
from dataclasses import dataclass, field

from bonito_tpu_torch import native
from bonito_tpu_torch.pipeline import thread_map
from bonito_tpu_torch.util import parasail_style_cigar_counts

_CIGAR_CAP = 1 << 20
_MD_CAP = 1 << 20
# each mapping thread's cigar and MD buffers, reused from read to read
_map_buffers = threading.local()


@dataclass
class Mapping:
    """mappy.Alignment-compatible record."""
    ctg: str
    r_st: int
    r_en: int
    q_st: int
    q_en: int
    strand: int          # +1 / -1
    mapq: int
    cigar_str: str       # =/X/I/D run-length (no softclips)
    NM: int
    MD: str
    ref_seq: str = ""    # aligned reference span (for --save-ctc)
    cigar_counts: dict = field(default_factory=dict)

    def __post_init__(self):
        if not self.cigar_counts:
            self.cigar_counts = dict(
                parasail_style_cigar_counts(self.cigar_str))


def read_fasta(path):
    """[(name, sequence)] from a (optionally gzipped) FASTA file."""
    opener = gzip.open if str(path).endswith(".gz") else open
    seqs, name, parts = [], None, []
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    seqs.append((name, "".join(parts)))
                parts_name = line[1:].split()
                if not parts_name:
                    raise ValueError(
                        f"malformed FASTA: header line with no name "
                        f"({path})")
                name = parts_name[0]
                parts = []
            else:
                parts.append(line)
    if name is not None:
        seqs.append((name, "".join(parts)))
    return seqs


class Aligner:
    """Minimizer-index aligner over a FASTA reference."""

    def __init__(self, reference, preset="lr:hq", k=15, w=10):
        if str(reference).endswith(".mmi"):
            raise ValueError(
                "prebuilt .mmi indexes are not supported; pass the FASTA")
        self.lib = native.load("mapper")
        self.preset = preset
        if preset not in (None, "lr:hq"):
            # the in-tree mapper has one (lr:hq-style) parameterisation;
            # accepting other presets silently would let users believe
            # they changed mapping behaviour
            sys.stderr.write(
                f"> warning: mm2 preset {preset!r} has no effect — the "
                f"in-tree mapper always uses its lr:hq-style parameters "
                f"(k={k}, w={w})\n")
        contigs = read_fasta(reference)
        if not contigs:
            raise ValueError(f"no sequences in {reference}")
        self.names = [n for n, _ in contigs]
        self.seqs = {n: s.upper() for n, s in contigs}
        # contigs are joined with an N-gap: minimizers() resets its
        # window on non-ACGT, so no k-mer (and no anchor) can span a
        # contig junction; the chain DP additionally refuses to link
        # anchors across contigs (mapper.cpp)
        GAP = 32
        starts, off = [], 0
        for _, s in contigs:
            starts.append(off)
            off += len(s) + GAP
        concat = ("N" * GAP).join(s for _, s in contigs).encode()
        starts_arr = (ctypes.c_int64 * len(starts))(*starts)
        self.handle = self.lib.mapper_index_build(
            concat, len(concat), starts_arr, len(starts), k, w)

    @property
    def seq_names(self):
        return list(self.names)

    def seq(self, name):
        return self.seqs[name]

    def seq_names_lengths(self):
        return [(n, len(self.seqs[n])) for n in self.names]

    def map(self, seq, MD=True):
        """Best mapping for ``seq`` or None (first-hit-only, as the
        reference uses: bonito/aligner.py:54-55)."""
        if not seq:
            return None
        q = seq.encode()
        ctg_id = ctypes.c_int32()
        r_st, r_en = ctypes.c_int64(), ctypes.c_int64()
        q_st, q_en = ctypes.c_int32(), ctypes.c_int32()
        strand, mapq = ctypes.c_int32(), ctypes.c_int32()
        nm, score = ctypes.c_int32(), ctypes.c_int32()
        # the 1 MB cigar/MD out-buffers are reused per mapping thread:
        # ctypes zero-fills on creation, ~2 MB of memset per read at
        # high read rates otherwise
        tl = _map_buffers
        if not hasattr(tl, "cigar"):
            tl.cigar = ctypes.create_string_buffer(_CIGAR_CAP)
            tl.md = ctypes.create_string_buffer(_MD_CAP)
        cigar, md = tl.cigar, tl.md
        while True:
            hit = self.lib.mapper_map(
                self.handle, q, len(q),
                ctypes.byref(ctg_id), ctypes.byref(r_st), ctypes.byref(r_en),
                ctypes.byref(q_st), ctypes.byref(q_en), ctypes.byref(strand),
                ctypes.byref(mapq), ctypes.byref(nm), ctypes.byref(score),
                cigar, len(cigar), md, len(md))
            if hit != -1:
                break
            # mapped, but the cigar/MD outgrew this thread's buffers
            # (multi-Mb ultralong reads): grow and retry rather than
            # silently reporting the read unmapped
            if len(cigar) >= (64 << 20):
                raise RuntimeError(
                    f"mapper cigar/MD exceeded 64 MB for a "
                    f"{len(seq)}-base read")
            tl.cigar = ctypes.create_string_buffer(2 * len(cigar))
            tl.md = ctypes.create_string_buffer(2 * len(md))
            cigar, md = tl.cigar, tl.md
        if not hit:
            return None
        name = self.names[ctg_id.value]
        return Mapping(
            ctg=name, r_st=r_st.value, r_en=r_en.value,
            q_st=q_st.value, q_en=q_en.value, strand=strand.value,
            mapq=mapq.value, cigar_str=cigar.value.decode(),
            NM=nm.value, MD=md.value.decode() if MD else "",
            ref_seq=self.seqs[name][r_st.value:r_en.value],
        )

    def __del__(self):
        if getattr(self, "handle", None) and getattr(self, "lib", None):
            self.lib.mapper_index_free(self.handle)
            self.handle = None


def _attach_mapping(aligner):
    def fn(item):
        read, res = item
        res = dict(res)
        res["mapping"] = aligner.map(res.get("sequence", ""))
        return read, res
    return fn


def align_map(aligner, results, n_thread=4):
    """Alignment stage: maps each (read, result) through worker threads
    (reference shape: bonito/aligner.py:11-15)."""
    fn = _attach_mapping(aligner)
    return (
        v for _, v in thread_map(
            fn, ((i, item) for i, item in enumerate(results)),
            n_thread=n_thread)
    )
