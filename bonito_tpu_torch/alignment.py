"""
The host alignments of ``native/align/align.cpp``, built by
``native.load``: ``smith_waterman``, the local affine-gap alignment of the
accuracy metric (parasail's role in upstream bonito), and ``edit_align``,
the global unit-cost alignment of the duplex consensus (edlib's role) —
bonito_tpu's ``alignment`` without its numpy fallbacks: a failed build
raises.
"""

import ctypes
import re
from dataclasses import dataclass

from bonito_tpu_torch import native

MAX_CIGAR = 1 << 16
MAX_CELLS = 1 << 28  # DP cells; the native code keeps three int32 matrices


@dataclass
class SWResult:
    score: int
    cigar: str            # run-length cigar over ops =/X/I/D (query-relative)
    beg_query: int        # 0-based start of alignment in query
    end_query: int        # exclusive end in query
    beg_ref: int
    end_ref: int

    @property
    def ref_aligned_length(self):
        """Number of alignment columns (match + mismatch + ins + del)."""
        return sum(int(n) for n, _ in re.findall(r"(\d+)(\D)", self.cigar))


def smith_waterman(query, ref, match=5, mismatch=-4, gap_open=8, gap_extend=4):
    """Local alignment of ``query`` against ``ref``: an SWResult, or None
    when the cigar overflows or the DP matrix would exceed MAX_CELLS."""
    lib = native.load("align")
    q, r = query.encode(), ref.encode()
    score = ctypes.c_int32()
    bq, eq, br, er = (ctypes.c_int32() for _ in range(4))
    ops = ctypes.create_string_buffer(MAX_CIGAR)
    lens = (ctypes.c_int32 * MAX_CIGAR)()
    n = lib.sw_align(
        q, len(q), r, len(r), match, mismatch, gap_open, gap_extend,
        MAX_CELLS, ctypes.byref(score),
        ctypes.byref(bq), ctypes.byref(eq), ctypes.byref(br),
        ctypes.byref(er), ops, lens, MAX_CIGAR)
    if n < 0:
        return None
    cigar = "".join(f"{lens[i]}{chr(ops.raw[i])}" for i in range(n))
    return SWResult(score.value, cigar, bq.value, eq.value, br.value, er.value)


def edit_align(query, ref):
    """Global edit-distance alignment of ``query`` against ``ref``:
    (distance, cigar over =/X/I/D), or None when the cigar overflows or
    the DP matrix would exceed MAX_CELLS."""
    lib = native.load("align")
    q, r = query.encode(), ref.encode()
    dist = ctypes.c_int32()
    ops = ctypes.create_string_buffer(MAX_CIGAR)
    lens = (ctypes.c_int32 * MAX_CIGAR)()
    n = lib.nw_align(q, len(q), r, len(r), MAX_CELLS, ctypes.byref(dist),
                     ops, lens, MAX_CIGAR)
    if n < 0:
        return None
    return dist.value, "".join(f"{lens[i]}{chr(ops.raw[i])}"
                               for i in range(n))
