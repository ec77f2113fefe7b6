"""
BAM emission, bonito_tpu's (``bonito_tpu/bam.py``) copied: BGZF blocks
(stdlib zlib, the canonical EOF block) and binary BAM records, the subset
of the BAM spec (SAMv1.pdf §4) the basecaller writes: a header with the
reference dictionary, records with cigar, seq, qual and Z/i/f/A/B-array
tags. No pysam or htslib.
"""

import re
import struct
import zlib
from collections import deque
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_BGZF_MAX = 65280  # uncompressed payload per block (htslib convention)

_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")

_NT16 = {c: i for i, c in enumerate("=ACMGRSVTWYHKDBN")}
_NT16_LUT = np.full(256, 15, dtype=np.uint8)
for _c, _i in _NT16.items():
    _NT16_LUT[ord(_c)] = _i
    _NT16_LUT[ord(_c.lower())] = _i
_CIGAR_OPS = {op: i for i, op in enumerate("MIDNSHP=X")}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")
from bonito_tpu_torch.util import _COMP as _REVCOMP  # noqa: E402 — shared IUPAC table


def _reg2bin(beg, end):
    """SAM spec distance-binning function."""
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def _deflate_block(payload, level):
    """One BGZF member for an immutable <=64k payload."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    bsize = len(comp) + 25 + 1  # fixed header(12) + extra(6) + footer(8)
    return (
        b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
        struct.pack("<HBBHH", 6, 66, 67, 2, bsize - 1) +
        comp + struct.pack("<II", crc, len(payload))
    )


class BGZFWriter:
    """Blocked-gzip writer with the BC extra-field and EOF marker.

    Blocks deflate (level 6) on a pool of two threads (zlib releases the
    GIL) while the caller keeps encoding records, the overlap htslib gets
    from bgzf_mt; block order is kept by draining the futures in the order
    they were submitted.
    """

    LEVEL, THREADS = 6, 2

    def __init__(self, fd):
        self.fd = fd
        self.buf = bytearray()
        self._pool = ThreadPoolExecutor(self.THREADS)
        self._pending = deque()

    def write(self, data):
        self.buf += data
        while len(self.buf) >= _BGZF_MAX:
            self._emit_block(bytes(self.buf[:_BGZF_MAX]))
            del self.buf[:_BGZF_MAX]

    def _emit_block(self, payload):
        self._pending.append(
            self._pool.submit(_deflate_block, payload, self.LEVEL))
        while len(self._pending) > 4 * self.THREADS:
            self.fd.write(self._pending.popleft().result())

    def close(self):
        if self.buf:
            self._emit_block(bytes(self.buf))
            self.buf = bytearray()
        while self._pending:
            self.fd.write(self._pending.popleft().result())
        self._pool.shutdown()
        self.fd.write(_EOF)
        self.fd.flush()


def _encode_seq(seq):
    codes = _NT16_LUT[np.frombuffer(seq.encode(), dtype=np.uint8)]
    if codes.size % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


_B_DTYPES = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2",
             "i": "<i4", "I": "<u4", "f": "<f4"}


def encode_array_tag(name, sub, values):
    """Binary BAM B-array tag straight from an array (no text round-trip)."""
    data = np.ascontiguousarray(values, dtype=np.dtype(_B_DTYPES[sub]))
    return (name.encode()[:2] + b"B" + sub.encode()
            + struct.pack("<i", data.size) + data.tobytes())


class ArrayTag:
    """A B-array SAM tag held as an array; renders to SAM text on str()
    and straight to BAM binary via bam_bytes() (skipping the per-element
    text round-trip, which dominates the writer for long mv: tags)."""

    __slots__ = ("name", "sub", "values")

    def __init__(self, name, sub, values):
        self.name = name
        self.sub = sub
        self.values = np.asarray(values, dtype=np.dtype(_B_DTYPES[sub]))

    def bam_bytes(self):
        return encode_array_tag(self.name, self.sub, self.values)

    def __str__(self):
        vals = self.values
        if (self.sub != "f" and vals.size
                and 0 <= vals.min() and vals.max() <= 9):
            body = np.empty(2 * vals.size, dtype=np.uint8)
            body[0::2] = ord(",")
            body[1::2] = vals.astype(np.uint8) + ord("0")
            return f"{self.name}:B:{self.sub}{body.tobytes().decode()}"
        return f"{self.name}:B:{self.sub}," + ",".join(
            str(v) for v in vals.tolist())


def _encode_tag(tag_str):
    """'xx:T:value' SAM text tag (or ArrayTag) -> binary BAM tag bytes."""
    if isinstance(tag_str, ArrayTag):
        return tag_str.bam_bytes()
    tag, typ, val = tag_str.split(":", 2)
    name = tag.encode()[:2]
    if typ == "i":
        return name + b"i" + struct.pack("<i", int(val))
    if typ == "f":
        return name + b"f" + struct.pack("<f", float(val))
    if typ == "A":
        return name + b"A" + val.encode()[:1]
    if typ == "Z":
        return name + b"Z" + val.encode() + b"\x00"
    if typ == "B":
        sub, *items = val.split(",")
        fmt = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}[sub]
        conv = float if sub == "f" else int
        data = struct.pack(f"<{len(items)}{fmt}", *[conv(x) for x in items])
        return name + b"B" + sub.encode() + struct.pack("<i", len(items)) + data
    raise ValueError(f"unsupported tag type {typ}")


def _encode_cigar(cigar_str):
    ops = _CIGAR_RE.findall(cigar_str)
    return b"".join(
        struct.pack("<I", (int(n) << 4) | _CIGAR_OPS[op]) for n, op in ops)


class BAMWriter:
    """Minimal BAM writer: header once, then per-read records."""

    def __init__(self, fd, header_text, refs):
        """refs: [(name, length)] reference dictionary (empty if unaligned)."""
        self.bgzf = BGZFWriter(fd)
        self.ref_ids = {name: i for i, (name, _) in enumerate(refs)}
        text = header_text.encode()
        head = b"BAM\x01" + struct.pack("<i", len(text)) + text
        head += struct.pack("<i", len(refs))
        for name, length in refs:
            nb = name.encode() + b"\x00"
            head += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        self.bgzf.write(head)

    def write(self, read_id, seq, qstring, mapping=None, tags=None):
        name = read_id.encode() + b"\x00"
        if mapping is not None and mapping.strand == -1:
            seq = seq.translate(_REVCOMP)[::-1]
            qstring = qstring[::-1]
        l_seq = len(seq)
        if qstring and qstring != "*":
            if len(qstring) != l_seq:
                # a mismatch here writes a structurally corrupt record
                # that only fails when the BAM is READ — fail loudly now
                raise ValueError(
                    f"seq/qual length mismatch in read {read_id}: "
                    f"{l_seq} bases vs {len(qstring)} quals")
            q = np.frombuffer(qstring.encode(), dtype=np.uint8)
            if q.size and q.min() < 33:
                # fail loudly instead of wrapping below phred+33
                raise ValueError(f"qstring char below '!' in read {read_id}")
            qual = (q - 33).tobytes()
        else:
            qual = b"\xff" * l_seq

        if mapping is None:
            ref_id, pos, mapq, flag = -1, -1, 0, 4
            cigar = b""
            bin_ = _reg2bin(-1, 0)
        else:
            ref_id = self.ref_ids[mapping.ctg]
            pos = mapping.r_st
            mapq = mapping.mapq
            flag = 16 if mapping.strand == -1 else 0
            clip_l, clip_r = mapping.q_st, l_seq - mapping.q_en
            if mapping.strand == -1:
                clip_l, clip_r = clip_r, clip_l
            cig = (f"{clip_l}S" if clip_l else "") + mapping.cigar_str + (
                f"{clip_r}S" if clip_r else "")
            cigar = _encode_cigar(cig)
            bin_ = _reg2bin(pos, mapping.r_en)
            tags = list(tags or [])
            if getattr(mapping, "NM", None) is not None:
                tags.append(f"NM:i:{mapping.NM}")
            if getattr(mapping, "MD", None):
                tags.append(f"MD:Z:{mapping.MD}")

        tag_bytes = b"".join(_encode_tag(t) for t in (tags or []))
        rec = struct.pack(
            "<iiBBHHHiiii",
            ref_id, pos, len(name), mapq, bin_, len(cigar) // 4, flag,
            l_seq, -1, -1, 0,
        ) + name + cigar + _encode_seq(seq) + qual + tag_bytes
        self.bgzf.write(struct.pack("<i", len(rec)) + rec)

    def close(self):
        self.bgzf.close()
