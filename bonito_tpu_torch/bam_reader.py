"""
BAM, SAM and CRAM reading, the input side of ``duplex``: a copy of
bonito_tpu's ``bam_reader.py`` for the port (upstream bonito reads with
pysam through an offset index).

BGZF is a chain of gzip members, so the whole stream decompresses with
gzip; records are then parsed from the BAM byte layout. SAM text files
are parsed line by line; CRAM goes through ``cram.CramReader``.
"""

import gzip
import struct
from pathlib import Path

import numpy as np

from bonito_tpu_torch.duplex import SeqRecord

_SEQ_LUT = "=ACMGRSVTWYHKDBN"
# nibble code -> base ascii, for vectorised unpacking
_SEQ_BYTES = np.frombuffer(_SEQ_LUT.encode(), dtype=np.uint8)


def _decode_seq(seq_bytes, l_seq):
    """Packed-nibble BAM sequence bytes -> string (vectorised)."""
    packed = np.frombuffer(seq_bytes, dtype=np.uint8)
    codes = np.empty(2 * packed.size, dtype=np.uint8)
    codes[0::2] = packed >> 4
    codes[1::2] = packed & 0xF
    return _SEQ_BYTES[codes[:l_seq]].tobytes().decode()


def _parse_bam_records(data):
    """Yield SeqRecord from decompressed BAM bytes."""
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    l_text = struct.unpack("<i", data[4:8])[0]
    off = 8 + l_text
    n_ref = struct.unpack("<i", data[off:off + 4])[0]
    off += 4
    for _ in range(n_ref):
        l_name = struct.unpack("<i", data[off:off + 4])[0]
        off += 4 + l_name + 4
    while off + 4 <= len(data):
        block_size = struct.unpack("<i", data[off:off + 4])[0]
        rec = data[off + 4:off + 4 + block_size]
        off += 4 + block_size
        if len(rec) < 32:
            break
        (ref_id, pos, l_read_name, mapq, bin_, n_cigar, flag,
         l_seq, next_ref, next_pos, tlen) = struct.unpack("<iiBBHHHiiii",
                                                          rec[:32])
        # skip secondary/supplementary BEFORE decoding: the nibble
        # unpack + qstring build are the expensive part of each record
        if flag & 0x900:
            continue
        p = 32
        name = rec[p:p + l_read_name - 1].decode()
        p += l_read_name
        p += 4 * n_cigar
        nseq = (l_seq + 1) // 2
        seq_bytes = rec[p:p + nseq]
        p += nseq
        qual = rec[p:p + l_seq]
        p += l_seq

        seq = _decode_seq(seq_bytes, l_seq)
        if qual and qual[0] != 0xFF:
            qstring = (np.frombuffer(qual, dtype=np.uint8) + 33).tobytes().decode()
        else:
            qstring = "*"
        yield SeqRecord(name, seq, qstring), flag


def _parse_cram_records(data):
    from bonito_tpu_torch.cram import CramReader
    try:
        records = list(CramReader(data))
    except ValueError as e:
        if "reference-based" in str(e):
            raise ValueError(
                "this CRAM is reference-based (written with --reference) "
                "and duplex's read index cannot decode it without the "
                "same fasta — re-basecall to BAM (the recommended duplex "
                "input) or write referenceless CRAM (no --reference)"
            ) from e
        raise
    for rec in records:
        if rec.flag & 0x900:
            continue
        yield SeqRecord(rec.name, rec.seq, rec.qual or "*"), rec.flag


def _parse_sam_records(text):
    for line in text.splitlines():
        if not line or line.startswith("@"):
            continue
        fields = line.split("\t")
        if len(fields) < 11:
            continue
        flag = int(fields[1])
        if flag & 0x900:
            continue
        yield SeqRecord(fields[0], fields[9], fields[10]), flag


class ReadIndexedBam:
    """read_id -> SeqRecord lookup over a BAM, SAM or CRAM file
    (the role of upstream bonito's ReadIndexedBam in its cli/duplex.py)."""

    def __init__(self, path):
        self.path = Path(path)
        data = self.path.read_bytes()
        if data[:2] == b"\x1f\x8b":
            # gzip/BGZF wraps BAM *or* plain SAM text — re-dispatch on
            # the decompressed payload
            data = gzip.decompress(data)
        if data[:4] == b"BAM\x01":
            records = _parse_bam_records(data)
        elif data[:4] == b"CRAM":
            records = _parse_cram_records(data)
        else:
            records = _parse_sam_records(data.decode())
        self._records = {}
        for rec, flag in records:
            # reverse-strand records store the revcomp; restore read
            # orientation for consensus
            if flag & 0x10:
                from bonito_tpu_torch.util import revcomp
                rec = SeqRecord(
                    rec.read_id,
                    revcomp(rec.sequence),
                    rec.qstring[::-1] if rec.qstring != "*" else "*")
            self._records.setdefault(rec.read_id, rec)

    def __len__(self):
        return len(self._records)

    def __contains__(self, read_id):
        return read_id in self._records

    @property
    def read_ids(self):
        return list(self._records)

    def get_record(self, read_id):
        try:
            return self._records[read_id]
        except KeyError:
            raise KeyError(f"read {read_id!r} not in {self.path}") from None
