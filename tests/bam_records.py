"""A BAM file's records, parsed with gzip and struct, for the tests that
hold the port's BAM output against another's (without pysam)."""

import gzip
import struct

import numpy as np

EOF_BLOCK = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def parse_bam(data):
    """(header text, refs, records) of a BAM file's bytes; each record is
    its fixed fields, name, cigar, seq, its qualities (as phred+33 text)
    and its tag bytes."""
    assert data.endswith(EOF_BLOCK)
    raw = gzip.decompress(data)
    assert raw[:4] == b"BAM\x01"
    (l_text,) = struct.unpack_from("<i", raw, 4)
    text = raw[8:8 + l_text].decode()
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", raw, pos)
    pos += 4
    refs = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", raw, pos)
        name = raw[pos + 4:pos + 4 + l_name - 1].decode()
        refs.append((name, struct.unpack_from("<i", raw, pos + 4 + l_name)[0]))
        pos += 8 + l_name
    records = []
    while pos < len(raw):
        (size,) = struct.unpack_from("<i", raw, pos)
        rec = raw[pos + 4:pos + 4 + size]
        pos += 4 + size
        (ref_id, p, l_name, mapq, bin_, n_cigar, flag, l_seq, *_) = \
            struct.unpack_from("<iiBBHHHiiii", rec)
        o = 32
        name = rec[o:o + l_name - 1].decode()
        o += l_name
        cigar = rec[o:o + 4 * n_cigar]
        o += 4 * n_cigar
        seq = rec[o:o + (l_seq + 1) // 2]
        o += (l_seq + 1) // 2
        qual = (np.frombuffer(rec[o:o + l_seq], np.uint8) + 33).tobytes()
        o += l_seq
        records.append(((ref_id, p, mapq, bin_, flag, l_seq), name, cigar,
                        seq, qual.decode(), rec[o:]))
    return text, refs, records


_B_TYPES = {"c": "<i1", "C": "<u1", "s": "<i2", "S": "<u2", "i": "<i4",
            "I": "<u4", "f": "<f4"}


def parse_tags(data):
    """{tag: value} of a record's tag bytes (B arrays as numpy arrays)."""
    tags, o = {}, 0
    while o < len(data):
        tag, typ = data[o:o + 2].decode(), chr(data[o + 2])
        o += 3
        if typ == "Z":
            end = data.index(b"\0", o)
            tags[tag] = data[o:end].decode()
            o = end + 1
        elif typ == "A":
            tags[tag] = chr(data[o])
            o += 1
        elif typ == "B":
            dt = np.dtype(_B_TYPES[chr(data[o])])
            (n,) = struct.unpack_from("<i", data, o + 1)
            tags[tag] = np.frombuffer(data, dt, n, o + 5)
            o += 5 + n * dt.itemsize
        else:
            dt = np.dtype(_B_TYPES[typ])
            tags[tag] = np.frombuffer(data, dt, 1, o)[0].item()
            o += dt.itemsize
    return tags
