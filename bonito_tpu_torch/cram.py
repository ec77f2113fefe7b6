"""
CRAM 3.0 codec (writer and reader), a copy of bonito_tpu's ``cram.py`` for
the port, written against the public CRAM 3.0 specification (hts-specs
CRAMv3.pdf). Upstream bonito emits CRAM through pysam and htslib; the
port, like ``bam.py`` and ``pod5.py``, carries the container format itself.
Its bytes equal bonito_tpu's on the same records, and each package's
``CramReader`` reads the other's files.

Two encoding modes, as htslib behaves with and without a fasta:

- *reference-based* (``reference_based=True``, preservation ``RR=true``):
  match stretches are implicit against the reference and mismatches
  encode as 'X' substitution-matrix codes (smaller files); decoding needs
  the same fasta (``CramReader(..., reference=...)``). ``io.Writer``
  picks this mode whenever an aligner is present.
- *referenceless* (default, ``RR=false``), htslib's mode when no
  reference is supplied: read bases are carried verbatim in read features
  ('b' stretches, soft clips, inserts), so no fasta is needed to decode.

Aligned records keep ref name/pos/MAPQ/CIGAR (M/=/X stretches decode as
M, as in htslib); tags round-trip via the tag dictionary and per-tag
external blocks. Blocks are gzip-compressed, or rANS where the writer
asks (``rans.py``, the native codec); containers and blocks carry their
CRC32s; the file ends with the spec's canonical 38-byte v3 EOF container,
which the writer's own primitives reproduce bit for bit.

The reader decodes everything this writer emits (EXTERNAL,
BYTE_ARRAY_LEN, BYTE_ARRAY_STOP codecs), the role the BAM reader plays
for BAM.
"""

import struct
import zlib

from bonito_tpu_torch.bam import _encode_tag

MAGIC = b"CRAM\x03\x00"

# block content types
CT_FILE_HEADER = 0
CT_COMPRESSION_HEADER = 1
CT_SLICE_HEADER = 2
CT_EXTERNAL = 4
CT_CORE = 5

# block compression methods (CRAM 3.0 spec §8; 3.1 adds 5..8 which this
# reader names in its error message rather than decoding)
M_RAW, M_GZIP, M_BZIP2, M_LZMA, M_RANS = 0, 1, 2, 3, 4
_METHOD_NAMES_31 = {5: "rANS4x16 (CRAM 3.1)", 6: "adaptive arithmetic "
                    "(CRAM 3.1)", 7: "fqzcomp (CRAM 3.1)",
                    8: "name tokeniser (CRAM 3.1)"}

# CF record flags
CF_QS_STORED = 0x1
CF_DETACHED = 0x2
CF_MATE_DOWNSTREAM = 0x4
CF_NO_SEQ = 0x8

# the canonical CRAM v3 EOF container (spec §9; htslib writes these exact
# bytes and uses them to detect clean EOF)
EOF_CONTAINER = bytes.fromhex(
    "0f000000ffffffff0fe045"
    "4f4600000000010005bdd94f0001000606010001000100ee63014b")


# ---------------------------------------------------------------------------
# ITF8 / LTF8 variable-length integers
# ---------------------------------------------------------------------------

def itf8_encode(value):
    v = value & 0xFFFFFFFF
    if v < 0x80:
        return bytes([v])
    if v < 0x4000:
        return bytes([0x80 | (v >> 8), v & 0xFF])
    if v < 0x200000:
        return bytes([0xC0 | (v >> 16), (v >> 8) & 0xFF, v & 0xFF])
    if v < 0x10000000:
        return bytes([0xE0 | (v >> 24), (v >> 16) & 0xFF,
                      (v >> 8) & 0xFF, v & 0xFF])
    # 5-byte form: 4 bits in byte0, 8+8+8 in the middle, low 4 bits in byte4
    return bytes([0xF0 | ((v >> 28) & 0x0F), (v >> 20) & 0xFF,
                  (v >> 12) & 0xFF, (v >> 4) & 0xFF, v & 0x0F])


def itf8_decode(buf, pos):
    b0 = buf[pos]
    if b0 < 0x80:
        v, n = b0, 1
    elif b0 < 0xC0:
        v, n = ((b0 & 0x3F) << 8) | buf[pos + 1], 2
    elif b0 < 0xE0:
        v = ((b0 & 0x1F) << 16) | (buf[pos + 1] << 8) | buf[pos + 2]
        n = 3
    elif b0 < 0xF0:
        v = ((b0 & 0x0F) << 24) | (buf[pos + 1] << 16) \
            | (buf[pos + 2] << 8) | buf[pos + 3]
        n = 4
    else:
        v = ((b0 & 0x0F) << 28) | (buf[pos + 1] << 20) \
            | (buf[pos + 2] << 12) | (buf[pos + 3] << 4) \
            | (buf[pos + 4] & 0x0F)
        n = 5
    if v >= 0x80000000:
        v -= 0x100000000
    return v, pos + n


def ltf8_encode(value):
    v = value & 0xFFFFFFFFFFFFFFFF
    for nbytes in range(9):
        if v < (1 << (7 * (nbytes + 1) + nbytes)) and nbytes < 8:
            # nbytes trailing bytes; byte0 has nbytes leading ones
            prefix = (0xFF << (8 - nbytes)) & 0xFF
            shift = 8 * nbytes
            if (v >> shift) < (1 << (7 - nbytes)):
                out = [prefix | (v >> shift)]
                for i in range(nbytes - 1, -1, -1):
                    out.append((v >> (8 * i)) & 0xFF)
                return bytes(out)
    out = [0xFF]
    for i in range(7, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)
    return bytes(out)


def ltf8_decode(buf, pos):
    b0 = buf[pos]
    nbytes = 0
    mask = 0x80
    while nbytes < 8 and (b0 & mask):
        nbytes += 1
        mask >>= 1
    if nbytes < 8:
        v = b0 & ((1 << (7 - nbytes)) - 1)
    else:
        v = 0
    for i in range(nbytes):
        v = (v << 8) | buf[pos + 1 + i]
    if v >= 0x8000000000000000:
        v -= 0x10000000000000000
    return v, pos + 1 + nbytes


# ---------------------------------------------------------------------------
# blocks and containers
# ---------------------------------------------------------------------------

def build_block(content_type, content_id, raw, method=None):
    # an int method means raw-passthrough and is valid ONLY for M_RAW:
    # any other int would label uncompressed bytes with a codec id and
    # write a structurally corrupt block
    if method is not None and method not in ("rans0", "rans1", M_RAW):
        raise ValueError(
            f"unknown CRAM block codec {method!r} (None=gzip, M_RAW, "
            f"'rans0', 'rans1')")
    if method in ("rans0", "rans1"):
        # opt-in htslib-default codec (spec method 4); gzip stays this
        # writer's default — zlib's C deflate outruns the rANS paths on
        # a CPU and every CRAM 3.0 reader must accept either
        from bonito_tpu_torch import rans
        comp = rans.compress_auto(raw, order=int(method[-1]))
        method = M_RANS
        if len(comp) >= len(raw):
            comp, method = raw, M_RAW
    elif method is None:
        comp = zlib.compress(raw, 6)
        # gzip framing (htslib expects real gzip members, not raw deflate)
        comp = (b"\x1f\x8b\x08\x00\x00\x00\x00\x00\x00\xff"
                + comp[2:-4]
                + struct.pack("<II", zlib.crc32(raw), len(raw) & 0xFFFFFFFF))
        method = M_GZIP
        if len(comp) >= len(raw):
            comp, method = raw, M_RAW
    else:
        comp = raw
    body = (bytes([method, content_type]) + itf8_encode(content_id)
            + itf8_encode(len(comp)) + itf8_encode(len(raw)) + comp)
    return body + struct.pack("<I", zlib.crc32(body))


def parse_block(buf, pos):
    method, ctype = buf[pos], buf[pos + 1]
    cid, p = itf8_decode(buf, pos + 2)
    csize, p = itf8_decode(buf, p)
    rsize, p = itf8_decode(buf, p)
    data = bytes(buf[p:p + csize])
    p += csize
    crc = struct.unpack("<I", buf[p:p + 4])[0]
    if zlib.crc32(buf[pos:p]) != crc:
        raise ValueError("CRAM block CRC mismatch")
    p += 4
    if method == M_GZIP:
        data = zlib.decompress(data, wbits=31)
    elif method == M_BZIP2:
        import bz2
        data = bz2.decompress(data)
    elif method == M_LZMA:
        import lzma
        data = lzma.decompress(data)
    elif method == M_RANS:
        from bonito_tpu_torch import rans
        data = rans.uncompress_auto(data, rsize)
    elif method != M_RAW:
        name = _METHOD_NAMES_31.get(method, f"method {method}")
        raise ValueError(
            f"unsupported CRAM block compression: {name}. This reader "
            f"decodes CRAM 3.0 (raw/gzip/bzip2/lzma/rANS-4x8 — what "
            f"htslib writes by default); for CRAM 3.1 output, convert "
            f"with `samtools view -O cram,version=3.0` or use BAM, the "
            f"recommended interop format (see README 'CRAM interop').")
    if len(data) != rsize:
        raise ValueError("CRAM block size mismatch")
    return {"type": ctype, "id": cid, "data": data}, p


def build_container(ref_id, start, span, n_records, counter, n_bases,
                    blocks, landmarks):
    head = (itf8_encode(ref_id) + itf8_encode(start) + itf8_encode(span)
            + itf8_encode(n_records) + ltf8_encode(counter)
            + ltf8_encode(n_bases) + itf8_encode(len(blocks))
            + itf8_encode(len(landmarks))
            + b"".join(itf8_encode(x) for x in landmarks))
    body = b"".join(blocks)
    head = struct.pack("<i", len(body)) + head
    return head + struct.pack("<I", zlib.crc32(head)) + body


def parse_container_header(buf, pos):
    start0 = pos
    length = struct.unpack("<i", buf[pos:pos + 4])[0]
    p = pos + 4
    ref_id, p = itf8_decode(buf, p)
    start, p = itf8_decode(buf, p)
    span, p = itf8_decode(buf, p)
    n_records, p = itf8_decode(buf, p)
    counter, p = ltf8_decode(buf, p)
    n_bases, p = ltf8_decode(buf, p)
    n_blocks, p = itf8_decode(buf, p)
    n_landmarks, p = itf8_decode(buf, p)
    landmarks = []
    for _ in range(n_landmarks):
        lm, p = itf8_decode(buf, p)
        landmarks.append(lm)
    crc = struct.unpack("<I", buf[p:p + 4])[0]
    if zlib.crc32(buf[start0:p]) != crc:
        raise ValueError("CRAM container header CRC mismatch")
    p += 4
    return {"length": length, "ref_id": ref_id, "start": start,
            "span": span, "n_records": n_records, "counter": counter,
            "n_bases": n_bases, "n_blocks": n_blocks,
            "landmarks": landmarks, "body_pos": p}, p


# ---------------------------------------------------------------------------
# encodings (serialised forms used in the compression header)
# ---------------------------------------------------------------------------

def enc_external(content_id):
    params = itf8_encode(content_id)
    return itf8_encode(1) + itf8_encode(len(params)) + params


def enc_byte_array_stop(stop_byte, content_id):
    params = bytes([stop_byte]) + itf8_encode(content_id)
    return itf8_encode(5) + itf8_encode(len(params)) + params


def enc_byte_array_len(len_encoding, val_encoding):
    params = len_encoding + val_encoding
    return itf8_encode(4) + itf8_encode(len(params)) + params


def _serialise_map(entries):
    """entries: [(key bytes, value bytes)] -> itf8 size + itf8 n + body."""
    body = itf8_encode(len(entries)) + b"".join(k + v for k, v in entries)
    return itf8_encode(len(body)) + body


# data series -> (external content id). FC is a byte series; the rest of
# the scalar series are ITF8-in-external.
_SERIES_IDS = {
    "BF": 1, "CF": 2, "RI": 3, "RL": 4, "AP": 5, "RG": 6, "RN": 7,
    "MF": 8, "NS": 9, "NP": 10, "TS": 11, "TL": 12,
    "FN": 13, "FC": 14, "FP": 15, "DL": 16, "BB": 17, "SC": 18, "IN": 19,
    "BA": 20, "MQ": 21, "QS": 22, "RS": 23, "PD": 24, "HC": 25, "BS": 26,
}
_BYTE_ARRAY_SERIES = ("BB", "SC", "IN")
_TAG_ID_BASE = 32

# substitution matrix helpers (preservation key SM): for reference base r
# the four substitute bases are ACGTN-minus-r in order; the SM byte packs
# each substitute's 2-bit code MSB-first. 0x1b = codes 0,1,2,3 in order.
DEFAULT_SM = b"\x1b" * 5
_SUB_ORDER = {r: [b for b in "ACGTN" if b != r] for r in "ACGTN"}


def _sub_code(ref_base, read_base, sm=DEFAULT_SM):
    """2-bit substitution code for read_base against ref_base, or None
    when either base falls outside the ACGTN matrix."""
    if ref_base not in _SUB_ORDER:
        return None
    byte = sm["ACGTN".index(ref_base)]
    for i, b in enumerate(_SUB_ORDER[ref_base]):
        if b == read_base:
            return (byte >> (6 - 2 * i)) & 3
    return None


def _sub_base(ref_base, code, sm=DEFAULT_SM):
    r = ref_base if ref_base in _SUB_ORDER else "N"
    byte = sm["ACGTN".index(r)]
    for i, b in enumerate(_SUB_ORDER[r]):
        if ((byte >> (6 - 2 * i)) & 3) == code:
            return b
    raise ValueError(f"substitution code {code} unmapped for {ref_base}")


def build_compression_header(tag_lines, tag_ids, reference_based=False):
    """tag_lines: list of TD lines (each a list of (tag, type) pairs);
    tag_ids: {(tag, type): content id}."""
    td = b"\x00".join(
        b"".join(t.encode() + y.encode() for t, y in line)
        for line in tag_lines) + b"\x00"
    preservation = _serialise_map([
        (b"RN", b"\x01"),            # read names preserved
        (b"AP", b"\x00"),            # AP stored absolute, not delta
        # RR=true: match stretches are implicit against the reference
        # (htslib's mode when a fasta is supplied — bonito/io.py:415-425);
        # RR=false: verbatim bases, no fasta needed to decode
        (b"RR", b"\x01" if reference_based else b"\x00"),
        (b"SM", DEFAULT_SM),
        (b"TD", itf8_encode(len(td)) + td),
    ])
    series = []
    for name, cid in _SERIES_IDS.items():
        if name == "RN":
            enc = enc_byte_array_stop(0x00, cid)
        elif name in _BYTE_ARRAY_SERIES:
            enc = enc_byte_array_len(enc_external(cid), enc_external(cid))
        else:
            enc = enc_external(cid)
        series.append((name.encode(), enc))
    data_series = _serialise_map(series)
    tags = _serialise_map([
        (itf8_encode((ord(t[0]) << 16) | (ord(t[1]) << 8) | ord(y)),
         enc_byte_array_len(enc_external(cid), enc_external(cid)))
        for (t, y), cid in sorted(tag_ids.items(), key=lambda kv: kv[1])])
    return preservation + data_series + tags


def parse_compression_header(data):
    pos = 0
    preservation = {}
    _, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        key = data[pos:pos + 2].decode()
        pos += 2
        if key in ("RN", "AP", "RR"):
            preservation[key] = bool(data[pos]); pos += 1
        elif key == "SM":
            preservation[key] = data[pos:pos + 5]; pos += 5
        elif key == "TD":
            ln, pos = itf8_decode(data, pos)
            preservation[key] = data[pos:pos + ln]; pos += ln
        else:
            raise ValueError(f"unknown preservation key {key}")

    def read_encoding(pos):
        codec, pos = itf8_decode(data, pos)
        plen, pos = itf8_decode(data, pos)
        params = data[pos:pos + plen]
        return (codec, params), pos + plen

    series = {}
    _, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        key = data[pos:pos + 2].decode()
        pos += 2
        series[key], pos = read_encoding(pos)

    tags = {}
    _, pos = itf8_decode(data, pos)
    n, pos = itf8_decode(data, pos)
    for _ in range(n):
        ikey, pos = itf8_decode(data, pos)
        key = (chr((ikey >> 16) & 0xFF) + chr((ikey >> 8) & 0xFF),
               chr(ikey & 0xFF))
        tags[key], pos = read_encoding(pos)

    td_lines = []
    td = preservation.get("TD", b"\x00")
    for line in td.split(b"\x00")[:-1]:
        td_lines.append([(line[i:i + 2].decode(), chr(line[i + 2]))
                         for i in range(0, len(line), 3)])
    return preservation, series, tags, td_lines


# ---------------------------------------------------------------------------
# codec readers (decode side)
# ---------------------------------------------------------------------------

class _Stream:
    __slots__ = ("data", "pos")

    def __init__(self, data):
        self.data = data
        self.pos = 0

    def itf8(self):
        v, self.pos = itf8_decode(self.data, self.pos)
        return v

    def byte(self):
        b = self.data[self.pos]
        self.pos += 1
        return b

    def take(self, n):
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def until(self, stop):
        end = self.data.index(stop, self.pos)
        b = self.data[self.pos:end]
        self.pos = end + 1
        return b


class _Codec:
    """Decoder for one encoding over the slice's external streams."""

    def __init__(self, spec, streams):
        self.codec, params = spec
        if self.codec == 1:                       # EXTERNAL
            cid, _ = itf8_decode(params, 0)
            self.stream = streams[cid]
        elif self.codec == 5:                     # BYTE_ARRAY_STOP
            self.stop = params[0]
            cid, _ = itf8_decode(params, 1)
            self.stream = streams[cid]
        elif self.codec == 4:                     # BYTE_ARRAY_LEN
            codec_l, p = itf8_decode(params, 0)
            plen, p = itf8_decode(params, p)
            self.len_codec = _Codec((codec_l, params[p:p + plen]), streams)
            p += plen
            codec_v, p2 = itf8_decode(params, p)
            plen_v, p2 = itf8_decode(params, p2)
            self.val_codec = _Codec((codec_v, params[p2:p2 + plen_v]),
                                    streams)
        else:
            raise ValueError(f"unsupported CRAM codec {self.codec}")

    def read_int(self):
        return self.stream.itf8()

    def read_byte(self):
        return self.stream.byte()

    def read_bytes(self):
        if self.codec == 5:
            return self.stream.until(self.stop)
        if self.codec == 4:
            n = self.len_codec.read_int()
            return self.val_codec.stream.take(n)
        raise ValueError("not a byte-array codec")


# ---------------------------------------------------------------------------
# record model
# ---------------------------------------------------------------------------

class CramRecord:
    __slots__ = ("name", "flag", "ref_id", "pos", "mapq", "cigar",
                 "seq", "qual", "tags", "read_group", "ref")

    def __init__(self, name, flag, ref_id, pos, mapq, cigar, seq, qual,
                 tags, read_group=-1, ref=None):
        self.name = name
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos          # 0-based leftmost (BAM convention); -1 unmapped
        self.mapq = mapq
        self.cigar = cigar      # [(op_char, length)]
        self.seq = seq
        self.qual = qual        # phred string (no +33 offset applied), "" = missing
        self.tags = tags        # ["xx:T:val", ...] SAM text form
        self.read_group = read_group
        self.ref = ref          # aligned reference span (ref-based mode)


_CONSUMES_QUERY = set("MIS=X")


def _features_from_record(rec, use_ref=False):
    """Feature list [(code, read_pos_1based, payload)] for a mapped
    record. No-ref mode: M/=/X stretches -> 'b' (verbatim bases).
    Reference-based mode (use_ref, rec.ref = the aligned reference
    span): matches are implicit, mismatches encode as 'X' substitution
    codes — the htslib-with-fasta behaviour that makes CRAM files
    materially smaller. S -> softclip, I -> insert, D/N/H/P -> lengths."""
    feats = []
    rpos = 1
    refpos = 0  # cursor into rec.ref (consumed by M/=/X and D/N)
    with_ref = use_ref and rec.ref is not None
    for op, n in rec.cigar:
        if op == "S":
            feats.append(("S", rpos, rec.seq[rpos - 1:rpos - 1 + n]))
            rpos += n
        elif op in "M=X":
            if with_ref:
                frag = rec.seq[rpos - 1:rpos - 1 + n]
                ref_frag = rec.ref[refpos:refpos + n]
                if len(ref_frag) < len(frag):
                    # a short rec.ref would silently zip-truncate here
                    # and the decoder would fabricate reference bases
                    # for the uncovered positions — corrupt output, so
                    # fail loudly at write time instead
                    raise ValueError(
                        f"rec.ref shorter than the CIGAR's reference "
                        f"footprint for {rec.name} (need {refpos + n}, "
                        f"have {len(rec.ref)})")
                for i, (a, b) in enumerate(zip(frag, ref_frag)):
                    if a == b:
                        continue
                    code = _sub_code(b, a)
                    if code is None:  # outside the ACGTN matrix
                        feats.append(("b", rpos + i, a))
                    else:
                        feats.append(("X", rpos + i, code))
            else:
                feats.append(("b", rpos, rec.seq[rpos - 1:rpos - 1 + n]))
            refpos += n
            rpos += n
        elif op == "I":
            feats.append(("I", rpos, rec.seq[rpos - 1:rpos - 1 + n]))
            rpos += n
        elif op == "D":
            feats.append(("D", rpos, n))
            refpos += n
        elif op == "N":
            feats.append(("N", rpos, n))
            refpos += n
        elif op == "H":
            feats.append(("H", rpos, n))
        elif op == "P":
            feats.append(("P", rpos, n))
        else:
            raise ValueError(f"unsupported CIGAR op {op}")
    return feats


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

class CramWriter:
    """CRAM 3.0 writer with the BAMWriter API: header once, then
    write(read_id, seq, qstring, mapping=None, tags=None)."""

    RECORDS_PER_CONTAINER = 4096

    def __init__(self, fd, header_text, refs, records_per_container=None,
                 reference_based=False, codec=None):
        self.fd = fd
        self.reference_based = bool(reference_based)
        # codec for the EXTERNAL data-series blocks: None -> gzip (this
        # writer's default; zlib's C deflate is fastest here), "rans0"/
        # "rans1" -> the htslib-default rANS 4x8 (spec method 4)
        self.codec = codec
        self.refs = list(refs)
        self.ref_ids = {name: i for i, (name, _) in enumerate(refs)}
        self.rg_ids = {}
        for line in header_text.splitlines():
            if line.startswith("@RG"):
                for field in line.split("\t")[1:]:
                    if field.startswith("ID:"):
                        self.rg_ids[field[3:]] = len(self.rg_ids)
        self._pending = []
        self._counter = 0
        if records_per_container:
            self.RECORDS_PER_CONTAINER = records_per_container

        self.fd.write(MAGIC + b"bonito_tpu".ljust(20, b"\x00"))
        head = struct.pack("<i", len(header_text.encode())) \
            + header_text.encode()
        block = build_block(CT_FILE_HEADER, 0, head)
        self.fd.write(build_container(-1, 0, 0, 0, 0, 0, [block], [0]))

    # -- record intake ------------------------------------------------------

    def write(self, read_id, seq, qstring, mapping=None, tags=None):
        # same loud guards as BAMWriter.write: a mismatched qstring
        # silently desyncs the container's QS stream, corrupting the
        # quality strings of EVERY later record in it
        if qstring and qstring != "*":
            if len(qstring) != len(seq):
                raise ValueError(
                    f"seq/qual length mismatch in read {read_id}: "
                    f"{len(seq)} bases vs {len(qstring)} quals")
            if qstring and min(qstring) < "!":
                raise ValueError(
                    f"qstring char below '!' in read {read_id}")
        # the CRAM tag machinery works on SAM text forms (TD lines slice
        # "xx:T:"), so render ArrayTag and friends up front
        tags = [str(t) for t in (tags or [])]
        if mapping is not None and mapping.strand == -1:
            from bonito_tpu_torch.util import revcomp
            seq = revcomp(seq)
            qstring = qstring[::-1]
        if mapping is None:
            rec = CramRecord(read_id, 4, -1, -1, 0, [], seq,
                             "" if qstring in ("", "*") else qstring, tags)
        else:
            l_seq = len(seq)
            clip_l, clip_r = mapping.q_st, l_seq - mapping.q_en
            if mapping.strand == -1:
                clip_l, clip_r = clip_r, clip_l
            cig = (f"{clip_l}S" if clip_l else "") + mapping.cigar_str \
                + (f"{clip_r}S" if clip_r else "")
            if getattr(mapping, "NM", None) is not None:
                tags.append(f"NM:i:{mapping.NM}")
            if getattr(mapping, "MD", None):
                tags.append(f"MD:Z:{mapping.MD}")
            ref_span = (getattr(mapping, "ref_seq", None)
                        if self.reference_based else None)
            rec = CramRecord(
                read_id, 16 if mapping.strand == -1 else 0,
                self.ref_ids[mapping.ctg], mapping.r_st, mapping.mapq,
                _parse_cigar(cig), seq,
                "" if qstring in ("", "*") else qstring, tags,
                ref=ref_span.upper() if ref_span else None)
        self.add_record(rec)

    def add_record(self, rec):
        # lift RG:Z into the dedicated RG series
        kept = []
        for t in rec.tags:
            if t.startswith("RG:Z:") and rec.read_group < 0:
                rec.read_group = self.rg_ids.get(t[5:], -1)
                if rec.read_group < 0:
                    kept.append(t)
            else:
                kept.append(t)
        rec.tags = kept
        self._pending.append(rec)
        if len(self._pending) >= self.RECORDS_PER_CONTAINER:
            self._flush()

    # -- container emission --------------------------------------------------

    def _flush(self):
        if not self._pending:
            return
        records = self._pending
        self._pending = []

        tag_lines, tag_ids = [], {}
        line_index = {}
        rec_tl = []
        for rec in records:
            line = tuple((t[:2], t[3]) for t in rec.tags)
            if line not in line_index:
                line_index[line] = len(tag_lines)
                tag_lines.append(list(line))
                for key in line:
                    if key not in tag_ids:
                        tag_ids[key] = _TAG_ID_BASE + len(tag_ids)
            rec_tl.append(line_index[line])

        streams = {cid: bytearray() for cid in _SERIES_IDS.values()}
        for cid in tag_ids.values():
            streams[cid] = bytearray()

        def put_int(name, v):
            streams[_SERIES_IDS[name]] += itf8_encode(v)

        def put_byte(name, v):
            streams[_SERIES_IDS[name]].append(v)

        def put_array(name, b):
            sid = _SERIES_IDS[name]
            streams[sid] += itf8_encode(len(b)) + bytes(b)

        n_bases = 0
        for rec, tl in zip(records, rec_tl):
            seq_b = rec.seq.encode()
            has_qual = bool(rec.qual)
            cf = CF_DETACHED | (CF_QS_STORED if has_qual else 0)
            mapped = not (rec.flag & 4)
            put_int("BF", rec.flag)
            put_int("CF", cf)
            put_int("RI", rec.ref_id)
            put_int("RL", len(seq_b))
            put_int("AP", rec.pos + 1 if mapped else 0)
            put_int("RG", rec.read_group)
            streams[_SERIES_IDS["RN"]] += rec.name.encode() + b"\x00"
            # detached mate block (single-end: no mate)
            put_int("MF", 0)
            put_int("NS", -1)
            put_int("NP", 0)
            put_int("TS", 0)
            put_int("TL", tl)
            for t in rec.tags:
                payload = _encode_tag(t)[3:]
                sid = tag_ids[(t[:2], t[3])]
                streams[sid] += itf8_encode(len(payload)) + payload
            if mapped:
                feats = _features_from_record(
                    rec, use_ref=self.reference_based)
                put_int("FN", len(feats))
                prev = 0
                for code, fpos, payload in feats:
                    put_byte("FC", ord(code))
                    put_int("FP", fpos - prev)
                    prev = fpos
                    if code == "b":
                        put_array("BB", payload.encode())
                    elif code == "S":
                        put_array("SC", payload.encode())
                    elif code == "I":
                        put_array("IN", payload.encode())
                    elif code == "X":
                        put_byte("BS", payload)
                    elif code == "D":
                        put_int("DL", payload)
                    elif code == "N":
                        put_int("RS", payload)
                    elif code == "H":
                        put_int("HC", payload)
                    elif code == "P":
                        put_int("PD", payload)
                put_int("MQ", rec.mapq)
            else:
                streams[_SERIES_IDS["BA"]] += seq_b
            if has_qual:
                streams[_SERIES_IDS["QS"]] += bytes(
                    q - 33 for q in rec.qual.encode())
            n_bases += len(seq_b)

        comp_block = build_block(
            CT_COMPRESSION_HEADER, 0,
            build_compression_header(tag_lines, tag_ids,
                                     reference_based=self.reference_based))

        ext_blocks, content_ids = [], []
        for cid in sorted(streams):
            if streams[cid]:
                ext_blocks.append(
                    build_block(CT_EXTERNAL, cid, bytes(streams[cid]),
                                method=self.codec))
                content_ids.append(cid)
        core_block = build_block(CT_CORE, 0, b"", method=M_RAW)

        slice_head = (
            itf8_encode(-2) + itf8_encode(0) + itf8_encode(0)   # multiref
            + itf8_encode(len(records)) + ltf8_encode(self._counter)
            + itf8_encode(1 + len(ext_blocks))
            + itf8_encode(len(content_ids))
            + b"".join(itf8_encode(c) for c in content_ids)
            + itf8_encode(-1)                                   # embedded ref
            + b"\x00" * 16)                                     # md5 (no ref)
        slice_block = build_block(CT_SLICE_HEADER, 0, slice_head)

        blocks = [comp_block, slice_block, core_block] + ext_blocks
        self.fd.write(build_container(
            -2, 0, 0, len(records), self._counter, n_bases,
            blocks, [len(comp_block)]))
        self._counter += len(records)

    def close(self):
        self._flush()
        self.fd.write(EOF_CONTAINER)
        self.fd.flush()


def _parse_cigar(cigar_str):
    import re
    return [(op, int(n))
            for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar_str)]


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

class CramReader:
    """Decode a CRAM 3.0 byte string/file written with external-style
    codecs (everything CramWriter emits). Yields CramRecord."""

    def __init__(self, source, reference=None):
        """``reference``: FASTA path or {name: sequence} dict — required
        to decode reference-based CRAM (preservation RR=true); files this
        writer produces without a reference decode with no fasta."""
        data = source if isinstance(source, (bytes, bytearray)) \
            else open(source, "rb").read()
        if not data.startswith(MAGIC[:4]):
            raise ValueError("not a CRAM file")
        if reference is None:
            self.ref_seqs = None
        elif isinstance(reference, dict):
            self.ref_seqs = {k: v.upper() for k, v in reference.items()}
        else:
            from bonito_tpu_torch.aligner import read_fasta
            self.ref_seqs = {n: s.upper() for n, s in read_fasta(reference)}
        self.version = (data[4], data[5])
        self.data = data
        pos = 26
        hdr, pos = parse_container_header(data, pos)
        block, _ = parse_block(data, hdr["body_pos"])
        text_len = struct.unpack("<i", block["data"][:4])[0]
        self.header_text = block["data"][4:4 + text_len].decode()
        self._first_container = hdr["body_pos"] + hdr["length"]
        self.refs = []
        for line in self.header_text.splitlines():
            if line.startswith("@SQ"):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:])
                self.refs.append((fields["SN"], int(fields["LN"])))
        self.rg_names = [
            dict(f.split(":", 1) for f in line.split("\t")[1:])["ID"]
            for line in self.header_text.splitlines()
            if line.startswith("@RG")]

    def __iter__(self):
        pos = self._first_container
        data = self.data
        while pos < len(data):
            if data[pos:pos + len(EOF_CONTAINER)] == EOF_CONTAINER:
                return
            hdr, p = parse_container_header(data, pos)
            end = hdr["body_pos"] + hdr["length"]
            comp_block, p = parse_block(data, hdr["body_pos"])
            preservation, series, tags_enc, td_lines = \
                parse_compression_header(comp_block["data"])
            while p < end:
                block, p2 = parse_block(data, p)
                if block["type"] != CT_SLICE_HEADER:
                    raise ValueError("expected slice header block")
                sh = _Stream(block["data"])
                sh.itf8(); sh.itf8(); sh.itf8()
                n_records = sh.itf8()
                _, sh.pos = ltf8_decode(block["data"], sh.pos)  # counter
                n_blocks = sh.itf8()
                n_ids = sh.itf8()
                for _ in range(n_ids):
                    sh.itf8()
                streams = {}
                bp = p2
                for _ in range(n_blocks):
                    blk, bp = parse_block(data, bp)
                    if blk["type"] == CT_EXTERNAL:
                        streams[blk["id"]] = _Stream(blk["data"])
                p = bp
                yield from self._decode_slice(
                    n_records, preservation, series, tags_enc, td_lines,
                    streams)
            pos = end

    def _decode_slice(self, n_records, preservation, series, tags_enc,
                      td_lines, streams):
        codecs = {}
        tag_codecs = {k: _Codec(v, streams) for k, v in tags_enc.items()}

        def c(name):
            # lazy: a series' stream exists only if the slice used it
            if name not in codecs:
                codecs[name] = _Codec(series[name], streams)
            return codecs[name]

        for _ in range(n_records):
            bf = c("BF").read_int()
            cf = c("CF").read_int()
            ref_id = c("RI").read_int()
            rl = c("RL").read_int()
            ap = c("AP").read_int()
            rg = c("RG").read_int()
            name = c("RN").read_bytes().decode()
            if cf & CF_DETACHED:
                c("MF").read_int()
                c("NS").read_int()
                c("NP").read_int()
                c("TS").read_int()
            elif cf & CF_MATE_DOWNSTREAM:
                c("NF").read_int()
            tl = c("TL").read_int()
            tags = []
            for tag, typ in td_lines[tl] if td_lines else []:
                payload = tag_codecs[(tag, typ)].read_bytes()
                val = _decode_tag_payload(typ, payload)
                tags.append(f"{tag}:{_sam_tag_type(typ)}:{_sam_tag_str(val)}")
            mapped = not (bf & 4)
            if mapped:
                nfeat = c("FN").read_int()
                feats = []
                fpos = 0
                for _ in range(nfeat):
                    code = chr(c("FC").read_byte())
                    fpos += c("FP").read_int()
                    if code == "b":
                        feats.append((code, fpos, c("BB").read_bytes()))
                    elif code == "S":
                        feats.append((code, fpos, c("SC").read_bytes()))
                    elif code == "I":
                        feats.append((code, fpos, c("IN").read_bytes()))
                    elif code == "X":
                        feats.append((code, fpos, c("BS").read_byte()))
                    elif code == "D":
                        feats.append((code, fpos, c("DL").read_int()))
                    elif code == "N":
                        feats.append((code, fpos, c("RS").read_int()))
                    elif code == "H":
                        feats.append((code, fpos, c("HC").read_int()))
                    elif code == "P":
                        feats.append((code, fpos, c("PD").read_int()))
                    else:
                        raise ValueError(f"unsupported feature {code}")
                mapq = c("MQ").read_int()
                pos = ap - 1
                ref = None
                if preservation.get("RR"):
                    if self.ref_seqs is None:
                        raise ValueError(
                            "reference-based CRAM (RR=true): pass "
                            "reference= to CramReader to decode")
                    ref_name = self.refs[ref_id][0]
                    ref = self.ref_seqs[ref_name]
                seq, cigar = _reconstruct(
                    feats, rl, ref=ref, ref_pos=pos,
                    sm=preservation.get("SM", DEFAULT_SM))
            else:
                seq = c("BA").stream.take(rl).decode()
                cigar, mapq, pos = [], 0, -1
            if cf & CF_QS_STORED:
                qual = bytes(q + 33 for q in c("QS").stream.take(rl)).decode()
            else:
                qual = ""
            if rg >= 0 and rg < len(self.rg_names):
                tags.append(f"RG:Z:{self.rg_names[rg]}")
            yield CramRecord(name, bf, ref_id, pos, mapq, cigar, seq,
                             qual, tags, rg)


_B_SUBTYPES = {"c": "b", "C": "B", "s": "h", "S": "H", "i": "i", "I": "I",
               "f": "f"}


def _decode_tag_payload(typ, payload):
    """Invert bam._encode_tag's value bytes for one tag."""
    if typ == "i":
        return struct.unpack("<i", payload)[0]
    if typ == "f":
        return struct.unpack("<f", payload)[0]
    if typ == "A":
        return payload[:1].decode()
    if typ == "Z":
        return payload.rstrip(b"\x00").decode()
    if typ == "B":
        sub = chr(payload[0])
        n = struct.unpack("<i", payload[1:5])[0]
        items = struct.unpack(f"<{n}{_B_SUBTYPES[sub]}", payload[5:])
        return (sub, list(items))
    raise ValueError(f"unsupported tag type {typ}")


def _reconstruct(feats, read_len, ref=None, ref_pos=0, sm=DEFAULT_SM):
    """Rebuild SEQ + CIGAR from the feature list. With ``ref`` (the
    contig sequence; reference-based mode, RR=true) read positions not
    covered by a feature decode as reference matches and 'X' features
    apply the substitution matrix. Without a reference, full feature
    coverage is required (which the no-ref writer guarantees)."""
    seq = bytearray()
    cigar = []

    def push(op, n):
        if n <= 0:
            return
        if cigar and cigar[-1][0] == op:
            cigar[-1] = (op, cigar[-1][1] + n)
        else:
            cigar.append((op, n))

    covered = 1   # next un-decoded read position (1-based)
    rcur = ref_pos  # reference cursor (0-based into ref)

    def fill_match(upto):
        # implicit reference match run covering [covered, upto)
        nonlocal covered, rcur
        n = upto - covered
        if n <= 0:
            return
        if ref is None:
            raise ValueError("referenceless CRAM record with uncovered "
                             f"read positions at {covered}")
        seq.extend(ref[rcur:rcur + n].encode())
        push("M", n)
        rcur += n
        covered = upto

    for code, fpos, payload in feats:
        fill_match(fpos)
        if code == "b":
            seq += payload
            push("M", len(payload))
            covered = fpos + len(payload)
            rcur += len(payload)
        elif code == "X":
            seq += _sub_base(ref[rcur] if ref is not None else "N",
                             payload, sm).encode()
            push("M", 1)
            covered = fpos + 1
            rcur += 1
        elif code == "S":
            seq += payload
            push("S", len(payload))
            covered = fpos + len(payload)
        elif code == "I":
            seq += payload
            push("I", len(payload))
            covered = fpos + len(payload)
        elif code == "D":
            push("D", payload)
            rcur += payload
        elif code == "N":
            push("N", payload)
            rcur += payload
        elif code == "H":
            push("H", payload)
        elif code == "P":
            push("P", payload)
    fill_match(read_len + 1)
    if len(seq) != read_len:
        raise ValueError("decoded sequence length mismatch")
    return seq.decode(), cigar


def _sam_tag_type(typ):
    return "i" if typ in "cCsSiI" else typ


def _sam_tag_str(val):
    if isinstance(val, tuple):          # B array: (subtype, list)
        sub, items = val
        return ",".join([sub] + [str(x) for x in items])
    if isinstance(val, float):
        return repr(val)
    return str(val)
