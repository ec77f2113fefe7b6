"""
rANS 4x8 codec (CRAM 3.0 block compression method 4), a copy of
bonito_tpu's ``rans.py`` for the port: the order-0 and order-1 coder in
Python, and ``compress_auto``/``uncompress_auto`` on the native library
built from ``native/rans/rans.cpp`` (``bonito_tpu_torch.native``).

This is the codec htslib emits by default for most CRAM data series
(htslib's cram/rANS_static.c, which upstream bonito reaches through
pysam). The native library is the production path and has no Python
fallback here: a failed build raises, as ``native`` says. The Python
coder is the tests' oracle, byte-identical to the library on encode and
cross-decoding. Format (hts-specs CRAMcodecs "rANS codec"):

  header: order u8 | compressed-size u32le (bytes after this 9-byte
          header) | uncompressed-size u32le
  order 0: one frequency table over 256 symbols normalised to 4096,
          RLE-serialised; 4 interleaved 32-bit rANS states (lower bound
          2^23, byte renormalisation) flushed as 4 u32le, state 0 first;
          symbol i is carried by state i%4.
  order 1: byte coded under its predecessor; input split into four
          isz4 = len//4 sized quarters (one state each; the first byte
          of each quarter under context 0) with the remainder carried
          by state 3; per-context tables, outer context list using the
          same RLE scheme.
"""

import ctypes
import struct

TOTFREQ = 4096
TF_SHIFT = 12
RANS_BYTE_L = 1 << 23


# ---------------------------------------------------------------------------
# frequency tables
# ---------------------------------------------------------------------------

def _normalise(counts):
    """Scale 256 counts to sum EXACTLY TOTFREQ, present symbols >= 1.
    Always succeeds (<=256 symbols, TOTFREQ=4096 > 256): a deficit is
    added to the most frequent symbol; an excess (from the max(1, .)
    clamps on rare symbols) is drained from the currently largest
    frequency, which is always > 1 while an excess remains. Must stay
    step-identical with native/rans/rans.cpp::normalise — the tests pin
    the two byte-equal."""
    total = sum(counts)
    freqs = [0] * 256
    if not total:
        return freqs
    maxi = max(range(256), key=lambda i: counts[i])
    s = 0
    for i in range(256):
        if not counts[i]:
            continue
        f = counts[i] * TOTFREQ // total
        freqs[i] = max(f, 1)
        s += freqs[i]
    if s < TOTFREQ:
        freqs[maxi] += TOTFREQ - s
        return freqs
    excess = s - TOTFREQ
    while excess > 0:
        big = max(range(256), key=lambda i: freqs[i])
        take = min(freqs[big] - 1, excess)
        freqs[big] -= take
        excess -= take
    return freqs


def _write_freqs(freqs, out):
    """htslib RLE scheme: ascending symbols; a run-length byte follows a
    symbol whose predecessor is also present; freqs are 1 byte (<128) or
    2 bytes (0x80|hi, lo); 0-terminated."""
    rle = 0
    for j in range(256):
        if not freqs[j]:
            continue
        if rle:
            rle -= 1
        else:
            out.append(j)
            if j and freqs[j - 1]:
                k = j + 1
                while k < 256 and freqs[k]:
                    k += 1
                rle = k - (j + 1)
                out.append(rle)
        f = freqs[j]
        if f < 128:
            out.append(f)
        else:
            out.append(0x80 | (f >> 8))
            out.append(f & 0xFF)
    out.append(0)


def _read_freqs(data, pos):
    freqs = [0] * 256
    rle = 0
    j = data[pos]
    pos += 1
    while True:
        f = data[pos]
        pos += 1
        if f >= 128:
            f = ((f & 127) << 8) | data[pos]
            pos += 1
        freqs[j] = f
        if not rle and j + 1 == data[pos]:
            j = data[pos]
            rle = data[pos + 1]
            pos += 2
        elif rle:
            rle -= 1
            j += 1
            if j > 255:
                raise ValueError("rANS freq table run past symbol space")
        else:
            j = data[pos]
            pos += 1
        if j == 0:
            # symbols ascend, so 0 can only open the list (handled by
            # the pre-loop read) — here it is the terminator
            break
    return freqs, pos


def _cumulate(freqs):
    cum = [0] * 257
    for i in range(256):
        cum[i + 1] = cum[i] + freqs[i]
    lookup = bytearray(TOTFREQ)
    for i in range(256):
        for m in range(cum[i], cum[i + 1]):
            lookup[m] = i
    return cum, bytes(lookup)


# ---------------------------------------------------------------------------
# core rANS
# ---------------------------------------------------------------------------

def _enc_put(x, rev, start, freq):
    x_max = ((RANS_BYTE_L >> TF_SHIFT) << 8) * freq
    while x >= x_max:
        rev.append(x & 0xFF)
        x >>= 8
    return ((x // freq) << TF_SHIFT) + (x % freq) + start


def _enc_flush(x, rev):
    rev.extend(((x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF))


def compress(data, order=0):
    data = bytes(data)
    n = len(data)
    if n < 4:
        order = 0
    table = bytearray()
    rev = bytearray()

    if order == 0:
        counts = [0] * 256
        for b in data:
            counts[b] += 1
        freqs = _normalise(counts)
        cum, _ = _cumulate(freqs)
        _write_freqs(freqs, table)
        X = [RANS_BYTE_L] * 4
        for i in range(n - 1, -1, -1):
            s = data[i]
            X[i & 3] = _enc_put(X[i & 3], rev, cum[s], freqs[s])
        for j in (3, 2, 1, 0):
            _enc_flush(X[j], rev)
    else:
        isz4 = n >> 2
        counts = {}

        def bump(ctx, sym):
            c = counts.setdefault(ctx, [0] * 256)
            c[sym] += 1

        for q in range(4):
            bump(0, data[q * isz4])
        for i in range(1, n):
            if i in (isz4, 2 * isz4, 3 * isz4):
                continue
            bump(data[i - 1], data[i])
        tabs = {}
        for ctx, c in counts.items():
            f = _normalise(c)
            cum, _ = _cumulate(f)
            tabs[ctx] = (f, cum)
        # outer context list, same RLE scheme; inner order-0 tables
        used = [ctx in tabs for ctx in range(256)]
        rle = 0
        for ctx in range(256):
            if not used[ctx]:
                continue
            if rle:
                rle -= 1
            else:
                table.append(ctx)
                if ctx and used[ctx - 1]:
                    k = ctx + 1
                    while k < 256 and used[k]:
                        k += 1
                    rle = k - (ctx + 1)
                    table.append(rle)
            _write_freqs(tabs[ctx][0], table)
        table.append(0)

        X = [RANS_BYTE_L] * 4

        def put(j, ctx, sym):
            f, cum = tabs[ctx]
            X[j] = _enc_put(X[j], rev, cum[sym], f[sym])

        i3 = n - 1
        l3 = data[i3]
        while i3 >= 4 * isz4 and i3 > 0:
            put(3, data[i3 - 1], l3)
            l3 = data[i3 - 1]
            i3 -= 1
        i2, i1, i0 = 3 * isz4 - 1, 2 * isz4 - 1, isz4 - 1
        l2, l1, l0 = data[i2], data[i1], data[i0]
        while i0 > 0:
            put(3, data[i3 - 1], l3); l3 = data[i3 - 1]; i3 -= 1
            put(2, data[i2 - 1], l2); l2 = data[i2 - 1]; i2 -= 1
            put(1, data[i1 - 1], l1); l1 = data[i1 - 1]; i1 -= 1
            put(0, data[i0 - 1], l0); l0 = data[i0 - 1]; i0 -= 1
        put(3, 0, l3)
        put(2, 0, l2)
        put(1, 0, l1)
        put(0, 0, l0)
        for j in (3, 2, 1, 0):
            _enc_flush(X[j], rev)

    body = bytes(table) + bytes(reversed(rev))
    return (struct.pack("<BII", order, len(body), n) + body)


def uncompress(data, expected_size=None):
    try:
        return _uncompress(data, expected_size)
    except (IndexError, KeyError, struct.error) as e:
        # malformed/truncated foreign stream: surface one loud error
        # instead of a bare container-offset exception
        raise ValueError(f"malformed rANS stream ({type(e).__name__})")


def _uncompress(data, expected_size=None):
    if len(data) < 9:
        raise ValueError("rANS stream too short")
    order, body, raw = struct.unpack("<BII", data[:9])
    if expected_size is not None and raw != expected_size:
        raise ValueError(
            f"rANS size mismatch: header {raw}, block {expected_size}")
    if 9 + body > len(data):
        raise ValueError("rANS stream truncated")
    if raw == 0:
        return b""
    pos = 9
    end = 9 + body  # strict body end: trailing slack is NOT renorm input
    out = bytearray(raw)

    if order == 0:
        freqs, pos = _read_freqs(data, pos)
        cum, lookup = _cumulate(freqs)
        X = list(struct.unpack_from("<4I", data, pos))
        pos += 16
        for i in range(raw):
            j = i & 3
            x = X[j]
            m = x & (TOTFREQ - 1)
            s = lookup[m]
            out[i] = s
            x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
            while x < RANS_BYTE_L and pos < end:
                x = (x << 8) | data[pos]
                pos += 1
            X[j] = x
    elif order == 1:
        tabs = {}
        rle = 0
        ctx = data[pos]
        pos += 1
        while True:
            freqs, pos = _read_freqs(data, pos)
            tabs[ctx] = (freqs, *(_cumulate(freqs)))
            if not rle and ctx + 1 == data[pos]:
                ctx = data[pos]
                rle = data[pos + 1]
                pos += 2
            elif rle:
                rle -= 1
                ctx += 1
                if ctx > 255:
                    raise ValueError(
                        "rANS context table run past symbol space")
            else:
                ctx = data[pos]
                pos += 1
            if ctx == 0:
                break
        X = list(struct.unpack_from("<4I", data, pos))
        pos += 16
        isz4 = raw >> 2
        starts = [0, isz4, 2 * isz4, 3 * isz4]
        last = [0, 0, 0, 0]
        for i in range(isz4):
            for j in range(4):
                x = X[j]
                freqs, cum, lookup = tabs[last[j]]
                m = x & (TOTFREQ - 1)
                s = lookup[m]
                out[starts[j] + i] = s
                x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
                while x < RANS_BYTE_L and pos < end:
                    x = (x << 8) | data[pos]
                    pos += 1
                X[j] = x
                last[j] = s
        for i in range(4 * isz4, raw):
            x = X[3]
            freqs, cum, lookup = tabs[last[3]]
            m = x & (TOTFREQ - 1)
            s = lookup[m]
            out[i] = s
            x = freqs[s] * (x >> TF_SHIFT) + m - cum[s]
            while x < RANS_BYTE_L and pos < end:
                x = (x << 8) | data[pos]
                pos += 1
            X[3] = x
            last[3] = s
    else:
        raise ValueError(f"unsupported rANS order {order}")
    return bytes(out)


# ---------------------------------------------------------------------------
# the native library (the production path; the above is the oracle)
# ---------------------------------------------------------------------------

def _lib():
    from bonito_tpu_torch import native
    return native.load("rans")


def compress_auto(data, order=0):
    """rANS-compress ``data`` with the native library."""
    lib = _lib()
    data = bytes(data)
    bound = lib.rans_compress_bound(len(data), order)
    out = (ctypes.c_uint8 * bound)()
    n = lib.rans_compress(
        (ctypes.c_uint8 * len(data)).from_buffer_copy(data) if data
        else (ctypes.c_uint8 * 1)(),
        len(data), order, out)
    if n < 0:
        raise ValueError(f"native rans_compress failed ({n})")
    return bytes(out[:n])


def uncompress_auto(data, expected_size):
    """rANS-uncompress ``data`` to ``expected_size`` bytes with the native
    library."""
    lib = _lib()
    data = bytes(data)
    out = (ctypes.c_uint8 * max(expected_size, 1))()
    r = lib.rans_uncompress(
        (ctypes.c_uint8 * len(data)).from_buffer_copy(data),
        len(data), out, expected_size)
    if r != 0:
        raise ValueError(f"native rans_uncompress failed ({r})")
    return bytes(out[:expected_size])
