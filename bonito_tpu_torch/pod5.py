"""
POD5 read backend, bonito_tpu's (``bonito_tpu/pod5.py``) without pyarrow,
zstandard or flatbuffers.

A pod5 file is a signature, three embedded Arrow IPC files (reads, signal
and run-info tables) and a flatbuffer footer that indexes them; each
embedded file is read by ``bonito_tpu_torch.arrow``, the footer by its
flatbuffer reader. A file without a footer is scanned for the Arrow files'
framing magic. Both layouts are read: bonito_tpu's writer's and the
official one's (uuid extension read ids, dictionary-encoded run info, pore
type and end reason, the signal table in several record batches, nulls,
which take each column's default).

Signal chunks are VBZ: zstd (the system ``libzstd`` through ctypes) over
svb16 with delta and zigzag (``native/vbz``, built at first use). Without
libzstd a VBZ chunk raises; nothing falls back.

Read semantics are bonito_tpu's, and upstream bonito's
(bonito/pod5.py:18-124): pA = calibration_scale * (adc +
calibration_offset), then quantile or pa standardisation and trim.
"""

import ctypes
import ctypes.util
import struct
import sys
import threading
import uuid
from datetime import datetime, timedelta, timezone
from functools import partial
from glob import glob
from pathlib import Path

import numpy as np

from bonito_tpu_torch import arrow, native
from bonito_tpu_torch.fast5 import READ_BLOCK, _parse_time
from bonito_tpu_torch.reader import Read as BaseRead
from bonito_tpu_torch.signal import apply_standardisation

_SIGNATURE = b"\x8bPOD\r\n\x1a\n"
_ARROW_START = b"ARROW1\x00\x00"
_ARROW_MAGIC = b"ARROW1"

# pod5 footer.fbs: ContentType of each embedded file
CONTENT_READS, CONTENT_SIGNAL, CONTENT_RUN_INFO = 0, 1, 4


# ---------------------------------------------------------------------------
# VBZ: zstd over svb16
# ---------------------------------------------------------------------------

class LibraryMissing(RuntimeError):
    """A library the data needs is not on this machine. The readers let
    it through where they warn and go on for a bad read."""


_zstd = None
_zstd_lock = threading.Lock()


def libzstd():
    """The system libzstd, bound; raises LibraryMissing without one."""
    global _zstd
    with _zstd_lock:
        if _zstd is None:
            name = ctypes.util.find_library("zstd")
            if name is None:
                raise LibraryMissing(
                    "VBZ-compressed pod5 signal needs the system libzstd, "
                    "and ctypes.util.find_library('zstd') finds none")
            lib = ctypes.CDLL(name)
            size_t, p = ctypes.c_size_t, ctypes.c_void_p
            lib.ZSTD_decompress.restype = size_t
            lib.ZSTD_decompress.argtypes = [p, size_t, p, size_t]
            lib.ZSTD_compress.restype = size_t
            lib.ZSTD_compress.argtypes = [p, size_t, p, size_t, ctypes.c_int]
            lib.ZSTD_compressBound.restype = size_t
            lib.ZSTD_compressBound.argtypes = [size_t]
            lib.ZSTD_isError.restype = ctypes.c_uint
            lib.ZSTD_isError.argtypes = [size_t]
            _zstd = lib
    return _zstd


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def vbz_compress(signal):
    """VBZ bytes of an int16 signal (zstd level 1, as bonito_tpu's)."""
    zstd, svb = libzstd(), native.load("vbz")
    signal = np.ascontiguousarray(signal, np.int16)
    n = len(signal)
    payload = np.empty(svb.svb16_max_encoded_size(n), np.uint8)
    size = svb.svb16_encode_dz(
        signal.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), n,
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    out = np.empty(zstd.ZSTD_compressBound(size), np.uint8)
    written = zstd.ZSTD_compress(_ptr(out), len(out), _ptr(payload), size, 1)
    if zstd.ZSTD_isError(written):
        raise RuntimeError("zstd failed to compress a signal chunk")
    return out[:written].tobytes()


def vbz_decompress(data, sample_count):
    """The int16 samples of a VBZ chunk (bytes-like) of ``sample_count``
    samples; a corrupt chunk raises."""
    zstd, svb = libzstd(), native.load("vbz")
    src = np.frombuffer(data, np.uint8)
    payload = np.empty((sample_count + 7) // 8 + 2 * sample_count, np.uint8)
    size = zstd.ZSTD_decompress(_ptr(payload), len(payload), _ptr(src),
                                len(src))
    if zstd.ZSTD_isError(size):
        raise ValueError("corrupt vbz signal chunk (zstd)")
    out = np.empty(sample_count, np.int16)
    rc = svb.svb16_decode_dz(
        payload.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), sample_count)
    if rc != 0:
        raise ValueError("corrupt vbz signal chunk")
    return out


# ---------------------------------------------------------------------------
# the footer (pod5 footer.fbs: table Footer { file_identifier, software,
# pod5_version, contents: [EmbeddedFile] }; table EmbeddedFile { offset,
# length, format, content_type }; Format.FeatherV2 = 0)
# ---------------------------------------------------------------------------

def build_footer(contents, file_identifier, software="bonito_tpu_torch",
                 pod5_version="0.3.10"):
    """The footer flatbuffer; ``contents`` are dicts with offset, length
    and content_type (format is always FeatherV2, 0)."""
    files = [arrow.Table(("q", c["offset"]), ("q", c["length"]),
                         ("h", c.get("format", 0)), ("h", c["content_type"]))
             for c in contents]
    return arrow.serialize(arrow.Table(file_identifier, software,
                                       pod5_version, files))


def parse_footer(data):
    """The footer of a pod5 file's bytes (or of their tail), which sits
    before <int64 length><section marker><signature>: {file_identifier,
    software, pod5_version, contents: [...]}, or None where there is none."""
    tail = len(data) - len(_SIGNATURE) - 16
    flen_off = tail - 8
    if flen_off <= 0:
        return None
    flen = int.from_bytes(data[flen_off:tail], "little", signed=True)
    if flen <= 0 or flen > flen_off:
        return None
    root = arrow.FlatTable.root(memoryview(data)[flen_off - flen:flen_off])
    return {
        "file_identifier": root.string(0),
        "software": root.string(1),
        "pod5_version": root.string(2),
        "contents": [{"offset": ef.scalar(0, "q"),
                      "length": ef.scalar(1, "q"),
                      "format": ef.scalar(2, "h"),
                      "content_type": ef.scalar(3, "h")}
                     for ef in root.tables(3)],
    }


def _footer_or_none(data):
    try:
        footer = parse_footer(data)
    except (struct.error, IndexError, UnicodeDecodeError):
        return None
    return footer if footer and footer["contents"] else None


# ---------------------------------------------------------------------------
# container parsing
# ---------------------------------------------------------------------------

def _embedded_arrow_files(path):
    """Every embedded Arrow file of a pod5 file: from the footer's index,
    or for a file without one by scanning for the framing magic."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path} is not a pod5 file (bad signature)")
    mv = memoryview(data)
    footer = _footer_or_none(data)
    if footer:
        return [arrow.ArrowFile(mv[ef["offset"]:ef["offset"] + ef["length"]])
                for ef in footer["contents"]]
    files, pos = [], 0
    while True:
        start = data.find(_ARROW_START, pos)
        if start < 0:
            return files
        # an Arrow file ends in <int32 footer size>"ARROW1"; padding can
        # make an end magic look like a start, so each candidate end is
        # checked by its footer size and by opening the slice
        scan, found = start + len(_ARROW_START), None
        while found is None:
            cand = data.find(_ARROW_MAGIC, scan)
            if cand < 0:
                break
            scan = cand + len(_ARROW_MAGIC)
            footer_size = int.from_bytes(data[cand - 4:cand], "little")
            if cand - 4 <= start or footer_size <= 0 \
                    or cand - 4 - footer_size < start:
                continue
            try:
                found = arrow.ArrowFile(mv[start:cand + len(_ARROW_MAGIC)])
            except arrow.ArrowError:
                continue
        if found is None:
            pos = start + len(_ARROW_START)
            continue
        files.append(found)
        pos = scan


def _classify(files):
    reads = signal = run_info = None
    for f in files:
        names = set(f.names)
        if "samples" in names and "signal" in names:
            signal = f
        elif "calibration_offset" in names or (
                "signal" in names and "read_number" in names):
            reads = f
        elif "acquisition_id" in names or "sample_rate" in names:
            run_info = f
    return reads, signal, run_info


# the run-info fields a Read takes
_RUN_INFO = ("acquisition_id", "sample_id", "flow_cell_id", "system_name",
             "acquisition_start_time", "sample_rate")


class Pod5File:
    """A parsed pod5 file: per-read signal and metadata lookups."""

    def __init__(self, path):
        self.path = Path(path)
        reads, signal, run_info = _classify(_embedded_arrow_files(path))
        if reads is None or signal is None:
            raise ValueError(f"{path}: missing reads/signal table")
        self.reads, self.signal, self.run_info = reads, signal, run_info
        self.read_id_bytes = [r.tobytes()
                              for r in reads.column("read_id").numpy()]
        # built on the first get_signal: metadata passes never need it
        self._sig_rows = None
        self._samples = None
        self._sig_col = signal.column("signal")
        # VBZ chunks are (large) binary; a list of integers is raw signal
        self._compressed = self._sig_col.field.kind in ("binary",
                                                        "large_binary")
        self._run_info_cache = {}

    def read_ids(self):
        return [str(uuid.UUID(bytes=b)) for b in self.read_id_bytes]

    def num_reads(self):
        return self.reads.num_rows

    def _ensure_sig_index(self):
        if self._sig_rows is None:
            self._sig_rows = {}
            for i, rid in enumerate(self.signal.column("read_id").numpy()):
                self._sig_rows.setdefault(rid.tobytes(), []).append(i)
            self._samples = self.signal.column("samples").numpy()

    def get_signal(self, read_id_bytes):
        self._ensure_sig_index()
        parts = []
        for r in self._sig_rows.get(read_id_bytes, []):
            chunk = self._sig_col[r]
            if self._compressed:
                parts.append(vbz_decompress(chunk, int(self._samples[r])))
            else:
                parts.append(np.asarray(chunk, np.int16))
        return np.concatenate(parts) if parts else np.empty(0, np.int16)

    def run_info_row(self, key):
        """The run-info fields a Read takes, of the row at an index or of
        an acquisition id (the official layout's reads table names its run
        by acquisition id, dictionary-encoded)."""
        if self.run_info is None or key is None:
            return {}
        if key in self._run_info_cache:
            return self._run_info_cache[key]
        row = key
        if isinstance(key, str):
            if "acquisition_id" not in self.run_info.names:
                return {}
            ids = self.run_info.column("acquisition_id").to_list()
            row = ids.index(key) if key in ids else None
        info = {}
        if row is not None and row < self.run_info.num_rows:
            info = {name: self.run_info.column(name)[row]
                    for name in _RUN_INFO if name in self.run_info.names}
        self._run_info_cache[key] = info
        return info

    def _col(self, name, row, default=None):
        if name in self.reads.names:
            v = self.reads.column(name)[row]
            return v if v is not None else default
        return default


class Read(BaseRead):

    def __init__(self, p5: Pod5File, row: int, filename, meta=False,
                 do_trim=True, scaling_strategy=None, norm_params=None):
        rid = p5.read_id_bytes[row]
        self.read_id = str(uuid.UUID(bytes=rid))
        self.filename = Path(filename).name

        info = p5.run_info_row(p5._col("run_info", row))
        self.run_id = info.get("acquisition_id", "") or ""
        self.sample_id = info.get("sample_id", "unset") or "unset"
        self.flow_cell_id = info.get("flow_cell_id", "") or ""
        self.device_id = info.get("system_name", "") or ""
        start_time = info.get("acquisition_start_time")
        if isinstance(start_time, datetime):
            self.exp_start_time = start_time.astimezone(
                timezone.utc).isoformat(timespec="milliseconds")
        else:
            self.exp_start_time = str(start_time or "")
        self.sample_rate = info.get("sample_rate", 5000) or 5000

        if meta:
            return

        self.mux = p5._col("well", row, 0)
        self.channel = p5._col("channel", row, 0)
        self.read_number = p5._col("read_number", row, 0)
        offset = p5._col("calibration_offset", row, 0.0)
        scale = p5._col("calibration_scale", row, 1.0)

        start_sample = p5._col("start", row, 0)
        self.start = start_sample / self.sample_rate

        raw = p5.get_signal(rid)
        self.duration = len(raw) / self.sample_rate
        scaled = np.array(scale * (raw + offset), dtype=np.float32)
        if self.exp_start_time:
            # acquisition start + start_sample / rate, as upstream bonito
            # (bonito/pod5.py:48-50) and the fast5 backend
            try:
                start_dt = (_parse_time(self.exp_start_time.replace("Z", ""))
                            + timedelta(seconds=float(self.start)))
                if start_dt.tzinfo is None:
                    start_dt = start_dt.replace(tzinfo=timezone.utc)
                self.start_time = start_dt.astimezone(
                    timezone.utc).isoformat(timespec="milliseconds")
            except (ValueError, TypeError):
                self.start_time = self.exp_start_time
        apply_standardisation(self, scaled, scaling_strategy, norm_params,
                              do_trim=do_trim)


def _num_reads_fast(path):
    """The reads table's row count, without reading the signal: the
    footer from the file's tail, then only the reads table. A file without
    a footer is parsed whole."""
    p = Path(path)
    size = p.stat().st_size
    with open(p, "rb") as f:
        if f.read(len(_SIGNATURE)) != _SIGNATURE:
            raise ValueError(f"{path} is not a pod5 file (bad signature)")
        tail_len = min(size, 1 << 16)
        f.seek(size - tail_len)
        footer = _footer_or_none(f.read(tail_len))
        for ef in (footer or {}).get("contents", []):
            if ef["content_type"] == CONTENT_READS:
                f.seek(ef["offset"])
                return arrow.ArrowFile(f.read(ef["length"])).num_rows
    return Pod5File(path).num_reads()


def _files(directory, recursive=False):
    pattern = "**/*.pod5" if recursive else "*.pod5"
    return sorted(glob(str(Path(directory) / pattern), recursive=recursive))


def get_read_groups(directory, model, read_ids=None, skip=False, n_proc=1,
                    recursive=False, cancel=None):
    """Unique @RG lines and the count of all reads in the files (before
    any filter), as upstream bonito's (bonito/pod5.py:84-110)."""
    groups = set()
    num_reads = 0
    for filename in _files(directory, recursive):
        try:
            p5 = Pod5File(filename)
        except (OSError, ValueError, KeyError) as e:
            sys.stderr.write(f"> warning: {filename} - {e}\n")
            continue
        num_reads += p5.num_reads()
        for row in range(p5.num_reads()):
            read = Read(p5, row, filename, meta=True)
            if read_ids is None or (read.read_id in read_ids) ^ skip:
                groups.add(read.readgroup(model))
    return sorted(groups), num_reads


# one parsed Pod5File per worker process: its work items are blocks of
# rows of one file at a time
_P5_CACHE = {}


def _p5_cached(filename):
    if filename not in _P5_CACHE:
        _P5_CACHE.clear()
        _P5_CACHE[filename] = Pod5File(filename)
    return _P5_CACHE[filename]


def _read_block(item, read_ids=None, skip=False, do_trim=True,
                scaling_strategy=None, norm_params=None):
    """Worker: the Reads of a (filename, row range or None) item. A file
    or read that fails warns and is skipped, as in upstream bonito; a
    missing library raises."""
    filename, rows = item
    out = []
    try:
        p5 = _p5_cached(filename)
    except (OSError, ValueError, KeyError) as e:
        sys.stderr.write(f"> warning: {filename} - {e}\n")
        return out
    row_range = (range(*rows) if rows is not None
                 else range(p5.num_reads()))
    for row in row_range:
        rid = str(uuid.UUID(bytes=p5.read_id_bytes[row]))
        if not (read_ids is None or (rid in read_ids) ^ skip):
            continue
        try:
            out.append(Read(p5, row, filename, do_trim=do_trim,
                            scaling_strategy=scaling_strategy,
                            norm_params=norm_params))
        except LibraryMissing:
            raise
        except Exception as e:  # noqa: BLE001 — one bad read, reported
            sys.stderr.write(f"> warning: {filename} {rid} - {e}\n")
    return out


def get_reads(directory, read_ids=None, skip=False, max_read_size=0,
              n_proc=1, recursive=False, cancel=None, do_trim=True,
              scaling_strategy=None, norm_params=None):
    """Stream Reads; with ``n_proc`` > 1 the files are parsed (VBZ, trim,
    normalisation) in that many worker processes, in blocks of
    ``fast5.READ_BLOCK`` reads."""
    from bonito_tpu_torch.pipeline import process_map

    files = _files(directory, recursive)
    native.build("vbz")  # once here, not in every worker at once

    def blocks():
        for f in files:
            try:
                n = _num_reads_fast(f)
            except (OSError, ValueError, KeyError) as e:
                sys.stderr.write(f"> warning: {f} - {e}\n")
                continue
            for lo in range(0, n, READ_BLOCK):
                yield (f, (lo, min(lo + READ_BLOCK, n)))

    # the shared settings (a --read-ids set may be large) are bound into
    # the worker once, not sent with every item
    worker = partial(_read_block, read_ids=read_ids, skip=skip,
                     do_trim=do_trim, scaling_strategy=scaling_strategy,
                     norm_params=norm_params)
    if n_proc <= 1:
        batches = ((None, worker((f, None))) for f in files)
    else:
        batches = process_map(
            worker, ((i, a) for i, a in enumerate(blocks())),
            n_proc=n_proc, maxsize=4)
    try:
        for _, reads in batches:
            for read in reads:
                if max_read_size > 0 and len(read.signal) > max_read_size:
                    sys.stderr.write(
                        f"> skipping long read {read.read_id} "
                        f"({len(read.signal)} samples)\n")
                    continue
                yield read
                if cancel is not None and cancel.is_set():
                    return
    finally:
        _P5_CACHE.clear()  # the in-process path's last file


# ---------------------------------------------------------------------------
# writer (fixtures and repacking)
# ---------------------------------------------------------------------------

def write_pod5(path, reads, run_info=None, compress=True):
    """Write a pod5 file in bonito_tpu's layout. ``reads`` is an iterable
    of dicts: read_id (uuid str), signal (int16 array), and optionally
    channel, well, read_number, start, calibration_offset,
    calibration_scale."""
    run_info = {**{
        "acquisition_id": "run0",
        "sample_id": "sample",
        "flow_cell_id": "FC000",
        "system_name": "sim",
        "sample_rate": 5000,
        "acquisition_start_time": datetime(2026, 1, 1, tzinfo=timezone.utc),
    }, **(run_info or {})}

    reads = list(reads)
    rid_bytes = [uuid.UUID(r["read_id"]).bytes for r in reads]
    signals = [np.ascontiguousarray(r["signal"], np.int16) for r in reads]
    fbin = arrow.fixed_size_binary(16)
    signal_table = [
        ("read_id", fbin, rid_bytes),
        ("signal", arrow.LARGE_BINARY if compress
         else arrow.large_list(arrow.int_type(16, True)),
         [vbz_compress(s) for s in signals] if compress else signals),
        ("samples", arrow.int_type(32, False), [len(s) for s in signals]),
    ]
    u = partial(arrow.int_type, signed=False)
    reads_table = [
        ("read_id", fbin, rid_bytes),
        ("read_number", u(32),
         [r.get("read_number", i) for i, r in enumerate(reads)]),
        ("channel", u(16), [r.get("channel", 1) for r in reads]),
        ("well", u(8), [r.get("well", 1) for r in reads]),
        ("start", u(64), [r.get("start", 0) for r in reads]),
        ("calibration_offset", arrow.FLOAT32,
         [r.get("calibration_offset", 0.0) for r in reads]),
        ("calibration_scale", arrow.FLOAT32,
         [r.get("calibration_scale", 1.0) for r in reads]),
        ("run_info", arrow.int_type(16, True), [0] * len(reads)),
    ]

    def run_info_type(v):  # pyarrow's inference for one value
        if isinstance(v, datetime):
            return arrow.timestamp("ms", "UTC")
        if isinstance(v, str):
            return arrow.UTF8
        if isinstance(v, float):
            return ("float", {"precision": 2})
        return arrow.int_type(64, True)
    run_info_table = [(k, run_info_type(v), [v]) for k, v in run_info.items()]

    file_id = uuid.uuid4()
    section = file_id.bytes
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(section)
        contents = []
        for table, ctype in ((reads_table, CONTENT_READS),
                             (signal_table, CONTENT_SIGNAL),
                             (run_info_table, CONTENT_RUN_INFO)):
            payload = arrow.write_file(table)
            contents.append({"offset": f.tell(), "length": len(payload),
                             "content_type": ctype})
            f.write(payload)
            f.write(b"\x00" * (-len(payload) % 8))
        # <flatbuffer><int64 length><section marker><signature>
        footer = build_footer(contents, file_identifier=str(file_id))
        f.write(footer)
        f.write(len(footer).to_bytes(8, "little"))
        f.write(section)
        f.write(_SIGNATURE)
