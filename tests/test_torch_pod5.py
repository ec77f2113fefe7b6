"""The port's pod5 reader and writer (``bonito_tpu_torch.pod5`` on
``bonito_tpu_torch.arrow``: no pyarrow, zstandard or flatbuffers) against
bonito_tpu's (pyarrow): the same Reads, bit for bit, from bonito_tpu's
files (VBZ and uncompressed, with the footer and without), bonito_tpu's
Reads from the port's files, both from a file in the official pod5 layout
written here with pyarrow, VBZ chunks across the two codecs, and the
refusals (a compressed Arrow body, no libzstd)."""

import io
import subprocess
import sys
import uuid
from datetime import datetime, timezone
from pathlib import Path

import numpy as np
import pyarrow as pa
import pyarrow.ipc
import pytest

from bonito_tpu import pod5 as jp5
from bonito_tpu_torch import arrow
from bonito_tpu_torch import pod5 as tp5

ROOT = Path(__file__).resolve().parent.parent
PA = {"strategy": "pa"}, {"standardise": 1, "mean": 90.0, "stdev": 23.0}
QUANTILE = None, None


def records(seed, lengths=(500, 4000, 12000, 2100)):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lengths):
        pa_ = 90 + 23 * rng.normal(size=n)
        if i % 2:
            pa_[:400] += 160  # trimmed
        out.append({"read_id": str(uuid.UUID(int=rng.integers(1 << 62))),
                    "signal": np.rint(pa_ / 0.17 - 5).astype(np.int16),
                    "calibration_offset": 5.0, "calibration_scale": 0.17,
                    "channel": 3 + i, "well": 1 + i % 4,
                    "read_number": 10 + i, "start": 1234 * i})
    return out


def same_reads(a, b):
    """Reads of both packages equal field for field, the f32 signal bit
    for bit."""
    assert [r.read_id for r in a] == [r.read_id for r in b]
    for x, y in zip(a, b):
        # (readgroup() leaves its fields in _groupdict)
        vx = {k: v for k, v in vars(x).items()
              if k != "signal" and k[0] != "_"}
        vy = {k: v for k, v in vars(y).items()
              if k != "signal" and k[0] != "_"}
        assert vx == vy
        assert {k: type(v) for k, v in vx.items()} == {
            k: type(v) for k, v in vy.items()}
        if x.signal is None:  # a metadata pass reads no signal
            assert y.signal is None
        else:
            assert x.signal.dtype == y.signal.dtype == np.float32
            np.testing.assert_array_equal(x.signal.view(np.uint32),
                                          y.signal.view(np.uint32))
        assert x.tagdata() == y.tagdata()
        assert x.readgroup("m") == y.readgroup("m")


def read_both(path, strategy=PA, do_trim=True):
    scaling, norm = strategy
    jf, tf = jp5.Pod5File(path), tp5.Pod5File(path)
    assert tf.read_ids() == jf.read_ids()
    assert tf.num_reads() == jf.num_reads()
    assert tp5._num_reads_fast(path) == jp5._num_reads_fast(path)
    for row, rid in enumerate(tf.read_ids()):
        b = uuid.UUID(rid).bytes
        np.testing.assert_array_equal(tf.get_signal(b), jf.get_signal(b))
        assert tf.get_signal(b).dtype == np.int16
    kw = dict(scaling_strategy=scaling, norm_params=norm, do_trim=do_trim)
    same_reads([jp5.Read(jf, i, path, **kw) for i in range(jf.num_reads())],
               [tp5.Read(tf, i, path, **kw) for i in range(tf.num_reads())])
    same_reads([jp5.Read(jf, i, path, meta=True)
                for i in range(jf.num_reads())],
               [tp5.Read(tf, i, path, meta=True)
                for i in range(tf.num_reads())])


def strip_footer(path, out):
    """The file with its footer cut, as files written without one are."""
    data = Path(path).read_bytes()
    sig, section = data[-8:], data[-24:-8]
    flen = int.from_bytes(data[-32:-24], "little")
    body = data[:-32 - flen]
    Path(out).write_bytes(body + (0).to_bytes(8, "little") + section + sig)
    assert tp5.parse_footer(Path(out).read_bytes()) is None


@pytest.mark.parametrize("compress", [True, False], ids=["vbz", "raw"])
@pytest.mark.parametrize("footer", [True, False], ids=["footer", "no-footer"])
@pytest.mark.parametrize("strategy", [PA, QUANTILE], ids=["pa", "quantile"])
def test_port_reads_bonito_tpu_files(tmp_path, compress, footer, strategy):
    path = tmp_path / "a.pod5"
    jp5.write_pod5(path, records(1), compress=compress)
    if not footer:
        strip_footer(path, tmp_path / "b.pod5")
        path.unlink()
        path = tmp_path / "b.pod5"
    read_both(path, strategy)
    read_both(path, strategy, do_trim=False)


@pytest.mark.parametrize("compress", [True, False], ids=["vbz", "raw"])
def test_bonito_tpu_reads_port_files(tmp_path, compress):
    path = tmp_path / "a.pod5"
    run_info = {"acquisition_id": "runX", "sample_id": "s9",
                "sample_rate": 4000,
                "acquisition_start_time": datetime(2025, 3, 4, 5, 6, 7,
                                                   tzinfo=timezone.utc)}
    tp5.write_pod5(path, records(2), run_info=run_info, compress=compress)
    read_both(path)
    # and as pyarrow reads it: valid Arrow files of bonito_tpu's types
    data = path.read_bytes()
    footer = jp5.parse_footer(data)
    assert footer["software"] == "bonito_tpu_torch"
    for ef in footer["contents"]:
        table = pa.ipc.open_file(pa.BufferReader(
            data[ef["offset"]:ef["offset"] + ef["length"]])).read_all()
        table.validate(full=True)
        if "samples" in table.schema.names:
            assert str(table.schema.field("signal").type) == (
                "large_binary" if compress else "large_list<item: int16>")


def test_get_reads_streams_alike(tmp_path):
    """Both packages' ``get_reads`` over a directory of two files, in the
    reader's own process, and through the port's spawned workers."""
    jp5.write_pod5(tmp_path / "a.pod5", records(3))
    jp5.write_pod5(tmp_path / "b.pod5", records(4, (900, 30, 7000)),
                   compress=False)
    scaling, norm = PA
    kw = dict(scaling_strategy=scaling, norm_params=norm)
    ref = list(jp5.get_reads(tmp_path, n_proc=1, **kw))
    same_reads(ref, list(tp5.get_reads(tmp_path, n_proc=1, **kw)))
    same_reads(ref, list(tp5.get_reads(tmp_path, n_proc=2, **kw)))
    ids = {ref[1].read_id, ref[4].read_id}
    for skip in (False, True):
        same_reads(list(jp5.get_reads(tmp_path, read_ids=ids, skip=skip,
                                      **kw)),
                   list(tp5.get_reads(tmp_path, read_ids=ids, skip=skip,
                                      **kw)))
    assert (tp5.get_read_groups(tmp_path, "m")
            == jp5.get_read_groups(tmp_path, "m"))


# ---------------------------------------------------------------------------
# the official layout
# ---------------------------------------------------------------------------

def _arrow_file(table, max_chunksize=None, **options):
    sink = io.BytesIO()
    with pa.ipc.new_file(sink, table.schema,
                         options=pa.ipc.IpcWriteOptions(**options)) as w:
        w.write_table(table, max_chunksize=max_chunksize)
    return sink.getvalue()


def _ext(name):
    return {"ARROW:extension:name": name, "ARROW:extension:metadata": ""}


def official_pod5(path, recs, chunk=1500):
    """A pod5 file in the official layout (pod5 format 0.3): uuid
    extension read ids, the reads table's signal as list<uint64> of
    signal-table rows, run_info, pore_type and end_reason
    dictionary-encoded, bool and map columns, nulls, the signal split in
    chunks of ``chunk`` samples over several record batches."""
    rid = pa.field("read_id", pa.binary(16),
                   metadata=_ext("minknow.uuid"))
    sig_ids, sig_chunks, sig_samples, rows = [], [], [], []
    for r in recs:
        rows.append([])
        s = r["signal"]
        for lo in range(0, len(s), chunk):
            rows[-1].append(len(sig_ids))
            sig_ids.append(uuid.UUID(r["read_id"]).bytes)
            sig_chunks.append(jp5.vbz_compress(s[lo:lo + chunk]))
            sig_samples.append(len(s[lo:lo + chunk]))
    signal = pa.table([pa.array(sig_ids, pa.binary(16)),
                       pa.array(sig_chunks, pa.large_binary()),
                       pa.array(sig_samples, pa.uint32())],
                      schema=pa.schema([
                          rid, pa.field("signal", pa.large_binary(),
                                        metadata=_ext("minknow.vbz")),
                          pa.field("samples", pa.uint32())]))
    n = len(recs)
    dictionary = lambda values: pa.array(values).dictionary_encode()
    offset = [r["calibration_offset"] for r in recs]
    offset[1] = None  # null: the column's default, 0.0
    well = [r["well"] for r in recs]
    well[2] = None
    reads = pa.table([
        pa.array([uuid.UUID(r["read_id"]).bytes for r in recs],
                 pa.binary(16)),
        pa.array(rows, pa.list_(pa.uint64())),
        pa.array([r["read_number"] for r in recs], pa.uint32()),
        pa.array([r["start"] for r in recs], pa.uint64()),
        pa.array([1.5] * n, pa.float32()),
        pa.array([r["channel"] for r in recs], pa.uint16()),
        pa.array(well, pa.uint8()),
        dictionary(["not_set"] * n),
        pa.array(offset, pa.float32()),
        pa.array([r["calibration_scale"] for r in recs], pa.float32()),
        dictionary(["signal_positive", "unknown"] * (n // 2) + ["unknown"]
                   * (n % 2)),
        pa.array([False, True] * (n // 2) + [False] * (n % 2)),
        dictionary(["acq-1"] * n),
        pa.array([len(r["signal"]) for r in recs], pa.uint64()),
    ], schema=pa.schema([
        rid, pa.field("signal", pa.list_(pa.uint64())),
        pa.field("read_number", pa.uint32()), pa.field("start", pa.uint64()),
        pa.field("median_before", pa.float32()),
        pa.field("channel", pa.uint16()), pa.field("well", pa.uint8()),
        pa.field("pore_type", pa.dictionary(pa.int16(), pa.string())),
        pa.field("calibration_offset", pa.float32()),
        pa.field("calibration_scale", pa.float32()),
        pa.field("end_reason", pa.dictionary(pa.int16(), pa.string())),
        pa.field("end_reason_forced", pa.bool_()),
        pa.field("run_info", pa.dictionary(pa.int16(), pa.string())),
        pa.field("num_samples", pa.uint64())]))
    start = datetime(2024, 5, 6, 7, 8, 9, 123000, tzinfo=timezone.utc)
    run_info = pa.table({
        "acquisition_id": ["acq-0", "acq-1"],
        "acquisition_start_time": pa.array([start, start],
                                           pa.timestamp("ms", tz="UTC")),
        "adc_max": pa.array([4095, 4095], pa.int16()),
        "context_tags": pa.array([[("k", "v")], []],
                                 pa.map_(pa.string(), pa.string())),
        "flow_cell_id": ["FC0", "FC1"],
        "sample_id": [None, "sample-1"],
        "sample_rate": pa.array([5000, 4000], pa.uint16()),
        "system_name": ["sys0", "sys1"],
        "tracking_id": pa.array([[("a", "b")], [("c", "d")]],
                                pa.map_(pa.string(), pa.string())),
    })
    section = uuid.uuid4().bytes
    with open(path, "wb") as f:
        f.write(jp5._SIGNATURE + section)
        contents = []
        for table, ctype, size in ((signal, jp5.CONTENT_SIGNAL, 2),
                                   (run_info, jp5.CONTENT_RUN_INFO, None),
                                   (reads, jp5.CONTENT_READS, 3)):
            payload = _arrow_file(table, max_chunksize=size)
            contents.append({"offset": f.tell(), "length": len(payload),
                             "content_type": ctype})
            f.write(payload + b"\0" * (-len(payload) % 8))
        footer = jp5.build_footer(contents, str(uuid.uuid4()))
        f.write(footer + len(footer).to_bytes(8, "little") + section
                + jp5._SIGNATURE)


def test_official_layout_read_alike(tmp_path):
    path = tmp_path / "official.pod5"
    official_pod5(path, records(5, (700, 5200, 3100, 2000, 90)))
    f = tp5.Pod5File(path)
    assert len(f.signal._batches) > 1 and len(f.reads._batches) > 1
    assert f.reads.column("run_info")[0] == "acq-1"
    assert f.reads.column("calibration_offset")[1] is None
    read_both(path)
    read_both(path, QUANTILE)
    r = tp5.Read(f, 1, path)
    assert (r.sample_rate, r.run_id, r.sample_id, r.well if hasattr(
        r, "well") else r.mux) == (4000, "acq-1", "sample-1", 2)


# ---------------------------------------------------------------------------
# arrow, VBZ and the refusals
# ---------------------------------------------------------------------------

def test_arrow_columns_match_pyarrow():
    """Every column kind pod5 files hold, with nulls, over record batches
    of 3 rows, read as pyarrow reads them."""
    t = pa.table({
        "i16": pa.array([1, None, 3, -4, 5, 6, 7], pa.int16()),
        "u64": pa.array([1 << 40, 2, 3, 4, 5, 6, 7], pa.uint64()),
        "f32": pa.array([0.5, 1.25, None, 3, 4, 5, 6], pa.float32()),
        "utf8": pa.array(["x", "yy", None, "z", "", "q", "w"]),
        "bin": pa.array([b"ab", b"", None, b"c", b"d", b"e", b"f"],
                        pa.large_binary()),
        "list": pa.array([[1, 2], [], [3], None, [7], [8], [9]],
                         pa.list_(pa.uint64())),
        "llist": pa.array([[1], [2, 3], [], [4], [5], [6], [-7]],
                          pa.large_list(pa.int16())),
        "dict": pa.array(["r1", "r2", "r1", None, "r1", "r2", "r3"])
        .dictionary_encode(),
        "bool": pa.array([True, False, None, True, True, False, True]),
        "ts": pa.array([datetime(2026, 1, 2, 3, tzinfo=timezone.utc)] * 7,
                       pa.timestamp("ms", tz="UTC")),
        "fsb": pa.array([bytes([i]) * 16 for i in range(7)], pa.binary(16)),
        "map": pa.array([[("k", "v")]] * 7, pa.map_(pa.string(),
                                                   pa.string())),
        "after": pa.array(np.arange(7, dtype=np.float64)),
    })
    f = arrow.ArrowFile(_arrow_file(t, max_chunksize=3))
    assert f.num_rows == 7 and len(f._batches) == 3
    for name in f.names:
        if name == "map":  # laid out, not decoded
            continue
        got = [bytes(v) if isinstance(v, memoryview)
               else v.tolist() if isinstance(v, np.ndarray) else v
               for v in f.column(name).to_list()]
        assert got == t.column(name).to_pylist(), name
    np.testing.assert_array_equal(f.column("u64").numpy(),
                                  t.column("u64").to_numpy())
    assert f.column("i16").valid().tolist() == [
        v is not None for v in t.column("i16").to_pylist()]


@pytest.mark.parametrize("codec", ["zstd", "lz4"])
def test_compressed_arrow_body_raises(codec):
    t = pa.table({"a": pa.array(np.arange(100, dtype=np.int32))})
    with pytest.raises(arrow.ArrowError, match="compressed"):
        arrow.ArrowFile(_arrow_file(t, compression=codec))


def test_vbz_across_codecs():
    """The port's VBZ decodes bonito_tpu's chunks and the reverse, with the
    extreme deltas of tests/test_pod5.py (|delta| above 32767 wraps in
    int16)."""
    rng = np.random.default_rng(0)
    for sig in (np.array([32767, -32768, 100, -30000, 30000], np.int16),
                rng.integers(-32768, 32768, 4000).astype(np.int16),
                rng.integers(-300, 300, 20001).astype(np.int16),
                np.empty(0, np.int16)):
        np.testing.assert_array_equal(
            tp5.vbz_decompress(jp5.vbz_compress(sig), len(sig)), sig)
        np.testing.assert_array_equal(
            jp5.vbz_decompress(tp5.vbz_compress(sig), len(sig)), sig)
    with pytest.raises(ValueError, match="corrupt"):
        tp5.vbz_decompress(b"not zstd at all", 10)


def test_no_libzstd_raises(tmp_path, monkeypatch):
    """Without libzstd a VBZ chunk raises, naming it; the reader lets
    that through where it warns and goes on for a bad read."""
    path = tmp_path / "a.pod5"
    jp5.write_pod5(path, records(6, (300,)))
    monkeypatch.setattr(tp5, "_zstd", None)
    monkeypatch.setattr(tp5.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(tp5.LibraryMissing, match="libzstd"):
        tp5.vbz_decompress(b"", 0)
    with pytest.raises(tp5.LibraryMissing, match="libzstd"):
        list(tp5.get_reads(tmp_path))


def test_reading_pod5_imports_no_pyarrow(tmp_path):
    """(tqdm is left out: torch imports it where it is installed; no
    module of the port does, tests/test_torch_imports.py)"""
    path = tmp_path / "a.pod5"
    jp5.write_pod5(path, records(7, (800, 900)))
    code = ("import sys; from bonito_tpu_torch import pod5; "
            f"reads = list(pod5.get_reads({str(tmp_path)!r})); "
            "assert len(reads) == 2 and reads[0].signal.size; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('pyarrow', 'zstandard', 'flatbuffers', 'h5py', 'jax', "
            "'bonito_tpu')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
