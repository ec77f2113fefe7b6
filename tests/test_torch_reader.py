"""The port's signal conditioning, fast5 reader, ``Reader`` and pipeline
maps against bonito_tpu's: ``trim``, ``normalisation`` and
``apply_standardisation`` bit for bit on quantile and pa configs, with and
without the trim; fast5 files written with h5py read alike (multi-read and
the legacy single-read layout); the directory probe and ``read_chunks``;
``thread_map``/``process_map`` and their item and star forms, in order and
failing fast."""

import uuid

import numpy as np
import pytest

from bonito_tpu import fast5 as jf5
from bonito_tpu import pipeline as jpipe
from bonito_tpu import reader as jreader
from bonito_tpu import signal as jsignal
from bonito_tpu_torch import fast5 as tf5
from bonito_tpu_torch import pipeline as tpipe
from bonito_tpu_torch import reader as treader
from bonito_tpu_torch import signal as tsignal

CONFIGS = {
    "quantile-default": (None, None),
    "quantile": ({"strategy": "quantile"},
                 {"quantile_a": 0.1, "quantile_b": 0.8,
                  "shift_multiplier": 0.5, "scale_multiplier": 0.6}),
    "pa": ({"strategy": "pa"}, {"standardise": 1, "mean": 90.0,
                                 "stdev": 23.0}),
    "pa-off": ({"strategy": "pa"}, {"standardise": 0}),
}


def pa_signal(seed, n, adapter=True):
    rng = np.random.default_rng(seed)
    x = (90 + 23 * rng.normal(size=n)).astype(np.float32)
    if adapter:
        x[:300] += 160
    return x


class _Read:
    start, duration, sample_rate = 1.5, 2.0, 5000


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("do_trim", [True, False])
@pytest.mark.parametrize("seed,n", [(0, 20000), (1, 900), (2, 5)])
def test_standardisation_is_bonito_tpu_s(config, do_trim, seed, n):
    scaling, norm = CONFIGS[config]
    x = pa_signal(seed, n, adapter=seed != 1)
    assert tsignal.normalisation(x, scaling, norm) == \
        jsignal.normalisation(x, scaling, norm)
    a = tsignal.apply_standardisation(_Read(), x, scaling, norm, do_trim)
    b = jsignal.apply_standardisation(_Read(), x, scaling, norm, do_trim)
    assert vars(a).keys() == vars(b).keys()
    for k in vars(a):
        if k != "signal":
            assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.signal.view(np.uint32),
                                  b.signal.view(np.uint32))
    for kw in ({}, {"threshold": 1.0, "window_size": 20}, {"max_trim": 0.05}):
        assert tsignal.trim(x, **kw) == jsignal.trim(x, **kw)


def test_unknown_strategy_and_missing_flag_raise():
    x = pa_signal(0, 100)
    for mod in (tsignal, jsignal):
        with pytest.raises(ValueError, match="not supported"):
            mod.normalisation(x, {"strategy": "mad"})
        with pytest.raises(ValueError, match="standardisation flag"):
            mod.normalisation(x, {"strategy": "pa"}, {})


def write_fast5(path, reads, legacy=False):
    """A multi-read fast5 (or the legacy single-read layout) with h5py,
    one ``read_<id>`` group a read with Raw, channel_id and tracking_id."""
    import h5py
    with h5py.File(path, "w") as f:
        for i, (rid, sig) in enumerate(reads):
            if legacy:
                grp = f.create_group(f"Raw/Reads/Read_{i}")
                raw, key = grp, f.require_group("UniqueGlobalKey")
                channel = key.require_group("channel_id")
                tracking = key.require_group("tracking_id")
            else:
                grp = f.create_group(f"read_{rid}")
                raw = grp.create_group("Raw")
                channel = grp.create_group("channel_id")
                tracking = grp.create_group("tracking_id")
            raw.create_dataset("Signal", data=sig)
            raw.attrs.update({"read_id": rid.encode(), "read_number": 7 + i,
                              "start_mux": 1 + i % 4,
                              "start_time": 4000 * i})
            channel.attrs.update({"channel_number": str(20 + i).encode(),
                                  "digitisation": 2048.0,
                                  "offset": -10.0, "range": 400.0,
                                  "sampling_rate": 4000.0})
            tracking.attrs.update({"run_id": b"runF",
                                   "exp_start_time": b"2024-02-03T04:05:06Z",
                                   "flow_cell_id": b"FCF",
                                   "device_id": b"devF", "sample_id": b"sF"})


def fast5_reads(seed, lengths):
    out = []
    for i, n in enumerate(lengths):
        sig = pa_signal(seed + i, n, adapter=bool(i % 2))
        out.append((str(uuid.UUID(int=seed * 100 + i)),
                    np.rint(sig / (400 / 2048) + 10).astype(np.int16)))
    return out


def same_reads(a, b):
    assert [r.read_id for r in a] == [r.read_id for r in b]
    for x, y in zip(a, b):
        vx = {k: v for k, v in vars(x).items() if k != "signal"
              and k[0] != "_"}
        vy = {k: v for k, v in vars(y).items() if k != "signal"
              and k[0] != "_"}
        assert vx == vy
        if x.signal is not None:
            np.testing.assert_array_equal(x.signal.view(np.uint32),
                                          y.signal.view(np.uint32))
        assert x.tagdata() == y.tagdata() and \
            x.readgroup("m") == y.readgroup("m")


@pytest.mark.parametrize("config", ["pa", "quantile-default"])
def test_fast5_read_alike(tmp_path, config):
    scaling, norm = CONFIGS[config]
    write_fast5(tmp_path / "a.fast5", fast5_reads(1, [3000, 12000, 500]))
    write_fast5(tmp_path / "b.fast5", fast5_reads(2, [7000]), legacy=True)
    kw = dict(scaling_strategy=scaling, norm_params=norm)
    ref = list(jf5.get_reads(tmp_path, n_proc=0, **kw))
    assert len(ref) == 4
    # one spawned reader process once, else in this process
    same_reads(ref, list(tf5.get_reads(tmp_path, n_proc=int(config == "pa"),
                                       **kw)))
    ids = {ref[0].read_id, ref[3].read_id}
    same_reads(list(jf5.get_reads(tmp_path, read_ids=ids, skip=True,
                                  n_proc=0, **kw)),
               list(tf5.get_reads(tmp_path, read_ids=ids, skip=True,
                                  n_proc=0, **kw)))
    assert (tf5.get_read_groups(tmp_path, "m", n_proc=0)
            == jf5.get_read_groups(tmp_path, "m", n_proc=0))


def test_fast5_without_h5py_names_it(tmp_path, monkeypatch):
    import builtins
    real = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == "h5py":
            raise ImportError("No module named 'h5py'")
        return real(name, *a, **k)
    write_fast5(tmp_path / "a.fast5", fast5_reads(3, [100]))
    monkeypatch.setattr(builtins, "__import__", no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        list(tf5.get_reads(tmp_path, n_proc=0))


def test_reader_probes_like_bonito_tpu(tmp_path):
    with pytest.raises(FileNotFoundError):
        treader.Reader(tmp_path)
    (tmp_path / "sub").mkdir()
    write_fast5(tmp_path / "sub" / "a.fast5", fast5_reads(4, [100]))
    with pytest.raises(FileNotFoundError):
        treader.Reader(tmp_path)
    r = treader.Reader(tmp_path, recursive=True)
    assert r.fmt == jreader.Reader(tmp_path, recursive=True).fmt == "fast5"
    from bonito_tpu_torch.pod5 import write_pod5
    write_pod5(tmp_path / "a.pod5", [{"read_id": str(uuid.UUID(int=1)),
                                      "signal": np.zeros(10, np.int16)}])
    r = treader.Reader(tmp_path, recursive=True)
    assert r.fmt == jreader.Reader(tmp_path, recursive=True).fmt == "pod5"
    assert r.get_reads.__self__ is r


@pytest.mark.parametrize("n,chunksize,overlap", [
    (10000, 4000, 400), (4000, 4000, 400), (3999, 4000, 400),
    (12345, 1000, 200)])
def test_read_chunks_is_bonito_tpu_s(n, chunksize, overlap):
    read = jreader.Read()
    read.read_id, read.signal = "r", np.arange(n, dtype=np.float32)
    read.start, read.duration = 1.0, 2.0
    a = list(treader.read_chunks(read, chunksize, overlap))
    b = list(jreader.read_chunks(read, chunksize, overlap))
    assert [c.read_id for c in a] == [c.read_id for c in b]
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.signal, y.signal)
        assert vars(x).keys() == vars(y).keys()


def _square(x):
    return x * x


def _fail_at_7(x):
    if x == 7:
        raise ValueError("item 7")
    return x


def _add(a, b):
    return a + b


@pytest.mark.parametrize("n_workers", [0, 1, 3])
def test_maps_keep_order_and_fail_fast(n_workers):
    items = [(i, i) for i in range(40)]
    ref = list(jpipe.thread_map(_square, iter(items), n_thread=n_workers))
    assert list(tpipe.thread_map(_square, iter(items),
                                 n_thread=n_workers)) == ref
    assert list(tpipe.thread_starmap(_add, ((i, (i, 1)) for i in range(9)),
                                     n_thread=n_workers)) == list(
        jpipe.thread_starmap(_add, ((i, (i, 1)) for i in range(9)),
                             n_thread=n_workers))
    assert list(tpipe.thread_itemmap(_add, iter(items), n_thread=n_workers)) \
        == list(jpipe.thread_itemmap(_add, iter(items), n_thread=n_workers))
    with pytest.raises(ValueError, match="item 7"):
        list(tpipe.thread_map(_fail_at_7, iter(items), n_thread=n_workers))
    assert list(tpipe.process_itemmap(_add, iter(items), n_proc=0)) == list(
        jpipe.process_itemmap(_add, iter(items), n_proc=0))


def test_process_maps_are_spawned_and_fail_fast():
    """Spawned workers: the order, a worker's error as a RuntimeError
    carrying its traceback, and process_iter. The functions are builtins,
    so that a worker does not import this module (and JAX)."""
    items = [(i, str(i)) for i in range(30)]
    assert tpipe._MP.get_start_method() == "spawn"
    assert list(tpipe.process_map(int, iter(items), n_proc=2)) == list(
        jpipe.process_map(int, iter(items), n_proc=0))
    items[7] = (7, "seven")
    with pytest.raises(RuntimeError, match="seven"):
        list(tpipe.process_map(int, iter(items), n_proc=2))
    assert list(tpipe.process_iter(range(5))) == list(range(5))
