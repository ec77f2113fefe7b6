"""
Fast5 (HDF5) read backend, bonito_tpu's (``bonito_tpu/fast5.py``) copied:
h5py directly, one ``read_<id>`` group per read with Raw/Signal,
channel_id and tracking_id. h5py is imported inside the functions that
read, so that the package imports without it; reading a fast5 directory on
a machine without h5py raises an ImportError that names it.

Behaviour is upstream bonito's (bonito/fast5.py): pA scaling
``scaling * (raw + offset)``, quantile or pa standardisation, trim, and
files parsed in worker processes.
"""

import sys
from datetime import timedelta, timezone
from glob import glob
from pathlib import Path

import numpy as np

from bonito_tpu_torch.pipeline import process_map
from bonito_tpu_torch.reader import Read as BaseRead
from bonito_tpu_torch.signal import apply_standardisation

# reads per work item of the reader processes (pod5 too)
READ_BLOCK = 8


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("reading fast5 files needs h5py, which is not "
                          "installed; convert the reads to pod5") from e
    return h5py


def _attr(obj, key, default=None):
    v = obj.attrs.get(key, default)
    if isinstance(v, (bytes, np.bytes_)):
        return v.decode()
    return v


def _parse_time(s):
    from datetime import datetime
    try:
        return datetime.fromisoformat(s.replace("Z", "+00:00"))
    except ValueError:
        from dateutil import parser
        return parser.parse(s)


class Read(BaseRead):

    def __init__(self, group, filename, meta=False, do_trim=True,
                 scaling_strategy=None, norm_params=None):
        self.meta = meta
        self.read_id = _attr(group["Raw"], "read_id")
        self.filename = Path(filename).name

        tracking = group["tracking_id"]
        self.run_id = _attr(tracking, "run_id", "")
        self.sample_id = _attr(tracking, "sample_id", "unset")
        self.exp_start_time = (
            _attr(tracking, "exp_start_time", "") or "").replace("Z", "")
        self.flow_cell_id = _attr(tracking, "flow_cell_id", "")
        self.device_id = _attr(tracking, "device_id", "")

        if self.meta:
            return

        raw_grp = group["Raw"]
        channel = group["channel_id"]

        self.offset = int(_attr(channel, "offset", 0))
        self.sample_rate = _attr(channel, "sampling_rate", 1)
        digitisation = _attr(channel, "digitisation", 1) or 1
        self.scaling = _attr(channel, "range", 1) / digitisation

        self.mux = int(_attr(raw_grp, "start_mux", 0))
        self.read_number = int(_attr(raw_grp, "read_number", 0))
        self.channel = _attr(channel, "channel_number", "0")

        self.start = _attr(raw_grp, "start_time", 0) / self.sample_rate
        self.duration = raw_grp["Signal"].shape[0] / self.sample_rate
        if self.exp_start_time:
            start_dt = (_parse_time(self.exp_start_time)
                        + timedelta(seconds=float(self.start)))
            if start_dt.tzinfo is None:
                start_dt = start_dt.replace(tzinfo=timezone.utc)
            self.start_time = start_dt.astimezone(
                timezone.utc).isoformat(timespec="milliseconds")

        raw = raw_grp["Signal"][:]
        scaled = np.array(self.scaling * (raw + self.offset),
                          dtype=np.float32)
        apply_standardisation(self, scaled, scaling_strategy, norm_params,
                              do_trim=do_trim)


def _iter_read_groups(f5):
    if "Raw" in f5:  # single-read legacy layout
        reads = f5["Raw/Reads"]
        for name in reads:
            yield {"Raw": reads[name],
                   "channel_id": f5["UniqueGlobalKey/channel_id"],
                   "tracking_id": f5["UniqueGlobalKey/tracking_id"]}
    else:
        for name in f5:
            if name.startswith("read_"):
                yield f5[name]


def _filter(read_id, read_ids, skip):
    return read_ids is None or (read_id in read_ids) ^ skip


def _read_file(args):
    """Worker: the Reads of (filename, read_ids, skip, do_trim,
    scaling_strategy, norm_params, meta[, names]); ``names``, a block of
    read groups, keeps one work item small."""
    (filename, read_ids, skip, do_trim, scaling_strategy, norm_params,
     meta) = args[:7]
    names = args[7] if len(args) > 7 else None
    h5py = _h5py()
    out = []
    try:
        with h5py.File(filename, "r") as f5:
            groups = ((f5[n] for n in names) if names is not None
                      else _iter_read_groups(f5))
            for grp in groups:
                rid = _attr(grp["Raw"], "read_id")
                if not _filter(rid, read_ids, skip):
                    continue
                try:
                    out.append(Read(grp, filename, meta=meta, do_trim=do_trim,
                                    scaling_strategy=scaling_strategy,
                                    norm_params=norm_params))
                except Exception as e:  # noqa: BLE001 — one bad read
                    sys.stderr.write(f"> warning: {filename} {rid} - {e}\n")
    except OSError as e:
        sys.stderr.write(f"> warning: {filename} - {e}\n")
    return out


def _read_blocks(files, block=READ_BLOCK):
    """(filename, names) work items of about ``block`` reads; a legacy
    single-read file is one whole-file item."""
    h5py = _h5py()
    for filename in files:
        try:
            with h5py.File(filename, "r") as f5:
                if "Raw" in f5:  # legacy single-read layout
                    yield filename, None
                    continue
                names = [n for n in f5 if n.startswith("read_")]
        except OSError as e:
            sys.stderr.write(f"> warning: {filename} - {e}\n")
            continue
        for i in range(0, len(names), block):
            yield filename, names[i:i + block]


def _files(directory, recursive=False):
    pattern = "**/*.fast5" if recursive else "*.fast5"
    return sorted(glob(str(Path(directory) / pattern), recursive=recursive))


def get_read_groups(directory, model, read_ids=None, skip=False, n_proc=1,
                    recursive=False, cancel=None):
    """Unique @RG lines and the filtered read count
    (upstream bonito/fast5.py:109-126)."""
    groups = set()
    num_reads = 0
    args = [(f, read_ids, skip, False, None, None, True)
            for f in _files(directory, recursive)]
    for _, reads in process_map(_read_file,
                                ((i, a) for i, a in enumerate(args)),
                                n_proc=n_proc):
        num_reads += len(reads)
        for read in reads:
            groups.add(read.readgroup(model))
        if cancel is not None and cancel.is_set():
            break
    return sorted(groups), num_reads


def get_reads(directory, read_ids=None, skip=False, max_read_size=0,
              n_proc=1, recursive=False, cancel=None, do_trim=True,
              scaling_strategy=None, norm_params=None):
    """Stream the Reads of every fast5 file in ``directory``."""
    args = ((f, read_ids, skip, do_trim, scaling_strategy, norm_params,
             False, names)
            for f, names in _read_blocks(_files(directory, recursive)))
    for _, reads in process_map(_read_file,
                                ((i, a) for i, a in enumerate(args)),
                                n_proc=n_proc, maxsize=4):
        for read in reads:
            if max_read_size > 0 and len(read.signal) > max_read_size:
                sys.stderr.write(
                    f"> skipping long read {read.read_id} "
                    f"({len(read.signal)} samples)\n")
                continue
            yield read
            if cancel is not None and cancel.is_set():
                return
