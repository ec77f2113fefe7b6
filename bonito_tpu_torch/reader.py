"""
Format-agnostic signal reading, bonito_tpu's (``bonito_tpu/reader.py``)
copied: directory probing, the Read record type and its SAM metadata,
read chunking for ``--save-ctc``. Trim and normalisation live in
``bonito_tpu_torch.signal``; the backends are ``bonito_tpu_torch.pod5``
and ``bonito_tpu_torch.fast5``.

The @RG and tag schema are upstream bonito's (bonito/reader.py:59-86):
BAM equality needs them verbatim.
"""

import sys
from collections import OrderedDict
from glob import iglob
from importlib import import_module

__formats__ = ["pod5", "fast5"]


class Reader:
    """Probe a directory for pod5/fast5 and dispatch to the backend."""

    def __init__(self, directory, recursive=False):
        self.fmt = None
        for fmt in __formats__:
            pattern = f"**/*.{fmt}" if recursive else f"*.{fmt}"
            match = next(iglob(str(directory) + "/" + pattern,
                               recursive=True), None)
            if match is not None:
                self.fmt = fmt
                break
        else:
            raise FileNotFoundError(
                f"no pod5/fast5 files found in {directory}")
        if self.fmt == "fast5":
            sys.stderr.write(
                "DeprecationWarning: fast5 support will be deprecated; "
                "please use pod5\n")
        backend = import_module(f"bonito_tpu_torch.{self.fmt}")
        self._get_reads = backend.get_reads
        self._get_read_groups = backend.get_read_groups

    def get_reads(self, *args, **kwargs):
        return self._get_reads(*args, **kwargs)

    def get_read_groups(self, *args, **kwargs):
        return self._get_read_groups(*args, **kwargs)


class Read:
    """Base read record; backends fill the attributes."""

    read_id = None
    run_id = ""
    filename = ""
    sample_id = "unset"
    exp_start_time = ""
    flow_cell_id = ""
    device_id = ""
    mux = 0
    channel = 0
    read_number = 0
    start = 0.0
    duration = 0.0
    start_time = ""
    sample_rate = 1
    shift = 0.0
    scale = 1.0
    scaling_strategy = "quantile"
    trimmed_samples = 0
    num_samples = 0
    signal = None

    def __repr__(self):
        return "Read('%s')" % self.read_id

    def readgroup(self, model):
        """@RG header line (upstream bonito/reader.py:59-73)."""
        self._groupdict = OrderedDict([
            ("ID", f"{self.run_id}_{model}"),
            ("PL", "ONT"),
            ("DT", f"{self.exp_start_time}"),
            ("PU", f"{self.flow_cell_id}"),
            ("PM", f"{self.device_id}"),
            ("LB", f"{self.sample_id}"),
            ("SM", f"{self.sample_id}"),
            ("DS", "%s" % " ".join([
                f"run_id={self.run_id}",
                f"basecall_model={model}",
            ])),
        ])
        return "\t".join(
            ["@RG", *[f"{k}:{v}" for k, v in self._groupdict.items()]])

    def tagdata(self):
        """Per-read SAM tags (upstream bonito/reader.py:75-86)."""
        return [
            f"mx:i:{self.mux}",
            f"ch:i:{self.channel}",
            f"st:Z:{self.start_time}",
            f"du:f:{self.duration}",
            f"rn:i:{self.read_number}",
            f"f5:Z:{self.filename}",
            f"sm:f:{self.shift}",
            f"sd:f:{self.scale}",
            f"sv:Z:{self.scaling_strategy}",
        ]


class ReadChunk:
    """Fixed-size slice of a read for ``--save-ctc``."""

    def __init__(self, read, chunk, i, n):
        self.read_id = "%s:%i:%i" % (read.read_id, i, n)
        self.run_id = read.run_id
        self.filename = read.filename
        self.mux = read.mux
        self.channel = read.channel
        self.start = read.start
        self.duration = read.duration
        self.template_start = self.start
        self.template_duration = self.duration
        self.signal = chunk

    def __repr__(self):
        return "ReadChunk('%s')" % self.read_id


def read_chunks(read, chunksize=4000, overlap=400):
    """Split a read into fixed-size chunks, the last aligned to its end."""
    if len(read.signal) < chunksize:
        return
    _, offset = divmod(len(read.signal) - chunksize, chunksize - overlap)
    signal = read.signal[offset:]
    step = chunksize - overlap
    n = (len(signal) - chunksize) // step + 1
    for i in range(n):
        yield ReadChunk(read, signal[i * step:i * step + chunksize], i + 1, n)
