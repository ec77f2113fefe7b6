"""
Output layer of the port. So far the training logs: ``CSVLogger``, a copy
of bonito_tpu's (``bonito_tpu/io.py``). The SAM/BAM/fastq writers wait for
the ``basecaller`` CLI slice.
"""

import csv
import os


class CSVLogger:
    """Append-only CSV sink for per-step/per-epoch metrics (the training
    logs ``losses_N.csv`` and ``training.csv``).

    The column set is fixed by the first row appended — or, when resuming
    into an existing file, by its header line — and later rows are
    projected onto it, "-" filling any missing field. Writes are flushed
    in batches so per-step logging stays cheap."""

    FLUSH_EVERY = 100

    def __init__(self, filename, sep=","):
        self.filename = str(filename)
        self.sep = sep
        self.columns = self._existing_header()
        self.fh = open(self.filename, "a", newline="")
        self._unflushed = 0

    def _existing_header(self):
        if not os.path.exists(self.filename):
            return None
        with open(self.filename, newline="") as f:
            header = next(csv.reader(f, delimiter=self.sep), None)
        return header or None

    def _write_fields(self, fields):
        csv.writer(self.fh, delimiter=self.sep).writerow(fields)

    def set_columns(self, columns):
        if self.columns:
            raise Exception("columns already set")
        self.columns = list(columns)
        self._write_fields(self.columns)

    def append(self, row):
        if self.columns is None:
            self.set_columns(row.keys())
        self._write_fields([row.get(name, "-") for name in self.columns])
        self._unflushed += 1
        if self._unflushed > self.FLUSH_EVERY:
            self.fh.flush()
            self._unflushed = 0

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
