"""
Training data loading: the port's own copy of bonito_tpu's ``data.py``
for one process (multi-GPU training, with its per-process share of the
chunks, is a later slice).

A dataset directory holds ``chunks.npy`` [N, T] (signal),
``references.npy`` [N, L] (uint8 labels, A=1..T=4, 0-padded) and
``reference_lengths.npy`` [N]; an optional ``validation/`` subdirectory
holds a held-out split, else the last 3% of the chunks (or
``--valid-chunks`` of them) are. An optional ``indices.npy`` selects and
orders rows. A directory may instead ship a ``dataset.py`` plugin exposing
a ``Loader`` class.

Loaders are plain numpy batch iterators. The npy files open memory-mapped;
a share bounded by ``--chunks`` is read into memory up front, since
shuffled fancy indexing over a raw memory map is seek-bound on disk.
"""

import importlib.util
import os
import sys
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class DataSettings:
    training_data: str
    num_train_chunks: int
    num_valid_chunks: int
    output_dir: str


@dataclass
class ComputeSettings:
    batch_size: int
    num_workers: int = 0
    seed: int = 25


@dataclass
class ModelSetup:
    n_pre_context_bases: int
    n_post_context_bases: int
    standardisation: dict


class ChunkDataSet:
    def __init__(self, chunks, targets, lengths):
        self.chunks = chunks
        self.targets = targets
        self.lengths = lengths

    def __len__(self):
        return len(self.lengths)

    def __getitem__(self, i):
        return (
            np.asarray(self.chunks[i], dtype=np.float32)[..., None],
            np.asarray(self.targets[i], dtype=np.int32),
            np.asarray(self.lengths[i], dtype=np.int32),
        )


class NumpyBatchLoader:
    """Shuffling fixed-size batch iterator over a ChunkDataSet: batches of
    (chunks [B, T, 1] f32, targets [B, L] int32, lengths [B] int32)."""

    def __init__(self, dataset, batch_size, shuffle=True, seed=25,
                 drop_last=True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def __iter__(self):
        n = len(self.dataset)
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for i in range(0, n - (n % self.batch_size if self.drop_last else 0),
                       self.batch_size):
            idx = np.sort(order[i:i + self.batch_size])
            chunks = np.asarray(self.dataset.chunks[idx], dtype=np.float32)
            if chunks.ndim == 2:
                chunks = chunks[..., None]
            yield (
                chunks,
                np.asarray(self.dataset.targets[idx], dtype=np.int32),
                np.asarray(self.dataset.lengths[idx], dtype=np.int32),
            )


def load_numpy_datasets(limit=None, directory=None):
    """(chunks, targets, lengths), memory-mapped, with ``indices.npy``
    applied when present; a share bounded by ``limit`` is read into
    memory."""
    chunks = np.load(os.path.join(directory, "chunks.npy"), mmap_mode="r")
    targets = np.load(os.path.join(directory, "references.npy"), mmap_mode="r")
    lengths = np.load(os.path.join(directory, "reference_lengths.npy"),
                      mmap_mode="r")
    indices = os.path.join(directory, "indices.npy")
    if os.path.exists(indices):
        idx = np.load(indices, mmap_mode="r")
        idx = idx[idx < len(lengths)]
        if limit:
            idx = idx[:limit]
        return (np.array(chunks[idx]), np.array(targets[idx]),
                np.array(lengths[idx]))
    if limit:
        return (np.array(chunks[:limit]), np.array(targets[:limit]),
                np.array(lengths[:limit]))
    # unbounded (--chunks 0): stay memory-mapped, a training set can exceed
    # host memory; the loader copies only the rows a batch takes
    return chunks, targets, lengths


def load_numpy(limit, directory, valid_limit=None):
    """(train, valid) ChunkDataSets from an npy directory."""
    train_data = load_numpy_datasets(limit=limit, directory=directory)
    if os.path.exists(os.path.join(directory, "validation")):
        valid_data = load_numpy_datasets(
            limit=valid_limit, directory=os.path.join(directory, "validation"))
    else:
        print("[validation set not found: splitting training set]",
              file=sys.stderr)
        if valid_limit is None:
            split = np.floor(len(train_data[0]) * 0.97).astype(np.int32)
        else:
            # an explicit --valid-chunks carves that many chunks off the
            # end of the training set
            split = max(0, len(train_data[0]) - valid_limit)
        valid_data = [x[split:] for x in train_data]
        train_data = [x[:split] for x in train_data]
    return ChunkDataSet(*train_data), ChunkDataSet(*valid_data)


def load_script(directory, name="loader", suffix="dataset.py", **kwargs):
    """A dataset plugin: ``Loader(**kwargs)`` of the directory's
    ``dataset.py``."""
    directory = Path(directory)
    filepath = directory / suffix if directory.is_dir() else directory
    spec = importlib.util.spec_from_file_location(name, filepath)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.Loader(**kwargs)


def load_data(data: DataSettings, setup: ModelSetup, compute: ComputeSettings):
    """(train_loader, valid_loader) from an npy directory or a
    ``dataset.py`` plugin; npy chunks win when both are present, a
    directory with neither raises."""
    directory = data.training_data
    has_npy = (Path(directory) / "chunks.npy").exists()
    has_plugin = (Path(directory) / "dataset.py").exists()
    if not has_npy and not has_plugin:
        raise FileNotFoundError(
            f"no suitable training data in {directory}: expected "
            f"chunks.npy/references.npy/reference_lengths.npy or dataset.py")
    if not has_npy:
        loader = load_script(
            directory,
            n_pre_context_bases=setup.n_pre_context_bases,
            n_post_context_bases=setup.n_post_context_bases,
            standardisation=setup.standardisation,
        )
        return (loader.train_loader(batch_size=compute.batch_size,
                                    chunks=data.num_train_chunks),
                loader.valid_loader(batch_size=compute.batch_size,
                                    chunks=data.num_valid_chunks))

    train_set, valid_set = load_numpy(
        data.num_train_chunks, directory, valid_limit=data.num_valid_chunks)
    train_loader = NumpyBatchLoader(
        train_set, compute.batch_size, shuffle=True, seed=compute.seed)
    valid_loader = NumpyBatchLoader(
        valid_set, compute.batch_size, shuffle=False, drop_last=False)
    return train_loader, valid_loader
