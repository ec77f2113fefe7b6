"""
Host-side utilities: signal chunking/stitching, batch bookkeeping, model
loading, the training helpers (``init``, ``decode_ref``, ``accuracy``) and
the writers' (``revcomp``, ``mean_qscore_from_qstring``,
``column_to_set``). The chunk/stitch arithmetic is bonito_tpu's (and
upstream bonito's) exactly, so stitched strings agree at chunk junctions.
"""

import os
import random
import re
import glob as _glob
from collections import defaultdict
from importlib import import_module
from itertools import groupby
from operator import itemgetter
from pathlib import Path
from types import ModuleType

import numpy as np

__dir__ = Path(__file__).parent
__models_dir__ = __dir__ / "models"

_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")

# one reverse complement for every writer: the IUPAC ambiguity codes and
# lowercase; S, W and N are their own complements
_COMP = str.maketrans("ACGTURYKMBVDHacgturykmbvdh",
                      "TGCAAYRMKVBHDtgcaayrmkvbhd")


def revcomp(seq):
    """Reverse complement (IUPAC and lowercase aware)."""
    return seq.translate(_COMP)[::-1]


def mean_qscore_from_qstring(qstring):
    """Mean qscore of a phred+33 string, averaged in error space in f64
    (f32 can move a read across the strict ``--min-qscore`` test)."""
    if len(qstring) == 0:
        return 0.0
    qs = (np.frombuffer(qstring.encode(), dtype=np.uint8).astype(np.float64)
          - 33)
    mean_err = np.exp(qs * (-np.log(10) / 10.0)).mean()
    return float(-10 * np.log10(max(mean_err, 1e-4)))


def column_to_set(filename):
    """The set of the first column of a whitespace-separated file (the
    ``--read-ids`` file), or None without a file."""
    if filename and os.path.isfile(filename):
        with open(filename) as tsv:
            return {line.split()[0] for line in tsv if line.strip()}
    return None


def concat(xs, dim=0):
    """Concatenate a homogeneous list of arrays/lists/strings/dicts."""
    head = xs[0]
    if isinstance(head, np.ndarray):
        return np.concatenate(xs, axis=dim)
    if isinstance(head, list):
        return [x for part in xs for x in part]
    if isinstance(head, str):
        return "".join(xs)
    if isinstance(head, dict):
        return {k: concat([x[k] for x in xs], dim) for k in head}
    raise TypeError(f"cannot concat {type(head)}")


def select_range(x, start, end, dim=0):
    """Slice [start:end] along ``dim`` for arrays; plain slicing otherwise."""
    if isinstance(x, dict):
        return {k: select_range(v, start, end, dim) for k, v in x.items()}
    if dim == 0 or isinstance(x, list):
        return x[start:end]
    index = (slice(None),) * dim + (slice(start, end),)
    return x[index]


def size(x, dim=0):
    if hasattr(x, "shape"):
        return x.shape[dim]
    if dim == 0:
        return len(x)
    raise TypeError(f"cannot size {type(x)} along dim {dim}")


# ---------------------------------------------------------------------------
# chunk / stitch
# ---------------------------------------------------------------------------

def chunk(signal, chunksize, overlap):
    """Tile a 1-D signal into overlapping chunks [n_chunks, chunksize].
    A read shorter than chunksize is padded by repeating its signal; the
    stitcher then keeps only floor(T/stride) output frames of it."""
    signal = np.asarray(signal)
    if signal.ndim == 1:
        signal = signal[None, :]
    if signal.shape[0] != 1:
        raise ValueError(f"chunk() takes one signal, got {signal.shape}")
    T = signal.shape[-1]
    if chunksize == 0:
        return signal[None, 0]
    if T < chunksize:
        n, overhang = divmod(chunksize, T)
        return np.concatenate([np.tile(signal, n), signal[..., :overhang]], axis=-1)
    stub = (T - overlap) % (chunksize - overlap)
    step = chunksize - overlap
    starts = np.arange(stub, T - chunksize + 1, step)
    chunks = np.stack([signal[0, s:s + chunksize] for s in starts], axis=0)
    if stub > 0:
        chunks = np.concatenate([signal[:, :chunksize], chunks], axis=0)
    return chunks


def stitch(chunks, chunksize, overlap, length, stride, reverse=False):
    """Stitch per-chunk outputs [n_chunks, T_out, ...] back into one read.
    Each junction drops overlap/2 raw samples from both sides (in output
    frames); when the read does not tile evenly the first chunk was
    anchored at the read start and keeps (stub + overlap/2)/stride frames."""
    if isinstance(chunks, dict):
        return {k: stitch(v, chunksize, overlap, length, stride,
                          reverse=reverse) for k, v in chunks.items()}
    n = size(chunks, 0)
    if n == 1:
        if length < chunksize:
            return chunks[0][:int(np.floor(length / stride))]
        return chunks[0]

    cut = (overlap // 2) // stride
    body = (chunksize - overlap // 2) // stride
    stub = (length - overlap) % (chunksize - overlap)
    head = (stub + overlap // 2) // stride if stub > 0 else body

    keeps = [(0, head)] + [(cut, body)] * (n - 2) + [(cut, None)]
    if reverse:
        return concat([
            c[(-b if b is not None else None):(-a if a else None)]
            for c, (a, b) in zip(list(chunks)[::-1], keeps[::-1])
        ])
    return concat([c[a:b] for c, (a, b) in zip(chunks, keeps)])


# ---------------------------------------------------------------------------
# batchify / unbatchify
# ---------------------------------------------------------------------------

def batchify(items, batchsize, dim=0):
    """Pack a stream of (key, chunks) into fixed-size batches, yielding
    (spans, batch) where spans = ((key, (start, end)), ...) records where
    each read's chunks landed; a read is split greedily across batches."""
    spans, parts, fill = [], [], 0
    for key, chunks in items:
        taken, total = 0, size(chunks, dim)
        if total == 0:
            spans.append((key, (fill, fill)))
            parts.append(select_range(chunks, 0, 0, dim))
        while taken < total:
            take = min(batchsize - fill, total - taken)
            spans.append((key, (fill, fill + take)))
            parts.append(select_range(chunks, taken, taken + take, dim))
            taken += take
            fill += take
            if fill == batchsize:
                yield tuple(spans), concat(parts, dim)
                spans, parts, fill = [], [], 0
    if parts:
        yield tuple(spans), concat(parts, dim)


def unbatchify(batches, dim=0):
    """Invert batchify: regroup batch slices back into per-key arrays."""
    def pieces():
        for spans, batch in batches:
            for key, (start, end) in spans:
                yield key, select_range(batch, start, end, dim)

    return (
        (key, concat([piece for _, piece in group], dim))
        for key, group in groupby(pieces(), itemgetter(0))
    )


# ---------------------------------------------------------------------------
# model loading
# ---------------------------------------------------------------------------

def load_symbol(config, symbol):
    """Load ``symbol`` from the package a config names. Upstream
    (``bonito.*``) and bonito_tpu (``bonito_tpu.*``) package names map
    onto this port, so directories written by either load here."""
    if not isinstance(config, dict):
        from bonito_tpu_torch.config import load_config
        config = load_config(model_directory(config) / "config.toml")
    package = config["model"]["package"]
    for prefix in ("bonito.", "bonito_tpu."):
        if package.startswith(prefix):
            package = "bonito_tpu_torch." + package[len(prefix):]
            break
    obj = getattr(import_module(package), symbol)
    if isinstance(obj, ModuleType):
        obj = getattr(obj, symbol)
    return obj


def model_directory(dirname):
    """Resolve a model name to a directory (checks the bundled models dir)."""
    p = Path(dirname)
    if not p.is_dir() and (__models_dir__ / dirname).is_dir():
        return __models_dir__ / dirname
    return p


def _tar_not_ported(path):
    return NotImplementedError(
        f"{path}: upstream weights_N.tar checkpoints are not read by the "
        f"port yet; convert it with bonito_tpu or keep a weights_N.npz")


def get_last_checkpoint(dirname):
    """Latest weights_{N}.npz or .tar in a model directory, as bonito_tpu's
    (the .tar wins a tie of N). The port reads .npz only: a latest .tar
    raises rather than an older .npz being loaded in its place."""
    found = []
    for pattern in ("weights_*.npz", "weights_*.tar"):
        for path in _glob.glob(os.path.join(str(dirname), pattern)):
            m = re.search(r"_(\d+)\.(npz|tar)$", path)
            if m:
                found.append((int(m.group(1)), path))
    if not found:
        raise FileNotFoundError(f"no model weights found in '{dirname}'")
    path = max(found)[1]
    if path.endswith(".tar"):
        raise _tar_not_ported(path)
    return path


def set_config_defaults(config, chunksize=None, batchsize=None, overlap=None,
                        quantize=False):
    params = config.get("basecaller", {})
    params["chunksize"] = chunksize or params.get("chunksize", 4000)
    params["overlap"] = overlap if overlap is not None else params.get("overlap", 500)
    params["batchsize"] = batchsize or params.get("batchsize", 64)
    params["quantize"] = params.get("quantize") if quantize is None else quantize
    config["basecaller"] = params
    return config


def load_model(dirname, weights=None, half=True, chunksize=None,
               batchsize=None, overlap=None, quantize=False, fuse_bn=False,
               device=None, route=None, attn_route=None):
    """Load a model (config + weights) off disk onto ``device`` (the card
    unless ``device="cpu"``). Chunksize is rounded down to a stride
    multiple and overlap to an even stride multiple so stitching stays
    exact. ``quantize=None`` takes the config's own ``basecaller.quantize``
    (true in every shipped LSTM-CRF config); a quantised model runs the
    int8 LSTM route ``route`` (``ops.lstm.INT8_ROUTES``; None: each
    layer's shape gate decides). ``attn_route="local"`` puts a transformer
    model's attention on the local route (``transformer.model``)."""
    from bonito_tpu_torch import resolve_device
    from bonito_tpu_torch.config import load_config

    device = resolve_device(device)
    dirname = model_directory(dirname)
    if weights is None:
        weights_path = get_last_checkpoint(dirname)
    else:
        weights_path = dirname / f"weights_{weights}.npz"
        if not weights_path.exists():
            if weights_path.with_suffix(".tar").exists():
                raise _tar_not_ported(weights_path.with_suffix(".tar"))
            raise FileNotFoundError(f"{weights_path} not found")

    config = load_config(dirname / "config.toml")
    config = set_config_defaults(config, chunksize, batchsize, overlap, quantize)
    return _load_model(weights_path, config, half=half, fuse_bn=fuse_bn,
                       device=device, route=route, attn_route=attn_route)


def _load_model(weights_path, config, half=True, fuse_bn=False, device=None,
                route=None, attn_route=None):
    from bonito_tpu_torch import nn, resolve_device
    from bonito_tpu_torch.checkpoint import load_params, params_from_jax

    device = resolve_device(device)
    Model = load_symbol(config, "Model")
    model = Model(config)

    stride = model.stride
    config["basecaller"]["chunksize"] -= config["basecaller"]["chunksize"] % stride
    config["basecaller"]["overlap"] -= config["basecaller"]["overlap"] % (stride * 2)

    params_from_jax(model, load_params(weights_path))
    if fuse_bn:
        # fold in f64/f32 before any bf16 cast
        nn.fuse_bn(model.encoder)
    if half:
        model.to_bf16()
    if config["basecaller"].get("quantize"):
        # after the cast, as in bonito_tpu: the int8 weights are those of
        # the bf16-rounded values
        model.quantize(route=route)
    if attn_route is not None:
        from bonito_tpu_torch.transformer.model import set_attn_route
        set_attn_route(model, attn_route)
    return model.to(device)


# ---------------------------------------------------------------------------
# training helpers
# ---------------------------------------------------------------------------

def init(seed=25):
    """Seed the host's generators (Python's, numpy's) and torch's."""
    import torch
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def decode_ref(encoded, labels):
    """Integer-encoded reference -> string, dropping blanks (label 0)."""
    return "".join(labels[e] for e in np.asarray(encoded).tolist() if e)


def parasail_style_cigar_counts(cigar):
    counts = defaultdict(int)
    for count, op in _CIGAR_RE.findall(cigar):
        counts[op] += int(count)
    return counts


def accuracy(ref, seq, balanced=False, min_coverage=0.0):
    """Percent accuracy of ``seq`` against ``ref`` from a local alignment
    (``alignment.smith_waterman``), as bonito_tpu's and upstream bonito's:
    0 below ``min_coverage`` of the reference aligned."""
    from bonito_tpu_torch.alignment import smith_waterman

    if len(seq) == 0 or len(ref) == 0:
        return 0.0
    result = smith_waterman(seq, ref)
    if result is None:
        return 0.0
    if result.ref_aligned_length / len(ref) < min_coverage:
        return 0.0
    counts = parasail_style_cigar_counts(result.cigar)
    if balanced:
        denom = counts["="] + counts["X"] + counts["D"]
        if denom == 0:
            return 0.0
        return (counts["="] - counts["I"]) / denom * 100
    denom = counts["="] + counts["I"] + counts["X"] + counts["D"]
    if denom == 0:
        return 0.0
    return counts["="] / denom * 100
