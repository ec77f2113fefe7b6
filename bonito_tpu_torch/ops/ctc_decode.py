"""
The host CTC decoders of the conv-CTC family, bonito_tpu's
(``bonito_tpu/ops/ctc_decode.py``) copied: the greedy collapse (numpy)
and the prefix beam search, which runs in the native C++ library
``ctcbeam`` (``native/ctc/ctcbeam.cpp``, built by ``native.load``).

bonito_tpu falls back to its Python beam where the library is missing or
C > 8; here a failed build raises and C > 8 raises: the Python beam,
``beam_search_ctc_py``, is the tests' oracle and never on the path.
"""

import ctypes
import os
from collections import defaultdict
from math import log

import numpy as np

from bonito_tpu_torch import native
from bonito_tpu_torch.util import phred_array

MAX_LABELS = 8  # the native trie's children per node (blank included)


def greedy_ctc(probs, alphabet, qscores=False, qscale=1.0, qbias=0.0):
    """Argmax path of posteriors [T, C], collapsed: (sequence, path), with
    ``path`` the frame that emits each base; with ``qscores`` the sequence
    has its phred+33 qstring appended (each base's quality: the mean
    probability of its label over its run of frames)."""
    labels = probs.argmax(axis=1)
    prev = np.concatenate([[0], labels[:-1]])
    emit = (labels != 0) & (labels != prev)
    path = np.flatnonzero(emit)
    seq = "".join(alphabet[i] for i in labels[path])
    if not qscores:
        return seq, path

    T = len(labels)
    change = np.flatnonzero(np.diff(labels) != 0) + 1
    starts = np.concatenate([[0], change])
    ends = np.concatenate([change, [T]])
    col = np.concatenate([[0.0], np.cumsum(probs[np.arange(T), labels],
                                           dtype=np.float64)])
    run_means = (col[ends] - col[starts]) / (ends - starts)
    run_of = np.searchsorted(starts, path, side="right") - 1
    quals = phred_array(run_means[run_of], qscale, qbias).tobytes().decode()
    return seq + quals, path


def blank_collapse(probs, thr):
    """Frame-keep mask dropping all but the first frame of each run whose
    blank posterior exceeds ``thr`` (arXiv:2210.17017): (kept probs, kept
    frame indices)."""
    blank_high = probs[:, 0] > thr
    keep = ~blank_high
    keep[0] = True
    keep[1:] |= ~blank_high[:-1]
    idx = np.nonzero(keep)[0]
    return probs[idx], idx


def beam_search_ctc(probs, alphabet, beamsize=5, threshold=1e-3,
                    collapse=None):
    """CTC prefix beam search over posteriors [T, C] in the native
    library: (sequence, path), path the frame of each base's first
    emission. ``collapse`` is a blank-posterior threshold for
    ``blank_collapse`` (0/None: off; ``BONITO_TPU_CTC_BLANK_COLLAPSE``
    supplies it), with the path mapped back to the original frames."""
    if collapse is None:
        env = os.environ.get("BONITO_TPU_CTC_BLANK_COLLAPSE")
        collapse = float(env) if env else 0.0
    if collapse:
        probs_c, kept = blank_collapse(np.asarray(probs), float(collapse))
        seq, path = beam_search_ctc(probs_c, alphabet, beamsize, threshold,
                                    collapse=0.0)
        path = kept[np.asarray(path, np.int64)] if len(path) else path
        return seq, path
    return _beam_search_native(probs, alphabet, beamsize, threshold)


def _beam_search_native(probs, alphabet, beamsize, threshold):
    probs = np.ascontiguousarray(probs, np.float32)
    T, C = probs.shape
    if not 2 <= C <= MAX_LABELS or beamsize < 1:
        raise ValueError(f"the native CTC beam takes 2 to {MAX_LABELS} "
                         f"labels and a beam of 1 or more, got C {C}, beam "
                         f"{beamsize}")
    lib = native.load("ctcbeam")
    max_out = T + 1
    labels = np.empty(max_out, np.int32)
    frames = np.empty(max_out, np.int64)
    n = lib.ctc_beam_search(
        probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.int32(T), np.int32(C), np.int32(beamsize), np.float32(threshold),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        frames.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        np.int32(max_out))
    if n < 0:
        raise RuntimeError(f"the native CTC beam failed on [{T}, {C}] "
                           f"posteriors (code {n})")
    seq = "".join(alphabet[i] for i in labels[:n])
    return seq, frames[:n].copy()


def beam_search_ctc_py(probs, alphabet, beamsize=5, threshold=1e-3):
    """CTC prefix beam search over posteriors [T, C] in Python: the oracle
    the native beam is held against (decision for decision: per-prefix
    blank and non-blank scores, the repeat split, the first writer's
    frames, a stable top-``beamsize``). (sequence, path)."""
    T, C = probs.shape
    NEG = -1e30

    def lse(a, b):
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = max(a, b)
        return m + log(np.exp(a - m) + np.exp(b - m))

    # prefix (label ids) -> [p_blank, p_nonblank, frames]
    beams = {(): [0.0, NEG, ()]}
    log_probs = np.log(np.maximum(probs, 1e-30))
    log_thresh = log(threshold) if threshold > 0 else -np.inf

    for t in range(T):
        next_beams = defaultdict(lambda: [NEG, NEG, ()])
        lp = log_probs[t]
        for prefix, (pb, pnb, frames) in beams.items():
            total = lse(pb, pnb)
            entry = next_beams[prefix]
            entry[0] = lse(entry[0], total + lp[0])
            if not entry[2]:
                entry[2] = frames
            for c in range(1, C):
                if lp[c] < log_thresh:
                    continue
                p = lp[c]
                if prefix and prefix[-1] == c:
                    # a repeat continues the prefix; a new emission of the
                    # same label needs a blank before it
                    entry = next_beams[prefix]
                    entry[1] = lse(entry[1], pnb + p)
                    if not entry[2]:
                        entry[2] = frames
                    new_prefix = prefix + (c,)
                    entry2 = next_beams[new_prefix]
                    entry2[1] = lse(entry2[1], pb + p)
                    if len(entry2[2]) != len(new_prefix):
                        entry2[2] = frames + (t,)
                else:
                    new_prefix = prefix + (c,)
                    entry2 = next_beams[new_prefix]
                    entry2[1] = lse(entry2[1], total + p)
                    if len(entry2[2]) != len(new_prefix):
                        entry2[2] = frames + (t,)
        beams = dict(sorted(
            next_beams.items(),
            key=lambda kv: lse(kv[1][0], kv[1][1]),
            reverse=True,
        )[:beamsize])

    best = max(beams.items(), key=lambda kv: lse(kv[1][0], kv[1][1]))
    prefix, (_, _, frames) = best
    seq = "".join(alphabet[c] for c in prefix)
    return seq, np.array(frames, dtype=np.int64)
