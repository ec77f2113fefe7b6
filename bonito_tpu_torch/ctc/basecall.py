"""
Conv-CTC basecalling, bonito_tpu's ``ctc/basecall.py``: a lazy generator
chain, each stage behind a bounded-queue thread,

    reads -> chunk -> batchify -> device (forward, one batch in flight
          ahead) -> unbatchify -> stitch -> decode (host, worker threads)

The device step runs at the fixed shape [batchsize, chunksize]: the signal
goes up in the model's dtype, a ragged last batch is padded with zero
rows, and the log-probs come back in bf16 for a half model (f32 for an f32
one) and are converted to f32 on the host, where the decoders run.
"""

import os
import sys
from functools import partial

import numpy as np
import torch

from bonito_tpu_torch.ctc.model import decode_scores
from bonito_tpu_torch.pipeline import (device_stage, process_map, thread_iter,
                                       thread_map)
from bonito_tpu_torch.profiling import instrument
from bonito_tpu_torch.util import (batchify, chunk, mean_qscore_from_qstring,
                                   stitch, unbatchify)


def make_compute_fn(model, batchsize):
    """The device step: signal batch [n <= batchsize, chunksize] -> f32
    log-probs [n, T, C] on the host, as ``compute(batch)`` and in its two
    parts: ``dispatch(batch)`` uploads the batch (pinned, on the card) and
    enqueues the forward and the copy back; ``fetch(handle)`` waits for
    that batch only."""
    dtype = model.compute_dtype
    wire = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    device = model.device
    on_card = device.type == "cuda"

    def dispatch(batch):
        n = batch.shape[0]
        x = np.asarray(batch, np.float32)
        if n < batchsize:
            x = np.concatenate(
                [x, np.zeros((batchsize - n, *x.shape[1:]), x.dtype)])
        # cast on the host: the step casts to the model's dtype anyway
        x = torch.from_numpy(x).to(dtype)[..., None]
        with torch.inference_mode():
            if on_card:
                x = x.pin_memory().to(device, non_blocking=True)
            out = model(x).to(wire).contiguous()
            if not on_card:
                return n, out, None
            host = torch.empty(out.shape, dtype=wire, pin_memory=True)
            host.copy_(out, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return n, host, done

    def fetch(handle):
        n, out, done = handle
        if done is not None:
            done.synchronize()
        return out[:n].float().numpy()

    def compute(batch):
        return fetch(dispatch(batch))

    compute.dispatch = dispatch
    compute.fetch = fetch
    return compute


def basecall(model, reads, beamsize=5, chunksize=0, overlap=0, batchsize=1,
             qscores=False, reverse=None, rna=False):
    """Basecall a stream of reads (objects with ``.signal``) on the
    model's device; yields (read, result-dict) pairs. The decode runs on
    ``BONITO_TPU_DECODE_THREADS`` threads (4), or on
    ``BONITO_TPU_DECODE_PROCS`` spawned processes where that is set."""
    compute = make_compute_fn(model, batchsize)

    chunks = thread_iter(
        (read, chunk(np.asarray(read.signal, np.float32), chunksize, overlap))
        for read in instrument("read", reads)
    )
    batches = thread_iter(batchify(instrument("chunk", chunks),
                                   batchsize=batchsize))
    scores = unbatchify(instrument(
        "device",
        thread_iter(device_stage(compute, instrument("batch", batches)))))
    scores = thread_iter(
        (read, {"scores": stitch(v, chunksize, overlap, len(read.signal),
                                 model.stride)})
        for read, v in scores
    )
    if reverse:
        # the r9.4.1 conv-CTC models have no reverse-strand decode
        sys.stderr.write(
            "> warning: --revcomp has no effect for the conv-CTC family\n")
    decoder = partial(
        decode, decode_fn=partial(decode_scores, alphabet=model.alphabet,
                                  qscale=model.qscale, qbias=model.qbias),
        beamsize=beamsize, qscores=qscores, stride=model.stride, rna=rna)
    stitched = instrument("stitch", scores)
    if os.environ.get("BONITO_TPU_DECODE_PROCS"):
        return process_map(decoder, stitched,
                           n_proc=int(os.environ["BONITO_TPU_DECODE_PROCS"]))
    n_thread = int(os.environ.get("BONITO_TPU_DECODE_THREADS", "4"))
    return thread_map(decoder, stitched, n_thread=n_thread)


def decode(scores, decode_fn, beamsize=5, qscores=False, stride=1,
           rna=False):
    """A read's stitched log-probs -> its call: the greedy path's moves and
    mean qscore always; its sequence and qstring with ``qscores`` or beam
    1, else the beam's sequence with ``moves`` None and qstring "*".
    ``rna`` flips the read. A fault in the beam raises (bonito_tpu's
    basecall swallows it and keeps the greedy call)."""
    n_frames = len(scores["scores"])
    seq, path = decode_fn(scores["scores"], beamsize=1, qscores=True,
                          return_path=True)
    seq, qstring = seq[:len(path)], seq[len(path):]
    mean_qscore = mean_qscore_from_qstring(qstring)

    moves = np.zeros(n_frames, np.uint8)
    moves[np.asarray(path, np.int64)] = 1

    if not (qscores or beamsize == 1):
        seq = decode_fn(scores["scores"], beamsize=beamsize)
        moves = None
        qstring = "*"
    if rna:
        seq = seq[::-1]
        if qstring != "*":
            qstring = qstring[::-1]
    return {"sequence": seq, "qstring": qstring, "stride": stride,
            "moves": moves, "mean_qscore": mean_qscore}
