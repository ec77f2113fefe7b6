"""
CRF basecalling pipeline. A lazy generator chain, each stage behind a
bounded-queue thread:

    reads -> chunk -> batchify -> prepare (host int8 wire)
          -> device (encoder + decode, one batch in flight ahead)
          -> unbatchify -> stitch -> fmt

The device step always runs at the fixed shape [batchsize, chunksize]; a
ragged last batch is padded with zero rows of scale 1.
"""

import numpy as np
import torch

from bonito_tpu_torch.ops.beam_device import beam_search_device
from bonito_tpu_torch.ops.decode import (
    to_str, use_fused_head, viterbi_decode, viterbi_decode_head,
    viterbi_decode_tcn)
from bonito_tpu_torch.pipeline import device_stage, thread_iter
from bonito_tpu_torch.profiling import instrument
from bonito_tpu_torch.util import batchify, chunk, stitch, unbatchify


def stitch_results(results, length, size, overlap, stride, reverse=False):
    """Stitch per-chunk result dicts back into per-read arrays."""
    if isinstance(results, dict):
        return {k: stitch_results(v, length, size, overlap, stride,
                                  reverse=reverse)
                for k, v in results.items()}
    if length < size:
        return results[0, :int(np.floor(length / stride))]
    return stitch(results, size, overlap, length, stride, reverse=reverse)


HEAD_ROUTES = ("fused", "tcn")
DECODERS = ("viterbi", "beam")


def make_compute_fn(model, batchsize, chunksize, reverse=False,
                    decoder="viterbi", head_route=None):
    """The device step: signal batch [n <= batchsize, chunksize] -> decoded
    per-frame arrays, as ``compute(batch)`` and in its three parts:

    - ``prepare(batch)`` (host, numpy): the int8 signal wire — each chunk
      scaled by its own abs-max/127 and rounded to int8, with the f32
      scale beside it; a ragged batch is padded with zero rows of scale 1;
    - ``dispatch(prepared)``: uploads the batch and enqueues the forward
      and decode on the device; returns a handle without waiting;
    - ``fetch(handle)``: waits for that batch only and unpacks the packed
      wire, plane 0 = sequence | moves << 3, plane 1 = qstring.

    The forward strand's Viterbi decode reads the move scores of the CRF
    head. ``head_route`` names where they are computed: ``"fused"`` by the
    fused-head decode, in f32 (``forward_tcn_head`` + ``viterbi_decode_head``:
    inside kernels G and J, or once by GW's head product at 1024 states),
    ``"tcn"`` by the head matmul in the model dtype (``forward_tcn`` +
    ``viterbi_decode_tcn``). None is bonito_tpu's default: fused for the
    small state spaces (``ops.decode.use_fused_head``) where the head can
    be split, else tcn, else (no fixed blank) the full scores.

    ``reverse`` (the basecaller's ``--revcomp``) and ``decoder="beam"``
    take the full scores of ``model(x)``, as bonito_tpu does: the Viterbi
    decode of the reverse strand reads them in reverse-complement order in
    place (``viterbi_decode(..., reverse=True)``, bonito_tpu's decode of
    ``seqdist.reverse_complement(scores)``); the beam decode
    (``beam_search_device``, width ``basecaller.beam_width`` of the config,
    32 by default) takes that copy. ``head_route`` names no route there.
    """
    if decoder not in DECODERS:
        raise ValueError(f"decoder {decoder!r}: expected one of {DECODERS}")
    if head_route is not None and head_route not in HEAD_ROUTES:
        raise ValueError(f"head_route {head_route!r}: expected None or one "
                         f"of {HEAD_ROUTES}")
    full = reverse or decoder == "beam"
    if full and head_route is not None:
        raise ValueError(f"head_route={head_route!r}: the reverse strand and "
                         f"the beam decode read the full scores, not a head "
                         f"route")
    fused_head = (use_fused_head(model.seqdist) if head_route is None
                  else head_route == "fused")
    config = getattr(model, "config", {})
    qcfg = config.get("qscore", {})
    qscale = float(qcfg.get("scale", 1.0))
    qbias = float(qcfg.get("bias", 0.0))
    beam_width = int(config.get("basecaller", {}).get("beam_width", 32))
    device = model.device
    dtype = model.compute_dtype
    on_card = device.type == "cuda"
    q = dict(qscale=qscale, qbias=qbias)

    def decode(x):
        if not full:
            head = model.forward_tcn_head(x) if fused_head else None
            if head is not None:
                return viterbi_decode_head(model.seqdist, head, **q)
            if head_route == "fused":
                raise ValueError("head_route='fused': this model's head "
                                 "cannot be split from its encoder")
            tcn = model.forward_tcn(x)
            if tcn is not None:
                return viterbi_decode_tcn(model.seqdist, *tcn, **q)
            if head_route == "tcn":
                raise ValueError("head_route='tcn': this model's head has no "
                                 "fixed blank score")
        scores = model(x)
        if decoder == "beam":
            if reverse:
                scores = model.seqdist.reverse_complement(scores)
            return beam_search_device(model.seqdist, scores,
                                      beam_width=beam_width, **q)
        return viterbi_decode(model.seqdist, scores, reverse=reverse, **q)

    def prepare(batch):
        n = batch.shape[0]
        b = np.asarray(batch, dtype=np.float32)
        amax = np.maximum(np.abs(b).max(axis=1), 1e-8)
        sig_scale = (amax / 127.0).astype(np.float32)
        x = np.rint(b * (1.0 / sig_scale)[:, None]).astype(np.int8)
        if n < batchsize:
            sig_scale = np.concatenate(
                [sig_scale, np.ones(batchsize - n, np.float32)])
            x = np.concatenate(
                [x, np.zeros((batchsize - n, x.shape[1]), np.int8)])
        return n, x, sig_scale

    def upload(a):
        t = torch.from_numpy(a)
        if on_card:  # pinned, so the copy is enqueued without blocking
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def dispatch(prepared):
        n, x, sig_scale = prepared
        with torch.inference_mode():
            xc = upload(x).to(dtype) * upload(sig_scale)[:, None].to(dtype)
            out = decode(xc[..., None])
            packed = torch.stack(
                [out["sequence"] | (out["moves"] << 3), out["qstring"]])
            if not on_card:
                return n, packed, None
            host = torch.empty(packed.shape, dtype=torch.uint8,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return n, host, done

    def fetch(handle):
        n, packed, done = handle
        if done is not None:
            done.synchronize()
        packed = packed.numpy()
        return {"sequence": packed[0, :n] & 0x7,
                "qstring": packed[1, :n],
                "moves": packed[0, :n] >> 3}

    def compute(batch):
        return fetch(dispatch(prepare(batch)))

    compute.prepare = prepare
    compute.dispatch = dispatch
    compute.fetch = fetch
    return compute


def basecall(model, reads, chunksize=4000, overlap=100, batchsize=32,
             reverse=False, rna=False, decoder="viterbi", head_route=None):
    """Basecall a stream of reads (objects with ``.signal``) on the
    model's device; yields (read, result-dict) pairs. ``reverse``,
    ``decoder`` and ``head_route`` as in ``make_compute_fn``; with
    ``reverse`` each read's chunks are stitched in reverse order."""
    compute = make_compute_fn(model, batchsize, chunksize, reverse=reverse,
                              decoder=decoder, head_route=head_route)

    chunks = thread_iter(
        ((read, 0, read.signal.shape[-1]),
         chunk(np.asarray(read.signal, np.float32), chunksize, overlap))
        for read in instrument("read", reads)
    )
    batches = thread_iter(batchify(instrument("chunk", chunks),
                                   batchsize=batchsize))
    prepared = thread_iter(
        (spans, compute.prepare(b))
        for spans, b in instrument("batch", batches)
    )
    decoded = thread_iter(device_stage(compute, instrument("prep", prepared)))
    results = thread_iter(
        (read, stitch_results(attrs, end - start, chunksize, overlap,
                              model.stride, reverse))
        for ((read, start, end), attrs) in unbatchify(
            instrument("device", decoded))
    )
    return thread_iter(
        (read, fmt(model.stride, attrs, model.alphabet, rna))
        for read, attrs in instrument("stitch", results)
    )


def fmt(stride, attrs, alphabet, rna=False):
    fliprna = (lambda x: x[::-1]) if rna else (lambda x: x)
    return {
        "stride": stride,
        "moves": np.asarray(attrs["moves"]),
        "qstring": fliprna(to_str(attrs["qstring"], qstring=True)),
        "sequence": fliprna(to_str(attrs["sequence"], "".join(alphabet))),
    }
