"""
Kernels G and J — the TCN decode with the CRF head inside
(``csrc/decode_tcn_fused.cu``) — with their plain PyTorch versions and
launch counts.

G replaces ``bonito_tpu/ops/decode_pallas.py:_fwd_kernel_tcn_fused`` and J
``_bwd_kernel_tcn_fused`` plus the qscore epilogue of
``viterbi_decode_tcn_fused``; both hold ``_head_mv``. They read the
encoder output and the head's folded weights and compute every frame's
move scores themselves, in f32, in both passes, so the [T, 4S, N] move
tensor never exists in device memory — and is never rounded to bf16,
which is what makes this route's output differ from the TCN route's
(kernels B and C read bf16 moves).

A head is any object with ``SeqdistModel.forward_tcn_head``'s fields:
``h`` [T/U, N, H] (time-major, rows contiguous in H: the LSTM's own output
layout), ``wT`` [U, 4S, H] with rows in the TCN (b, j, r) order, ``bias``
[U, 4S] f32 or None, ``act_tanh``, ``scale``, ``cmin``/``cmax`` (None: no
clamp) and ``blank``. Output frame t = th * U + p takes phase p of
encoder frame th: ``mv = clip(scale * tanh?(wT[p] @ h[th] + bias[p]))``.
Everything after the move scores is the TCN decode's math
(``ops/decode_cuda.py``), and the plain versions are exactly that: the
move tensor from ``head_moves_plain`` through ``tcn_forward_plain`` and
``tcn_backward_plain``.

``tcn_fused_forward``/``tcn_fused_backward`` run the plain version for a
head on the CPU and the kernel for a head on the card; never one for the
other.
"""

import math

import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.decode_cuda import (
    NB, tcn_backward_plain, tcn_forward_plain)

TILE = 16      # H must be a multiple of the WMMA k-tile
MAX_S = 256    # 4 batch rows of S states make a block: at most 1024 threads
MAX_H = 256
INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry points' refusal


def head_moves_plain(head):
    """The head's move scores [N, T, 4S] in f32: operands in the model
    dtype, f32 accumulation, then bias, tanh, scale and clamp in f32 (the
    order of bonito_tpu's ``_head_mv``)."""
    h = head.h
    Th, N, H = h.shape
    U, Cm, _ = head.wT.shape
    z = torch.einsum("tnh,pch->ntpc", h.float(),
                     head.wT.to(h.dtype).float())
    if head.bias is not None:
        z = z + head.bias.float()
    if head.act_tanh:
        z = torch.tanh(z)
    if head.scale != 1.0:
        z = z * head.scale
    if head.cmin is not None:
        z = torch.clamp(z, head.cmin, head.cmax)
    return z.reshape(N, Th * U, Cm)


def tcn_fused_forward_plain(head):
    return tcn_forward_plain(head_moves_plain(head), head.blank)


def tcn_fused_backward_plain(head, move_in, choices, cs, logz, end_state,
                             qscale=1.0, qbias=0.0):
    return tcn_backward_plain(head_moves_plain(head), move_in, choices, cs,
                              logz, end_state, head.blank, qscale, qbias)


def fused_rows(S):
    """For each forward-pass thread's reads: row j * S + s of the weights
    the forward kernel takes is row (b * nb + j) * R + r of ``wT``, the
    move into state s = r * nb + b from predecessor j * R + r. (The
    backward pass reads ``wT`` as it is: thread p = j * R + r takes rows
    b * S + p.)"""
    R = S // NB
    s = torch.arange(S)
    j = torch.arange(NB)[:, None]
    return (((s % NB) * NB + j) * R + s // NB).reshape(-1)


def _check_head(head, name):
    h, wT = head.h, head.wT
    if h.device.type != "cuda" or wT.device != h.device:
        raise ValueError(f"{name} needs h and wT on one CUDA device, got "
                         f"{h.device} and {wT.device}")
    if h.dtype != torch.bfloat16 or wT.dtype != torch.bfloat16:
        raise TypeError(f"{name} takes bf16 h and wT (a half=True model), "
                        f"got {h.dtype} and {wT.dtype}")
    if h.dim() != 3 or wT.dim() != 3:
        raise ValueError(f"{name} takes h [T/U, N, H] and wT [U, 4S, H]")
    Th, N, H = h.shape
    U, Cm, Hw = wT.shape
    S = Cm // NB
    if (Cm != NB * S or S % NB or S & (S - 1) or not 0 < S <= MAX_S
            or Hw != H or H % TILE or not 0 < H <= MAX_H or U < 1 or Th < 1
            or N < 1):
        raise ValueError(
            f"{name}: h {tuple(h.shape)} and wT {tuple(wT.shape)} need "
            f"[T/U, N, H] and [U, nb*S, H] with S a power of two from 4 to "
            f"{MAX_S} and H a multiple of {TILE} up to {MAX_H}")
    if head.bias is not None and tuple(head.bias.shape) != (U, Cm):
        raise ValueError(f"{name}: bias {tuple(head.bias.shape)}, expected "
                         f"{(U, Cm)}")
    return Th, N, H, S, U


def _operands(head, rows=None):
    """h contiguous; the weights (and bias, zeros for None) with their
    rows in the order ``rows``, contiguous at a 32-byte address."""
    h = head.h.contiguous()
    w = head.wT if rows is None else head.wT[:, rows.to(head.wT.device)]
    w = w.contiguous()
    if w.data_ptr() % 32:
        w = w.clone()
    U, Cm, _ = w.shape
    if head.bias is None:
        bias = torch.zeros(U, Cm, device=h.device)
    else:
        bias = head.bias.to(device=h.device, dtype=torch.float32)
        if rows is not None:
            bias = bias[:, rows.to(h.device)]
        bias = bias.contiguous()
    return h, w, bias


def _head_ops(head):
    clamp = head.cmin is not None
    return (int(bool(head.act_tanh)), float(head.scale), int(clamp),
            float(head.cmin) if clamp else 0.0,
            float(head.cmax) if clamp else 0.0)


def _launched(rc, name, S, H, U):
    if rc == INVALID_VALUE:
        raise ValueError(f"{name}: S={S}, H={H}, U={U} needs more shared "
                         f"memory than a block has")
    build.check(rc, name)


def tcn_fused_forward(head):
    """The forward pass over a head's move scores -> (move_in [N, T, S]
    f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32, end_state
    [N] int32): ``tcn_fused_forward_plain`` for a head on the CPU, kernel
    G on the card."""
    if head.h.device.type == "cpu":
        return tcn_fused_forward_plain(head)
    build.refuse_grad("G", [head.h, head.wT, head.bias], build.DECODE_ROUTE)
    Th, N, H, S, U = _check_head(head, "kernel G")
    T = Th * U
    h, w, bias = _operands(head, fused_rows(S))
    dev = h.device
    move_in = torch.empty(N, T, S, device=dev)
    choices = torch.empty(N, T, S, dtype=torch.uint8, device=dev)
    cs = torch.empty(N, T, device=dev)
    logz = torch.empty(N, device=dev)
    end_state = torch.empty(N, dtype=torch.int32, device=dev)
    blank = float(head.blank)
    tcn_fused_forward.launches += 1
    _launched(build.library().decode_fused_fwd_bf16(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(), move_in.data_ptr(),
        choices.data_ptr(), cs.data_ptr(), logz.data_ptr(),
        end_state.data_ptr(), Th, N, H, S, U, math.exp(blank), blank,
        *_head_ops(head), build.stream_of(h)), "decode_fused_fwd_bf16",
        S, H, U)
    return move_in, choices, cs, logz, end_state


def tcn_fused_backward(head, move_in, choices, cs, logz, end_state,
                       qscale=1.0, qbias=0.0):
    """The backward pass, traceback and emission -> {"sequence",
    "qstring", "moves"}, each [N, T] uint8: ``tcn_fused_backward_plain``
    for a head on the CPU, kernel J on the card."""
    if head.h.device.type == "cpu":
        return tcn_fused_backward_plain(head, move_in, choices, cs, logz,
                                        end_state, qscale, qbias)
    build.refuse_grad("J", [head.h, head.wT, head.bias], build.DECODE_ROUTE)
    Th, N, H, S, U = _check_head(head, "kernel J")
    T = Th * U
    h, w, bias = _operands(head)
    for name, x, shape, dtype in (
            ("move_in", move_in, (N, T, S), torch.float32),
            ("choices", choices, (N, T, S), torch.uint8),
            ("c", cs, (N, T), torch.float32),
            ("logz", logz, (N,), torch.float32),
            ("end_state", end_state, (N,), torch.int32)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != h.device or not x.is_contiguous()):
            raise ValueError(f"kernel J: {name} must be a contiguous {dtype} "
                             f"{shape} on {h.device}")
    out = torch.empty(3, N, T, dtype=torch.uint8, device=h.device)
    tcn_fused_backward.launches += 1
    _launched(build.library().decode_fused_bwd_bf16(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(), move_in.data_ptr(),
        choices.data_ptr(), cs.data_ptr(), logz.data_ptr(),
        end_state.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), Th, N, H, S, U, math.exp(float(head.blank)),
        float(qscale), float(qbias), *_head_ops(head),
        build.stream_of(h)), "decode_fused_bwd_bf16", S, H, U)
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


tcn_fused_forward.launches = 0
tcn_fused_backward.launches = 0
