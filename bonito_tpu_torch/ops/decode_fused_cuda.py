"""
Kernels G and J (``csrc/decode_tcn_fused.cu``, S <= 256) and GW and JW
(``csrc/decode_tcn_fused_wide.cu``, 256 < S <= 1024) — the TCN decode
with the CRF head inside — with their plain PyTorch versions and launch
counts.

G and GW replace ``bonito_tpu/ops/decode_pallas.py:_fwd_kernel_tcn_fused``,
J and JW ``_bwd_kernel_tcn_fused`` plus the qscore epilogue of
``viterbi_decode_tcn_fused``; all hold ``_head_mv``. They read the
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
head on the CPU and a kernel for a head on the card: G and J where 4 batch
rows of S states make a block (S <= 256, H <= 256), GW and JW, a block per
row and a thread per state, for the 512 and 1024 states of hac and sup
(``kernels_for`` says which, or raises). Never the plain version for a
kernel, nor one kernel for another's shape.
"""

import math

import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.decode_cuda import (
    NB, check_forward_outputs, tcn_backward_plain, tcn_forward_plain)

TILE = 16      # H must be a multiple of the WMMA k-tile
MAX_S = 256    # G, J: 4 batch rows of S states make a block, 1024 threads
MAX_H = 256
MAX_S_WIDE = 1024  # GW, JW: one batch row of S states, a thread each
MAX_H_WIDE = 1024  # GW, JW: hac's width, the widest they are tested at
WIDE_PHASES = (1, 2)  # GW, JW: hac's and sup's; 8 / U encoder frames a chunk
INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry points' refusal


def head_moves_plain(head):
    """The head's move scores [N, T, 4S] in f32: operands in the model
    dtype, the sum over H in order of k with one f32 rounding per product
    added (a product of two bf16 values is exact in f32), then bias, tanh,
    scale and clamp in f32 (the order of bonito_tpu's ``_head_mv``). GW
    and JW take the same steps, so on the card they give these bits; G and
    J sum in WMMA tiles, another order."""
    h = head.h
    Th, N, H = h.shape
    U, Cm, _ = head.wT.shape
    hf = h.float().transpose(0, 1)                  # [N, Th, H]
    w = head.wT.to(h.dtype).float()                 # [U, Cm, H]
    z = torch.zeros(N, Th, U, Cm, device=h.device)
    for k in range(H):
        z.addcmul_(hf[:, :, k, None, None], w[:, :, k])
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


def kernels_for(S, H, U):
    """The kernels that decode a head of S states, width H and U upsample
    phases on the card: ("G", "J") for S <= MAX_S, ("GW", "JW") above. A
    ValueError names the limit a shape passes."""
    if S < NB or S & (S - 1) or S > MAX_S_WIDE:
        raise ValueError(f"the fused-head decode takes S a power of two from "
                         f"{NB} to {MAX_S_WIDE}, got S={S}")
    if H < TILE or H % TILE:
        raise ValueError(f"the fused-head decode takes H a multiple of "
                         f"{TILE}, got H={H}")
    if U < 1:
        raise ValueError(f"the fused-head decode takes U >= 1, got U={U}")
    if S <= MAX_S:
        if H > MAX_H:
            raise ValueError(f"kernels G and J (S <= {MAX_S}) take H up to "
                             f"{MAX_H}, got H={H}")
        return "G", "J"
    if H > MAX_H_WIDE:
        raise ValueError(f"kernels GW and JW (S > {MAX_S}) take H up to "
                         f"{MAX_H_WIDE}, got H={H}")
    if U not in WIDE_PHASES:
        raise ValueError(f"kernels GW and JW (S > {MAX_S}) take U in "
                         f"{WIDE_PHASES}, got U={U}")
    return "GW", "JW"


def _check_head(head):
    """Raise unless a kernel takes the head -> (Th, N, H, S, U, its forward
    and backward kernels' names)."""
    h, wT = head.h, head.wT
    if h.device.type != "cuda" or wT.device != h.device:
        raise ValueError(f"the fused-head decode needs h and wT on one CUDA "
                         f"device, got {h.device} and {wT.device}")
    if h.dtype != torch.bfloat16 or wT.dtype != torch.bfloat16:
        raise TypeError(f"the fused-head decode takes bf16 h and wT (a "
                        f"half=True model), got {h.dtype} and {wT.dtype}")
    if h.dim() != 3 or wT.dim() != 3:
        raise ValueError("the fused-head decode takes h [T/U, N, H] and wT "
                         "[U, 4S, H]")
    Th, N, H = h.shape
    U, Cm, Hw = wT.shape
    S = Cm // NB
    if Cm != NB * S or Hw != H or Th < 1 or N < 1:
        raise ValueError(f"the fused-head decode: h {tuple(h.shape)} and wT "
                         f"{tuple(wT.shape)} need [T/U, N, H] and [U, nb*S, H]")
    names = kernels_for(S, H, U)
    if head.bias is not None and tuple(head.bias.shape) != (U, Cm):
        raise ValueError(f"the fused-head decode: bias "
                         f"{tuple(head.bias.shape)}, expected {(U, Cm)}")
    return (Th, N, H, S, U) + names


def k_major(w):
    """Weights [U, Cm, H] -> [U, H/4, Cm, 4]: k-major in runs of four, the
    order GW's and JW's threads read them (``csrc/decode_tcn_fused_wide.cu``,
    head_product: a thread reads four k of each of its rows at a time, and
    a warp's 32 rows lie side by side)."""
    U, Cm, H = w.shape
    return w.reshape(U, Cm, H // 4, 4).permute(0, 2, 1, 3).contiguous()


def _operands(head, rows=None):
    """h contiguous; the weights (and bias, zeros for None) with their
    rows in the order ``rows``, contiguous at a 32-byte address."""
    h = head.h.contiguous()
    if h.data_ptr() % 16:  # the kernels read h 16 bytes at a time
        h = h.clone()
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


def _wide(head):
    return head.wT.shape[-2] > NB * MAX_S


def _checked(kernel, head):
    """Raise unless ``kernel`` takes the head -> (Th, N, H, S, U)."""
    build.refuse_grad(kernel, [head.h, head.wT, head.bias],
                      build.DECODE_ROUTE)
    Th, N, H, S, U, fwd, bwd = _check_head(head)
    if kernel not in (fwd, bwd):
        raise ValueError(f"kernel {kernel} takes S "
                         f"{'above' if kernel in ('GW', 'JW') else 'up to'} "
                         f"{MAX_S}, got S={S}")
    return Th, N, H, S, U


def _launch(wrapper, kernel, entry, head, shape, tensors, scalars):
    """Count the launch on ``wrapper`` and call the library's ``entry``
    with the head's operands (the weights in the kernel's row order and,
    for GW and JW, laid out by ``k_major``), ``tensors``, the head's shape
    and ``scalars``."""
    S = shape[3]
    h, w, bias = _operands(head, fused_rows(S) if kernel in ("G", "GW")
                           else None)
    if kernel in ("GW", "JW"):
        w = k_major(w)
    wrapper.launches += 1
    _launched(getattr(build.library(), entry)(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(),
        *(x.data_ptr() for x in tensors), *shape, *scalars,
        *_head_ops(head), build.stream_of(h)), entry, S, shape[2], shape[4])


def _forward(wrapper, kernel, entry, head):
    shape = _checked(kernel, head)
    Th, N, _, S, U = shape
    dev = head.h.device
    out = (torch.empty(N, Th * U, S, device=dev),
           torch.empty(N, Th * U, S, dtype=torch.uint8, device=dev),
           torch.empty(N, Th * U, device=dev), torch.empty(N, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev))
    blank = float(head.blank)
    _launch(wrapper, kernel, entry, head, shape, out,
            (math.exp(blank), blank))
    return out


def _backward(wrapper, kernel, entry, head, fwd, qscale, qbias):
    shape = _checked(kernel, head)
    Th, N, _, S, U = shape
    dev = head.h.device
    check_forward_outputs(f"kernel {kernel}", dev, N, Th * U, S, *fwd)
    out = torch.empty(3, N, Th * U, dtype=torch.uint8, device=dev)
    _launch(wrapper, kernel, entry, head, shape, (*fwd, *out),
            (math.exp(float(head.blank)), float(qscale), float(qbias)))
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


def tcn_fused_forward(head):
    """The forward pass over a head's move scores -> (move_in [N, T, S]
    f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32, end_state
    [N] int32): ``tcn_fused_forward_plain`` for a head on the CPU, kernel
    G on the card, or GW (``tcn_fused_forward_wide``) above MAX_S states."""
    if head.h.device.type == "cpu":
        return tcn_fused_forward_plain(head)
    if _wide(head):
        return tcn_fused_forward_wide(head)
    return _forward(tcn_fused_forward, "G", "decode_fused_fwd_bf16", head)


def tcn_fused_forward_wide(head):
    """``tcn_fused_forward`` above MAX_S states: kernel GW on the card,
    the plain version for a head on the CPU."""
    if head.h.device.type == "cpu":
        return tcn_fused_forward_plain(head)
    return _forward(tcn_fused_forward_wide, "GW",
                    "decode_fused_wide_fwd_bf16", head)


def tcn_fused_backward(head, move_in, choices, cs, logz, end_state,
                       qscale=1.0, qbias=0.0):
    """The backward pass, traceback and emission -> {"sequence",
    "qstring", "moves"}, each [N, T] uint8: ``tcn_fused_backward_plain``
    for a head on the CPU, kernel J on the card, or JW
    (``tcn_fused_backward_wide``) above MAX_S states."""
    fwd = (move_in, choices, cs, logz, end_state)
    if head.h.device.type == "cpu":
        return tcn_fused_backward_plain(head, *fwd, qscale, qbias)
    if _wide(head):
        return tcn_fused_backward_wide(head, *fwd, qscale, qbias)
    return _backward(tcn_fused_backward, "J", "decode_fused_bwd_bf16", head,
                     fwd, qscale, qbias)


def tcn_fused_backward_wide(head, move_in, choices, cs, logz, end_state,
                            qscale=1.0, qbias=0.0):
    """``tcn_fused_backward`` above MAX_S states: kernel JW on the card,
    the plain version for a head on the CPU."""
    fwd = (move_in, choices, cs, logz, end_state)
    if head.h.device.type == "cpu":
        return tcn_fused_backward_plain(head, *fwd, qscale, qbias)
    return _backward(tcn_fused_backward_wide, "JW",
                     "decode_fused_wide_bwd_bf16", head, fwd, qscale, qbias)


tcn_fused_forward.launches = 0
tcn_fused_backward.launches = 0
tcn_fused_forward_wide.launches = 0
tcn_fused_backward_wide.launches = 0
