"""
Kernels G and J (``csrc/decode_tcn_fused.cu``, S <= 256) and GW and JW
(256 < S <= 1024) — the TCN decode with the CRF head inside — with their
plain PyTorch versions and launch counts.

G and GW replace ``bonito_tpu/ops/decode_pallas.py:_fwd_kernel_tcn_fused``,
J and JW ``_bwd_kernel_tcn_fused`` plus the qscore epilogue of
``viterbi_decode_tcn_fused``; all hold ``_head_mv``. The move scores are
f32, never rounded to bf16, which is what makes this route's output differ
from the TCN route's (kernels B and C read bf16 moves). G and J read the
encoder output and the head's folded weights and compute every frame's
move scores themselves, in both passes, so at S <= 256 the [T, 4S, N] move
tensor never exists in device memory. At 512 and 1024 states (hac and sup)
GW takes the head product once for the whole batch (``head_product``:
``csrc/head_product.cu``, a GEMM tiled over every row on the f32 cores)
into an f32 [N, T, 4S] tensor and runs the forward pass over it on the
ring of kernel B (``csrc/decode_tcn_ring.cu``, its f32 instance); JW is
the backward pass over the same moves on C's ring, handed over by the
caller (``tcn_fused_forward``'s ``moves_out``, ``tcn_fused_backward``'s
``moves``; ``move_buffer`` makes the tensor), so the product is not taken
again.

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
rows of S states make a block (S <= 256, H <= 256), GW and JW for the 512
and 1024 states of hac and sup (``kernels_for`` says which, or raises).
Never the plain version for a kernel, nor one kernel for another's shape.
G and J run on their rings (``fused_decode_plan``'s "fwd" and "bwd": 8
batch rows a CTA, head warps computing the next chunk's move scores while
consumer warps walk this one) where the plan gives one, else on their
earlier kernels; GW and JW on the product and the rings where
``wide_decode_plan`` gives a plan, else on their earlier kernels
(``csrc/decode_tcn_fused_wide.cu``: a block per row computing the head
product itself, in each pass). ``*_old_kernel`` run the earlier kernels
whatever the plan (no count), for comparisons.
"""

import functools
import math

import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.decode_cuda import (
    NB, check_forward_outputs, decode_plan, tcn_backward_plain,
    tcn_forward_plain)

TILE = 16      # H must be a multiple of the WMMA k-tile
MAX_S = 256    # G, J: 4 batch rows of S states make a block, 1024 threads
MAX_H = 256
MAX_S_WIDE = 1024  # GW, JW: one batch row of S states, a thread each
MAX_H_WIDE = 1024  # GW, JW: hac's width, the widest they are tested at
WIDE_PHASES = (1, 2)  # GW, JW: hac's and sup's; 8 / U encoder frames a chunk
INVALID_VALUE = 1  # cudaErrorInvalidValue: the C entry points' refusal
SMEM = 232448      # the most shared memory a block may ask for
# J on its ring (csrc/decode_tcn_fused.cu:decode_fused_bwd_ring): batch rows
# a CTA (an encoder frame's rows are the n of a head tile), encoder frames a
# chunk, head warps, the instances built (S 64; H 32 or 96; U 1 or 2), the
# slots of the ring of chunks (fewer where they do not fit; the C entry
# takes 2 to J_RING_MAX)
J_ROWS, J_FRAMES, J_HEAD_WARPS = 8, 4, 8
J_STATES, J_WIDTHS, J_PHASES = (64,), (32, 96), (1, 2)
J_RING, J_RING_MAX = 4, 8
# G on its ring (decode_fused_fwd_ring): J's rows, head warps and instances;
# chunks of G_FRAMES output frames (G_FRAMES / U encoder frames: two tiles
# of a chunk's scores and exps must fit beside the ring), rings of G_RING
G_FRAMES, G_RING = 4, 4
# GW's head product (csrc/head_product.cu, its HP_BM, HP_BN, HP_BK,
# HP_STAGES): a CTA's tile of rows, columns and k a step, the ring's slots;
# 256 threads of 8 x 8 outputs; two CTAs an SM (its launch bounds)
HP_TILE, HP_STAGES, HP_THREADS, HP_CTAS_PER_SM = (128, 128, 16), 4, 256, 2


def head_moves_plain(head):
    """The head's move scores [N, T, 4S] in f32: operands in the model
    dtype, the sum over H in order of k with one f32 rounding per product
    added (a product of two bf16 values is exact in f32), then bias, tanh,
    scale and clamp in f32 (the order of bonito_tpu's ``_head_mv``). GW's
    product (``head_product``) and the earlier GW and JW take the same
    steps, so on the card they give these bits; G and J sum in WMMA tiles,
    another order."""
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


def _forward_plain(head, moves_out):
    """The plain forward pass, its move scores also written to
    ``moves_out`` where one is given."""
    if moves_out is None:
        return tcn_fused_forward_plain(head)
    moves_out.copy_(head_moves_plain(head))
    return tcn_forward_plain(moves_out, head.blank)


def _backward_plain(head, fwd, qscale, qbias, moves):
    """The plain backward pass over ``moves`` where given (the forward
    pass's), else over the head's own."""
    if moves is None:
        return tcn_fused_backward_plain(head, *fwd, qscale, qbias)
    return tcn_backward_plain(moves, *fwd, head.blank, qscale, qbias)


@functools.lru_cache(maxsize=None)
def fused_rows(S, device=None):
    """For each forward-pass thread's reads: row j * S + s of the weights
    the forward kernel takes is row (b * nb + j) * R + r of ``wT``, the
    move into state s = r * nb + b from predecessor j * R + r. (The
    backward pass reads ``wT`` as it is: thread p = j * R + r takes rows
    b * S + p.) Made once per device, so that no launch waits for a copy
    of it to the card."""
    R = S // NB
    s = torch.arange(S, device=device)
    j = torch.arange(NB, device=device)[:, None]
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


def _round_up(v, m):
    return -(-v // m) * m


def j_ring_smem(S, H, U, ring):
    """The shared memory of J's ring kernel (csrc/decode_tcn_fused.cu:
    JLayout): the mbarriers, beta of two parities, two chunks' records
    (the mass of each run of 32 states, the row's max and the traceback
    word a frame) and exps, and ``ring`` slots of a chunk's h rows, move-in
    and choices."""
    fu = J_FRAMES * U
    slot = _round_up(J_FRAMES * J_ROWS * H * 2 + J_ROWS * fu * S * 5, 128)
    return (256 + _round_up(2 * J_ROWS * S * 4, 128)
            + _round_up(2 * J_ROWS * fu * (S // 32 + 2) * 4, 128)
            + _round_up(2 * fu * J_ROWS * (NB * S + 4) * 4, 128)
            + ring * slot)


def g_ring_smem(S, H, U, ring):
    """The shared memory of G's ring kernel (csrc/decode_tcn_fused.cu:
    GLayout): the mbarriers, alpha and the max semiring's scores of two
    parities, two chunks' tiles of each move's score and exp (float2
    pairs), and ``ring`` slots of a chunk's h rows."""
    return (256 + _round_up(2 * J_ROWS * S * 8, 128)
            + _round_up(2 * G_FRAMES * J_ROWS * (NB * S + 2) * 8, 128)
            + ring * _round_up(G_FRAMES // U * J_ROWS * H * 2, 128))


def _registers(warps):
    """A thread's registers in a CTA of ``warps``: the 4 sub-partitions of
    an SM's 65,536 hold ceil(warps / 4) warps each."""
    return min(65536 // 4 // (32 * -(-warps // 4)) // 8 * 8, 255)


@functools.lru_cache(maxsize=None)
def _ring_plan(N, S, H, U, sms, backward):
    if S not in J_STATES or H not in J_WIDTHS or U not in J_PHASES:
        return None
    smem_of, ring = ((j_ring_smem, J_RING) if backward
                     else (g_ring_smem, G_RING))
    while ring > 2 and smem_of(S, H, U, ring) > SMEM:
        ring -= 1
    smem = smem_of(S, H, U, ring)
    if smem > SMEM:
        return None
    ctas = -(-N // J_ROWS)
    # a consumer warp a row, the head warps, the producer (and J's
    # epilogue warp)
    warps = J_ROWS + J_HEAD_WARPS + 1 + backward
    m_tiles = U * NB * S // 16 // J_HEAD_WARPS
    # a head warp keeps its weight fragments and needs about 48 more
    registers = _registers(warps)
    if m_tiles * (H // 16) * 4 + 48 > registers:
        return None
    return {"rows": J_ROWS, "ctas": ctas,
            "waves": None if sms is None else -(-ctas // sms),
            "threads": 32 * warps, "registers": registers,
            "consumer_warps": J_ROWS, "states_per_thread": S // 32,
            "head_warps": J_HEAD_WARPS, "m_tiles_a_head_warp": m_tiles,
            "k_tiles": H // 16,
            "frames_a_chunk": J_FRAMES * U if backward else G_FRAMES,
            "ring": ring, "smem": smem}


def fused_decode_plan(N, T, S, H, U, sms=None, aligned=True):
    """The ring kernels' plans, {"fwd": G's, "bwd": J's}, for a head of S
    states, width H and U phases over N rows of T = Th * U frames on a card
    of ``sms`` SMs: 8 batch rows a CTA, a consumer warp a row (two states a
    thread), 8 head warps with their m-tiles of the weights in registers, a
    producer warp (and J's epilogue warp); G's ring of G_RING chunks of
    G_FRAMES output frames, J's of J_RING chunks of 4 encoder frames (or
    fewer, down to 2, where the shared memory does not hold them). None
    where no instance takes the shape (S 64, H 32 or 96, U 1 or 2), where
    the head warps' weights do not fit their registers, or where a pointer
    is not aligned for the bulk copies, and the earlier kernels run."""
    if N < 1 or T < 1 or T % U or not aligned:
        return None
    plans = {"fwd": _ring_plan(N, S, H, U, sms, False),
             "bwd": _ring_plan(N, S, H, U, sms, True)}
    return None if plans["fwd"] is None and plans["bwd"] is None else plans


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
        if bias.data_ptr() % 16:  # GW's product reads it 16 bytes at a time
            bias = bias.clone()
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


def _launch(wrapper, kernel, entry, head, shape, tensors, scalars,
            operands, plan):
    """Count the launch on ``wrapper`` (None: count nothing) and call the
    library's ``entry`` (with ``plan``'s ring depth after the shape where
    the plan is not None) with ``operands`` (the weights in the kernel's
    row order; for GW and JW laid out here by ``k_major``), ``tensors``,
    the head's shape and ``scalars``."""
    S = shape[3]
    h, w, bias = operands
    more = () if plan is None else (plan["ring"],)
    if kernel in ("GW", "JW"):
        w = k_major(w)
    if wrapper is not None:
        wrapper.launches += 1
    _launched(getattr(build.library(), entry)(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(),
        *(x.data_ptr() for x in tensors), *shape, *more, *scalars,
        *_head_ops(head), build.stream_of(h)), entry, S, shape[2], shape[4])


def _plan(wrapper, key, shape, pointers):
    """``fused_decode_plan``'s plan of G (``key`` "fwd") or J ("bwd") for
    a launch counted on ``wrapper``, kept as ``wrapper.plan``; None for the
    earlier kernels' wrappers and launches counted on none."""
    if wrapper not in (tcn_fused_forward, tcn_fused_backward):
        return None
    Th, N, H, S, U = shape
    plans = fused_decode_plan(N, Th * U, S, H, U, _sms(pointers[0].device),
                              aligned=all(x.data_ptr() % 16 == 0
                                          for x in pointers))
    wrapper.plan = None if plans is None else plans[key]
    return wrapper.plan


def _forward(wrapper, kernel, entry, head):
    """G's and GW's checks and launch: for G the ring on
    ``fused_decode_plan``'s plan where ``wrapper`` is G's counter and the
    plan is not None, else the earlier kernel's ``entry``."""
    shape = _checked(kernel, head)
    Th, N, _, S, U = shape
    dev = head.h.device
    out = (torch.empty(N, Th * U, S, device=dev),
           torch.empty(N, Th * U, S, dtype=torch.uint8, device=dev),
           torch.empty(N, Th * U, device=dev), torch.empty(N, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev))
    blank = float(head.blank)
    operands = _operands(head, fused_rows(S, head.wT.device))
    plan = _plan(wrapper, "fwd", shape, operands[:1])
    _launch(wrapper, kernel,
            entry if plan is None else "decode_fused_fwd_ring_bf16", head,
            shape, out, (math.exp(blank), blank), operands, plan)
    return out


def _backward(wrapper, kernel, entry, head, fwd, qscale, qbias):
    """J's and JW's checks and launch: for J the ring on
    ``fused_decode_plan``'s plan where ``wrapper`` is J's counter and the
    plan is not None, else the earlier kernel's ``entry``."""
    shape = _checked(kernel, head)
    Th, N, H, S, U = shape
    dev = head.h.device
    check_forward_outputs(f"kernel {kernel}", dev, N, Th * U, S, *fwd)
    out = torch.empty(3, N, Th * U, dtype=torch.uint8, device=dev)
    scalars = (math.exp(float(head.blank)), float(qscale), float(qbias))
    operands = _operands(head)
    plan = _plan(wrapper, "bwd", shape, (operands[0], fwd[0], fwd[1]))
    _launch(wrapper, kernel,
            entry if plan is None else "decode_fused_bwd_ring_bf16", head,
            shape, (*fwd, *out), scalars, operands, plan)
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def product_plan(N, Th, H, cols, sms=None):
    """The plan of GW's head product (``csrc/head_product.cu``) over M =
    N * Th rows (row n * Th + th reads h[th, n]), ``cols`` = U * 4S columns
    and K = H on a card of ``sms`` SMs: 128 x 128 output tiles (``tiles_m``
    by ``tiles_n``, the last row tile ragged), 256 threads of 8 x 8 outputs,
    16 k a step through a ring of 4 bf16 slots and two f32 tiles, a
    persistent grid of two CTAs an SM (all the tiles where ``sms`` is None)
    walking the tiles column fastest. None where the kernel does not take
    the shape: H a multiple of 16, ``cols`` of 128."""
    bm, bn, bk = HP_TILE
    if N < 1 or Th < 1 or H < bk or H % bk or cols < bn or cols % bn:
        return None
    tiles_m, tiles_n = -(-N * Th // bm), cols // bn
    tiles = tiles_m * tiles_n
    ctas = tiles if sms is None else min(tiles, HP_CTAS_PER_SM * sms)
    return {"tile": HP_TILE, "threads": HP_THREADS, "stages": HP_STAGES,
            "k_steps": H // bk, "tiles_m": tiles_m, "tiles_n": tiles_n,
            "tiles": tiles, "ctas": ctas, "ctas_per_sm": HP_CTAS_PER_SM,
            "waves": None if sms is None else -(-tiles // ctas),
            "smem": 2 * bk * (bm + bn) * 4 + HP_STAGES * (bm + bn) * bk * 2}


@functools.lru_cache(maxsize=None)
def wide_decode_plan(N, Th, H, S, U, sms=None):
    """The plan of GW and JW for a head of S states (512 or 1024), width H
    and U phases over N rows of Th encoder frames: {"product":
    ``product_plan``'s, "fwd" and "bwd": the f32 ring of B's and C's
    kernels (``decode_plan`` with f32 moves: rings of 8 frames, 148,288 and
    183,104 B at S 1024)}. None where either does not take the shape, and
    the earlier GW and JW run."""
    product = product_plan(N, Th, H, U * NB * S, sms)
    ring = decode_plan(N, Th * U, S, sms, torch.float32)
    if product is None or ring is None:
        return None
    return {"product": product, "fwd": ring["fwd"], "bwd": ring["bwd"]}


def _wide_plan(head):
    Th, N, H = head.h.shape
    U, Cm, _ = head.wT.shape
    return wide_decode_plan(N, Th, H, Cm // NB, U, _sms(head.h.device))


def move_buffer(head):
    """An empty f32 [N, T, 4S] tensor for the head's move scores, taken once
    for both passes (``tcn_fused_forward``'s ``moves_out``,
    ``tcn_fused_backward``'s ``moves``): on the CPU, and on the card where
    GW's product runs (``wide_decode_plan`` gives a plan). None where the
    kernels take the moves from the head themselves (G and J; the earlier
    GW and JW)."""
    Th, N, _ = head.h.shape
    U, Cm, _ = head.wT.shape
    if head.h.device.type != "cpu" and (not _wide(head)
                                        or _wide_plan(head) is None):
        return None
    return torch.empty(N, Th * U, Cm, device=head.h.device)


def _check_moves(kernel, moves, head, shape):
    Th, N, _, S, U = shape
    if (moves.dtype != torch.float32 or moves.device != head.h.device
            or tuple(moves.shape) != (N, Th * U, NB * S)
            or not moves.is_contiguous() or moves.data_ptr() % 16):
        raise ValueError(f"kernel {kernel}: moves must be a contiguous, "
                         f"16-byte aligned f32 {(N, Th * U, NB * S)} on "
                         f"{head.h.device}")


def head_product(head, out=None):
    """The head's move scores [N, T, 4S] f32 (``head_moves_plain``'s
    tensor), into ``out`` where given: the plain version for a head on the
    CPU, GW's product kernel (``csrc/head_product.cu``, on
    ``product_plan``'s plan, recorded in ``.plan``) on the card, at 512 and
    1024 states; it raises where the plan is None."""
    if head.h.device.type == "cpu":
        mv = head_moves_plain(head)
        return mv if out is None else out.copy_(mv)
    shape = _checked("GW", head)
    Th, N, H, S, U = shape
    cols = U * NB * S
    plan = product_plan(N, Th, H, cols, _sms(head.h.device))
    if plan is None:
        raise ValueError(f"GW's head product takes H a multiple of "
                         f"{HP_TILE[2]} and U*4S of {HP_TILE[1]}, got H={H}, "
                         f"U*4S={cols}")
    if out is None:
        out = torch.empty(N, Th * U, NB * S, device=head.h.device)
    _check_moves("GW", out, head, shape)
    h, w, bias = _operands(head)
    head_product.plan = plan
    head_product.launches += 1
    build.check(build.library().head_product_wide(
        h.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(), Th, N,
        H, cols, plan["ctas"], *_head_ops(head), build.stream_of(h)),
        "head_product_wide")
    return out


def tcn_fused_forward(head, moves_out=None):
    """The forward pass over a head's move scores -> (move_in [N, T, S]
    f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32, end_state
    [N] int32): ``tcn_fused_forward_plain`` for a head on the CPU, kernel
    G on the card, or GW (``tcn_fused_forward_wide``) above MAX_S states.
    ``moves_out`` (``move_buffer``'s tensor, or None) receives the move
    scores where they are taken as a tensor, for ``tcn_fused_backward``."""
    if head.h.device.type == "cpu":
        return _forward_plain(head, moves_out)
    if _wide(head):
        return tcn_fused_forward_wide(head, moves_out)
    if moves_out is not None:
        raise ValueError("kernel G takes the move scores inside the kernel: "
                         "moves_out must be None")
    return _forward(tcn_fused_forward, "G", "decode_fused_fwd_bf16", head)


def tcn_fused_forward_old_kernel(head):
    """Kernel G's earlier kernel whatever the plan, for comparisons; counts
    no launch."""
    return _forward(None, "G", "decode_fused_fwd_bf16", head)


def tcn_fused_forward_wide(head, moves_out=None):
    """``tcn_fused_forward`` above MAX_S states: the plain version for a
    head on the CPU; on the card kernel GW, the head product
    (``head_product``, into ``moves_out`` where given) and then the forward
    pass over its f32 moves on B's ring, on ``wide_decode_plan``'s plan
    (recorded in ``.plan``), or the earlier GW where it gives None."""
    if head.h.device.type == "cpu":
        return _forward_plain(head, moves_out)
    shape = _checked("GW", head)
    plan = tcn_fused_forward_wide.plan = _wide_plan(head)
    if plan is None:
        if moves_out is not None:
            raise ValueError("the earlier GW takes the move scores inside "
                             "the kernel: moves_out must be None")
        return _forward(tcn_fused_forward_wide, "GW",
                        "decode_fused_wide_fwd_bf16", head)
    Th, N, _, S, U = shape
    moves = head_product(head, moves_out)
    dev = head.h.device
    out = (torch.empty(N, Th * U, S, device=dev),
           torch.empty(N, Th * U, S, dtype=torch.uint8, device=dev),
           torch.empty(N, Th * U, device=dev), torch.empty(N, device=dev),
           torch.empty(N, dtype=torch.int32, device=dev))
    blank = float(head.blank)
    tcn_fused_forward_wide.launches += 1
    build.check(build.library().decode_tcn_fwd_ring_f32(
        moves.data_ptr(), *(x.data_ptr() for x in out), N, Th * U, S,
        plan["fwd"]["ring"], math.exp(blank), blank, build.stream_of(moves)),
        "decode_tcn_fwd_ring_f32")
    return out


def tcn_fused_forward_wide_old_kernel(head):
    """Kernel GW's earlier kernel (``csrc/decode_tcn_fused_wide.cu``, the
    product in each pass) whatever the plan, for comparisons; counts no
    launch."""
    return _forward(None, "GW", "decode_fused_wide_fwd_bf16", head)


def tcn_fused_backward(head, move_in, choices, cs, logz, end_state,
                       qscale=1.0, qbias=0.0, moves=None):
    """The backward pass, traceback and emission -> {"sequence",
    "qstring", "moves"}, each [N, T] uint8: ``tcn_fused_backward_plain``
    for a head on the CPU, kernel J on the card, or JW
    (``tcn_fused_backward_wide``) above MAX_S states. ``moves``: the
    forward pass's move scores (its ``moves_out``), which JW and the plain
    version then read instead of taking the head product again."""
    fwd = (move_in, choices, cs, logz, end_state)
    if head.h.device.type == "cpu":
        return _backward_plain(head, fwd, qscale, qbias, moves)
    if _wide(head):
        return tcn_fused_backward_wide(head, *fwd, qscale, qbias, moves)
    if moves is not None:
        raise ValueError("kernel J takes the move scores inside the kernel: "
                         "moves must be None")
    return _backward(tcn_fused_backward, "J", "decode_fused_bwd_bf16", head,
                     fwd, qscale, qbias)


def tcn_fused_backward_old_kernel(head, move_in, choices, cs, logz,
                                  end_state, qscale=1.0, qbias=0.0):
    """Kernel J's earlier kernel whatever the plan, for comparisons; counts
    no launch."""
    return _backward(None, "J", "decode_fused_bwd_bf16", head,
                     (move_in, choices, cs, logz, end_state), qscale, qbias)


def tcn_fused_backward_wide(head, move_in, choices, cs, logz, end_state,
                            qscale=1.0, qbias=0.0, moves=None):
    """``tcn_fused_backward`` above MAX_S states: the plain version for a
    head on the CPU; on the card kernel JW, the backward pass on C's ring
    over ``moves`` (the forward pass's f32 move scores; where None, GW's
    head product takes them first), on ``wide_decode_plan``'s plan
    (recorded in ``.plan``), or the earlier JW where it gives None."""
    fwd = (move_in, choices, cs, logz, end_state)
    if head.h.device.type == "cpu":
        return _backward_plain(head, fwd, qscale, qbias, moves)
    shape = _checked("JW", head)
    plan = tcn_fused_backward_wide.plan = _wide_plan(head)
    if plan is None:
        if moves is not None:
            raise ValueError("the earlier JW takes the move scores inside "
                             "the kernel: moves must be None")
        return _backward(tcn_fused_backward_wide, "JW",
                         "decode_fused_wide_bwd_bf16", head, fwd, qscale,
                         qbias)
    Th, N, _, S, U = shape
    dev = head.h.device
    check_forward_outputs("kernel JW", dev, N, Th * U, S, *fwd)
    if moves is None:
        moves = head_product(head)
    _check_moves("JW", moves, head, shape)
    out = torch.empty(3, N, Th * U, dtype=torch.uint8, device=dev)
    tcn_fused_backward_wide.launches += 1
    build.check(build.library().decode_tcn_bwd_ring_f32(
        moves.data_ptr(), *(x.data_ptr() for x in fwd), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), N, Th * U, S,
        plan["bwd"]["ring"], math.exp(float(head.blank)), float(qscale),
        float(qbias), build.stream_of(moves)), "decode_tcn_bwd_ring_f32")
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


def tcn_fused_backward_wide_old_kernel(head, move_in, choices, cs, logz,
                                       end_state, qscale=1.0, qbias=0.0):
    """Kernel JW's earlier kernel whatever the plan, for comparisons;
    counts no launch."""
    return _backward(None, "JW", "decode_fused_wide_bwd_bf16", head,
                     (move_in, choices, cs, logz, end_state), qscale, qbias)


tcn_fused_forward.launches = 0
tcn_fused_forward.plan = None
tcn_fused_backward.launches = 0
tcn_fused_backward.plan = None
tcn_fused_forward_wide.launches = 0
tcn_fused_forward_wide.plan = None
tcn_fused_backward_wide.launches = 0
tcn_fused_backward_wide.plan = None
head_product.launches = 0
head_product.plan = None
