"""
Kernels Y and Z — the CTC alignment lattice's logZ and its gradient with
respect to the move scores (``csrc/lattice.cu``) — with their launch
counts. The plain versions, the autograd Function and the route are in
``ops/lattice.py``.

Y replaces ``bonito_tpu/ops/lattice_pallas.py:_fwd_kernel`` and Z
``_bwd_kernel``. They read the move scores [N, T, P-1] f32 that
``CTC_CRF.prepare_ctc_moves_tcn`` selects, the stay being the constant
blank. Bound by bytes on an H100. Y where ``lattice_fwd_plan`` gives no
plan, and Z where ``lattice_plan`` gives none, is the earlier design: one
block per batch row, the lattice's positions strided over its threads, one
barrier a frame, so any P runs. On their plans both are split over warps:
a CTA a row, K positions a thread, alpha (Y) or beta (Z) in registers, the
neighbour's value by shuffle and between warps through shared memory with
one barrier a frame, move (and Z's stack) read D frames ahead into
registers. ``lattice_forward_old_kernel`` and
``lattice_backward_old_kernel`` run the earlier kernels whatever the plan
(no count), for comparisons: the outputs are equal bit for bit.

Each wrapper launches its kernel for a CUDA tensor and raises for
anything else; it never runs the plain version.
"""

import functools

import torch

from bonito_tpu_torch.ops import build

MAX_POSITIONS = 227 * 1024 // 8  # alpha or beta, double buffered in shared memory
# Z split over warps (csrc/lattice.cu:lattice_bwd_split): positions a
# thread (the instances built, each with the prefetch depths built; 4 and 8
# positions a thread were slower at every training shape, and a CTA of 32
# warps leaves them too few registers), the most warps a CTA may have, and
# its shared memory (each warp's edge value by parity)
Z_POSITIONS = (1, 2)
Z_DEPTHS = {1: (8, 16), 2: (4, 8)}
Z_WARPS_MAX = 32
Z_SMEM = 2 * Z_WARPS_MAX * 4
# Y split over warps (csrc/lattice.cu:lattice_fwd_split): the same
# positions a thread, warps and shared memory as Z's, and the prefetch
# depth built for each (Y reads no stack, so one position a thread takes
# 32 frames; 16 was slower at every training shape, and at two positions a
# thread 16 slower than 8: scripts/lattice_split.py y)
Y_DEPTHS = {1: (32,), 2: (8,)}


def z_prefetch(k, warps):
    """Frames of move and stack a thread reads ahead, as measured fastest
    (scripts/lattice_split.py on an H100): 16 at one position a thread up
    to 24 warps (beyond, their 62 registers a thread fill the register
    file), else 8."""
    return 16 if k == 1 and warps <= 24 else 8


def y_prefetch(k, warps):
    """Frames of move a thread of Y reads ahead (``Y_DEPTHS``)."""
    return Y_DEPTHS[k][0]


def _split_plan(name, N, T, P, sms, prefetch):
    """One CTA a row; the fewest positions a thread (``Z_POSITIONS``)
    that keep the CTA to Z_WARPS_MAX warps of 32 threads, with
    ``prefetch``'s depth. None for P below 2 or above 2048; a ValueError
    above MAX_POSITIONS, which no kernel takes."""
    if P > MAX_POSITIONS:
        raise ValueError(f"kernel {name} takes at most {MAX_POSITIONS} "
                         f"lattice positions, got P={P}")
    if N < 1 or T < 1 or P < 2:
        return None
    k = next((k for k in Z_POSITIONS if -(-P // (32 * k)) <= Z_WARPS_MAX),
             None)
    if k is None:
        return None
    warps = -(-P // (32 * k))
    return {"ctas": N, "waves": None if sms is None else -(-N // sms),
            "positions_per_thread": k, "warps": warps, "threads": 32 * warps,
            "prefetch": prefetch(k, warps), "smem": Z_SMEM}


@functools.lru_cache(maxsize=None)
def lattice_fwd_plan(N, T, P, sms=None):
    """Y's plan for moves [N, T, P-1] on a card of ``sms`` SMs: Z's split
    (``_split_plan``) with ``y_prefetch``'s depth. None (the earlier Y) for
    P below 2 or above 2048; a ValueError above MAX_POSITIONS."""
    return _split_plan("Y", N, T, P, sms, y_prefetch)


@functools.lru_cache(maxsize=None)
def lattice_plan(N, T, P, sms=None):
    """Z's plan for moves [N, T, P-1] on a card of ``sms`` SMs: one CTA a
    row; the fewest positions a thread (``Z_POSITIONS``) that keep the CTA
    to Z_WARPS_MAX warps of 32 threads, with ``z_prefetch``'s depth. None
    (the earlier Z) for P below 2 or above 2048; a ValueError above
    MAX_POSITIONS, which no kernel takes."""
    return _split_plan("Z", N, T, P, sms, z_prefetch)


def _check(move, lengths, name):
    if move.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {move.device}")
    if (move.dtype != torch.float32 or move.dim() != 3
            or not move.is_contiguous()):
        raise ValueError(f"{name} takes contiguous f32 moves [N, T, P-1]")
    N, T, Pm = move.shape
    P = Pm + 1
    if N < 1 or T < 1 or P > MAX_POSITIONS:
        raise ValueError(f"{name}: moves {tuple(move.shape)} need N, T >= 1 "
                         f"and at most {MAX_POSITIONS} positions")
    if (tuple(lengths.shape) != (N,) or lengths.dtype != torch.int32
            or lengths.device != move.device or not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be a contiguous int32 [{N}] "
                         f"on {move.device}")
    return N, T, P


def _sms(tensor):
    return torch.cuda.get_device_properties(
        tensor.device).multi_processor_count


def _forward(wrapper, move, lengths, blank, with_stack):
    """Y's checks and launch: split over warps on ``lattice_fwd_plan``'s
    plan where ``wrapper`` is Y's counter and the plan is not None, else
    the earlier kernel; the launch counted on ``wrapper`` (None: no
    count)."""
    N, T, P = _check(move, lengths, "kernel Y")
    lib = build.library()
    dev = move.device
    stack = torch.empty(N, T, P, device=dev) if with_stack else None
    logz = torch.empty(N, device=dev)
    plan = None
    if wrapper is not None:
        plan = lattice_fwd_plan(N, T, P, _sms(move))
        wrapper.plan = plan
        wrapper.launches += 1
    args = (move.data_ptr(), lengths.data_ptr(),
            None if stack is None else stack.data_ptr(), logz.data_ptr(), N,
            T, P)
    if plan is None:
        build.check(lib.lattice_fwd(*args, float(blank),
                                    build.stream_of(move)), "lattice_fwd")
    else:
        build.check(lib.lattice_fwd_split(
            *args, plan["positions_per_thread"], plan["prefetch"],
            float(blank), build.stream_of(move)), "lattice_fwd_split")
    return stack, logz


def lattice_forward(move, lengths, blank, with_stack=True):
    """Kernel Y: move [N, T, P-1] f32, lengths [N] int32 -> (alpha stack
    [N, T, P] f32 or None, logZ [N] f32); split over warps on
    ``lattice_fwd_plan``'s plan (``lattice_forward.plan`` holds the last
    call's), else the earlier kernel."""
    return _forward(lattice_forward, move, lengths, blank, with_stack)


def lattice_forward_old_kernel(move, lengths, blank, with_stack=True):
    """Kernel Y's earlier kernel whatever the plan, for comparisons;
    counts no launch."""
    return _forward(None, move, lengths, blank, with_stack)


def _backward(wrapper, move, stack, lengths, gz, sign, blank):
    """Z's checks and launch: split over warps on ``lattice_plan``'s plan
    where ``wrapper`` is Z's counter and the plan is not None, else the
    earlier kernel; the launch counted on ``wrapper`` (None: no count)."""
    N, T, P = _check(move, lengths, "kernel Z")
    for key, x, shape in (("stack", stack, (N, T, P)), ("gz", gz, (N,)),
                          ("sign", sign, (N,))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != move.device or not x.is_contiguous()):
            raise ValueError(f"kernel Z: {key} must be a contiguous f32 "
                             f"{shape} on {move.device}")
    lib = build.library()
    dmove = torch.empty_like(move)
    plan = None
    if wrapper is not None:
        plan = lattice_plan(N, T, P, _sms(move))
        wrapper.plan = plan
        wrapper.launches += 1
    args = (move.data_ptr(), stack.data_ptr(), lengths.data_ptr(),
            gz.data_ptr(), sign.data_ptr(), dmove.data_ptr(), N, T, P)
    if plan is None:
        build.check(lib.lattice_bwd(*args, float(blank),
                                    build.stream_of(move)), "lattice_bwd")
    else:
        build.check(lib.lattice_bwd_split(
            *args, plan["positions_per_thread"], plan["prefetch"],
            float(blank), build.stream_of(move)), "lattice_bwd_split")
    return dmove


def lattice_backward(move, stack, lengths, gz, sign, blank):
    """Kernel Z: the gradient of Y's logZ times g, from log|g| - logZ and
    sign(g) ([N] f32 each) -> d move [N, T, P-1] f32; split over warps on
    ``lattice_plan``'s plan (``lattice_backward.plan`` holds the last
    call's), else the earlier kernel."""
    return _backward(lattice_backward, move, stack, lengths, gz, sign, blank)


def lattice_backward_old_kernel(move, stack, lengths, gz, sign, blank):
    """Kernel Z's earlier kernel whatever the plan, for comparisons; counts
    no launch."""
    return _backward(None, move, stack, lengths, gz, sign, blank)


lattice_forward.launches = 0
lattice_forward.plan = None
lattice_backward.launches = 0
lattice_backward.plan = None
