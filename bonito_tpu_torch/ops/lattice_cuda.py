"""
Kernels Y and Z — the CTC alignment lattice's logZ and its gradient with
respect to the move scores (``csrc/lattice.cu``) — with their launch
counts. The plain versions, the autograd Function and the route are in
``ops/lattice.py``.

Y replaces ``bonito_tpu/ops/lattice_pallas.py:_fwd_kernel`` and Z
``_bwd_kernel``. They read the move scores [N, T, P-1] f32 that
``CTC_CRF.prepare_ctc_moves_tcn`` selects, the stay being the constant
blank. Bound by bytes on an H100 and latency-bound by design: one block
per batch row, the lattice's positions strided over its threads, so any
P runs.

Each wrapper launches its kernel for a CUDA tensor and raises for
anything else; it never runs the plain version.
"""

import torch

from bonito_tpu_torch.ops import build

MAX_POSITIONS = 227 * 1024 // 8  # alpha or beta, double buffered in shared memory


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


def lattice_forward(move, lengths, blank, with_stack=True):
    """Kernel Y: move [N, T, P-1] f32, lengths [N] int32 -> (alpha stack
    [N, T, P] f32 or None, logZ [N] f32)."""
    N, T, P = _check(move, lengths, "kernel Y")
    lib = build.library()
    dev = move.device
    stack = torch.empty(N, T, P, device=dev) if with_stack else None
    logz = torch.empty(N, device=dev)
    lattice_forward.launches += 1
    build.check(lib.lattice_fwd(
        move.data_ptr(), lengths.data_ptr(),
        None if stack is None else stack.data_ptr(), logz.data_ptr(), N, T,
        P, float(blank), build.stream_of(move)), "lattice_fwd")
    return stack, logz


def lattice_backward(move, stack, lengths, gz, sign, blank):
    """Kernel Z: the gradient of Y's logZ times g, from log|g| - logZ and
    sign(g) ([N] f32 each) -> d move [N, T, P-1] f32."""
    N, T, P = _check(move, lengths, "kernel Z")
    for key, x, shape in (("stack", stack, (N, T, P)), ("gz", gz, (N,)),
                          ("sign", sign, (N,))):
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != move.device or not x.is_contiguous()):
            raise ValueError(f"kernel Z: {key} must be a contiguous f32 "
                             f"{shape} on {move.device}")
    lib = build.library()
    dmove = torch.empty_like(move)
    lattice_backward.launches += 1
    build.check(lib.lattice_bwd(
        move.data_ptr(), stack.data_ptr(), lengths.data_ptr(), gz.data_ptr(),
        sign.data_ptr(), dmove.data_ptr(), N, T, P, float(blank),
        build.stream_of(move)), "lattice_bwd")
    return dmove


lattice_forward.launches = 0
lattice_backward.launches = 0
