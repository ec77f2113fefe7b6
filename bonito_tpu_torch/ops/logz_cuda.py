"""
Kernels U, V, W and X — the CRF partition function and its gradient for
the training loss (``csrc/logz.cu``) — with their launch counts. The plain
versions, the autograd Functions and the routes are in ``ops/logz.py``.

U replaces ``bonito_tpu/ops/logz_pallas.py:_fwd_kernel_tcn`` (and
``_fwd_kernel_tcn_nockpt``: U without its stack), V ``_bwd_kernel_tcn``,
W ``_fwd_kernel`` (and ``_fwd_kernel_nockpt``), X ``_bwd_kernel``. U and V
read the decode layout: moves [N, T, nb*S], each frame's columns in
(b, j, r) order, with a constant stay ``blank`` — the memory that
``Model.forward_tcn``'s [T, S*nb, N] view lies on. W and X read full
scores [N, T, S*(nb+1)] with a stay plane. Both are bound by bytes on an
H100 and, like the decode kernels, latency-bound by design: one block per
batch row, one thread per state, one recursion step per frame.

Each wrapper launches its kernel for a CUDA tensor and raises for
anything else; it never runs the plain version.
"""

import torch

from bonito_tpu_torch.ops import build

NB = 4  # n_base; the kernels are written for the 4-letter alphabet
STATES = (4, 16, 64, 256, 1024)  # S = 4**k, one thread each


def _check(scores, full, name):
    """(N, T, S) of a score tensor kernel ``name`` takes: a contiguous
    bf16 or f32 CUDA tensor [N, T, S*nb] (S*(nb+1) when ``full``)."""
    if scores.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {scores.device}")
    if scores.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bf16 or f32 scores, got "
                        f"{scores.dtype}")
    if scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError(f"{name} takes contiguous scores [N, T, C]")
    N, T, C = scores.shape
    width = NB + 1 if full else NB
    S = C // width
    if C != width * S or S not in STATES or N < 1 or T < 1:
        raise ValueError(f"{name}: scores {tuple(scores.shape)} need "
                         f"{width}*S columns with S in {STATES}")
    return N, T, S


def _check_f32(name, device, **tensors):
    for key, (x, shape) in tensors.items():
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous f32 "
                             f"{shape} on {device}")


def _forward(fn, name, scores, full, blank, round_bf16, with_stack):
    N, T, S = _check(scores, full, name)
    lib = build.library()
    dev = scores.device
    stack = torch.empty(N, T, S, device=dev) if with_stack else None
    logz = torch.empty(N, device=dev)
    fn.launches += 1
    build.check(lib.logz_fwd(
        scores.data_ptr(), int(scores.dtype == torch.float32), int(full),
        int(round_bf16), None if stack is None else stack.data_ptr(),
        logz.data_ptr(), N, T, S, float(blank), build.stream_of(scores)),
        "logz_fwd")
    return stack, logz


def _backward(fn, name, scores, full, stack, logz, g, blank, round_bf16,
              out_dtype):
    N, T, S = _check(scores, full, name)
    _check_f32(name, scores.device, stack=(stack, (N, T, S)),
               logz=(logz, (N,)), g=(g, (N,)))
    out_dtype = scores.dtype if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} writes bf16 or f32, not {out_dtype}")
    lib = build.library()
    grad = torch.empty(scores.shape, dtype=out_dtype, device=scores.device)
    fn.launches += 1
    build.check(lib.logz_bwd(
        scores.data_ptr(), int(scores.dtype == torch.float32), int(full),
        int(round_bf16), stack.data_ptr(), logz.data_ptr(), g.data_ptr(),
        grad.data_ptr(), int(out_dtype == torch.float32), N, T, S,
        float(blank), build.stream_of(scores)), "logz_bwd")
    return grad


def tcn_forward(moves, blank, round_bf16=True, with_stack=True):
    """Kernel U: moves [N, T, nb*S] (TCN column order), stay ``blank`` ->
    (alpha stack [N, T, S] f32 or None, logZ [N] f32)."""
    return _forward(tcn_forward, "kernel U", moves, False, blank,
                    round_bf16, with_stack)


def tcn_backward(moves, stack, logz, g, blank, round_bf16=True,
                 out_dtype=None):
    """Kernel V: d logZ / d moves x g, [N, T, nb*S] in ``out_dtype`` (the
    moves' own by default)."""
    return _backward(tcn_backward, "kernel V", moves, False, stack, logz, g,
                     blank, round_bf16, out_dtype)


def full_forward(scores, round_bf16=True, with_stack=True):
    """Kernel W: full scores [N, T, (nb+1)*S] -> (alpha stack or None,
    logZ [N] f32)."""
    return _forward(full_forward, "kernel W", scores, True, 0.0, round_bf16,
                    with_stack)


def full_backward(scores, stack, logz, g, round_bf16=True, out_dtype=None):
    """Kernel X: d logZ / d scores x g, [N, T, (nb+1)*S]."""
    return _backward(full_backward, "kernel X", scores, True, stack, logz, g,
                     0.0, round_bf16, out_dtype)


tcn_forward.launches = 0
tcn_backward.launches = 0
full_forward.launches = 0
full_backward.launches = 0
