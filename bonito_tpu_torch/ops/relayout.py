"""
Kernel P — the layout pin (``csrc/relayout.cu``) — with its plain PyTorch
version and its launch count.

Replaces ``bonito_tpu/ops/relayout.py:pin_layout`` (``_copy``): the
identity in values, a row-major contiguous copy in memory. The stack of
transformer layers asks for it at its input (``nn.Stack``), where the
activation is a [N, T, C] view of a convolution's [N, C, T] output; the pin
is then the one transpose that the stack's layers would otherwise each pay
for. An already contiguous tensor is copied too, as the TPU entry does.

``pin_layout`` runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; it never falls back from one to the
other. ``relayout_plan`` picks the kernel's variant from the sizes and
strides alone, so the CPU tests reach it. Where a gradient is wanted it
goes through ``PinLayout``, the TPU entry's custom gradient: the copy
forward and the copy of the cotangent backward (kernel P twice on the
card, both counted in ``pin_layout.launches``).
"""

import ctypes

import torch

from bonito_tpu_torch.ops import build

MAX_DIMS = 8
UNITS = (1, 2, 4, 8)  # element sizes the gather moves


def pin_layout_plain(x):
    """A row-major contiguous copy of ``x`` (always a copy)."""
    return x.clone(memory_format=torch.contiguous_format)


def _collapse(sizes, strides):
    """Drop dimensions of size 1 and merge neighbours that are contiguous
    with each other; the order of the elements does not change."""
    dims = [(n, s) for n, s in zip(sizes, strides) if n != 1]
    out = []
    for n, s in dims:
        if out and out[-1][1] == s * n:
            out[-1] = (out[-1][0] * n, s)
        else:
            out.append((n, s))
    return out or [(1, 1)]


def relayout_plan(sizes, strides, itemsize, aligned=True):
    """Which variant of kernel P copies a tensor of these sizes and element
    strides (no dimension empty), and its arguments:

    ("transpose", B, R, C, sb, sc, itemsize)   memory [B, C, R] to [B, R, C]
    ("gather", sizes, strides, unit)           ``unit`` bytes per element: 16
                                               for whole 16-byte rows

    ``aligned``: the tensor starts at a 16-byte address."""
    if itemsize not in UNITS:
        raise TypeError(f"pin_layout moves elements of {UNITS} bytes, got "
                        f"{itemsize}")
    dims = _collapse(sizes, strides)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"pin_layout takes up to {MAX_DIMS} dimensions "
                         f"that do not merge, got {len(dims)}")
    epv = 16 // itemsize
    if aligned and dims[-1][1] == 1 and all(
            v % epv == 0 for v in [dims[-1][0]] + [s for _, s in dims[:-1]]):
        return ("gather", [n for n, _ in dims[:-1]] + [dims[-1][0] // epv],
                [s // epv for _, s in dims[:-1]] + [1], 16)
    if (aligned and itemsize in (2, 4) and len(dims) in (2, 3)
            and dims[-2][1] == 1):
        (R, _), (C, sc) = dims[-2:]
        B, sb = dims[0] if len(dims) == 3 else (1, 0)
        if all(v % epv == 0 for v in (R, C, sb, sc)):
            return ("transpose", B, R, C, sb, sc, itemsize)
    return ("gather", [n for n, _ in dims], [s for _, s in dims], itemsize)


def _array(values):
    return (ctypes.c_longlong * len(values))(*values)


def pin_layout(x):
    """``pin_layout_plain``'s function: the plain version for a CPU tensor,
    kernel P for a CUDA tensor of any strides; through ``PinLayout`` where
    a gradient is wanted."""
    if torch.is_grad_enabled() and x.requires_grad:
        return PinLayout.apply(x)
    return _pin(x)


class PinLayout(torch.autograd.Function):
    """The identity with both directions pinned, as bonito_tpu's
    ``pin_layout`` VJP: the cotangent is copied row-major too."""

    @staticmethod
    def forward(ctx, x):
        return _pin(x)

    @staticmethod
    def backward(ctx, g):
        return _pin(g)


def _pin(x):
    if x.device.type == "cpu":
        return pin_layout_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"kernel P needs a CUDA tensor, got {x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    plan = relayout_plan(list(x.shape), list(x.stride()), x.element_size(),
                         aligned=x.data_ptr() % 16 == 0)
    lib = build.library()
    pin_layout.launches += 1
    if plan[0] == "transpose":
        _, B, R, C, sb, sc, unit = plan
        rc = lib.relayout_transpose_any(
            x.data_ptr(), out.data_ptr(), B, R, C, sb, sc, unit,
            build.stream_of(x))
    else:
        _, sizes, strides, unit = plan
        rc = lib.relayout_gather_any(
            x.data_ptr(), out.data_ptr(), len(sizes), _array(sizes),
            _array(strides), unit, build.stream_of(x))
    build.check(rc, f"relayout ({plan[0]})")
    return out


pin_layout.launches = 0
