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

A [B, R, C] view of [B, C, R] memory (the sup stack's input) takes a
transpose at any T, in bf16 and f32: the 16-byte one where its rows are
whole 16-byte rows, the tiles of 32 R elsewhere (T 250 in f32 at
``evaluate``'s batch, T 999 in bf16); ``pin_layout_old_kernel`` runs the
earlier plan, which sent those other shapes to the element gather.
"""

import ctypes

import torch

from bonito_tpu_torch.ops import build

MAX_DIMS = 8
UNITS = (1, 2, 4, 8)  # element sizes the gather moves
# the C entry of each transpose variant
ENTRIES = {"transpose": "relayout_transpose_any",
           "tiles": "relayout_transpose_tiles_any"}


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


def relayout_plan(sizes, strides, itemsize, aligned=True, earlier=False):
    """Which variant of kernel P copies a tensor of these sizes and element
    strides (no dimension empty), and its arguments:

    ("transpose", B, R, C, sb, sc, itemsize)   memory [B, C, R] to [B, R, C]
                                               in whole 16-byte rows
    ("tiles", B, R, C, sb, sc, itemsize)       the same at any R, C, strides
                                               and start
    ("gather", sizes, strides, unit)           ``unit`` bytes per element: 16
                                               for whole 16-byte rows

    ``aligned``: the tensor starts at a 16-byte address. A [B, R, C] view
    of [B, C, R] memory takes the 16-byte transpose where R, C and the
    strides are whole 16-byte rows at a 16-byte start (faster there:
    chip_smoke.py times both at sup's bf16 [128, 1000, 512]), the tiles at
    any other shape. ``earlier``: the plan of the earlier kernel P
    (``pin_layout_old_kernel``), which sent those other shapes to the
    gather."""
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
    if itemsize in (2, 4) and len(dims) in (2, 3) and dims[-2][1] == 1:
        (R, _), (C, sc) = dims[-2:]
        B, sb = dims[0] if len(dims) == 3 else (1, 0)
        if aligned and all(v % epv == 0 for v in (R, C, sb, sc)):
            return ("transpose", B, R, C, sb, sc, itemsize)
        if not earlier:
            return ("tiles", B, R, C, sb, sc, itemsize)
    return ("gather", [n for n, _ in dims], [s for _, s in dims], itemsize)


def _array(values):
    return (ctypes.c_longlong * len(values))(*values)


def pin_layout(x):
    """``pin_layout_plain``'s function: the plain version for a CPU tensor,
    kernel P for a CUDA tensor of any strides (its plan recorded in
    ``.plan``); through ``PinLayout`` where a gradient is wanted."""
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


def _pin(x, earlier=False):
    """Kernel P on ``relayout_plan``'s plan, counted in ``pin_layout``; the
    earlier kernel's plan, uncounted, where ``earlier``."""
    if x.device.type == "cpu":
        return pin_layout_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"kernel P needs a CUDA tensor, got {x.device}")
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    plan = relayout_plan(list(x.shape), list(x.stride()), x.element_size(),
                         aligned=x.data_ptr() % 16 == 0, earlier=earlier)
    lib = build.library()
    if not earlier:
        pin_layout.plan = plan
        pin_layout.launches += 1
    if plan[0] in ENTRIES:
        _, B, R, C, sb, sc, unit = plan
        rc = getattr(lib, ENTRIES[plan[0]])(
            x.data_ptr(), out.data_ptr(), B, R, C, sb, sc, unit,
            build.stream_of(x))
    else:
        _, sizes, strides, unit = plan
        rc = lib.relayout_gather_any(
            x.data_ptr(), out.data_ptr(), len(sizes), _array(sizes),
            _array(strides), unit, build.stream_of(x))
    build.check(rc, f"relayout ({plan[0]})")
    return out


def pin_layout_old_kernel(x):
    """The earlier kernel P on ``relayout_plan(..., earlier=True)``'s plan
    (CUDA tensors only): what chip_smoke.py and the card tests hold the
    tiles against. It counts no launch."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel P needs a CUDA tensor, got {x.device}")
    return _pin(x, earlier=True)


pin_layout.launches = 0
pin_layout.plan = None  # the last counted call's
