"""
int8 quantisation arithmetic shared by the quantised LSTM and CRF head.

Weights are quantised once, at load, in numpy f32 — the same operations
in the same order as bonito_tpu's ``quantize_cols``/``quantize_whh``
(``ops/lstm_pallas.py``), so the int8 weights and their scales are
bit-identical to that package's. Activations are quantised on the device
in torch: an LSTM's h is bounded by 1, so its step is the static 1/127;
a conv output is unbounded and takes a dynamic per-tensor step.

``int_matmul`` and ``project_int8`` are plain products outside any
kernel (XLA in bonito_tpu): ``torch._int_mm`` on the card, an int32
matmul on the CPU. Both are exact integer arithmetic.
"""

import numpy as np
import torch

H_STEP = 1.0 / 127.0  # the static activation step of a bounded LSTM h


def quantize_cols(w):
    """Per-output-column symmetric int8 quantisation of a [C, O] weight:
    (w_q int8 [C, O], col_scale f32 [1, O]) with w ~= w_q * col_scale.
    An all-zero column gets scale 1."""
    w = np.asarray(w, np.float32)
    col_max = np.abs(w).max(axis=0)
    col_scale = np.where(col_max > 0, col_max / 127.0, 1.0)
    w_q = np.clip(np.round(w / col_scale), -127, 127).astype(np.int8)
    return w_q, col_scale.astype(np.float32)[None, :]


def quantize_whh(w_hh):
    """``quantize_cols`` for the recurrent weight, with the static 1/127
    step of h folded into the scales."""
    w_q, col_scale = quantize_cols(w_hh)
    return w_q, col_scale / 127.0


def quantize_h(h):
    """A bounded activation (|h| <= 1) as int8 steps of 1/127, rounding
    half to even."""
    return torch.round(h.float() * 127.0).to(torch.int8)


def dequantize_h(h_q, dtype):
    return (h_q.float() * H_STEP).to(dtype)


def quantize_dynamic(x):
    """Per-tensor dynamic quantisation: (x_q int8, step) with the step a
    0-d f32 tensor, max|x| / 127 over the whole tensor, floored at 1e-8."""
    xf = x.float()
    step = torch.clamp(xf.abs().max(), min=1e-8) / 127.0
    return torch.round(xf / step).to(torch.int8), step


def int_matmul(a_q, w_q):
    """Exact int8 product a_q [M, K] @ w_q [K, O] -> int32 [M, O]. On the
    card ``torch._int_mm``, which wants more than 16 rows (fewer are padded
    here) and K and O multiples of 8 (it raises otherwise)."""
    if a_q.device.type == "cuda":
        M = a_q.shape[0]
        if M > 16:
            return torch._int_mm(a_q, w_q)
        a_q = torch.nn.functional.pad(a_q, (0, 0, 0, 17 - M))
        return torch._int_mm(a_q, w_q)[:M]
    return torch.matmul(a_q.to(torch.int32), w_q.to(torch.int32))


def project_int8(x, w_ih_q, ih_scales, b, dtype):
    """The quantised input projection of the two-stage route for all
    timesteps at once: x [T, N, C] float -> xw [T, N, 4H] in ``dtype``,
    dynamic per-tensor activation step, int32 product, f32 rescale."""
    T, N, C = x.shape
    x_q, step = quantize_dynamic(x)
    xw = int_matmul(x_q.reshape(T * N, C), w_ih_q).float()
    # in place: at hac widths xw is 2.6 GB in f32
    xw.mul_(step * ih_scales.float().reshape(1, -1))
    if b is not None:
        xw.add_(b.float())
    return xw.to(dtype).reshape(T, N, -1)
