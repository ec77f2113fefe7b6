"""
LSTM over [N, T, C] activations.

The input projection ``xw = x @ w_ih (+ b)`` for all timesteps is one
``torch.matmul`` in the model dtype (bonito_tpu leaves it to XLA outside
its Pallas kernel, ``lstm_pallas.py:106-108``). It is computed time-major,
so xw lands as the contiguous [T, N, 4H] the recurrence reads. The
recurrence is ``ops.lstm_cuda.lstm_recurrence``: the plain version on the
CPU, kernel A on the card, and an error for anything else — there is no
silent fallback. Torch gate order (i, f, g, o).

``lstm_int8`` is the quantised layer (bonito_tpu's ``ops/lstm.py:
lstm_int8``). Its route is an argument, not an environment variable, and
the same route runs on the CPU (plain versions) and on the card (kernels):

- ``"fused"``: kernel D, projection and recurrence in int8 from an int8
  input; the only route that can emit an int8 h for the next layer;
- ``"two_stage"``: ``project_int8`` outside, then kernel E;
- ``"dequant"``: the dequantised weights through ``lstm`` (kernel A) —
  what bonito_tpu runs off the TPU, and on it for small H, where its fused
  bf16 input-projection kernel stands in; that kernel is not ported yet,
  so ``lstm`` stands in for it here.
"""

import torch

from bonito_tpu_torch.ops import int8
from bonito_tpu_torch.ops.lstm_cuda import (  # noqa: F401 (re-exported)
    lstm_recurrence, lstm_recurrence_plain)
from bonito_tpu_torch.ops.lstm_int8_cuda import (
    fused_supported, lstm_int8_fused, lstm_int8_recurrence)

INT8_ROUTES = ("fused", "two_stage", "dequant")
SMALL_H = 256  # bonito_tpu's bound for its small-H (fast) routing


def lstm(x, w_ih, w_hh, b, reverse=False):
    """x [N, T, C]; w_ih [C, 4H]; w_hh [H, 4H]; b [4H] or None -> hidden
    states [N, T, H] (a transposed view of the [T, N, H] result)."""
    dtype = x.dtype
    xw = torch.matmul(x.transpose(0, 1), w_ih.to(dtype)).contiguous()
    if b is not None:
        xw.add_(b.to(dtype))  # in place: xw is a fresh tensor of its own
    h = lstm_recurrence(xw, w_hh.to(dtype), reverse=reverse)
    return h.transpose(0, 1)


def int8_route(x, w_hh_q, w_ih_q):
    """The route ``lstm_int8`` takes when none is named: the stand-in for
    the small-H kernel where bonito_tpu routes to it (a float input, a
    quantised projection, H <= 256), kernel D where its tiles fit, else
    the two-stage route."""
    C, H = x.shape[-1], w_hh_q.shape[0]
    if w_ih_q is not None and x.dtype != torch.int8 and H <= SMALL_H:
        return "dequant"
    if w_ih_q is not None and fused_supported(C, H):
        return "fused"
    return "two_stage"


def lstm_int8(x, w_ih, w_hh_q, scales, b, reverse=False, w_ih_q=None,
              ih_scales=None, out_int8=False, route=None):
    """Quantised LSTM over x [N, T, C] -> [N, T, H]. w_hh_q [H, 4H] int8
    with ``scales`` (the 1/127 step of h folded in); the projection is
    quantised too when ``w_ih_q``/``ih_scales`` are given (``w_ih`` is
    None then). ``x`` may be an int8 ``round(h * 127)`` from a previous
    quantised layer on every route; the result is int8 only with
    ``out_int8`` on the fused route, else bf16 there and the dtype of the
    (dequantised) input on the others."""
    if route is None:
        route = int8_route(x, w_hh_q, w_ih_q)
    if route not in INT8_ROUTES:
        raise ValueError(f"route {route!r}: expected one of {INT8_ROUTES}")
    if route == "fused":
        if w_ih_q is None:
            raise ValueError("the fused int8 route needs w_ih_q/ih_scales")
        xt = x.transpose(0, 1)
        if x.dtype == torch.int8:
            x_q, step = xt, int8.H_STEP
        else:
            x_q, step = int8.quantize_dynamic(xt)
        h = lstm_int8_fused(x_q, w_ih_q, w_hh_q, ih_scales.float() * step,
                            scales, b, reverse=reverse, out_int8=out_int8)
        return h.transpose(0, 1)
    if x.dtype == torch.int8:
        x = int8.dequantize_h(x, torch.bfloat16)
    dtype = x.dtype
    if route == "two_stage":
        xt = x.transpose(0, 1)
        if w_ih_q is not None:
            xw = int8.project_int8(xt, w_ih_q, ih_scales, b, dtype)
        else:
            xw = torch.matmul(xt, w_ih.to(dtype)).contiguous()
            if b is not None:
                xw.add_(b.to(dtype))
        return lstm_int8_recurrence(xw, w_hh_q, scales,
                                    reverse=reverse).transpose(0, 1)
    if w_ih is None:
        w_ih = (w_ih_q.float() * ih_scales.float()).to(dtype)
    w_hh = (w_hh_q.float() * scales.float() * 127.0).to(dtype)
    return lstm(x, w_ih, w_hh, b, reverse=reverse)
