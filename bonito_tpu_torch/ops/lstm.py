"""
LSTM over [N, T, C] activations, torch gate order (i, f, g, o).

``lstm`` takes one of two routes, chosen by shape before any launch and
alike on the CPU (plain versions) and on the card (kernels):

- a small layer (``small_h``: H <= 256, C and H multiples of 16) runs
  ``ops.lstm_fused_cuda.lstm_fused``, kernel F: the input projection
  inside the kernel, accumulated and kept in f32. It is where bonito_tpu
  runs ``lstm_pallas_fused`` (its ``supported_fused``);
- any other layer computes ``xw = x @ w_ih (+ b)`` for all timesteps as
  one ``torch.matmul`` in the model dtype (bonito_tpu leaves it to XLA
  outside its Pallas kernel, ``lstm_pallas.py:106-108``), time-major, so
  that xw lands as the contiguous [T, N, 4H] which
  ``ops.lstm_cuda.lstm_recurrence``, kernel A, reads.

The two differ in arithmetic (A reads xw rounded to the model dtype), so
the gate is part of the result. Neither wrapper falls back: a tensor on
the card launches the kernel or raises.

``lstm_int8`` is the quantised layer (bonito_tpu's ``ops/lstm.py:
lstm_int8``). Its route is an argument, not an environment variable, and
the same route runs on the CPU (plain versions) and on the card (kernels):

- ``"fused"``: kernel D, projection and recurrence in int8 from an int8
  input; the only route that can emit an int8 h for the next layer;
- ``"two_stage"``: ``project_int8`` outside, then kernel E;
- ``"dequant"``: the dequantised weights through ``lstm`` — what
  bonito_tpu runs off the TPU, and on it for a small layer with a float
  input (every layer of a quantised fast model), which it sends through
  ``lstm_pallas_fused`` (``ops/lstm.py:108-122``) as ``lstm`` sends it
  through kernel F.

``lstm_train`` is the layer in training (bonito_tpu's ``lstm_train``,
kernel-table row 8): the projection as in ``lstm``, under autograd, then
the recurrence through ``LSTMRecurrence``, kernels R and S, whatever H is
(bonito_tpu trains a small layer through the same kernels, not through
its small-H one).
"""

import torch

from bonito_tpu_torch.ops import int8
from bonito_tpu_torch.ops.lstm_cuda import (  # noqa: F401 (re-exported)
    lstm_recurrence, lstm_recurrence_plain)
# small_h(C, H): whether a layer runs kernel F. It is bonito_tpu's
# ``supported_fused`` (H <= 256, C and H tiling) by shape; that gate's other
# two terms are the TPU's and are not carried over: the batch need not be a
# multiple of 8 (sublanes), and the VMEM budget is replaced by kernel F's own
# limit (C and H multiples of 16, the WMMA tile; C up to 1024).
from bonito_tpu_torch.ops.lstm_fused_cuda import (
    fused_supported as small_h, lstm_fused)
from bonito_tpu_torch.ops.lstm_int8_cuda import (
    fused_supported, lstm_int8_fused, lstm_int8_recurrence)
from bonito_tpu_torch.ops.lstm_train_cuda import (
    lstm_train_backward, lstm_train_forward)

INT8_ROUTES = ("fused", "two_stage", "dequant")


def lstm(x, w_ih, w_hh, b, reverse=False):
    """x [N, T, C]; w_ih [C, 4H]; w_hh [H, 4H]; b [4H] or None -> hidden
    states [N, T, H] (a transposed view of the [T, N, H] result)."""
    dtype = x.dtype
    if small_h(x.shape[-1], w_hh.shape[0]):
        h = lstm_fused(x.transpose(0, 1), w_ih.to(dtype), w_hh.to(dtype), b,
                       reverse=reverse)
        return h.transpose(0, 1)
    xw = torch.matmul(x.transpose(0, 1), w_ih.to(dtype)).contiguous()
    if b is not None:
        xw.add_(b.to(dtype))  # in place: xw is a fresh tensor of its own
    h = lstm_recurrence(xw, w_hh.to(dtype), reverse=reverse)
    return h.transpose(0, 1)


def int8_route(x, w_hh_q, w_ih_q):
    """The route ``lstm_int8`` takes when none is named: the dequantised
    weights through kernel F where bonito_tpu sends them through its
    small-H kernel (a float input, a quantised projection, ``small_h``),
    kernel D where its tiles fit, else the two-stage route."""
    C, H = x.shape[-1], w_hh_q.shape[0]
    if w_ih_q is not None and x.dtype != torch.int8 and small_h(C, H):
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


def train_supported(x, w_hh):
    """bonito_tpu's ``supported_train`` gate by shape (its TPU backend test
    left out): H a multiple of 8, and its VMEM model of W_hh plus the
    double-buffered per-step streams of R and S (lane-padded to 128) under
    90 MB. Where it holds, c, the gates and their gradient are rounded to
    bf16, as its kernels round them; where it fails they stay f32 (it runs
    its scan there)."""
    N, _, _ = x.shape
    H = w_hh.shape[0]
    if H % 8:
        return False
    eff = lambda d: -(-d // 128) * 128  # noqa: E731
    G = 4 * H
    itemsize = 2 if x.dtype in (torch.bfloat16, torch.float16) else 4
    whh = H * G * itemsize
    fwd = 2 * N * (eff(G) * itemsize + eff(H) * itemsize + eff(H) * 2
                   + eff(G) * 2)
    bwd = 2 * N * (2 * eff(G) * 2 + 3 * eff(H) * 2)
    scratch = 2 * N * eff(H) * 4
    return whh + max(fwd, bwd) + scratch < 90 * 1024 * 1024


class LSTMRecurrence(torch.autograd.Function):
    """h [T, N, H] of xw [T, N, 4H] and w_hh [H, 4H] (both in the model
    dtype) through R, and their gradients through S: bonito_tpu's
    ``_lstm_rec`` custom VJP. The forward keeps (w_hh, h, c, acts), not
    xw. The backward returns dxw = dgates in h's dtype and dW_hh =
    sum_t h_prev^T dgates, h_prev being h one step back in the
    recurrence's direction (0 at its first step), as one torch.matmul in
    the model dtype (cuBLAS sums in f32) over the steps that have one."""

    @staticmethod
    def forward(ctx, xw, w_hh, reverse, round_bf16):
        h, c, acts = lstm_train_forward(xw, w_hh, reverse, round_bf16)
        ctx.save_for_backward(w_hh, h, c, acts)
        ctx.reverse, ctx.round_bf16 = reverse, round_bf16
        return h

    @staticmethod
    def backward(ctx, g_h):
        w_hh, h, c, acts = ctx.saved_tensors
        dgates = lstm_train_backward(
            w_hh, acts, c, g_h.to(h.dtype).contiguous(), ctx.reverse,
            ctx.round_bf16)
        T, N, H = h.shape
        dtype = torch.promote_types(h.dtype, dgates.dtype)
        # the step that reads h[s] as its h_prev: s + 1, or s - 1 reversed
        h_prev, dg = (h[1:], dgates[:-1]) if ctx.reverse else (h[:-1],
                                                                dgates[1:])
        dw = torch.matmul(h_prev.reshape(-1, H).t().to(dtype),
                          dg.reshape(-1, 4 * H).to(dtype))
        return dgates.to(h.dtype), dw.to(w_hh.dtype), None, None


def lstm_train(x, w_ih, w_hh, b, reverse=False):
    """The differentiable layer: x [N, T, C] -> h [N, T, H] (a transposed
    view of [T, N, H]), the projection xw = x @ w_ih (+ b) in x's dtype
    under autograd, then ``LSTMRecurrence``, rounded to bf16 inside where
    ``train_supported`` holds. A CUDA tensor that R or S does not take
    raises."""
    dtype = x.dtype
    xw = torch.matmul(x.transpose(0, 1), w_ih.to(dtype))
    if b is not None:
        xw = xw + b.to(dtype)
    h = LSTMRecurrence.apply(xw.contiguous(), w_hh.to(dtype), bool(reverse),
                             train_supported(x, w_hh))
    return h.transpose(0, 1)
