"""
Sliding-window (banded) attention for the transformer family, and the
differentiable routes around the kernels. Query i attends key j iff
``-left <= j - i <= right`` (upstream's flash-attn ``window_size``).

``attend`` (q, k, v [N, H, T, D] with rotary already applied) dispatches
by shape as bonito_tpu's does: no window -> dense; a band that fits one
128-block -> the banded kernel L (``ops.attention_cuda.local_attention``:
the kernel on the card, its plain version on the CPU); any other window ->
dense with the band mask. With ``differentiable=True`` (a gradient is
wanted) the fitting band goes through ``local_attention_blocked`` instead,
plain torch under autograd with the arithmetic of bonito_tpu's XLA
``local_attention``: kernel L keeps no graph, and bonito_tpu's
``attend(differentiable=True)`` never calls its kernel either.

``fused_attention_train`` is the fused route where a gradient is wanted:
an autograd Function whose forward is kernel H (o and each query's lse)
and whose backward is kernel O (dqkv), their plain versions on the CPU;
bonito_tpu's ``fused_rotary_window_attention_train``. cos and sin get no
gradient, as that function's VJP returns zeros for them.

``dense_attention`` is the O(T^2) reference with bonito_tpu's arithmetic:
scores accumulated in f32, softmax in f32, probabilities cast to v's dtype
before the second product.
"""

import math

import torch
import torch.nn.functional as F

from bonito_tpu_torch.ops import attention_cuda
from bonito_tpu_torch.ops.attention_cuda import (
    BLOCK, NEG, band_mask, local_attention, local_supported)


def sliding_window_mask(T, window, device=None):
    """Dense [T, T] band mask: True where key j is visible to query i."""
    return band_mask(T, window, None, device)


def dense_attention(q, k, v, window=None):
    """Reference O(T^2) attention. q/k/v: [N, H, T, D]."""
    D = q.shape[-1]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    scores = scores / math.sqrt(D)
    if window is not None:
        mask = sliding_window_mask(q.shape[2], window, q.device)
        scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def local_attention_blocked(q, k, v, window, block=BLOCK):
    """Banded attention in key blocks, bonito_tpu's XLA ``local_attention``
    in plain torch (differentiable): T padded to a block multiple with
    masked keys, each query block against its [previous | own | next] key
    blocks, scores from f32 operands, a -1e30 mask, softmax in f32,
    probabilities cast to v's dtype before the second product. q/k/v
    [N, H, T, D]; left < block and right <= block."""
    left, right = window
    N, H, T, D = q.shape
    B = block
    Tp = -(-T // B) * B
    if Tp != T:
        q, k, v = (F.pad(t, (0, 0, 0, Tp - T)) for t in (q, k, v))
    nb = Tp // B

    def windows(t):  # [N, H, nb, 3B, D]: [prev | self | next] blocks
        tp = F.pad(t.reshape(N, H, nb, B, D), (0, 0, 0, 0, 1, 1))
        return torch.cat([tp[:, :, :-2], tp[:, :, 1:-1], tp[:, :, 2:]], dim=3)

    scores = torch.matmul(q.reshape(N, H, nb, B, D).float(),
                          windows(k).float().transpose(-1, -2)) / math.sqrt(D)
    qq = torch.arange(B, device=q.device)[:, None]
    kk = torch.arange(3 * B, device=q.device)[None, :]
    delta = kk - B - qq
    band = (delta >= -left) & (delta <= right)
    kabs = torch.arange(nb, device=q.device)[:, None, None] * B + (kk - B)
    valid = (kabs >= 0) & (kabs < T)
    scores = torch.where(band & valid, scores, NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, windows(v))
    return out.reshape(N, H, Tp, D)[:, :, :T]


def attend(q, k, v, window=None, differentiable=False):
    """Banded attention by shape: see the module."""
    if window is None or tuple(window) == (-1, -1):
        return dense_attention(q, k, v)
    window = tuple(window)
    if differentiable and 0 <= window[0] < BLOCK and 0 <= window[1] <= BLOCK:
        return local_attention_blocked(q, k, v, window)
    if not differentiable and local_supported(q, window):
        return local_attention(q, k, v, window)
    return dense_attention(q, k, v, window)


class FusedAttention(torch.autograd.Function):
    """Forward kernel H, backward kernel O (their plain versions for CPU
    tensors): rotary + banded attention from the packed qkv with the TPU
    kernels' rounding in both directions."""

    @staticmethod
    def forward(ctx, qkv, cos, sin, window, t_real):
        o, lse = attention_cuda.fused_rotary_window_attention_train(
            qkv, cos, sin, window, t_real)
        ctx.save_for_backward(qkv, cos, sin, lse, o)
        ctx.window, ctx.t_real = window, t_real
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, cos, sin, lse, o = ctx.saved_tensors
        dqkv = attention_cuda.fused_rotary_window_attention_bwd(
            qkv, cos, sin, lse, o, do.contiguous(), ctx.window, ctx.t_real)
        zero = lambda t, wanted: torch.zeros_like(t) if wanted else None
        return (dqkv, zero(cos, ctx.needs_input_grad[1]),
                zero(sin, ctx.needs_input_grad[2]), None, None)


def fused_attention_train(qkv, cos, sin, window, t_real=None):
    """qkv [N, T, 3, H, D]; cos/sin [T, r2] f32 -> o [N, T, H, D] (as
    kernel K gives it) under autograd: kernels H and O on the card."""
    return FusedAttention.apply(qkv, cos, sin, tuple(window), t_real)
