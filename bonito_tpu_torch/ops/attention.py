"""
Sliding-window (banded) attention for the transformer family, outside the
fused kernel: q, k, v [N, H, T, D] with rotary already applied. Query i
attends key j iff ``-left <= j - i <= right`` (upstream's flash-attn
``window_size``).

``attend`` dispatches by shape as bonito_tpu's does: no window -> dense;
a band that fits one 128-block -> the banded kernel L
(``ops.attention_cuda.local_attention``: the kernel on the card, its plain
version on the CPU); any other window -> dense with the band mask.
``dense_attention`` is the O(T^2) reference with bonito_tpu's arithmetic:
scores accumulated in f32, softmax in f32, probabilities cast to v's dtype
before the second product.
"""

import math

import torch

from bonito_tpu_torch.ops.attention_cuda import (
    band_mask, local_attention, local_supported)


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


def attend(q, k, v, window=None):
    """Banded attention by shape: see the module."""
    if window is None or tuple(window) == (-1, -1):
        return dense_attention(q, k, v)
    window = tuple(window)
    if local_supported(q, window):
        return local_attention(q, k, v, window)
    return dense_attention(q, k, v, window)
