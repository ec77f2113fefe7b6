"""
Transformer-CRF model family (upstream's "sup" v5 models), as bonito_tpu
builds it: conv downsample x12 -> N x [windowed multi-head attention with
rotary embeddings + SwiGLU gated MLP, RMSNorm post-norm, DeepNorm
alpha-scaled residuals] -> linear upsample x2 -> LinearCRFEncoder head.
Activations are [N, T, C]; linear weights keep bonito_tpu's [in, out]
layout (``x @ w``), so a checkpoint carries across by name.

The attention of a layer takes one of two routes, chosen by shape as in
bonito_tpu: fused, rotary + band-masked attention in one kernel from the
packed qkv (``ops.attention_cuda.fused_rotary_window_attention``, kernel
K), wherever that kernel takes the head shape; else local,
``apply_rotary`` and then ``ops.attention.attend`` (kernel L for a band
that fits, dense otherwise). Where a gradient is wanted (grad mode on and
qkv requiring grad, as in ``training.make_train_step``; bonito_tpu's
``ctx["train"]``) the fused route is ``ops.attention.fused_attention_train``
(kernels H and O) and the local route ``attend(..., differentiable=True)``
(plain torch under autograd): K and L keep no graph. The output is the same
either way. ``set_attn_route(model, "local")``, or
``load_model(..., attn_route="local")``, puts every layer on the local
route, which is what bonito_tpu computes off the TPU. The two round
differently (K rounds its operands and probabilities to bf16 whatever the
model's dtype), so the route is part of the result. The projections,
RMSNorm, SwiGLU and the residuals are plain torch, as they are plain XLA
in bonito_tpu.

bonito_tpu's int8 projections (``--quantize`` with calibrated ``amax``
scales) and rematerialisation (its opt-in ``jax.checkpoint`` of a layer)
wait for their slices.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from bonito_tpu_torch import nn
from bonito_tpu_torch.checkpoint import same, transpose
from bonito_tpu_torch.crf.model import SeqdistModel  # registers "seqdistmodel"
from bonito_tpu_torch.ops.attention import attend, fused_attention_train
from bonito_tpu_torch.ops.attention_cuda import (
    fused_rotary_window_attention, fused_supported)

def set_attn_route(model, attn_route):
    """Name the attention route of every attention layer of ``model`` (a
    model without one is left as it is): ``"local"``, rotary and then
    ``ops.attention.attend``; None, bonito_tpu's default by shape (fused
    wherever the fused kernel takes the head shape). Returns the model."""
    if attn_route not in (None, "local"):
        raise ValueError(f"attn_route {attn_route!r}: expected None or "
                         f"'local'")
    for m in model.modules():
        if hasattr(m, "attn_route"):
            m.attn_route = attn_route
    return model


def deepnorm_params(depth):
    """DeepNorm (arXiv:2203.00555) residual and init scalars."""
    alpha = round((2 * depth) ** 0.25, 7)
    beta = round((8 * depth) ** (-1 / 4), 7)
    return alpha, beta


def _xavier(rng, shape, gain=1.0):
    std = gain * math.sqrt(2.0 / (shape[0] + shape[-1]))
    return rng.normal(size=shape) * std


@nn.register
class RMSNorm(nn.Layer):
    """x / rms(x) * scale over the channels, computed in f32."""

    def __init__(self, d_model, eps=1e-5):
        super().__init__()
        self.d_model = d_model
        self.eps = eps
        self.scale = torch.nn.Parameter(torch.ones(d_model))

    def forward(self, x):
        xf = x.float()
        var = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        # the scale in x's dtype first, as bonito_tpu casts every parameter
        # for a bf16 forward of f32 master weights
        return (y * self.scale.to(x.dtype).float()).to(x.dtype)

    def to_dict(self):
        return {"d_model": self.d_model, "eps": self.eps}


_freqs = {}


def rotary_freqs(T, rotary_dim, base=10000.0, device=None):
    """cos, sin [T, rotary_dim / 2] f32, computed with numpy in f64 as
    bonito_tpu does (the kernels read these tables: computing them on the
    card would not match), cached per (T, rotary_dim, base, device)."""
    device = torch.device("cpu" if device is None else device)
    key = (T, rotary_dim, base, device)
    if key not in _freqs:
        inv = 1.0 / (base ** (np.arange(0, rotary_dim, 2) / rotary_dim))
        freqs = np.outer(np.arange(T), inv)
        _freqs[key] = tuple(
            torch.tensor(f(freqs), dtype=torch.float32, device=device)
            for f in (np.cos, np.sin))
    return _freqs[key]


def apply_rotary(x, cos, sin):
    """Non-interleaved rotary on the leading rotary_dim of the head dim,
    in x's dtype. x [N, T, H, D]; cos/sin [T, r/2]."""
    r2 = cos.shape[-1]
    x1, x2, x_pass = x[..., :r2], x[..., r2:2 * r2], x[..., 2 * r2:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, x_pass], dim=-1)


class MultiHeadAttention(nn.Layer):
    """Windowed self-attention with rotary embeddings; ``wqkv``
    [d_model, 3 d_model] and ``out_w`` [d_model, d_model] as in
    bonito_tpu."""

    def __init__(self, d_model, nhead, qkv_bias=False, out_bias=True,
                 rotary_dim=None, attn_window=None):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is no multiple of nhead "
                             f"{nhead}")
        self.d_model = d_model
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.rotary_dim = self.head_dim if rotary_dim is None else rotary_dim
        self.attn_window = None if attn_window is None else tuple(attn_window)
        self.attn_route = None
        self.wqkv = torch.nn.Parameter(torch.zeros(d_model, 3 * d_model))
        self.out_w = torch.nn.Parameter(torch.zeros(d_model, d_model))
        self.qkv_b = (torch.nn.Parameter(torch.zeros(3 * d_model))
                      if qkv_bias else None)
        self.out_b = (torch.nn.Parameter(torch.zeros(d_model))
                      if out_bias else None)

    def route(self, qkv):
        """"fused" or "local" for this qkv: fused wherever kernel K takes
        the shape, unless ``attn_route`` says local."""
        fits = self.attn_window is not None and fused_supported(
            qkv, self.attn_window, self.rotary_dim)
        return "fused" if fits and self.attn_route is None else "local"

    def forward(self, x):
        N, T, _ = x.shape
        qkv = torch.matmul(x, self.wqkv.to(x.dtype))
        if self.qkv_b is not None:
            qkv = qkv + self.qkv_b.to(x.dtype)
        qkv = qkv.reshape(N, T, 3, self.nhead, self.head_dim)
        cos, sin = rotary_freqs(T, self.rotary_dim, device=x.device)
        grad = torch.is_grad_enabled() and qkv.requires_grad
        if self.route(qkv) == "fused":
            fused = (fused_attention_train if grad
                     else fused_rotary_window_attention)
            o = fused(qkv, cos, sin, self.attn_window)
        else:
            q = apply_rotary(qkv[:, :, 0], cos, sin)
            k = apply_rotary(qkv[:, :, 1], cos, sin)
            v = qkv[:, :, 2]
            # [N, T, H, D] -> [N, H, T, D]
            q, k, v = (t.transpose(1, 2) for t in (q, k, v))
            o = attend(q, k, v, window=self.attn_window,
                       differentiable=grad).transpose(1, 2)
        o = torch.matmul(o.reshape(N, T, self.d_model),
                         self.out_w.to(x.dtype))
        if self.out_b is not None:
            o = o + self.out_b.to(x.dtype)
        return o


class GatedMlp(nn.Layer):
    """SwiGLU feed-forward: ``fc1`` packs [value; gate], out =
    fc2(value * silu(gate))."""

    def __init__(self, d_model, hidden_features):
        super().__init__()
        self.d_model = d_model
        self.hidden = hidden_features
        self.fc1 = torch.nn.Parameter(torch.zeros(d_model, 2 * hidden_features))
        self.fc2 = torch.nn.Parameter(torch.zeros(hidden_features, d_model))

    def forward(self, x):
        y = torch.matmul(x, self.fc1.to(x.dtype))
        y, gate = y.chunk(2, dim=-1)
        return torch.matmul(y * F.silu(gate), self.fc2.to(x.dtype))


@nn.register
class TransformerEncoderLayer(nn.Layer):
    """x = norm1(attn(x) + alpha x); x = norm2(ff(x) + alpha x)."""

    # ask nn.Stack for a layout pin at the stack's input
    pin_input_layout = True

    def __init__(self, d_model, nhead, dim_feedforward, deepnorm_alpha,
                 deepnorm_beta, attn_window=None):
        super().__init__()
        self.kwargs = {
            "d_model": d_model, "nhead": nhead,
            "dim_feedforward": dim_feedforward,
            "deepnorm_alpha": deepnorm_alpha,
            "deepnorm_beta": deepnorm_beta,
            "attn_window": attn_window,
        }
        self.d_model = d_model
        self.deepnorm_alpha = deepnorm_alpha
        self.deepnorm_beta = deepnorm_beta
        self.self_attn = MultiHeadAttention(
            d_model, nhead, qkv_bias=False, out_bias=True,
            attn_window=attn_window)
        self.ff = GatedMlp(d_model, dim_feedforward)
        self.norm1 = RMSNorm(d_model)
        self.norm2 = RMSNorm(d_model)

    def forward(self, x):
        # h + alpha x in one pass with one rounding, as XLA's fused
        # elementwise chain computes it (not alpha x rounded, then the sum)
        a = self.deepnorm_alpha
        x = self.norm1(torch.add(self.self_attn(x), x, alpha=a))
        return self.norm2(torch.add(self.ff(x), x, alpha=a))

    def to_dict(self):
        return dict(self.kwargs)

    def torch_param_map(self, path):
        """Upstream's keys of this layer (its flash-attn module names) ->
        the port's, for ``checkpoint.import_torch_checkpoint``."""
        return [
            (f"{path}.self_attn.Wqkv.weight", f"{path}.self_attn.wqkv",
             transpose),
            (f"{path}.self_attn.out_proj.weight", f"{path}.self_attn.out_w",
             transpose),
            (f"{path}.self_attn.out_proj.bias", f"{path}.self_attn.out_b",
             same),
            (f"{path}.ff.fc1.weight", f"{path}.ff.fc1", transpose),
            (f"{path}.ff.fc2.weight", f"{path}.ff.fc2", transpose),
            (f"{path}.norm1.weight", f"{path}.norm1.scale", same),
            (f"{path}.norm2.weight", f"{path}.norm2.scale", same),
        ]

    def init_(self, rng):
        """DeepNorm's beta-scaled xavier draws, as bonito_tpu's
        ``init_params``: gain 1 for the q and k columns of ``wqkv``, beta
        for its v columns, ``out_w``, ``fc1`` and ``fc2``."""
        beta, d = self.deepnorm_beta, self.d_model
        nn._fill(self.ff.fc1, _xavier(rng, self.ff.fc1.shape, beta))
        nn._fill(self.ff.fc2, _xavier(rng, self.ff.fc2.shape, beta))
        nn._fill(self.self_attn.out_w, _xavier(rng, (d, d), beta))
        nn._fill(self.self_attn.wqkv, np.concatenate(
            [_xavier(rng, (d, 2 * d)), _xavier(rng, (d, d), beta)], axis=1))


def Model(config):
    """A transformer SeqdistModel from a bonito-style config: the whole
    model tree sits under ``[model]``."""
    model_dict = {k: v for k, v in config["model"].items() if k != "package"}
    model = nn.from_dict(model_dict)
    if not isinstance(model, SeqdistModel):
        raise ValueError(f"config [model] builds a {type(model).__name__}, "
                         f"not a seqdistmodel")
    model.config = config
    return model
