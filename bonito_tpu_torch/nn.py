"""
Layer zoo: torch ``nn.Module``s behind the TOML-driven registry that
bonito_tpu's (and upstream bonito's) ``config.toml`` files name.

- Activations are [N, T, C] at every layer boundary, as in bonito_tpu,
  so the two packages compare layer by layer. Convolutions transpose to
  torch's [N, C, T] around ``conv1d`` internally.
- Parameter names follow bonito_tpu's parameter tree, so a flat
  dot-keyed bonito_tpu checkpoint maps onto ``state_dict`` keys; only
  the conv weight changes layout ([W, I, O] there, [O, I, W] here — the
  converter in ``checkpoint.py`` transposes it).
- A layer starts in inference mode (``training`` False), as bonito_tpu's
  ``apply`` without a train context; ``.train()`` switches a model to what
  its train step runs: BatchNorm on batch statistics with a pending
  running-stat update, and a float LSTM through ``ops.lstm.lstm_train``
  (kernels R and S on the card).

- ``LSTM.quantize_params`` and ``LinearCRFEncoder.quantize_head_params``
  give the int8 forms of bonito_tpu's quantised parameter tree (the same
  names and shapes), as buffers: ``to_bf16`` casts parameters only.

- ``Stack`` (a layer spec repeated ``depth`` times) and ``NamedSerial``
  (children named by their config keys) build the transformer family's
  encoder; ``from_dict`` defers to a type's own ``from_dict`` where it has
  one. The conv-CTC family's blocks are built from its config's
  ``[[block]]`` list (``ctc/model.py``), not through the registry.
- ``GELU`` is bonito_tpu's, ``jax.nn.gelu``'s default: the tanh
  approximation, not upstream bonito's exact erf form (ROADMAP, known
  limits).
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from bonito_tpu_torch.ops import int8
from bonito_tpu_torch.ops.lstm import lstm, lstm_int8, lstm_train
from bonito_tpu_torch.ops.relayout import pin_layout

layers = {}


def register(layer_cls):
    layer_cls.name = layer_cls.__name__.lower()
    layers[layer_cls.name] = layer_cls
    return layer_cls


def to_dict(layer):
    return {"type": layer.name, **layer.to_dict()}


def from_dict(model_dict, layer_types=None):
    if not isinstance(model_dict, dict):
        return model_dict
    model_dict = dict(model_dict)
    if layer_types is None:
        layer_types = layers
    type_name = model_dict.pop("type")
    if type_name not in layer_types:
        raise NotImplementedError(
            f"unknown layer type {type_name!r} (the transformer layers "
            f"register when bonito_tpu_torch.transformer is imported)")
    typ = layer_types[type_name]
    if hasattr(typ, "from_dict"):
        return typ.from_dict(model_dict, layer_types)
    if "sublayers" in model_dict:
        sub = model_dict["sublayers"]
        model_dict["sublayers"] = (
            [from_dict(x, layer_types) for x in sub]
            if isinstance(sub, list) else from_dict(sub, layer_types))
    return typ(**model_dict)


class Layer(torch.nn.Module):
    """Architecture node: a module with a config round-trip, in inference
    mode until ``.train()``."""

    def __init__(self):
        super().__init__()
        self.training = False

    def to_dict(self):
        return {}

    def output_stride(self, stride):
        return stride

    def init_(self, rng):
        """Fill parameters with random values drawn from ``rng``, a numpy
        Generator: numpy's draws are the same on every machine and torch
        version, so a model made from a seed is too."""


def get_stride(layer):
    return layer.output_stride(1)


def _fill(param, value):
    with torch.no_grad():
        param.copy_(torch.from_numpy(np.asarray(value, np.float32)))


def _orthogonal(rng, rows, cols):
    """A (semi-)orthogonal [rows, cols] matrix, QR of a normal draw."""
    a = rng.normal(size=(max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    return q if rows >= cols else q.T


# ---------------------------------------------------------------------------
# activations and glue
# ---------------------------------------------------------------------------

@register
class ReLU(Layer):
    def forward(self, x):
        return F.relu(x)


@register
class Tanh(Layer):
    def forward(self, x):
        return torch.tanh(x)


@register
class Swish(Layer):
    def forward(self, x):
        return F.silu(x)


@register
class GELU(Layer):
    """The tanh approximation, as bonito_tpu's ``jax.nn.gelu``."""

    def forward(self, x):
        return F.gelu(x, approximate="tanh")


def make_activation(activation):
    if activation is None or isinstance(activation, Layer):
        return activation
    return layers[activation]()


@register
class Serial(Layer):
    """Sublayers in order; children are named "0", "1", ... so parameter
    paths match bonito_tpu's tree."""

    def __init__(self, sublayers):
        super().__init__()
        for i, layer in enumerate(sublayers):
            self.add_module(str(i), layer)

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x

    def to_dict(self):
        return {"sublayers": [to_dict(l) for l in self.children()]}

    def output_stride(self, stride):
        for layer in self.children():
            stride = layer.output_stride(stride)
        return stride

    def init_(self, rng):
        for layer in self.children():
            layer.init_(rng)


@register
class Stack(Serial):
    """``depth`` copies of one layer spec. A layer class can ask for a
    layout pin at the stack's input (``pin_input_layout``): the activation
    arrives as a [N, T, C] view of a convolution's [N, C, T] output, and
    ``ops.relayout.pin_layout`` makes it row-major once instead of every
    layer's first matmul paying for the strides.

    bonito_tpu also pads the tokens to a block multiple here for its
    attention kernel; the port's kernel takes a ragged T as it is."""

    @classmethod
    def from_dict(cls, model_dict, layer_types=None):
        return cls([from_dict(model_dict["layer"], layer_types)
                    for _ in range(model_dict["depth"])])

    def forward(self, x):
        first = next(self.children(), None)
        if getattr(first, "pin_input_layout", False):
            x = pin_layout(x)
        return super().forward(x)

    def to_dict(self):
        layers_ = list(self.children())
        return {"layer": to_dict(layers_[0]), "depth": len(layers_)}


@register
class NamedSerial(Layer):
    """Sublayers in order, each a child under its config key, so parameter
    paths match bonito_tpu's tree (``encoder.conv.0.w``,
    ``encoder.transformer_encoder.3.self_attn.wqkv``, ``encoder.crf.w``)."""

    @classmethod
    def from_dict(cls, model_dict, layer_types=None):
        return cls({k: from_dict(v, layer_types)
                    for k, v in model_dict.items()})

    def __init__(self, named_layers):
        super().__init__()
        for name, layer in dict(named_layers).items():
            self.add_module(name, layer)

    def forward(self, x):
        for layer in self.children():
            x = layer(x)
        return x

    def to_dict(self):
        return {k: to_dict(v) for k, v in self.named_children()}

    def output_stride(self, stride):
        for layer in self.children():
            stride = layer.output_stride(stride)
        return stride

    def init_(self, rng):
        for layer in self.children():
            layer.init_(rng)


@register
class Permute(Layer):
    """Layout glue of torch-layout configs; the identity on [N, T, C]
    activations. ``dims`` is kept for config round-trips."""

    def __init__(self, dims):
        super().__init__()
        self.dims = list(dims)

    def forward(self, x):
        return x

    def to_dict(self):
        return {"dims": self.dims}


@register
class MakeContiguous(Layer):
    """Layout glue of torch-layout configs; the identity here, as in
    bonito_tpu (``nn.py:MakeContiguous``)."""

    def forward(self, x):
        return x


@register
class Reverse(Layer):
    """Runs its sublayers on the time-reversed sequence and flips the
    result back. The sublayers sit under ``layer`` (a Serial for a list),
    so parameter paths match bonito_tpu's tree (``encoder.4.layer.0.w``)."""

    def __init__(self, sublayers):
        super().__init__()
        self.layer = (Serial(sublayers) if isinstance(sublayers, list)
                      else sublayers)

    def forward(self, x):
        return self.layer(x.flip(1)).flip(1)

    def to_dict(self):
        if isinstance(self.layer, Serial):
            return self.layer.to_dict()
        # a single wrapped layer nests its typed dict, so that from_dict
        # builds it again
        return {"sublayers": to_dict(self.layer)}

    def output_stride(self, stride):
        return self.layer.output_stride(stride)

    def init_(self, rng):
        self.layer.init_(rng)


@register
class Clamp(Layer):
    def __init__(self, min, max):
        super().__init__()
        self.min, self.max = min, max

    def forward(self, x):
        return torch.clamp(x, self.min, self.max)

    def to_dict(self):
        return {"min": self.min, "max": self.max}


# ---------------------------------------------------------------------------
# parametric layers
# ---------------------------------------------------------------------------

@register
class Linear(Layer):
    """x @ w (+ b): ``w`` [in, out], as in bonito_tpu."""

    def __init__(self, in_features, out_features, bias=True):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.w = torch.nn.Parameter(torch.zeros(in_features, out_features))
        self.b = (torch.nn.Parameter(torch.zeros(out_features)) if bias
                  else None)

    @property
    def bias(self):
        return self.b is not None

    def forward(self, x):
        y = torch.matmul(x, self.w.to(x.dtype))
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y

    def to_dict(self):
        return {"in_features": self.in_features,
                "out_features": self.out_features, "bias": self.bias}

    def init_(self, rng):
        _fill(self.w, rng.normal(size=self.w.shape)
              / math.sqrt(self.in_features))


@register
class BatchNorm(Layer):
    """BatchNorm over the channels of [N, T, C] activations. mean/var stay
    f32 under ``to_bf16``.

    In training (and always without ``track_running_stats``) it normalises
    by the batch's mean and (biased) variance over (N, T), computed in f32
    and rounded to x's dtype as bonito_tpu's ``jnp.mean``/``jnp.var`` are.
    The running statistics do not change in the forward: it leaves
    ``pending``, bonito_tpu's update ``(1 - m) * running + m * batch`` (the
    unbiased variance) from the running statistics as they stand, and the
    train step writes it with ``apply_pending`` after the optimiser step,
    so that under grad accumulation the last microbatch's update is the one
    kept, as in bonito_tpu (``training.py:148-168``)."""

    def __init__(self, num_features, eps=1e-05, momentum=0.1, affine=True,
                 track_running_stats=True):
        super().__init__()
        self.num_features = num_features
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        self.track_running_stats = track_running_stats
        if affine:
            self.scale = torch.nn.Parameter(torch.ones(num_features))
            self.bias = torch.nn.Parameter(torch.zeros(num_features))
        if track_running_stats:
            self.register_buffer("mean", torch.zeros(num_features))
            self.register_buffer("var", torch.ones(num_features))
        self.pending = None

    def forward(self, x):
        if self.training or not self.track_running_stats:
            xf = x.float()
            mean = xf.mean((0, 1)).to(x.dtype)
            var = xf.var((0, 1), unbiased=False).to(x.dtype)
            if self.training and self.track_running_stats:
                m, n = self.momentum, x.shape[0] * x.shape[1]
                unbiased = (var * n / max(n - 1, 1)).detach()
                self.pending = ((1 - m) * self.mean + m * mean.detach(),
                                (1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt((var + self.eps).float()).to(x.dtype)
        y = (x - mean.to(x.dtype)) * inv
        if self.affine:
            y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return y

    def apply_pending(self):
        """Write the running-stat update of the last training forward."""
        if self.pending is not None:
            with torch.no_grad():
                self.mean.copy_(self.pending[0])
                self.var.copy_(self.pending[1])
            self.pending = None

    def to_dict(self):
        return {"num_features": self.num_features, "eps": self.eps,
                "momentum": self.momentum, "affine": self.affine,
                "track_running_stats": self.track_running_stats}


@register
class Convolution(Layer):
    """1-D convolution (+ optional norm + activation) over [N, T, C];
    weight ``w`` [O, I, W] (torch's conv1d layout)."""

    conv_weight_names = ("w",)  # [W, I, O] in a bonito_tpu checkpoint

    def __init__(self, insize, size, winlen, stride=1, padding=0, bias=True,
                 activation=None, norm=None):
        super().__init__()
        self.insize = insize
        self.size = size
        self.winlen = winlen
        self.stride = stride
        self.padding = padding
        self.w = torch.nn.Parameter(torch.zeros(size, insize, winlen))
        self.b = torch.nn.Parameter(torch.zeros(size)) if bias else None
        self.activation = make_activation(activation)
        if isinstance(norm, dict):
            norm = from_dict(norm)
        elif isinstance(norm, str):
            norm = layers[norm](size)
        self.norm = norm

    @property
    def bias(self):
        return self.b is not None

    def forward(self, x):
        y = F.conv1d(x.transpose(1, 2), self.w.to(x.dtype),
                     None if self.b is None else self.b.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        y = y.transpose(1, 2)
        if self.norm is not None:
            y = self.norm(y)
        if self.activation is not None:
            y = self.activation(y)
        return y

    def to_dict(self):
        res = {"insize": self.insize, "size": self.size, "bias": self.bias,
               "winlen": self.winlen, "stride": self.stride,
               "padding": self.padding}
        if self.activation is not None:
            res["activation"] = self.activation.name
        if self.norm is not None:
            norm_dict = to_dict(self.norm)
            default = to_dict(type(self.norm)(self.norm.num_features))
            res["norm"] = self.norm.name if norm_dict == default else norm_dict
        return res

    def output_stride(self, stride):
        return stride * self.stride

    def init_(self, rng):
        fan_in = self.insize * self.winlen
        _fill(self.w, rng.normal(size=self.w.shape) / math.sqrt(fan_in))


@register
class LSTM(Layer):
    """Unidirectional LSTM over [N, T, C]; torch gate order (i, f, g, o),
    ``w_ih`` [C, 4H], ``w_hh`` [H, 4H], ``b`` [4H] as in bonito_tpu. The
    layer runs in ``ops.lstm``: a small one (H <= 256) wholly in kernel F,
    a wide one as one projection matmul and kernel A's recurrence.
    ``reverse`` walks time backwards.

    After ``quantize_params`` the layer holds bonito_tpu's quantised form
    instead — ``w_hh_q``/``w_ih_q`` int8 with ``scales``/``ih_scales``
    [1, 4H] f32, and ``b`` in f32, all buffers — and runs
    ``ops.lstm.lstm_int8`` on ``int8_route`` (None: the shape gate's
    choice). ``int8_out`` makes the fused route emit ``round(h * 127)``
    int8 for a quantised consumer. In training a float layer runs
    ``ops.lstm.lstm_train`` (kernels R and S) whatever its H; a quantised
    one keeps its int8 route, as in bonito_tpu."""

    def __init__(self, size, insize, bias=True, reverse=False):
        super().__init__()
        self.size = size
        self.insize = insize
        self.reverse = bool(reverse)
        self.w_ih = torch.nn.Parameter(torch.zeros(insize, 4 * size))
        self.w_hh = torch.nn.Parameter(torch.zeros(size, 4 * size))
        self.b = torch.nn.Parameter(torch.zeros(4 * size)) if bias else None
        self.int8_out = False
        self.int8_route = None

    @property
    def bias(self):
        return self.b is not None

    @property
    def quantized(self):
        return self.w_hh is None

    def forward(self, x):
        if self.quantized:
            return lstm_int8(x, None, self.w_hh_q, self.scales, self.b,
                             reverse=self.reverse, w_ih_q=self.w_ih_q,
                             ih_scales=self.ih_scales,
                             out_int8=self.int8_out, route=self.int8_route)
        if self.training:
            return lstm_train(x, self.w_ih, self.w_hh, self.b,
                              reverse=self.reverse)
        return lstm(x, self.w_ih, self.w_hh, self.b, reverse=self.reverse)

    def set_quantized(self, w_hh_q, scales, w_ih_q, ih_scales):
        """Replace the float weights by their int8 form (numpy arrays or
        tensors of bonito_tpu's shapes); ``b`` becomes an f32 buffer, the
        type the int8 kernels read it in."""
        if self.quantized:
            raise ValueError("the layer is quantised already")
        device = self.w_hh.device
        H, C = self.size, self.insize
        for name, value, dtype, shape in (
                ("w_hh_q", w_hh_q, torch.int8, (H, 4 * H)),
                ("scales", scales, torch.float32, (1, 4 * H)),
                ("w_ih_q", w_ih_q, torch.int8, (C, 4 * H)),
                ("ih_scales", ih_scales, torch.float32, (1, 4 * H))):
            value = torch.tensor(np.asarray(value)).to(device=device,
                                                       dtype=dtype)
            if tuple(value.shape) != shape:
                raise ValueError(f"{name}: shape {tuple(value.shape)}, "
                                 f"expected {shape}")
            self.register_buffer(name, value)
        self.w_ih = self.w_hh = None
        if isinstance(self.b, torch.nn.Parameter):
            b = self.b.detach().float()
            del self.b
            self.register_buffer("b", b)

    def quantize_params(self):
        """Full-cell int8 quantisation of the weights as they stand (so
        after a bf16 cast, of the bf16-rounded values): w_hh per column
        with the static 1/127 step of h folded in, w_ih per column against
        a dynamic per-tensor activation step. Nothing to do when already
        quantised."""
        if self.quantized:
            return
        w_hh_q, scales = int8.quantize_whh(
            self.w_hh.detach().float().cpu().numpy())
        w_ih_q, ih_scales = int8.quantize_cols(
            self.w_ih.detach().float().cpu().numpy())
        self.set_quantized(w_hh_q, scales, w_ih_q, ih_scales)

    def to_dict(self):
        return {"size": self.size, "insize": self.insize, "bias": self.bias,
                "reverse": self.reverse}

    def init_(self, rng):
        """bonito_tpu's scheme: an orthogonal block per gate, and a bias of
        0.5 x a normal truncated at 2 standard deviations."""
        for w in (self.w_ih, self.w_hh):
            rows, cols = w.shape[0], w.shape[1] // 4
            _fill(w, np.concatenate(
                [_orthogonal(rng, rows, cols) for _ in range(4)], axis=1))
        if self.b is not None:
            b = rng.normal(size=self.b.shape)
            while (far := np.abs(b) > 2).any():
                b[far] = rng.normal(size=int(far.sum()))
            _fill(self.b, 0.5 * b)


@register
class LinearCRFEncoder(Layer):
    """Projects features to CRF transition scores [N, T, n_score]. With a
    fixed ``blank_score`` only the n_base**(state_len+1) move scores are
    learned (``w`` [H, out_size]); ``forward`` expands the blank (stay)
    column in front of each state's n_base move columns.

    ``quantize_head_params`` adds int8 weights ``w_q`` [H, out_size] with
    ``w_s`` [1, out_size] beside the float ``w``; the projection then runs
    as an int8 product against an input in steps of 1/127 — exact only
    for a bounded LSTM h, so ``SeqdistModel.quantize`` calls it for
    LSTM -> head pairs only."""

    SLAB_ROWS = 1 << 15  # rows of [N*T, H] per int8 product (see project)

    def __init__(self, insize, n_base, state_len, bias=True, scale=None,
                 activation=None, blank_score=None, expand_blanks=True,
                 permute=None):
        super().__init__()
        self.insize = insize
        self.n_base = n_base
        self.state_len = state_len
        self.scale = scale
        self.activation = make_activation(activation)
        self.blank_score = blank_score
        self.expand_blanks = expand_blanks
        self.permute = permute
        self.out_size = (
            n_base ** (state_len + 1) if blank_score is not None
            else (n_base + 1) * n_base ** state_len)
        self.w = torch.nn.Parameter(torch.zeros(insize, self.out_size))
        self.b = torch.nn.Parameter(torch.zeros(self.out_size)) if bias else None
        self.register_buffer("w_q", None)
        self.register_buffer("w_s", None)

    @property
    def bias(self):
        return self.b is not None

    def set_quantized_head(self, w_q, w_s):
        device = self.w.device
        self.w_q = torch.tensor(np.asarray(w_q)).to(device=device,
                                                    dtype=torch.int8)
        self.w_s = torch.tensor(np.asarray(w_s)).to(device=device,
                                                    dtype=torch.float32)
        if (tuple(self.w_q.shape) != tuple(self.w.shape)
                or tuple(self.w_s.shape) != (1, self.out_size)):
            raise ValueError(f"w_q {tuple(self.w_q.shape)} / w_s "
                             f"{tuple(self.w_s.shape)} do not fit w "
                             f"{tuple(self.w.shape)}")

    def quantize_head_params(self):
        """Per-output-column int8 weights from ``w`` as it stands, kept
        beside it. Nothing to do when already quantised."""
        if self.w_q is None:
            self.set_quantized_head(*int8.quantize_cols(
                self.w.detach().float().cpu().numpy()))

    def project(self, x, perm=None, out_dtype=None):
        """The head matmul (+ bias) over x [N, T, H], with the weight
        columns taken in the order ``perm`` when given. ``x`` may be a
        chained int8 h (steps of 1/127) or float. A float input through
        float weights keeps its dtype; an int8 input or int8 weights give
        ``out_dtype`` (default: bf16 for an int8 input, else the input's).

        Quantised, it is an int8 product with int32 accumulation, rescaled
        in f32. At hac widths the int32 result of a whole batch would be
        2.6 GB and its f32 rescale as much again, so the product runs over
        slabs of SLAB_ROWS rows and writes each into the result."""
        if out_dtype is None:
            out_dtype = torch.bfloat16 if x.dtype == torch.int8 else x.dtype
        cols = slice(None) if perm is None else perm
        b = None if self.b is None else self.b[cols]
        if self.w_q is None:
            if x.dtype == torch.int8:
                x = int8.dequantize_h(x, out_dtype)
            scores = torch.matmul(x, self.w[:, cols].to(x.dtype))
            if b is not None:
                scores = scores + b.to(x.dtype)
            return scores
        N, T, H = x.shape
        x_q = (x if x.dtype == torch.int8 else int8.quantize_h(x)).reshape(
            N * T, H)
        w_q = self.w_q[:, cols].contiguous()
        rescale = self.w_s.reshape(-1)[cols] / 127.0
        scores = torch.empty(N * T, w_q.shape[1], dtype=out_dtype,
                             device=x.device)
        for r in range(0, N * T, self.SLAB_ROWS):
            # int32 * f32 promotes to f32 in one pass
            part = int8.int_matmul(x_q[r:r + self.SLAB_ROWS], w_q) * rescale
            if b is not None:
                part.add_(b.float())
            scores[r:r + self.SLAB_ROWS] = part
        return scores.reshape(N, T, -1)

    def head(self, x, perm=None, out_dtype=None):
        """The projection with the activation and scale (no blanks)."""
        scores = self.project(x, perm, out_dtype)
        if self.activation is not None:
            scores = self.activation(scores)
        if self.scale is not None:
            scores = scores * self.scale
        return scores

    def forward(self, x):
        scores = self.head(x)
        if self.blank_score is not None:
            N, T, C = scores.shape
            scores = scores.reshape(N, T, C // self.n_base, self.n_base)
            blanks = torch.full((N, T, C // self.n_base, 1),
                                float(self.blank_score),
                                dtype=scores.dtype, device=scores.device)
            scores = torch.cat([blanks, scores], dim=-1).reshape(N, T, -1)
        return scores

    def to_dict(self):
        res = {"insize": self.insize, "n_base": self.n_base,
               "state_len": self.state_len, "bias": self.bias,
               "scale": self.scale, "blank_score": self.blank_score,
               "expand_blanks": self.expand_blanks}
        if self.activation is not None:
            res["activation"] = self.activation.name
        if self.permute is not None:
            res["permute"] = self.permute
        return res

    def init_(self, rng):
        _fill(self.w, rng.normal(size=self.w.shape) / math.sqrt(self.insize))


@register
class LinearUpsample(Layer):
    """Linear projection that lengthens the sequence by ``scale_factor``:
    [N, T, d_model] -> [N, T * scale_factor, d_model], frame t giving
    output frames t * scale_factor .. with ``w`` [d_model, scale_factor *
    d_model] and ``b`` as in bonito_tpu. In front of a CRF head it folds
    into the head's weights (``SeqdistModel.forward_tcn_head``)."""

    def __init__(self, d_model, scale_factor, batch_first=True):
        super().__init__()
        self.d_model = d_model
        self.scale_factor = scale_factor
        self.batch_first = batch_first
        self.w = torch.nn.Parameter(
            torch.zeros(d_model, scale_factor * d_model))
        self.b = torch.nn.Parameter(torch.zeros(scale_factor * d_model))

    def forward(self, x):
        N, T, C = x.shape
        h = torch.matmul(x, self.w.to(x.dtype)) + self.b.to(x.dtype)
        return h.reshape(N, T * self.scale_factor, C)

    def to_dict(self):
        return {"d_model": self.d_model, "scale_factor": self.scale_factor,
                "batch_first": self.batch_first}

    def output_stride(self, stride):
        return stride // self.scale_factor

    def init_(self, rng):
        _fill(self.w, rng.normal(size=self.w.shape) / math.sqrt(self.d_model))


# ---------------------------------------------------------------------------
# batchnorm folding (inference)
# ---------------------------------------------------------------------------

def fuse_bn(layer):
    """Fold every Convolution's BatchNorm into its weights, in f64 before
    any cast, and drop the norm from the tree."""
    for sub in list(layer.modules()):
        if (isinstance(sub, Convolution) and isinstance(sub.norm, BatchNorm)
                and sub.norm.track_running_stats):  # else nothing to fold
            bn = sub.norm
            inv = 1.0 / np.sqrt(bn.var.detach().cpu().double().numpy() + bn.eps)
            gamma = (bn.scale.detach().cpu().numpy() if bn.affine
                     else np.ones_like(inv))
            beta = (bn.bias.detach().cpu().numpy() if bn.affine
                    else np.zeros_like(inv))
            scale = (gamma * inv).astype(np.float32)
            w = sub.w.detach().cpu().numpy() * scale[:, None, None]
            b = (sub.b.detach().cpu().numpy() if sub.b is not None
                 else np.zeros(sub.size, np.float32))
            b = (b - bn.mean.detach().cpu().numpy()) * scale + beta
            device = sub.w.device
            sub.w = torch.nn.Parameter(torch.from_numpy(w).to(device))
            sub.b = torch.nn.Parameter(
                torch.from_numpy(b.astype(np.float32)).to(device))
            sub.norm = None
    return layer
