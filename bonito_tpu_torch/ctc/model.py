"""
The conv-CTC family (the QuartzNet-style r9.4.1 "fast" models), bonito_tpu's
``ctc/model.py`` as torch modules: time-channel-separable conv blocks with
BatchNorm, swish and residuals, a 1x1 conv decoder and log-softmax CTC
posteriors [N, T, C]; the host decoders (greedy with qualities, the native
prefix beam) and the CTC loss with label smoothing.

- The convolutions and passes are plain torch (cuDNN): bonito_tpu runs
  them as plain XLA, no Pallas kernel, so the family has no hand kernel.
- Activations are [N, T, C] at each block's boundary, as in bonito_tpu;
  inside, a block keeps torch's [N, C, T] memory, so the [N, T, C] tensor
  between blocks is a transposed view and no copy is made there.
- Parameter names are bonito_tpu's (``encoder.1.conv0.w_depth``,
  ``encoder.1.bn0.mean``, ``encoder.1.res_conv.w``, ``decoder.0.w``); the
  conv weights are in torch's layout, ``checkpoint`` transposes them.
- Dropout runs in train mode only, and only with a generator set
  (``Model.set_dropout_generator``): bonito_tpu's blocks drop only when a
  dropout key is in their context, which its trainer never passes.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from bonito_tpu_torch import nn
from bonito_tpu_torch.checkpoint import same
from bonito_tpu_torch.ops.ctc_decode import beam_search_ctc, greedy_ctc

LOG_EPSILON = -1e5  # optax.ctc_loss's stand-in for log(0)


class TCSConv(nn.Layer):
    """(Optionally separable) 1-D convolution over [N, T, C], no bias:
    ``w`` [O, I, W], or a depthwise ``w_depth`` [I, 1, W] (``groups=I``,
    the stride, padding and dilation) then a pointwise ``w_point`` [O, I,
    1]."""

    name = "tcsconv"  # built from the [[block]] list, not the registry

    def __init__(self, insize, size, winlen, stride=1, padding=0, dilation=1,
                 separable=False):
        super().__init__()
        self.insize, self.size, self.winlen = insize, size, winlen
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.separable = separable
        if separable:
            self.w_depth = torch.nn.Parameter(torch.zeros(insize, 1, winlen))
            self.w_point = torch.nn.Parameter(torch.zeros(size, insize, 1))
        else:
            self.w = torch.nn.Parameter(torch.zeros(size, insize, winlen))

    @property
    def conv_weight_names(self):
        return ("w_depth", "w_point") if self.separable else ("w",)

    def forward(self, x):
        y = x.transpose(1, 2)
        if self.separable:
            y = F.conv1d(y, self.w_depth.to(y.dtype), None, self.stride,
                         self.padding, self.dilation, groups=self.insize)
            y = F.conv1d(y, self.w_point.to(y.dtype))
        else:
            y = F.conv1d(y, self.w.to(y.dtype), None, self.stride,
                         self.padding, self.dilation)
        return y.transpose(1, 2)

    def output_stride(self, stride):
        return stride * self.stride

    def to_dict(self):
        return {"insize": self.insize, "size": self.size,
                "winlen": self.winlen, "stride": self.stride,
                "padding": self.padding, "dilation": self.dilation,
                "separable": self.separable}

    def init_(self, rng):
        """LeCun normal, bonito_tpu's: fan-in I x W (W for the depthwise)."""
        for name in self.conv_weight_names:
            w = getattr(self, name)
            nn._fill(w, rng.normal(size=w.shape)
                     / math.sqrt(w.shape[1] * w.shape[2]))


class Block(nn.Layer):
    """``repeat`` x (TCSConv, BatchNorm, swish, dropout), the last without
    its swish and dropout; with ``residual`` a kernel-1 conv and BatchNorm
    of the block's input added before the block's last swish and dropout.
    The stride applies to every conv of the repeat, the padding is
    (kernel // 2) x dilation, BatchNorm's eps 1e-3."""

    name = "block"

    def __init__(self, insize, size, activation, repeat=5, kernel=1, stride=1,
                 dilation=1, dropout=0.0, residual=False, separable=False):
        super().__init__()
        if stride > 1 and dilation > 1:
            raise ValueError("stride and dilation cannot both exceed 1")
        padding = (kernel // 2) * dilation
        self.activation = nn.make_activation(activation)
        self.dropout = dropout
        self.residual = residual
        self.repeat = repeat
        self.generator = None
        c_in = insize
        for i in range(repeat):
            self.add_module(f"conv{i}", TCSConv(
                c_in, size, kernel, stride=stride, padding=padding,
                dilation=dilation, separable=separable))
            self.add_module(f"bn{i}", nn.BatchNorm(size, eps=1e-3))
            c_in = size
        if residual:
            self.res_conv = TCSConv(insize, size, 1)
            self.res_bn = nn.BatchNorm(size, eps=1e-3)

    def _drop(self, x):
        if self.dropout > 0 and self.training and self.generator is not None:
            keep = torch.rand(x.shape, generator=self.generator,
                              device=x.device) >= self.dropout
            return torch.where(keep, x / (1 - self.dropout), 0)
        return x

    def forward(self, x):
        h = x
        for i in range(self.repeat):
            h = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(h))
            if i != self.repeat - 1:
                h = self._drop(self.activation(h))
        if self.residual:
            h = h + self.res_bn(self.res_conv(x))
        return self._drop(self.activation(h))

    def output_stride(self, stride):
        for i in range(self.repeat):
            stride = getattr(self, f"conv{i}").output_stride(stride)
        return stride

    def to_dict(self):
        conv = self.conv0
        return {"insize": conv.insize, "size": conv.size,
                "repeat": self.repeat, "kernel": conv.winlen,
                "stride": conv.stride, "dilation": conv.dilation,
                "dropout": self.dropout, "residual": self.residual,
                "separable": conv.separable}

    def init_(self, rng):
        for i in range(self.repeat):
            getattr(self, f"conv{i}").init_(rng)
        if self.residual:
            self.res_conv.init_(rng)

    def torch_param_map(self, path):
        """Upstream's keys of this block -> the port's: upstream's
        ``Block.conv`` interleaves TCSConv, BatchNorm, activation and
        dropout, so the k-th conv sits at index 4k and its BatchNorm at
        4k + 1, the residual at ``residual.0`` / ``.1``, all under one
        more ``.encoder``. Upstream's conv weights are the port's layout."""
        root, idx = path.split(".", 1)
        tp = f"{root}.encoder.{idx}"
        out = []

        def conv_entries(tprefix, oprefix, conv):
            if conv.separable:
                out.append((f"{tprefix}.depthwise.weight",
                            f"{oprefix}.w_depth", same))
                out.append((f"{tprefix}.pointwise.weight",
                            f"{oprefix}.w_point", same))
            else:
                out.append((f"{tprefix}.conv.weight", f"{oprefix}.w", same))

        def bn_entries(tprefix, oprefix):
            for t, o in (("weight", "scale"), ("bias", "bias"),
                         ("running_mean", "mean"), ("running_var", "var")):
                out.append((f"{tprefix}.{t}", f"{oprefix}.{o}", same))

        for k in range(self.repeat):
            conv_entries(f"{tp}.conv.{4 * k}", f"{path}.conv{k}",
                         getattr(self, f"conv{k}"))
            bn_entries(f"{tp}.conv.{4 * k + 1}", f"{path}.bn{k}")
        if self.residual:
            conv_entries(f"{tp}.residual.0", f"{path}.res_conv",
                         self.res_conv)
            bn_entries(f"{tp}.residual.1", f"{path}.res_bn")
        return out


def decode_scores(x, alphabet, qscale=1.0, qbias=0.0, beamsize=5,
                  threshold=1e-3, qscores=False, return_path=False):
    """Decode one read's log-probs [T, C] on the host: the greedy path
    (with its qstring appended under ``qscores``) for ``beamsize`` 1 or
    ``qscores``, else the native beam. A module-level function, so a
    decoder made from it pickles into spawned workers."""
    if isinstance(x, torch.Tensor):
        x = x.detach().float().cpu().numpy()
    probs = np.exp(np.asarray(x, dtype=np.float32))
    if beamsize == 1 or qscores:
        seq, path = greedy_ctc(probs, alphabet, qscores=qscores,
                               qscale=qscale, qbias=qbias)
    else:
        seq, path = beam_search_ctc(probs, alphabet, beamsize, threshold)
    if return_path:
        return seq, path
    return seq


def alignable(targets, lengths, T):
    """Per row: whether a CTC path of T frames can emit the target, that is
    whether its length plus its adjacent repeats (each needs a blank
    between) is at most T."""
    L = targets.shape[1]
    pos = torch.arange(1, L, device=targets.device)
    repeats = ((targets[:, 1:] == targets[:, :-1])
               & (pos[None] < lengths[:, None])).sum(1)
    return lengths + repeats <= T


def ctc_nll_plain(log_probs, targets, lengths, log_epsilon=LOG_EPSILON):
    """Per-row CTC negative log-likelihood of log-probs [N, T, C] (blank
    0) for right-padded targets [N, L] of ``lengths``: a torch copy of
    ``optax.ctc_loss``'s recursion (bonito_tpu's loss), every input frame
    real. optax normalises its input with a log-softmax and stands
    ``log_epsilon`` in for log(0), so a row that cannot align gets a
    finite loss near -log_epsilon, where the exact loss is infinite. It
    runs in f32, or in f64 for f64 log-probs (an oracle's precision)."""
    logprobs = F.log_softmax(log_probs.double() if log_probs.dtype
                             == torch.float64 else log_probs.float(), dim=-1)
    N, T, _ = logprobs.shape
    L = targets.shape[1]
    targets = targets.long()
    lengths = lengths.long()
    labellens = L - (torch.arange(L, device=targets.device)[None]
                     >= lengths[:, None]).sum(1)
    repeat = F.pad((targets[:, :-1] == targets[:, 1:]).float(), (0, 1))
    phi = logprobs[:, :, 0]                                   # [N, T]
    emit = torch.gather(logprobs, 2, targets[:, None, :].expand(N, T, L))
    like = dict(dtype=logprobs.dtype, device=logprobs.device)
    alpha_phi = torch.full((N, L + 1), log_epsilon, **like)
    alpha_phi[:, 0] = 0.0
    alpha_emit = torch.full((N, L), log_epsilon, **like)
    eps_repeat = (log_epsilon * repeat).to(logprobs.dtype)
    eps_new = (log_epsilon * (1.0 - repeat)).to(logprobs.dtype)

    def add_phi(a, added):
        return torch.cat([a[:, :1], torch.logaddexp(a[:, 1:], added)], 1)

    for t in range(T):
        # emit -> phi, except where the next label repeats
        prev_phi = add_phi(alpha_phi, alpha_emit + eps_repeat)
        e, p = emit[:, t], phi[:, t, None]
        next_emit = torch.logaddexp(prev_phi[:, :-1] + e, alpha_emit + e)
        # the self loop, and emit -> phi only where the next label repeats
        alpha_phi = add_phi(prev_phi + p, alpha_emit + p + eps_new)
        alpha_emit = next_emit
    last = add_phi(alpha_phi, alpha_emit)
    return -last.gather(1, labellens[:, None])[:, 0]


def ctc_nll_library(log_probs, targets, lengths):
    """``ctc_nll_plain``'s function for a batch whose every row can align:
    ``torch.nn.functional.ctc_loss`` ([T, N, C], blank 0, every input
    length T, no reduction) of the log-softmax of the input, as optax
    normalises it, whose value there is optax's. It runs in f64:
    in f32 its gradient to the log-probs drifts from the exact one over
    long chunks (7e-4 relative L2 at 1333 frames on the CPU, 1.4e-3 on
    the card), where the plain recursion's f32 gradient stays within
    5e-5. The result has the plain version's dtype."""
    N, T, _ = log_probs.shape
    out = F.ctc_loss(
        F.log_softmax(log_probs.double(), dim=-1).transpose(0, 1),
        targets.long(),
        torch.full((N,), T, dtype=torch.long, device=log_probs.device),
        lengths.long(), blank=0, reduction="none")
    return out.to(torch.float64 if log_probs.dtype == torch.float64
                  else torch.float32)


def ctc_nll(log_probs, targets, lengths):
    """``ctc_nll_plain``'s function. On the card, where every row of the
    batch can align (``alignable``; the host waits for the check once a
    call), it is ``ctc_nll_library``; a batch with a row that cannot align
    takes the plain recursion, which gives optax's finite value where
    ``ctc_loss`` gives inf. A route by input, not a fallback. The CPU runs
    the plain recursion."""
    if log_probs.device.type == "cuda" and bool(
            alignable(targets, lengths, log_probs.shape[1]).all()):
        return ctc_nll_library(log_probs, targets, lengths)
    return ctc_nll_plain(log_probs, targets, lengths)


class Model(torch.nn.Module):
    """Conv-CTC model: signal [N, T, 1] -> log posteriors [N, T / stride,
    n_labels] in f32 (the log-softmax after the cast, as bonito_tpu's)."""

    def __init__(self, config):
        super().__init__()
        qcfg = config.get("qscore", {})
        self.qbias = qcfg.get("bias", 0.0)
        self.qscale = qcfg.get("scale", 1.0)
        self.config = config
        self.alphabet = config["labels"]["labels"]
        self.features = config["block"][-1]["filters"]
        self.compute_dtype = torch.float32

        activation = config["encoder"]["activation"]
        blocks = []
        c_in = config["input"]["features"]
        for layer in config["block"]:
            blocks.append(Block(
                c_in, layer["filters"], activation,
                repeat=layer["repeat"], kernel=layer["kernel"][0],
                stride=layer["stride"][0], dilation=layer["dilation"][0],
                dropout=layer["dropout"], residual=layer["residual"],
                separable=layer["separable"]))
            c_in = layer["filters"]
        self.encoder = nn.Serial(blocks)
        self.decoder = nn.Serial([
            nn.Convolution(self.features, len(self.alphabet), 1, bias=True)])
        self.stride = nn.get_stride(self.encoder)
        self.training = False  # inference until .train(), as its layers

    @property
    def device(self):
        return next(self.parameters()).device

    @staticmethod
    def rewrite_torch_keys(key):
        """Upstream's decoder is ``Decoder.layers`` (a Sequential), not a
        bare Convolution."""
        if key.startswith("decoder.0.conv."):
            return key.replace("decoder.0.conv.", "decoder.layers.0.")
        return key

    def init(self, seed=0):
        """Random weights from ``seed`` (numpy draws: the same model on
        every machine and torch version)."""
        rng = np.random.default_rng(seed)
        self.encoder.init_(rng)
        self.decoder.init_(rng)
        return self

    def to_bf16(self):
        """Cast the parameters to bf16 (BatchNorm statistics stay f32)."""
        for p in self.parameters():
            p.data = p.data.to(torch.bfloat16)
        self.compute_dtype = torch.bfloat16
        return self

    def set_dropout_generator(self, generator):
        """Blocks drop activations in train mode from ``generator`` (None:
        no dropout, as bonito_tpu's trainer runs)."""
        for block in self.encoder.children():
            block.generator = generator
        return self

    def forward(self, x):
        h = self.encoder(x)
        logits = self.decoder(h)
        return F.log_softmax(logits.float(), dim=-1)

    # -- decoding (host) ---------------------------------------------------

    def decode(self, x, beamsize=5, threshold=1e-3, qscores=False,
               return_path=False):
        """Decode one read's log-probs [T, C] on the host."""
        return decode_scores(x, self.alphabet, self.qscale, self.qbias,
                             beamsize=beamsize, threshold=threshold,
                             qscores=qscores, return_path=return_path)

    def decode_batch(self, x, beamsize=5):
        """The beam (width 5 by default, as bonito_tpu's) of each row of
        [N, T, C] log-probs, fetched to the host once."""
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        xs = np.asarray(x)
        return [self.decode(xs[i], beamsize=beamsize) for i in range(len(xs))]

    # -- loss --------------------------------------------------------------

    def ctc_label_smoothing_loss(self, log_probs, targets, lengths,
                                 weights=None):
        """The per-row CTC NLL (``ctc_nll``) divided by the target length,
        averaged, plus ``-mean(log_probs * w)``: w 0.4 for the blank and
        0.1 / (C - 1) for each other label."""
        N, T, C = log_probs.shape
        if weights is None:
            weights = torch.cat([torch.tensor([0.4]),
                                 (0.1 / (C - 1)) * torch.ones(C - 1)])
        weights = weights.to(device=log_probs.device, dtype=log_probs.dtype)
        per_row = ctc_nll(log_probs, targets, lengths)
        loss = (per_row / lengths.to(per_row.dtype)).mean()
        smooth = -(log_probs * weights).mean()
        return {"total_loss": loss + smooth, "loss": loss,
                "label_smooth_loss": smooth}

    def loss(self, log_probs, targets, lengths):
        return self.ctc_label_smoothing_loss(log_probs, targets, lengths)
