"""
CRF model families: an encoder (conv downsample, then an LSTM stack or,
for the transformer family, a stack of attention layers and an upsample,
then a CRF head, built from the config's layer tree) paired with a CTC_CRF
state space. ``forward`` gives full scores [N, T, n_score] (what
``decode_batch`` decodes and ``loss`` scores); ``forward_tcn`` the decode
layout the TCN kernels read (and ``loss_tcn``, the default training loss,
scores); ``forward_tcn_head`` the encoder output and the head's weights for
the decode kernels that hold the head.
"""

from collections import namedtuple

import numpy as np
import torch

from bonito_tpu_torch import nn
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops import int8
from bonito_tpu_torch.ops.decode import tcn_permutation, viterbi_decode
from bonito_tpu_torch.ops.lstm import INT8_ROUTES


# forward_tcn_head's return: the encoder output and the CRF head as the
# operands of the fused-head decode (ops.decode.viterbi_decode_head)
HeadSplit = namedtuple(
    "HeadSplit",
    ["h", "wT", "bias", "act_tanh", "scale", "cmin", "cmax", "blank"])


def rnn_encoder(n_base, state_len, insize=1, first_conv_size=4, stride=5,
                winlen=19, activation="swish", rnn_type="lstm", features=768,
                scale=5.0, blank_score=None, expand_blanks=True, num_layers=5,
                norm=None):
    """The encoder of an old-style parametric ``[encoder]`` config
    (bonito_tpu's ``rnn_encoder``): three convolutions, ``num_layers``
    recurrent layers of alternating direction (the last one forward) and
    a tanh CRF head scaled by ``scale``."""
    rnn = nn.layers[rnn_type]

    def conv(c_in, c_out, ks, stride=1):
        return nn.Convolution(c_in, c_out, ks, stride=stride, padding=ks // 2,
                              bias=True, activation=activation, norm=norm)

    return nn.Serial([
        conv(insize, first_conv_size, ks=5),
        conv(first_conv_size, 16, ks=5),
        conv(16, features, ks=winlen, stride=stride),
        nn.Permute([2, 0, 1]),
        *(rnn(features, features, reverse=(num_layers - i) % 2)
          for i in range(num_layers)),
        nn.LinearCRFEncoder(
            features, n_base, state_len, activation="tanh", scale=scale,
            blank_score=blank_score, expand_blanks=expand_blanks),
    ])


@nn.register
class SeqdistModel(torch.nn.Module):
    """Encoder + CTC_CRF seqdist. Registered as ``seqdistmodel`` so that a
    config which serialises the whole model (the transformer family's)
    builds through ``nn.from_dict``."""

    def __init__(self, encoder, seqdist, n_pre_post_context_bases=None,
                 target_projection=None):
        super().__init__()
        self.seqdist = seqdist
        self.encoder = encoder
        self.stride = nn.get_stride(encoder)
        self.alphabet = seqdist.alphabet
        self.compute_dtype = torch.float32
        self._perm = {}
        self.training = False  # inference until .train(), as its layers
        if n_pre_post_context_bases is None:
            n_pre_post_context_bases = (seqdist.state_len - 1, 1)
        self.n_pre_context_bases, self.n_post_context_bases = (
            n_pre_post_context_bases)
        self.target_projection = (
            None if target_projection is None
            else np.array([0] + list(target_projection)))

    @classmethod
    def from_dict(cls, model_dict, layer_types=None):
        kwargs = dict(model_dict)
        kwargs["encoder"] = nn.from_dict(kwargs["encoder"], layer_types)
        kwargs["seqdist"] = CTC_CRF(**kwargs.pop("seqdist"))
        return cls(**kwargs)

    def to_dict(self):
        res = {
            "encoder": nn.to_dict(self.encoder),
            "seqdist": {"state_len": self.seqdist.state_len,
                        "alphabet": self.seqdist.alphabet},
            "n_pre_post_context_bases": (self.n_pre_context_bases,
                                         self.n_post_context_bases),
        }
        if self.target_projection is not None:
            res["target_projection"] = self.target_projection.tolist()[1:]
        return res

    @property
    def device(self):
        return next(self.parameters()).device

    def init(self, seed=0):
        """Random weights from ``seed`` (numpy draws: the same model on
        every machine and torch version)."""
        self.encoder.init_(np.random.default_rng(seed))
        return self

    def to_bf16(self):
        """Cast the parameters to bf16 (BatchNorm statistics stay f32)."""
        for p in self.parameters():
            p.data = p.data.to(torch.bfloat16)
        self.compute_dtype = torch.bfloat16
        return self

    def quantize(self, route=None):
        """int8-quantise every layer that has ``quantize_params`` (the
        LSTM cells) from the weights as they stand, then mark the chains:
        a quantised LSTM that feeds another emits its hidden state as
        int8 ``round(h * 127)`` — what its own recurrence and the
        consumer's projection both quantise to — and one that feeds the
        CRF head does too, with the head's weights going int8 as well
        (the static 1/127 step is exact only for a bounded LSTM h, which
        is why the head is quantised here, by structure, and not by the
        walk). Layout glue (Permute) between producer and consumer does
        not break a chain. ``route`` names the int8 LSTM route of every
        layer (``ops.lstm.INT8_ROUTES``; None: each layer's shape gate).

        bonito_tpu's ``quantize`` also quantises the transformer family's
        attention and MLP projections, with calibrated activation scales
        (``amax``). That is a slice of its own: a model with such
        projections raises here, it never runs in bf16 under the name of
        a quantised model."""
        if route is not None and route not in INT8_ROUTES:
            raise ValueError(f"route {route!r}: expected None or one of "
                             f"{INT8_ROUTES}")
        waits = sorted({type(m).__name__ for m in self.encoder.modules()
                        if hasattr(m, "wqkv") or hasattr(m, "fc1")})
        if waits:
            raise NotImplementedError(
                f"quantize: the int8 projections of {waits} with calibrated "
                f"amax activation scales (bonito_tpu's --quantize for the "
                f"transformer family) are a later slice of the port; load "
                f"this model with quantize=False")
        for layer in self.encoder.modules():
            if hasattr(layer, "quantize_params"):
                layer.quantize_params()
                layer.int8_route = route
        _mark_chains(self.encoder)
        return self

    def forward(self, x):
        """x [N, T, 1] signal chunks -> scores [N, T/stride, n_score]."""
        return self.encoder(x)

    def decode_batch(self, scores):
        """Viterbi strings from full scores [N, T, n_score] (a tensor or an
        array, decoded on the model's device): ``viterbi_decode``, the exact
        MAP path, as bonito_tpu's ``decode_batch``."""
        scores = torch.as_tensor(scores, device=self.device)
        out = viterbi_decode(self.seqdist, scores)
        return [self.seqdist.path_to_str(p)
                for p in out["sequence"].cpu().numpy()]

    def decode_batch_posteriors(self, scores):
        """Viterbi strings over the smoothed posteriors (bonito_tpu's
        validation decoder, reference semantics): plain torch."""
        scores = torch.as_tensor(scores, device=self.device).float()
        post = self.seqdist.posteriors(scores) + 1e-8
        paths = self.seqdist.viterbi(torch.log(post)).cpu().numpy()
        return [self.seqdist.path_to_str(p) for p in paths]

    def decode(self, x):
        """The Viterbi string of one read's full scores [T, n_score]."""
        return self.decode_batch(x[None])[0]

    def _project_targets(self, targets):
        targets = torch.as_tensor(targets)
        if self.target_projection is None:
            return targets
        return torch.as_tensor(self.target_projection,
                               device=targets.device)[targets.long()]

    def loss(self, scores, targets, target_lengths, **kwargs):
        """``ctc_loss`` of full scores [N, T, n_score] (in f32): logZ
        through kernels W and X on the card, the lattice a plain loop."""
        return self.seqdist.ctc_loss(scores.float(),
                                     self._project_targets(targets),
                                     target_lengths, **kwargs)

    def loss_tcn(self, moves_tcn, blank_score, targets, target_lengths,
                 **kwargs):
        """``ctc_loss_tcn`` from ``forward_tcn``'s output, the default
        training loss: kernels Y and Z (the lattice) and U and V (logZ)
        on the card."""
        return self.seqdist.ctc_loss_tcn(moves_tcn, blank_score,
                                         self._project_targets(targets),
                                         target_lengths, **kwargs)

    def decode_head(self):
        """(items_before_head, (name, crf), (name, clamp) or None), or None
        when the encoder does not end in a LinearCRFEncoder with a fixed
        blank score."""
        items = list(self.encoder.named_children())
        clamp = None
        if items and isinstance(items[-1][1], nn.Clamp):
            clamp = items.pop()
        if not items or not isinstance(items[-1][1], nn.LinearCRFEncoder):
            return None
        crf = items.pop()
        if crf[1].blank_score is None:
            return None
        return items, crf, clamp

    def _tcn_perm(self, device):
        if device not in self._perm:
            self._perm[device] = torch.as_tensor(
                tcn_permutation(self.seqdist), device=device)
        return self._perm[device]

    def forward_tcn(self, x):
        """Decode-layout forward: only the learned move scores, with the
        head's weight columns permuted to (b, j, r) order, and the stay
        score a constant blank (clamped like the move scores). Returns
        (moves_tcn [T, S*nb, N], blank) — bonito_tpu's contract — where
        moves_tcn is a permuted view of the [N, T, S*nb] head output, the
        memory the decode kernels read. None without a fixed-blank head."""
        split = self.decode_head()
        if split is None:
            return None
        items, (_, crf), clamp = split
        h = x
        for _, layer in items:
            h = layer(h)
        # a float h keeps its dtype through the head (the bf16 input of an
        # amp train step gives bf16 moves, as bonito_tpu's cast tree does);
        # an int8 h from a quantised chain gives the compute dtype
        moves = crf.head(h, self._tcn_perm(h.device),
                         self.compute_dtype if h.dtype == torch.int8
                         else h.dtype)
        blank = float(crf.blank_score)
        if clamp is not None:
            moves = clamp[1](moves)
            blank = float(np.clip(blank, clamp[1].min, clamp[1].max))
        return moves.permute(1, 2, 0), blank

    def forward_tcn_head(self, x):
        """Fused-head forward split: the encoder up to, and without, the
        last LinearUpsample (if any) and the CRF head, and the head folded
        into one weight per upsample phase:

            HeadSplit(h [T/U, N, H], wT [U, S*nb, H], bias [U, S*nb] f32 or
                      None, act_tanh, scale, cmin, cmax, blank)

        with ``wT``'s rows in the TCN (b, j, r) order and the upsample
        folded exactly into the projection: wT[p] = (W_up[:, p] @ w)^T,
        bias = b_up @ w (+ b). ``h`` and ``wT`` are in the compute dtype;
        an int8 h from a quantised chain is dequantised, and the float
        ``w`` is used even where the head also holds int8 weights. None
        where bonito_tpu's returns None: no fixed blank, an activation
        other than tanh, or a head that neither tanh nor a Clamp bounds
        (the decode's exp() relies on bounded scores).

        bonito_tpu returns h as [T/U, H, N], batch on the TPU's lanes; here
        it is [T/U, N, H], the LSTM's own output memory, rows contiguous
        in H as a CUDA block reads them."""
        split = self.decode_head()
        if split is None:
            return None
        items, (_, crf), clamp = split
        act_tanh = isinstance(crf.activation, nn.Tanh)
        if crf.activation is not None and not act_tanh:
            return None
        if not act_tanh and clamp is None:
            return None
        cmin = cmax = None
        if clamp is not None:
            cmin, cmax = float(clamp[1].min), float(clamp[1].max)
        upsample = None
        if items and isinstance(items[-1][1], nn.LinearUpsample):
            upsample = items.pop()[1]
        h = x
        for _, layer in items:
            h = layer(h)
        if h.dtype == torch.int8:
            h = int8.dequantize_h(h, self.compute_dtype)

        perm = self._tcn_perm(h.device)
        w = crf.w.float()[:, perm]                               # [H, Cm]
        b = crf.b.float()[perm] if crf.b is not None else None
        if upsample is None:
            wT = w.t()[None]
            bias = None if b is None else b[None]
        else:
            U, H = upsample.scale_factor, upsample.d_model
            w_up = upsample.w.float().reshape(H, U, H)
            wT = torch.einsum("hpg,gc->pch", w_up, w)
            bias = torch.matmul(upsample.b.float().reshape(U, H), w)
            if b is not None:
                bias = bias + b[None]
        scale = float(crf.scale) if crf.scale is not None else 1.0
        blank = float(crf.blank_score)
        if clamp is not None:
            blank = float(np.clip(blank, cmin, cmax))
        return HeadSplit(h.to(self.compute_dtype).transpose(0, 1),
                         wT.to(self.compute_dtype).contiguous(), bias,
                         act_tanh, scale, cmin, cmax, blank)


# value-preserving layers an int8 h passes through (bonito_tpu's glue also
# names Dropout, a layer it does not have)
GLUE = (nn.Permute, nn.MakeContiguous)


def _mark_chains(layer):
    items = list(layer.children())
    for i, a in enumerate(items):
        if not (isinstance(a, nn.LSTM) and a.quantized):
            continue
        consumer = next((s for s in items[i + 1:] if not isinstance(s, GLUE)),
                        None)
        if isinstance(consumer, nn.LSTM) and consumer.quantized:
            a.int8_out = True
        elif isinstance(consumer, nn.LinearCRFEncoder):
            consumer.quantize_head_params()
            a.int8_out = True
    for sub in items:
        _mark_chains(sub)


class Model(SeqdistModel):
    """CRF model built from a bonito-style config dict."""

    def __init__(self, config):
        seqdist = CTC_CRF(
            state_len=config["global_norm"]["state_len"],
            alphabet=config["labels"]["labels"],
        )
        if "type" in config["encoder"]:
            encoder = nn.from_dict(config["encoder"])
        else:
            encoder = rnn_encoder(seqdist.n_base, seqdist.state_len,
                                  insize=config["input"]["features"],
                                  **config["encoder"])
        super().__init__(
            encoder, seqdist,
            n_pre_post_context_bases=config["input"].get(
                "n_pre_post_context_bases"))
        self.config = config
