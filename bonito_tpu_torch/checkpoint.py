"""
Checkpoints: bonito_tpu's flat, dot-keyed ``weights_{N}.npz`` (numpy
alone reads it) and the converter from bonito_tpu's parameter tree.

bonito_tpu keys are the port's ``state_dict`` keys (``encoder.4.w_hh``,
``encoder.0.norm.mean``, ...; for the transformer family
``encoder.conv.0.w``, ``encoder.transformer_encoder.3.self_attn.wqkv``,
``encoder.upsample.w``, ``encoder.crf.w``; for the conv-CTC family
``encoder.1.conv0.w_depth``, ``encoder.1.bn0.mean``,
``encoder.1.res_conv.w``, ``decoder.0.w``). One layout differs: a conv
weight is [W, I, O] in bonito_tpu and [O, I, W] here (a depthwise
``w_depth`` [W, 1, I] is [I, 1, W], a pointwise ``w_point`` [1, I, O] is
[O, I, 1]: each the same transpose); linear weights are [in, out] in
both. A module names its conv weights in ``conv_weight_names``.
Param-less layers (Permute, Clamp) have no entry.
Importing upstream ``weights_N.tar`` waits. A training run also writes
the optimiser's state, in the port's own ``optim_N.pt``.

Checkpoints on disk hold the float tree only: quantisation happens at
load (``util.load_model``), as in bonito_tpu. ``params_from_jax`` also
takes an already-quantised bonito_tpu tree (``w_hh_q``/``scales``/
``w_ih_q``/``ih_scales`` in place of an LSTM's ``w_hh``/``w_ih``, and
``w_q``/``w_s`` beside a CRF head's ``w``) and puts the model's layers
into that form.
"""

from pathlib import Path

import numpy as np
import torch

from bonito_tpu_torch import nn


def _flatten(tree, prefix=""):
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = np.asarray(v)
    return flat


def load_params(path):
    """Flat {dot key: numpy array} from a bonito_tpu ``.npz``."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _conv_weight_keys(model):
    return {f"{name}.{w}" if name else w for name, m in model.named_modules()
            for w in getattr(m, "conv_weight_names", ())}


def params_from_jax(model, tree):
    """Fill ``model`` from a bonito_tpu parameter tree (nested dicts or
    flat dot keys, numpy arrays). Every tensor the model holds must be
    present with the matching shape, and nothing else may be."""
    flat = _flatten(tree) if any(isinstance(v, dict) for v in tree.values()) \
        else {k: np.asarray(v) for k, v in tree.items()}
    conv_w = _conv_weight_keys(model)
    _adopt_quantized_form(model, flat)
    state = model.state_dict()
    missing = sorted(set(state) - set(flat))
    unexpected = sorted(set(flat) - set(state))
    if missing or unexpected:
        raise KeyError(f"checkpoint does not match the model: missing "
                       f"{missing}, unexpected {unexpected}")
    with torch.no_grad():
        for key, target in state.items():
            value = flat[key]
            if key in conv_w:
                value = value.transpose(2, 1, 0)  # [W, I, O] -> [O, I, W]
            if tuple(value.shape) != tuple(target.shape):
                raise ValueError(f"{key}: checkpoint shape {value.shape}, "
                                 f"model shape {tuple(target.shape)}")
            target.copy_(torch.tensor(np.asarray(value, dtype=np.float32)))
    return model


def _adopt_quantized_form(model, flat):
    """Quantise in place the layers that ``flat`` holds in int8 form and
    the model does not yet."""
    for name, m in model.named_modules():
        prefix = f"{name}." if name else ""
        if (isinstance(m, nn.LSTM) and not m.quantized
                and prefix + "w_hh_q" in flat):
            m.set_quantized(*(flat[prefix + k] for k in (
                "w_hh_q", "scales", "w_ih_q", "ih_scales")))
        elif (isinstance(m, nn.LinearCRFEncoder) and m.w_q is None
                and prefix + "w_q" in flat):
            m.set_quantized_head(flat[prefix + "w_q"], flat[prefix + "w_s"])


def save_params(path, model):
    """``weights_{N}.npz`` in bonito_tpu's key format (f32): the inverse of
    ``params_from_jax``. Float models only: a quantised model no longer
    holds the weights a checkpoint stores."""
    quantized = [name for name, m in model.named_modules()
                 if isinstance(m, nn.LSTM) and m.quantized]
    if quantized:
        raise ValueError(f"layers {quantized} are quantised; save the float "
                         f"model, quantisation happens at load")
    conv_w = _conv_weight_keys(model)
    flat = {}
    for key, value in model.state_dict().items():
        value = value.detach().float().cpu().numpy()
        if key in conv_w:
            value = value.transpose(2, 1, 0)
        flat[key] = np.ascontiguousarray(value)
    np.savez(path, **flat)


def save_checkpoint(workdir, epoch, model, optim_state=None):
    """``weights_{epoch}.npz`` in ``workdir`` (bonito_tpu's key format: it
    loads there with ``checkpoint.load_params``), and ``optim_{epoch}.pt``
    with the optimiser's state when one is given. The port keeps its own
    optimiser file: bonito_tpu's ``optim_{epoch}.pkl`` pickles optax state,
    which neither side reads from the other."""
    workdir = Path(workdir)
    save_params(workdir / f"weights_{epoch}.npz", model)
    if optim_state is not None:
        torch.save(optim_state, workdir / f"optim_{epoch}.pt")


def load_optim_state(workdir, epoch):
    """The optimiser state ``save_checkpoint`` wrote for ``epoch``, or
    None."""
    path = Path(workdir) / f"optim_{epoch}.pt"
    if not path.exists():
        return None
    return torch.load(path, map_location="cpu", weights_only=True)
