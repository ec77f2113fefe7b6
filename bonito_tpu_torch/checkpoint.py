"""
Checkpoints: bonito_tpu's flat, dot-keyed ``weights_{N}.npz`` (numpy
alone reads it) and the converter from bonito_tpu's parameter tree, and
upstream bonito's ``weights_{N}.tar`` (a torch state dict) in and out.

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
Param-less layers (Permute, Clamp) have no entry. A training run also
writes the optimiser's state, in the port's own ``optim_N.pt``.

Upstream's keys name its torch modules (``encoder.0.conv.weight``,
``encoder.0.norm.bn.running_mean``, ``encoder.4.rnn.weight_ih_l0``,
``encoder.9.linear.weight``; a family's own in ``torch_param_map`` and
``rewrite_torch_keys``). ``import_torch_checkpoint`` maps them onto the
port's keys in the port's layouts, as bonito_tpu's importer does onto
its own: an upstream conv weight is [O, I, W], the port's layout, and
stays so; linear and LSTM weights turn to [in, out]; an LSTM's
``bias_ih_l0`` and ``bias_hh_l0`` fold into one ``b``; ``module.``
prefixes and ``num_batches_tracked`` go. ``export_state_dict`` is its
inverse, with a zeroed ``bias_hh_l0`` beside each LSTM bias.

Checkpoints on disk hold the float tree only: quantisation happens at
load (``util.load_model``), as in bonito_tpu. ``params_from_jax`` also
takes an already-quantised bonito_tpu tree (``w_hh_q``/``scales``/
``w_ih_q``/``ih_scales`` in place of an LSTM's ``w_hh``/``w_ih``, and
``w_q``/``w_s`` beside a CRF head's ``w``) and puts the model's layers
into that form.
"""

import re
import sys
import zipfile
from pathlib import Path

import numpy as np
import torch

from bonito_tpu_torch import nn


def same(a):
    """An upstream tensor already in the port's layout."""
    return a


def transpose(a):
    """[out, in] <-> [in, out] (linear and LSTM weights)."""
    return np.transpose(a, (1, 0))


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
    # [W, I, O] -> [O, I, W]
    return load_state(model, {k: v.transpose(2, 1, 0) if k in conv_w else v
                              for k, v in flat.items()})


def load_state(model, flat):
    """Fill ``model`` from flat keys in the port's own layouts (what
    ``import_torch_checkpoint`` gives). Every tensor the model holds must
    be present with the matching shape, and nothing else may be."""
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


# ---------------------------------------------------------------------------
# upstream torch checkpoints
# ---------------------------------------------------------------------------

def _torch_state_dict(path):
    """{key: numpy array} of a torch state dict file, read with
    ``weights_only`` (nothing but tensors and containers is unpickled),
    ``module.`` prefixes stripped and non-tensor entries dropped."""
    state = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    state = {(k[len("module."):] if k.startswith("module.") else k): v
             for k, v in state.items()}
    return {k: v.detach().numpy() for k, v in state.items()
            if isinstance(v, torch.Tensor)}


def _expected_torch_params(layer, path):
    """[(upstream key, port key, converter)] of one layer; the converter
    maps the upstream array to the port's layout and back."""
    out = []
    if isinstance(layer, nn.Convolution):
        out.append((f"{path}.conv.weight", f"{path}.w", same))
        if layer.bias:
            out.append((f"{path}.conv.bias", f"{path}.b", same))
        if isinstance(layer.norm, nn.BatchNorm):
            # upstream's BatchNorm wraps a torch module named "bn"
            out.extend(_batchnorm_params(layer.norm, f"{path}.norm"))
    elif isinstance(layer, nn.BatchNorm):
        out.extend(_batchnorm_params(layer, path))
    elif isinstance(layer, nn.LSTM):
        out.append((f"{path}.rnn.weight_ih_l0", f"{path}.w_ih", transpose))
        out.append((f"{path}.rnn.weight_hh_l0", f"{path}.w_hh", transpose))
        if layer.bias:
            out.append((f"{path}.rnn.bias_ih_l0", f"{path}.b", same))
    elif isinstance(layer, (nn.LinearCRFEncoder, nn.Linear)):
        # upstream wraps a torch.nn.Linear named "linear"
        out.append((f"{path}.linear.weight", f"{path}.w", transpose))
        if layer.bias:
            out.append((f"{path}.linear.bias", f"{path}.b", same))
    elif isinstance(layer, nn.LinearUpsample):
        out.append((f"{path}.linear.weight", f"{path}.w", transpose))
        out.append((f"{path}.linear.bias", f"{path}.b", same))
    elif hasattr(layer, "torch_param_map"):
        out.extend(layer.torch_param_map(path))
    return out


def _batchnorm_params(bn, path):
    out = []
    if bn.affine:
        out.append((f"{path}.bn.weight", f"{path}.scale", same))
        out.append((f"{path}.bn.bias", f"{path}.bias", same))
    if bn.track_running_stats:
        out.append((f"{path}.bn.running_mean", f"{path}.mean", same))
        out.append((f"{path}.bn.running_var", f"{path}.var", same))
    return out


def _expected(layer, path):
    """The entries of ``layer``'s tree under ``path``: a layer with its own
    entries maps its whole subtree (a convolution's norm too)."""
    entries = _expected_torch_params(layer, path)
    if entries:
        return entries
    for name, sub in layer.named_children():
        entries.extend(_expected(sub, f"{path}.{name}" if path else name))
    return entries


def _natural(key):
    """Numeric-aware order: 'encoder.2' before 'encoder.10'."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", key)]


def _match_names(state, expected):
    """{expected upstream key: key in ``state``}. Where a key is missing
    (renamed modules), both sides are grouped by their last two key
    parts and paired in natural order; a group whose counts differ
    raises KeyError rather than permute weights."""
    keys = [k for k, _, _ in expected]
    if all(k in state for k in keys):
        return {k: k for k in keys}

    def suffix(k):
        return ".".join(k.split(".")[-2:])

    state_by_sfx, exp_by_sfx = {}, {}
    for k in state:
        state_by_sfx.setdefault(suffix(k), []).append(k)
    for k in keys:
        exp_by_sfx.setdefault(suffix(k), []).append(k)
    remap = {}
    for sfx, exp_keys in exp_by_sfx.items():
        cands = state_by_sfx.get(sfx, [])
        if len(cands) != len(exp_keys):
            raise KeyError(
                f"checkpoint parameters matching *.{sfx}: need "
                f"{len(exp_keys)}, found {len(cands)}")
        for e, c in zip(sorted(exp_keys, key=_natural),
                        sorted(cands, key=_natural)):
            remap[e] = c
    return remap


def _nested(flat):
    tree = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _check_against(params, model):
    """bonito_tpu's guard: an imported array whose shape differs from the
    model's tensor raises (the remap paired the wrong layers); one the
    model has no place for is reported."""
    have = _nested({k: tuple(v.shape) for k, v in model.state_dict().items()})

    def walk(exp_node, have_node, path):
        for k, v in exp_node.items():
            h = have_node.get(k) if isinstance(have_node, dict) else None
            if isinstance(v, dict):
                if isinstance(h, dict):
                    walk(v, h, f"{path}.{k}")
                else:
                    sys.stderr.write(
                        f"> warning: imported subtree {path}.{k} has "
                        f"no counterpart in the model\n")
            elif h is None:
                sys.stderr.write(
                    f"> warning: imported parameter {path}.{k} has "
                    f"no counterpart in the model\n")
            elif tuple(v.shape) != h:
                raise ValueError(
                    f"checkpoint import shape mismatch at {path}.{k}: "
                    f"{tuple(v.shape)} vs model {h}")

    walk(_nested(params), have, "")


def import_torch_checkpoint(path, model):
    """An upstream ``weights_N.tar`` as {port key: f32 array} in the port's
    layouts, for ``model``'s tree (``load_state`` fills the model)."""
    state = _torch_state_dict(path)
    expected = [e for root in ("encoder", "decoder")
                if getattr(model, root, None) is not None
                for e in _expected(getattr(model, root), root)]
    rewrite = getattr(model, "rewrite_torch_keys", None)
    if rewrite is not None:
        expected = [(rewrite(tk), ok, conv) for tk, ok, conv in expected]
    remap = _match_names(state, expected)
    params = {}
    for torch_key, our_key, convert in expected:
        src = remap[torch_key]
        arr = convert(state[src])
        # upstream's LSTMs carry bias_hh beside bias_ih: one sum here
        if torch_key.endswith("bias_ih_l0"):
            hh = src.replace("bias_ih", "bias_hh")
            if hh in state:
                arr = arr + state[hh]
        params[our_key] = np.ascontiguousarray(arr, np.float32)
    _check_against(params, model)
    return params


def export_state_dict(layer, prefix=""):
    """``layer``'s tensors under upstream's keys and layouts (f32 numpy),
    the inverse of ``import_torch_checkpoint``: every converter is its own
    inverse. Each LSTM bias gets a zeroed ``bias_hh_l0`` twin. Keys are
    relative to ``layer`` unless ``prefix`` is given."""
    have = layer.state_dict()
    plen = len(prefix) + 1 if prefix else 0
    state, skipped = {}, []
    for torch_key, our_key, convert in _expected(layer, prefix):
        value = have.get(our_key[plen:])
        if value is None:
            skipped.append(torch_key)  # a quantised layer's float weights
            continue
        # a copy: a CPU tensor's numpy() shares the parameter's memory
        arr = convert(value.detach().float().cpu().numpy()).copy(order="C")
        state[torch_key] = arr
        if torch_key.endswith("bias_ih_l0"):
            state[torch_key.replace("bias_ih", "bias_hh")] = np.zeros_like(arr)
    if skipped:
        sys.stderr.write(
            f"> warning: export skipped {len(skipped)} expected "
            f"parameter(s) missing from the params tree "
            f"(first: {skipped[0]})\n")
    return state


def load_weights(path, model):
    """Fill ``model`` from a ``weights_N.npz`` (bonito_tpu's) or an
    upstream ``weights_N.tar``."""
    path = str(path)
    if path.endswith(".npz"):
        return params_from_jax(model, load_params(path))
    if path.endswith(".tar") or zipfile.is_zipfile(path):
        return load_state(model, import_torch_checkpoint(path, model))
    raise ValueError(f"unrecognised checkpoint format: {path}")


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
