"""
``python -m bonito_tpu_torch export``: bonito_tpu's export CLI
(``bonito_tpu/cli/export.py``), a model directory in one of three forms:

- ``--format dorado``: one ``torch.jit.script``-ed ``.tensor`` archive a
  parameter (``torch.jit.load`` reads it back, as Dorado's libtorch does),
  named by upstream's encoder keys, BatchNorm fused into the convolutions,
  Clamp layers skipped in the layer numbering;
- ``--format npy``: the same tensors as ``.npy`` files;
- ``--format torch``: an upstream ``weights_1.tar`` (``checkpoint.
  export_state_dict``), which upstream bonito, bonito_tpu and the port
  import.

Each writes the config with its training-only sections taken out. The
model is loaded in f32 and not quantised; ``--device cpu`` loads it on the
CPU (the card otherwise).
"""

import shutil
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from pathlib import Path

import numpy as np

from bonito_tpu_torch import nn
from bonito_tpu_torch.checkpoint import export_state_dict
from bonito_tpu_torch.config import load_config, save_config
from bonito_tpu_torch.util import load_model


def clean_config(config):
    """The config without its training-only sections; every other field
    stays (unknown metadata too)."""
    drop = ("decoder", "aux_CRF_losses", "training", "basecaller",
            "lr_scheduler", "optim")
    config = {k: v for k, v in config.items() if k not in drop}
    for field in ("qscore", "run_info", "scaling", "standardisation",
                  "training_dataset"):
        if field not in config:
            sys.stderr.write(
                f"INFO: metadata '{field}' is not set in config\n")
    return config


def reorder_layers_without_clamp(encoder_dict):
    """A serialised encoder tree without its Clamp layers."""
    if "sublayers" in encoder_dict:
        subs = [s for s in encoder_dict["sublayers"]
                if s.get("type") != "clamp"]
        encoder_dict = dict(encoder_dict, sublayers=[
            reorder_layers_without_clamp(s) for s in subs])
    return encoder_dict


def torch_state_dict(model):
    """The model's tensors under upstream's keys and layouts (every family),
    the keys rewritten as the importer expects them (the conv-CTC decoder's
    ``decoder.layers.0.*``)."""
    import torch
    state = {}
    for root in ("encoder", "decoder"):
        tree = getattr(model, root, None)
        if tree is not None:
            state.update(export_state_dict(tree, prefix=root))
    rewrite = getattr(model, "rewrite_torch_keys", None)
    if rewrite is not None:
        state = {rewrite(k): v for k, v in state.items()}
    return {k: torch.from_numpy(v) for k, v in state.items()}


def save_tensor(directory, name, array):
    """One tensor as a scripted module archive, the tensor its parameter
    "0": the form Dorado loads."""
    import torch
    module = torch.nn.Module()
    module.register_parameter(
        "0", torch.nn.Parameter(torch.from_numpy(array.copy()),
                                requires_grad=False))
    torch.jit.script(module).save(str(directory / f"{name}.tensor"))


def _clamp_order_map(encoder):
    """Top-level index -> its number when Clamp layers are not counted
    (the v4.0-v4.2 models put Clamps after convolutions; Dorado's
    numbering skips them)."""
    if not isinstance(encoder, nn.Serial):
        return {}
    clamp_count = 0
    order = {}
    for i, layer in enumerate(encoder.children()):
        if isinstance(layer, nn.Clamp):
            clamp_count += 1
        order[str(i)] = str(i - clamp_count)
    return order


def export_to_dorado(model, config, output, tensor_format="tensor"):
    """The encoder's tensors, BatchNorm fused, one file each, and the
    cleaned config. A Clamp-skipping rename moves the file after it is
    written (the archive keeps the name it was saved under)."""
    output.mkdir(parents=True, exist_ok=True)
    nn.fuse_bn(model.encoder)
    state = export_state_dict(model.encoder)

    for name, arr in state.items():
        if tensor_format == "npy":
            np.save(output / f"{name}.npy", arr)
        else:
            save_tensor(output, name, arr)

    order = _clamp_order_map(model.encoder)
    if any(k != v for k, v in order.items()):
        ext = "npy" if tensor_format == "npy" else "tensor"
        for name in state:
            head = name.split(".")[0]
            new = order.get(head, head)
            if new != head:
                shutil.move(output / f"{name}.{ext}",
                            output / f"{name.replace(head, new, 1)}.{ext}")

    cfg = clean_config(dict(config))
    if "encoder" in cfg and isinstance(cfg["encoder"], dict):
        cfg["encoder"] = reorder_layers_without_clamp(cfg["encoder"])
    save_config(cfg, output / "config.toml")
    sys.stderr.write(f"> exported {len(state)} tensors to {output}\n")


def main(args):
    model = load_model(args.model_directory, half=False, device=args.device)
    if args.config:
        config = load_config(args.config)
    elif (Path(args.model_directory) / "config.toml").exists():
        config = load_config(Path(args.model_directory) / "config.toml")
    else:
        config = model.config
    output = Path(args.output)

    if args.format in ("dorado", "npy"):
        export_to_dorado(model, config, output,
                         tensor_format="npy" if args.format == "npy"
                         else "tensor")
    else:
        import torch
        output.mkdir(parents=True, exist_ok=True)
        torch.save(torch_state_dict(model), output / "weights_1.tar")
        save_config(clean_config(dict(config)), output / "config.toml")
        sys.stderr.write(f"> exported torch checkpoint to {output}\n")


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("--output", required=True)
    parser.add_argument("--config", default=None,
                        help="config file to read settings from "
                             "(default: the model dir's config.toml)")
    parser.add_argument("--format", default="dorado",
                        choices=("dorado", "npy", "torch"))
    parser.add_argument("--device", default=None,
                        help="torch device to load the model on (default: "
                             "the CUDA card; 'cpu' for the CPU)")
    return parser
