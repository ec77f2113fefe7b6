"""
``python -m bonito_tpu_torch view``: bonito_tpu's view CLI
(``bonito_tpu/cli/view.py``): a model's layer tree and its parameter
count, from a ``MODELS`` name, a ``config.toml`` or a model directory. The
count is of the model's parameters: BatchNorm's running statistics are
buffers and not in it, as in bonito_tpu's count. Nothing is initialised
or moved to a device.
"""

import os
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser

from bonito_tpu_torch import models as model_zoo
from bonito_tpu_torch.config import load_config
from bonito_tpu_torch.util import load_symbol


def describe(layer, name="", indent=0):
    """The lines of ``layer``'s tree: each module's class with its scalar
    settings, its children indented under it."""
    attrs = layer.to_dict() if hasattr(layer, "to_dict") else {}
    inline = ", ".join(f"{k}={v}" for k, v in attrs.items()
                       if not isinstance(v, (dict, list, tuple)))
    label = f"({name}) " if name else ""
    lines = [f"{'  ' * indent}{label}{type(layer).__name__}({inline})"]
    for child_name, child in layer.named_children():
        lines.extend(describe(child, child_name, indent + 1))
    return lines


def main(args):
    if os.path.isdir(args.config):
        config = load_config(os.path.join(args.config, "config.toml"))
    elif os.path.exists(args.config):
        config = load_config(args.config)
    else:
        config = model_zoo.get_config(args.config)
    model = load_symbol(config, "Model")(config)
    for root in ("encoder", "decoder"):
        layer = getattr(model, root, None)
        if layer is not None:
            print("\n".join(describe(layer, root)))
    total = sum(p.numel() for p in model.parameters())
    print("total parameters:", "{:,}".format(total))


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("config", help="config.toml path, model directory "
                                       "or model-zoo name")
    return parser
