"""
Command line of the port: ``python -m bonito_tpu_torch <subcommand>``,
with bonito_tpu's subcommands. ``basecaller``, ``train``, ``evaluate``,
``view``, ``download`` and ``export`` are ported; ``duplex`` raises,
naming the ROADMAP item that ports it.
"""

import sys
from argparse import REMAINDER, ArgumentParser
from importlib import import_module

# subcommand -> the ROADMAP item (Queue 1) that ports it
WAITING = {
    "duplex": "Queue 1 item 11 (other CLI tools)",
}


def _waiting(args):
    raise NotImplementedError(
        f"bonito_tpu_torch {args.command} is not ported yet: "
        f"{WAITING[args.command]}")


def main(argv=None):
    from bonito_tpu_torch import __version__
    parser = ArgumentParser(prog="bonito_tpu_torch",
                            description="bonito_tpu on PyTorch and CUDA")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s " + __version__)
    subparsers = parser.add_subparsers(title="subcommands", dest="command",
                                       required=True)
    for name in ("basecaller", "train", "evaluate", "view", "download",
                 "export"):
        module = import_module(f"bonito_tpu_torch.cli.{name}")
        sub = subparsers.add_parser(name, parents=[module.argparser()])
        sub.set_defaults(func=module.main)
    for name in WAITING:
        sub = subparsers.add_parser(name, add_help=False)
        sub.add_argument("rest", nargs=REMAINDER)
        sub.set_defaults(func=_waiting)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    args.func(args)
