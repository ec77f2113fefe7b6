"""
Command line of the port: ``python -m bonito_tpu_torch <subcommand>``,
with bonito_tpu's subcommands: ``basecaller``, ``duplex``, ``train``,
``evaluate``, ``view``, ``download`` and ``export``.
"""

import sys
from argparse import ArgumentParser
from importlib import import_module


def main(argv=None):
    from bonito_tpu_torch import __version__
    parser = ArgumentParser(prog="bonito_tpu_torch",
                            description="bonito_tpu on PyTorch and CUDA")
    parser.add_argument("-v", "--version", action="version",
                        version="%(prog)s " + __version__)
    subparsers = parser.add_subparsers(title="subcommands", dest="command",
                                       required=True)
    for name in ("basecaller", "duplex", "train", "evaluate", "view",
                 "download", "export"):
        module = import_module(f"bonito_tpu_torch.cli.{name}")
        sub = subparsers.add_parser(name, parents=[module.argparser()])
        sub.set_defaults(func=module.main)
    args = parser.parse_args(sys.argv[1:] if argv is None else argv)
    args.func(args)
