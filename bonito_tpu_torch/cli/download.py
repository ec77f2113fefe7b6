"""
``python -m bonito_tpu_torch download``: bonito_tpu's download CLI
(``bonito_tpu/cli/download.py``). It fetches the published models and
training sets as zip archives from ``__url__`` (a ``file://`` URL works as
well), unpacks each into the output directory and writes a
``weights_N.npz`` beside every ``weights_N.tar`` it finds there, through
the port's importer. ``--list`` prints the tables below and fetches
nothing. A fetch that fails (no network, say) writes an error line and
gives None, as bonito_tpu's does.
"""

import re
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from pathlib import Path
from zipfile import ZipFile

__url__ = "https://cdn.oxfordnanoportal.com/software/analysis/bonito/"

# the published models, newest first (bonito_tpu's table)
models = [
    "dna_r10.4.1_e8.2_400bps_fast@v5.2.0",
    "dna_r10.4.1_e8.2_400bps_hac@v5.2.0",
    "dna_r10.4.1_e8.2_400bps_sup@v5.2.0",
    "dna_r10.4.1_e8.2_400bps_fast@v5.0.0",
    "dna_r10.4.1_e8.2_400bps_hac@v5.0.0",
    "dna_r10.4.1_e8.2_400bps_sup@v5.0.0",
    "dna_r10.4.1_e8.2_400bps_fast@v4.3.0",
    "dna_r10.4.1_e8.2_400bps_hac@v4.3.0",
    "dna_r10.4.1_e8.2_400bps_sup@v4.3.0",
    "dna_r10.4.1_e8.2_400bps_fast@v4.2.0",
    "dna_r10.4.1_e8.2_400bps_hac@v4.2.0",
    "dna_r10.4.1_e8.2_400bps_sup@v4.2.0",
    "dna_r10.4.1_e8.2_260bps_fast@v4.1.0",
    "dna_r10.4.1_e8.2_260bps_hac@v4.1.0",
    "dna_r10.4.1_e8.2_260bps_sup@v4.1.0",
    "dna_r10.4.1_e8.2_400bps_fast@v4.1.0",
    "dna_r10.4.1_e8.2_400bps_hac@v4.1.0",
    "dna_r10.4.1_e8.2_400bps_sup@v4.1.0",
    "dna_r10.4.1_e8.2_260bps_fast@v4.0.0",
    "dna_r10.4.1_e8.2_260bps_hac@v4.0.0",
    "dna_r10.4.1_e8.2_260bps_sup@v4.0.0",
    "dna_r10.4.1_e8.2_400bps_fast@v4.0.0",
    "dna_r10.4.1_e8.2_400bps_hac@v4.0.0",
    "dna_r10.4.1_e8.2_400bps_sup@v4.0.0",
    "dna_r10.4.1_e8.2_260bps_fast@v3.5.2",
    "dna_r10.4.1_e8.2_260bps_hac@v3.5.2",
    "dna_r10.4.1_e8.2_260bps_sup@v3.5.2",
    "dna_r10.4.1_e8.2_400bps_fast@v3.5.2",
    "dna_r10.4.1_e8.2_400bps_hac@v3.5.2",
    "dna_r10.4.1_e8.2_400bps_sup@v3.5.2",
    "dna_r9.4.1_e8_sup@v3.3",
    "dna_r9.4.1_e8_hac@v3.3",
    "dna_r9.4.1_e8_fast@v3.4",
    "rna004_130bps_fast@v5.2.0",
    "rna004_130bps_hac@v5.2.0",
    "rna004_130bps_sup@v5.2.0",
    "rna004_130bps_fast@v5.1.0",
    "rna004_130bps_hac@v5.1.0",
    "rna004_130bps_sup@v5.1.0",
    "rna004_130bps_fast@v5.0.0",
    "rna004_130bps_hac@v5.0.0",
    "rna004_130bps_sup@v5.0.0",
    "rna004_130bps_fast@v3.0.1",
    "rna004_130bps_hac@v3.0.1",
    "rna004_130bps_sup@v3.0.1",
    "rna002_70bps_fast@v3",
    "rna002_70bps_hac@v3",
    "rna002_70bps_sup@v3",
]

training = [
    "example_data_dna_r9.4.1_v0",
    "example_data_dna_r10.4.1_v0",
    "example_data_rna004_v0",
]


class Downloader:
    """Fetch, unpack and convert into ``out_dir``; an existing target is
    kept unless ``force``."""

    def __init__(self, out_dir, force=False):
        self.out_dir = Path(out_dir)
        self.force = force

    def download(self, name):
        target = self.out_dir / name
        if target.exists() and not self.force:
            sys.stderr.write(f" - skipping {name} (exists)\n")
            return target
        self.out_dir.mkdir(parents=True, exist_ok=True)
        url = f"{__url__}{name}.zip"
        zip_path = self.out_dir / f"{name}.zip"
        sys.stderr.write(f" - downloading {name}\n")
        try:
            import urllib.request
            urllib.request.urlretrieve(url, zip_path)
        except Exception as e:  # any failed fetch is reported, not raised
            sys.stderr.write(
                f"> error: download failed ({e}); this environment may have "
                "no network access\n")
            return None
        with ZipFile(zip_path) as zf:
            zf.extractall(self.out_dir)
        zip_path.unlink()
        self._convert(target)
        return target

    def _convert(self, model_dir):
        """A ``weights_N.npz`` beside each ``weights_N.tar`` of a model
        directory (one without ``config.toml`` is left as it is)."""
        from bonito_tpu_torch.checkpoint import (import_torch_checkpoint,
                                                 load_state, save_params)
        from bonito_tpu_torch.config import load_config
        from bonito_tpu_torch.util import load_symbol
        cfg_path = model_dir / "config.toml"
        if not cfg_path.exists():
            return
        config = load_config(cfg_path)
        model = load_symbol(config, "Model")(config)
        for tar in sorted(model_dir.glob("weights_*.tar")):
            m = re.search(r"_(\d+)\.tar$", tar.name)
            if m is None:
                continue  # weights_final.tar and the like
            npz = model_dir / f"weights_{m.group(1)}.npz"
            if npz.exists() and not self.force:
                continue
            load_state(model, import_torch_checkpoint(tar, model))
            save_params(npz, model)
            sys.stderr.write(f" - converted {tar.name} -> {npz.name}\n")


def main(args):
    from bonito_tpu_torch.util import __data_dir__, __models_dir__
    models_dir = args.out_dir or __models_dir__
    data_dir = args.out_dir or __data_dir__
    if args.models or args.all:
        if args.list:
            print("[available models]", file=sys.stderr)
            for model in models:
                print(f" - {model}")
        else:
            downloader = Downloader(models_dir, args.force)
            for model in models if args.all else (args.select or models):
                downloader.download(model)

    if args.training or args.all:
        if args.list:
            print("[available training data]", file=sys.stderr)
            for dataset in training:
                print(f" - {dataset}")
        else:
            downloader = Downloader(data_dir, args.force)
            for dataset in training:
                downloader.download(dataset)


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--all", action="store_true")
    group.add_argument("--models", action="store_true")
    group.add_argument("--training", action="store_true")
    parser.add_argument("--list", "-l", "--show", dest="list",
                        action="store_true")
    parser.add_argument("--out_dir", default=None, type=Path)
    parser.add_argument("--select", nargs="*", default=None)
    parser.add_argument("-f", "--force", action="store_true")
    return parser
