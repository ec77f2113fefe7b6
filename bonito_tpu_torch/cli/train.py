"""
``python -m bonito_tpu_torch train``: bonito_tpu's training CLI on one
card (``--device cpu`` runs the plain versions on the CPU): workdir
setup, the config or a pretrained model, data loading, ``Trainer.fit``.
"""

import os
import sys
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from importlib import import_module
from pathlib import Path

from bonito_tpu_torch import models as model_zoo
from bonito_tpu_torch import resolve_device
from bonito_tpu_torch import schedule as schedules
from bonito_tpu_torch.config import load_config, save_config
from bonito_tpu_torch.data import (
    ComputeSettings, DataSettings, ModelSetup, load_data)
from bonito_tpu_torch.training import Trainer
from bonito_tpu_torch.util import init, load_model, load_symbol, model_directory


def main(args):
    workdir = Path(args.training_directory)
    if workdir.exists() and not args.force:
        sys.stderr.write(f"[error] {workdir} exists, use -f to force continue "
                         "training or delete it.\n")
        sys.exit(1)
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-GPU training is ROADMAP Queue 1 item 12")
    device = resolve_device(args.device)
    init(args.seed)

    if args.pretrained:
        config = load_config(model_directory(args.pretrained) / "config.toml")
        if "lr_scheduler" in config:
            sys.stderr.write(
                "[ignoring 'lr_scheduler' in --pretrained config]\n")
            del config["lr_scheduler"]
    elif args.config and os.path.exists(args.config):
        config = load_config(args.config)
    elif args.config:
        config = model_zoo.get_config(args.config)
    else:
        sys.stderr.write("[error] --config or --pretrained is required\n")
        sys.exit(1)

    sys.stderr.write("[loading model]\n")
    if args.pretrained:
        sys.stderr.write(f"[using pretrained model {args.pretrained}]\n")
        # quantize=False: None would take the config's own value, true in
        # every shipped LSTM-CRF config, and an int8 model does not train
        model = load_model(args.pretrained, half=False, quantize=False,
                           device=device)
    else:
        model = load_symbol(config, "Model")(config).init(args.seed)
        model = model.to(device)

    sys.stderr.write("[loading data]\n")
    train_loader, valid_loader = load_data(
        DataSettings(training_data=args.directory,
                     num_train_chunks=args.chunks,
                     num_valid_chunks=args.valid_chunks,
                     output_dir=str(workdir)),
        ModelSetup(
            n_pre_context_bases=getattr(model, "n_pre_context_bases", 0),
            n_post_context_bases=getattr(model, "n_post_context_bases", 0),
            standardisation=config.get("standardisation", {})),
        ComputeSettings(batch_size=args.batch, num_workers=args.num_workers,
                        seed=args.seed))

    os.makedirs(workdir, exist_ok=True)
    # the workdir's config records the invocation and any dataset metadata
    config["training"] = {
        k: (str(v) if isinstance(v, Path) else v)
        for k, v in vars(args).items()
        if v is not None and not callable(v)
    }
    config["training"]["pwd"] = os.getcwd()
    dataset_cfg = getattr(
        getattr(train_loader, "dataset", None), "dataset_config", None)
    save_config({**config, **(dataset_cfg or {})}, workdir / "config.toml")

    lr_scheduler_fn = None
    if "lr_scheduler" in config:
        sched_config = dict(config["lr_scheduler"])
        if "package" in sched_config:
            # upstream and bonito_tpu configs name the builder by package
            package = sched_config["package"]
            for prefix in ("bonito.", "bonito_tpu."):
                if package.startswith(prefix):
                    package = "bonito_tpu_torch." + package[len(prefix):]
            builder = getattr(import_module(package), sched_config["symbol"])
        else:
            builder = getattr(schedules, sched_config.pop(
                "type", "linear_warmup_cosine_decay"))
        lr_scheduler_fn = builder(**sched_config)

    ds = getattr(train_loader, "dataset", None)
    trainer = Trainer(
        model, train_loader, valid_loader,
        use_amp=not args.no_amp,
        lr_scheduler_fn=lr_scheduler_fn,
        restore_optim=args.restore_optim,
        save_optim_every=args.save_optim_every,
        grad_accum_split=args.grad_accum_split,
        quantile_grad_clip=args.quantile_grad_clip,
        chunks_per_epoch=args.chunks or (len(ds) if ds is not None else 0),
        batch_size=args.batch,
    )
    # the CLI's lr wins over any [optim] lr; comma-separated values would be
    # per-group rates, which only a pluggable optimiser takes
    if "," in str(args.lr):
        lr = [float(x) for x in str(args.lr).split(",")]
    else:
        lr = float(args.lr)
    optim_kwargs = dict(config.get("optim", {}))
    optim_kwargs.pop("lr", None)
    trainer.fit(workdir, args.epochs, lr, **optim_kwargs)


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("training_directory")
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--config", default="dna_r9.4.1@v3.1")
    group.add_argument("--pretrained", default="")
    parser.add_argument("--directory", type=Path, required=True)
    parser.add_argument("--lr", default="2e-3")
    parser.add_argument("--seed", default=25, type=int)
    parser.add_argument("--epochs", default=5, type=int)
    parser.add_argument("--batch", default=64, type=int)
    parser.add_argument("--chunks", default=0, type=int)
    parser.add_argument("--valid-chunks", default=None, type=int)
    parser.add_argument("--no-amp", action="store_true", default=False)
    parser.add_argument("-f", "--force", action="store_true", default=False)
    parser.add_argument("--restore-optim", action="store_true", default=False)
    parser.add_argument("--nondeterministic", action="store_true",
                        default=False,
                        help="accepted for compatibility; has no effect")
    parser.add_argument("--device", default=None,
                        help="the torch device to train on (default: the "
                             "CUDA card; 'cpu' runs the plain versions)")
    parser.add_argument("--num-workers", default=4, type=int)
    parser.add_argument("--save-optim-every", default=10, type=int)
    parser.add_argument("--grad-accum-split", default=1, type=int)
    clip_group = parser.add_mutually_exclusive_group()
    clip_group.add_argument("--quantile-grad-clip", dest="quantile_grad_clip",
                            action="store_true")
    clip_group.add_argument("--no-quantile-grad-clip",
                            dest="quantile_grad_clip", action="store_false")
    clip_group.set_defaults(quantile_grad_clip=True)
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="multi-GPU training: not ported yet (ROADMAP "
                             "Queue 1 item 12)")
    parser.add_argument("--coordinator-address", default=None,
                        help="accepted with --distributed, which raises")
    return parser
