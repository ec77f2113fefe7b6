"""
``python -m bonito_tpu_torch basecaller``: a directory of pod5 or fast5
reads to SAM, BAM, CRAM or fastq on stdout, on one card (``--device cpu``
runs the plain versions on the CPU). bonito_tpu's CLI (``bonito_tpu/cli/
basecaller.py``) with the same flags: reader processes -> the basecall
chain (the device step inside) -> the aligner stage (``--reference``) ->
the writer thread. The format follows the name stdout is redirected to.

Every model family runs: LSTM-CRF, transformer-CRF and conv-CTC (whose
fastq output takes the greedy decode with qualities; its SAM and BAM the
beam's sequence, qstring "*" and no moves, as bonito_tpu's).

A published model name (``cli.download.models``) with no directory on
disk is downloaded into ``util.__models_dir__`` first, as bonito_tpu's.
CRAM is reference-based with ``--reference`` (it decodes with the same
fasta) and referenceless without, as bonito_tpu writes it.
``--distributed`` is refused before the model loads, naming its ROADMAP
item.
"""

import inspect
import os
import sys
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from datetime import timedelta
from itertools import islice

import numpy as np

from bonito_tpu_torch import resolve_device, util
from bonito_tpu_torch.cli.download import Downloader, models
from bonito_tpu_torch.io import CTCWriter, NullWriter, Writer, biofmt
from bonito_tpu_torch.pipeline import process_cancel
from bonito_tpu_torch.reader import Reader, read_chunks
from bonito_tpu_torch.util import (column_to_set, init, load_model,
                                   load_symbol)


def main(args):
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-GPU basecalling is ROADMAP Queue 1 item 12")
    device = resolve_device(args.device)
    init(args.seed)

    try:
        reader = Reader(args.reads_directory, args.recursive)
        sys.stderr.write(f"> reading {reader.fmt}\n")
    except FileNotFoundError:
        sys.stderr.write(f"> error: no suitable files found in "
                         f"{args.reads_directory}\n")
        sys.exit(1)

    fmt = biofmt(aligned=bool(args.reference))
    if args.reference and args.reference.endswith(".mmi"):
        # the mapper indexes the FASTA itself; minimap2's .mmi is not read
        sys.stderr.write(
            "> error: prebuilt minimap2 .mmi indexes are not supported; "
            "pass the FASTA\n")
        sys.exit(1)
    elif args.reference and fmt.name == "fastq":
        sys.stderr.write(f"> warning: did you really want {fmt.aligned} "
                         f"{fmt.name}?\n")
    else:
        sys.stderr.write(f"> outputting {fmt.aligned} {fmt.name}\n")

    if (args.model_directory in models
            and not (util.__models_dir__ / args.model_directory).exists()):
        sys.stderr.write("> downloading model\n")
        Downloader(util.__models_dir__).download(args.model_directory)

    sys.stderr.write(f"> loading model {args.model_directory}\n")
    if args.weights in (None, "", 0, "0"):
        weights = None  # 0 or unset: the latest
    else:
        try:
            weights = int(args.weights)
        except ValueError:
            sys.stderr.write(f"> error: --weights takes an integer, got "
                             f"{args.weights!r}\n")
            sys.exit(1)
    try:
        model = load_model(
            args.model_directory, weights=weights, chunksize=args.chunksize,
            overlap=args.overlap, batchsize=args.batchsize,
            quantize=args.quantize, fuse_bn=True, device=device)
    except FileNotFoundError:
        sys.stderr.write(f"> error: failed to load {args.model_directory}\n")
        sys.stderr.write("> available models:\n")
        for name in sorted(models):
            sys.stderr.write(f" - {name}\n")
        sys.exit(1)
    if args.verbose:
        sys.stderr.write(f"> model basecaller params: "
                         f"{model.config.get('basecaller')}\n")

    basecall = load_symbol(model.config, "basecall")
    mods = model.config.get("basecaller", {})
    chunksize = args.chunksize or mods.get("chunksize", 4000)
    overlap = (args.overlap if args.overlap is not None
               else mods.get("overlap", 500))
    batchsize = args.batchsize or mods.get("batchsize", 64)
    chunksize -= chunksize % model.stride
    overlap -= overlap % (model.stride * 2)

    aligner = None
    if args.reference:
        from bonito_tpu_torch.aligner import Aligner, align_map
        sys.stderr.write("> loading reference\n")
        aligner = Aligner(args.reference, preset=args.mm2_preset)

    if args.save_ctc and not args.reference:
        sys.stderr.write("> a reference is needed to output ctc training "
                         "data\n")
        sys.exit(1)

    read_ids = column_to_set(args.read_ids)
    cancel = process_cancel()

    groups = []
    if fmt.name != "fastq":
        groups, _ = reader.get_read_groups(
            args.reads_directory, args.model_directory, n_proc=8,
            recursive=args.recursive, read_ids=read_ids, skip=args.skip,
            cancel=cancel)

    scaling = model.config.get("scaling")
    reads = reader.get_reads(
        args.reads_directory, n_proc=args.n_proc, recursive=args.recursive,
        read_ids=read_ids, skip=args.skip, do_trim=not args.no_trim,
        norm_params=(model.config.get("standardisation")
                     if (scaling or {}).get("strategy") == "pa"
                     else model.config.get("normalisation")),
        scaling_strategy=scaling, max_read_size=args.max_read_size,
        cancel=cancel)
    if args.verbose:
        sys.stderr.write(f"> read scaling: {scaling}\n")
    if args.max_reads:
        reads = islice(reads, args.max_reads)
    if args.save_ctc:
        reads = (ctc_chunk for read in reads for ctc_chunk in read_chunks(
            read, chunksize=chunksize, overlap=overlap))

    kwargs = {}
    params = inspect.signature(basecall).parameters
    if fmt.name == "fastq" and "qscores" in params:
        # conv-CTC: the beam gives no qstring ('*'), which fastq cannot
        # hold; the greedy decode with qualities, as bonito_tpu's CLI
        kwargs["qscores"] = True
    if args.beam:
        if "decoder" in params:
            kwargs["decoder"] = "beam"
        else:
            sys.stderr.write("> warning: --beam has no effect for this model "
                             "family (no beam decoder); using its default "
                             "decode\n")
    results = basecall(model, reads, reverse=args.revcomp, rna=args.rna,
                       batchsize=batchsize, chunksize=chunksize,
                       overlap=overlap, **kwargs)
    if aligner:
        results = align_map(aligner, results, n_thread=args.alignment_threads)

    if args.save_ctc:
        min_accuracy = (args.min_accuracy_save_ctc
                        if args.min_accuracy_save_ctc is not None
                        else args.ctc_min_accuracy)
        writer = CTCWriter(
            fmt.mode, results, aligner, min_coverage=args.ctc_min_coverage,
            min_accuracy=min_accuracy, output_dir=args.output_dir,
            rna=args.rna, min_qscore=args.min_qscore, groups=groups,
            group_key=args.model_directory)
    elif args.no_output:
        writer = NullWriter(fmt.mode, results)
    else:
        writer = Writer(fmt.mode, results, aligner=aligner, groups=groups,
                        group_key=args.model_directory,
                        min_qscore=args.min_qscore,
                        output_dir=args.output_dir)

    t0 = time.perf_counter()
    writer.start()
    rejected = writer.stop() or {}
    duration = time.perf_counter() - t0
    sys.stdout.flush()

    num_samples = sum(num_samples for _, num_samples in writer.log)
    sys.stderr.write("> completed reads: %s\n" % len(writer.log))
    for reason, count in rejected.items():
        sys.stderr.write(f"> rejected reads: {count} ({reason})\n")
    sys.stderr.write("> duration: %s\n" % timedelta(
        seconds=np.round(duration)))
    sys.stderr.write("> samples per second %.1E\n" % (num_samples / duration))
    sys.stderr.write("> done\n")


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("reads_directory")
    parser.add_argument("--reference")
    parser.add_argument("--mm2-preset", default="lr:hq")
    parser.add_argument("--read-ids")
    parser.add_argument("--output-dir", default=None)
    parser.add_argument("--skip", action="store_true", default=False)
    parser.add_argument("--no-trim", action="store_true", default=False)
    parser.add_argument("--save-ctc", action="store_true", default=False)
    parser.add_argument("--ctc-min-coverage", default=0.9, type=float)
    parser.add_argument("--ctc-min-accuracy", default=0.99, type=float)
    parser.add_argument("--revcomp", action="store_true", default=False)
    parser.add_argument("--recursive", action="store_true", default=False)
    # None: the model config's [basecaller] quantize decides
    quant = parser.add_mutually_exclusive_group()
    quant.add_argument("--quantize", dest="quantize", action="store_true")
    quant.add_argument("--no-quantize", dest="quantize",
                       action="store_false")
    parser.set_defaults(quantize=None)
    parser.add_argument("--rna", action="store_true", default=False)
    parser.add_argument("--no-output", action="store_true", default=False)
    parser.add_argument("--weights", default=None, type=str)
    parser.add_argument("--seed", default=25, type=int)
    parser.add_argument(
        "--beam", action="store_true", default=False,
        help="decode with the fixed-width CRF beam search instead of the "
             "exact Viterbi path")
    parser.add_argument("--chunksize", default=None, type=int)
    parser.add_argument("--overlap", default=None, type=int)
    parser.add_argument("--batchsize", default=None, type=int)
    parser.add_argument("--max-read-size", default=0, type=int)
    parser.add_argument("--max-reads", default=0, type=int)
    parser.add_argument("--alignment-threads", type=int,
                        default=max(1, min(8, os.cpu_count() or 4)))
    parser.add_argument("--min-qscore", default=0, type=int)
    parser.add_argument("--min-accuracy-save-ctc", default=None, type=float,
                        help="alias of --ctc-min-accuracy")
    # reader processes: leave cores to the pipeline's threads
    parser.add_argument("--n-proc", type=int,
                        default=max(1, min(8, (os.cpu_count() or 4) - 2)))
    parser.add_argument("--device", default=None,
                        help="torch device; the card when not given "
                             "(cpu: the plain versions)")
    parser.add_argument("--distributed", action="store_true", default=False,
                        help="multi-GPU basecalling (not ported yet: raises)")
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of process 0 with --distributed")
    parser.add_argument("-v", "--verbose", action="count", default=0)
    return parser
