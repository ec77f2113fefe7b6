"""
``python -m bonito_tpu_torch evaluate``: bonito_tpu's evaluate CLI
(``bonito_tpu/cli/evaluate.py``) on one card (``--device cpu`` runs the
plain versions on the CPU): a model of any family scored on training or
validation chunks with references, the accuracy and the substitution,
insertion and deletion rates and clips of local alignments, with
``--output-dir``'s ``seqs.fasta``, ``refs.fasta`` and ``summ.txt``.

The model loads in f32 (``half=False``), as bonito_tpu's does, and runs
in f32 on the card: an LSTM-CRF model through the f32 instances of
kernels A and F and the full-score decode (M, Q), the transformer family
through K's and the decode's f32 instances, the conv-CTC family on cuDNN
and the host decoders. cuDNN may run f32 convolutions in TF32 where
``torch.backends.cudnn.allow_tf32`` is set.
"""

import csv
import inspect
import sys
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from pathlib import Path

import numpy as np

from bonito_tpu_torch import resolve_device
from bonito_tpu_torch.alignment import smith_waterman
from bonito_tpu_torch.data import (
    ComputeSettings, DataSettings, ModelSetup, load_data)
from bonito_tpu_torch.util import (
    decode_ref, init, load_model, parasail_style_cigar_counts)


def align_stats(ref, seq, min_coverage=0.0):
    """Alignment statistics of one chunk's call against its reference; the
    accuracy is 0 where the local alignment covers less than
    ``min_coverage`` of the reference (the other counts are kept)."""
    stats = {
        "accuracy": 0.0, "num_correct": 0, "num_mismatches": 0,
        "num_insertions": 0, "num_deletions": 0,
        "seq_len": len(seq), "ref_len": len(ref),
        "align_seq_start": 0, "align_seq_end": -1,
        "align_ref_start": 0, "align_ref_end": -1,
    }
    if not seq or not ref:
        return stats
    result = smith_waterman(seq, ref)
    if result is None:
        return stats
    counts = parasail_style_cigar_counts(result.cigar)
    correct = counts.get("=", 0)
    total = sum(counts.values())
    r_coverage = (result.end_ref - result.beg_ref) / len(ref)
    accuracy = correct / total if total else 0.0
    if r_coverage < min_coverage:
        accuracy = 0.0
    stats.update({
        "accuracy": accuracy,
        "num_correct": correct,
        "num_mismatches": counts.get("X", 0),
        "num_insertions": counts.get("I", 0),
        "num_deletions": counts.get("D", 0),
        "align_seq_start": result.beg_query,
        "align_seq_end": result.end_query - 1,
        "align_ref_start": result.beg_ref,
        "align_ref_end": result.end_ref - 1,
    })
    return stats


def main(args):
    import torch

    device = resolve_device(args.device)
    init(args.seed)

    print("* loading model", args.model_directory)
    model = load_model(args.model_directory, weights=args.weights,
                       half=False, device=device)

    standardisation = (
        model.config.get("standardisation", {}) if args.standardise else {})
    setup = ModelSetup(
        n_pre_context_bases=getattr(model, "n_pre_context_bases", 0),
        n_post_context_bases=getattr(model, "n_post_context_bases", 0),
        standardisation=standardisation,
    )
    mean = standardisation.get("mean", 0.0)
    stdev = standardisation.get("stdev", 1.0)
    print(f"* * applying standardisation params: mean={mean}, stdev={stdev}")

    print("* loading data")
    compute = ComputeSettings(batch_size=args.batchsize, seed=args.seed)
    if args.dataset == "valid":
        # with no validation/ subdirectory the valid split is carved out of
        # the train chunks: offer enough of them
        has_valid_dir = (Path(args.directory) / "validation").exists()
        n_train = args.chunks if has_valid_dir else args.chunks * 100
        data = DataSettings(str(args.directory), n_train, args.chunks, None)
        _, loader = load_data(data, setup, compute)
    else:
        data = DataSettings(str(args.directory), args.chunks, 0, None)
        loader, _ = load_data(data, setup, compute)
    if hasattr(loader, "drop_last"):
        loader.drop_last = False  # every chunk, the last partial batch too

    print("* calling")
    t0 = time.perf_counter()
    n_chunks = n_samples = 0
    seqs, refs = [], []
    # plugin loaders standardise their chunks themselves (ModelSetup)
    plugin_loader = not hasattr(loader, "dataset")
    takes_beamsize = "beamsize" in inspect.signature(
        model.decode_batch).parameters
    for data, targets, lengths in loader:
        data = np.asarray(data, np.float32)
        if standardisation and not plugin_loader:
            data = (data - mean) / stdev
        n_real = len(data)
        n_chunks += n_real
        n_samples += data.shape[0] * data.shape[1]
        if n_real < args.batchsize:
            # the device step keeps one shape: zero rows, sliced off below
            data = np.concatenate([data, np.zeros(
                (args.batchsize - n_real, *data.shape[1:]), data.dtype)])
        x = torch.from_numpy(np.ascontiguousarray(data))
        if x.ndim == 2:
            x = x[..., None]
        with torch.inference_mode():
            scores = model(x.to(device))
            batch_seqs = (model.decode_batch(scores, beamsize=args.beamsize)
                          if takes_beamsize else model.decode_batch(scores))
        seqs.extend(batch_seqs[:n_real])
        refs.extend(decode_ref(t[:n], model.alphabet)
                    for t, n in zip(targets, lengths))
    duration = time.perf_counter() - t0

    print("* aligning")
    rows = [align_stats(ref, seq, min_coverage=args.min_coverage)
            for ref, seq in zip(refs, seqs)]
    if not rows:
        print("* error: no chunks evaluated (empty dataset/split?)",
              file=sys.stderr)
        sys.exit(1)

    def mean_of(key):
        return float(np.mean([r[key] for r in rows]))

    def rate(num):
        vals = [r[num] / r["num_correct"] for r in rows if r["num_correct"]]
        return float(np.mean(vals)) if vals else 0.0

    seq_rclip = float(np.mean([r["seq_len"] - r["align_seq_end"] - 1
                               for r in rows]))
    ref_rclip = float(np.mean([r["ref_len"] - r["align_ref_end"] - 1
                               for r in rows]))
    print(f"""
* num_chunks      {len(rows)}
* accuracy        {mean_of('accuracy'):.2%}
* sub-rate        {rate('num_mismatches'):.2%}
* ins-rate        {rate('num_insertions'):.2%}
* del-rate        {rate('num_deletions'):.2%}
* seq_len         {mean_of('seq_len'):.1f}
* seq_lclip       {mean_of('align_seq_start'):.1f}
* seq_rclip       {seq_rclip:.1f}
* ref_len         {mean_of('ref_len'):.1f}
* ref_lclip       {mean_of('align_ref_start'):.1f}
* ref_rclip       {ref_rclip:.1f}
* time            {duration:.2f}
* samples/s       {n_samples / duration:.2E}
""")

    if args.output_dir:
        out = Path(args.output_dir)
        out.mkdir(exist_ok=True, parents=True)
        with (out / "seqs.fasta").open("w") as fh:
            fh.write("".join(f">chunk_{i}\n{s}\n" for i, s in enumerate(seqs)))
        with (out / "refs.fasta").open("w") as fh:
            fh.write("".join(f">chunk_{i}\n{s}\n" for i, s in enumerate(refs)))
        with (out / "summ.txt").open("w", newline="") as fh:
            w = csv.DictWriter(fh, fieldnames=list(rows[0]), delimiter="\t")
            w.writeheader()
            w.writerows(rows)


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("model_directory")
    parser.add_argument("--directory", required=True)
    parser.add_argument("--output-dir", "--output_dir", dest="output_dir",
                        default=None)
    parser.add_argument("--dataset", choices=["train", "valid"],
                        default="valid")
    parser.add_argument("--device", default=None,
                        help="torch device; the card when not given "
                             "(cpu: the plain versions)")
    parser.add_argument("--standardise", action="store_true", default=False)
    parser.add_argument("--seed", default=9, type=int)
    parser.add_argument("--weights", default=None, type=str)
    parser.add_argument("--chunks", default=512, type=int)
    parser.add_argument("--batchsize", default=256, type=int)
    parser.add_argument("--beamsize", default=5, type=int)
    parser.add_argument("--min-coverage", default=0.5, type=float)
    return parser
