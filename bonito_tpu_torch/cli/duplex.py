"""
``python -m bonito_tpu_torch duplex``: bonito_tpu's duplex CLI
(``bonito_tpu/cli/duplex.py``) in the port: the basespace duplex consensus
of template/complement pairs from a basecalled BAM, SAM or CRAM and a
pairs file, written as SAM, BAM, CRAM or fastq (the stdout redirect's
name picks it) with its summary. It runs on the host and reaches no
kernel.

The consensus (``duplex.call_basespace_duplex``) runs over worker
processes through ``pipeline.process_map``, which spawns them: the pairs'
records are looked up here and sent to the workers, so a pair whose read
is missing or has no base qualities is skipped before any worker sees
it. ``--reference`` maps the consensus through the port's aligner; a
prebuilt minimap2 ``.mmi`` is refused, as bonito_tpu refuses it.
"""

import os
import sys
import time
from argparse import ArgumentDefaultsHelpFormatter, ArgumentParser
from datetime import timedelta

from bonito_tpu_torch.io import DuplexWriter, biofmt
from bonito_tpu_torch.pipeline import process_map
from bonito_tpu_torch.util import init


def consensus(records):
    """The consensus of a (template, complement) pair of SeqRecords; module
    level so that a spawned worker can unpickle it."""
    from bonito_tpu_torch.duplex import call_basespace_duplex
    return call_basespace_duplex(*records)


def read_pairs(path, header=True):
    """(template id, complement id) pairs of a pairs file; its first line is
    a "template complement" header unless ``header`` is False."""
    pairs = []
    with open(path) as f:
        if header:
            f.readline()
        for line in f:
            parts = line.strip().split()
            if len(parts) >= 2:
                pairs.append((parts[0], parts[1]))
    return pairs


def pair_records(bam, pairs):
    """((tid, cid), (template, complement)) for each pair whose two reads
    are in ``bam`` with base qualities: the consensus is qscore-weighted,
    so a record without them cannot take part and its pair is skipped."""
    for tid, cid in pairs:
        try:
            t, c = bam.get_record(tid), bam.get_record(cid)
        except KeyError:
            continue
        if "*" in (t.qstring, c.qstring):
            sys.stderr.write(f"> warning: pair {tid}/{cid} skipped "
                             f"(missing base qualities)\n")
            continue
        yield (tid, cid), (t, c)


class _Read:
    """What DuplexWriter reads of a strand: its id and an empty signal."""

    def __init__(self, read_id):
        self.read_id = read_id
        self.signal = b""


def main(args):
    from bonito_tpu_torch.bam_reader import ReadIndexedBam

    init(args.seed)
    fmt = biofmt(aligned=bool(args.reference))

    if args.reference and args.reference.endswith(".mmi"):
        sys.stderr.write(
            "> error: prebuilt minimap2 .mmi indexes are not supported; "
            "pass the FASTA (indexed at start-up)\n")
        sys.exit(1)
    elif args.reference and fmt.name == "fastq":
        sys.stderr.write(f"> warning: did you really want "
                         f"{fmt.aligned} {fmt.name}?\n")
    else:
        sys.stderr.write(f"> outputting {fmt.aligned} {fmt.name}\n")

    sys.stderr.write(f"> indexing {args.in_bam}\n")
    bam = ReadIndexedBam(args.in_bam)
    pairs = read_pairs(args.duplex_pairs_file, header=not args.no_header)
    sys.stderr.write(f"> {len(pairs)} pairs\n")

    t0 = time.perf_counter()

    def results():
        for (tid, cid), res in process_map(
                consensus, pair_records(bam, pairs), n_proc=args.threads):
            yield (_Read(tid), _Read(cid)), res

    aligner = None
    if args.reference:
        from bonito_tpu_torch.aligner import Aligner, align_map
        aligner = Aligner(args.reference, preset=args.mm2_preset)

    stream = results()
    if aligner:
        stream = align_map(aligner, stream, n_thread=args.alignment_threads)

    writer = DuplexWriter(fmt.mode, stream, aligner=aligner,
                          min_qscore=args.min_qscore)
    writer.start()
    writer.stop()
    duration = time.perf_counter() - t0
    num_bases = sum(n for _, n in writer.log)
    sys.stderr.write("> duplex reads: %s\n" % len(writer.log))
    sys.stderr.write("> duration: %s\n" % timedelta(seconds=round(duration)))
    if duration > 0:
        sys.stderr.write("> bases per second %.1E\n" % (num_bases / duration))


def argparser():
    parser = ArgumentParser(
        formatter_class=ArgumentDefaultsHelpFormatter, add_help=False)
    parser.add_argument("in_bam")
    parser.add_argument("duplex_pairs_file")
    parser.add_argument("--reference", default=None)
    parser.add_argument("--mm2-preset", default="lr:hq", type=str)
    parser.add_argument("--no-header", action="store_true", default=False,
                        help="the pairs file has no header line")
    parser.add_argument("--seed", default=25, type=int)
    # the consensus is host work: as many workers as cores, less one
    parser.add_argument("--threads", type=int,
                        default=max(1, min(8, (os.cpu_count() or 4) - 1)))
    parser.add_argument("--alignment-threads", default=8, type=int)
    parser.add_argument("--min-qscore", default=0, type=int)
    return parser
