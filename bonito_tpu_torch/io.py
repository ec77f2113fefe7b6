"""
Output layer of the port, bonito_tpu's (``bonito_tpu/io.py``) copied: the
SAM/BAM/CRAM/fastq writers and the read summary of the basecaller, the
duplex consensus writer, the CTC training-data writer of ``--save-ctc``,
and the training logs (``CSVLogger``). BAM is ``bonito_tpu_torch.bam``'s,
CRAM ``bonito_tpu_torch.cram``'s. The format follows the name stdout is
redirected to, as in upstream bonito (bonito/io.py:35-54).
"""

import csv
import os
import sys
from collections import defaultdict, namedtuple
from pathlib import Path
from threading import Thread

import numpy as np

from bonito_tpu_torch.bam import ArrayTag, BAMWriter
from bonito_tpu_torch.util import mean_qscore_from_qstring, revcomp

__ont_bam_spec__ = "0.0.2"

Format = namedtuple("Format", "aligned name mode")


def _stdout_target():
    """(path, is_tty_or_pipe): ONE redirect-detection idiom for biofmt
    and summary_file — the realpath('/dev/fd/1') + isatty + '/proc'
    heuristic must stay in lockstep between them."""
    stdout = os.path.realpath("/dev/fd/1")
    return stdout, (sys.stdout.isatty() or stdout.startswith("/proc"))


def biofmt(aligned=False):
    """Pick the output format from how stdout is redirected
    (same rules as the reference: bonito/io.py:35-54)."""
    mode, name = ("w", "sam") if aligned else ("wfq", "fastq")
    aligned = "aligned" if aligned else "unaligned"
    stdout, interactive = _stdout_target()
    if interactive:
        return Format(aligned, name, mode)
    ext = stdout.split(os.extsep)[-1]
    if ext in ("fq", "fastq"):
        return Format(aligned, "fastq", "wfq")
    if ext == "bam":
        return Format(aligned, "bam", "wb")
    if ext == "cram":
        return Format(aligned, "cram", "wc")
    if ext == "sam":
        return Format(aligned, "sam", "w")
    return Format(aligned, name, mode)


def summary_file():
    """summary.tsv filename derived from the stdout target
    (reference: bonito/io.py:169-177)."""
    stdout, interactive = _stdout_target()
    if interactive:
        return "summary.tsv"
    return "%s_summary.tsv" % os.path.splitext(stdout)[0]


def encode_moves(moves, stride, sep=","):
    """Stride-prefixed comma string for the mv:B:c tag
    (semantics of reference bonito/io.py:57-70)."""
    moves = np.asarray(moves, dtype=np.uint8)
    separators = np.full(2 * moves.size, ord(sep), dtype=np.dtype("B"))
    separators[1::2] = moves + ord("0")
    return f"{stride}{separators.tobytes().decode('ascii')}"


def typical_indices(x, n=2.5):
    """Indices within n sigma of the mean (for CTC chunk outlier filtering)."""
    x = np.asarray(x)
    mu, sd = np.mean(x), np.std(x)
    return np.where((mu - n * sd < x) & (x < mu + n * sd))[0]


# ---------------------------------------------------------------------------
# SAM primitives
# ---------------------------------------------------------------------------

def sam_header(groups=None, sq=None, margs=None):
    """@HD/@SQ/@RG/@PG lines (reference: bonito/io.py:108-132)."""
    from bonito_tpu_torch import __version__
    HD = "@HD\tVN:1.5\tSO:unknown\tob:%s" % __ont_bam_spec__
    PG = "\t".join([
        "@PG", "ID:basecaller", "PN:bonito_tpu_torch",
        "VN:%s" % __version__,
        "CL:bonito_tpu_torch %s" % " ".join(
            margs if margs is not None else sys.argv[1:]),
    ])
    lines = [HD, PG]
    for name, length in (sq or []):
        lines.append(f"@SQ\tSN:{name}\tLN:{length}")
    for rg in (groups or []):
        lines.append(rg)
    return "\n".join(lines) + "\n"


def _cigar_and_clips(mapping, seqlen):
    """Soft-clip-padded cigar string for an aligned segment."""
    clip_l = mapping.q_st
    clip_r = seqlen - mapping.q_en
    cigar = mapping.cigar_str
    left = f"{clip_l}S" if clip_l else ""
    right = f"{clip_r}S" if clip_r else ""
    if mapping.strand == -1:
        left, right = (f"{clip_r}S" if clip_r else ""), (f"{clip_l}S" if clip_l else "")
    return left + cigar + right


def sam_record(read_id, sequence, qstring, mapping=None, tags=None):
    """One SAM line (fields per reference bonito/io.py:135-166)."""
    tags = list(tags or [])
    if mapping is None:
        fields = [read_id, "4", "*", "0", "0", "*", "*", "0", "0",
                  sequence, qstring]
    else:
        flag = 16 if mapping.strand == -1 else 0
        seq, qs = sequence, qstring
        if mapping.strand == -1:
            seq, qs = revcomp(sequence), qstring[::-1]
        fields = [
            read_id, str(flag), mapping.ctg, str(mapping.r_st + 1),
            str(mapping.mapq), _cigar_and_clips(mapping, len(sequence)),
            "*", "0", "0", seq, qs,
        ]
        if getattr(mapping, "NM", None) is not None:
            tags.append(f"NM:i:{mapping.NM}")
        if getattr(mapping, "MD", None):
            tags.append(f"MD:Z:{mapping.MD}")
    return "\t".join(fields + [str(t) for t in tags])


# ---------------------------------------------------------------------------
# summary.tsv
# ---------------------------------------------------------------------------

def summary_field_names(aligned=False):
    fields = [
        "filename", "read_id", "run_id", "channel", "mux", "start_time",
        "duration", "template_start", "template_duration",
        "sequence_length_template", "mean_qscore_template",
    ]
    if aligned:
        fields += [
            "alignment_genome", "alignment_genome_start", "alignment_genome_end",
            "alignment_strand_start", "alignment_strand_end",
            "alignment_direction", "alignment_length", "alignment_num_aligned",
            "alignment_num_correct", "alignment_num_insertions",
            "alignment_num_deletions", "alignment_num_substitutions",
            "alignment_mapq", "alignment_strand_coverage", "alignment_identity",
            "alignment_accuracy",
        ]
    return fields


def summary_row(read, seqlen, qscore, alignment=False):
    """One summary.tsv row (reference field semantics: bonito/io.py:179-258)."""
    sample_rate = getattr(read, "sample_rate", 0) or 1
    start = getattr(read, "start", 0) or 0
    duration = (getattr(read, "num_samples", 0) or 0) / sample_rate
    ts = (getattr(read, "trimmed_samples", 0) or 0) / sample_rate
    row = {
        "filename": getattr(read, "filename", ""),
        "read_id": read.read_id,
        "run_id": getattr(read, "run_id", ""),
        "channel": getattr(read, "channel", 0),
        "mux": getattr(read, "mux", 0),
        "start_time": start,
        "duration": duration,
        "template_start": start + ts,
        "template_duration": duration - ts,
        "sequence_length_template": seqlen,
        "mean_qscore_template": qscore,
    }
    if alignment:
        ins = alignment.cigar_counts.get("I", 0)
        dels = alignment.cigar_counts.get("D", 0)
        # the in-repo aligner emits =/X cigars (aligner.py:33): aligned
        # columns are '=' + 'X' (+ any 'M' from other producers) — an
        # M-only formula dropped X columns and understated every stat
        eqs = alignment.cigar_counts.get("=", 0)
        xs = alignment.cigar_counts.get("X", 0)
        matches = alignment.cigar_counts.get("M", 0) + eqs + xs
        # clamp like CTCWriter: a duck-typed mapping without NM (the
        # getattr default) plus I/D ops would go negative and report
        # identity > 1
        subs = max(getattr(alignment, "NM", 0) - ins - dels, 0)
        correct = matches - subs
        length = matches + ins + dels
        # strand coordinates in sequencing direction (reference
        # bonito/io.py:242-243 flips q_st/q_en for minus strand)
        if alignment.strand == -1:
            strand_st = seqlen - alignment.q_en
            strand_en = seqlen - alignment.q_st
        else:
            strand_st, strand_en = alignment.q_st, alignment.q_en
        row.update({
            "alignment_genome": alignment.ctg,
            "alignment_genome_start": alignment.r_st,
            "alignment_genome_end": alignment.r_en,
            "alignment_strand_start": strand_st,
            "alignment_strand_end": strand_en,
            "alignment_direction": "-" if alignment.strand == -1 else "+",
            "alignment_length": length,
            "alignment_num_aligned": matches,
            "alignment_num_correct": correct,
            "alignment_num_insertions": ins,
            "alignment_num_deletions": dels,
            "alignment_num_substitutions": subs,
            "alignment_mapq": alignment.mapq,
            "alignment_strand_coverage": (alignment.q_en - alignment.q_st) / max(seqlen, 1),
            "alignment_identity": correct / max(matches, 1),
            "alignment_accuracy": correct / max(length, 1),
        })
    elif alignment is None:
        row.update({
            "alignment_genome": "*", "alignment_genome_start": -1,
            "alignment_genome_end": -1, "alignment_strand_start": -1,
            "alignment_strand_end": -1, "alignment_direction": "*",
            "alignment_length": 0, "alignment_num_aligned": 0,
            "alignment_num_correct": 0, "alignment_num_insertions": 0,
            "alignment_num_deletions": 0, "alignment_num_substitutions": 0,
            "alignment_mapq": 0, "alignment_strand_coverage": 0.0,
            "alignment_identity": 0.0, "alignment_accuracy": 0.0,
        })
    return row


def duplex_summary_row(read_temp, read_comp, seqlen, qscore, alignment=False):
    """summary.tsv row for a duplex pair: upstream bonito's exact column
    set (bonito/io.py:261-340), so that downstream tooling parses it."""
    row = {
        "filename_template": getattr(read_temp, "filename", ""),
        "read_id_template": read_temp.read_id,
        "filename_complement": getattr(read_comp, "filename", ""),
        "read_id_complement": read_comp.read_id,
        "run_id": getattr(read_temp, "run_id", ""),
        "channel_template": getattr(read_temp, "channel", 0),
        "mux_template": getattr(read_temp, "mux", 0),
        "channel_complement": getattr(read_comp, "channel", 0),
        "mux_complement": getattr(read_comp, "mux", 0),
        "sequence_length_duplex": seqlen,
        "mean_qscore_duplex": qscore,
    }
    aligned_part = summary_row(read_temp, seqlen, qscore, alignment=alignment)
    for key in summary_field_names(aligned=True)[11:]:
        if key in aligned_part:
            row[key] = aligned_part[key]
    return row


class CSVLogger:
    """Append-only CSV sink for per-step/per-epoch metrics (the training
    logs ``losses_N.csv`` and ``training.csv``).

    The column set is fixed by the first row appended — or, when resuming
    into an existing file, by its header line — and later rows are
    projected onto it, "-" filling any missing field. Writes are flushed
    in batches so per-step logging stays cheap."""

    FLUSH_EVERY = 100

    def __init__(self, filename, sep=","):
        self.filename = str(filename)
        self.sep = sep
        self.columns = self._existing_header()
        self.fh = open(self.filename, "a", newline="")
        self._unflushed = 0

    def _existing_header(self):
        if not os.path.exists(self.filename):
            return None
        with open(self.filename, newline="") as f:
            header = next(csv.reader(f, delimiter=self.sep), None)
        return header or None

    def _write_fields(self, fields):
        csv.writer(self.fh, delimiter=self.sep).writerow(fields)

    def set_columns(self, columns):
        if self.columns:
            raise Exception("columns already set")
        self.columns = list(columns)
        self._write_fields(self.columns)

    def append(self, row):
        if self.columns is None:
            self.set_columns(row.keys())
        self._write_fields([row.get(name, "-") for name in self.columns])
        self._unflushed += 1
        if self._unflushed > self.FLUSH_EVERY:
            self.fh.flush()
            self._unflushed = 0

    def close(self):
        self.fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()


def write_fastq(read_id, sequence, qstring, fd=sys.stdout, tags=None):
    comment = " ".join(str(t) for t in tags) if tags else ""
    fd.write(f"@{read_id} {comment}\n{sequence}\n+\n{qstring}\n")


class NullWriter(Thread):
    """Consumes results without writing (``--no-output``)."""

    def __init__(self, mode, iterator, **kwargs):
        super().__init__()
        self.log = []
        self.iterator = iterator
        self._exc = None

    def run(self):
        # same invariant as Writer.run: a crash in the consuming thread
        # must re-raise from stop(), not leave the CLI exiting 0 after
        # a failed partial run
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — re-raised in stop()
            self._exc = e

    def _run(self):
        for read, res in self.iterator:
            self.log.append((read.read_id, len(read.signal)))

    def stop(self):
        self.join()
        if self._exc is not None:
            raise self._exc


class RejectCounter(defaultdict):
    """Count reads rejected by reason; dict of reason -> count."""

    def __init__(self):
        super().__init__(int)

    def __call__(self, condition, reason):
        if condition:
            self[reason] += 1
        return condition


class Writer(Thread):
    """
    Output writer thread: pulls (read, result) items, applies the min-qscore
    filter, emits SAM/BAM/CRAM/fastq + summary rows (reference:
    bonito/io.py:400-469).
    """

    def __init__(self, mode, iterator, aligner=None, fd=None, groups=None,
                 group_key=None, min_qscore=0, output_dir=None):
        super().__init__()
        self.mode = mode
        self.fastq = mode == "wfq"
        self.fd = fd if fd is not None else (
            sys.stdout.buffer if mode in ("wb", "wc") else sys.stdout)
        self.log = []
        self.aligner = aligner
        self.iterator = iterator
        self.group_key = group_key
        self.min_qscore = min_qscore
        self.rejected = RejectCounter()
        self.output_dir = output_dir
        self._bam = None
        self._summary = None
        self._exc = None

        # duck-typed: an aligner-like object without the index gives no @SQ
        names_lengths = getattr(aligner, "seq_names_lengths", None)
        sq = names_lengths() if callable(names_lengths) else []
        header_text = sam_header(groups=groups, sq=sq)
        if mode == "wb":
            self._bam = BAMWriter(self.fd, header_text, sq)
        elif mode == "wc":
            from bonito_tpu_torch.cram import CramWriter
            # with an aligner the mappings carry their reference span:
            # reference-based CRAM (RR=true, implicit match stretches and
            # substitution codes, what htslib writes when given a fasta),
            # which decodes with the same fasta; else referenceless
            self._bam = CramWriter(self.fd, header_text, sq,
                                   reference_based=aligner is not None)
        elif mode == "w":
            self.fd.write(header_text)

    def _summary_logger(self):
        if self._summary is None:
            name = summary_file()
            if self.output_dir:
                name = Path(self.output_dir) / Path(name).name
            self._summary = CSVLogger(name, sep="\t")
        return self._summary

    def write(self, read, seq, qstring, mapping, tags):
        if self.fastq:
            write_fastq(read.read_id, seq, qstring, fd=self.fd, tags=tags)
        elif self.mode in ("wb", "wc"):
            self._bam.write(read.read_id, seq, qstring, mapping=mapping,
                            tags=tags)
        else:
            self.fd.write(sam_record(read.read_id, seq, qstring,
                                     mapping=mapping, tags=tags) + "\n")

    def run(self):
        # writers run as daemon-ish threads off the CLI's main loop; a
        # crash here must not vanish (it would silently truncate output)
        # — capture and re-raise from stop(), which every CLI calls.
        try:
            self._run()
        except BaseException as e:  # noqa: BLE001 — re-raised in stop()
            self._exc = e

    def _run(self):
        for read, res in self.iterator:
            seq = res["sequence"]
            qstring = res.get("qstring", "*")
            mean_q = res.get("mean_qscore")
            if mean_q is None:  # .get default would eagerly scan the qstring
                mean_q = mean_qscore_from_qstring(qstring)
            mapping = res.get("mapping", None)

            self.log.append((read.read_id, len(read.signal)))
            if self.rejected(len(seq) == 0, "zero length"):
                continue
            if self.rejected(mean_q < self.min_qscore,
                             f"qscore < {self.min_qscore}"):
                continue

            tags = [
                f"RG:Z:{read.run_id}_{self.group_key}" if self.group_key
                else f"RG:Z:{read.run_id}",
                f"qs:i:{round(mean_q)}",
                f"ns:i:{getattr(read, 'num_samples', 0)}",
                f"ts:i:{getattr(read, 'trimmed_samples', 0)}",
                *(read.tagdata() if hasattr(read, "tagdata") else []),
            ]
            if res.get("moves") is not None and not self.fastq:
                moves = np.asarray(res["moves"], dtype=np.int8)
                tags.append(ArrayTag("mv", "c", np.concatenate(
                    [np.int8([res["stride"]]), moves])))
            self.write(read, seq, qstring, mapping, tags)
            self._summary_logger().append(
                summary_row(read, len(seq), mean_q,
                            alignment=mapping if self.aligner else False))

        if self._bam is not None:
            self._bam.close()
        if self._summary is not None:
            self._summary.close()

    def stop(self):
        self.join()
        if self._exc is not None:
            raise self._exc
        return self.rejected


class DuplexWriter(Writer):
    """Writer for duplex consensus pairs (read ids 'tmpl;compl')."""

    def _run(self):
        for (read_pair, res) in self.iterator:
            template, complement = read_pair
            read_id = f"{template.read_id};{complement.read_id}"
            seq = res["sequence"]
            qstring = res.get("qstring", "*")
            mean_q = res.get("mean_qscore")
            if mean_q is None:  # .get default would eagerly scan the qstring
                mean_q = mean_qscore_from_qstring(qstring)
            mapping = res.get("mapping", None)
            # log BEFORE filtering (like Writer.run and the reference)
            # so the CLI's read/base totals count processed pairs, not
            # just accepted ones
            self.log.append((read_id, len(seq)))
            if self.rejected(len(seq) == 0, "zero length"):
                continue
            if self.rejected(mean_q < self.min_qscore,
                             f"qscore < {self.min_qscore}"):
                continue

            class _Stub:
                pass
            stub = _Stub()
            stub.read_id = read_id
            stub.signal = np.empty(0)
            self.write(stub, seq, qstring, mapping, tags=[
                f"qs:f:{mean_q:.4f}"])
            self._summary_logger().append(duplex_summary_row(
                template, complement, len(seq), mean_q,
                alignment=mapping if self.aligner else False))
        if self._bam is not None:
            self._bam.close()
        if self._summary is not None:
            self._summary.close()


class CTCWriter(Writer):
    """
    Training-data writer for `basecaller --save-ctc` (reference:
    bonito/io.py:513-619): filters aligned reads by accuracy/coverage,
    accumulates (chunk, encoded-reference) pairs and writes
    chunks/references/reference_lengths.npy at the end. Accepted reads
    are ALSO written as normal records + summary rows (the reference
    emits the aligned calls alongside the npy outputs, io.py:571-577).
    """

    def __init__(self, mode, iterator, aligner, min_coverage=0.9,
                 min_accuracy=0.99, fd=None, output_dir=None, rna=False,
                 min_qscore=0, groups=None, group_key=None, **kwargs):
        super().__init__(mode, iterator, aligner=aligner, fd=fd,
                         groups=groups, group_key=group_key,
                         min_qscore=min_qscore, output_dir=output_dir)
        self.min_coverage = min_coverage
        self.min_accuracy = min_accuracy
        self.ctc_dir = Path(output_dir) if output_dir else Path(".")
        self.rna = rna

    def _run(self):
        chunks, targets, lengths = [], [], []
        base_to_int = {b: i for i, b in enumerate("NACGT")}

        for read, ctc_data in self.iterator:
            seq = ctc_data["sequence"]
            qstring = ctc_data.get("qstring", "")
            mean_q = ctc_data.get("mean_qscore")
            if mean_q is None:
                mean_q = mean_qscore_from_qstring(qstring)
            mapping = ctc_data.get("mapping", None)
            self.log.append((read.read_id, len(read.signal)))

            if self.rejected(mean_q < self.min_qscore, "low qscore"):
                continue
            if self.rejected(len(seq) == 0, "zero length"):
                continue
            if self.rejected(mapping is None, "unmapped"):
                continue
            cov = (mapping.q_en - mapping.q_st) / max(len(seq), 1)
            # aligned columns = '=' + 'X' (+ 'M'): the in-repo aligner
            # emits =/X cigars; an M-only count double-charged every
            # substitution and over-rejected chunks
            ins = mapping.cigar_counts.get("I", 0)
            dels = mapping.cigar_counts.get("D", 0)
            matches = (mapping.cigar_counts.get("M", 0)
                       + mapping.cigar_counts.get("=", 0)
                       + mapping.cigar_counts.get("X", 0))
            acc = (matches - max(mapping.NM - ins - dels, 0)) / max(
                matches + ins + dels, 1)
            if self.rejected(cov < self.min_coverage, "low coverage"):
                continue
            if self.rejected(acc < self.min_accuracy, "low accuracy"):
                continue
            refseq = mapping.ref_seq
            if mapping.strand == -1:
                # ref_seq is the forward-strand slice; the training
                # target must be in the READ's direction (the reference
                # revcomps here too, bonito/io.py:579-580) — without
                # this, minus-strand chunks trained on the wrong target
                refseq = revcomp(refseq)
            if self.rejected("N" in refseq, "N in reference"):
                continue

            target = [base_to_int[b] for b in refseq]
            if self.rna:
                target = target[::-1]
            chunks.append(np.asarray(read.signal, np.float16))
            targets.append(target)
            lengths.append(len(target))

            # accepted reads are real basecalls: emit the record +
            # summary row like the plain Writer (reference parity)
            tags = [
                f"RG:Z:{read.run_id}_{self.group_key}" if self.group_key
                else f"RG:Z:{read.run_id}",
                f"qs:i:{round(mean_q)}",
                *(read.tagdata() if hasattr(read, "tagdata") else []),
            ]
            self.write(read, seq, qstring or "*", mapping, tags)
            self._summary_logger().append(
                summary_row(read, len(seq), mean_q, alignment=mapping))

        if self._bam is not None:
            self._bam.close()
        if self._summary is not None:
            self._summary.close()
        if not chunks:
            sys.stderr.write("> no suitable ctc data to write\n")
            return

        chunks = np.stack([c for c in chunks], axis=0).astype(np.float16)
        lengths = np.asarray(lengths, np.uint16)
        L = max(len(t) for t in targets)
        tarr = np.zeros((len(targets), L), np.uint8)
        for i, t in enumerate(targets):
            tarr[i, :len(t)] = t

        # outlier-filter on target length, then shuffle
        idx = typical_indices(lengths)
        rng = np.random.default_rng(25)
        idx = rng.permutation(idx)
        chunks, tarr, lengths = chunks[idx], tarr[idx], lengths[idx]

        np.save(self.ctc_dir / "chunks.npy", chunks)
        np.save(self.ctc_dir / "references.npy", tarr)
        np.save(self.ctc_dir / "reference_lengths.npy", lengths)
        sys.stderr.write(f"> written ctc training data ({len(chunks)} chunks)\n")
