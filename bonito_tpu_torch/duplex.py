"""
Basespace duplex consensus, a copy of bonito_tpu's ``duplex.py`` for the
port.

The algorithm of upstream bonito's ``cli/duplex.py``: adjust per-base
qscores (shift, min-pool, homopolymer averaging), revcomp the complement
strand, globally align template and complement, trim unaligned ends, then
take the per-column qscore argmax as the consensus (summing the qscores
where the strands agree). The alignment is the port's native unit-cost
global aligner (``alignment.edit_align``, edlib's role upstream); the
end-repair pass upstream takes with parasail is folded into the same
global alignment.
"""

import re
from collections import namedtuple

import numpy as np

SeqRecord = namedtuple("SeqRecord", "read_id sequence qstring")

# SAM query/reference consumption per op — covers every op _CIGAR_RE
# accepts (M consumes both like =/X; H and P consume neither), so a
# cigar from any producer (not just the in-repo =X-emitting aligner)
# cannot KeyError downstream
_CIG_Q = {"=": True, "X": True, "M": True, "I": True, "S": True,
          "D": False, "N": False, "H": False, "P": False}
_CIG_R = {"=": True, "X": True, "M": True, "D": True, "N": True,
          "I": False, "S": False, "H": False, "P": False}
_CIGAR_RE = re.compile(r"(\d+)([MIDNSHP=X])")


def revcomp(seq):
    from bonito_tpu_torch.util import revcomp as _rc
    return _rc(seq)


def cigartuples_from_string(cigarstring):
    return [(m.group(2), int(m.group(1)))
            for m in _CIGAR_RE.finditer(cigarstring)]


def seq_lens(cigartuples):
    """(query_len, ref_len) consumed by a cigar."""
    q = sum(n for op, n in cigartuples if _CIG_Q[op])
    r = sum(n for op, n in cigartuples if _CIG_R[op])
    return q, r


def trim_while(cigar, from_end=False, num_match=11):
    """Drop cigar ops from one end up to (not including) the first
    anchoring run: an '=' op of length >= num_match. Returns the kept
    cigar plus how many query/ref bases the dropped ops consumed.
    (The role of the reference's end-trimming, bonito/cli/duplex.py:204-221.)
    """
    view = cigar[::-1] if from_end else list(cigar)
    anchor = next(
        (i for i, (op, n) in enumerate(view) if op == "=" and n >= num_match),
        len(view),
    )
    dropped, kept = view[:anchor], view[anchor:]
    if from_end:
        dropped, kept = dropped[::-1], kept[::-1]
    q_trim, r_trim = seq_lens(dropped)
    return kept, q_trim, r_trim


def adj_qscores(qscores, seq, qshift, pool_window=5, avg_hps_gt=2):
    """Deflate per-base qscores before consensus: shift by qshift positions
    (edge-replicated), take a centred min over pool_window, then flatten
    each homopolymer run of length >= avg_hps_gt to its mean — basecaller
    confidence is least reliable just *after* an event and inside
    homopolymers. Same arithmetic as upstream bonito's
    (bonito/cli/duplex.py:154-177)."""
    n = len(qscores)
    pos = np.arange(n)

    # shift then min-pool, both via clipped-index views (edge replication
    # and edge padding collapse to the same index clamp)
    shifted = qscores[np.clip(pos - qshift, 0, n - 1)].astype(np.float32)
    lo, hi = -(pool_window // 2), pool_window - pool_window // 2
    out = np.minimum.reduce(
        [shifted[np.clip(pos + d, 0, n - 1)] for d in range(lo, hi)])

    # homopolymer runs from run-length boundaries (no regex); flatten each
    # long run to its mean in one reduceat/scatter round
    bases = np.frombuffer(seq.encode("ascii"), np.uint8)
    if len(bases) > 1:
        edges = np.flatnonzero(bases[1:] != bases[:-1]) + 1
        starts = np.concatenate([[0], edges])
        lens = np.diff(np.concatenate([starts, [len(bases)]]))
        means = np.add.reduceat(out, starts) / lens
        run_of = np.repeat(np.arange(len(starts)), lens)
        flatten = (lens >= avg_hps_gt)[run_of]
        out[flatten] = means[run_of][flatten]
    return out


def compute_consensus(cigar, temp_seq, temp_qscores, comp_seq, comp_qscores):
    """Per-column consensus of an aligned template/complement pair: each
    alignment column takes the base of whichever strand is more confident
    there, summing the two qscores where the strands agree. A strand that
    doesn't consume a base at a column (gap) competes with the qscore of
    its most recent base. Same column arithmetic as upstream bonito's
    (bonito/cli/duplex.py:109-151)."""
    GAP = np.uint8(ord("-"))

    # one row per alignment column: which strands consume a base there
    op_flags = np.array([(_CIG_Q[op], _CIG_R[op]) for op, _ in cigar], bool)
    counts = [n for _, n in cigar]
    uses_t, uses_c = np.repeat(op_flags, counts, axis=0).T

    def column_view(seq, uses):
        col = np.full(len(uses), GAP)
        col[uses] = np.frombuffer(seq.encode("ascii"), np.uint8)
        return col

    def column_q(qscores, uses):
        last_base = np.maximum(np.cumsum(uses) - 1, 0)
        return qscores[last_base]

    tb, cb = column_view(temp_seq, uses_t), column_view(comp_seq, uses_c)
    tq, cq = column_q(temp_qscores, uses_t), column_q(comp_qscores, uses_c)

    from_comp = cq > tq
    agree = tb == cb
    base = np.where(from_comp, cb, tb)
    q = np.where(agree, tq + cq, np.where(from_comp, cq, tq))

    emit = base != GAP
    seq = base[emit].tobytes().decode()
    qstring = np.round(np.clip(q[emit], 0, 60) + 33).astype(
        np.uint8).tobytes().decode()
    return seq, qstring


def duplex_align(temp_seq, comp_seq):
    """Global =/X/I/D cigar between the two strands (native aligner)."""
    from bonito_tpu_torch.alignment import edit_align
    res = edit_align(temp_seq, comp_seq)
    if res is None:
        return []
    _, cigar_str = res
    return cigartuples_from_string(cigar_str)


def call_basespace_duplex(template: SeqRecord, complement: SeqRecord):
    """Consensus of a template/complement pair; qstrings are phred+33.
    Returns a result dict for DuplexWriter."""
    temp_seq = template.sequence
    comp_seq = complement.sequence
    temp_q = np.frombuffer(
        template.qstring.encode(), np.uint8).astype(np.float32) - 33
    comp_q = np.frombuffer(
        complement.qstring.encode(), np.uint8).astype(np.float32) - 33

    temp_q = adj_qscores(temp_q, temp_seq, qshift=1)
    comp_q = adj_qscores(comp_q, comp_seq, qshift=-1)

    comp_seq = revcomp(comp_seq)
    comp_q = comp_q[::-1]

    cigar = duplex_align(temp_seq, comp_seq)
    cigar, temp_st, comp_st = trim_while(cigar)
    cigar, temp_en, comp_en = trim_while(cigar, from_end=True)
    if not cigar:
        return {"sequence": "", "qstring": ""}

    seq, qstring = compute_consensus(
        cigar,
        temp_seq[temp_st:len(temp_seq) - temp_en],
        temp_q[temp_st:len(temp_q) - temp_en],
        comp_seq[comp_st:len(comp_seq) - comp_en],
        comp_q[comp_st:len(comp_q) - comp_en],
    )
    return {"sequence": seq, "qstring": qstring}
