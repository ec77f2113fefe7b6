"""
CRF decoding: the exact Viterbi (MAP) path with per-base qualities from
the true posterior of the emitted base, calibrated by the model's qscore
scale/bias. Output per frame, [N, T] uint8 each:

    sequence   0 where no base is emitted, else the base id 1..n_base
    qstring    phred+33 for emitting frames, 0 elsewhere
    moves      1 where a base is emitted

Two passes. The forward carries alpha in probability space (renormalised
by its max each frame, with a log correction) beside the max-semiring
alpha and its argmax choices; the backward carries beta and the
traceback state and emits each frame. The TCN routes build nothing of
[N, T, n_score].

Three routes lead here from a model. ``viterbi_decode_tcn`` reads the
move scores the head matmul wrote, in the model dtype (kernels B and C).
``viterbi_decode_head`` reads the encoder output and the head's weights
and takes the move scores in f32 (kernels G and J inside the decode; GW's
head product once for both passes at 512 and 1024 states);
``use_fused_head`` says where it is the default. Rounding the moves to
bf16 or not changes near-ties, so the two routes decode a bf16 model
differently and the choice is part of the result. ``viterbi_decode``
reads full score tensors with a stay plane (kernels M and Q): the reverse
strand's, whose stays are no longer one constant (read from the forward
strand's scores in place), and a head's without a fixed blank. The beam
decoder over full scores is ``ops.beam_device.beam_search_device``.
"""

import numpy as np
import torch

from bonito_tpu_torch.ops.decode_cuda import NB, tcn_backward, tcn_forward
from bonito_tpu_torch.ops.decode_full_cuda import full_backward, full_forward
from bonito_tpu_torch.ops.decode_fused_cuda import (
    head_moves_plain, move_buffer, tcn_fused_backward, tcn_fused_forward)


def _check(seqdist, Cm):
    S = seqdist.n_states
    if seqdist.n_base != NB or Cm != S * NB:
        raise ValueError(f"the decode needs n_base {NB} and {S * NB} move "
                         f"columns, got n_base {seqdist.n_base}, {Cm}")


def viterbi_decode_tcn(seqdist, moves_tcn, blank_score, qscale=1.0,
                       qbias=0.0):
    """moves_tcn [T, S*nb, N]: move scores with rows in (b, j, r) order
    (``Model.forward_tcn``), stay = the constant ``blank_score``. Same
    contract as bonito_tpu's ``viterbi_decode_tcn``.

    The kernels read the frame-major [N, T, S*nb] memory that the head
    matmul writes; ``Model.forward_tcn`` returns [T, S*nb, N] as a
    permuted view of it, so the permute back is free. Any other [T, Cm, N]
    tensor is copied into that layout first."""
    T, Cm, N = moves_tcn.shape
    _check(seqdist, Cm)
    moves = moves_tcn.permute(2, 0, 1).contiguous()
    blank = float(blank_score)
    fwd = tcn_forward(moves, blank)
    return tcn_backward(moves, *fwd, blank, qscale=qscale, qbias=qbias)


def use_fused_head(seqdist):
    """Whether the fused-head decode is a model's default route: for the
    small state spaces (fast, S = 64), as in bonito_tpu, so that a model
    decodes alike in both packages."""
    return seqdist.n_states <= 128


def tcn_from_head(head):
    """The [T, S*nb, N] move tensor of a head (``forward_tcn_head``) in
    f32, as the fused-head route takes it (``head_moves_plain``), in the
    layout of ``viterbi_decode_tcn``'s input."""
    return head_moves_plain(head).permute(1, 2, 0)


def viterbi_decode_head(seqdist, head, qscale=1.0, qbias=0.0):
    """Decode from ``SeqdistModel.forward_tcn_head``'s split. Same
    contract as bonito_tpu's ``viterbi_decode_head``. The move scores are
    taken once and kept between the passes in an f32 [N, T, 4S] tensor
    (``move_buffer``: on the CPU, and on the card at 512 and 1024 states,
    where GW's head product writes it and JW reads it: 2.44 GiB at hac's
    batch, 3.91 at sup's); kernels G and J compute them inside each pass
    and build no tensor."""
    _check(seqdist, head.wT.shape[1])
    moves = move_buffer(head)
    fwd = tcn_fused_forward(head, moves_out=moves)
    return tcn_fused_backward(head, *fwd, qscale=qscale, qbias=qbias,
                              moves=moves)


def viterbi_decode(seqdist, scores, qscale=1.0, qbias=0.0, reverse=False):
    """Full scores [N, T, S*(nb+1)] (slot 0 of each state the stay) -> the
    decode dict. Same contract as bonito_tpu's ``viterbi_decode``: kernels
    M and Q on the card, their plain versions (bonito_tpu's
    ``viterbi_decode_scan`` in plain torch) for a CPU tensor. The rows are
    independent, so the whole batch goes in one launch of each. The kernels
    read the scores in place: a strided CUDA tensor raises.

    ``reverse``: the decode of the reverse strand,
    ``viterbi_decode(seqdist, seqdist.reverse_complement(scores))``, with
    the kernels reading ``scores`` in reverse-complement order in place
    (no copy)."""
    N, T, C = scores.shape
    _check(seqdist, C - seqdist.n_states)
    fwd = full_forward(scores, reverse=reverse)
    return full_backward(scores, *fwd, qscale=qscale, qbias=qbias,
                         reverse=reverse)


def tcn_permutation(seqdist):
    """Head column of each TCN row: row (b*nb + j)*R + r takes column
    (r*nb + b)*nb + j of the head's move scores."""
    nb = seqdist.n_base
    R = seqdist.n_states // nb
    b_, j_, r_ = np.unravel_index(np.arange(nb * nb * R), (nb, nb, R))
    return (r_ * nb + b_) * nb + j_


def tcn_to_scores(seqdist, moves_tcn, blank_score):
    """Full [N, T, S*(nb+1)] scores from the TCN move tensor [T, Cm, N]
    (the inverse of ``Model.forward_tcn``'s head permutation)."""
    nb = seqdist.n_base
    S = seqdist.n_states
    T, Cm, N = moves_tcn.shape
    inv = np.empty(Cm, np.int64)
    inv[tcn_permutation(seqdist)] = np.arange(Cm)
    mv = moves_tcn.permute(2, 0, 1)[:, :, torch.as_tensor(inv)]
    mv = mv.reshape(N, T, S, nb)
    blanks = torch.full((N, T, S, 1), float(blank_score), dtype=mv.dtype,
                        device=mv.device)
    return torch.cat([blanks, mv], dim=3).reshape(N, T, S * (nb + 1))


def to_str(frame_codes, alphabet="NACGT", qstring=False):
    """Per-frame uint8 codes -> string, dropping zero (non-emitting)
    frames. Sequence codes index ``alphabet``; qstring codes are already
    phred+33 bytes."""
    arr = np.asarray(frame_codes)
    arr = arr[arr != 0]
    if qstring:
        return arr.tobytes().decode("ascii")
    lut = np.frombuffer(alphabet.encode(), dtype=np.uint8)
    return lut[arr].tobytes().decode("ascii")
