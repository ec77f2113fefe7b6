"""
Kernels M and Q — the decode's forward and backward passes over full score
tensors (``csrc/decode_full.cu``) — with their plain PyTorch versions and
launch counts.

M replaces ``bonito_tpu/ops/decode_pallas.py:_fwd_kernel`` and Q
``_bwd_kernel`` plus the qscore epilogue of ``viterbi_decode_pallas``. The
scores are [N, T, S*(nb+1)] as the CRF head writes them, bf16 or f32: for
state s, column s*(nb+1) is the stay and s*(nb+1)+1+j the move from
predecessor j*R + s//nb. The kernels read that memory as it lies; the
stay is a plane of its own, not the TCN route's constant blank. Both are
bound by bytes on an H100 and latency-bound by design (the recursion over
T is serial). On the card they run the ring kernels of
``csrc/decode_ring.cuh`` (B's and C's design: one CTA per batch row, four
states a thread, the frames' rows staged ahead through a ring, one barrier
a frame) on the plan ``decode_full_plan`` gives; where it gives None the
earlier kernels (one thread per state) run.

``reverse=True`` decodes the reverse strand from the forward strand's
scores as they lie: the function of M and Q on
``seqdist.reverse_complement(scores)``, which the kernels read through an
index map (``rc_columns``) instead of a copy. Their move_in and choices
then keep the states in the forward strand's order (reverse state s in
column ``rc_states(S)[s]``), where the kernels store them in whole warps;
the backward pass takes them so.

The plain versions are the TCN decode's (``ops/decode_cuda.py``) with a
stay plane, fed through the column permutation that takes the moves into
the TCN (b, j, r) order. ``full_forward``/``full_backward`` run the plain
version for a tensor on the CPU and the kernel for a tensor on the card;
never one for the other.
"""

import numpy as np
import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.decode_cuda import (
    NB, RING, check_forward_outputs, ring_smem, tcn_backward_plain,
    tcn_forward_plain)

SMEM = 232448  # the most shared memory a block may ask for


def split_scores(scores):
    """Full scores [N, T, S*(nb+1)] -> (moves [N, T, nb*S] with the columns
    in the TCN (b, j, r) order, stay [N, T, S])."""
    N, T, C = scores.shape
    S = C // (NB + 1)
    R = S // NB
    ms = scores.reshape(N, T, S, NB + 1)
    # [N, T, r, b, j] -> (b, j, r) columns
    moves = ms[..., 1:].reshape(N, T, R, NB, NB).permute(0, 1, 3, 4, 2)
    return moves.reshape(N, T, S * NB), ms[..., 0]


def state_len(S):
    """k of S = 4**k states."""
    k = int(round(np.log(S) / np.log(NB)))
    if NB ** k != S:
        raise ValueError(f"{S} states are no power of {NB}")
    return k


def rc_digits(x, digits):
    """The reverse complement of the ``digits`` base-4 digits of x (an
    integer array): the digits in reverse order, each d taken as 3 - d, as
    ``rc_digits`` of ``csrc/crf_frames.cuh`` takes them."""
    x = np.asarray(x, np.int64)
    y = np.zeros_like(x)
    for _ in range(digits):
        y = y * NB + (NB - 1 - x % NB)
        x = x // NB
    return y


def rc_states(S):
    """[S] int64: column s of the reverse entry's move_in and choices holds
    the reverse strand's state rc_sl(s) (an involution, so also the column
    of reverse state s)."""
    return torch.from_numpy(rc_digits(np.arange(S), state_len(S)))


def rc_columns(S):
    """[5S] int64: the forward strand's column of each column of the
    reverse strand's frame, as the kernels read it (``RevFullFrame`` and
    ``FullRows<In, true>``): the stay of state s at rc_sl(s)*5, its move
    from slot j at (rc_{sl-1}(s // 4)*4 + 3 - j)*5 + 1 + 3 - s % 4."""
    sl = state_len(S)
    s = np.arange(S)
    cols = np.empty((S, NB + 1), np.int64)
    cols[:, 0] = rc_digits(s, sl) * (NB + 1)
    block = rc_digits(s // NB, sl - 1) * NB
    for j in range(NB):
        cols[:, 1 + j] = ((block + NB - 1 - j) * (NB + 1) + NB - s % NB)
    return torch.from_numpy(cols.reshape(-1))


def reverse_scores(scores):
    """The reverse strand's full scores from the forward strand's: frames
    in reverse order, columns through ``rc_columns`` (equal to
    ``seqdist.reverse_complement``, tests/test_torch_reverse.py)."""
    cols = rc_columns(scores.shape[-1] // (NB + 1)).to(scores.device)
    return scores.flip(1)[..., cols]


def full_forward_plain(scores, reverse=False):
    """The forward pass -> (move_in [N, T, S] f32, choices [N, T, S] uint8,
    c [N, T] f32, logz [N] f32, end_state [N] int32); ``reverse``: of the
    reverse strand, move_in and choices in the forward strand's order of
    states."""
    if not reverse:
        return tcn_forward_plain(*split_scores(scores))
    move_in, choices, *rest = tcn_forward_plain(
        *split_scores(reverse_scores(scores)))
    cols = rc_states(move_in.shape[-1]).to(scores.device)
    return (move_in[..., cols], choices[..., cols], *rest)


def full_backward_plain(scores, move_in, choices, cs, logz, end_state,
                        qscale=1.0, qbias=0.0, reverse=False):
    """The backward pass, traceback and emission -> {"sequence",
    "qstring", "moves"}, each [N, T] uint8; ``reverse`` as for
    ``full_forward_plain``."""
    if reverse:
        cols = rc_states(move_in.shape[-1]).to(scores.device)
        scores = reverse_scores(scores)
        move_in, choices = move_in[..., cols], choices[..., cols]
    moves, stay = split_scores(scores)
    return tcn_backward_plain(moves, move_in, choices, cs, logz, end_state,
                              stay, qscale, qbias)


def _check_cuda(scores):
    """(N, T, S) of full scores the kernels take: a contiguous bf16 or f32
    CUDA tensor, nb = 4 and S = 4**k states, 4 to 1024 (a thread each);
    raises on anything else."""
    if scores.device.type != "cuda":
        raise ValueError(f"kernels M, Q need a CUDA tensor, got "
                         f"{scores.device}")
    if scores.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernels M, Q take bf16 or f32 scores, got "
                        f"{scores.dtype}")
    if not scores.is_contiguous():
        raise ValueError("kernels M, Q take contiguous scores")
    N, T, C = scores.shape
    S = C // (NB + 1)
    if (C != S * (NB + 1) or S not in (4, 16, 64, 256, 1024) or N < 1
            or T < 1):
        raise ValueError(f"kernels M, Q: scores {tuple(scores.shape)} need "
                         f"S*(nb+1) columns with S = 4**k states, 4 to 1024, "
                         f"and N, T >= 1")
    return N, T, S


def decode_full_plan(N, T, S, dtype, sms=None):
    """The plan of kernels M and Q on the ring for scores [N, T, 5S] of
    ``dtype`` on a card of ``sms`` SMs, or None where the ring does not
    take the shape: S = 4**k from 16 to 1024 (a frame's choices, S bytes,
    are copied in 16-byte pieces). Each pass takes the deepest ring of at
    most ``RING`` frames that fits the card's shared memory: at least 2
    (Q's least) for bf16, 4 for f32; else None, and the earlier kernels
    run. One CTA per batch row: S / 4 consumer threads (rounded up to whole
    warps) with four states each, a producer warp and an epilogue warp."""
    if (N < 1 or T < 1 or S not in (16, 64, 256, 1024)
            or dtype not in (torch.bfloat16, torch.float32)):
        return None
    row = (NB + 1) * S * (4 if dtype == torch.float32 else 2)
    consumers = -(-(S // NB) // 32) * 32
    plan = {"threads": consumers + 64, "consumer_threads": consumers,
            "states_per_thread": NB, "ctas": N,
            "waves": None if sms is None else -(-N // sms)}
    for name, backward in (("fwd", False), ("bwd", True)):
        ring = RING
        while ring > 1 and ring_smem(S, ring, backward, row) > SMEM:
            ring -= 1
        if ring < (4 if dtype == torch.float32 else 2):
            return None
        plan[name] = {"ring": ring, "smem": ring_smem(S, ring, backward, row)}
    return plan


def decode_full_entry(plan, backward):
    """The C entry a plan launches: the ring's, or the earlier kernel's
    where the plan is None."""
    name = "decode_full_bwd" if backward else "decode_full_fwd"
    return name if plan is None else name + "_ring"


def _plan(counter, scores, *outputs):
    """The plan a counted launch takes (recorded in ``counter.plan``), None
    where ``counter`` is None (the comparisons' route, which counts
    nothing) or a pointer is not 16-byte aligned (the ring's bulk copies)."""
    if counter is None:
        return None
    plan = None
    if all(t.data_ptr() % 16 == 0 for t in (scores, *outputs)):
        N, T, C = scores.shape
        plan = decode_full_plan(
            N, T, C // (NB + 1), scores.dtype,
            torch.cuda.get_device_properties(scores.device)
            .multi_processor_count)
    counter.plan = plan
    counter.launches += 1
    return plan


def _forward(counter, scores, reverse):
    """M's checks and launch: the ring on ``decode_full_plan``'s plan, the
    earlier kernel where it gives None or ``counter`` is None."""
    build.refuse_grad("M", [scores], build.DECODE_ROUTE)
    N, T, S = _check_cuda(scores)
    lib = build.library()
    dev = scores.device
    move_in = torch.empty(N, T, S, device=dev)
    choices = torch.empty(N, T, S, dtype=torch.uint8, device=dev)
    cs = torch.empty(N, T, device=dev)
    logz = torch.empty(N, device=dev)
    end_state = torch.empty(N, dtype=torch.int32, device=dev)
    plan = _plan(counter, scores, move_in, choices)
    entry = decode_full_entry(plan, False)
    args = [scores.data_ptr(), int(scores.dtype == torch.float32),
            int(reverse), move_in.data_ptr(), choices.data_ptr(),
            cs.data_ptr(), logz.data_ptr(), end_state.data_ptr(), N, T, S]
    args += [] if plan is None else [plan["fwd"]["ring"]]
    build.check(getattr(lib, entry)(*args, build.stream_of(scores)), entry)
    return move_in, choices, cs, logz, end_state


def _backward(counter, scores, move_in, choices, cs, logz, end_state, qscale,
              qbias, reverse):
    """Q's checks and launch, routed as ``_forward``'s."""
    build.refuse_grad("Q", [scores], build.DECODE_ROUTE)
    N, T, S = _check_cuda(scores)
    check_forward_outputs("kernel Q", scores.device, N, T, S, move_in,
                          choices, cs, logz, end_state)
    lib = build.library()
    out = torch.empty(3, N, T, dtype=torch.uint8, device=scores.device)
    plan = _plan(counter, scores, move_in, choices)
    entry = decode_full_entry(plan, True)
    args = [scores.data_ptr(), int(scores.dtype == torch.float32),
            int(reverse), move_in.data_ptr(), choices.data_ptr(),
            cs.data_ptr(), logz.data_ptr(), end_state.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), N, T, S]
    args += [] if plan is None else [plan["bwd"]["ring"]]
    args += [float(qscale), float(qbias)]
    build.check(getattr(lib, entry)(*args, build.stream_of(scores)), entry)
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


def full_forward(scores, reverse=False):
    """``full_forward_plain``: the plain version for a CPU tensor, kernel M
    on the card (on ``decode_full_plan``'s plan, recorded in ``.plan``,
    else the earlier kernel)."""
    if scores.device.type == "cpu":
        return full_forward_plain(scores, reverse)
    return _forward(full_forward, scores, reverse)


def full_backward(scores, move_in, choices, cs, logz, end_state, qscale=1.0,
                  qbias=0.0, reverse=False):
    """``full_backward_plain``: the plain version for a CPU tensor, kernel Q
    on the card (routed as ``full_forward``)."""
    if scores.device.type == "cpu":
        return full_backward_plain(scores, move_in, choices, cs, logz,
                                   end_state, qscale, qbias, reverse)
    return _backward(full_backward, scores, move_in, choices, cs, logz,
                     end_state, qscale, qbias, reverse)


def full_forward_old_kernel(scores, reverse=False):
    """M's earlier kernel whatever the plan (CUDA tensors only): the route
    where ``decode_full_plan`` gives None, and what chip_smoke.py and the
    card tests hold the ring against. It counts no launch."""
    return _forward(None, scores, reverse)


def full_backward_old_kernel(scores, move_in, choices, cs, logz, end_state,
                             qscale=1.0, qbias=0.0, reverse=False):
    """Q's earlier kernel, as ``full_forward_old_kernel``."""
    return _backward(None, scores, move_in, choices, cs, logz, end_state,
                     qscale, qbias, reverse)


full_forward.launches = 0
full_backward.launches = 0
full_forward.plan = None  # the last call's (None: the earlier kernel)
full_backward.plan = None
