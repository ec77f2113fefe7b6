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
bound by bytes on an H100 and, like B and C, latency-bound by design: one
block per batch row, one thread per state.

The plain versions are the TCN decode's (``ops/decode_cuda.py``) with a
stay plane, fed through the column permutation that takes the moves into
the TCN (b, j, r) order. ``full_forward``/``full_backward`` run the plain
version for a tensor on the CPU and the kernel for a tensor on the card;
never one for the other.
"""

import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.decode_cuda import (
    NB, check_forward_outputs, tcn_backward_plain, tcn_forward_plain)


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


def full_forward_plain(scores):
    """The forward pass -> (move_in [N, T, S] f32, choices [N, T, S] uint8,
    c [N, T] f32, logz [N] f32, end_state [N] int32)."""
    return tcn_forward_plain(*split_scores(scores))


def full_backward_plain(scores, move_in, choices, cs, logz, end_state,
                        qscale=1.0, qbias=0.0):
    """The backward pass, traceback and emission -> {"sequence",
    "qstring", "moves"}, each [N, T] uint8."""
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


def full_forward(scores):
    """``full_forward_plain``: the plain version for a CPU tensor, kernel M
    on the card."""
    if scores.device.type == "cpu":
        return full_forward_plain(scores)
    build.refuse_grad("M", [scores], build.DECODE_ROUTE)
    N, T, S = _check_cuda(scores)
    lib = build.library()
    dev = scores.device
    move_in = torch.empty(N, T, S, device=dev)
    choices = torch.empty(N, T, S, dtype=torch.uint8, device=dev)
    cs = torch.empty(N, T, device=dev)
    logz = torch.empty(N, device=dev)
    end_state = torch.empty(N, dtype=torch.int32, device=dev)
    full_forward.launches += 1
    build.check(lib.decode_full_fwd(
        scores.data_ptr(), int(scores.dtype == torch.float32),
        move_in.data_ptr(), choices.data_ptr(), cs.data_ptr(),
        logz.data_ptr(), end_state.data_ptr(), N, T, S,
        build.stream_of(scores)), "decode_full_fwd")
    return move_in, choices, cs, logz, end_state


def full_backward(scores, move_in, choices, cs, logz, end_state, qscale=1.0,
                  qbias=0.0):
    """``full_backward_plain``: the plain version for a CPU tensor, kernel Q
    on the card."""
    if scores.device.type == "cpu":
        return full_backward_plain(scores, move_in, choices, cs, logz,
                                   end_state, qscale, qbias)
    build.refuse_grad("Q", [scores], build.DECODE_ROUTE)
    N, T, S = _check_cuda(scores)
    check_forward_outputs("kernel Q", scores.device, N, T, S, move_in,
                          choices, cs, logz, end_state)
    lib = build.library()
    out = torch.empty(3, N, T, dtype=torch.uint8, device=scores.device)
    full_backward.launches += 1
    build.check(lib.decode_full_bwd(
        scores.data_ptr(), int(scores.dtype == torch.float32),
        move_in.data_ptr(), choices.data_ptr(), cs.data_ptr(),
        logz.data_ptr(), end_state.data_ptr(), out[0].data_ptr(),
        out[1].data_ptr(), out[2].data_ptr(), N, T, S, float(qscale),
        float(qbias), build.stream_of(scores)), "decode_full_bwd")
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


full_forward.launches = 0
full_backward.launches = 0
