"""
The CTC alignment lattice's logZ of ``CTC_CRF.ctc_loss_tcn``, kernel-table
row 11: differentiable with respect to the move scores, kernels Y and Z on
the card and their plain versions (below) on the CPU.

Each target's lattice has P positions; position p advances by at most one
per frame; the stay is the constant blank and the moves [N, T, P-1] f32
come from ``CTC_CRF.prepare_ctc_moves_tcn``; lengths [N] positions are
valid. Padding is NEG = -1e30, never -inf (the backward's sums would make
inf - inf). The backward is the closed form over the alpha stack the
forward kept: d move[t, p] = exp(alpha_t[p] + move + beta_{t+1}[p+1] -
logZ) * g, with the cotangent passed as log|g| - logZ and sign(g) so that
a masked row (g = 0) gets 0. ``csrc/lattice.cu`` has the recurrences.

A CUDA tensor takes the kernels, which take any P and need no fallback;
a CPU tensor takes their plain versions. Both are f32, as bonito_tpu's
kernel and its scan are.
"""

import torch

from bonito_tpu_torch.ops import lattice_cuda

NEG = -1e30


def _logaddexp(x, y):
    m = torch.maximum(x, y)
    return m + torch.log1p(torch.exp(-(x - y).abs()))


def forward_plain(move, lengths, blank, with_stack=True):
    """Y's plain version -> (alpha stack [N, T, P] f32 or None, logZ [N])."""
    N, T, Pm = move.shape
    P = Pm + 1
    dev = move.device
    alpha = torch.full((N, P), NEG, device=dev)
    alpha[:, 0] = 0.0
    neg = torch.full((N, 1), NEG, device=dev)
    stack = torch.empty(N, T, P, device=dev) if with_stack else None
    for t in range(T):
        if with_stack:
            stack[:, t] = alpha
        moved = torch.cat([neg, alpha[:, :-1] + move[:, t]], 1)
        alpha = _logaddexp(alpha + blank, moved)
    end = torch.arange(P, device=dev)[None] == (lengths.long() - 1)[:, None]
    return stack, torch.where(end, alpha, 0.0).sum(1)


def backward_plain(move, stack, lengths, gz, sign, blank):
    """Z's plain version -> d move [N, T, P-1] f32."""
    N, T, Pm = move.shape
    P = Pm + 1
    dev = move.device
    end = torch.arange(P, device=dev)[None] == (lengths.long() - 1)[:, None]
    beta = torch.where(end, 0.0, NEG)
    neg = torch.full((N, 1), NEG, device=dev)
    dmove = torch.empty_like(move)
    for t in range(T - 1, -1, -1):
        m = move[:, t]
        dmove[:, t] = torch.exp(((stack[:, t, :-1] + m) + beta[:, 1:])
                                + gz[:, None]) * sign[:, None]
        beta = _logaddexp(beta + blank, torch.cat([beta[:, 1:], neg], 1)
                          + torch.cat([m, neg], 1))
    return dmove


def forward(move, lengths, blank, with_stack=True):
    if move.device.type == "cpu":
        return forward_plain(move, lengths, blank, with_stack)
    return lattice_cuda.lattice_forward(move, lengths, blank, with_stack)


def backward(move, stack, lengths, gz, sign, blank):
    if move.device.type == "cpu":
        return backward_plain(move, stack, lengths, gz, sign, blank)
    return lattice_cuda.lattice_backward(move, stack, lengths, gz, sign,
                                         blank)


def cotangent(g, logz):
    """(log|g| - logZ, sign(g)) as the kernels take g, both [N] f32."""
    g = g.float()
    return ((torch.log(torch.clamp(g.abs(), min=1e-38)) - logz).contiguous(),
            torch.sign(g).contiguous())


class LatticeLogZ(torch.autograd.Function):
    @staticmethod
    def forward(ctx, move, lengths, blank):
        stack, logz = forward(move, lengths, blank)
        ctx.save_for_backward(move, stack, lengths, logz)
        ctx.blank = blank
        return logz

    @staticmethod
    def backward(ctx, g):
        move, stack, lengths, logz = ctx.saved_tensors
        return backward(move, stack, lengths, *cotangent(g, logz),
                        ctx.blank), None, None


def lattice_logZ(move, lengths, blank):
    """move [N, T, P-1] f32, lengths [N] valid lattice positions -> logZ
    [N]; the gradient is with respect to ``move`` only."""
    move = move.float().contiguous()
    lengths = torch.as_tensor(lengths, device=move.device).int().contiguous()
    if not (torch.is_grad_enabled() and move.requires_grad):
        return forward(move, lengths, float(blank), with_stack=False)[1]
    return LatticeLogZ.apply(move, lengths, float(blank))
