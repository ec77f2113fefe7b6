"""
The CRF partition function logZ of the training loss, differentiable, with
bonito_tpu's routes: ``logZ_tcn`` (kernel-table row 9, kernels U and V)
from the decode layout with a constant stay, and ``logZ`` (row 10,
kernels W and X) from full scores with a stay plane.

Forward, per row, in log space with flat ends (alpha_0 = 0, logZ =
logsumexp over states of alpha_T); backward, the closed form: the edge
posteriors exp(alpha_t[pred] + score + beta_{t+1}[succ] - logZ) times the
cotangent, streamed from a beta pass over the alpha stack the forward kept
([N, T, S] f32). ``csrc/logz.cu`` has the recurrences.

Routes, as bonito_tpu's by shape (its gates taken as if on a TPU):
- where its Pallas gate passes (``supported``/``supported_tcn``: n_base 4,
  S and R multiples of 8, N a multiple of 8) the numbers are its kernel
  route's: scores rounded to bf16, the gradient rounded to bf16 and then
  cast to the primal's dtype;
- elsewhere they are its scan's, f32 throughout: the same recurrences
  without the rounding;
- a CUDA tensor that no kernel takes (n_base != 4, S above 1024) raises;
  a CPU tensor of such a shape takes ``CTC_CRF.logZ_scan`` under autograd.
A CUDA tensor launches the kernels, a CPU tensor runs their plain versions
(below); with no gradient wanted the forward runs without its stack.
"""

import torch

from bonito_tpu_torch.ops import logz_cuda
from bonito_tpu_torch.ops.decode import tcn_to_scores
from bonito_tpu_torch.ops.decode_cuda import NB, block_sum
from bonito_tpu_torch.ops.decode_full_cuda import split_scores


# -- bonito_tpu's gates (ops/decode_pallas.py:supported*, ops/decode.py) --

def _sub_batch(n_states):
    return max(128, min(2048, 128 * 1024 // max(n_states, 1)))


def _block_k(S, N, nb):
    """The TPU kernels' block depth for its VMEM budget; 0: none fits."""
    eff_n = -(-N // 128) * 128
    plane = S * eff_n
    avail = (16 << 20) - 14 * plane * 4
    per_k = plane * (2 + 2 * nb + 4 + 2) * 2
    if avail < per_k:
        return 0
    return max(1, min(4, avail // per_k))


def _gate(seqdist, N, cols, width):
    S = seqdist.n_states
    R = S // max(seqdist.n_base, 1)
    return (seqdist.n_base == 4 and S % 8 == 0 and R % 8 == 0
            and N % 8 == 0 and cols == S * width
            and _block_k(S, min(N, _sub_batch(S)), seqdist.n_base) >= 1)


def supported(seqdist, scores):
    """bonito_tpu's gate of ``logZ_pallas`` for full scores [N, T, C]."""
    N, _, C = scores.shape
    return _gate(seqdist, N, C, seqdist.n_base + 1)


def supported_tcn(seqdist, moves_tcn, blank_score):
    """bonito_tpu's gate of ``logZ_tcn`` for moves [T, S*nb, N]."""
    _, Cm, N = moves_tcn.shape
    return blank_score is not None and _gate(seqdist, N, Cm, seqdist.n_base)


def _kernel_takes(seqdist, cols, width):
    return (seqdist.n_base == NB and seqdist.n_states in logz_cuda.STATES
            and cols == seqdist.n_states * width)


# -- the plain versions of U, V, W and X -----------------------------------

def _round(x, round_bf16):
    return x.to(torch.bfloat16).float() if round_bf16 else x.float()


def _stay(stay, t, round_bf16):
    if isinstance(stay, torch.Tensor):
        return _round(stay[:, t], round_bf16)
    return stay


def _lse(a, b):
    big = torch.maximum(a, b)
    return big + torch.log(torch.exp(a - big) + torch.exp(b - big))


def _sum4(x, dim):
    x = x.unbind(dim)
    return x[0] + x[1] + x[2] + x[3]


def forward_plain(moves, stay, round_bf16=True, with_stack=True):
    """moves [N, T, nb*S] (TCN column order, any strides), stay a float or
    [N, T, S] -> (alpha stack [N, T, S] f32 or None, logZ [N] f32)."""
    N, T, Cm = moves.shape
    S = Cm // NB
    R = S // NB
    dev = moves.device
    alpha = torch.zeros(N, S, device=dev)
    stack = torch.empty(N, T, S, device=dev) if with_stack else None
    for t in range(T):
        if with_stack:
            stack[:, t] = alpha
        mv = _round(moves[:, t], round_bf16).reshape(N, NB, NB, R)  # b, j, r
        cand = mv + alpha.reshape(N, 1, NB, R)
        m = cand.amax(2)                                           # [N, b, r]
        move_in = m + torch.log(_sum4(torch.exp(cand - m[:, :, None]), 2))
        move_in = move_in.transpose(1, 2).reshape(N, S)            # r*nb + b
        alpha = _lse(_stay(stay, t, round_bf16) + alpha, move_in)
    mx = alpha.amax(1)
    return stack, mx + torch.log(block_sum(torch.exp(alpha - mx[:, None])))


def backward_plain(moves, stay, stack, logz, g, round_bf16=True,
                   out_dtype=torch.float32):
    """The gradient of ``forward_plain``'s logZ times g [N] -> (d moves
    [N, T, nb*S], d stay [N, T, S] or None for a constant stay), in
    ``out_dtype``; rounded to bf16 first with ``round_bf16``."""
    N, T, Cm = moves.shape
    S = Cm // NB
    R = S // NB
    dev = moves.device
    plane = isinstance(stay, torch.Tensor)
    gmoves = torch.empty(N, T, Cm, dtype=out_dtype, device=dev)
    gstay = torch.empty(N, T, S, dtype=out_dtype, device=dev) if plane else None
    lz, gg = logz[:, None], g.float()[:, None]

    def out(x):
        return _round(x, round_bf16).to(out_dtype)

    beta = torch.zeros(N, S, device=dev)
    for t in range(T - 1, -1, -1):
        mv = _round(moves[:, t], round_bf16).reshape(N, NB, NB, R)  # b, j, r
        st = _stay(stay, t, round_bf16)
        bv = beta.reshape(N, R, NB).transpose(1, 2)[:, :, None]    # b, 1, r
        edge = (mv + stack[:, t].reshape(N, 1, NB, R)) + bv
        gmoves[:, t] = out(torch.exp(edge.reshape(N, Cm) - lz) * gg)
        if plane:
            gstay[:, t] = out(torch.exp(((stack[:, t] + st) + beta) - lz) * gg)
        mo = mv + bv                                               # b, j, r
        mm = mo.amax(1)                                            # [N, j, r]
        ls = mm + torch.log(_sum4(torch.exp(mo - mm[:, None]), 1))
        beta = _lse(st + beta, ls.reshape(N, S))                   # j*R + r
    return gmoves, gstay


def full_forward_plain(scores, round_bf16=True, with_stack=True):
    """W's plain version: full scores [N, T, (nb+1)*S]."""
    return forward_plain(*split_scores(scores), round_bf16, with_stack)


def full_backward_plain(scores, stack, logz, g, round_bf16=True,
                        out_dtype=torch.float32):
    """X's plain version: the gradient in the full scores' layout."""
    N, T, C = scores.shape
    S = C // (NB + 1)
    gm, gs = backward_plain(*split_scores(scores), stack, logz, g,
                            round_bf16, out_dtype)
    gm = gm.reshape(N, T, NB, NB, S // NB).permute(0, 1, 4, 2, 3)  # r, b, j
    return torch.cat([gs[..., None], gm.reshape(N, T, S, NB)], -1).reshape(
        N, T, C)


# -- one call: the plain version for a CPU tensor, the kernel on the card --

def tcn_forward(moves, blank, round_bf16=True, with_stack=True):
    if moves.device.type == "cpu":
        return forward_plain(moves, float(blank), round_bf16, with_stack)
    return logz_cuda.tcn_forward(moves, blank, round_bf16, with_stack)


def tcn_backward(moves, stack, logz, g, blank, round_bf16=True,
                 out_dtype=None):
    out_dtype = moves.dtype if out_dtype is None else out_dtype
    if moves.device.type == "cpu":
        return backward_plain(moves, float(blank), stack, logz, g, round_bf16,
                              out_dtype)[0]
    return logz_cuda.tcn_backward(moves, stack, logz, g, blank, round_bf16,
                                  out_dtype)


def full_forward(scores, round_bf16=True, with_stack=True):
    if scores.device.type == "cpu":
        return full_forward_plain(scores, round_bf16, with_stack)
    return logz_cuda.full_forward(scores, round_bf16, with_stack)


def full_backward(scores, stack, logz, g, round_bf16=True, out_dtype=None):
    out_dtype = scores.dtype if out_dtype is None else out_dtype
    if scores.device.type == "cpu":
        return full_backward_plain(scores, stack, logz, g, round_bf16,
                                   out_dtype)
    return logz_cuda.full_backward(scores, stack, logz, g, round_bf16,
                                   out_dtype)


# -- the autograd Functions and the routes ---------------------------------

def _frame_major(moves_tcn):
    """The [N, T, S*nb] memory a [T, S*nb, N] move tensor views (a copy
    only when it views no such memory)."""
    moves = moves_tcn.permute(2, 0, 1)
    return moves if moves.is_contiguous() else moves.contiguous()


class TcnLogZ(torch.autograd.Function):
    """logZ [N] of moves_tcn [T, S*nb, N]; the gradient comes back in the
    moves' own shape, strides and dtype."""

    @staticmethod
    def forward(ctx, moves_tcn, blank, round_bf16):
        stack, logz = tcn_forward(_frame_major(moves_tcn), blank, round_bf16)
        ctx.save_for_backward(moves_tcn, stack, logz)
        ctx.blank, ctx.round_bf16 = blank, round_bf16
        return logz

    @staticmethod
    def backward(ctx, g):
        moves_tcn, stack, logz = ctx.saved_tensors
        grad = tcn_backward(_frame_major(moves_tcn), stack, logz,
                            g.float().contiguous(), ctx.blank, ctx.round_bf16)
        return grad.permute(1, 2, 0), None, None


class FullLogZ(torch.autograd.Function):
    """logZ [N] of full scores [N, T, S*(nb+1)]."""

    @staticmethod
    def forward(ctx, scores, round_bf16):
        scores = scores.contiguous()
        stack, logz = full_forward(scores, round_bf16)
        ctx.save_for_backward(scores, stack, logz)
        ctx.round_bf16 = round_bf16
        return logz

    @staticmethod
    def backward(ctx, g):
        scores, stack, logz = ctx.saved_tensors
        return full_backward(scores, stack, logz, g.float().contiguous(),
                             ctx.round_bf16), None


def _wants_grad(x):
    return torch.is_grad_enabled() and x.requires_grad


def logZ_tcn(seqdist, moves_tcn, blank_score):
    """logZ [N] from moves_tcn [T, S*nb, N] and the constant stay
    ``blank_score``: ``CTC_CRF.logZ_tcn``'s route."""
    T, Cm, N = moves_tcn.shape
    if not _kernel_takes(seqdist, Cm, NB):
        if moves_tcn.device.type == "cuda":
            raise ValueError(
                f"logZ_tcn: no kernel takes n_base {seqdist.n_base}, "
                f"{seqdist.n_states} states, {Cm} move rows on the card")
        return seqdist.logZ_scan(tcn_to_scores(seqdist, moves_tcn,
                                               blank_score))
    round_bf16 = supported_tcn(seqdist, moves_tcn, blank_score)
    blank = float(blank_score)
    if not _wants_grad(moves_tcn):
        return tcn_forward(_frame_major(moves_tcn), blank, round_bf16,
                           with_stack=False)[1]
    return TcnLogZ.apply(moves_tcn, blank, round_bf16)


def logZ(seqdist, scores):
    """logZ [N] from full scores [N, T, S*(nb+1)] (Log semiring):
    ``CTC_CRF.logZ``'s route. bonito_tpu casts the scores to f32 before
    its kernel, so the gradient's dtype is f32 there, cast back to the
    scores' own by autograd."""
    N, T, C = scores.shape
    if not _kernel_takes(seqdist, C, NB + 1):
        if scores.device.type == "cuda":
            raise ValueError(
                f"logZ: no kernel takes n_base {seqdist.n_base}, "
                f"{seqdist.n_states} states, {C} columns on the card")
        return seqdist.logZ_scan(scores)
    round_bf16 = supported(seqdist, scores)
    scores = scores.float()
    if not _wants_grad(scores):
        return full_forward(scores.contiguous(), round_bf16,
                            with_stack=False)[1]
    return FullLogZ.apply(scores, round_bf16)
