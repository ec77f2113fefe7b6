"""
Fixed-width CRF beam search over full scores, batch-vectorised: bonito_tpu's
``beam_search_device`` (koi's ``beam_search`` semantics) in plain torch.

Each frame, every beam proposes a stay and n_base moves; hypotheses with
the same (state, emitted base) merge by log-sum-exp, the traceback
following the best-scoring member (the highest index on a tie); the best
beam_width survive, and survivors more than beam_cut below the best are
dropped (they go on as rows at -1e30, which merge as identity and never
win). Where bonito_tpu looks rows up by one-hot contractions, this gathers
them: the same f32 values. Survivors are chosen by a stable descending
sort, which puts the lower index first among equal values as
``lax.top_k`` does (``torch.topk`` promises no order on ties, and the
candidates tie often: every dead beam sits at -1e30).

It is plain XLA in bonito_tpu and plain torch here, a loop over the frames
of a few small operations each; the default decode is the exact Viterbi
path (kernels M and Q, or the TCN routes).
"""

import torch

NEG = -1e30


def beam_search_device(seqdist, scores, beam_width=32, beam_cut=100.0,
                       scale=1.0, offset=0.0, qscale=1.0, qbias=0.0):
    """scores [N, T, S*(nb+1)] raw CRF scores -> {sequence, qstring,
    moves}, each [N, T] uint8 (the contract of ``viterbi_decode``)."""
    nb = seqdist.n_base
    S = seqdist.n_states
    R = S // nb
    W = beam_width
    dev = scores.device

    scores = scores.float() * scale + offset
    N, T, C = scores.shape
    ms = scores.reshape(N, T, S, nb + 1)

    states = torch.zeros(N, W, dtype=torch.long, device=dev)
    bscores = torch.full((N, W), NEG, device=dev)
    bscores[:, 0] = 0.0

    warange = torch.arange(W, device=dev)
    barange = torch.arange(nb, device=dev)
    carange = torch.arange(W * (nb + 1), device=dev)
    cand_parent = torch.cat([warange, warange.repeat_interleave(nb)])
    cand_parent = cand_parent[None].expand(N, -1)
    cand_base = torch.cat([torch.zeros(W, dtype=torch.long, device=dev),
                           (1 + barange).repeat(W)])[None].expand(N, -1)

    parents, emitted = [], []
    for t in range(T):
        ms_t = ms[:, t]                                        # [N, S, nb+1]
        stay_sc = bscores + ms_t[..., 0].gather(1, states)
        j = states // R
        succ = (states[..., None] * nb + barange) % S          # [N, W, nb]
        # the move into each successor from its slot 1 + j (the
        # predecessor's leading base)
        move_sc = bscores[..., None] + ms_t.gather(
            1, succ.reshape(N, W * nb, 1).expand(-1, -1, nb + 1)).reshape(
            N, W, nb, nb + 1).gather(
            3, (1 + j)[..., None, None].expand(-1, -1, nb, 1))[..., 0]

        cand_scores = torch.cat([stay_sc, move_sc.reshape(N, W * nb)], 1)
        cand_states = torch.cat([states, succ.reshape(N, W * nb)], 1)

        # merge identical (state, base) hypotheses by logsumexp
        key = cand_states * (nb + 1) + cand_base               # [N, 5W]
        eq = key[:, :, None] == key[:, None, :]                # [N, 5W, 5W]
        sc_j = torch.where(eq, cand_scores[:, None, :], NEG)
        gmax = sc_j.amax(2)                                    # [N, 5W]
        merged = gmax + torch.log(torch.exp(sc_j - gmax[..., None]).sum(2))
        # representative = best-scoring member, ties -> highest index
        is_best = eq & (cand_scores[:, None, :] == gmax[..., None])
        best_idx = torch.where(is_best, carange, -1).amax(2)
        merged = torch.where(carange == best_idx, merged, NEG)

        vals, top = torch.sort(merged, dim=1, descending=True, stable=True)
        vals, top = vals[:, :W], top[:, :W]
        vals = torch.where(vals > vals[:, :1] - beam_cut, vals, NEG)

        states = cand_states.gather(1, top)
        bscores = vals
        parents.append(cand_parent.gather(1, top))
        emitted.append(cand_base.gather(1, top))

    # traceback from the best final beam (the first on a tie)
    w = torch.argmax(bscores, dim=1)[:, None]
    bases = torch.empty(N, T, dtype=torch.long, device=dev)
    for t in range(T - 1, -1, -1):
        bases[:, t] = emitted[t].gather(1, w)[:, 0]
        w = parents[t].gather(1, w)
    is_move = bases > 0

    # qscores from the frame score distribution
    conf = torch.softmax(scores, dim=-1).amax(-1)
    q = (-10.0 * torch.log10(torch.clamp(1.0 - conf, 1e-4, 1.0)) * qscale
         + qbias)
    qchar = (torch.round(q) + 33.0).to(torch.uint8)
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    return {
        "sequence": torch.where(is_move, bases.to(torch.uint8), zero),
        "qstring": torch.where(is_move, qchar, zero),
        "moves": is_move.to(torch.uint8),
    }
