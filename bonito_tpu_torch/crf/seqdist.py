"""
CTC-CRF sequence distribution: the state space, its recurrences and the
training loss.

States are the last ``state_len`` bases (S = n_base**state_len, newest
base in the least-significant base-n_base digit). Each state has
n_base+1 incoming transition slots: slot 0 = stay, slot 1+j = move from
the predecessor whose dropped (oldest) base was j. With states factored
as s = r*n_base + b, the predecessor of slot j is p = j*R + r (R =
S/n_base). Full score tensors are [N, T, S*(n_base+1)].

The recurrences are plain torch, each with bonito_tpu's name and
contract (``bonito_tpu/crf/seqdist.py``). The two partition functions
that bonito_tpu runs as Pallas kernels on a TPU, ``logZ`` (full scores)
and ``logZ_tcn`` (the decode layout), and the alignment lattice of
``ctc_loss_tcn`` go through ``ops.logz`` and ``ops.lattice``: hand-written
kernels on the card, their plain versions on the CPU, routed by shape as
bonito_tpu routes them. ``ctc_loss``'s own lattice (its stays are no
constant) is a plain loop under autograd, as it is a scan in bonito_tpu.
"""

import numpy as np
import torch

NEG = -1e30


class Semiring:
    def __init__(self, one, sum_fn, pair_fn):
        self.one = one
        self.sum = sum_fn     # sum_fn(x, dim)
        self.pair = pair_fn   # the two-operand sum


Log = Semiring(0.0, torch.logsumexp, torch.logaddexp)
Max = Semiring(0.0, lambda x, dim: torch.amax(x, dim), torch.maximum)


def _clip_targets(targets):
    return torch.clamp(torch.as_tensor(targets).long() - 1, min=0)


class CTC_CRF:
    """CRF over k-mer states with CTC-style stay transitions."""

    def __init__(self, state_len, alphabet):
        self.alphabet = list(alphabet)
        self.state_len = state_len
        self.n_base = len(alphabet) - 1
        self.n_states = self.n_base ** state_len

    @property
    def idx(self):
        """Predecessor table [S, n_base+1]: column 0 the state itself
        (stay), column 1+j the predecessor j*R + s//n_base."""
        nb, S = self.n_base, self.n_states
        R = S // nb
        stay = np.arange(S, dtype=np.int32)[:, None]
        moves = (stay // nb) + np.arange(nb, dtype=np.int32)[None, :] * R
        return np.concatenate([stay, moves], axis=1)

    def n_score(self):
        return (self.n_base + 1) * self.n_states

    # -- dense one-step recurrences ------------------------------------------

    def _split_scores(self, Ms):
        """Ms [..., S, nb+1] -> (stay [..., S], moves [..., R, nb, nb])."""
        nb, S = self.n_base, self.n_states
        R = S // nb
        return Ms[..., 0], Ms[..., 1:].reshape(*Ms.shape[:-2], R, nb, nb)

    def _fwd_step(self, alpha, Ms_t, S):
        """alpha [N, S] -> alpha' [N, S] using scores Ms_t [N, S, nb+1]."""
        nb, NS = self.n_base, self.n_states
        R = NS // nb
        stay, moves = self._split_scores(Ms_t)          # [N,S], [N,r,b,j]
        a_moves = alpha.reshape(-1, nb, R).transpose(1, 2)  # [N, r, j]
        move_in = S.sum(moves + a_moves[:, :, None, :], -1)  # [N, r, b]
        return S.pair(stay + alpha, move_in.reshape(-1, NS))

    def _bwd_step(self, beta, Ms_t, S):
        """beta [N, S] (at t+1) -> beta' [N, S] (at t)."""
        nb, NS = self.n_base, self.n_states
        R = NS // nb
        stay, moves = self._split_scores(Ms_t)          # [N,S], [N,r,b,j]
        b_next = beta.reshape(-1, R, nb)                # [N, r, b]
        move_out = S.sum(moves + b_next[..., None], 2)  # over b -> [N, r, j]
        move_out = move_out.transpose(1, 2).reshape(-1, NS)  # p = j*R + r
        return S.pair(stay + beta, move_out)

    # -- scans ----------------------------------------------------------------

    def _reshape(self, scores):
        N, T, _ = scores.shape
        return scores.reshape(N, T, self.n_states, self.n_base + 1).float()

    def forward_scores(self, scores, S=Log):
        """All forward state scores alpha [N, T+1, S]."""
        Ms = self._reshape(scores)
        N, T = Ms.shape[:2]
        alpha = [torch.full((N, self.n_states), S.one, device=Ms.device)]
        for t in range(T):
            alpha.append(self._fwd_step(alpha[-1], Ms[:, t], S))
        return torch.stack(alpha, 1)

    def backward_scores(self, scores, S=Log):
        """All backward state scores beta [N, T+1, S]."""
        Ms = self._reshape(scores)
        N, T = Ms.shape[:2]
        beta = [torch.full((N, self.n_states), S.one, device=Ms.device)]
        for t in range(T - 1, -1, -1):
            beta.append(self._bwd_step(beta[-1], Ms[:, t], S))
        return torch.stack(beta[::-1], 1)

    def logZ(self, scores, S=Log):
        """Partition function [N] (flat alpha_0 / beta_T). The Log
        semiring goes through ``ops.logz.logZ``: kernels W and X on the
        card where bonito_tpu takes its Pallas kernel, with its bf16
        rounding (``ops.logz`` has the routes)."""
        if S is not Log:
            return self.logZ_scan(scores, S)
        from bonito_tpu_torch.ops import logz
        return logz.logZ(self, scores)

    def logZ_scan(self, scores, S=Log):
        """The plain loop over frames, in f32, differentiated by autograd."""
        Ms = self._reshape(scores)
        N, T = Ms.shape[:2]
        alpha = torch.full((N, self.n_states), S.one, device=Ms.device)
        for t in range(T):
            alpha = self._fwd_step(alpha, Ms[:, t], S)
        return S.sum(alpha, 1)

    def normalise(self, scores):
        """Per-frame global normalisation: scores - logZ/T."""
        T = scores.shape[1]
        scores = scores.float()
        return scores - self.logZ(scores)[:, None, None] / T

    def posteriors(self, scores, S=Log):
        """Edge posteriors [N, T, C]. Log semiring: the transition
        posteriors p(edge at t | x) (rows sum to 1 over C). Max semiring:
        the score of the best full path through each edge."""
        Ms = self._reshape(scores)                      # [N, T, S, nb+1]
        alpha = self.forward_scores(scores, S)          # [N, T+1, S]
        beta = self.backward_scores(scores, S)          # [N, T+1, S]
        nb, NS = self.n_base, self.n_states
        R = NS // nb
        N, T = Ms.shape[:2]
        stay_pred = alpha[:, :-1]                                   # [N,T,S]
        a = alpha[:, :-1].reshape(N, T, nb, R)                      # [N,T,j,r]
        move_pred = a.transpose(2, 3)[:, :, :, None, :].expand(
            N, T, R, nb, nb)                                        # [N,T,r,b,j]
        pred = torch.cat([stay_pred[..., None],
                          move_pred.reshape(N, T, NS, nb)], -1)     # [N,T,S,nb+1]
        edge = pred + Ms + beta[:, 1:, :, None]
        if S is Log:
            z = torch.logsumexp(edge.reshape(N, T, -1), -1)
            edge = torch.exp(edge - z[..., None, None])
        return edge.reshape(N, T, -1)

    def compute_transition_probs(self, scores, betas):
        """Per-state transition probabilities [N, T, S, nb+1] in the
        (old_state, emitted_base) layout — stay first, then the nb
        outgoing moves — and the initial state probabilities [N, S], from
        scores [N, T, C] and betas [N, T+1, S]."""
        N, T, _ = scores.shape
        nb, S = self.n_base, self.n_states
        R = S // nb
        log_trans = scores.reshape(N, T, S, nb + 1) + betas[:, 1:, :, None]
        # move slot j of new state s (= r*nb+b) comes from p = j*R + r and
        # emits b: regroup the moves by predecessor
        moves = log_trans[..., 1:].reshape(N, T, R, nb, nb).transpose(3, 4)
        moves = moves.transpose(2, 3).reshape(N, T, S, nb)       # p = j*R+r
        out = torch.cat([log_trans[..., :1], moves], -1)
        return torch.softmax(out, -1), torch.softmax(betas[:, 0], -1)

    # -- decoding --------------------------------------------------------------

    def viterbi(self, scores):
        """Best path [N, T]: 0 where the best edge is a stay, else 1 +
        the emitted base (the new state's newest digit)."""
        c = torch.argmax(self.posteriors(scores, Max), 2)
        n_edge = self.n_base + 1
        base = 1 + torch.div(c, n_edge, rounding_mode="floor") % self.n_base
        return torch.where(c % n_edge != 0, base, 0)

    def path_to_str(self, path):
        alphabet = np.frombuffer("".join(self.alphabet).encode(), dtype="u1")
        path = np.asarray(path)
        return alphabet[path[path != 0]].tobytes().decode()

    def reverse_complement(self, scores):
        """Full scores [N, T, S*(n_base+1)] of the reverse-complement
        strand: time reversed, each k-mer transition mapped to its reverse
        complement. A permutation of the entries, bonito_tpu's exactly:
        the stay columns take the state's digits in reverse order, each
        flipped (complemented); the move columns take the new state's
        digits and the slot, the dropped digit becoming the new slot."""
        N, T, C = scores.shape
        nb, sl = self.n_base, self.state_len
        expanded = scores.reshape(N, T, *(nb,) * sl, nb + 1)

        blanks = expanded[..., 0].permute(0, 1, *range(sl + 1, 1, -1))
        blanks = blanks.reshape(N, T, -1, 1).flip(1, 2)

        # (N, T, a1..a_sl, j) -> (N, T, a_sl-1..a1, j, a_sl)
        moves = expanded[..., 1:].permute(0, 1, *range(sl, 1, -1), sl + 2,
                                          sl + 1)
        moves = moves.reshape(N, T, -1, nb).flip(1, 2, 3)
        return torch.cat([blanks, moves], dim=-1).reshape(N, T, -1)

    # -- training loss ----------------------------------------------------------

    def _lattice_states(self, targets):
        """(zero-indexed targets [N, L], the state s of each lattice
        position [N, n_pos])."""
        targets = _clip_targets(targets)
        n = targets.shape[1] - (self.state_len - 1)
        state = sum(targets[:, i:n + i] * self.n_base ** (self.state_len - i - 1)
                    for i in range(self.state_len))
        return targets, state

    def prepare_ctc_scores(self, scores, targets):
        """Per-position stay/move scores along the target alignment
        lattice, targets [N, L] CTC labels (blank=0, bases 1..nb) ->
        (stay [N, T, n_pos], move [N, T, n_pos-1]) in f32. bonito_tpu
        selects with one-hot products (MXU work on a TPU); a gather takes
        the same values exactly, and its backward scatter-adds."""
        targets, state = self._lattice_states(targets)
        targets = targets.to(scores.device)
        state = state.to(scores.device)
        n = state.shape[1]
        stay_idx = state * (self.n_base + 1)
        move_idx = stay_idx[:, 1:] + targets[:, :n - 1] + 1
        N, T, _ = scores.shape
        scores = scores.float()
        stay = torch.gather(scores, 2, stay_idx[:, None].expand(N, T, n))
        move = torch.gather(scores, 2, move_idx[:, None].expand(N, T, n - 1))
        return stay, move

    @staticmethod
    def _lattice_logZ(stay, move, lengths, S=Log):
        """Alignment-lattice partition function: stay [N, T, n], move
        [N, T, n-1], lengths [N] = the number of valid lattice positions
        of each sample. alpha_0 is 0 at position 0 and NEG (not -inf, whose
        sums make NaN in the backward) elsewhere; the end is read with a
        mask at lengths - 1 (a gather's index would wrap at -1)."""
        N, T, n = stay.shape
        alpha = torch.full((N, n), NEG, device=stay.device)
        alpha[:, 0] = 0.0
        pad = torch.full((N, 1), NEG, device=stay.device)
        for t in range(T):
            move_path = torch.cat([pad, alpha[:, :-1] + move[:, t]], 1)
            alpha = S.pair(alpha + stay[:, t], move_path)
        lengths = torch.as_tensor(lengths, device=stay.device)
        end = torch.arange(n, device=stay.device)[None] == (lengths - 1)[:, None]
        return torch.where(end, alpha, 0.0).sum(1)

    def ctc_viterbi_alignments(self, scores, targets, target_lengths):
        """One-hot Viterbi alignment of each target to the frames:
        [N, T, n_pos] with 1 where lattice position p is active at frame t
        on the best alignment path."""
        stay, move = self.prepare_ctc_scores(scores, targets)
        lengths = (torch.as_tensor(target_lengths, device=stay.device)
                   + 1 - self.state_len).long()
        N, T, n = stay.shape
        alpha = torch.full((N, n), NEG, device=stay.device)
        alpha[:, 0] = 0.0
        pad = torch.full((N, 1), NEG, device=stay.device)
        moved = []
        for t in range(T):
            stay_path = alpha + stay[:, t]
            move_path = torch.cat([pad, alpha[:, :-1] + move[:, t]], 1)
            moved.append(move_path > stay_path)
            alpha = torch.where(moved[-1], move_path, stay_path)
        pos = lengths - 1
        rows = torch.arange(N, device=stay.device)
        path = torch.zeros(N, T, n, device=stay.device)
        for t in range(T - 1, -1, -1):
            # a position of -1 (a target shorter than state_len) wraps, as
            # bonito_tpu's one_hot and take_along_axis do
            p = pos % n
            path[rows, t, p] = (pos >= 0).float()
            pos = pos - moved[t][rows, p].long()
        return path

    def logZ_tcn(self, moves_tcn, blank_score):
        """Partition function [N] from the decode-layout [T, S*nb, N] move
        scores + constant stay (``Model.forward_tcn``'s output): kernels U
        and V on the card (``ops.logz`` has the routes)."""
        from bonito_tpu_torch.ops import logz
        return logz.logZ_tcn(self, moves_tcn, blank_score)

    def prepare_ctc_moves_tcn(self, moves_tcn, targets):
        """Move scores along the target lattice, from the TCN layout ->
        move [N, T, n_pos-1] f32. (The lattice's stays are all the
        constant blank, so only the moves are selected.) A gather of the
        [N, T, Cm] memory that ``moves_tcn`` views."""
        nb, S = self.n_base, self.n_states
        R = S // nb
        T, Cm, N = moves_tcn.shape
        targets, state = self._lattice_states(targets)
        n = state.shape[1]
        s_succ = state[:, 1:]
        j = targets[:, :n - 1]
        q = ((s_succ % nb) * nb + j) * R + torch.div(
            s_succ, nb, rounding_mode="floor")         # TCN row
        q = q.to(moves_tcn.device)
        return torch.gather(moves_tcn.permute(2, 0, 1), 2,
                            q[:, None].expand(N, T, n - 1)).float()

    def _reduce(self, logz, target_lengths, lattice_lengths, loss_clip,
                reduction):
        # max(., 1): a zero-length target would otherwise NaN the whole
        # batch through the backward (where() zeroes the value, but the
        # division's backward multiplies the zero cotangent by 1/0 first)
        loss = -(logz / torch.clamp(target_lengths, min=1))
        # targets shorter than state_len have no valid lattice
        valid = lattice_lengths >= 1
        loss = torch.where(valid, loss, 0.0)
        if loss_clip:
            loss = torch.clamp(loss, 0.0, loss_clip)
        if reduction == "mean":
            return loss.sum() / torch.clamp(valid.sum(), min=1)
        if reduction in ("none", None):
            return loss
        raise ValueError(f"unknown reduction {reduction}")

    def ctc_loss_tcn(self, moves_tcn, blank_score, targets, target_lengths,
                     loss_clip=None, reduction="mean", normalise_scores=True):
        """``ctc_loss`` from the TCN layout: the same value through
        lattice_logZ(scores - z/T) == lattice_logZ(scores) - z (every
        lattice path takes exactly T transitions), so the normalised
        scores never materialise and the logZ gradient comes back in the
        TCN layout. The lattice runs kernels Y and Z on the card."""
        from bonito_tpu_torch.ops import lattice
        move = self.prepare_ctc_moves_tcn(moves_tcn, targets)
        target_lengths = torch.as_tensor(target_lengths,
                                         device=move.device).long()
        lattice_lengths = (target_lengths + 1 - self.state_len).int()
        logz = lattice.lattice_logZ(move, lattice_lengths, float(blank_score))
        if normalise_scores:
            logz = logz - self.logZ_tcn(moves_tcn, blank_score)
        return self._reduce(logz, target_lengths, lattice_lengths, loss_clip,
                            reduction)

    def ctc_loss(self, scores, targets, target_lengths, loss_clip=None,
                 reduction="mean", normalise_scores=True):
        """-log p(target | x) / target_length, averaged over the batch."""
        if normalise_scores:
            scores = self.normalise(scores)
        stay, move = self.prepare_ctc_scores(scores, targets)
        target_lengths = torch.as_tensor(target_lengths,
                                         device=stay.device).long()
        lattice_lengths = (target_lengths + 1 - self.state_len).int()
        logz = self._lattice_logZ(stay, move, lattice_lengths)
        return self._reduce(logz, target_lengths, lattice_lengths, loss_clip,
                            reduction)
