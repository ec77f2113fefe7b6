"""
CTC-CRF sequence distribution: the state space the decode runs over.

States are the last ``state_len`` bases (S = n_base**state_len, newest
base in the least-significant base-n_base digit). Each state has
n_base+1 incoming transition slots: slot 0 = stay, slot 1+j = move from
the predecessor whose dropped (oldest) base was j. With states factored
as s = r*n_base + b, the predecessor of slot j is p = j*R + r (R =
S/n_base). Full score tensors are [N, T, S*(n_base+1)].

The training recurrences (logZ, posteriors, ctc_loss) wait for the
training slice.
"""

import numpy as np
import torch


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
