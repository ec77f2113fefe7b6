"""The shape rules and thread layouts of kernels G and Z on the card
(``ops.decode_fused_cuda.fused_decode_plan``'s "fwd", the fused-head
decode's forward pass on its ring of chunks, and
``ops.lattice_cuda.lattice_plan``, the alignment lattice's gradient split
over warps), checked here on the CPU: what each launch asks of an H100;
that G's ring hands every chunk over once, in order, under any
interleaving of its warps; that G's order of the f32 steps (alpha kept
raw and read through 1 / the last frame's max, the row's max, the max
semiring's first j, logZ's runs, the first argmax), emulated here, gives
``tcn_fused_forward_plain``'s outputs bit for bit; and that Z's split (K
positions a thread, the neighbour's beta by shuffle and from the warp
above, D frames of move and stack read ahead) gives
``lattice.backward_plain``'s bit for bit. The kernels themselves run only
on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import math
import random

import numpy as np
import pytest
import torch

from bonito_tpu_torch.crf.model import HeadSplit
from bonito_tpu_torch.ops import decode_cuda
from bonito_tpu_torch.ops import decode_fused_cuda as dfc
from bonito_tpu_torch.ops import lattice, lattice_cuda

SMS = 132           # an H100's SMs
SMEM = 232448       # the most shared memory a block may ask for
REGISTERS = 65536   # an SM's registers, in 4 sub-partitions


def _register_cap(threads):
    """The registers a thread of a block of ``threads`` may hold: each of
    the 4 sub-partitions keeps ceil(warps / 4) warps, in units of 8."""
    warps = -(-threads // 32)
    return min(255, REGISTERS // 4 // (32 * -(-warps // 4)) // 8 * 8)


# (N, T, S, H, U): fast, the two-phase head chip_smoke.py checks, the GPU
# tests' shapes (one block, ragged rows and chunks)
G_SHAPES = [(1024, 1200, 64, 96, 1), (24, 100, 64, 32, 2),
            (8, 9, 64, 32, 1), (19, 13, 64, 96, 1), (5, 14, 64, 32, 2),
            (64, 60, 64, 96, 1), (1, 1, 64, 96, 1)]


@pytest.mark.parametrize("N,T,S,H,U", G_SHAPES)
def test_g_plan_fits_the_card(N, T, S, H, U):
    """8 rows a CTA, a consumer warp a row (two states a thread), 8 head
    warps whose m-tiles cover the head's U * 4S rows once with their
    weights in registers, a producer warp; the registers a thread may hold
    in such a block, and the shared memory of two chunks' tiles and a ring
    of 2 to 8 chunks of 4 output frames."""
    plan = dfc.fused_decode_plan(N, T, S, H, U, SMS)["fwd"]
    assert plan["rows"] == 8 and plan["ctas"] == -(-N // 8)
    assert plan["waves"] == -(-plan["ctas"] // SMS)
    assert plan["consumer_warps"] == 8 and plan["states_per_thread"] == 2
    assert plan["head_warps"] * plan["m_tiles_a_head_warp"] * 16 == U * 4 * S
    assert plan["threads"] == 32 * (8 + 8 + 1) <= 1024
    assert plan["registers"] == _register_cap(plan["threads"])
    assert (plan["m_tiles_a_head_warp"] * plan["k_tiles"] * 4 + 48
            <= plan["registers"])
    assert plan["k_tiles"] * 16 == H and plan["frames_a_chunk"] == 4
    assert 2 <= plan["ring"] <= dfc.J_RING_MAX
    assert plan["smem"] == dfc.g_ring_smem(S, H, U, plan["ring"]) <= SMEM


def test_g_plan_at_fast():
    """The fast head (N 1024, T 1200, H 96, S 64, U 1): 128 CTAs of 17
    warps, one wave of 132 SMs, 96 registers a thread (48 of them a head
    warp's weights), a ring of 4 chunks, 165,120 B; J's plan beside it."""
    plans = dfc.fused_decode_plan(1024, 1200, 64, 96, 1, SMS)
    assert plans["fwd"] == {
        "rows": 8, "ctas": 128, "waves": 1, "threads": 544,
        "registers": 96, "consumer_warps": 8, "states_per_thread": 2,
        "head_warps": 8, "m_tiles_a_head_warp": 2, "k_tiles": 6,
        "frames_a_chunk": 4, "ring": 4, "smem": 165120}
    assert plans["bwd"]["threads"] == 576 and plans["bwd"]["ring"] == 4


@pytest.mark.parametrize("N,T,S,H,U,kw", [
    (8, 9, 16, 16, 1, {}), (8, 9, 256, 96, 1, {}), (8, 9, 1024, 96, 1, {}),
    (8, 9, 64, 16, 1, {}), (8, 9, 64, 256, 1, {}), (8, 9, 64, 96, 3, {}),
    (8, 18, 64, 96, 2, {}), (8, 9, 64, 96, 1, {"aligned": False}),
    (8, 9, 64, 48, 1, {}), (8, 9, 64, 128, 1, {}), (0, 9, 64, 96, 1, {}),
    (8, 0, 64, 96, 1, {}), (8, 9, 64, 32, 2, {})])
def test_g_plan_sends_the_rest_to_the_earlier_kernel(N, T, S, H, U, kw):
    """No instance (S 64, H 32 or 96, U 1 or 2 built; H 96 at U 2 would
    keep 96 registers of weights a head-warp thread), T not a whole number
    of encoder frames, or a pointer the bulk copies cannot read: no plan for
    G or J, the earlier kernels."""
    assert dfc.fused_decode_plan(N, T, S, H, U, SMS, **kw) is None


class _Barrier:
    """An mbarrier: phases complete when `count` arrivals are in; a wait
    for use u passes the parity of u, and the model checks that the waiter
    is never two phases behind."""

    def __init__(self, count):
        self.count, self.left, self.done = count, count, 0

    def arrive(self):
        self.left -= 1
        assert self.left >= 0
        if self.left == 0:
            self.done += 1
            self.left = self.count

    def ready(self, use):
        assert self.done <= use + 1, "a waiter two phases behind"
        return self.done == use + 1


def _run_g_ring(nchunk, ring, rows, heads, seed):
    """csrc/decode_tcn_fused.cu's G ring with `rows` consumer warps and
    `heads` head warps, each warp a generator that yields the barrier and
    use it waits for; the warps run in a random order, the producer's
    copies land at random times. Returns the chunks each consumer walked."""
    full = [_Barrier(1) for _ in range(ring)]
    empty = [_Barrier(heads) for _ in range(ring)]
    tfull = [_Barrier(heads) for _ in range(2)]
    tempty = [_Barrier(rows) for _ in range(2)]
    slot = [None] * ring          # the chunk a slot holds
    tile = [[None] * heads for _ in range(2)]  # each head warp's rows
    done = {"head": [-1] * heads, "cons": [-1] * rows}
    walked = [[] for _ in range(rows)]
    landing = []

    def producer():
        for it in range(nchunk):
            s = it % ring
            if it >= ring:
                yield empty[s], it // ring - 1
                # the slot's last chunk is read by every head warp
                assert min(done["head"]) >= it - ring
            landing.append((s, it))

    def head(hw):
        for it in range(nchunk):
            s, b = it % ring, it & 1
            yield full[s], it // ring
            if it >= 2:
                yield tempty[b], (it - 2) >> 1
                # the tile's chunk it - 2 is read by every consumer
                assert min(done["cons"]) >= it - 2
            assert slot[s] == it
            tile[b][hw] = it
            done["head"][hw] = it
            empty[s].arrive()
            tfull[b].arrive()

    def consumer(r):
        for it in range(nchunk):
            b = it & 1
            yield tfull[b], it >> 1
            assert tile[b] == [it] * heads
            walked[r].append(it)
            done["cons"][r] = it
            tempty[b].arrive()

    warps = [producer()] + [head(h) for h in range(heads)] \
        + [consumer(r) for r in range(rows)]
    waiting = {id(w): None for w in warps}
    rng = random.Random(seed)
    live = list(warps)
    while live or landing:
        runnable = [w for w in live if waiting[id(w)] is None
                    or waiting[id(w)][0].ready(waiting[id(w)][1])]
        if landing and (not runnable or rng.random() < 0.3):
            s, it = landing.pop(rng.randrange(len(landing)))
            slot[s] = it
            full[s].arrive()
            continue
        assert runnable, "the ring deadlocks"
        w = rng.choice(runnable)
        try:
            waiting[id(w)] = next(w)
        except StopIteration:
            live.remove(w)
    return walked


@pytest.mark.parametrize("ring", [2, 3, 4, 8])
@pytest.mark.parametrize("nchunk", [1, 2, 3, 5, 17])
def test_g_ring_hands_each_chunk_over_once_in_order(nchunk, ring):
    """Every consumer walks chunks 0 .. nchunk-1 (frames 0 .. T-1) once, in
    order, each finding every head warp's rows of its chunk in its tile;
    no slot is filled while a head warp has its chunk to read, no tile
    written while a consumer has its chunk to read; no waiter falls two
    phases behind; no interleaving deadlocks."""
    for seed in range(20):
        walked = _run_g_ring(nchunk, ring, rows=3, heads=2, seed=seed)
        assert all(w == list(range(nchunk)) for w in walked)


def _butterfly(x):
    """An xor butterfly over the last dim (32 lanes), in f32: lane 0's."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def _emulate_g(moves, blank):
    """G's ring as its warps take the f32 steps: the head warps' scores in
    the (j, s) order and their exps; consumer lane l of a row holds states
    s = 32i + l, reads alpha raw times 1 / the last frame's max, sums over
    j in order from 0, takes the max semiring's first best j, the row's max
    (on the bits: the raw values are never negative); at the end the sum
    of each run of 32 states is the warp's butterfly, the runs added in
    order from 0, and the end state the first argmax over the lanes'
    pairs."""
    N, T, Cm = moves.shape
    S = Cm // 4
    R = S // 4
    s = torch.arange(S)
    rows = dfc.fused_rows(S).view(4, S)                  # [j, s] -> TCN row
    pred = torch.arange(4)[:, None] * R + s // 4          # [j, s]
    p_stay = torch.tensor(math.exp(blank))
    raw = torch.ones(N, S)
    amax = torch.zeros(N, S)
    inv = torch.ones(N)
    c = torch.zeros(N)
    move_in = torch.empty(N, T, S)
    choices = torch.empty(N, T, S, dtype=torch.uint8)
    cs = torch.empty(N, T)
    for t in range(T):
        m = moves[:, t].float()[:, rows]                  # [N, j, s]
        e = torch.exp(m)                                  # the tile
        A = raw * inv[:, None]
        acc = torch.zeros(N, S)
        best = torch.zeros(N, S)
        jbest = torch.zeros(N, S, dtype=torch.long)
        for j in range(4):
            acc = acc + e[:, j] * A[:, pred[j]]
            cand = m[:, j] + amax[:, pred[j]]
            take = (cand > best) | (j == 0)
            best = torch.where(take, cand, best)
            jbest = torch.where(take, j, jbest)
        raw = p_stay * A + acc
        stay_m = blank + amax
        is_move = best > stay_m
        amax = torch.where(is_move, best, stay_m)
        wmax = raw.view(torch.int32).amax(1).view(torch.float32)
        inv = 1.0 / wmax
        c = c + torch.log(wmax)
        move_in[:, t] = acc * inv[:, None]
        choices[:, t] = torch.where(is_move, jbest + 1, 0).to(torch.uint8)
        cs[:, t] = c
    runs = _butterfly((raw * inv[:, None]).view(N, S // 32, 32))
    total = torch.zeros(N)
    for k in range(S // 32):
        total = total + runs[:, k]
    logz = torch.log(total) + c
    # lane l: the first of its two states on ties, then the lanes' first
    lane_v, lane_i = amax.view(N, S // 32, 32).max(1)
    lane_s = lane_i * 32 + torch.arange(32)
    top = lane_v.amax(1, keepdim=True)
    end = torch.where(lane_v == top, lane_s, S).amin(1).to(torch.int32)
    return move_in, choices, cs, logz, end


@pytest.mark.parametrize("N,Th,H,U,tanh,gain", [
    (6, 40, 32, 1, False, 3.0), (4, 9, 32, 2, True, 0.5),
    (3, 32, 96, 1, True, 0.5), (5, 17, 96, 1, False, 3.0),
    (4, 12, 32, 1, False, 50.0)])
def test_g_ring_emulation_equals_the_plain_version(N, Th, H, U, tanh, gain):
    """At the states the ring is built for (S 64: two runs of 32), on
    heads with one and two phases, with and without tanh, the ring's order
    of the f32 steps gives ``tcn_fused_forward_plain``'s move-in, choices,
    c, logZ and end state bit for bit: the assignment of states to
    threads, alpha read raw through 1 / max, the max on the bits and the
    runs move no bit. A gain of 50 clamps most scores to +-5, so the max
    semiring meets ties (the first j wins) and the end state too."""
    S = 64
    g = torch.Generator().manual_seed(N + Th + H)
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / H ** 0.5).to(
        torch.bfloat16)
    bias = 0.3 * torch.randn(U, 4 * S, generator=g) if tanh else None
    head = HeadSplit(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                     None if tanh else -5.0, None if tanh else 5.0, 2.0)
    want = dfc.tcn_fused_forward_plain(head)
    got = _emulate_g(dfc.head_moves_plain(head), 2.0)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert 0 < want[1].float().mean().item()  # some frames move


# P from 2 to sup's 1020, P - 1 no multiple of 4, below a warp, around the
# warps' edges, and two positions a thread above 1024
Z_PS = [2, 3, 5, 31, 32, 33, 64, 65, 496, 597, 598, 1020, 1024, 1025, 2048]


@pytest.mark.parametrize("P", Z_PS)
def test_lattice_plan_covers_every_position_once(P):
    """One CTA a row; the fewest positions a thread that keep the CTA to
    32 warps; warp w's lane l takes positions 32 K w + 32 j + l, each of
    0 .. P - 1 once, none of the last warp's wholly past P - 1; the
    prefetch depth a built instance has; one thread's prefetched values
    fit the registers a CTA of its warps leaves."""
    plan = lattice_cuda.lattice_plan(128, 1000, P, SMS)
    k, warps = plan["positions_per_thread"], plan["warps"]
    assert plan["ctas"] == 128 and plan["waves"] == 1
    assert k == (1 if P <= 1024 else 2) and k in lattice_cuda.Z_POSITIONS
    assert plan["threads"] == 32 * warps <= 1024
    assert plan["prefetch"] in lattice_cuda.Z_DEPTHS[k]
    assert 2 * k * plan["prefetch"] + 24 <= REGISTERS // plan["threads"]
    w, j, lane = np.meshgrid(np.arange(warps), np.arange(k), np.arange(32),
                             indexing="ij")
    p = (32 * k * w + 32 * j + lane).ravel()
    assert sorted(p[p < P]) == list(range(P))
    assert 32 * k * (warps - 1) < P
    assert plan["smem"] == 2 * 32 * 4


def test_lattice_plan_at_the_training_shapes():
    """hac (P 496): 16 warps of one position, 16 frames ahead; fast (P
    598): 19 warps, 16 ahead; sup (N 32, P 1020): 32 warps, 8 ahead (16
    would fill the register file)."""
    for N, T, P, warps, depth in ((128, 1000, 496, 16, 16),
                                  (128, 1200, 598, 19, 16),
                                  (32, 2048, 1020, 32, 8)):
        assert lattice_cuda.lattice_plan(N, T, P, SMS) == {
            "ctas": N, "waves": 1, "positions_per_thread": 1,
            "warps": warps, "threads": 32 * warps, "prefetch": depth,
            "smem": 256}


def test_lattice_plan_sends_the_rest_to_the_earlier_kernel():
    """P of 1 (no moves) or above 32 warps of two positions: no plan, the
    earlier Z; N or T of 0: none; above MAX_POSITIONS, which no kernel
    takes, a ValueError."""
    for shape in ((8, 9, 1), (8, 9, 2049), (8, 9, 9000),
                  (8, 9, lattice_cuda.MAX_POSITIONS), (0, 9, 64), (8, 0, 64)):
        assert lattice_cuda.lattice_plan(*shape, SMS) is None
    with pytest.raises(ValueError, match="at most"):
        lattice_cuda.lattice_plan(8, 9, lattice_cuda.MAX_POSITIONS + 1, SMS)


def _emulate_z(move, stack, lengths, gz, sign, blank, k, depth):
    """Z split over warps as its threads take the f32 steps: lane l of
    warp w holds beta of positions 32 K w + 32 j + l in registers (NEG past
    P - 1, never updated); the neighbour's beta of the frame after comes by
    shuffle from lane l + 1, lane 0 handing on its next position's or,
    for the last, the warp above's first position's from the edge buffer
    of that frame's parity (NEG above the last warp); move and stack come
    from a ring of ``depth`` frames, each slot refilled with the frame
    ``depth`` below the one it held once that frame is done."""
    N, T, Pm = move.shape
    P = Pm + 1
    warps = -(-P // (32 * k))
    NEG = torch.tensor(lattice.NEG, dtype=torch.float32)
    pos = (32 * k * torch.arange(warps)[:, None, None]
           + 32 * torch.arange(k)[None, :, None]
           + torch.arange(32)[None, None, :])            # [w, j, l]
    inside, moving = pos < P, pos < P - 1
    pclamp = pos.clamp(max=P - 2).clamp(min=0)
    end = (lengths.long() - 1)[:, None, None, None]
    b = torch.where(pos[None] == end, 0.0, NEG).expand(N, -1, -1, -1).clone()
    edge = torch.full((2, N, warps), float("nan"))
    edge[T & 1] = b[:, :, 0, 0]
    dmove = torch.full((N, T, Pm), float("nan"))

    def load(t):
        return (torch.where(moving, move[:, t][:, pclamp], NEG),
                torch.where(moving, stack[:, t][:, pclamp], 0.0))

    ring = {d: (T - 1 - d, load(T - 1 - d)) for d in range(min(depth, T))}
    for t0 in range(T - 1, -1, -depth):
        for d in range(depth):
            t = t0 - d
            if t < 0:
                break
            held, (mv, a) = ring[d]
            assert held == t
            up = torch.cat([edge[(t + 1) & 1][:, 1:],
                            torch.full((N, 1), lattice.NEG)], 1)
            # lane 0's hand-on: its next slot's value, the last slot the
            # warp above's edge (above the last warp, NEG)
            lane0 = torch.cat([b[:, :, 1:, 0], up[:, :, None]], 2)
            src = b.clone()
            src[..., 0] = lane0
            nb = torch.roll(src, -1, dims=3)
            v = torch.exp(((a + mv) + nb) + gz[:, None, None, None]) \
                * sign[:, None, None, None]
            row = dmove[:, t]
            row[:, pos[moving]] = v[:, moving]
            new = lattice._logaddexp(b + blank, nb + mv)
            b = torch.where(inside, new, b)
            edge[t & 1] = b[:, :, 0, 0]
            if t - depth >= 0:
                ring[d] = (t - depth, load(t - depth))
    return dmove


@pytest.mark.parametrize("P,T,k,depth", [
    (13, 24, 1, 16), (37, 40, 1, 8), (70, 19, 1, 16), (33, 9, 2, 4),
    (130, 30, 2, 8), (2, 17, 1, 16), (96, 5, 1, 8)])
def test_z_split_emulation_equals_the_plain_version(P, T, k, depth):
    """Z's split at one and two positions a thread, prefetch depths 4 to
    16 (T below, at and above them), P within a warp and over several,
    P - 1 no multiple of 4, rows of length 0, 1, -1, P and shorter (the
    positions past the length kept), cotangents of sign -1, 0 and +1:
    ``lattice.backward_plain``'s dmove bit for bit, -0.0 where the plain
    version writes it."""
    N = 8
    rng = np.random.default_rng(P + T + k)
    move = torch.from_numpy(rng.normal(size=(N, T, P - 1)).astype(np.float32))
    lengths = torch.tensor([P, 0, 1, -1, max(P // 2, 1), P, 3, P - 1],
                           dtype=torch.int32)
    cot = torch.tensor([1.0, 0.0, -2.0, 0.5, -1.0, 3.0, 0.0, -0.5])
    stack, lz = lattice.forward_plain(move, lengths, 2.0)
    gz, sg = lattice.cotangent(cot, lz)
    want = lattice.backward_plain(move, stack, lengths, gz, sg, 2.0)
    got = _emulate_z(move, stack, lengths, gz, sg, 2.0, k, depth)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (torch.signbit(want) & (want == 0)).any()  # -0.0 is written
