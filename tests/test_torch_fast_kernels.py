"""The shape rules and thread layouts of kernels F and J on the card
(``ops.lstm_fused_cuda.fused_plan``, the fast LSTM layer's mma kernel, and
``ops.decode_fused_cuda.fused_decode_plan``, the fused-head decode's
backward pass on its ring of chunks), checked here on the CPU: what each
launch asks of an H100, that F's threads cover every row and gate column
once and that its gate-column order, run through the plain version's math,
gives the plain version's h bit for bit; that J's ring hands every chunk
over once, in order, under any interleaving of its warps; and that J's
order of the f32 steps (the consumers' states, the mass's runs, the
epilogue's sums), emulated here, gives ``tcn_backward_plain``'s outputs
bit for bit. The kernels themselves run only on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""

import math
import random

import pytest
import torch

from bonito_tpu_torch.ops import decode_cuda
from bonito_tpu_torch.ops import decode_fused_cuda as dfc
from bonito_tpu_torch.ops import lstm_fused_cuda as lfc

SMS = 132           # an H100's SMs
SMEM = 232448       # the most shared memory a block may ask for
REGISTERS = 65536   # an SM's registers, in 4 sub-partitions


def _register_cap(threads):
    """The registers a thread of a block of ``threads`` may hold: each of
    the 4 sub-partitions keeps ceil(warps / 4) warps, in units of 8."""
    warps = -(-threads // 32)
    return min(255, REGISTERS // 4 // (32 * -(-warps // 4)) // 8 * 8)


# (N, H = C): fast (N 1024), the GPU tests' shapes (a ragged last block, one
# row), and more rows than one wave holds
F_SHAPES = [(1024, 96), (64, 96), (19, 32), (8, 16), (1, 80), (5, 48),
            (2000, 64)]


@pytest.mark.parametrize("N,H", F_SHAPES)
def test_fused_plan_fits_the_card(N, H):
    """8 rows a block, H / 8 warps of 8 units each (4H threads), the
    weights in registers beside the three products' accumulators and the
    gate math's values, the ring of x rows and h in shared memory."""
    plan = lfc.fused_plan(N, H, H, SMS)
    assert plan["rows"] == 8 and plan["units_a_warp"] == 8
    assert plan["warps"] == H // 8 and plan["threads"] == 4 * H <= 1024
    assert plan["ctas"] == -(-N // 8)
    assert plan["waves"] == -(-plan["ctas"] // SMS)
    assert plan["weight_registers"] == (H + H) // 2
    # the x, next x and h accumulators (24), bias, c and addressing: 64
    assert plan["weight_registers"] + 64 <= _register_cap(plan["threads"])
    assert plan["smem"] == 2 * (5 * 8 * (H + 8) + 2 * 8 * (H + 8)) <= SMEM


@pytest.mark.parametrize("N,H", F_SHAPES)
def test_fused_plan_covers_every_row_and_gate_column_once(N, H):
    """Lane 4g + tig of warp w in block c holds, in its two m16 tiles'
    accumulators, the permuted columns 32w + 16mt + g (+ 8) for rows 8c +
    2 tig and 8c + 2 tig + 1: through ``gate_columns`` they are i, f (tile
    0) and g, o (tile 1) of unit 8w + g, and every (row, gate column) is
    held once."""
    plan = lfc.fused_plan(N, H, H, SMS)
    perm = lfc.gate_columns(H)
    assert sorted(perm.tolist()) == list(range(4 * H))
    held = torch.zeros(8, 4 * H, dtype=torch.int64)  # one block's rows
    for w in range(plan["warps"]):
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            cols = [int(perm[32 * w + 16 * mt + 8 * half + g])
                    for mt in (0, 1) for half in (0, 1)]
            assert cols == [k * H + 8 * w + g for k in range(4)]
            held[2 * tig:2 * tig + 2, cols] += 1
    assert torch.all(held == 1)
    rows = torch.arange(plan["ctas"] * 8)
    assert rows[rows < N].numel() == N  # the blocks' rows cover the batch


@pytest.mark.parametrize("N,C,H", [(19, 32, 48), (8, 1024, 96),
                                   (16, 112, 112), (8, 256, 256),
                                   (8, 96, 128), (4, 16, 32)])
def test_fused_plan_sends_the_rest_to_the_earlier_kernel(N, C, H):
    """C != H, or H beyond the widths built (a thread's registers hold
    (C + H) / 2 of weights: 96 at fast): no plan, the earlier kernel."""
    assert lfc.fused_supported(C, H)
    assert lfc.fused_plan(N, C, H, SMS) is None


@pytest.mark.parametrize("N,C,H", [(0, 96, 96), (8, 8, 8), (8, 96, 272)])
def test_fused_plan_rejects_what_f_does_not_take(N, C, H):
    with pytest.raises(ValueError, match="kernel F takes"):
        lfc.fused_plan(N, C, H, SMS)


@pytest.mark.parametrize("H", lfc.MMA_WIDTHS)
def test_mma_kernel_loads_its_fragments_in_gate_column_order(H):
    """csrc/lstm_fused.cu:load_weights, emulated: lane 4g + tig of warp w
    packs, for m-tile mt and k-tile kt, the pairs W[k][c], W[k + 1][c] at k
    = 16 kt + 2 tig (+ 8) and c = 2mt H + 8w + g (+ H); those are the A
    fragments (m16n8k16: rows g and g + 8, k 2 tig, 2 tig + 1 and 8 more)
    of the operand whose rows are W's columns in ``gate_columns`` order."""
    g_ = torch.Generator().manual_seed(H)
    W = torch.randn(H, 4 * H, generator=g_)
    A = W[:, lfc.gate_columns(H)].t()  # [4H, K]: the operand's rows
    for w in range(H // 8):
        for lane in range(32):
            g, tig = lane >> 2, lane & 3
            for mt in (0, 1):
                c0 = 2 * mt * H + 8 * w + g
                for kt in range(H // 16):
                    k = 16 * kt + 2 * tig
                    loaded = [(W[kk, c], W[kk + 1, c]) for kk, c in
                              ((k, c0), (k, c0 + H), (k + 8, c0),
                               (k + 8, c0 + H))]
                    m = 32 * w + 16 * mt + g
                    frag = [(A[r, kk], A[r, kk + 1]) for r, kk in
                            ((m, k), (m + 8, k), (m, k + 8), (m + 8, k + 8))]
                    assert loaded == frag


def _emulate_f(x, w_ih, w_hh, b, reverse):
    """``lstm_fused_plain``'s math on the mma kernel's weights (its gate
    columns permuted, ``gate_columns``, as it loads them), each step's four
    gates read back as its threads hold them: gate k of unit 8w + r at
    permuted column 32w + 8k + r."""
    T, N, C = x.shape
    H = w_hh.shape[0]
    dtype = x.dtype
    wt = torch.cat([w_ih.to(dtype), w_hh.to(dtype)])[:, lfc.gate_columns(H)] \
        .t().float()
    xw = torch.matmul(x.float(), wt[:, :C].t())
    if b is not None:
        xw = xw + b.float()[lfc.gate_columns(H)]
    w = wt[:, C:].t()
    h = torch.zeros(N, H)
    c = torch.zeros(N, H)
    out = torch.empty(T, N, H, dtype=dtype)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[t] + torch.matmul(h.to(dtype).float(), w)
        i, f, gg, o = (gates.view(N, H // 8, 4, 8)[:, :, k].reshape(N, H)
                       for k in range(4))
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h.to(dtype)
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("N,T,H", [(12, 7, 96), (5, 9, 16)])
def test_gate_permutation_through_the_plain_math_gives_the_plain_h(
        N, T, H, bias, reverse):
    """At fast widths and a small one, bf16 as the model runs: the
    permuted columns change no bit of h."""
    g = torch.Generator().manual_seed(N + T + H)
    x = torch.tanh(torch.randn(T, N, H, generator=g)).to(torch.bfloat16)
    w_ih = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(torch.bfloat16)
    w_hh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(torch.bfloat16)
    b = 0.5 * torch.randn(4 * H, generator=g) if bias else None
    want = lfc.lstm_fused_plain(x, w_ih, w_hh, b, reverse=reverse)
    got = _emulate_f(x, w_ih, w_hh, b, reverse)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


# (N, T, S, H, U): fast, the two-phase head chip_smoke.py checks, the GPU
# tests' shapes (one block, ragged rows and chunks)
J_SHAPES = [(1024, 1200, 64, 96, 1), (24, 100, 64, 32, 2),
            (8, 9, 64, 32, 1), (19, 13, 64, 96, 1), (5, 14, 64, 32, 2),
            (64, 60, 64, 96, 1)]


@pytest.mark.parametrize("N,T,S,H,U", J_SHAPES)
def test_fused_decode_plan_fits_the_card(N, T, S, H, U):
    """8 rows a CTA, a consumer warp a row (two states a thread), 8 head
    warps whose m-tiles cover the head's U * 4S rows once with their
    weights in registers, a producer and an epilogue warp; the registers a
    thread may hold in such a block, and the shared memory with a ring of
    2 to 8 chunks."""
    plan = dfc.fused_decode_plan(N, T, S, H, U, SMS)["bwd"]
    assert plan is not None
    assert plan["rows"] == 8 and plan["ctas"] == -(-N // 8)
    assert plan["consumer_warps"] == 8 and plan["states_per_thread"] == 2
    assert plan["head_warps"] * plan["m_tiles_a_head_warp"] * 16 == U * 4 * S
    assert plan["threads"] == 32 * (8 + 8 + 2) <= 1024
    assert plan["registers"] == _register_cap(plan["threads"])
    assert (plan["m_tiles_a_head_warp"] * plan["k_tiles"] * 4 + 48
            <= plan["registers"])
    assert plan["k_tiles"] * 16 == H and plan["frames_a_chunk"] == 4 * U
    assert 2 <= plan["ring"] <= dfc.J_RING_MAX
    assert plan["smem"] == dfc.j_ring_smem(S, H, U, plan["ring"]) <= SMEM


def test_fused_decode_plan_at_fast():
    """The fast head (N 1024, T 1200, H 96, S 64, U 1): 128 CTAs of 18
    warps, one wave of 132 SMs, 96 registers a thread (48 of them a head
    warp's weights), a ring of 4 chunks, 137,472 B."""
    assert dfc.fused_decode_plan(1024, 1200, 64, 96, 1, SMS)["bwd"] == {
        "rows": 8, "ctas": 128, "waves": 1, "threads": 576,
        "registers": 96, "consumer_warps": 8, "states_per_thread": 2,
        "head_warps": 8, "m_tiles_a_head_warp": 2, "k_tiles": 6,
        "frames_a_chunk": 4, "ring": 4, "smem": 137472}


@pytest.mark.parametrize("N,T,S,H,U,kw", [
    (8, 9, 16, 16, 1, {}), (8, 9, 256, 96, 1, {}), (8, 9, 1024, 96, 1, {}),
    (8, 9, 64, 16, 1, {}), (8, 9, 64, 256, 1, {}), (8, 9, 64, 96, 3, {}),
    (8, 18, 64, 96, 2, {}), (8, 9, 64, 96, 1, {"aligned": False}),
    (8, 9, 64, 48, 1, {}), (8, 9, 64, 96, 2, {}),
    (0, 9, 64, 96, 1, {})])
def test_fused_decode_plan_sends_the_rest_to_the_earlier_kernel(N, T, S, H,
                                                                U, kw):
    """No instance (S 64, H 32 or 96, U 1 or 2 built; H 96 at U 2 would
    keep 96 registers of weights a head-warp thread), or a pointer the bulk
    copies cannot read: no plan, the earlier J."""
    assert dfc.fused_decode_plan(N, T, S, H, U, SMS, **kw) is None


class _Barrier:
    """An mbarrier: phases complete when `count` arrivals (and the bytes
    of any copies expected) are in; a wait for use u passes the parity of
    u, and the model checks that the waiter is never two phases behind."""

    def __init__(self, count):
        self.count, self.left, self.done = count, count, 0

    def arrive(self):
        self.left -= 1
        assert self.left >= 0
        if self.left == 0:
            self.done += 1
            self.left = self.count

    def ready(self, use):
        # try_wait.parity(use & 1) passes once the phase of that parity
        # completed: one phase ahead at most
        assert self.done <= use + 1, "a waiter two phases behind"
        return self.done == use + 1


def _run_j_ring(nchunk, ring, rows, heads, seed):
    """csrc/decode_tcn_fused.cu's ring of chunks with `rows` consumer warps
    and `heads` head warps, each warp a generator that yields the barrier
    and use it waits for; the warps run in a random order. Returns the
    frames (chunks) each consumer walked and the epilogue's chunks."""
    full = [_Barrier(1) for _ in range(ring)]
    empty = [_Barrier(heads + rows) for _ in range(ring)]
    tfull = [_Barrier(heads) for _ in range(2)]
    tempty = [_Barrier(rows + 1) for _ in range(2)]
    rfull = [_Barrier(rows) for _ in range(2)]
    slot = [None] * ring          # the chunk a slot holds
    tile = [None, None]           # the chunk whose exps a tile holds
    rec = [[None] * rows for _ in range(2)]
    done = {"head": [-1] * heads, "cons": [-1] * rows, "epi": -1}
    walked = [[] for _ in range(rows)]
    epi = []
    landing = []                  # copies issued, not landed

    def producer():
        for it in range(nchunk):
            s = it % ring
            if it >= ring:
                yield empty[s], it // ring - 1
                # the slot's last chunk is read by every head and consumer
                assert min(done["head"] + done["cons"]) >= it - ring
            landing.append((s, it))
        return

    def head(hw):
        for it in range(nchunk):
            s, b = it % ring, it & 1
            yield full[s], it // ring
            if it >= 2:
                yield tempty[b], (it - 2) >> 1
                # the tile's chunk it - 2 is read and its records taken
                assert min(done["cons"]) >= it - 2 and done["epi"] >= it - 2
            assert slot[s] == it
            tile[b] = it
            done["head"][hw] = it
            empty[s].arrive()
            tfull[b].arrive()

    def consumer(r):
        for it in range(nchunk):
            s, b = it % ring, it & 1
            yield full[s], it // ring
            yield tfull[b], it >> 1
            assert slot[s] == it and tile[b] == it
            walked[r].append(it)
            rec[b][r] = it
            done["cons"][r] = it
            empty[s].arrive()
            tempty[b].arrive()
            rfull[b].arrive()

    def epilogue():
        for it in range(nchunk):
            b = it & 1
            yield rfull[b], it >> 1
            assert rec[b] == [it] * rows
            epi.append(it)
            done["epi"] = it
            tempty[b].arrive()

    warps = [producer(), epilogue()] + [head(h) for h in range(heads)] \
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
    return walked, epi


@pytest.mark.parametrize("ring", [2, 3, 4, 8])
@pytest.mark.parametrize("nchunk", [1, 2, 3, 5, 17])
def test_j_ring_hands_each_chunk_over_once_in_order(nchunk, ring):
    """Every consumer walks chunks 0 .. nchunk-1 (frames T-1 .. 0) once, in
    order, each finding its chunk in its slot and its exps in its tile; the
    epilogue takes every chunk's records once, in order; no slot is filled
    and no tile written while a chunk in it has a read to come; no waiter
    falls two phases behind; no interleaving deadlocks."""
    for seed in range(20):
        walked, epi = _run_j_ring(nchunk, ring, rows=3, heads=2, seed=seed)
        assert all(w == list(range(nchunk)) for w in walked)
        assert epi == list(range(nchunk))


def _butterfly(x):
    """An xor butterfly over the last dim (32 lanes), in f32: lane 0's."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[..., lanes ^ o]
    return x[..., 0]


def _emulate_j(moves, move_in, choices, cs, logz, end_state, stay, qscale,
               qbias):
    """J's ring as its warps take the f32 steps: the head warps' exps of the
    moves; consumer lane l of a row holds predecessors p = 32i + l, reads
    beta raw times 1 / the last frame's max, sums over b in order from 0,
    takes the row's max and its share of the mass (the emitted base's
    states); the mass of each run of 32 states is the warp's butterfly,
    and the epilogue adds the runs in order from 0."""
    N, T, Cm = moves.shape
    S = Cm // 4
    R = S // 4
    rows = torch.arange(N)
    p = torch.arange(S)
    succ = 4 * (p % R)[:, None] + torch.arange(4)            # [S, 4]
    ex = torch.exp(moves.float())                            # the tile
    braw = torch.ones(N, S)
    inv = torch.ones(N)
    state = end_state.long()
    d = torch.zeros(N)
    seq = torch.zeros(N, T, dtype=torch.uint8)
    qstr = torch.zeros(N, T, dtype=torch.uint8)
    mv = torch.zeros(N, T, dtype=torch.uint8)
    p_stay = math.exp(stay)
    for t in range(T - 1, -1, -1):
        bc = braw * inv[:, None]
        choice = choices[rows, t, state].long()
        base = state % 4 + 1
        share = torch.where(p % 4 == (base - 1)[:, None], move_in[:, t] * bc,
                            torch.zeros(()))
        e = ex[:, t].view(N, 4, S)
        acc = torch.zeros(N, S)
        for bb in range(4):
            acc = acc + e[:, bb] * bc[:, succ[:, bb]]
        braw = p_stay * bc + acc
        mx = braw.amax(1)
        runs = _butterfly(share.view(N, S // 32, 32))
        bmass = torch.zeros(N)
        for k in range(S // 32):
            bmass = bmass + runs[:, k]
        prob = bmass * torch.exp(cs[:, t] + d - logz)
        moved = choice != 0
        seq[:, t] = torch.where(moved, base, 0).to(torch.uint8)
        qstr[:, t] = torch.where(
            moved, decode_cuda.qstring_codes(prob, qscale, qbias),
            torch.zeros((), dtype=torch.uint8))
        mv[:, t] = moved.to(torch.uint8)
        d = d + torch.log(mx)
        inv = 1.0 / mx
        state = torch.where(moved, state // 4 + (choice - 1).clamp(min=0) * R,
                            state)
    return {"sequence": seq, "qstring": qstr, "moves": mv}


@pytest.mark.parametrize("N,T,S", [(6, 40, 64), (4, 9, 64), (3, 64, 64)])
def test_j_ring_emulation_equals_the_plain_version(N, T, S):
    """At the states the ring is built for (S 64: two runs of 32, whose sum
    in order from 0 is block_sum's), on moves given as f32 (a head's, tanh
    x 5, and a clamped one), the ring's order of the f32 steps gives
    ``tcn_backward_plain``'s sequence, qstring and moves bit for bit: the
    assignment of states to threads and the mass's runs move no bit."""
    g = torch.Generator().manual_seed(N + T + S)
    for moves in (5 * torch.tanh(torch.randn(N, T, 4 * S, generator=g)),
                  (3 * torch.randn(N, T, 4 * S, generator=g)).clamp(-5, 5)):
        fwd = decode_cuda.tcn_forward_plain(moves, 2.0)
        want = decode_cuda.tcn_backward_plain(moves, *fwd, 2.0, 1.05, 0.2)
        got = _emulate_j(moves, *fwd, 2.0, 1.05, 0.2)
        for k in ("sequence", "qstring", "moves"):
            assert torch.equal(got[k], want[k]), k
