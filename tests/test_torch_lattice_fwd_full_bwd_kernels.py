"""The shape rules and thread layouts of kernels Y and X on the card
(``ops.lattice_cuda.lattice_fwd_plan``, the alignment lattice's forward
pass split over warps, and ``ops.logz_cuda.logz_plan(..., full=True)``,
the gradient of logZ of the full scores on the ring), checked here on the
CPU: what each launch asks of an H100; that Y's split (K positions a
thread, alpha[p-1] by shuffle from lane l-1 and from the warp below by
parity, D frames of move read ahead) gives ``lattice.forward_plain``'s
stack and logZ bit for bit; that X's consumers (V's predecessors j*R + q,
the sums over b in order) and its gradient pass over the frame's columns
give ``logz.full_backward_plain``'s gradient bit for bit; and both
emulations against bonito_tpu's Pallas kernels in interpret mode. The
kernels themselves run only on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.ops import lattice_pallas, logz_pallas
from bonito_tpu_torch.ops import lattice, lattice_cuda, logz, logz_cuda

SMS = 132           # an H100's SMs
SMEM = 232448       # the most shared memory a block may ask for
REGISTERS = 65536   # an SM's registers
ALPHABET = ["N", "A", "C", "G", "T"]
# the tolerances of tests/test_torch_loss.py: f32 values, and a gradient
# rounded to bf16 (one bf16 step of each entry, most entries equal)
F32_RTOL, F32_ATOL = 2e-5, 1e-6
MIN_EQUAL = 0.99


@pytest.fixture
def one_thread():
    """torch on one CPU thread, so that each elementwise exp and log takes
    one code path over the whole tensor (its vector loop: every tensor
    below holds a multiple of 64 entries), in the emulations and in the
    plain versions alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- Y --------------------------------------------------------------------

Y_PS = [2, 3, 31, 32, 33, 496, 598, 1020, 1024, 1025, 2048]


@pytest.mark.parametrize("P", Y_PS)
def test_lattice_fwd_plan_covers_every_position_once(P):
    """One CTA a row; the fewest positions a thread that keep the CTA to
    32 warps (Z's split); warp w's lane l takes positions 32 K w + 32 j +
    l, each of 0 .. P - 1 once, none of the last warp's wholly past P - 1;
    a prefetch depth that an instance is built with; one thread's
    prefetched moves fit the registers a CTA of its warps leaves."""
    plan = lattice_cuda.lattice_fwd_plan(128, 1000, P, SMS)
    k, warps = plan["positions_per_thread"], plan["warps"]
    assert plan["ctas"] == 128 and plan["waves"] == 1
    assert k == (1 if P <= 1024 else 2) and k in lattice_cuda.Z_POSITIONS
    assert plan["threads"] == 32 * warps <= 1024
    assert plan["prefetch"] in lattice_cuda.Y_DEPTHS[k]
    assert k * plan["prefetch"] + 24 <= REGISTERS // plan["threads"]
    w, j, lane = np.meshgrid(np.arange(warps), np.arange(k), np.arange(32),
                             indexing="ij")
    p = (32 * k * w + 32 * j + lane).ravel()
    assert sorted(p[p < P]) == list(range(P))
    assert 32 * k * (warps - 1) < P
    assert plan["smem"] == 2 * 32 * 4


def test_lattice_fwd_plan_at_the_training_shapes():
    """hac (P 496): 16 warps of one position; fast (P 598): 19; sup (N 32,
    P 1020): 32; each 32 frames ahead."""
    for N, T, P, warps in ((128, 1000, 496, 16), (128, 1200, 598, 19),
                           (32, 2048, 1020, 32)):
        assert lattice_cuda.lattice_fwd_plan(N, T, P, SMS) == {
            "ctas": N, "waves": 1, "positions_per_thread": 1,
            "warps": warps, "threads": 32 * warps, "prefetch": 32,
            "smem": 256}


def test_lattice_fwd_plan_sends_the_rest_to_the_earlier_kernel():
    """P of 1 (no moves) or above 32 warps of two positions: no plan, the
    earlier Y; N or T of 0: none; above MAX_POSITIONS, which no kernel
    takes, a ValueError. Z's rule is its own: putting Y alone on its
    earlier kernel leaves Z's plan."""
    for shape in ((8, 9, 1), (8, 9, 2049), (8, 9, 9000),
                  (8, 9, lattice_cuda.MAX_POSITIONS), (0, 9, 64), (8, 0, 64)):
        assert lattice_cuda.lattice_fwd_plan(*shape, SMS) is None
    with pytest.raises(ValueError, match="kernel Y takes at most"):
        lattice_cuda.lattice_fwd_plan(8, 9, lattice_cuda.MAX_POSITIONS + 1,
                                      SMS)
    assert lattice_cuda.lattice_fwd_plan is not lattice_cuda.lattice_plan


def _emulate_y(move, lengths, blank, k, depth, with_stack=True):
    """Y split over warps as its threads take the f32 steps: lane l of warp
    w holds alpha of positions 32 K w + 32 j + l in registers (0 at
    position 0, NEG elsewhere and past P - 1, never updated there); alpha
    [p-1] of the frame comes by shuffle from lane l - 1, lane 31 handing
    lane 0 its position of j - 1 and, for j = 0, lane 0 taking the warp
    below's last position's from the edge buffer of the frame's parity
    (NEG below warp 0); the move into p from a ring of ``depth`` frames,
    each slot refilled with the frame ``depth`` above the one it held once
    that frame is done; the stack stored before the update; logZ from the
    thread that holds position lengths - 1, else 0."""
    N, T, Pm = move.shape
    P = Pm + 1
    warps = -(-P // (32 * k))
    NEG = torch.tensor(lattice.NEG, dtype=torch.float32)
    pos = (32 * k * torch.arange(warps)[:, None, None]
           + 32 * torch.arange(k)[None, :, None]
           + torch.arange(32)[None, None, :])            # [w, j, l]
    inside, moving = pos < P, (pos >= 1) & (pos < P)
    pclamp = (pos - 1).clamp(min=0, max=P - 2)
    a = torch.where(pos == 0, 0.0, NEG).expand(N, -1, -1, -1).clone()
    edge = torch.full((2, N, warps), float("nan"))
    edge[0] = a[:, :, k - 1, 31]
    stack = torch.full((N, T, P), float("nan")) if with_stack else None

    def load(t):
        return torch.where(moving, move[:, t][:, pclamp], NEG)

    ring = {d: (d, load(d)) for d in range(min(depth, T))}
    for t0 in range(0, T, depth):
        for d in range(depth):
            t = t0 + d
            if t >= T:
                break
            held, mv = ring[d]
            assert held == t
            if with_stack:
                stack[:, t][:, pos[inside]] = a[:, inside]
            down = torch.cat([torch.full((N, 1), lattice.NEG),
                              edge[t & 1][:, :-1]], 1)
            # lane 31's hand-on to lane 0: its position of j - 1 (for j =
            # 0 nothing: lane 0 takes the warp below's edge instead)
            src = a.clone()
            src[..., 31] = torch.cat(
                [torch.full((N, warps, 1), lattice.NEG), a[:, :, :-1, 31]],
                2)
            nb = torch.roll(src, 1, dims=3)
            nb[:, :, 0, 0] = down
            moved = torch.where(pos == 0, NEG, nb + mv)
            new = lattice._logaddexp(a + blank, moved)
            a = torch.where(inside, new, a)
            edge[(t + 1) & 1] = a[:, :, k - 1, 31]
            if t + depth < T:
                ring[d] = (t + depth, load(t + depth))
    end = (lengths.long() - 1)[:, None, None, None]
    hit = (pos[None] == end) & inside
    logz = torch.where(hit, a, 0.0).flatten(1).sum(1)
    return stack, logz


@pytest.mark.parametrize("with_stack", [True, False])
@pytest.mark.parametrize("P,T,k,depth", [
    (13, 40, 1, 16), (37, 20, 1, 32), (70, 45, 1, 32), (2, 17, 1, 16),
    (33, 9, 2, 8), (130, 30, 2, 16), (96, 5, 1, 16), (65, 33, 2, 8)])
def test_y_split_emulation_equals_the_plain_version(one_thread, P, T, k,
                                                    depth, with_stack):
    """Y's split at one and two positions a thread, every prefetch depth
    built (T below, at and above it), P within a warp and over several,
    P - 1 no multiple of 4; rows of length 0, 1, P / 2, P, -1 and P + 1 in
    one batch: ``lattice.forward_plain``'s stack and logZ bit for bit,
    with the stack and without it."""
    N = 64
    rng = np.random.default_rng(P + T + k)
    move = torch.from_numpy(
        (2 * rng.normal(size=(N, T, P - 1))).astype(np.float32))
    lengths = torch.from_numpy(rng.integers(P // 2, P + 1, N)
                               .astype(np.int32))
    lengths[:6] = torch.tensor([0, 1, max(P // 2, 1), P, -1, P + 1])
    want_stack, want = lattice.forward_plain(move, lengths, 2.0, with_stack)
    got_stack, got = _emulate_y(move, lengths, 2.0, k, depth, with_stack)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not got[[0, 4, 5]].any()
    if with_stack:
        assert torch.equal(got_stack.view(torch.int32),
                           want_stack.view(torch.int32))


def test_y_split_emulation_matches_bonito_tpu():
    """Y's emulation against bonito_tpu's lattice kernel (interpret mode)
    at one small shape, with rows of length P, P - 1, 1, 0 and -1: logZ
    within f32 rounding, the tolerance of tests/test_torch_loss.py."""
    N, T, P = 8, 24, 13
    rng = np.random.default_rng(5)
    move = rng.normal(size=(N, T, P - 1)).astype(np.float32)
    lengths = np.array([P, P - 1, 5, 1, 0, -1, P, 7], np.int32)
    ref = lattice_pallas.lattice_logZ(jnp.asarray(move), jnp.asarray(lengths),
                                      2.0, interpret=True)
    _, got = _emulate_y(torch.from_numpy(move), torch.from_numpy(lengths),
                        2.0, 1, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=F32_RTOL,
                               atol=F32_ATOL)


# -- X --------------------------------------------------------------------

STATES = (4, 16, 64, 256, 1024)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", STATES)
def test_full_plan_fits_the_card(S, dtype):
    """X's ring: V's k predecessors a thread for the chain's S / k
    consumer threads, more consumer threads for the gradient's pass (whole
    warps, at most 20), a producer warp; rings of 8 frames within the
    card's shared memory, a slot's pieces (the 5S scores, the stack's row)
    whole 16-byte pieces; the forward part W's ring on U's threads; the
    entries the wrappers launch. bf16 at S 4 (rows of 40 B) has no
    plan."""
    plan = logz_cuda.logz_plan(64, 100, S, dtype, SMS, full=True)
    if S == 4 and dtype == torch.bfloat16:
        assert plan is None
        return
    k = plan["states_per_thread"]
    assert k == logz_cuda.STATES_PER_THREAD[S]
    nc = plan["consumer_threads"]
    assert nc == logz_cuda.X_CONSUMERS[S] and nc % 32 == 0
    assert logz_cuda.ring_consumers(S, k) <= nc <= 640
    assert plan["threads"] == nc + 32 <= logz_cuda.X_THREADS
    assert nc == min(384, -(-5 * S // 32) * 32)  # a column a thread, to 384
    assert plan["fwd"] == {
        "ring": logz_cuda.RING, "threads": logz_cuda.ring_consumers(S, k) + 32,
        "smem": logz_cuda.logz_smem(S, logz_cuda.RING, dtype, False,
                                    full=True)}
    assert plan["bwd"]["ring"] == logz_cuda.RING
    assert plan["bwd"]["smem"] == logz_cuda.logz_smem(
        S, logz_cuda.RING, dtype, True, full=True) <= SMEM
    assert (5 * S * dtype.itemsize) % 16 == 0 and (4 * S) % 16 == 0
    assert logz_cuda.logz_entry(plan, True, True) == "logz_full_bwd_ring"
    assert logz_cuda.logz_entry(plan, False, True) == "logz_full_fwd_ring"


def test_full_plan_at_the_training_shapes():
    """hac (N 128, T 1000) and sup (N 32, T 2048) at S 1024, f32 scores as
    ``loss`` casts them: X on 12 consumer warps, the first 8 of four
    predecessors a thread, every one of them in the gradient's pass, and a
    producer warp, one wave, a ring of 8 slots of 24,576 B, 204,864 B in
    all; W on 8 consumer warps of four states a thread and the producer,
    8 slots of 20,480 B, 172,096 B. fast (N 128, T 1200, S 64): X on 10
    consumer warps, the first 2 of one predecessor a thread, 12,864 B; W
    on 2 warps of one state a thread, 10,816 B."""
    for N in (128, 32):
        assert logz_cuda.logz_plan(N, 1000, 1024, torch.float32, SMS,
                                   full=True) == {
            "threads": 416, "consumer_threads": 384, "states_per_thread": 4,
            "ctas": N, "waves": 1,
            "fwd": {"ring": 8, "smem": 172096, "threads": 288},
            "bwd": {"ring": 8, "smem": 204864}}
    assert logz_cuda.logz_plan(128, 1200, 64, torch.float32, SMS,
                               full=True) == {
        "threads": 352, "consumer_threads": 320, "states_per_thread": 1,
        "ctas": 128, "waves": 1,
        "fwd": {"ring": 8, "smem": 10816, "threads": 96},
        "bwd": {"ring": 8, "smem": 12864}}


@pytest.mark.parametrize("S", STATES)
def test_full_plan_sends_the_rest_to_the_earlier_kernel(S):
    """Pointers not 16-byte aligned, in both dtypes: no plan, the earlier
    X's entry and the earlier W's."""
    for dtype in (torch.bfloat16, torch.float32):
        plan = logz_cuda.logz_plan(8, 9, S, dtype, SMS, aligned=False,
                                   full=True)
        assert plan is None
        assert logz_cuda.logz_entry(plan, True, True) == "logz_bwd"
        assert logz_cuda.logz_entry(plan, False, True) == "logz_fwd"


def _max4(x):
    """fmaxf from -inf over the last dim (4), in order."""
    x = x.unbind(-1)
    return torch.maximum(torch.maximum(torch.maximum(x[0], x[1]), x[2]),
                         x[3])


def _sum4(x):
    """0 + x0 + x1 + x2 + x3 over the last dim, in order."""
    x = x.unbind(-1)
    return ((x[0] + x[1]) + x[2]) + x[3]


def _lse2(a, b):
    big = torch.maximum(a, b)
    return big + torch.log(torch.exp(a - big) + torch.exp(b - big))


def _emulate_x(scores, stack, lz, g, round_bf16, out_dtype):
    """X as csrc/logz_ring.cu's ring kernel takes it. Chain consumer i of
    S / k (rounded up to whole warps; those past S / k take thread 0's and
    store nothing) holds predecessors j*R + q, q = i % R, its m-th j = (i /
    R) * k + (m + q / 8) mod k: from the slot, the moves 5(4q + b) + 1 + j
    and the stays 5(j*R + q), the sums over b in order, beta_t into the
    other parity. The gradient: consecutive threads on consecutive columns c of
    the frame's 5S, s = c / 5, the stay (c % 5 = 0) as (alpha_t[s] + stay)
    + beta[s], a move j = c % 5 - 1 as (move + alpha_t[j*R + s/4]) +
    beta[s], exp(e - logZ) * g rounded as the kernel stores it."""
    N, T, W = scores.shape
    S = W // 5
    R = S // 4
    k = logz_cuda.STATES_PER_THREAD[S]
    nc = logz_cuda.ring_consumers(S, k)
    i = torch.arange(nc)
    i = torch.where(i < S // k, i, 0)
    q = i % R
    j = (i // R)[:, None] * k + ((torch.arange(k)[None] + (q[:, None] >> 3))
                                 & (k - 1))               # [th, k]
    pred = j * R + q[:, None]
    b = torch.arange(4)
    mcol = (4 * q[:, None, None] + b[:, None]) * 5 + 1 + j[:, None, :]
    scol = pred * 5                                       # [th, k]
    col = torch.arange(W)
    s, jj = col // 5, col % 5 - 1
    acol = torch.where(jj < 0, s, jj.clamp(min=0) * R + s // 4)
    lz, g = lz[:, None], g.float()[:, None]
    grad = torch.full((N, T, W), float("nan"), dtype=out_dtype)
    beta = torch.zeros(N, S)
    for t in range(T - 1, -1, -1):
        row = scores[:, t].float()
        if round_bf16:
            row = row.to(torch.bfloat16).float()
        al = stack[:, t]
        # the gradient pass over the frame's columns
        e = torch.where(jj < 0, (al[:, acol] + row) + beta[:, s],
                        (row + al[:, acol]) + beta[:, s])
        v = torch.exp(e - lz) * g
        if round_bf16:
            v = v.to(torch.bfloat16).float()
        grad[:, t] = v.to(out_dtype)
        # the chain: each thread's predecessors from its successors 4q + b
        bs = beta[:, 4 * q[:, None] + b]                  # [N, th, b]
        mo = (row[:, mcol] + bs[:, :, :, None]).transpose(2, 3)  # [N,th,k,b]
        mm = _max4(mo)
        ls = mm + torch.log(_sum4(torch.exp(mo - mm[..., None])))
        nxt = torch.empty(N, S)
        nxt[:, pred] = _lse2(row[:, scol] + beta[:, pred], ls)
        beta = nxt
    return grad


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("S,N,T", [(4, 16, 7), (16, 8, 9), (64, 4, 12),
                                   (256, 2, 6), (1024, 2, 4)])
def test_x_ring_emulation_equals_the_plain_version(one_thread, S, N, T,
                                                   round_bf16, out_dtype):
    """At every S, with and without the bf16 rounding, into f32 and bf16:
    X's assignment of predecessors to threads and its pass over columns
    give ``logz.full_backward_plain``'s gradient bit for bit, a zero
    cotangent's row 0."""
    gen = torch.Generator().manual_seed(S + T)
    scores = 3 * torch.randn(N, T, 5 * S, generator=gen)
    cot = torch.linspace(-1.5, 2.0, N)
    cot[0] = 0.0
    stack, lz = logz.full_forward_plain(scores, round_bf16)
    want = logz.full_backward_plain(scores, stack, lz, cot, round_bf16,
                                    out_dtype)
    got = _emulate_x(scores, stack, lz, cot, round_bf16, out_dtype)
    assert got.dtype == want.dtype == out_dtype
    bits = torch.int16 if out_dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
    assert not got[0].float().any()


def test_x_ring_emulation_matches_bonito_tpu(one_thread):
    """X's emulation against the VJP of bonito_tpu's ``logZ_pallas``
    (interpret mode) at one small shape (state_len 3, N 8, T 12): each
    entry within one bf16 step of its magnitude, at least 99% equal, the
    tolerance of tests/test_torch_loss.py."""
    jsd = JaxCRF(3, ALPHABET)
    N, T, S = 8, 12, 64
    rng = np.random.default_rng(11)
    sc = (2 * rng.normal(size=(N, T, 5 * S))).astype(np.float32)
    w = np.linspace(-1.5, 2.0, N).astype(np.float32)
    ref = jax.grad(lambda s: jnp.sum(
        logz_pallas.logZ_pallas(jsd, s, True) * w))(jnp.asarray(sc))
    scores = torch.from_numpy(sc)
    stack, lz = logz.full_forward_plain(scores, True)
    got = _emulate_x(scores, stack, lz, torch.from_numpy(w), True,
                     torch.float32).numpy()
    ref = np.asarray(ref, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    assert np.all(np.abs(got - ref) <= step), np.abs(got - ref).max()
    assert (got == ref).mean() >= MIN_EQUAL
