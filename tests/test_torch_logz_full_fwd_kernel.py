"""The shape rule and thread layout of kernel W on the card (logZ of the
full scores, the forward pass of ``loss``: ``ops.logz_cuda.logz_plan(...,
full=True)["fwd"]``, U's ring over the full scores' slot), checked here on
the CPU: what each launch asks of an H100; that the consumers' reads of a
frame's slot take every state's five ``FullFrame`` columns once and fall
on distinct banks; that W's assignment of states to threads gives
``logz.full_forward_plain``'s stack and logZ bit for bit; and that
emulation against bonito_tpu's Pallas forward in interpret mode. The
kernel itself runs only on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.ops import logz_pallas
from bonito_tpu_torch.ops import logz, logz_cuda

SMS = 132           # an H100's SMs
SMEM = 232448       # the most shared memory a block may ask for
BANKS = 32          # 4-byte banks of an SM's shared memory
STATES = (4, 16, 64, 256, 1024)
ALPHABET = ["N", "A", "C", "G", "T"]
# the tolerances of tests/test_torch_loss.py for f32 values
F32_RTOL, F32_ATOL = 2e-5, 1e-6


@pytest.fixture
def one_thread():
    """torch on one CPU thread, so that each elementwise exp and log takes
    one code path over the whole tensor (its vector loop: every tensor
    below holds a multiple of 64 entries), in the emulation and in the
    plain version alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ks(S):
    """The numbers of states a thread W's C entry takes at S."""
    return [k for k in (1, 4) if logz_cuda.ring_consumers(S, k) + 32
            <= logz_cuda.THREADS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", STATES)
def test_w_plan_fits_the_card(S, dtype):
    """W's part of ``logz_plan(..., full=True)``: U's S / k consumer
    threads (whole warps, k as U's) and a producer warp, within the C
    entry's bound; rings of 8 slots of a frame's 5S scores with alpha's two
    parities and the mbarriers within the card's shared memory, each row a
    whole number of 16-byte pieces; the ring's C entry. bf16 at S 4 (rows
    of 40 B) has no plan."""
    plan = logz_cuda.logz_plan(64, 100, S, dtype, SMS, full=True)
    if S == 4 and dtype == torch.bfloat16:
        assert plan is None
        assert logz_cuda.logz_entry(plan, False, True) == "logz_fwd"
        return
    k = plan["states_per_thread"]
    assert k == logz_cuda.STATES_PER_THREAD[S] and k in _ks(S)
    fwd = plan["fwd"]
    consumers = fwd["threads"] - 32
    assert consumers % 32 == 0 and S // k <= consumers < S // k + 32
    assert fwd["threads"] <= logz_cuda.THREADS
    ring = fwd["ring"]
    assert ring == logz_cuda.RING and 2 <= ring <= 16
    head = (ring * 8 + 15) // 16 * 16
    assert fwd["smem"] == head + 8 * S + ring * 5 * S * dtype.itemsize
    assert fwd["smem"] == logz_cuda.logz_smem(S, ring, dtype, False,
                                              full=True) <= SMEM
    assert (5 * S * dtype.itemsize) % 16 == 0 and head % 16 == 0
    assert logz_cuda.logz_entry(plan, False, True) == "logz_full_fwd_ring"
    assert logz_cuda.logz_entry(plan, False) == "logz_tcn_fwd_ring"


def test_w_plan_at_the_training_shapes():
    """hac (N 128, T 1000) and sup (N 32, T 2048) at S 1024: 8 consumer
    warps of four states a thread and a producer, one wave on 132 SMs, 8
    slots of 20,480 B in f32 (172,096 B in all; 90,176 in bf16); fast (N
    128, T 1200, S 64): 2 warps of one state a thread."""
    for N, T in ((128, 1000), (32, 2048)):
        for dtype, smem in ((torch.float32, 172096),
                            (torch.bfloat16, 90176)):
            plan = logz_cuda.logz_plan(N, T, 1024, dtype, SMS, full=True)
            assert plan["fwd"] == {"ring": 8, "smem": smem, "threads": 288}
            assert plan["states_per_thread"] == 4
            assert (plan["ctas"], plan["waves"]) == (N, 1)
    plan = logz_cuda.logz_plan(128, 1200, 64, torch.float32, SMS, full=True)
    assert plan["fwd"]["threads"] == 96 and plan["states_per_thread"] == 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S", STATES)
def test_w_plan_sends_unaligned_pointers_to_the_earlier_kernel(S, dtype):
    """Pointers not 16-byte aligned: no plan, the earlier W's entry."""
    plan = logz_cuda.logz_plan(8, 9, S, dtype, SMS, aligned=False,
                               full=True)
    assert plan is None
    assert logz_cuda.logz_entry(plan, False, True) == "logz_fwd"


def _threads(S, k):
    """W's consumers (csrc/logz_ring.cu, FullSlot): thread i < S / k takes
    the k states s0 = k*i .. s0 + k-1 of block q = s0 / 4; those past S / k
    (up to whole warps) take thread 0's and store nothing. Returns the
    first states [th], the blocks [th] and whether each thread stores."""
    nc = logz_cuda.ring_consumers(S, k)
    i = torch.arange(nc)
    active = i < S // k
    s0 = k * torch.where(active, i, 0)
    return s0, s0 // 4, active


@pytest.mark.parametrize("S", STATES)
def test_w_slot_reads_take_every_state_once(S):
    """At each k the C entry takes: the active threads' states cover
    0 .. S-1 once; a thread's k states lie in one block q (so that its four
    predecessors j*R + q serve all of them); its read of a frame's slot, 5k
    consecutive scores from 5 s0, takes each of its states' stay at column
    5s and move from slot j at 5s + 1 + j (``FullFrame``), so every
    column of the frame is read once."""
    R = S // 4
    for k in _ks(S):
        s0, q, active = _threads(S, k)
        own = (s0[active, None] + torch.arange(k)).flatten()
        assert sorted(own.tolist()) == list(range(S))
        states = s0[:, None] + torch.arange(k)
        assert bool((states // 4 == q[:, None]).all())
        read = (5 * s0[active, None] + torch.arange(5 * k)).reshape(-1, k, 5)
        st = states[active]
        assert torch.equal(read[..., 0], 5 * st)
        for j in range(4):
            assert torch.equal(read[..., 1 + j], 5 * st + 1 + j)
            # the predecessor of state s from slot j: j*R + s/4
            assert bool(((j * R + q[active, None]) == j * R + st // 4).all())
        assert sorted(read.flatten().tolist()) == list(range(5 * S))


def _bank_conflicts(addresses, bytes_each):
    """The most distinct 4-byte words of one bank that one phase of a
    warp's loads takes (1: conflict-free). A load of 16 bytes goes in
    phases of 8 threads, 4 bytes of 32; a word read by several threads is
    one access (broadcast)."""
    per_phase = 128 // max(bytes_each, 4)
    worst = 1
    for p in range(0, len(addresses), per_phase):
        words = set()
        for a in addresses[p:p + per_phase]:
            words.update(range(a // 4, (a + bytes_each + 3) // 4))
        banks = {}
        for w in words:
            banks.setdefault(w % BANKS, set()).add(w)
        worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("S", STATES)
def test_w_slot_and_alpha_reads_are_conflict_free(S):
    """Each warp's reads of a frame's slot in f32 (at k 4 five 16-byte
    loads at byte 80i + 16m, at k 1 five words at 5i + m) and its reads of
    alpha (the predecessors j*R + q, its own k values at s0) take no bank
    twice."""
    R = S // 4
    for k in _ks(S):
        s0, q, _ = _threads(S, k)
        for w in range(0, len(s0), 32):
            sw, qw = s0[w:w + 32].tolist(), q[w:w + 32].tolist()
            for m in range(5):
                if k == 4:
                    assert _bank_conflicts([20 * s + 16 * m for s in sw],
                                           16) == 1
                else:
                    assert _bank_conflicts([4 * (5 * s + m) for s in sw],
                                           4) == 1
            for j in range(4):
                assert _bank_conflicts([4 * (j * R + b) for b in qw], 4) == 1
            assert _bank_conflicts([4 * s for s in sw], 4 * k) == 1


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


def _warp_tree_sum(x):
    """The sum over states of the ring's epilogue: consumer warp 0 reads
    run k's 32 states in its lanes (zeros past S), takes their xor
    butterfly (16, 8, 4, 2, 1), lane k keeps run k's sum, and the runs'
    sums go through the butterfly again (zeros past the last run)."""
    N, S = x.shape
    runs = -(-S // 32)
    u = torch.zeros(N, runs * 32)
    u[:, :S] = x
    u = u.reshape(N, runs, 32)
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        u = u + u[..., lanes ^ o]
    v = torch.zeros(N, 32)
    v[:, :runs] = u[..., 0]
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def _emulate_w(scores, k, round_bf16):
    """W as csrc/logz_ring.cu's consumers take it, k states a thread: each
    thread reads its 5k consecutive scores of the frame's row (rounded to
    bf16 with ``round_bf16``), its states' moves into s from slot j plus
    alpha[j*R + q], their max, the sum of exps over j in order, then
    lse2(stay + alpha[s], m + log(sum)) into the other parity; the stack
    is alpha before each frame; logZ in the epilogue's tree."""
    N, T, W = scores.shape
    S = W // 5
    R = S // 4
    s0, q, _ = _threads(S, k)
    own = s0[:, None] + torch.arange(k)                   # [th, k]
    pred = torch.arange(4)[None] * R + q[:, None]         # [th, 4]
    cols = own[..., None] * 5 + torch.arange(5)           # [th, k, 5]
    alpha = torch.zeros(N, S)
    stack = torch.empty(N, T, S)
    for t in range(T):
        stack[:, t] = alpha
        row = scores[:, t].float()
        if round_bf16:
            row = row.to(torch.bfloat16).float()
        x = row[:, cols]                                  # [N, th, k, 5]
        cand = x[..., 1:] + alpha[:, pred][:, :, None, :]
        m = _max4(cand)
        move_in = m + torch.log(_sum4(torch.exp(cand - m[..., None])))
        nxt = torch.empty(N, S)
        nxt[:, own] = _lse2(x[..., 0] + alpha[:, own], move_in)
        alpha = nxt
    mx = alpha.amax(1)
    return stack, mx + torch.log(_warp_tree_sum(torch.exp(alpha
                                                          - mx[:, None])))


@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("S,N,T", [(4, 16, 7), (16, 8, 9), (64, 4, 12),
                                   (256, 2, 6), (1024, 2, 4)])
def test_w_ring_emulation_equals_the_plain_version(one_thread, S, N, T,
                                                   round_bf16):
    """At every S and every k the C entry takes, with and without the bf16
    rounding: W's assignment of states to threads, its reads of the slot
    and its epilogue's sum give ``logz.full_forward_plain``'s stack and
    logZ bit for bit, and the same logZ without the stack."""
    gen = torch.Generator().manual_seed(S + T)
    scores = 3 * torch.randn(N, T, 5 * S, generator=gen)
    stack, lz = logz.full_forward_plain(scores, round_bf16)
    _, lz_only = logz.full_forward_plain(scores, round_bf16,
                                         with_stack=False)
    assert torch.equal(lz.view(torch.int32), lz_only.view(torch.int32))
    for k in _ks(S):
        e_stack, e_lz = _emulate_w(scores, k, round_bf16)
        assert torch.equal(e_stack.view(torch.int32),
                           stack.view(torch.int32)), k
        assert torch.equal(e_lz.view(torch.int32), lz.view(torch.int32)), k


def test_w_ring_emulation_matches_bonito_tpu(one_thread):
    """W's emulation against bonito_tpu's ``_run_fwd`` (the Pallas forward
    behind ``logZ_pallas``, interpret mode) at one small shape (state_len
    3, N 8, T 12): the alpha stack and logZ within the f32 tolerances of
    tests/test_torch_loss.py, and the forward-only kernel's logZ."""
    jsd = JaxCRF(3, ALPHABET)
    N, T, S = 8, 12, 64
    rng = np.random.default_rng(12)
    sc = (2 * rng.normal(size=(N, T, 5 * S))).astype(np.float32)
    split = logz_pallas._split(jsd, jnp.asarray(sc))
    alpha, ref_lz = logz_pallas._run_fwd(jsd, *split, True)
    _, ref_only = logz_pallas._run_fwd(jsd, *split, True, with_ckpt=False)
    ref_stack = np.asarray(alpha, np.float32).transpose(2, 0, 1)
    for k in _ks(S):
        stack, lz = _emulate_w(torch.from_numpy(sc), k, True)
        np.testing.assert_allclose(stack.numpy(), ref_stack, rtol=F32_RTOL,
                                   atol=F32_ATOL)
        np.testing.assert_allclose(lz.numpy(), np.asarray(ref_lz),
                                   rtol=F32_RTOL, atol=F32_ATOL)
        np.testing.assert_allclose(lz.numpy(), np.asarray(ref_only),
                                   rtol=F32_RTOL, atol=F32_ATOL)
