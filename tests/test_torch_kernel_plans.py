"""The pure-Python shape rules of kernels A, R, S, L, D, E, K, H, O, B
and C (``ops.lstm_cuda.persistent_plan``, ``ops.lstm_train_cuda.
forward_plan`` and ``backward_plan``, ``ops.attention_cuda.
padded_head_dim``, ``ops.lstm_int8_cuda.persistent_plan``, ``ops.
attention_cuda.window_plan`` and ``window_bwd_plan``, ``ops.decode_cuda.
decode_plan``): what each launch asks of the card,
that A's, S's, D's and E's CTAs cover every row, unit and gate column
once, that K's stretches cover every query tile once with its band in the
ring, that O's two kinds cover every query tile and every key tile once
with their bands (the dk kind's mirrored) in their rings, that B's and
C's ring hands each frame over once, in order, and sums the states in
``block_sum``'s tree, that M's and Q's (``ops.decode_full_cuda.
decode_full_plan``) fits and copies each frame of either strand once, with
the reverse strand's states kept in the forward strand's order, that the
f32 ring of GW and JW (``decode_plan`` with f32 moves) fits, that GW's
head product (``ops.decode_fused_cuda.product_plan``) fits and its
persistent CTAs cover every output tile once, that U's
and V's (``ops.logz_cuda.logz_plan``) fits, covers every state once,
copies each frame once in its pass's order and, emulated here state by
state in the kernels' order, computes ``ops.logz``'s plain versions bit
for bit, and the head dim L's bf16 instance runs at; that A's f32
persistent kernel (``ops.lstm_cuda.f32_plan``) fits, gives None where
W_hh's f32 slice cannot be held, and its CTAs, warps and chunks cover
every row, unit and k once, and that F's f32 kernel (``ops.
lstm_fused_cuda.f32_plan``) fills the card and fits, and that S's f32
persistent kernel (``ops.lstm_train_cuda.f32_backward_plan``) fits, gives
None where W_hh's 8 f32 rows cannot be held, and its CTAs, warps and lanes
cover every row, unit and k once. Each is what the
wrapper passes to its kernel. They run here, on the CPU; the kernels
themselves, and L's tiling, which is fixed in the kernel, only on the card
(tests/test_torch_gpu.py)."""

import pytest
import torch

from bonito_tpu_torch.ops import (attention_cuda, decode_cuda,
                                  decode_full_cuda, decode_fused_cuda, logz,
                                  logz_cuda, lstm_cuda, lstm_fused_cuda,
                                  lstm_int8_cuda, lstm_train_cuda)

SMS = 132             # an H100's SMs
SMEM = 232448         # the most shared memory a block may ask for
# CTAs of S's persistent kernel an H100 holds at once in clusters of 1 and
# 2 (ops.lstm_train_cuda.resident_ctas on the card: the occupancy API's
# clusters times their size)
RESIDENT = {1: 132, 2: 132}

# (N, H): hac (N 96, H 1024), fast's width through projection + A (N
# 1024, H 96), the GPU tests' shapes, more rows than one grid holds, and an
# H whose W_hh slice leaves only 16-row slices
A_SHAPES = [(96, 1024), (1024, 96), (8, 16), (40, 64), (96, 128), (200, 1024),
            (1, 96), (300, 1024), (2000, 256), (96, 1536), (33, 1024)]


@pytest.mark.parametrize("N,H", A_SHAPES)
def test_persistent_plan_fits_the_card(N, H):
    plan = lstm_cuda.persistent_plan(N, H, SMS)
    assert plan is not None
    assert plan["smem"] <= SMEM
    assert plan["smem"] == lstm_cuda.smem_bytes(
        H, plan["rows"], plan["kc"], plan["stages"], plan["cluster"])
    # two CTAs share h only where the ring holds a whole step's chunks and
    # the unit blocks pair up
    assert plan["cluster"] == (2 if H // 16 % 2 == 0
                               and plan["stages"] == H // plan["kc"] else 1)
    assert plan["ctas"] == plan["unit_blocks"] * plan["slices"] <= SMS
    assert plan["units"] == 16
    assert plan["rows"] in (16, 32, 48, 64)
    assert H % plan["kc"] == 0 and plan["kc"] % 16 == 0
    assert plan["kc"] <= 512 and (H // plan["kc"] >= 2 or H == 16)
    assert 2 <= plan["stages"] <= max(2, min(8, H // plan["kc"]))


@pytest.mark.parametrize("N,H", A_SHAPES)
def test_persistent_plan_covers_every_row_and_unit_once(N, H):
    """The wrapper's launches (row groups of n_launch rows), each CTA's
    slice of rows and block of 16 units: every (row, unit) exactly once."""
    plan = lstm_cuda.persistent_plan(N, H, SMS)
    starts = list(range(0, N, plan["n_launch"]))
    assert len(starts) == plan["launches"]
    assert plan["unit_blocks"] * plan["units"] == H
    owner = {}
    for n0 in starts:
        rows = min(plan["n_launch"], N - n0)
        assert plan["slices"] * plan["rows"] >= rows
        for cta in range(plan["ctas"]):  # as csrc/lstm.cu's blockIdx.x
            slice_, block = divmod(cta, plan["unit_blocks"])
            for r in range(plan["rows"]):
                row = slice_ * plan["rows"] + r
                if row >= rows:  # a padding row: computed, never written
                    continue
                for u in range(plan["units"]):
                    key = (n0 + row, block * plan["units"] + u)
                    owner[key] = owner.get(key, 0) + 1
    assert sorted(owner) == [(n, u) for n in range(N) for u in range(H)]
    assert set(owner.values()) == {1}


def test_persistent_plan_at_hac():
    """hac (N 96, H 1024): one launch of 64 unit blocks x 2 slices of 48
    rows, W_hh's 132 KB slice beside both of a step's 512-wide k-chunks,
    neighbouring unit blocks sharing h in clusters of two."""
    plan = lstm_cuda.persistent_plan(96, 1024, SMS)
    assert (plan["unit_blocks"], plan["slices"], plan["rows"]) == (64, 2, 48)
    assert (plan["launches"], plan["ctas"], plan["kc"], plan["stages"],
            plan["cluster"]) == (1, 128, 512, 2, 2)
    assert plan["smem"] == 64 * 1032 * 2 + 2 * 48 * 520 * 2 + 16 == 231952


@pytest.mark.parametrize("N,H,launches", [(200, 1024, 2), (300, 1024, 3),
                                          (2000, 1024, 16), (96, 1536, 6),
                                          (2000, 256, 4)])
def test_persistent_plan_row_groups(N, H, launches):
    assert lstm_cuda.persistent_plan(N, H, SMS)["launches"] == launches


@pytest.mark.parametrize("N,H", [(8, 2048), (96, 2048), (8, 4096)])
def test_persistent_plan_sends_wide_h_to_the_step_kernel(N, H):
    """W_hh's slice does not fit (H 2048: 263 KB), or H / 16 CTAs exceed the
    SMs (H 4096): no plan, and the wrapper takes the step kernel."""
    assert lstm_cuda.persistent_plan(N, H, SMS) is None


def test_persistent_plan_follows_the_card():
    """Fewer SMs, fewer slices a launch; a card too small for H / 16 CTAs
    takes the step kernel."""
    plan = lstm_cuda.persistent_plan(96, 1024, 66)
    assert plan["ctas"] <= 66 and plan["launches"] == 2
    assert lstm_cuda.persistent_plan(96, 1024, 63) is None


@pytest.mark.parametrize("N,H", [(0, 1024), (8, 24), (8, 8)])
def test_persistent_plan_rejects_what_a_does_not_take(N, H):
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_cuda.persistent_plan(N, H, SMS)


@pytest.mark.parametrize("D", range(8, 129, 8))
def test_padded_head_dim(D):
    """The least padded dim the kernel is built for that holds D: heads of
    40 (the shallow transformer's) become 48, sup's 64 stay 64."""
    dp = attention_cuda.padded_head_dim(D)
    assert dp in attention_cuda.L_PADDED and dp % 16 == 0 and D <= dp
    assert all(p < D for p in attention_cuda.L_PADDED if p < dp)
    assert dp == {40: 48, 64: 64}.get(D, dp)


# ---------------------------------------------------------------------------
# kernels R and S: the train step's recurrence and its BPTT
# ---------------------------------------------------------------------------

# (N, H): hac training (N 128, H 1024) and fast's (N 128, H 96) at the
# batches below, small H, more rows than one grid holds, and a width whose
# hac-like grid takes 4 slices
S_SHAPES = [(n, h) for h in (1024, 96) for n in (1, 32, 96, 128, 256)] + [
    (8, 32), (40, 64), (200, 1024), (128, 512)]


def test_forward_plan_is_a_plan_at_hac_training():
    """R runs kernel A's kernel with its stores at A's plan: at hac training
    (N 128, H 1024) 64 unit blocks x 2 slices of 64 rows, chunks 256 wide
    in 2 stages without a cluster (64 rows of 512-wide chunks do not fit
    beside W_hh's slice), 205,824 bytes."""
    plan = lstm_train_cuda.forward_plan(128, 1024, SMS)
    assert plan == lstm_cuda.persistent_plan(128, 1024, SMS)
    assert (plan["unit_blocks"], plan["slices"], plan["rows"]) == (64, 2, 64)
    assert (plan["launches"], plan["ctas"], plan["kc"], plan["stages"],
            plan["cluster"]) == (1, 128, 256, 2, 1)
    assert plan["smem"] == 64 * 1032 * 2 + 4 * 64 * 72 * 4 == 205824


@pytest.mark.parametrize("dtype,round_bf16", [(torch.float32, True),
                                              (torch.float32, False),
                                              (torch.bfloat16, False)])
def test_train_plans_send_f32_to_the_step_kernels(dtype, round_bf16):
    """An f32 model runs R on kernel A's f32 plan (``lstm_cuda.f32_plan``)
    and S on its own f32 plan (``f32_backward_plan``), c, the gates and
    their gradient stored in bf16 or f32 alike; a bf16 model that stores
    them in f32 takes the step kernels."""
    fplan = lstm_train_cuda.forward_plan(128, 1024, SMS, dtype, round_bf16)
    bplan = lstm_train_cuda.backward_plan(128, 1024, SMS, RESIDENT, dtype,
                                          round_bf16)
    if dtype == torch.bfloat16:
        assert fplan is None and bplan is None
        return
    assert fplan == lstm_cuda.f32_plan(128, 1024, SMS)
    assert bplan is not None
    assert bplan == lstm_train_cuda.f32_backward_plan(128, 1024, SMS,
                                                      round_bf16)


@pytest.mark.parametrize("N,H", [(128, 1536), (128, 2048), (8, 4096),
                                 (8, 16), (40, 48)])
def test_backward_plan_sends_other_widths_to_the_step_kernel(N, H):
    """W_hh's block is held in registers, H / 8 a thread: H above 1024
    takes the step kernel (and H / 16 CTAs beyond the SMs at H 4096), as
    does an H whose 4H / cluster columns do not split into the 8 warps'
    k-slices of whole 16-column k-steps for any cluster that divides H /
    16 (H 16, 48)."""
    assert lstm_train_cuda.backward_plan(N, H, SMS, RESIDENT) is None


@pytest.mark.parametrize("N,H", S_SHAPES)
def test_backward_plan_fits_the_card(N, H):
    plan = lstm_train_cuda.backward_plan(N, H, SMS, RESIDENT)
    assert plan is not None
    assert plan["smem"] <= SMEM
    assert plan["smem"] == lstm_train_cuda.backward_smem(
        H, plan["rows"], plan["cluster"], plan["stages"])
    c = plan["cluster"]
    assert c in lstm_train_cuda.CLUSTERS and plan["unit_blocks"] % c == 0
    assert plan["ctas"] == plan["unit_blocks"] * plan["slices"]
    assert plan["ctas"] <= min(SMS, RESIDENT[c])  # every CTA resident
    assert plan["units"] == 16 and plan["rows"] in (16, 32, 48, 64)
    # the 8 warps' k-slices of whole k-steps; W_hh's block in registers:
    # c m-tiles x the k-steps of a k-slice x 4 registers = H / 8 a thread
    assert plan["k_cols"] == 4 * H // c and plan["k_cols"] % (8 * 16) == 0
    assert c * (plan["k_cols"] // 8 // 16) * 4 == H // 8 <= 128
    n_chunks = plan["rows"] // plan["chunk_rows"]
    assert plan["chunk_rows"] == (16 if plan["rows"] >= 32 else 8)
    assert n_chunks % plan["stages"] == 0 and 2 <= plan["stages"] <= 4


@pytest.mark.parametrize("N,H", S_SHAPES)
def test_backward_plan_covers_every_row_unit_and_gate_column_once(N, H):
    """The wrapper's launches, each CTA's slice of rows, the 16 units it
    owns (dgates, dc) and its share of the product (its cluster's units
    over its rank's gate columns): every (row, unit) owned once, and every
    (row, unit, gate column) term of dh = dgates @ W_hh^T summed once."""
    plan = lstm_train_cuda.backward_plan(N, H, SMS, RESIDENT)
    starts = list(range(0, N, plan["n_launch"]))
    assert len(starts) == plan["launches"]
    c, k_cols, g_u = plan["cluster"], plan["k_cols"], plan["unit_blocks"]
    assert g_u * plan["units"] == H
    owner, terms = {}, {}
    for n0 in starts:
        rows = min(plan["n_launch"], N - n0)
        assert plan["slices"] * plan["rows"] >= rows
        for cta in range(plan["ctas"]):  # as csrc/lstm_train.cu's blockIdx.x
            slice_, block = divmod(cta, g_u)
            rank = block % c                 # clusters of c neighbours
            first = (block - rank) * 16      # the cluster's first unit
            for r in range(plan["rows"]):
                row = slice_ * plan["rows"] + r
                if row >= rows:  # a padding row: computed, never written
                    continue
                for u in range(16):
                    key = (n0 + row, block * 16 + u)
                    owner[key] = owner.get(key, 0) + 1
                for u in range(first, first + 16 * c):
                    key = (n0 + row, u)
                    terms.setdefault(key, []).append(
                        (rank * k_cols, (rank + 1) * k_cols))
    assert sorted(owner) == [(n, u) for n in range(N) for u in range(H)]
    assert set(owner.values()) == {1}
    assert sorted(terms) == sorted(owner)
    for spans in terms.values():
        assert sorted(spans) == [(k, k + k_cols) for k in range(0, 4 * H,
                                                                 k_cols)]


def test_backward_plan_at_hac_training():
    """hac training (N 128, H 1024) on an H100: 2 slices of 64 rows, 128
    CTAs in clusters of 2. Each CTA's warps hold the 32 units x 2048 gate columns of W_hh
    that are its (128 KB, 128 registers a thread); it reads its rows' 2048
    columns of dgates a step, 16 rows (a 4 KB copy each) a slot through a
    ring of 2; one launch."""
    plan = lstm_train_cuda.backward_plan(128, 1024, SMS, RESIDENT)
    assert (plan["cluster"], plan["rows"], plan["slices"]) == (2, 64, 2)
    assert (plan["launches"], plan["ctas"], plan["k_cols"],
            plan["chunk_rows"], plan["stages"]) == (1, 128, 2048, 16, 2)
    assert plan["smem"] == (2 * 16 * 2056 * 2 + 8 * 64 * 36 * 4
                            + 2 * 64 * 16 * 4 + 16 * 2) == 213536


def test_backward_plan_follows_the_card():
    """A card that holds no clusters of 2 runs hac training in clusters of
    one, each CTA with all 4096 columns: its ring fits only 16 rows a CTA,
    four launches; one that holds fewer than 128 CTAs in clusters of 2
    takes two launches (still fewer than four); fewer SMs than H / 16
    CTAs: the step kernel."""
    plan = lstm_train_cuda.backward_plan(128, 1024, SMS, {1: 132, 2: 0})
    assert (plan["cluster"], plan["launches"], plan["rows"],
            plan["k_cols"]) == (1, 4, 16, 4096)
    plan = lstm_train_cuda.backward_plan(128, 1024, SMS, {1: 132, 2: 120})
    assert (plan["cluster"], plan["launches"]) == (2, 2)
    assert lstm_train_cuda.backward_plan(128, 1024, 63, RESIDENT) is None


@pytest.mark.parametrize("N,H", [(0, 1024), (8, 24)])
def test_train_plans_reject_what_r_and_s_do_not_take(N, H):
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_train_cuda.forward_plan(N, H, SMS)
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_train_cuda.backward_plan(N, H, SMS, RESIDENT)



# ---------------------------------------------------------------------------
# kernels D and E: the int8 LSTM layer and its recurrence
# ---------------------------------------------------------------------------

# (N, C, H): hac (N 96, C = H = 1024), the card tests' shapes, odd N, a
# narrow input, more rows than one grid holds, and H 2048 (W_hh_q's slice
# leaves no room for a ring of the whole step)
D_SHAPES = [(96, 1024, 1024), (37, 64, 64), (5, 96, 32), (19, 992, 160),
            (61, 512, 1024), (128, 128, 1024), (200, 1024, 1024),
            (1, 32, 32), (2000, 256, 256), (64, 1024, 2048)]


def _int8_plan(N, C, H, fused, sms=SMS):
    return lstm_int8_cuda.persistent_plan(N, C if fused else None, H, sms,
                                          fused=fused)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("N,C,H", D_SHAPES)
def test_int8_plan_fits_the_card(N, C, H, fused):
    plan = _int8_plan(N, C, H, fused)
    assert plan is not None
    assert plan["smem"] <= SMEM
    assert plan["smem"] == lstm_int8_cuda.smem_bytes(
        C if fused else 0, H, plan["rows"], plan["kc"], plan["stages"], fused)
    assert plan["ctas"] == plan["unit_blocks"] * plan["slices"] <= SMS
    assert plan["units"] == 16 and plan["rows"] in (16, 32, 48, 64)
    # the k-chunks are whole int8 products; pairs share h only where the
    # ring holds a whole step, each CTA loads its own through 2+ stages
    # otherwise
    kc = plan["kc"]
    assert H % kc == 0 and kc % 32 == 0 and kc <= 1024
    if plan["cluster"] == 2:
        assert plan["unit_blocks"] % 2 == 0 and plan["stages"] == H // kc
    else:
        assert plan["cluster"] == 1 and 2 <= plan["stages"] <= 8
    # D stages x's rows of one step beside the x product's partial sums
    assert plan["x_bytes"] == (plan["rows"] * (C + 16)
                               + 4 * plan["rows"] * 72 * 4 if fused else 0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("N,C,H", D_SHAPES)
def test_int8_plan_covers_every_row_and_unit_once(N, C, H, fused):
    """The wrapper's launches (row groups of n_launch rows), each CTA's
    slice of rows and block of 16 units (csrc/lstm_int8.cu's blockIdx.x):
    every (row, unit) exactly once; a cluster's two CTAs share a slice."""
    plan = _int8_plan(N, C, H, fused)
    starts = list(range(0, N, plan["n_launch"]))
    assert len(starts) == plan["launches"]
    assert plan["unit_blocks"] * plan["units"] == H
    owner = {}
    for n0 in starts:
        rows = min(plan["n_launch"], N - n0)
        # every slice has a row of the batch (the kernel's live rows)
        assert (plan["slices"] - 1) * plan["rows"] < rows
        assert plan["slices"] * plan["rows"] >= rows
        for cta in range(plan["ctas"]):
            slice_, block = divmod(cta, plan["unit_blocks"])
            if plan["cluster"] == 2:  # the peer: the same slice
                assert divmod(cta ^ 1, plan["unit_blocks"])[0] == slice_
            for r in range(plan["rows"]):
                row = slice_ * plan["rows"] + r
                if row >= rows:  # a padding row: computed, never written
                    continue
                for u in range(plan["units"]):
                    key = (n0 + row, block * plan["units"] + u)
                    owner[key] = owner.get(key, 0) + 1
    assert sorted(owner) == [(n, u) for n in range(N) for u in range(H)]
    assert set(owner.values()) == {1}


def test_int8_plan_at_hac():
    """hac (N 96, C = H = 1024) on an H100: one launch of 64 unit blocks x
    2 slices of 48 rows, in pairs that share each load of h (and in D of
    x), h in one 1024-byte chunk a row. D: W_hh_q's slice (64 x 1040), the
    ring under the h partial sums (4 x 48 x 72 int32), x's rows (48 x 1040)
    and their partial sums, two mbarriers; E without x's region."""
    d = lstm_int8_cuda.persistent_plan(96, 1024, 1024, SMS)
    e = lstm_int8_cuda.persistent_plan(96, None, 1024, SMS, fused=False)
    for plan in (d, e):
        assert (plan["unit_blocks"], plan["slices"], plan["rows"]) == (64, 2,
                                                                      48)
        assert (plan["launches"], plan["ctas"], plan["cluster"], plan["kc"],
                plan["stages"]) == (1, 128, 2, 1024, 1)
    assert d["smem"] == 66560 + 55296 + (49920 + 55296) + 16 == 227088
    assert e["smem"] == 66560 + 55296 + 8 == 121864


@pytest.mark.parametrize("N,C,H,fused,launches", [
    (200, 1024, 1024, True, 3), (200, 1024, 1024, False, 2),
    (128, 1024, 1024, True, 2), (128, 128, 1024, True, 1),
    (2000, 256, 256, True, 4)])
def test_int8_plan_row_groups(N, C, H, fused, launches):
    """D's x region takes 48-row slices at C 1024 where E's fit 64."""
    assert _int8_plan(N, C, H, fused)["launches"] == launches


@pytest.mark.parametrize("N,C,H,fused", [
    (8, 2048, 1024, True),      # W_ih_q's slice beyond the registers
    (8, 1024, 4096, True),      # H / 16 CTAs beyond the SMs
    (8, None, 4096, False),
    (8, 48, 64, True),          # C not a multiple of 32
    (8, 64, 48, True),          # H not a multiple of 32
    (8, None, 528, False)])
def test_int8_plan_sends_the_rest_to_the_step_kernel(N, C, H, fused):
    assert lstm_int8_cuda.persistent_plan(N, C, H, SMS, fused=fused) is None


def test_int8_plan_follows_the_card():
    """Fewer SMs, fewer slices a launch; a card too small for H / 16 CTAs
    takes the step kernel."""
    plan = lstm_int8_cuda.persistent_plan(96, 1024, 1024, 66)
    assert plan["ctas"] <= 66 and plan["launches"] == 2
    assert lstm_int8_cuda.persistent_plan(96, 1024, 1024, 63) is None
    plan = lstm_int8_cuda.persistent_plan(96, None, 1024, 100, fused=False)
    assert plan["ctas"] == 64 and plan["launches"] == 2


@pytest.mark.parametrize("N,C,H,fused", [(0, 1024, 1024, True),
                                         (8, 24, 64, True), (8, 64, 24, True),
                                         (8, None, 64, True),
                                         (8, None, 8, False)])
def test_int8_plan_rejects_what_d_and_e_do_not_take(N, C, H, fused):
    with pytest.raises(ValueError, match="multiples of 16"):
        lstm_int8_cuda.persistent_plan(N, C, H, SMS, fused=fused)


# ---------------------------------------------------------------------------
# kernels K and H: the stretch kernel's plan
# ---------------------------------------------------------------------------

SUP_WINDOW = (127, 128)
# (N, T, H, D, window, t_real): sup inference (N 128, T 1000, 8 heads of
# 64), sup training (N 32, T 1024 and 1000, t_real 1000), heads of 32 and
# 128, the GPU tests' shapes (ragged T, small windows, one token)
K_SHAPES = [(128, 1000, 8, 64, SUP_WINDOW, None),
            (32, 1024, 8, 64, SUP_WINDOW, None),
            (32, 1000, 8, 64, SUP_WINDOW, None),
            (32, 1024, 8, 64, SUP_WINDOW, 1000),
            (16, 1000, 8, 64, SUP_WINDOW, None),
            (8, 1024, 8, 64, SUP_WINDOW, 1000),
            (32, 1024, 8, 32, SUP_WINDOW, None),
            (32, 1024, 8, 128, SUP_WINDOW, None),
            (2, 257, 1, 128, SUP_WINDOW, None),
            (3, 200, 4, 16, (63, 64), None),
            (2, 300, 2, 32, (100, 20), 250),
            (2, 100, 3, 40, (5, 0), 77),
            (2, 130, 2, 24, (0, 128), None),
            (1, 1, 1, 16, SUP_WINDOW, None)]


def _plan(N, T, H, D, window, sms=SMS, dtype=torch.bfloat16):
    return attention_cuda.window_plan(N, T, H, D, window, dtype, sms)


# K and H take the stretch kernel on bf16 and f32 qkv alike (the ring
# keeps bf16 rows either way): each plan test runs for both


def _stretch_steps(plan, t_a, T, live, back=None, ahead=None):
    """What the kernel's producers stage for the stretch from tile t_a, as
    ``csrc/attention_window.cu`` (and ``attention_window_bwd.cu``) computes
    it: for each step, the tile and the ring blocks it adds (the leading
    window first, then one block); blocks hold data below ``live``."""
    back = plan["back"] if back is None else back
    ahead = plan["ahead"] if ahead is None else ahead
    n_tiles = -(-T // 64)
    nb = -(-live // 64)
    steps = min(plan["stretch"], n_tiles - t_a)
    for s in range(steps):
        t = t_a + s
        lo = max(t - back if s == 0 else t + ahead, 0)
        yield t, range(lo, min(t + ahead, nb - 1) + 1)


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_fits_the_card(N, T, H, D, window, t_real):
    _fits(N, T, H, D, window, torch.bfloat16)


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_fits_the_card_in_f32(N, T, H, D, window, t_real):
    _fits(N, T, H, D, window, torch.float32)


def _fits(N, T, H, D, window, dtype):
    plan = _plan(N, T, H, D, window, dtype=dtype)
    assert plan is not None
    assert plan["dtype"] == attention_cuda.WINDOW_DTYPES[dtype]
    # f32 changes nothing of the plan but its dtype: the same ring of bf16
    # rows, the same shared memory and CTAs
    assert {**plan, "dtype": "bf16"} == _plan(N, T, H, D, window)
    assert plan["smem"] == attention_cuda.window_smem(plan["ring"],
                                                      plan["head_dim"])
    assert plan["smem"] <= SMEM
    assert plan["resident"] * (plan["smem"] + 1024) <= attention_cuda.SM_SMEM
    assert D <= plan["head_dim"] in (32, 64, 128)
    left, right = window
    assert plan["back"] == -(-left // 64)
    assert plan["ahead"] == (63 + right) // 64
    assert plan["ring"] == plan["back"] + plan["ahead"] + 2 <= 6
    assert plan["ctas"] == N * H * plan["stretches"]
    assert plan["stretches"] == -(-plan["tiles"] // plan["stretch"])
    assert plan["waves"] == -(-plan["ctas"] // (SMS * plan["resident"]))


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_covers_every_tile_once(N, T, H, D, window, t_real):
    """Each (n, h)'s stretches (one CTA each, as the kernel numbers them)
    cover its query tiles 0 .. ceil(T / 64) - 1 exactly once."""
    _covers(N, T, H, D, window, t_real, torch.bfloat16)


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_covers_every_tile_once_in_f32(N, T, H, D, window,
                                                   t_real):
    _covers(N, T, H, D, window, t_real, torch.float32)


def _covers(N, T, H, D, window, t_real, dtype):
    plan = _plan(N, T, H, D, window, dtype=dtype)
    n_tiles = -(-T // 64)
    seen = [0] * n_tiles
    for st in range(plan["stretches"]):
        for t, _ in _stretch_steps(plan, st * plan["stretch"], T,
                                   t_real or T):
            seen[t] += 1
    assert seen == [1] * n_tiles


@pytest.mark.parametrize("rotary_dim", [None, "half"])
@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_keeps_each_band_in_the_ring(N, T, H, D, window, t_real,
                                                 rotary_dim):
    """Walk every stretch as the kernel does: when tile t is computed,
    every key of its band (-left <= j - i <= right, j < t_real) is in the
    ring (its block staged and not overwritten since), and a block the
    producers stage overwrites nothing that the tile before (which the
    consumers may still read) or a later one needs. The rotary dim (all of
    D or half of it) changes nothing of the plan."""
    _band_in_ring(N, T, H, D, window, t_real, torch.bfloat16)


@pytest.mark.parametrize("rotary_dim", [None, "half"])
@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_plan_keeps_each_band_in_the_ring_in_f32(N, T, H, D, window,
                                                        t_real, rotary_dim):
    _band_in_ring(N, T, H, D, window, t_real, torch.float32)


def _band_in_ring(N, T, H, D, window, t_real, dtype):
    left, right = window
    t_real = t_real or T
    plan = _plan(N, T, H, D, window, dtype=dtype)
    # rotary_dim is not an input
    assert plan == _plan(N, T, H, D, window, dtype=dtype)
    ring = plan["ring"]
    for st in range(plan["stretches"]):
        slots = [None] * ring  # the block each slot holds
        steps = list(_stretch_steps(plan, st * plan["stretch"], T, t_real))
        for s, (t, blocks) in enumerate(steps):
            for b in blocks:
                old = slots[b % ring]
                # the consumers of tiles t - 1 and later must not need it
                if old is not None:
                    assert old + plan["back"] < t - 1, (t, b, old)
                slots[b % ring] = b
            for i in range(t * 64, min(t * 64 + 64, T)):
                for j in range(max(0, i - left), min(t_real, i + right + 1)):
                    assert slots[(j // 64) % ring] == j // 64, (t, i, j)


def test_window_plan_at_sup():
    """sup inference: a CTA per (n, h) walks all 16 tiles, two CTAs an SM,
    1024 CTAs in four waves; a ring of six blocks of 64 keys."""
    plan = _plan(128, 1000, 8, 64, SUP_WINDOW)
    assert (plan["stretch"], plan["ctas"], plan["resident"], plan["waves"],
            plan["ring"], plan["smem"]) == (16, 1024, 2, 4, 6, 114720)


def test_window_plan_at_sup_evaluate_in_f32():
    """sup's forward in f32 at evaluate's batch (256 chunks of 3000
    samples: T 250, four tiles): a CTA walks all four tiles of its (n, h),
    2048 CTAs in eight waves of two an SM, the bf16 ring of six blocks."""
    plan = _plan(256, 250, 8, 64, SUP_WINDOW, dtype=torch.float32)
    assert (plan["stretch"], plan["ctas"], plan["resident"], plan["waves"],
            plan["ring"], plan["smem"], plan["dtype"]) == (
                4, 2048, 2, 8, 6, 114720, "f32")


def test_window_plan_follows_the_card():
    """sup training's 256 (n, h) pairs fill an H100's 264 slots in one
    wave of whole stretches; twice the SMs take half stretches, half the
    SMs keep them whole over two waves."""
    assert _plan(32, 1024, 8, 64, SUP_WINDOW)["stretch"] == 16
    wide = _plan(32, 1024, 8, 64, SUP_WINDOW, sms=264)
    assert (wide["stretch"], wide["ctas"], wide["waves"]) == (8, 512, 1)
    narrow = _plan(32, 1024, 8, 64, SUP_WINDOW, sms=66)
    assert (narrow["stretch"], narrow["waves"]) == (16, 2)


@pytest.mark.parametrize("dtype,D,window", [
    (torch.float64, 64, SUP_WINDOW),   # a dtype K does not take
    (torch.float16, 64, SUP_WINDOW),
    (torch.bfloat16, 136, SUP_WINDOW),  # beyond the widest head K takes
    (torch.bfloat16, 60, SUP_WINDOW),
    (torch.bfloat16, 64, (128, 128)),   # beyond the band K takes
    (torch.bfloat16, 64, (127, 129))])
def test_window_plan_sends_the_rest_to_the_earlier_kernel(dtype, D, window):
    """No plan for a dtype, head or window K does not take at all (which
    the wrapper's checks refuse first): the wrapper would launch the
    earlier kernel's entry (K's, or H's with lse), by the shape rule alone.
    f32, once sent here, now has a plan; O's rule keeps none for it."""
    plan = attention_cuda.window_plan(128, 1000, 8, D, window, dtype, SMS)
    assert plan is None
    assert attention_cuda.window_entry(plan, False) == \
        "fused_rotary_window_attention"
    assert attention_cuda.window_entry(plan, True) == \
        "fused_rotary_window_attention_lse"
    assert attention_cuda.window_entry(_plan(128, 1000, 8, 64, SUP_WINDOW),
                                       True) == \
        "fused_rotary_window_attention_stretch"
    f32 = _plan(128, 1000, 8, 64, SUP_WINDOW, dtype=torch.float32)
    assert attention_cuda.window_entry(f32, False) == \
        "fused_rotary_window_attention_stretch"
    assert attention_cuda.window_bwd_plan(128, 1000, 8, 64, SUP_WINDOW,
                                          torch.float32, SMS) is None


def _bwd_plan(N, T, H, D, window, sms=SMS):
    return attention_cuda.window_bwd_plan(N, T, H, D, window, torch.bfloat16,
                                          sms)


def _bwd_kind_steps(plan, kind, t_a, T, t_real):
    """The steps of a CTA of O's ``kind``: the dq kind's ring holds key
    blocks (data below t_real), the dk kind's query blocks (below T)."""
    return _stretch_steps(plan, t_a, T, t_real if kind == "dq" else T,
                          plan[kind]["back"], plan[kind]["ahead"])


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_bwd_plan_fits_the_card(N, T, H, D, window, t_real):
    """O's plan: what a CTA asks (two rings' rows and the tile's two kinds
    of rows in 227 KB; the resident CTAs within an SM), rings of at most six
    blocks, the dk kind's band the dq kind's mirrored, two kinds of CTA."""
    plan = _bwd_plan(N, T, H, D, window)
    assert plan is not None
    assert plan["smem"] == attention_cuda.window_bwd_smem(plan["ring"],
                                                          plan["head_dim"])
    assert plan["smem"] <= SMEM
    assert plan["resident"] * (plan["smem"] + 1024) <= attention_cuda.SM_SMEM
    assert plan["resident"] == (2 if plan["head_dim"] <= 64 else 1)
    assert D <= plan["head_dim"] in (32, 64, 128)
    left, right = window
    assert plan["dq"] == {"back": -(-left // 64), "ahead": -(-right // 64)}
    assert plan["dk"] == {"back": -(-right // 64), "ahead": -(-left // 64)}
    for kind in ("dq", "dk"):
        assert plan["ring"] == (plan[kind]["back"] + plan[kind]["ahead"]
                                + 2) <= 6
    assert plan["ctas"] == 2 * N * H * plan["stretches"]
    assert plan["stretches"] == -(-plan["tiles"] // plan["stretch"])
    assert plan["waves"] == -(-plan["ctas"] // (SMS * plan["resident"]))


@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_bwd_plan_covers_every_tile_once(N, T, H, D, window, t_real):
    """Each (n, h)'s stretches of each kind cover its tiles 0 .. ceil(T /
    64) - 1 exactly once: the dq kind's query tiles, the dk kind's key
    tiles."""
    plan = _bwd_plan(N, T, H, D, window)
    n_tiles = -(-T // 64)
    for kind in ("dq", "dk"):
        seen = [0] * n_tiles
        for st in range(plan["stretches"]):
            for t, _ in _bwd_kind_steps(plan, kind, st * plan["stretch"], T,
                                        t_real or T):
                seen[t] += 1
        assert seen == [1] * n_tiles, kind


@pytest.mark.parametrize("kind", ["dq", "dk"])
@pytest.mark.parametrize("N,T,H,D,window,t_real", K_SHAPES)
def test_window_bwd_plan_keeps_each_band_in_the_ring(N, T, H, D, window,
                                                     t_real, kind):
    """Walk every stretch of each kind as the kernel does: when tile t is
    computed, every pair of its band is in the ring (its block staged and
    not overwritten since), and a block the producers stage overwrites
    nothing the tile before (which the consumers may still read) or a later
    one needs. The dq kind: query i of the tile (below T) and the keys it
    sees (-left <= j - i <= right, j < t_real); the dk kind, the mirrored
    band: key j of the tile (below t_real: a later key is seen by no query)
    and the queries that see it (j - right <= i <= j + left, i < T)."""
    left, right = window
    t_real = t_real or T
    plan = _bwd_plan(N, T, H, D, window)
    ring, back = plan["ring"], plan[kind]["back"]
    for st in range(plan["stretches"]):
        slots = [None] * ring  # the block each slot holds
        for t, blocks in _bwd_kind_steps(plan, kind, st * plan["stretch"], T,
                                         t_real):
            for b in blocks:
                old = slots[b % ring]
                if old is not None:
                    assert old + back < t - 1, (t, b, old)
                slots[b % ring] = b
            for r in range(t * 64, min(t * 64 + 64, T)):
                if kind == "dq":
                    cols = range(max(0, r - left), min(t_real, r + right + 1))
                else:
                    cols = (range(max(0, r - right), min(T, r + left + 1))
                            if r < t_real else range(0))
                for c in cols:
                    assert slots[(c // 64) % ring] == c // 64, (t, r, c)


def test_window_bwd_plan_at_sup_training():
    """sup training (N 32, T 1024, 8 heads of 64): each kind's CTA walks
    all 16 tiles of its (n, h), 512 CTAs in two waves at two an SM (the 256
    dk CTAs first, then the dq ones as slots come free); rings of six
    blocks, 114,736 bytes a CTA."""
    plan = _bwd_plan(32, 1024, 8, 64, SUP_WINDOW)
    assert (plan["stretch"], plan["ctas"], plan["resident"], plan["waves"],
            plan["ring"], plan["smem"]) == (16, 512, 2, 2, 6, 114736)
    assert plan == _bwd_plan(32, 1000, 8, 64, SUP_WINDOW)


@pytest.mark.parametrize("dtype,D,window", [
    (torch.float32, 64, SUP_WINDOW),   # f32: the earlier kernel
    (torch.float16, 64, SUP_WINDOW),
    (torch.bfloat16, 136, SUP_WINDOW),  # beyond the widest head O takes
    (torch.bfloat16, 60, SUP_WINDOW),
    (torch.bfloat16, 64, (128, 128)),   # beyond the band O takes
    (torch.bfloat16, 64, (127, 129))])
def test_window_bwd_plan_sends_the_rest_to_the_earlier_kernel(dtype, D,
                                                              window):
    """No plan for f32 (and none for what O does not take at all, which the
    wrapper's checks refuse first): the wrapper then launches the earlier
    kernel's entry, by the shape rule alone."""
    plan = attention_cuda.window_bwd_plan(32, 1024, 8, D, window, dtype, SMS)
    assert plan is None
    assert attention_cuda.window_bwd_entry(plan) == \
        "fused_rotary_window_attention_bwd"
    assert attention_cuda.window_bwd_entry(
        _bwd_plan(32, 1024, 8, 64, SUP_WINDOW)) == \
        "fused_rotary_window_attention_bwd_stretch"


# (N, T, S): hac (N 96, T 1666), sup (N 128, T 2000), the GPU tests'
# shapes (state_len 2, 3 and 5; T below, at and beyond the ring), one row,
# one frame, S 48 (no power of 4: a warp with idle threads)
DECODE_SHAPES = [(96, 1666, 1024), (128, 2000, 1024), (4, 9, 16),
                 (8, 30, 64), (3, 12, 1024), (2, 4, 64), (3, 400, 1024),
                 (1, 8, 256), (2, 1, 1024), (1, 17, 48)]


@pytest.mark.parametrize("N,T,S", DECODE_SHAPES)
def test_decode_plan_fits_the_card(N, T, S):
    """One CTA a row of S / 4 consumer threads (whole warps, at most 8),
    a producer and an epilogue warp; each pass's shared memory within the
    card's."""
    plan = decode_cuda.decode_plan(N, T, S, SMS)
    assert plan is not None and plan["ctas"] == N
    assert plan["states_per_thread"] == 4
    assert plan["consumer_threads"] % 32 == 0
    assert S // 4 <= plan["consumer_threads"] < S // 4 + 32
    assert plan["threads"] == plan["consumer_threads"] + 64 <= 320
    for name, backward in (("fwd", False), ("bwd", True)):
        ring = plan[name]["ring"]
        assert 2 <= ring <= 16  # what the C entries take
        assert plan[name]["smem"] == decode_cuda.ring_smem(S, ring, backward)
        assert plan[name]["smem"] <= SMEM
        # the slots and the rows they copy are whole 16-byte pieces
        assert (8 * S) % 16 == 0 and (4 * S) % 16 == 0 and S % 16 == 0


def _ring_events(T, ring, backward):
    """The order of csrc/decode_ring.cuh's fills and reads of the ring
    for one row: ("fill", frame) by the producer warp (frames 0 .. ring -
    1 first, then after the barrier of frame i those below i + 2 + ring in
    B, i + 1 + ring in C), ("read", frame, why) by the consumers; frames
    are the order the pass takes them (C's frame i is t = T - 1 - i). B's
    consumers read frame 0's row before the loop and, in frame i, the row
    of min(i + 1, T - 1); C's read the same rows, and in frame i also its
    move_in and choices (the epilogue warp reads none of the ring)."""
    events = [("fill", u) for u in range(min(ring, T))]
    issued = min(ring, T)
    events.append(("read", 0, "row"))
    for i in range(T):
        events.append(("read", min(i + 1, T - 1), "row"))
        if backward:
            events.append(("read", i, "frame"))
        events.append(("barrier", i))
        upto = min(T, i + (1 if backward else 2) + ring)
        events += [("fill", u) for u in range(issued, upto)]
        issued = max(issued, upto)
    return events


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("T", [1, 2, 7, 8, 9, 16, 17, 40])
def test_decode_ring_hands_each_frame_over_once_in_order(T, backward):
    """With the plan's ring of 8: T below, at and beyond it. Every frame
    is copied once, in the pass's order (B t = 0 .. T-1, C t = T-1 .. 0);
    each read finds its frame in its slot (slot u % ring), filled before;
    the rows the consumers compute with are frames 0, 1, ..., T-1, each
    once (the last frame's second read of its row is unused); and no slot
    is refilled while a frame in it has a read to come."""
    ring = decode_cuda.decode_plan(1, T, 1024)["bwd" if backward else
                                               "fwd"]["ring"]
    events = _ring_events(T, ring, backward)
    fills = [e[1] for e in events if e[0] == "fill"]
    assert fills == list(range(T))
    slots = [None] * ring
    rows = []
    for k, e in enumerate(events):
        if e[0] == "fill":
            old = slots[e[1] % ring]
            if old is not None:
                assert not any(f[0] == "read" and f[1] == old
                               for f in events[k:]), (e, old)
            slots[e[1] % ring] = e[1]
        elif e[0] == "read":
            assert slots[e[1] % ring] == e[1], e
            if e[2] == "row":
                rows.append(e[1])
    assert rows[:T] == list(range(T)) and rows[T:] == [T - 1]


def test_decode_ring_leaves_its_copies_frames_to_land():
    """Beyond the first ring, a frame's copy is issued at least ring - 2
    whole frames before the frame in which its row is read (B: ring - 1
    but for frame ring, which goes with ring + 1)."""
    for backward in (False, True):
        events = _ring_events(100, 8, backward)
        at, frame = {}, 0
        for e in events:
            if e[0] == "barrier":
                frame = e[1] + 1
            elif e[0] == "fill":
                at[e[1]] = frame
        # frame u's row is read in frame u - 1
        lead = [u - 1 - at[u] for u in range(8, 100)]
        assert min(lead) == 6
        assert lead[1:] == [6 if backward else 7] * len(lead[1:])


def test_decode_plan_at_hac_and_sup():
    """hac (N 96, T 1666) and sup (N 128, T 2000) at S 1024: 96 or 128
    CTAs of 8 consumer warps, a producer and an epilogue warp, one wave on
    132 SMs, rings
    of 8 frames: 82,752 B (B) and 117,568 B (C) a CTA."""
    for N, T in ((96, 1666), (128, 2000)):
        plan = decode_cuda.decode_plan(N, T, 1024, SMS)
        assert plan == {"threads": 320, "consumer_threads": 256,
                        "states_per_thread": 4, "ctas": N, "waves": 1,
                        "fwd": {"ring": 8, "smem": 82752},
                        "bwd": {"ring": 8, "smem": 117568}}
    assert decode_cuda.decode_entry(plan, False) == "decode_tcn_fwd_ring"
    assert decode_cuda.decode_entry(plan, True) == "decode_tcn_bwd_ring"


@pytest.mark.parametrize("N,T,S", [(3, 7, 4), (2, 9, 8), (2, 5, 20),
                                   (2, 5, 1028), (0, 5, 64), (2, 0, 64)])
def test_decode_plan_sends_the_rest_to_the_earlier_kernel(N, T, S):
    """S not a multiple of 16 (a row of choices is no whole number of
    16-byte pieces) or beyond 1024, and empty shapes: no plan, and the
    wrappers launch the earlier kernels' entries."""
    plan = decode_cuda.decode_plan(N, T, S, SMS)
    assert plan is None
    assert decode_cuda.decode_entry(plan, False) == "decode_tcn_fwd_bf16"
    assert decode_cuda.decode_entry(plan, True) == "decode_tcn_bwd_bf16"


def _ring_state_sum(x, only_base=None):
    """A sum over states as csrc/decode_ring.cuh takes it. The forward
    pass's logZ: the epilogue warp reads run k's 32 states in its lanes
    (zeros past S) and takes their xor butterfly (16, 8, 4, 2, 1). The
    backward pass's mass: thread r = 32w + lane holds states 4r .. 4r+3 and
    leaves one share (its state of the emitted base; the other three states
    add zeros); one lane of the epilogue warp sums the shares of threads 8k
    .. 8k+7 (states xor 16, 8, 4 of run k) as ((v0 + v4) + (v2 + v6)) +
    ((v1 + v5) + (v3 + v7)). Run k's sum then goes through the butterfly
    of 32 runs (zeros past the last). f32 throughout."""
    S = x.shape[-1]
    if only_base is None:
        k = -(-S // 32)
        u = torch.zeros(*x.shape[:-1], 32 * k)
        u[..., :S] = x
        u = u.reshape(*x.shape[:-1], k, 32)
        lanes = torch.arange(32)
        for o in (16, 8, 4, 2, 1):
            u = u + u[..., lanes ^ o]
        run = u[..., 0]
    else:
        consumers = -(-(S // 4) // 32) * 32
        v = torch.zeros(*x.shape[:-1], consumers, 4)
        v[..., :S // 4, :] = x.reshape(*x.shape[:-1], S // 4, 4)
        k = consumers // 8
        u = v[..., only_base].reshape(*x.shape[:-1], k, 8)
        run = (((u[..., 0] + u[..., 4]) + (u[..., 2] + u[..., 6]))
               + ((u[..., 1] + u[..., 5]) + (u[..., 3] + u[..., 7])))
    runs = torch.zeros(*x.shape[:-1], 32)
    runs[..., :k] = run
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        runs = runs + runs[..., idx ^ o]
    return runs[..., 0]


@pytest.mark.parametrize("S", [16, 48, 64, 256, 1024])
def test_decode_ring_sums_states_in_block_sums_tree(S):
    """The ring's epilogue warp takes the forward pass's closing sum (the
    states' alpha in their order) and, from four states a thread, the
    backward pass's posterior mass in block_sum's tree, bit for bit on random
    f32 values of many magnitudes (and, for the mass, one base's states
    with the others at zero)."""
    g = torch.Generator().manual_seed(S)
    x = torch.rand(64, S, generator=g) * torch.exp(
        8 * torch.randn(64, S, generator=g))
    want = decode_cuda.block_sum(x)
    assert torch.equal(_ring_state_sum(x).view(torch.int32),
                       want.view(torch.int32))
    for base in range(4):
        masked = torch.where(torch.arange(S) % 4 == base, x, torch.zeros(()))
        assert torch.equal(
            _ring_state_sum(x, base).view(torch.int32),
            decode_cuda.block_sum(masked).view(torch.int32))


# (N, T, S): hac (N 96, T 1666, S 1024), sup (N 128, T 2000), fast (N 1024,
# T 1200, S 64), the GPU tests' shapes (one frame, one row, S 16 and 256)
FULL_SHAPES = [(96, 1666, 1024), (128, 2000, 1024), (1024, 1200, 64),
               (4, 9, 16), (5, 40, 256), (2, 1, 1024), (1, 300, 1024)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,T,S", FULL_SHAPES)
def test_decode_full_plan_fits_the_card(N, T, S, dtype):
    """M's and Q's ring: one CTA a row of S / 4 consumer threads (whole
    warps, at most 8), a producer and an epilogue warp; each pass's shared
    memory within the card's, its slots whole 16-byte pieces, the ring as
    deep as B's and C's (f32 too, at 1024 states)."""
    plan = decode_full_cuda.decode_full_plan(N, T, S, dtype, SMS)
    assert plan is not None and plan["ctas"] == N
    assert plan["waves"] == -(-N // SMS)
    assert plan["states_per_thread"] == 4
    assert S // 4 <= plan["consumer_threads"] < S // 4 + 32
    assert plan["consumer_threads"] % 32 == 0
    assert plan["threads"] == plan["consumer_threads"] + 64 <= 320
    row = 5 * S * dtype.itemsize
    for name, backward in (("fwd", False), ("bwd", True)):
        ring = plan[name]["ring"]
        assert ring == decode_cuda.RING
        assert plan[name]["smem"] == decode_cuda.ring_smem(S, ring, backward,
                                                           row)
        assert plan[name]["smem"] <= SMEM
        assert row % 16 == 0 and (4 * S) % 16 == 0 and S % 16 == 0
    assert decode_full_cuda.decode_full_entry(plan, False) == \
        "decode_full_fwd_ring"
    assert decode_full_cuda.decode_full_entry(plan, True) == \
        "decode_full_bwd_ring"


def test_decode_full_plan_at_hac():
    """hac (N 96, T 1666, S 1024): 96 CTAs of 8 consumer warps, a producer
    and an epilogue warp, one wave on 132 SMs, rings of 8 frames: 99,136 B
    (M) and 133,952 B (Q) a CTA in bf16 (a slot of 10S and 15S bytes),
    181,056 and 215,872 B in f32."""
    for dtype, smem in ((torch.bfloat16, (99136, 133952)),
                        (torch.float32, (181056, 215872))):
        plan = decode_full_cuda.decode_full_plan(96, 1666, 1024, dtype, SMS)
        assert plan == {"threads": 320, "consumer_threads": 256,
                        "states_per_thread": 4, "ctas": 96, "waves": 1,
                        "fwd": {"ring": 8, "smem": smem[0]},
                        "bwd": {"ring": 8, "smem": smem[1]}}


@pytest.mark.parametrize("N,T,S,dtype", [
    (3, 7, 4, torch.bfloat16), (3, 7, 4, torch.float32),
    (2, 5, 48, torch.bfloat16), (2, 5, 32, torch.float32),
    (2, 5, 2048, torch.bfloat16), (0, 5, 64, torch.bfloat16),
    (2, 0, 64, torch.float32), (2, 5, 64, torch.float16)])
def test_decode_full_plan_sends_the_rest_to_the_earlier_kernel(N, T, S,
                                                               dtype):
    """S 4 (a row of choices is no whole number of 16-byte pieces), S no
    power of 4 or beyond 1024, empty shapes and another dtype: no plan, and
    the wrappers launch the earlier kernels' entries (or raise, for what
    those do not take either)."""
    plan = decode_full_cuda.decode_full_plan(N, T, S, dtype, SMS)
    assert plan is None
    assert decode_full_cuda.decode_full_entry(plan, False) == \
        "decode_full_fwd"
    assert decode_full_cuda.decode_full_entry(plan, True) == \
        "decode_full_bwd"


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("T", [1, 2, 8, 9, 17, 40])
def test_full_ring_hands_each_frame_over_once_in_order(T, backward,
                                                       reverse):
    """M's and Q's ring runs B's and C's schedule (``_ring_events``) on the
    plan's ring: each frame of the pass (M t = 0 .. T-1, Q t = T-1 .. 0) is
    copied once, found in its slot when read and not overwritten while a
    read is to come, and its row is the forward strand's frame t, or T-1-t
    for the reverse strand (``FullRows::row``): every forward frame once,
    in the pass's order or its reverse."""
    plan = decode_full_cuda.decode_full_plan(1, T, 1024, torch.bfloat16)
    ring = plan["bwd" if backward else "fwd"]["ring"]
    events = _ring_events(T, ring, backward)
    fills = [e[1] for e in events if e[0] == "fill"]
    assert fills == list(range(T))
    slots = [None] * ring
    for k, e in enumerate(events):
        if e[0] == "fill":
            old = slots[e[1] % ring]
            if old is not None:
                assert not any(f[0] == "read" and f[1] == old
                               for f in events[k:]), (e, old)
            slots[e[1] % ring] = e[1]
        elif e[0] == "read":
            assert slots[e[1] % ring] == e[1], e
    strand = [T - 1 - u if backward else u for u in fills]
    rows = [T - 1 - t if reverse else t for t in strand]
    assert sorted(rows) == list(range(T))
    assert rows == (list(range(T)) if backward == reverse
                    else list(range(T - 1, -1, -1)))


def _rc(x, digits):
    return int(decode_full_cuda.rc_digits(x, digits))


@pytest.mark.parametrize("S", [16, 64, 256, 1024])
def test_reverse_ring_keeps_the_states_in_the_forward_order(S):
    """The reverse strand's ring (``own_at``, ``load4``, ``store4`` of
    csrc/decode_ring.cuh with REV): consumer q holds the reverse states
    4 rc(q) + b at column (3-b)*R + q and their predecessors j*R + rc(q) at
    4q + 3-j, the columns ``rc_states`` gives them; each kind covers every
    column once, and each thread reads the 20 values of forward block q
    (``FullRows::piece``): the moves into its states and, for Q, its
    predecessors' stays, the columns ``rc_columns`` gives."""
    R = S // 4
    digits = decode_full_cuda.state_len(S) - 1
    order = decode_full_cuda.rc_states(S).tolist()
    cols = decode_full_cuda.rc_columns(S).reshape(S, 5).tolist()
    own, pred = set(), set()
    for q in range(R):
        r = _rc(q, digits)
        for k in range(4):
            at_own, at_pred = (3 - k) * R + q, 4 * q + 3 - k
            assert order[at_own] == 4 * r + k
            assert order[at_pred] == k * R + r
            own.add(at_own)
            pred.add(at_pred)
            # the move into state 4r + k from slot j, and Q's stay of
            # predecessor j = k, inside block q
            for j in range(4):
                assert cols[4 * r + k][1 + j] == (
                    20 * q + (3 - j) * 5 + 4 - k)
            assert cols[k * R + r][0] == 20 * q + (3 - k) * 5
            # M's stay of its own state b = k, outside the block
            assert cols[4 * r + k][0] == ((3 - k) * R + q) * 5
    assert own == pred == set(range(S))


@pytest.mark.parametrize("state_len", [1, 2, 3, 5])
def test_reverse_traceback_walks_the_forward_order(state_len):
    """Q's traceback on the reverse strand keeps the column sigma =
    rc_sl(state) of its state: the emitted base is 3 - sigma / R and a move
    by choice c (1..4) goes to (sigma % R) * 4 + 4 - c, the column of
    state / 4 + (c - 1) * R."""
    S = 4 ** state_len
    R = S // 4
    order = decode_full_cuda.rc_states(S).tolist()
    for state in range(S):
        sigma = order[state]
        assert state % 4 == 3 - sigma // R
        for c in range(1, 5):
            assert order[state // 4 + (c - 1) * R] == sigma % R * 4 + 4 - c


# (N, T, S): the loss kernels' training shapes (chip_smoke.py LOSS_SHAPES:
# hac, fast, sup) and the card tests' (every S, T below, at and beyond the
# ring, one row, one frame)
LOGZ_SHAPES = [(128, 1000, 1024), (128, 1200, 64), (32, 2048, 1024),
               (3, 7, 4), (4, 9, 16), (8, 30, 64), (5, 40, 256),
               (3, 12, 1024), (1, 1, 1024), (2, 8, 1024), (1, 5, 64),
               (32, 100, 1024)]


def _logz_ks(S):
    """The numbers of states a thread the ring's C entries take at S."""
    return [k for k in (1, 4) if logz_cuda.ring_consumers(S, k) + 32
            <= logz_cuda.THREADS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("N,T,S", LOGZ_SHAPES)
def test_logz_plan_fits_the_card(N, T, S, dtype):
    """U's and V's ring: one CTA a row of S / k consumer threads (whole
    warps) and a producer warp, within the C entries' bound; each
    pass's shared memory within the card's, its slots' pieces (the moves'
    row, the stack's row) whole 16-byte pieces."""
    plan = logz_cuda.logz_plan(N, T, S, dtype, SMS)
    assert plan is not None and plan["ctas"] == N
    assert plan["waves"] == -(-N // SMS)
    k = plan["states_per_thread"]
    assert k in _logz_ks(S)
    assert plan["consumer_threads"] % 32 == 0
    assert S // k <= plan["consumer_threads"] < S // k + 32
    assert plan["threads"] == plan["consumer_threads"] + 32
    assert plan["threads"] <= logz_cuda.THREADS <= 1024
    for name, backward in (("fwd", False), ("bwd", True)):
        ring = plan[name]["ring"]
        assert ring == logz_cuda.RING and 1 <= ring <= 16
        assert plan[name]["smem"] == logz_cuda.logz_smem(S, ring, dtype,
                                                         backward)
        assert plan[name]["smem"] <= SMEM
    assert (4 * S * dtype.itemsize) % 16 == 0 and (4 * S) % 16 == 0
    assert logz_cuda.logz_entry(plan, False) == "logz_tcn_fwd_ring"
    assert logz_cuda.logz_entry(plan, True) == "logz_tcn_bwd_ring"


def test_logz_plan_at_hac_and_sup():
    """hac training (N 128, T 1000) and sup's (N 32, T 2048) at S 1024, in
    bf16: a CTA a row of 8 consumer warps of four states a thread and a
    producer warp, one wave on 132 SMs, rings of 8 frames: 73,792 B (U, a
    slot of 8 KB) and 106,560 B (V, a slot of 12 KB); in f32 139,328 and
    172,096 B. fast's (N 128, T 1200, S 64): two warps of one state a
    thread."""
    for N, T in ((128, 1000), (32, 2048)):
        for dtype, smem in ((torch.bfloat16, (73792, 106560)),
                            (torch.float32, (139328, 172096))):
            plan = logz_cuda.logz_plan(N, T, 1024, dtype, SMS)
            assert plan == {"threads": 288, "consumer_threads": 256,
                            "states_per_thread": 4, "ctas": N, "waves": 1,
                            "fwd": {"ring": 8, "smem": smem[0]},
                            "bwd": {"ring": 8, "smem": smem[1]}}
    plan = logz_cuda.logz_plan(128, 1200, 64, torch.bfloat16, SMS)
    assert (plan["threads"], plan["states_per_thread"]) == (96, 1)


@pytest.mark.parametrize("N,T,S,dtype", [
    (3, 7, 4, torch.bfloat16), (4, 9, 16, torch.float32),
    (8, 30, 64, torch.bfloat16), (5, 40, 256, torch.float32),
    (3, 12, 1024, torch.float32), (1, 1, 1024, torch.bfloat16),
    (128, 1200, 64, torch.float32), (32, 2048, 1024, torch.float32),
    (128, 1000, 1024, torch.bfloat16)])
def test_logz_plan_sends_the_rest_to_the_earlier_kernel(N, T, S, dtype):
    """Pointers not 16-byte aligned (the ring's bulk copies need them
    so), at every S and in both dtypes: no plan, and the wrappers launch
    the earlier kernels' entries. What neither takes (S outside STATES,
    another dtype, an empty shape) the wrappers' checks refuse before a
    plan is made."""
    assert logz_cuda.logz_plan(N, T, S, dtype, SMS) is not None
    plan = logz_cuda.logz_plan(N, T, S, dtype, SMS, aligned=False)
    assert plan is None
    assert logz_cuda.logz_entry(plan, False) == "logz_fwd"
    assert logz_cuda.logz_entry(plan, True) == "logz_bwd"


def _logz_threads(S, k):
    """csrc/logz_ring.cu's consumers: thread i < S / k takes block
    q = i % R and the k values c*k .. c*k + k-1 of it, c = i / R."""
    R = S // 4
    i = torch.arange(S // k)
    q, c = i % R, i // R
    kk = c[:, None] * k + torch.arange(k)[None]  # b (U) or j (V)
    return q, kk


@pytest.mark.parametrize("S", [4, 16, 64, 256, 1024])
def test_logz_ring_covers_every_state_once(S):
    """At every number of states a thread the C entries take: U's
    consumers hold states 4q + b, V's predecessors j*R + q, each state
    once; V's stores cover the 4S gradient columns (b*4 + j)*R + q once,
    and U's and V's reads of a frame's moves cover its row."""
    R = S // 4
    for k in _logz_ks(S):
        q, kk = _logz_threads(S, k)
        own = (4 * q[:, None] + kk).flatten()
        pred = (kk * R + q[:, None]).flatten()
        assert sorted(own.tolist()) == list(range(S))
        assert sorted(pred.tolist()) == list(range(S))
        b = torch.arange(4)
        cols_u = ((kk[:, :, None] * 4 + b) * R + q[:, None, None]).flatten()
        cols_v = ((b[None, :, None] * 4 + kk[:, None, :]) * R
                  + q[:, None, None]).flatten()
        assert sorted(cols_u.tolist()) == list(range(4 * S))
        assert sorted(cols_v.tolist()) == list(range(4 * S))


def _logz_ring_events(T, ring, full=False):
    """The order of csrc/logz_ring.cu's fills and reads of the ring for one
    row (U, V and X alike, each in its pass's order: V's and X's frame i is
    t = T-1-i): ("fill", frame) by the producer's lane 0 (frames 0 .. ring
    - 1 first, then after the barrier of frame i those below i + 2 + ring,
    for X those below i + 1 + ring), ("read", frame) by the consumers:
    frame 0's slot before the loop and, in frame i, the slot of min(i + 1,
    T - 1), read into registers for the next frame; X (``full``) also
    reads frame i's own slot in frame i ("pass": its gradient over the
    frame's columns)."""
    events = [("fill", u) for u in range(min(ring, T))]
    issued = min(ring, T)
    events.append(("read", 0))
    for i in range(T):
        if full:
            events.append(("pass", i))
        events.append(("read", min(i + 1, T - 1)))
        events.append(("barrier", i))
        upto = min(T, i + (1 if full else 2) + ring)
        events += [("fill", u) for u in range(issued, upto)]
        issued = max(issued, upto)
    return events


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("T", [1, 2, 7, 8, 9, 16, 17, 40])
def test_logz_ring_hands_each_frame_over_once_in_order(T, backward):
    """With the plan's ring of 8 (and rings of 2, the least the C entries
    take, and 3): T below, at and beyond it. Every frame is copied once, in
    the pass's order (U t = 0 .. T-1, V t = T-1 .. 0: the stack's and the
    moves' rows of frame t in one slot); each read finds its frame in its
    slot (slot u % ring), filled before; the frames whose values the
    consumers compute with are 0 .. T-1, each once (the last frame's second
    read is unused); and no slot is refilled while a frame in it has a
    read to come. With V, X's ring (``full``: the slot of the full scores
    and the stack's row, read again by the frame's own gradient pass) the
    same, each frame's pass finding it in its slot; with U, W's ring (a
    frame's 5S scores to a slot, U's schedule)."""
    plan = logz_cuda.logz_plan(1, T, 1024, torch.bfloat16)
    full = logz_cuda.logz_plan(1, T, 1024, torch.float32, full=True)
    rings = [(plan["bwd" if backward else "fwd"]["ring"], False), (2, False),
             (3, False)]
    if backward:
        rings += [(full["bwd"]["ring"], True), (2, True), (3, True)]
    else:
        rings += [(full["fwd"]["ring"], False)]  # W's, on U's schedule
    for ring, is_full in rings:
        events = _logz_ring_events(T, ring, is_full)
        fills = [e[1] for e in events if e[0] == "fill"]
        assert fills == list(range(T))
        slots = [None] * ring
        for k, e in enumerate(events):
            if e[0] == "fill":
                old = slots[e[1] % ring]
                if old is not None:
                    assert not any(f[0] in ("read", "pass") and f[1] == old
                                   for f in events[k:]), (e, old)
                slots[e[1] % ring] = e[1]
            elif e[0] in ("read", "pass"):
                assert slots[e[1] % ring] == e[1], e
        reads = [e[1] for e in events if e[0] == "read"]
        assert reads[:T] == list(range(T)) and reads[T:] == [T - 1]
        passes = [e[1] for e in events if e[0] == "pass"]
        assert passes == (list(range(T)) if is_full else [])
        frames = [T - 1 - u if backward else u for u in fills]
        assert frames == (list(range(T - 1, -1, -1)) if backward
                          else list(range(T)))


@pytest.fixture
def one_thread():
    """torch on one CPU thread, so that each elementwise exp and log takes
    one code path over the whole tensor (its vector loop: the sizes below
    are multiples of 64), in the emulation and in the plain version alike."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _emulate_u(moves, blank, k):
    """U as csrc/logz_ring.cu's consumers take it, k states a thread: each
    thread's states from its predecessors in the frame's parity, the sums
    over j in order; logZ in the epilogue's tree (``_ring_state_sum``)."""
    N, T, C = moves.shape
    S = C // 4
    R = S // 4
    q, b = _logz_threads(S, k)
    own = 4 * q[:, None] + b                              # [th, k]
    pred = torch.arange(4)[None] * R + q[:, None]         # [th, 4]
    col = (b[..., None] * 4 + torch.arange(4)) * R + q[:, None, None]
    alpha = torch.zeros(N, S)
    stack = torch.empty(N, T, S)
    for t in range(T):
        stack[:, t] = alpha
        row = moves[:, t].to(torch.bfloat16).float()
        cand = row[:, col] + alpha[:, pred][:, :, None, :]  # [N, th, k, 4]
        m = _max4(cand)
        move_in = m + torch.log(_sum4(torch.exp(cand - m[..., None])))
        nxt = torch.empty(N, S)
        nxt[:, own] = _lse2(blank + alpha[:, own], move_in)
        alpha = nxt
    mx = alpha.amax(1)
    return stack, mx + torch.log(_ring_state_sum(torch.exp(alpha
                                                           - mx[:, None])))


def _emulate_v(moves, blank, stack, lz, g, k):
    """V as csrc/logz_ring.cu's consumers take it, k predecessors a thread:
    the 4k edge posteriors x g, then the thread's betas from their
    successors 4q + b, the sums over b in order; the gradient rounded to
    bf16 and kept in f32."""
    N, T, C = moves.shape
    S = C // 4
    R = S // 4
    q, j = _logz_threads(S, k)
    pred = j * R + q[:, None]                              # [th, k]
    succ = 4 * q[:, None] + torch.arange(4)                # [th, 4]
    col = (torch.arange(4)[None, :, None] * 4 + j[:, None, :]) * R \
        + q[:, None, None]                                 # [th, 4, k]
    grad = torch.empty(N, T, C)
    beta = torch.zeros(N, S)
    lz, g = lz[:, None, None, None], g[:, None, None, None]
    for t in range(T - 1, -1, -1):
        row = moves[:, t].to(torch.bfloat16).float()
        mv = row[:, col]                                   # [N, th, b, k]
        bs = beta[:, succ][..., None]                      # [N, th, b, 1]
        e = (mv + stack[:, t][:, pred][:, :, None, :]) + bs
        gv = torch.exp(e - lz) * g
        grad[:, t][:, col] = gv.to(torch.bfloat16).float()
        mo = (mv + bs).transpose(2, 3)                     # [N, th, k, b]
        mm = _max4(mo)
        ls = mm + torch.log(_sum4(torch.exp(mo - mm[..., None])))
        nxt = torch.empty(N, S)
        nxt[:, pred] = _lse2(blank + beta[:, pred], ls)
        beta = nxt
    return grad


@pytest.mark.parametrize("S,N,T", [(16, 8, 12), (64, 8, 12), (1024, 4, 6)])
def test_logz_ring_emulation_equals_the_plain_versions(one_thread, S, N, T):
    """At every number of states a thread the C entries take, the ring's
    per-state order, emulated, gives ``ops.logz``'s forward_plain (stack
    and logZ) and backward_plain (the gradient, rounded to bf16) bit for
    bit: the assignment of states to threads moves no bit."""
    g = torch.Generator().manual_seed(S + T)
    moves = 5 * torch.tanh(torch.randn(N, T, 4 * S, generator=g))
    cot = torch.linspace(-1.5, 2.0, N)
    stack, lz = logz.forward_plain(moves, 1.5)
    grad, _ = logz.backward_plain(moves, 1.5, stack, lz, cot)
    for k in _logz_ks(S):
        e_stack, e_lz = _emulate_u(moves, 1.5, k)
        assert torch.equal(e_stack.view(torch.int32),
                           stack.view(torch.int32)), k
        assert torch.equal(e_lz.view(torch.int32), lz.view(torch.int32)), k
        e_grad = _emulate_v(moves, 1.5, stack, lz, cot, k)
        assert torch.equal(e_grad.view(torch.int32),
                           grad.view(torch.int32)), k


@pytest.mark.parametrize("S", [512, 1024])
def test_decode_plan_f32_slots_fit_the_card(S):
    """GW's and JW's passes on B's and C's ring over the head product's f32
    moves: a slot of 16S bytes (21S with C's move_in and choices), rings of
    8 frames within the card's shared memory at S 512 and 1024, the bf16
    plan's threads."""
    plan = decode_cuda.decode_plan(96, 1666, S, SMS, torch.float32)
    bf16 = decode_cuda.decode_plan(96, 1666, S, SMS)
    assert plan["threads"] == bf16["threads"] and plan["ctas"] == 96
    for name, backward in (("fwd", False), ("bwd", True)):
        ring = plan[name]["ring"]
        assert ring == decode_cuda.RING
        assert plan[name]["smem"] == decode_cuda.ring_smem(S, ring, backward,
                                                           16 * S)
        assert bf16[name]["smem"] < plan[name]["smem"] <= SMEM
    if S == 1024:
        assert (plan["fwd"]["smem"], plan["bwd"]["smem"]) == (148288, 183104)


# (N, Th, H, cols): hac (U 1, S 1024), sup (U 2), ragged rows (N * Th no
# multiple of 128), one row, S 512, the card tests' shapes
PRODUCT_SHAPES = [(96, 1666, 1024, 4096), (128, 1000, 512, 8192),
                  (5, 11, 512, 8192), (1, 1, 16, 4096), (2, 13, 256, 2048),
                  (3, 19, 64, 4096), (4, 24, 1024, 4096), (9, 37, 32, 2048)]


@pytest.mark.parametrize("N,Th,H,cols", PRODUCT_SHAPES)
def test_product_plan_fits_the_card(N, Th, H, cols):
    """GW's head product: 128 x 128 tiles of 256 threads, 16 k a step,
    two f32 tiles and a ring of 4 bf16 slots (64 KB, two CTAs an SM within
    the SM's 228 KB), a persistent grid of at most two CTAs an SM."""
    plan = decode_fused_cuda.product_plan(N, Th, H, cols, SMS)
    assert plan["tile"] == (128, 128, 16) and plan["threads"] == 256
    assert plan["tiles_m"] == -(-N * Th // 128)
    assert plan["tiles_n"] * 128 == cols
    assert plan["tiles"] == plan["tiles_m"] * plan["tiles_n"]
    assert plan["ctas"] == min(plan["tiles"], 2 * SMS)
    assert plan["waves"] == -(-plan["tiles"] // plan["ctas"])
    assert plan["k_steps"] * 16 == H
    assert plan["smem"] == 2 * 16 * 256 * 4 + 4 * 256 * 16 * 2 == 65536
    assert plan["ctas_per_sm"] * (plan["smem"] + 1024) <= 233472


def test_product_plan_at_hac_and_sup():
    """hac: 159,936 rows by 4096 columns, 1250 x 32 tiles over 264 CTAs,
    64 k steps; sup: 128,000 rows by 8192, 1000 x 64 tiles, 32 k steps."""
    hac = decode_fused_cuda.product_plan(96, 1666, 1024, 4096, SMS)
    sup = decode_fused_cuda.product_plan(128, 1000, 512, 8192, SMS)
    for plan, want in ((hac, (1250, 32, 40000, 64, 152)),
                       (sup, (1000, 64, 64000, 32, 243))):
        assert (plan["tiles_m"], plan["tiles_n"], plan["tiles"],
                plan["k_steps"], plan["waves"]) == want
        assert plan["ctas"] == 264
    assert decode_fused_cuda.wide_decode_plan(96, 1666, 1024, 1024, 1,
                                              SMS) == {
        "product": hac, "fwd": {"ring": 8, "smem": 148288},
        "bwd": {"ring": 8, "smem": 183104}}


@pytest.mark.parametrize("N,Th,H,cols", [
    (4, 5, 1000, 4096), (4, 5, 8, 4096), (4, 5, 1024, 4000),
    (4, 5, 1024, 64), (0, 5, 64, 4096), (4, 0, 64, 4096)])
def test_product_plan_refuses_what_the_kernel_does_not_take(N, Th, H, cols):
    """H no multiple of 16 (or below it), columns no multiple of 128 (or
    fewer), empty shapes: no plan, and the wrapper raises."""
    assert decode_fused_cuda.product_plan(N, Th, H, cols, SMS) is None
    S = cols // 4
    if N and Th and S and S & (S - 1) == 0:
        assert decode_fused_cuda.wide_decode_plan(N, Th, H, S, 1,
                                                  SMS) is None


@pytest.mark.parametrize("N,Th,H,cols", PRODUCT_SHAPES)
def test_product_ctas_cover_every_output_tile_once(N, Th, H, cols):
    """CTA b of the persistent grid takes tiles b, b + ctas, ... (column
    tile fastest): every tile once, and so every output (row n * Th + th,
    column p * 4S + c) once, the ragged rows past N * Th stored by none;
    CTAs in flight together work on at most a few row panels."""
    plan = decode_fused_cuda.product_plan(N, Th, H, cols, SMS)
    M, bm, bn = N * Th, 128, 128
    taken = torch.zeros(plan["tiles"], dtype=torch.int32)
    for b in range(plan["ctas"]):
        taken[b::plan["ctas"]] += 1
    assert (taken == 1).all()
    # tile t's outputs: rows m0 .. m0 + 127 (those below M stored), columns
    # c0 .. c0 + 127; the tiles' corners are every (m0, c0) once
    t = torch.arange(plan["tiles"])
    m0, c0 = t // plan["tiles_n"] * bm, t % plan["tiles_n"] * bn
    corners = set(zip(m0.tolist(), c0.tolist()))
    assert corners == {(m, c) for m in range(0, M, bm)
                       for c in range(0, cols, bn)}
    assert int(m0.max()) < M <= int(m0.max()) + bm
    first_wave = range(min(plan["ctas"], plan["tiles"]))
    panels = {t // plan["tiles_n"] for t in first_wave}
    assert len(panels) <= -(-2 * SMS // plan["tiles_n"]) + 1


# ---------------------------------------------------------------------------
# A and F in f32 (csrc/lstm_f32.cu)
# ---------------------------------------------------------------------------

# (N, H): the GPU tests' and chip_smoke.py's shapes, evaluate's (N 256) and
# the --no-amp validation's (N 16) at hac's and the old-style model's H,
# basecall's N 96, narrow H, and row groups
A32_SHAPES = [(N, H) for N in (16, 96, 256) for H in (768, 1024)] + [
    (8, 16), (33, 48), (40, 64), (96, 128), (200, 96), (96, 272),
    (300, 1024), (513, 1024), (1, 1024)]


@pytest.mark.parametrize("N,H", A32_SHAPES)
def test_f32_plan_fits_the_card(N, H):
    """What the C entry (``csrc/lstm_f32.cu:lstm_recurrence_f32_persistent``)
    takes: H / 8 CTAs within the SMs, one a launch's rows in warp tiles of
    32, k-slices 1, 2, 4 or 8 with at most 12 consumer warps and a producer,
    chunks dividing H in multiples of 8 k a k-slice, 2 to 8 slots, and
    227 KB of shared memory at most."""
    plan = lstm_cuda.f32_plan(N, H, SMS)
    assert plan is not None
    assert plan["ctas"] == H // 8 <= SMS and plan["units"] == 8
    assert plan["smem"] == lstm_cuda.f32_smem_bytes(
        H, plan["rows"], plan["k_slices"], plan["kc"], plan["stages"])
    assert plan["smem"] <= SMEM
    assert plan["rows"] % 32 == 0 and plan["rows"] <= 256
    assert plan["rows"] >= plan["n_launch"] > plan["rows"] - 32
    assert plan["row_tiles"] == plan["rows"] // 32
    assert plan["k_slices"] in (1, 2, 4, 8)
    assert plan["row_tiles"] * plan["k_slices"] <= 12
    assert plan["warps"] == plan["row_tiles"] * plan["k_slices"] + 1
    assert plan["threads"] == 32 * plan["warps"] <= 416
    assert H % plan["kc"] == 0 and plan["kc"] % (8 * plan["k_slices"]) == 0
    assert 2 <= plan["stages"] <= max(2, min(8, H // plan["kc"]))


@pytest.mark.parametrize("N,H", A32_SHAPES)
def test_f32_plan_covers_every_row_unit_and_k_once(N, H):
    """The wrapper's row groups, each CTA's 8 units of every row of its
    launch (padding rows computed, never written), and within a CTA the
    consumer warps (row tile, k-slice) over each chunk's kc / k_slices k:
    every (row, unit) updated once, and every (row, k) of each gate column
    summed once, in one warp's order."""
    plan = lstm_cuda.f32_plan(N, H, SMS)
    starts = list(range(0, N, plan["n_launch"]))
    assert len(starts) == plan["launches"]
    owner = torch.zeros(N, H, dtype=torch.int32)
    for n0 in starts:
        rows = min(plan["n_launch"], N - n0)
        for cta in range(plan["ctas"]):  # blockIdx.x: units 8 cta ..
            owner[n0:n0 + rows, 8 * cta:8 * cta + 8] += 1
    assert (owner == 1).all()
    R, kc, ks = plan["rows"], plan["kc"], plan["k_slices"]
    summed = torch.zeros(R, H, dtype=torch.int32)
    kn = kc // ks
    for warp in range(plan["row_tiles"] * ks):
        rt, slice_ = warp % plan["row_tiles"], warp // plan["row_tiles"]
        for ch in range(H // kc):
            k0 = ch * kc + slice_ * kn
            summed[32 * rt:32 * rt + 32, k0:k0 + kn] += 1
    assert (summed == 1).all()


def test_f32_plan_at_hac_and_evaluate():
    """hac's basecall batch (N 96): 128 CTAs of 96 rows, 3 row tiles x 4
    k-slices and a producer warp, chunks of 64 k in 3 slots beside W_hh's
    128 KB and the step's xw (96 rows of 40); evaluate's batch (N 256): 256
    rows, 8 tiles of all k (one k-slice), chunks of 16 k in 3 slots; the
    --no-amp validation's (N 16): 32 rows, 8 k-slices, chunks of 128 k in 4
    slots. One launch each."""
    hac = lstm_cuda.f32_plan(96, 1024, SMS)
    assert (hac["ctas"], hac["rows"], hac["row_tiles"], hac["k_slices"],
            hac["threads"], hac["kc"], hac["stages"], hac["launches"]) == (
        128, 96, 3, 4, 416, 64, 3, 1)
    # the ring (3 x 64 k x 104) over the partial sums (4 x 96 rows x 40)
    assert hac["smem"] == (1024 * 32 + 3 * 64 * 104 + 96 * 40) * 4 + 48
    assert hac["smem"] == 226352 and 3 * 64 * 104 > 4 * 96 * 40
    ev = lstm_cuda.f32_plan(256, 1024, SMS)
    assert (ev["rows"], ev["row_tiles"], ev["k_slices"], ev["threads"],
            ev["kc"], ev["stages"]) == (256, 8, 1, 288, 16, 3)
    assert ev["smem"] == (1024 * 32 + 3 * 16 * 264 + 256 * 40) * 4 + 48
    val = lstm_cuda.f32_plan(16, 1024, SMS)
    assert (val["rows"], val["k_slices"], val["kc"], val["stages"]) == (
        32, 8, 128, 4)


@pytest.mark.parametrize("N,H,sms", [(8, 2048, SMS), (96, 1536, SMS),
                                     (96, 1024, 127), (256, 1600, 1000),
                                     (16, 1792, 1000)])
def test_f32_plan_gives_none_where_w_hh_cannot_be_held(N, H, sms):
    """H / 8 CTAs beyond the SMs (H 2048 and 1536 on an H100, H 1024 on a
    card of 127), or W_hh's slice (128 H bytes) and a ring of two chunks
    beyond 227 KB (H 1600 and 1792 on a card of any size): no plan, and
    the wrapper takes the earlier f32 kernel."""
    assert lstm_cuda.f32_plan(N, H, sms) is None


def test_f32_plan_row_groups():
    """Rows beyond 256 a launch go to further launches of even size."""
    plan = lstm_cuda.f32_plan(513, 1024, SMS)
    assert (plan["launches"], plan["n_launch"], plan["rows"]) == (3, 171, 192)


@pytest.mark.parametrize("N,H", [(0, 1024), (8, 24), (8, 8)])
def test_f32_plan_rejects_what_a_does_not_take(N, H):
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_cuda.f32_plan(N, H, SMS)


# (N, C, H, rows a block): the fewest rows that fit the grid on 132 SMs
F32_SHAPES = [(1024, 96, 96, 8), (256, 96, 96, 2), (16, 96, 96, 1),
              (132, 96, 96, 1), (133, 96, 96, 2), (528, 96, 96, 4),
              (2000, 96, 96, 8), (37, 64, 128, 1), (20, 1024, 256, 1),
              (300, 1024, 256, 4), (9, 32, 32, 1), (19, 32, 48, 1)]


@pytest.mark.parametrize("N,C,H,rows", F32_SHAPES)
def test_f32_plan_of_kernel_f_fills_the_card(N, C, H, rows):
    """F's f32 kernel: the fewest rows a block (1, 2, 4, 8) whose grid fits
    one wave of the SMs (8 beyond), so evaluate's N 256 runs 128 blocks
    and the validation's N 16 runs 16 (the earlier kernel: 32 and 2);
    4H threads; the x product a block of up to 32 steps, the most that
    fit and fill the passes of 32 (step, row)s where any does; W_ih in
    shared memory where it fits beside a block of one step; 227 KB at
    most, as ``csrc/lstm_f32.cu:
    f32_rows_smem_floats`` counts it."""
    plan = lstm_fused_cuda.f32_plan(N, C, H, SMS)
    assert plan["rows"] == rows and plan["ctas"] == -(-N // rows)
    assert plan["ctas"] <= SMS or rows == 8
    assert plan["threads"] == 4 * H
    assert plan["whh_in_registers"] == (H == 96)
    assert 1 <= plan["block"] <= 32
    assert plan["smem"] == lstm_fused_cuda.f32_smem_bytes(
        C, H, rows, plan["block"], plan["wih_in_smem"]) <= SMEM
    # the most steps that fit, of those that fill the passes where one does
    fit = [b for b in range(1, 33) if lstm_fused_cuda.f32_smem_bytes(
        C, H, rows, b, plan["wih_in_smem"]) <= SMEM]
    whole = [b for b in fit if b * rows % 32 == 0]
    assert plan["block"] == max(whole or fit)
    assert plan["wih_in_smem"] == (lstm_fused_cuda.f32_smem_bytes(
        C, H, rows, 1, True) <= SMEM)


def test_f32_plan_of_kernel_f_at_fast_and_evaluate():
    """fast (N 1024): 128 blocks of 8 rows, the x product 4 steps a pass,
    W_ih's 144 KB beside them; evaluate (N 256): 128 blocks of 2 rows, 16
    steps a pass; the validation (N 16): 16 blocks of one row, 32 steps."""
    fast = lstm_fused_cuda.f32_plan(1024, 96, 96, SMS)
    assert (fast["ctas"], fast["rows"], fast["block"], fast["smem"]) == (
        128, 8, 4, 4 * (96 * 384 + 4 * 8 * 384 + 2 * 4 * 8 * 96
                        + 2 * 8 * 96))
    ev = lstm_fused_cuda.f32_plan(256, 96, 96, SMS)
    assert (ev["ctas"], ev["rows"], ev["block"]) == (128, 2, 16)
    val = lstm_fused_cuda.f32_plan(16, 96, 96, SMS)
    assert (val["ctas"], val["rows"], val["block"]) == (16, 1, 32)
    assert all(p["wih_in_smem"] and p["whh_in_registers"]
               for p in (fast, ev, val))


@pytest.mark.parametrize("N,C,H", [(0, 96, 96), (8, 104, 96), (8, 96, 272),
                                   (8, 1040, 96), (8, 96, 8)])
def test_f32_plan_of_kernel_f_refuses_what_f_does_not_take(N, C, H):
    with pytest.raises(ValueError, match="kernel F"):
        lstm_fused_cuda.f32_plan(N, C, H, SMS)
    with pytest.raises(ValueError, match="kernel F"):
        lstm_fused_cuda.f32_old_layout(N, C, H)


# ---------------------------------------------------------------------------
# S in f32 (csrc/lstm_f32.cu)
# ---------------------------------------------------------------------------

# (N, H): the --no-amp batch (16), the train CLI's default batch (64), hac
# training's (128), two row groups (300), at hac's, the old-style model's
# and fast's H, and narrow H
S32_SHAPES = [(N, H) for N in (16, 64, 128, 300) for H in (96, 768, 1024)
              ] + [(8, 16), (33, 48), (1, 1024), (256, 1024), (513, 96)]


@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("N,H", S32_SHAPES)
def test_f32_backward_plan_fits_the_card(N, H, round_bf16):
    """What the C entry (``csrc/lstm_f32.cu:lstm_train_bwd_f32_persistent``)
    takes: H / 8 CTAs within the SMs, a launch's rows in warp tiles of 16
    (at most 256), k-slices 1, 2, 4 or 8 with at most 16 consumer warps and
    a producer, chunks dividing 4H in multiples of 8 k a k-slice, 2 to 8
    slots, and 227 KB of shared memory at most."""
    plan = lstm_train_cuda.f32_backward_plan(N, H, SMS, round_bf16)
    assert plan is not None and plan["dtype"] == "f32"
    assert plan["ctas"] == H // 8 <= SMS and plan["units"] == 8
    assert plan["smem"] == lstm_train_cuda.f32_backward_smem(
        H, plan["rows"], plan["k_slices"], plan["kc"], plan["stages"],
        round_bf16)
    assert plan["smem"] <= SMEM
    assert plan["rows"] % 16 == 0 and plan["rows"] <= 256
    assert plan["rows"] >= plan["n_launch"] > plan["rows"] - 16
    assert plan["launches"] == -(-N // 256)
    assert plan["row_tiles"] == plan["rows"] // 16
    assert plan["k_slices"] in (1, 2, 4, 8)
    assert plan["row_tiles"] * plan["k_slices"] <= 16
    assert plan["warps"] == plan["row_tiles"] * plan["k_slices"] + 1
    assert plan["threads"] == 32 * plan["warps"] <= 544
    G = 4 * H
    assert G % plan["kc"] == 0 and plan["kc"] % (8 * plan["k_slices"]) == 0
    assert plan["kc"] <= 512
    assert 2 <= plan["stages"] <= max(2, min(8, G // plan["kc"]))
    # the ring's row stride: 8 lanes' 16-byte loads (4 row groups of 4 rows
    # x two k) on distinct banks, 16 floats past a multiple of 32
    assert plan["ldr"] >= plan["rows"] and plan["ldr"] % 32 == 16


@pytest.mark.parametrize("N,H", S32_SHAPES)
def test_f32_backward_plan_covers_every_row_unit_and_k_once(N, H):
    """The wrapper's row groups, each CTA's 8 units of every row of its
    launch (padding rows computed, never written), and within a CTA the
    consumer warps (row tile, k-slice) and their lanes (row group, k lane)
    over every 8th k of each chunk's kc / k_slices: every (row, unit)
    updated once, and every (row, k) of dh = dgates @ W_hh^T summed once."""
    plan = lstm_train_cuda.f32_backward_plan(N, H, SMS)
    starts = list(range(0, N, plan["n_launch"]))
    assert len(starts) == plan["launches"]
    owner = torch.zeros(N, H, dtype=torch.int32)
    for n0 in starts:
        rows = min(plan["n_launch"], N - n0)
        for cta in range(plan["ctas"]):  # blockIdx.x: units 8 cta ..
            owner[n0:n0 + rows, 8 * cta:8 * cta + 8] += 1
    assert (owner == 1).all()
    R, kc, ks, G = plan["rows"], plan["kc"], plan["k_slices"], 4 * H
    summed = torch.zeros(R, G, dtype=torch.int32)
    kn = kc // ks
    for warp in range(plan["row_tiles"] * ks):
        rt, slice_ = warp % plan["row_tiles"], warp // plan["row_tiles"]
        for lane in range(32):
            rg, kl = lane & 3, lane >> 2
            r0 = 16 * rt + 4 * rg
            for ch in range(G // kc):
                k0 = ch * kc + slice_ * kn + kl
                summed[r0:r0 + 4, k0:k0 + kn:8] += 1
    assert (summed == 1).all()


def test_f32_backward_plan_at_the_no_amp_batch_and_hac_training():
    """The --no-amp batch (N 16, H 1024): 128 CTAs of 16 rows, one row
    tile x 8 k-slices and a producer warp, chunks of 512 k in 3 slots
    beside W_hh's 8 rows (128 KB) and the step's inputs (16 rows of 128
    bytes in bf16); the CLI's default batch (N 64): 4 tiles x 4 slices,
    chunks of 64 k in 4 slots (rows of 80 floats); hac training's (N 128):
    8 tiles x 2 slices, chunks of 32 k in 4 slots (rows of 144). One
    launch each."""
    val = lstm_train_cuda.f32_backward_plan(16, 1024, SMS)
    assert (val["ctas"], val["rows"], val["row_tiles"], val["k_slices"],
            val["threads"], val["kc"], val["stages"], val["launches"],
            val["ldr"]) == (128, 16, 1, 8, 288, 512, 3, 1, 16)
    assert val["smem"] == (4096 * 8 + 3 * 512 * 16) * 4 + 16 * 128 + 48
    cli = lstm_train_cuda.f32_backward_plan(64, 1024, SMS)
    assert (cli["rows"], cli["row_tiles"], cli["k_slices"], cli["kc"],
            cli["stages"], cli["ldr"]) == (64, 4, 4, 64, 4, 80)
    hac = lstm_train_cuda.f32_backward_plan(128, 1024, SMS)
    assert (hac["rows"], hac["row_tiles"], hac["k_slices"], hac["kc"],
            hac["stages"], hac["ldr"], hac["launches"]) == (
        128, 8, 2, 32, 4, 144, 1)


@pytest.mark.parametrize("N,H,sms", [(16, 2048, SMS), (300, 2048, 1000),
                                     (16, 1536, SMS), (16, 1024, 127)])
def test_f32_backward_plan_gives_none_where_w_hh_cannot_be_held(N, H, sms):
    """H / 8 CTAs beyond the SMs (H 1536 and 2048 on an H100, H 1024 on a
    card of 127), or W_hh's 8 rows (128 H bytes) and a ring of two chunks
    beyond 227 KB (H 2048 on a card of any size): no plan, and the wrapper
    takes the step kernel."""
    assert lstm_train_cuda.f32_backward_plan(N, H, sms) is None
    assert lstm_train_cuda.backward_plan(N, H, sms, RESIDENT,
                                         torch.float32) is None
