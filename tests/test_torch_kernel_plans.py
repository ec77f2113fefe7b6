"""The pure-Python shape rules of kernels A and L (``ops.lstm_cuda.
persistent_plan``, ``ops.attention_cuda.padded_head_dim``): what each
launch asks of the card, that A's CTAs cover every row and unit once, and
the head dim L's bf16 instance runs at. Each is what the wrapper passes to
its kernel. They run here, on the CPU; the kernels themselves, and L's
tiling, which is fixed in the kernel, only on the card
(tests/test_torch_gpu.py)."""

import pytest

from bonito_tpu_torch.ops import attention_cuda, lstm_cuda

SMS = 132             # an H100's SMs
SMEM = 232448         # the most shared memory a block may ask for

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
