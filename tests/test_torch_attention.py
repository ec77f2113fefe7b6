"""The port's attention and layout-pin ops on the CPU against bonito_tpu:
the plain version of kernel K against ``fused_rotary_window_attention`` in
interpret mode and against the exact path, the plain version of kernel L
against ``local_attention_pallas`` in interpret mode, ``dense_attention``
and ``attend``'s padded path, the plain version of kernel P and the plan
that picks P's variant, and the shape gates."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu.ops import attention as jattention
from bonito_tpu.ops import attention_pallas as jpallas
from bonito_tpu.transformer.model import apply_rotary as jax_apply_rotary
from bonito_tpu.transformer.model import rotary_freqs as jax_rotary_freqs
from bonito_tpu_torch.ops import attention, attention_cuda, relayout
from bonito_tpu_torch.transformer.model import apply_rotary, rotary_freqs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _bf16_step(a):
    """One bf16 step at magnitude ``a`` (8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _f32(x):
    return np.asarray(x.astype(jnp.float32))


# ---------------------------------------------------------------------------
# kernel K's plain version
# ---------------------------------------------------------------------------

K_CASES = [
    # N, T, H, D, rotary_dim, window, t_real
    (2, 256, 2, 64, 64, (127, 128), None),   # T a block multiple
    (2, 200, 2, 16, 16, (63, 64), None),     # ragged T
    (1, 1000, 2, 16, 16, (127, 128), None),  # the sup token count
    (2, 256, 2, 32, 16, (127, 128), None),   # partial rotary_dim
    (2, 256, 2, 32, 32, (100, 20), 200),     # a stream the caller padded
    (2, 130, 3, 24, 16, (15, 16), None),     # D no multiple of 16
]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,T,H,D,r,window,t_real", K_CASES)
def test_fused_plain_matches_pallas_interpret(N, T, H, D, r, window, t_real,
                                              dtype):
    """Both round to bf16 at the same points (rotary, p / sum, f32
    accumulators), for bf16 and for f32 input, so they differ by f32 sum
    order and a rare flipped rounding only: one bf16 step of the largest
    output on the max, 1e-5 on the mean. The exact path (apply_rotary +
    dense_attention in f32) is 2e-2 away, the tolerance of bonito_tpu's own
    tests of the kernel."""
    rng = np.random.default_rng(T + D + r)
    qkv = rng.normal(size=(N, T, 3, H, D)).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jqkv = jnp.asarray(qkv).astype(jd)
    cos, sin = jax_rotary_freqs(T, r)
    assert jpallas.fused_supported(jqkv, window, r, require_tpu=False)
    ref = _f32(jpallas.fused_rotary_window_attention(
        jqkv, cos, sin, window, 128, True, t_real))
    tqkv = _t(qkv).to(td)
    assert attention_cuda.fused_supported(tqkv, window, r)
    tcos, tsin = rotary_freqs(T, r)
    out = attention_cuda.fused_rotary_window_attention(tqkv, tcos, tsin,
                                                       window, t_real)
    assert out.shape == (N, T, H, D) and out.dtype == td
    real = slice(None, t_real)  # rows beyond t_real are the caller's padding
    err = np.abs(out.float().numpy() - ref)[:, real]
    assert err.max() <= _bf16_step(np.abs(ref).max())
    assert err.mean() <= 1e-5
    if t_real is None:
        q, k, v = (jnp.swapaxes(t, 1, 2) for t in (
            jax_apply_rotary(jqkv[:, :, 0].astype(jnp.float32), cos, sin),
            jax_apply_rotary(jqkv[:, :, 1].astype(jnp.float32), cos, sin),
            jqkv[:, :, 2].astype(jnp.float32)))
        exact = np.asarray(jnp.swapaxes(
            jattention.dense_attention(q, k, v, window), 1, 2))
        np.testing.assert_allclose(out.float().numpy(), exact, atol=2e-2)


def test_fused_plain_gives_zero_where_no_key_is_visible():
    """Queries at and beyond t_real + left see nothing: 0, no NaN."""
    qkv = torch.randn(1, 64, 3, 1, 16, generator=torch.Generator().manual_seed(0))
    cos, sin = rotary_freqs(64, 16)
    out = attention_cuda.fused_rotary_window_attention_plain(
        qkv, cos, sin, (3, 4), t_real=20)
    assert torch.isfinite(out).all()
    assert (out[:, 23:] == 0).all() and (out[:, :23].abs().sum(-1) > 0).all()


@pytest.mark.parametrize("shape,window,r,ok", [
    ((2, 1000, 3, 8, 64), (127, 128), 64, True),
    ((2, 1000, 3, 8, 64), (127, 128), 32, True),
    ((2, 77, 3, 8, 24), (0, 0), 16, True),
    ((2, 1000, 3, 8, 40), (127, 128), 40, False),   # rotary_dim % 16
    ((2, 1000, 3, 8, 64), (128, 128), 64, False),   # left fills the block
    ((2, 1000, 3, 8, 64), (127, 129), 64, False),
    ((2, 1000, 3, 8, 20), (127, 128), 16, False),   # D % 8
    ((2, 1000, 3, 8, 32), (127, 128), 48, False),   # rotary_dim > D
])
def test_fused_gate_is_bonito_tpu_s_without_the_tpu_terms(shape, window, r, ok):
    assert attention_cuda.fused_supported(torch.empty(shape), window, r) == ok
    assert bool(jpallas.fused_supported(
        jnp.zeros(shape, jnp.bfloat16), window, r, require_tpu=False)) == ok


def test_fused_gate_limits_the_head_to_what_the_kernel_holds():
    """bonito_tpu bounds T by a VMEM budget instead; the port bounds D."""
    assert attention_cuda.fused_supported(
        torch.empty(1, 100000, 3, 8, 128), (127, 128), 128)
    assert not attention_cuda.fused_supported(
        torch.empty(1, 8, 3, 8, 256), (127, 128), 128)
    assert not attention_cuda.fused_supported(
        torch.empty(1, 8, 3, 8, 64), None, 64)


# ---------------------------------------------------------------------------
# kernel L's plain version, dense_attention, attend
# ---------------------------------------------------------------------------

def _qkv(seed, N, H, T, D):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(N, H, T, D)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("T,window", [(256, (127, 128)), (128, (127, 128)),
                                      (256, (63, 64)), (384, (100, 20))])
def test_local_plain_matches_pallas_interpret_and_dense(T, window):
    """f32 at 2e-5, the tolerance of bonito_tpu's own test of the kernel."""
    q, k, v = _qkv(T, 2, 3, T, 16)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    out = attention_cuda.local_attention(_t(q), _t(k), _t(v), window).numpy()
    kernel = jpallas.local_attention_pallas(jq, jk, jv, window, interpret=True)
    dense = jattention.dense_attention(jq, jk, jv, window)
    np.testing.assert_allclose(out, np.asarray(kernel), atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(dense), atol=2e-5)


@pytest.mark.parametrize("T", [200, 77])
def test_attend_takes_a_ragged_t_without_padding(T):
    """bonito_tpu's ``attend`` pads a ragged T to the block with masked
    keys; the port's banded route takes T as it is."""
    window = (127, 128)
    q, k, v = _qkv(T, 2, 2, T, 8)
    ref = jattention.attend(*(jnp.asarray(a) for a in (q, k, v)), window)
    out = attention.attend(_t(q), _t(k), _t(v), window)
    assert out.shape == (2, 2, T, 8)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)


@pytest.mark.parametrize("window", [None, (-1, -1), (200, 300), (127, 128)])
def test_attend_dispatch_by_shape(window, monkeypatch):
    """No window and (-1, -1): dense; a band over the 128-block: dense
    with the mask; a band that fits: the banded op. All agree with
    bonito_tpu's ``attend``."""
    calls = []
    monkeypatch.setattr(attention, "local_attention", lambda *a: (
        calls.append("local"), attention_cuda.local_attention(*a))[1])
    q, k, v = _qkv(5, 1, 2, 256, 8)
    ref = jattention.attend(*(jnp.asarray(a) for a in (q, k, v)), window)
    out = attention.attend(_t(q), _t(k), _t(v), window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5)
    assert calls == (["local"] if window == (127, 128) else [])


def test_dense_attention_and_mask_match_bonito_tpu_in_bf16():
    """bf16: scores and softmax in f32, probabilities rounded to bf16
    before the second product, as bonito_tpu's."""
    q, k, v = _qkv(9, 2, 2, 96, 16)
    window = (20, 10)
    np.testing.assert_array_equal(
        attention.sliding_window_mask(96, window).numpy(),
        np.asarray(jattention.sliding_window_mask(96, window)))
    ref = jattention.dense_attention(
        *(jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)), window)
    out = attention.dense_attention(
        *(_t(a).to(torch.bfloat16) for a in (q, k, v)), window)
    assert out.dtype == torch.bfloat16
    err = np.abs(out.float().numpy() - _f32(ref))
    assert err.max() <= _bf16_step(np.abs(_f32(ref)).max())


def test_rotary_tables_and_apply_rotary_match_bonito_tpu():
    T, r = 300, 32
    cos, sin = rotary_freqs(T, r)
    jcos, jsin = jax_rotary_freqs(T, r)
    np.testing.assert_array_equal(cos.numpy(), np.asarray(jcos))
    np.testing.assert_array_equal(sin.numpy(), np.asarray(jsin))
    assert rotary_freqs(T, r)[0] is cos  # cached per (T, r, device)
    x = np.random.default_rng(1).normal(size=(2, T, 3, 48)).astype(np.float32)
    np.testing.assert_allclose(
        apply_rotary(_t(x), cos, sin).numpy(),
        np.asarray(jax_apply_rotary(jnp.asarray(x), jcos, jsin)), atol=1e-6)


def test_attention_wrappers_take_the_plain_versions_on_the_cpu():
    qkv = torch.randn(1, 40, 3, 2, 16, generator=torch.Generator().manual_seed(2))
    cos, sin = rotary_freqs(40, 16)
    fused, local = (attention_cuda.fused_rotary_window_attention,
                    attention_cuda.local_attention)
    before = fused.launches, local.launches
    torch.testing.assert_close(
        fused(qkv, cos, sin, (7, 8)),
        attention_cuda.fused_rotary_window_attention_plain(
            qkv, cos, sin, (7, 8)), rtol=0, atol=0)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    torch.testing.assert_close(
        local(q, k, v, (7, 8)),
        attention_cuda.local_attention_plain(q, k, v, (7, 8)), rtol=0, atol=0)
    assert (fused.launches, local.launches) == before  # kernel launches only


# ---------------------------------------------------------------------------
# kernel P's plain version and its plan
# ---------------------------------------------------------------------------

def _views():
    g = torch.Generator().manual_seed(3)
    base = torch.randn(4, 48, 40, generator=g)
    return {
        "transposed": base.transpose(1, 2),       # a conv's [N, T, C] view
        "sliced": base[:, 3:41:2, 8:40],          # rows of whole 16 bytes
        "ragged": base[:, 3:41:2, 7:38],
        "contiguous": base,
        "permuted4d": torch.randn(3, 5, 2, 7, generator=g).permute(3, 1, 0, 2),
        "expanded": base[:, :1].expand(4, 6, 40),
    }


@pytest.mark.parametrize("name", list(_views()))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.uint8])
def test_pin_layout_plain_is_a_contiguous_identical_copy(name, dtype):
    x = _views()[name]
    x = (x * 50).to(dtype) if dtype == torch.uint8 else x.to(dtype)
    before = relayout.pin_layout.launches
    out = relayout.pin_layout(x)
    assert relayout.pin_layout.launches == before
    assert out.is_contiguous() and out.dtype == dtype
    assert torch.equal(out, x)
    assert out.data_ptr() != x.data_ptr()  # a copy, even of a contiguous x


def _bits(x):
    """x with numpy's view of its bits (bf16 as int16), strides kept."""
    return x.view(torch.int16) if x.dtype == torch.bfloat16 else x


def _storage_elements(x, unit):
    """x's storage from its first element, as integers of ``unit`` bytes."""
    x = _bits(x)
    item = x.element_size()
    whole = torch.as_strided(x, (x.untyped_storage().nbytes() // item,),
                             (1,), 0)
    raw = whole.numpy().view(np.uint8)[x.storage_offset() * item:]
    return raw[:len(raw) // unit * unit].view(
        {1: np.uint8, 2: np.uint16, 4: np.uint32}[unit])


def _run_plan(plan, x):
    """What kernel P's variant computes, with numpy on x's storage."""
    raw = _storage_elements(x, 1)
    if plan[0] in ("transpose", "tiles"):
        _, B, R, C, sb, sc, unit = plan
        sizes, strides = [B, R, C], [sb, 1, sc]
    else:
        _, sizes, strides, unit = plan
    sizes, strides = list(sizes), [s * unit for s in strides]
    view = np.lib.stride_tricks.as_strided(
        raw, shape=sizes + [unit], strides=strides + [1])
    return np.ascontiguousarray(view).reshape(-1)


def _run_tiles(plan, x):
    """Kernel P's tile transpose (``relayout_transpose_tiles`` in
    ``csrc/relayout.cu``) step by step with numpy: each block's tile of 32
    R by 64 words of C, a warp's lanes on 32 consecutive R of one column,
    bf16 pairs of columns packed into a word, then 16-byte or element
    stores. Returns the output's bytes and how often each element was
    written."""
    _, B, R, C, sb, sc, unit = plan
    src = _storage_elements(x, unit)
    epw, tc = 4 // unit, 64 * (4 // unit)
    n_rt, n_ct = -(-R // 32), -(-C // tc)
    vec = C % (16 // unit) == 0  # the output comes from torch.empty
    out = np.zeros(B * R * C, src.dtype)
    writes = np.zeros(B * R * C, np.int64)
    lane = np.arange(32)
    for blk in range(B * n_rt * n_ct):
        rt, ct, b = blk % n_rt, blk // n_rt % n_ct, blk // (n_rt * n_ct)
        r0, c0 = rt * 32, ct * tc
        tile = np.zeros((64, 33), np.uint64)
        r = r0 + lane
        for w in range(64):  # word w = warp + 8 i, loaded by warp w % 8
            for k in range(epw):
                c = c0 + w * epw + k
                live = (r < R) & (c < C)
                v = np.zeros(32, np.uint64)
                v[live] = src[b * sb + c * sc + r[live]]
                tile[w, :32] |= v << (16 * k)
        base = b * R * C
        if vec:
            for e in range(32 * 16):
                rl, ch = divmod(e, 16)
                rr, c = r0 + rl, c0 + ch * 4 * epw
                if rr < R and c < C:
                    at = base + rr * C + c
                    assert at * unit % 16 == 0  # a whole, aligned store
                    words = tile[4 * ch:4 * ch + 4, rl]
                    vals = [(wd >> (16 * k)) & (2 ** (8 * unit) - 1)
                            for wd in words for k in range(epw)]
                    out[at:at + 4 * epw] = vals
                    writes[at:at + 4 * epw] += 1
        else:
            for e in range(32 * tc):
                rl, cl = divmod(e, tc)
                rr, c = r0 + rl, c0 + cl
                if rr < R and c < C:
                    at = base + rr * C + c
                    out[at] = (int(tile[cl // epw, rl]) >> (16 * (cl % epw))
                               ) & (2 ** (8 * unit) - 1)
                    writes[at] += 1
    return out.view(np.uint8), writes


@pytest.mark.parametrize("name,kind,unit", [
    ("transposed", "transpose", 4), ("sliced", "gather", 16),
    ("ragged", "gather", 4),
    ("contiguous", "gather", 16), ("permuted4d", "gather", 4),
    ("expanded", "gather", 16)])
def test_relayout_plan_picks_the_variant_and_addresses_every_element(
        name, kind, unit):
    x = _views()[name]
    plan = relayout.relayout_plan(list(x.shape), list(x.stride()), 4)
    assert (plan[0], plan[-1]) == (kind, unit)
    want = np.frombuffer(x.contiguous().numpy().tobytes(), np.uint8)
    np.testing.assert_array_equal(_run_plan(plan, x), want)
    # an unaligned start: a transposed view takes the tiles (any start),
    # the rest goes to the gather element by element
    loose = relayout.relayout_plan(list(x.shape), list(x.stride()), 4,
                                   aligned=False)
    assert (loose[0], loose[-1]) == (("tiles", 4) if kind == "transpose"
                                     else ("gather", 4))
    np.testing.assert_array_equal(_run_plan(loose, x), want)
    # the earlier kernel P's plan: the same where aligned, the gather for
    # every unaligned view
    assert relayout.relayout_plan(list(x.shape), list(x.stride()), 4,
                                  earlier=True) == plan
    old_loose = relayout.relayout_plan(list(x.shape), list(x.stride()), 4,
                                       aligned=False, earlier=True)
    assert (old_loose[0], old_loose[-1]) == ("gather", 4)
    np.testing.assert_array_equal(_run_plan(old_loose, x), want)


def test_relayout_plan_of_the_sup_stack_input():
    """The conv stack's output at sup widths, [128, 1000, 512] bf16 viewed
    from [128, 512, 1000] memory: the tile transpose."""
    plan = relayout.relayout_plan([128, 1000, 512], [512000, 1, 1000], 2)
    assert plan == ("transpose", 128, 1000, 512, 512000, 1000, 2)
    # T = 999 does not fill 16-byte rows: the tiles of 32 R (the earlier
    # kernel's plan sent it to the gather, element by element)
    plan = relayout.relayout_plan([128, 999, 512], [511488, 1, 999], 2)
    assert plan == ("tiles", 128, 999, 512, 511488, 999, 2)
    old = relayout.relayout_plan([128, 999, 512], [511488, 1, 999], 2,
                                 earlier=True)
    assert old[0] == "gather" and old[-1] == 2
    with pytest.raises(TypeError, match="bytes"):
        relayout.relayout_plan([4, 4], [4, 1], 16)


def test_relayout_plan_of_the_f32_sup_stack_input_at_evaluate():
    """evaluate's sup forward in f32 (256 chunks of 3000 samples: T 250, no
    multiple of 4): the tiles, where the earlier plan took the gather."""
    sizes, strides = [256, 250, 512], [128000, 1, 250]
    assert relayout.relayout_plan(sizes, strides, 4) == (
        "tiles", 256, 250, 512, 128000, 250, 4)
    assert relayout.relayout_plan(sizes, strides, 4, earlier=True) == (
        "gather", sizes, strides, 4)
    # and the bf16 input of a 12000-sample chunk at another stride
    assert relayout.relayout_plan([128, 999, 512], [511488, 1, 999], 2,
                                  aligned=False)[0] == "tiles"


TILE_VIEWS = {
    # ragged R (not a multiple of the 32-row tile), C a multiple of 16 bytes
    "f32 ragged R": lambda g: torch.randn(2, 64, 77, generator=g)
    .transpose(1, 2),
    # an odd C: element stores, the last tile's columns predicated
    "f32 odd C": lambda g: torch.randn(3, 67, 40, generator=g)
    .transpose(1, 2),
    "bf16 odd C": lambda g: torch.randn(2, 131, 45, generator=g)
    .to(torch.bfloat16).transpose(1, 2),
    # an unaligned start (one element in), T 999's kind of stride
    "bf16 unaligned": lambda g: torch.randn(2, 130, 99, generator=g)
    .to(torch.bfloat16)[:, 1:].transpose(1, 2),
    "f32 unaligned": lambda g: torch.randn(2 * 64 * 250 + 1, generator=g)
    [1:].view(2, 64, 250).transpose(1, 2),
    # two dimensions (C a multiple of 16 bytes: 16-byte stores), and a
    # batch of stride 0
    "bf16 2d": lambda g: torch.randn(200, 70, generator=g)
    .to(torch.bfloat16).t(),
    "f32 expanded": lambda g: torch.randn(1, 80, 33, generator=g)
    .expand(3, 80, 33).transpose(1, 2),
}


@pytest.mark.parametrize("name", list(TILE_VIEWS))
def test_tile_transpose_writes_every_element_once(name):
    """The new variant at shapes the earlier plan gave the gather: every
    output element written once, with its value, every 16-byte store
    whole and aligned."""
    x = TILE_VIEWS[name](torch.Generator().manual_seed(len(name)))
    aligned = x.storage_offset() * x.element_size() % 16 == 0
    plan = relayout.relayout_plan(list(x.shape), list(x.stride()),
                                  x.element_size(), aligned=aligned)
    assert plan[0] == "tiles"
    got, writes = _run_tiles(plan, x)
    assert (writes == 1).all()
    want = np.frombuffer(_bits(x.contiguous()).numpy().tobytes(), np.uint8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_run_plan(plan, x), want)


# ---------------------------------------------------------------------------
# kernel K's f32 staging (``StageF32`` of ``csrc/attention_window.cu``)
# ---------------------------------------------------------------------------

def _swz(row, c, dp):
    """``swz<DP>``: the element offset of chunk c of ``row`` in a tile."""
    x = (row & 7) if dp // 8 >= 8 else ((row >> 1) & 3)
    return row * dp + ((c ^ x) << 3)


def _bf16_values(a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(
        torch.bfloat16).float().numpy()


def _stage_f32_step(x, cos, sin, q_tile, k_ring, v_ring, q0, b_lo, b_hi,
                    dims, writes):
    """One step of the f32 staging as the kernel walks it: its units (a
    rotary pair of chunks of q or k, a plain chunk of v or of q and k
    beyond the rotary dim) numbered as ``StageF32::load`` numbers them and
    dealt to NT threads in batches of RB; each unit rotated in f32 (every
    product and sum rounded on its own), rounded to bf16 and stored at its
    swizzled place, or zeros for a row at or beyond T (q) or t_real (k, v).
    ``x`` is one (n, h)'s [T, 3, D] f32 rows; ``writes`` counts each
    element's stores."""
    T, D, r2, t_real, dp, ring, nt, rb = dims
    ch, ch2 = dp // 8, dp // 16
    nblk = max(b_hi - b_lo + 1, 0)
    rch, chd = r2 // 8, D // 8
    tail = chd - 2 * rch
    n_pair = (1 + nblk) * 64 * ch2
    n_v = nblk * 64 * ch
    total = n_pair + n_v + ((1 + nblk) * 64 * ch if tail > 0 else 0)
    nb = -(-total // (nt * rb))
    units = sorted(i + (j * rb + k) * nt for i in range(nt)
                   for j in range(nb) for k in range(rb))
    assert units == list(range(nb * nt * rb))  # each unit one thread's

    def rows(part, tiles):
        if part == 0:
            return "q", q0, T, 0
        b = b_lo + part - 1
        return tiles, b * 64, t_real, (b % ring) * 64 * dp

    for e in range(total):
        pair = e < n_pair
        if pair:
            part, rem = divmod(e, 64 * ch2)
            r, c = divmod(rem, ch2)
            if c >= rch:
                continue
            name, tok0, live, off = rows(part, "k")
            plane = 0 if part == 0 else 1
        else:
            f = e - n_pair
            v = f < n_v
            f -= 0 if v else n_v
            part, rem = divmod(f, 64 * ch)
            part += 1 if v else 0
            r, c = divmod(rem, ch)
            if c >= chd or (not v and c < 2 * rch):
                continue
            name, tok0, live, off = rows(part, "v" if v else "k")
            plane = 2 if v else (0 if part == 0 else 1)
        dst = {"q": q_tile, "k": k_ring, "v": v_ring}[name]
        tok = tok0 + r
        lo = off + _swz(r, c, dp)
        hi = off + _swz(r, c + rch, dp) if pair else None
        if tok >= live:
            vals = [(lo, np.zeros(8, np.float32))]
            if pair:
                vals.append((hi, np.zeros(8, np.float32)))
        else:
            a = x[tok, plane, c * 8:c * 8 + 8]
            if pair:
                b = x[tok, plane, c * 8 + r2:c * 8 + r2 + 8]
                cs = cos[tok, c * 8:c * 8 + 8]
                sn = sin[tok, c * 8:c * 8 + 8]
                vals = [(lo, _bf16_values(a * cs - b * sn)),
                        (hi, _bf16_values(b * cs + a * sn))]
            else:
                vals = [(lo, _bf16_values(a))]
        for at, val in vals:
            dst[at:at + 8] = val
            writes[name][at:at + 8] += 1


def _unswizzle(tile, dp, rows=64):
    out = np.zeros((rows, dp), np.float32)
    for r in range(rows):
        for c in range(dp // 8):
            out[r, c * 8:c * 8 + 8] = tile[_swz(r, c, dp):_swz(r, c, dp) + 8]
    return out


@pytest.mark.parametrize("stretch", ["plan", "all"])
@pytest.mark.parametrize("N,T,H,D,r,window,t_real", [
    (2, 200, 2, 64, 64, (127, 128), None),   # sup's head, a ragged T
    (1, 300, 2, 32, 16, (100, 20), 250),     # partial rotary, t_real < T
    (1, 130, 2, 40, 32, (63, 64), None)])    # D 40 padded to 64, a tail
def test_f32_staging_matches_the_rotated_bf16_rows_and_pallas(
        N, T, H, D, r, window, t_real, stretch):
    """Kernel K's f32 instance stages its ring as the emulation above does
    (the plan's stretch, and one CTA walking every tile so that the ring
    wraps): each staged row equals ``_rotated_bf16``'s (rotate in f32, then
    bf16) bit for bit, each live chunk written once a step and the padding
    never; the keys each tile's queries see are in the ring when the tile
    is computed; and the attention from the staged rows, in the consumers'
    order of rounding, agrees with bonito_tpu's Pallas kernel in interpret
    mode on the same f32 qkv as the plain version does (one bf16 step of
    the largest output on the max, 1e-5 on the mean)."""
    rng = np.random.default_rng(T + D + r)
    qkv = rng.normal(size=(N, T, 3, H, D)).astype(np.float32)
    left, right = window
    t_real_ = t_real or T
    plan = attention_cuda.window_plan(N, T, H, D, window, torch.float32, 132)
    assert plan is not None and plan["dtype"] == "f32"
    dp, ring, back, ahead = (plan["head_dim"], plan["ring"], plan["back"],
                             plan["ahead"])
    n_tiles = plan["tiles"]
    st = plan["stretch"] if stretch == "plan" else n_tiles
    tcos, tsin = rotary_freqs(T, r)
    cos, sin = tcos.numpy(), tsin.numpy()
    want_q, want_k, want_v = (t.numpy() for t in attention_cuda._rotated_bf16(
        _t(qkv), tcos, tsin))          # [N, H, T, D] bf16 values in f32
    scale = np.float32(1.0 / np.sqrt(D))
    out = np.zeros((N, T, H, D), np.float32)
    nb = -(-t_real_ // 64)
    for n in range(N):
        for h in range(H):
            x = qkv[n, :, :, h, :]
            for t_a in range(0, n_tiles, st):
                k_ring = np.zeros(ring * 64 * dp, np.float32)
                v_ring = np.zeros(ring * 64 * dp, np.float32)
                for s_ in range(min(st, n_tiles - t_a)):
                    t = t_a + s_
                    q_tile = np.zeros(64 * dp, np.float32)
                    if s_ == 0:
                        b_lo, b_hi = max(t - back, 0), min(t + ahead, nb - 1)
                    else:
                        b = t + ahead if t + ahead < nb else nb
                        b_lo, b_hi = b, (b if b < nb else b - 1)
                    writes = {k: np.zeros(ring * 64 * dp, np.int64)
                              for k in "kv"}
                    writes["q"] = np.zeros(64 * dp, np.int64)
                    _stage_f32_step(x, cos, sin, q_tile, k_ring, v_ring,
                                    t * 64, b_lo, b_hi,
                                    (T, D, r // 2, t_real_, dp, ring, 64, 2),
                                    writes)
                    for name, w in writes.items():
                        w = np.stack([_unswizzle(t_, dp) for t_ in
                                      w.reshape(-1, 64 * dp)])
                        assert w.max() <= 1 and not w[..., D:].any()
                        if name == "q":
                            assert w[..., :D].all()
                    q = _unswizzle(q_tile, dp)
                    live = min(64, T - t * 64)
                    np.testing.assert_array_equal(
                        q[:live, :D], want_q[n, h, t * 64:t * 64 + live])
                    # the tile's band, read from the ring as the consumers do
                    i0, i1 = t * 64, min(t * 64 + 64, T)
                    j0, j1 = max(0, i0 - left), min(t_real_, i1 - 1 + right + 1)
                    ks = np.zeros((j1 - j0, D), np.float32)
                    vs = np.zeros((j1 - j0, D), np.float32)
                    for j in range(j0, j1):
                        slot = (j // 64) % ring
                        kk = _unswizzle(k_ring[slot * 64 * dp:
                                               (slot + 1) * 64 * dp], dp)
                        vv = _unswizzle(v_ring[slot * 64 * dp:
                                               (slot + 1) * 64 * dp], dp)
                        ks[j - j0] = kk[j % 64, :D]
                        vs[j - j0] = vv[j % 64, :D]
                    np.testing.assert_array_equal(ks, want_k[n, h, j0:j1])
                    np.testing.assert_array_equal(vs, want_v[n, h, j0:j1])
                    # the consumers' function on the staged rows
                    s = (q[:i1 - i0, :D] @ ks.T) * scale
                    d = np.arange(j0, j1)[None] - np.arange(i0, i1)[:, None]
                    vis = (d >= -left) & (d <= right)
                    s = np.where(vis, s, -1e30)
                    p = np.exp(s - s.max(-1, keepdims=True)) * vis
                    den = p.sum(-1, keepdims=True)
                    p = _bf16_values(np.where(den > 0, p / np.maximum(
                        den, 1e-30), 0.0))
                    out[n, i0:i1, h] = p @ vs
    jqkv = jnp.asarray(qkv)
    jcos, jsin = jax_rotary_freqs(T, r)
    ref = _f32(jpallas.fused_rotary_window_attention(
        jqkv, jcos, jsin, window, 128, True, t_real))
    real = slice(None, t_real)
    err = np.abs(out - ref)[:, real]
    assert err.max() <= _bf16_step(np.abs(ref).max())
    assert err.mean() <= 1e-5
    plain = attention_cuda.fused_rotary_window_attention_plain(
        _t(qkv), tcos, tsin, window, t_real).numpy()
    assert np.abs(out - plain).max() <= _bf16_step(np.abs(plain).max())
