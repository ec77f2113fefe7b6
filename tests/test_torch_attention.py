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


def _run_plan(plan, x):
    """What kernel P's variant computes, with numpy on x's storage."""
    item = x.element_size()
    whole = torch.as_strided(x, (x.untyped_storage().nbytes() // item,),
                             (1,), 0)
    raw = whole.numpy().view(np.uint8)[x.storage_offset() * item:]
    if plan[0] == "transpose":
        _, B, R, C, sb, sc, unit = plan
        sizes, strides = [B, R, C], [sb, 1, sc]
    else:
        _, sizes, strides, unit = plan
    sizes, strides = list(sizes), [s * unit for s in strides]
    view = np.lib.stride_tricks.as_strided(
        raw, shape=sizes + [unit], strides=strides + [1])
    return np.ascontiguousarray(view).reshape(-1)


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
    # an unaligned start, or 2-byte elements that do not fill 16-byte rows
    loose = relayout.relayout_plan(list(x.shape), list(x.stride()), 4,
                                   aligned=False)
    assert loose[0] == "gather" and loose[-1] == 4
    np.testing.assert_array_equal(_run_plan(loose, x), want)


def test_relayout_plan_of_the_sup_stack_input():
    """The conv stack's output at sup widths, [128, 1000, 512] bf16 viewed
    from [128, 512, 1000] memory: the tile transpose."""
    plan = relayout.relayout_plan([128, 1000, 512], [512000, 1, 1000], 2)
    assert plan == ("transpose", 128, 1000, 512, 512000, 1000, 2)
    # T = 999 does not fill 16-byte rows: the gather, element by element
    plan = relayout.relayout_plan([128, 999, 512], [511488, 1, 999], 2)
    assert plan[0] == "gather" and plan[-1] == 2
    with pytest.raises(TypeError, match="bytes"):
        relayout.relayout_plan([4, 4], [4, 1], 16)
