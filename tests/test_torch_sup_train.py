"""The port's sup (transformer-CRF) train step on the CPU against
bonito_tpu: kernel-table row 13 (the training twin of the fused rotary +
banded attention: H's and O's plain versions through the autograd Function)
against ``fused_rotary_window_attention_train`` in interpret mode under
``jax.grad``; the local route with a gradient against bonito_tpu's
``attend(differentiable=True)``; ``pin_layout``'s gradient; one train step
of a small sup model against bonito_tpu's ``make_train_step`` on both
attention routes, in f32 and in bf16 amp; the train CLI on a small sup
config.

bonito_tpu takes its fused kernels on a TPU only; the fused-route step
forces them from here in interpret mode (the ``jax_kernels`` fixture), as
tests/test_torch_sup.py and tests/test_torch_train.py do. No file of
bonito_tpu changes.

Tolerances. Row 13: the port's plain versions and the TPU kernels round at
the same points, so they differ by f32 sums in another order and by what
that flips: a bf16 rounding of a rotated q or k (XLA may fuse the rotary's
multiply-add), of p or of ds. o and each of dq, dk, dv within
ROW13_STEPS bf16 steps of the output's largest magnitude (seen: at most
0.35 of a step), their mean difference within ROW13_MEAN of it (seen:
4e-7); lse within LSE_STEPS of a bf16 step of its largest magnitude (seen:
2.4e-4 at |lse| 6.2, a flipped rounding of a rotated q or k). The local route in f32: 1e-5. A train
step: the losses, gradient norms and gradients (relative L2, a convolution's
bias in front of BatchNorm measured against its weight's, as its gradient
is 0 in exact arithmetic) within STEP_* in f32 and AMP_* in bf16 amp (seen
beside each); after AdamW at least PARAM_MIN_EQUAL of the parameters'
entries agree to UPDATE_TOL, as tests/test_torch_train.py holds them."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bonito_tpu import training as jax_training
from bonito_tpu.models import transformer_crf_config
from bonito_tpu.ops import attention as jattention
from bonito_tpu.ops import attention_pallas as jpallas
from bonito_tpu.ops import lattice_pallas, logz_pallas
from bonito_tpu.transformer import model as jtransformer
from bonito_tpu_torch import checkpoint, training
from bonito_tpu_torch.cli import main as cli_main
from bonito_tpu_torch.config import save_config
from bonito_tpu_torch.ops import attention, attention_cuda, relayout
from bonito_tpu_torch.transformer import model as transformer

ROW13_STEPS, ROW13_MEAN, LSE_STEPS = 1, 2.0 ** -16, 2.0 ** -4
LOCAL_TOL = 1e-5
# seen: f32 loss 1.3e-7 relative, norm 4.5e-5, gradients 1.2e-3 worst and
# 6.8e-4 over all (local 7.4e-4 and 3.5e-4: both packages round the loss's
# inner gradient to bf16), 0.998 of the new parameters' entries equal; amp
# loss 8.6e-5, norm 4.6e-4, gradients 0.117 worst (a BatchNorm bias of the
# first convolution, at the end of the longest chain of bf16 roundings) and
# 0.033 over all, 0.979 equal
STEP_LOSS_RTOL, STEP_NORM_RTOL, STEP_GRAD_REL, STEP_GRAD_ALL = (
    1e-5, 2e-4, 5e-3, 5e-3)
AMP_LOSS_RTOL, AMP_NORM_RTOL, AMP_GRAD_REL, AMP_GRAD_ALL = (
    5e-4, 5e-3, 0.2, 0.1)
UPDATE_TOL, LR = 1e-6, 2e-3
PARAM_MIN_EQUAL, AMP_PARAM_MIN_EQUAL = 0.99, 0.95
SMALL = dict(d_model=64, nhead=4, depth=2, dim_feedforward=128, state_len=3,
             batchsize=8, chunksize=3072, overlap=0)
CHUNK, TARGET_LEN = 3072, 100  # 256 tokens, 512 decode frames


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_loss_kernels(monkeypatch):
    """bonito_tpu's loss on its kernel route on the CPU: its gates taken as
    if on a TPU and its Pallas entries in interpret mode (as
    tests/test_torch_train.py). Its attention stays on the CPU's default,
    the local route."""
    monkeypatch.delenv("BONITO_TPU_NO_PALLAS", raising=False)
    monkeypatch.setattr(logz_pallas, "supported_tcn",
                        partial(logz_pallas.supported_tcn, require_tpu=False))
    monkeypatch.setattr(lattice_pallas, "supported",
                        partial(lattice_pallas.supported, require_tpu=False))
    tcn, lat = logz_pallas.logZ_tcn, lattice_pallas.lattice_logZ
    monkeypatch.setattr(logz_pallas, "logZ_tcn",
                        lambda sd, m, b: tcn(sd, m, b, True))
    monkeypatch.setattr(lattice_pallas, "lattice_logZ",
                        lambda m, n, b: lat(m, n, b, interpret=True))


@pytest.fixture
def jax_kernels(monkeypatch, jax_loss_kernels):
    """bonito_tpu's train step on its kernel routes on the CPU: the loss's
    as ``jax_loss_kernels``, and the fused attention's gate taken as if on
    a TPU with both of its entries in interpret mode."""
    gate = jpallas.fused_supported
    monkeypatch.setattr(
        jpallas, "fused_supported",
        lambda qkv, window, rotary_dim, block=128, require_tpu=True:
        gate(qkv, window, rotary_dim, block, False))
    for name in ("fused_rotary_window_attention",
                 "fused_rotary_window_attention_train"):
        kernel = getattr(jpallas, name)
        monkeypatch.setattr(
            jpallas, name,
            lambda qkv, cos, sin, window, block=128, interpret=False,
            t_real=None, kernel=kernel: kernel(qkv, cos, sin, window, block,
                                                True, t_real))


def bf16_step(x):
    return 2.0 ** (np.floor(np.log2(x)) - 7)


# ---------------------------------------------------------------------------
# row 13: H and O's plain versions through the Function against the TPU
# kernels in interpret mode (the shapes of tests/test_transformer.py's
# TestFusedAttentionVJP, and t_real < T)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,T,H,D,r,window,t_real,dtype", [
    (2, 256, 4, 32, 32, (63, 64), None, "f32"),
    (2, 256, 4, 32, 32, (63, 64), None, "bf16"),
    (2, 200, 4, 32, 32, (63, 64), None, "bf16"),      # ragged T
    (1, 128, 2, 32, 16, (31, 32), None, "f32"),       # partial rotary
    (2, 256, 4, 16, 16, (127, 128), 180, "bf16"),     # t_real < T
])
def test_row13_matches_bonito_tpu(N, T, H, D, r, window, t_real, dtype):
    rng = np.random.default_rng(T + D + r)
    qkv = rng.normal(size=(N, T, 3, H, D)).astype(np.float32)
    g = rng.normal(size=(N, T, H, D)).astype(np.float32)
    jd, td = ((jnp.bfloat16, torch.bfloat16) if dtype == "bf16"
              else (jnp.float32, torch.float32))
    jq = jnp.asarray(qkv).astype(jd)
    cos, sin = jtransformer.rotary_freqs(T, r)
    out, res = jpallas._fused_train_fwd(jq, cos, sin, window, 128, True,
                                        t_real)
    lse_ref = np.asarray(res[2])[:, :, :T]

    def loss(x):
        o = jpallas.fused_rotary_window_attention_train(
            x, cos, sin, window, 128, True, t_real)
        return jnp.sum(o.astype(jnp.float32) * jnp.asarray(g))
    dqkv_ref = np.asarray(jax.grad(loss)(jq).astype(jnp.float32))

    x = torch.from_numpy(qkv).to(td).requires_grad_()
    c, s = transformer.rotary_freqs(T, r)
    o = attention.fused_attention_train(x, c, s, window, t_real)
    assert o.dtype == td and o.requires_grad
    (o.float() * torch.from_numpy(g)).sum().backward()
    assert x.grad.dtype == td
    _, lse = attention_cuda.fused_rotary_window_attention_train_plain(
        x.detach(), c, s, window, t_real)

    def close(out, ref, steps, what):
        d = np.abs(out - ref)
        top = np.abs(ref).max()
        assert d.max() <= steps * bf16_step(top), (what, d.max(), top)
        assert d.mean() <= ROW13_MEAN * top, (what, d.mean(), top)
    close(o.detach().float().numpy(), np.asarray(out.astype(jnp.float32)),
          ROW13_STEPS, "o")
    close(lse.numpy(), lse_ref, LSE_STEPS, "lse")
    for i, what in enumerate(("dq", "dk", "dv")):
        close(x.grad[:, :, i].float().numpy(), dqkv_ref[:, :, i],
              ROW13_STEPS, what)


def test_row13_o_is_kernel_k_and_cos_sin_get_zeros():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.normal(size=(2, 100, 3, 2, 16)).astype(
        np.float32)).to(torch.bfloat16)
    c, s = transformer.rotary_freqs(100, 16)
    o, lse = attention_cuda.fused_rotary_window_attention_train(
        qkv, c, s, (31, 32), 70)
    assert torch.equal(o, attention_cuda.fused_rotary_window_attention(
        qkv, c, s, (31, 32), 70))
    assert lse.shape == (2, 2, 100) and lse.dtype == torch.float32
    # queries at and beyond t_real + left see no key: lse -1e30, o 0
    assert (lse[:, :, 101:] == attention_cuda.NEG).all()
    c = c.clone().requires_grad_()
    x = qkv.clone().requires_grad_()
    attention.fused_attention_train(x, c, s, (31, 32)).sum().backward()
    assert torch.equal(c.grad, torch.zeros_like(c))


# ---------------------------------------------------------------------------
# the local route with a gradient, and the pin's gradient
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,window", [(256, (127, 128)), (200, (63, 64)),
                                      (300, (127, 128)), (90, (200, 10))])
def test_local_route_with_a_gradient_matches_bonito_tpu(T, window):
    rng = np.random.default_rng(T)
    q, k, v, g = (rng.normal(size=(2, 3, T, 16)).astype(np.float32)
                  for _ in range(4))

    def jloss(q, k, v):
        o = jattention.attend(q, k, v, window=window, differentiable=True)
        return jnp.sum(o * g), o
    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attention.attend(tq, tk, tv, window, differentiable=True)
    (o * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=0, atol=LOCAL_TOL)
    for t, ref in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=0,
                                   atol=LOCAL_TOL)


def test_pin_layout_gradient_is_the_identity():
    x = torch.randn(2, 8, 5).transpose(1, 2).requires_grad_()
    g = torch.randn(2, 8, 5).transpose(1, 2)
    before = relayout.pin_layout.launches
    y = relayout.pin_layout(x)
    assert y.is_contiguous() and torch.equal(y, x) and y.grad_fn is not None
    y.backward(g)
    assert torch.equal(x.grad, g)
    assert relayout.pin_layout.launches == before  # no kernel on the CPU


# ---------------------------------------------------------------------------
# one sup train step against make_train_step
# ---------------------------------------------------------------------------

def _pair(seed=3):
    cfg = transformer_crf_config(**SMALL)
    jm = jtransformer.Model(cfg)
    jm.init(jax.random.PRNGKey(seed))
    params = jax.tree.map(np.asarray, jm.params)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = checkpoint.params_from_jax(transformer.Model(cfg), params)
    return jm, pm


def _batch(N=8, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, CHUNK, 1)).astype(np.float32)
    lengths = rng.integers(TARGET_LEN // 2, TARGET_LEN + 1, N).astype(
        np.int32)
    targets = rng.integers(1, 5, (N, TARGET_LEN)).astype(np.int32)
    targets[np.arange(TARGET_LEN)[None] >= lengths[:, None]] = 0
    return x, targets, lengths


def _flat(params):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = ".".join(str(p.key) for p in path)
        value = np.asarray(jnp.asarray(leaf, jnp.float32))
        if value.ndim == 3 and key.endswith(".w"):
            value = value.transpose(2, 1, 0)  # conv [W, I, O] -> [O, I, W]
        flat[key] = value
    return flat


def _jax_step(jm, batch, use_amp, lr_scale=0.5, clip=2.0):
    """bonito_tpu's make_train_step, once: (gradients, new parameters,
    losses, norm). The gradient comes back out of Adam's first moment after
    one step, mu = (1 - b1) g min(1, clip / norm), so that one compiled
    step gives both."""
    tx = optax.adamw(LR, weight_decay=0.01, eps=1e-8)
    jstep = jax_training.make_train_step(jm, tx, use_amp=use_amp)
    params, opt_state, losses, norm = jstep(
        jm.params, tx.init(jm.params), tuple(jnp.asarray(b) for b in batch),
        jnp.float32(lr_scale), jnp.float32(clip))
    scale = (1 - 0.9) * min(1.0, clip / (float(norm) + 1e-12))
    grads = _flat(jax.tree.map(lambda m: m / scale, opt_state[0].mu))
    return grads, _flat(params), float(losses["loss"]), float(norm)


def _port_grads(pm, batch, use_amp):
    x, targets, lengths = (torch.from_numpy(b) for b in batch)
    pm.train()
    try:
        moves, blank = pm.forward_tcn(
            x.to(torch.bfloat16 if use_amp else torch.float32))
        pm.loss_tcn(moves, blank, targets, lengths).backward()
    finally:
        pm.eval()
    grads = {k: p.grad.float().numpy().copy()
             for k, p in pm.named_parameters()}
    pm.zero_grad(set_to_none=True)
    return grads


def _grad_rel(out, ref):
    """Each parameter's relative L2 difference, and all of them as one."""
    rel, diff, total = {}, 0.0, 0.0
    for k in ref:
        if k.endswith(("norm.mean", "norm.var")):
            continue
        scale = ref[k[:-1] + "w"] if (
            k.endswith(".b") and k[:-1] + "norm.scale" in ref) else ref[k]
        d = np.linalg.norm(out[k] - ref[k])
        rel[k] = d / max(np.linalg.norm(scale), 1e-30)
        diff, total = diff + d ** 2, total + np.linalg.norm(scale) ** 2
    return rel, np.sqrt(diff / total)


@pytest.mark.parametrize("route", ["fused", "local"])
@pytest.mark.parametrize("use_amp", [False, True])
def test_sup_train_step_matches_bonito_tpu(route, use_amp, request):
    """fused: bonito_tpu forced onto its row-13 kernel in interpret mode;
    local: both on their local route with a gradient, bonito_tpu as it runs
    on the CPU."""
    request.getfixturevalue("jax_kernels" if route == "fused"
                            else "jax_loss_kernels")
    jm, pm = _pair()
    transformer.set_attn_route(pm, None if route == "fused" else "local")
    batch = _batch()
    ref_grads, ref, jloss, jnorm = _jax_step(jm, batch, use_amp)
    grads = _port_grads(pm, batch, use_amp)
    assert set(grads) == {k for k in ref_grads
                          if not k.endswith(("norm.mean", "norm.var"))}
    rel, rel_all = _grad_rel(grads, ref_grads)
    worst = max(rel, key=rel.get)
    assert rel[worst] <= (AMP_GRAD_REL if use_amp else STEP_GRAD_REL), (
        worst, rel[worst])
    assert rel_all <= (AMP_GRAD_ALL if use_amp else STEP_GRAD_ALL), rel_all
    assert all(np.abs(grads[k]).max() > 0 for k in grads
               if ".conv." in f".{k}" or k.endswith("wqkv"))

    before = {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}
    step = training.make_train_step(pm, training.make_optimizer(pm, LR),
                                    use_amp=use_amp)
    losses, norm = step(tuple(torch.from_numpy(b) for b in batch), 0.5, 2.0)
    loss_rtol, norm_rtol, min_equal = (
        (AMP_LOSS_RTOL, AMP_NORM_RTOL, AMP_PARAM_MIN_EQUAL) if use_amp
        else (STEP_LOSS_RTOL, STEP_NORM_RTOL, PARAM_MIN_EQUAL))
    np.testing.assert_allclose(float(losses["loss"]), jloss, rtol=loss_rtol)
    np.testing.assert_allclose(float(norm), jnorm, rtol=norm_rtol)
    out = {k: v.detach().float().numpy() for k, v in pm.state_dict().items()}
    equal = total = 0
    for k in ref:
        if k.endswith(("norm.mean", "norm.var")):
            continue
        diff = np.abs(out[k] - ref[k])
        assert diff.max() <= 2 * LR * 0.5 * 1.01, (k, diff.max())
        if k.endswith(".b") and k[:-1] + "norm.mean" in ref:
            continue  # a bias in front of BatchNorm: no gradient
        assert not np.array_equal(out[k], before[k]), k  # every one moved
        equal += int((diff <= UPDATE_TOL).sum())
        total += diff.size
    assert equal / total >= min_equal, equal / total
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# ---------------------------------------------------------------------------
# the train CLI on a small sup config
# ---------------------------------------------------------------------------

def test_sup_train_cli_on_the_cpu(tmp_path):
    cfg = transformer_crf_config(**SMALL)
    save_config(cfg, tmp_path / "config.toml")
    rng = np.random.default_rng(6)
    for sub, rows in (("", 16), ("validation", 8)):
        d = tmp_path / "data" / sub
        d.mkdir(parents=True)
        lengths = rng.integers(TARGET_LEN // 2, TARGET_LEN + 1, rows)
        refs = rng.integers(1, 5, (rows, TARGET_LEN))
        refs[np.arange(TARGET_LEN)[None] >= lengths[:, None]] = 0
        np.save(d / "chunks.npy", rng.normal(size=(rows, CHUNK)).astype(
            np.float16))
        np.save(d / "references.npy", refs.astype(np.uint8))
        np.save(d / "reference_lengths.npy", lengths.astype(np.uint16))
    work = tmp_path / "work"
    cli_main(["train", str(work), "--config", str(tmp_path / "config.toml"),
              "--directory", str(tmp_path / "data"), "--device", "cpu",
              "--batch", "8", "--epochs", "1"])
    assert (work / "weights_1.npz").exists()
    assert len((work / "losses_1.csv").read_text().splitlines()) == 3
    header, row = (work / "training.csv").read_text().splitlines()
    fields = dict(zip(header.split(","), row.split(",")))
    assert np.isfinite(float(fields["train_loss"]))
    assert np.isfinite(float(fields["validation_loss"]))
    assert 0 <= float(fields["validation_mean"]) <= 100
    trained = checkpoint.params_from_jax(
        transformer.Model(cfg), checkpoint.load_params(work / "weights_1.npz"))
    start = transformer.Model(cfg).init(25)  # the CLI's default seed
    moved = {k for k, v in start.state_dict().items()
             if not torch.equal(trained.state_dict()[k], v)}
    assert {f"encoder.conv.{i}.w" for i in range(5)} <= moved
    assert {f"encoder.transformer_encoder.{i}.self_attn.wqkv"
            for i in range(2)} <= moved
