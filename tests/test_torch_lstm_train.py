"""The port's LSTM in training (kernel-table row 8: the plain versions of
kernels R and S through ``ops.lstm.lstm_train``'s autograd Function) and
BatchNorm in train mode on the CPU, against bonito_tpu: its
``lstm_pallas_train`` in interpret mode under ``jax.grad`` where its
``supported_train`` gate passes, its ``lstm_scan`` under ``jax.grad`` where
the gate fails, and ``BatchNorm.apply`` with a train context.

Tolerances. h in f32: only the order of the f32 sums of h @ W_hh differs
(F32_TOL). Both packages round c, the activations and the gates' gradient
to bf16 inside (the gate passes); an f32 sum in another order can round to
the neighbouring bf16 value, so each gradient entry is held within
GRAD_STEPS bf16 steps of the largest entry of its tensor, and at least
GRAD_MIN_EQUAL of the entries agree to F32_TOL. In bf16 h itself is
rounded every step, and a flipped rounding moves the trajectory: every
entry within H_STEPS bf16 steps of |h| <= 1. A gradient that sums a bf16
tensor over N x T rows (the LSTM's bias, BatchNorm's scale and bias): torch
sums in f32, bonito_tpu's reduction on the CPU rounds in bf16 as it goes
(seen: up to 2.05% of the largest entry, a mean relative difference of
1.0-1.3%): within BF16_SUM_TOL of the largest entry, BF16_SUM_MEAN on the
mean relative difference. Where the gate fails nothing is rounded: F32_TOL
throughout in f32, GATE_BF16_MAX and GATE_BF16_MEAN in bf16 (the test's
docstring says why)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu import nn as jnn
from bonito_tpu.ops.lstm import lstm_scan
from bonito_tpu.ops.lstm_pallas import lstm_pallas_train, supported_train
from bonito_tpu_torch import nn
from bonito_tpu_torch.ops import lstm as ops_lstm
from bonito_tpu_torch.ops import lstm_train_cuda

F32_TOL = 2e-5
GRAD_STEPS, GRAD_MIN_EQUAL = 2, 0.9
H_STEPS = 4
BF16_SUM_TOL, BF16_SUM_MEAN = 2.0 ** -5, 0.02
GATE_BF16_MAX, GATE_BF16_MEAN = 2.0 ** -5, 4e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, N, T, C, H):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, T, C)).astype(np.float32)
    w_ih = (rng.normal(size=(C, 4 * H)) / np.sqrt(C)).astype(np.float32)
    w_hh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (0.5 * rng.normal(size=4 * H)).astype(np.float32)
    g = rng.normal(size=(N, T, H)).astype(np.float32)  # dLoss/dh
    return x, w_ih, w_hh, b, g


def _jax_value_and_grads(fn, args, g, dtype):
    args = [jnp.asarray(a, dtype) for a in args]

    def loss(*a):
        return jnp.sum(fn(*a).astype(jnp.float32) * g)

    h = fn(*args)
    grads = jax.grad(loss, argnums=tuple(range(len(args))))(*args)
    return [np.asarray(jnp.asarray(v, jnp.float32)) for v in (h, *grads)]


def _port_value_and_grads(args, g, dtype, reverse):
    ts = [torch.from_numpy(a).to(dtype).requires_grad_() for a in args]
    h = ops_lstm.lstm_train(*ts, reverse=reverse)
    (h.float() * torch.from_numpy(g)).sum().backward()
    return [v.detach().float().numpy() for v in (h, *(t.grad for t in ts))]


def _close_bf16_sum(out, ref):
    err = np.abs(out - ref)
    assert err.max() <= BF16_SUM_TOL * np.abs(ref).max(), err.max()
    assert err.mean() <= BF16_SUM_MEAN * np.abs(ref).mean(), err.mean()


def _close_grad(out, ref, name, bf16):
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    err = np.abs(out - ref)
    if bf16 and name == "b":
        _close_bf16_sum(out, ref)
        return
    assert err.max() <= GRAD_STEPS * step, (name, err.max(), step)
    equal = np.mean(err <= F32_TOL * np.abs(ref).max())
    assert equal >= GRAD_MIN_EQUAL, (name, equal)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("N,T,C,H", [(8, 24, 16, 32), (8, 12, 96, 96)])
def test_lstm_train_matches_pallas(N, T, C, H, dtype, reverse):
    x, w_ih, w_hh, b, g = _inputs(N + T + H, N, T, C, H)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    assert supported_train(jnp.zeros((N, T, C), jdt), jnp.zeros((H, 4 * H)),
                           require_tpu=False)
    ref = _jax_value_and_grads(
        lambda *a: lstm_pallas_train(*a, reverse=reverse, interpret=True),
        (x, w_ih, w_hh, b), g, jdt)
    out = _port_value_and_grads((x, w_ih, w_hh, b), g, tdt, reverse)
    if dtype == "f32":
        np.testing.assert_allclose(out[0], ref[0], rtol=F32_TOL, atol=F32_TOL)
    else:
        assert np.abs(out[0] - ref[0]).max() <= H_STEPS * 2.0 ** -8
    for name, o, r in zip(("x", "w_ih", "w_hh", "b"), out[1:], ref[1:]):
        _close_grad(o, r, name, dtype == "bf16")


@pytest.mark.parametrize("reverse,dtype", [
    (False, "f32"), (True, "f32"),
    pytest.param(False, "bf16", id="bf16-False"),
    pytest.param(True, "bf16", id="bf16-True")])
def test_lstm_train_matches_scan_where_the_gate_fails(reverse, dtype):
    """H 20 is no multiple of 8: bonito_tpu runs its scan under autodiff,
    the port the same kernels (here their plain versions) unrounded. In
    f32 the two agree to F32_TOL. In bf16 bonito_tpu's scan keeps its
    carries in bf16 between steps while XLA on the CPU keeps f32 inside
    each step's fused passes, and the port keeps h and c in f32 (h rounded
    only as stored): h and the four gradients (x, w_ih, w_hh, b) each
    within GATE_BF16_MAX of its largest entry, and the mean of the
    differences within GATE_BF16_MEAN of that entry (seen at T 10 and 100,
    both directions: 0.0058 to 0.0167 on the max, 0.0006 to 0.0021 on the
    mean; a torch scan carrying h and c in bf16 came no closer)."""
    N, T, C, H = 6, 10, 12, 20
    x, w_ih, w_hh, b, g = _inputs(5, N, T, C, H)
    assert not ops_lstm.train_supported(torch.zeros(N, T, C),
                                        torch.zeros(H, 4 * H))
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    ref = _jax_value_and_grads(
        lambda *a: lstm_scan(*a, reverse=reverse), (x, w_ih, w_hh, b), g,
        jdt)
    out = _port_value_and_grads((x, w_ih, w_hh, b), g, tdt, reverse)
    for name, o, r in zip(("h", "x", "w_ih", "w_hh", "b"), out, ref):
        if dtype == "f32":
            np.testing.assert_allclose(o, r, rtol=1e-4, atol=F32_TOL)
            continue
        err, big = np.abs(o - r), np.abs(r).max()
        assert err.max() <= GATE_BF16_MAX * big, (name, err.max() / big)
        assert err.mean() <= GATE_BF16_MEAN * big, (name, err.mean() / big)


@pytest.mark.parametrize("N,C,H,dtype", [
    (8, 16, 32, torch.float32), (128, 1024, 1024, torch.bfloat16),
    (2048, 1024, 1024, torch.bfloat16), (128, 96, 96, torch.float32),
    (4, 12, 20, torch.float32), (1024, 512, 1024, torch.float32)])
def test_train_gate_is_bonito_tpus(N, C, H, dtype):
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    assert ops_lstm.train_supported(
        torch.zeros(N, 1, C, dtype=dtype), torch.zeros(H, 4 * H)) == \
        supported_train(jnp.zeros((N, 1, C), jdt), jnp.zeros((H, 4 * H)),
                        require_tpu=False)


def test_plain_backward_reverse_mirrors_forward():
    """S with ``reverse`` is S on the time-flipped tensors, flipped back:
    the recurrence's previous step is index t+1 there."""
    rng = np.random.default_rng(4)
    T, N, H = 7, 3, 16
    xw = torch.from_numpy(rng.normal(size=(T, N, 4 * H)).astype(np.float32))
    w_hh = torch.from_numpy(rng.normal(size=(H, 4 * H)).astype(np.float32))
    g_h = torch.from_numpy(rng.normal(size=(T, N, H)).astype(np.float32))
    h, c, acts = lstm_train_cuda.lstm_train_forward_plain(xw, w_hh, True)
    h2, c2, acts2 = lstm_train_cuda.lstm_train_forward_plain(xw.flip(0), w_hh)
    for a, b in ((h, h2), (c, c2), (acts, acts2)):
        torch.testing.assert_close(a, b.flip(0), rtol=0, atol=0)
    d = lstm_train_cuda.lstm_train_backward_plain(w_hh, acts, c, g_h, True)
    d2 = lstm_train_cuda.lstm_train_backward_plain(w_hh, acts2, c2,
                                                   g_h.flip(0))
    torch.testing.assert_close(d, d2.flip(0), rtol=0, atol=0)


def test_lstm_layer_routes_by_mode():
    """In training a float layer takes ``lstm_train`` (differentiable), in
    eval the inference route; both give the same h in f32."""
    layer = nn.LSTM(16, 8, reverse=True)
    layer.init_(np.random.default_rng(0))
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(3, 5, 8)).astype(np.float32))
    assert not layer.training
    with torch.no_grad():
        ref = layer(x)
    layer.train()
    h = layer(x)
    assert h.grad_fn is not None
    torch.testing.assert_close(h, ref, rtol=F32_TOL, atol=F32_TOL)


# ---------------------------------------------------------------------------
# BatchNorm in train mode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("track", [True, False])
def test_batchnorm_train_matches_bonito_tpu(dtype, track):
    rng = np.random.default_rng(7)
    N, T, C = 4, 50, 6
    x = (2 + 3 * rng.normal(size=(N, T, C))).astype(np.float32)
    gy = rng.normal(size=(N, T, C)).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=C)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=C)).astype(np.float32)}
    if track:
        p["mean"] = (0.2 * rng.normal(size=C)).astype(np.float32)
        p["var"] = (1 + 0.1 * rng.random(C)).astype(np.float32)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    jbn = jnn.BatchNorm(C, track_running_stats=track)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jp["scale"], jp["bias"] = (jp[k].astype(jdt) for k in ("scale", "bias"))

    def jfn(xx, scale, bias):
        ctx = {"train": True, "updates": {}}
        y = jbn.apply({**jp, "scale": scale, "bias": bias}, xx, ctx)
        return jnp.sum(y.astype(jnp.float32) * gy), (y, ctx["updates"])

    (_, (ref, updates)), ref_g = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(x, jdt), jp["scale"], jp["bias"])

    bn = nn.BatchNorm(C, track_running_stats=track)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        if track:
            bn.mean.copy_(torch.from_numpy(p["mean"]))
            bn.var.copy_(torch.from_numpy(p["var"]))
    bn.train()
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    y = bn(xt)
    (y.float() * torch.from_numpy(gy)).sum().backward()

    tol = F32_TOL if dtype == "f32" else 2.0 ** -7
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(y.detach().float().numpy(), ref, rtol=tol,
                               atol=tol * np.abs(ref).max())
    for i, (out, r) in enumerate(zip((xt.grad, bn.scale.grad, bn.bias.grad),
                                     ref_g)):
        r = np.asarray(r.astype(jnp.float32))
        if dtype == "bf16" and i > 0:
            _close_bf16_sum(out.float().numpy(), r)
        else:
            np.testing.assert_allclose(out.float().numpy(), r, rtol=tol,
                                       atol=tol * np.abs(r).max())
    if not track:
        assert bn.pending is None and not updates
        return
    (upd,) = updates.values()
    # the forward leaves the running statistics as they were
    np.testing.assert_array_equal(bn.mean.numpy(), p["mean"])
    m = bn.momentum
    for got, key in zip(bn.pending, ("mean", "var")):
        assert got.dtype == torch.float32
        ref_upd = np.asarray(upd[key])
        # in bf16 the batch's statistic may round to the neighbouring bf16
        # value (another f32 sum order): m x one bf16 step of it
        batch = (ref_upd - (1 - m) * p[key]) / m
        atol = F32_TOL if dtype == "f32" else m * 2.0 ** -7 * np.abs(
            batch).max()
        np.testing.assert_allclose(got.numpy(), ref_upd, rtol=F32_TOL,
                                   atol=atol)
    pending = [t.clone() for t in bn.pending]
    bn.apply_pending()
    assert bn.pending is None
    torch.testing.assert_close(bn.mean, pending[0], rtol=0, atol=0)
    torch.testing.assert_close(bn.var, pending[1], rtol=0, atol=0)
