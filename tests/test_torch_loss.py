"""The port's CRF training loss on the CPU against bonito_tpu: the plain
versions of kernels U, V (row 9), W, X (row 10), Y and Z (row 11) against
bonito_tpu's Pallas kernels in interpret mode under ``jax.grad``;
``ctc_loss_tcn``, ``ctc_loss`` and ``SeqdistModel.loss_tcn``/``loss`` on
both of bonito_tpu's routes (its Pallas kernels, forced onto the CPU in
interpret mode, and its scans); the short-target guard, ``loss_clip``, the
reductions and ``target_projection``; the other recurrences of
``CTC_CRF``; and the slice as a whole, a narrow LSTM-CRF from
``forward_tcn`` to the loss's gradient with respect to its moves.

Tolerances. On the kernel route both packages round the scores to bf16
and the gradient to bf16: an entry may differ by one bf16 step of its
magnitude (a different f32 sum order can round to the neighbouring bf16
value), and at least MIN_EQUAL of the entries are equal. Values and f32
gradients differ by f32 rounding only: F32_RTOL."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.crf.seqdist import Log as JLog
from bonito_tpu.crf.seqdist import Max as JMax
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.models import transformer_crf_config as jax_sup_config
from bonito_tpu.ops import lattice_pallas, logz_pallas
from bonito_tpu.transformer import model as jtransformer
from bonito_tpu_torch import checkpoint
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.crf.seqdist import CTC_CRF, Log, Max
from bonito_tpu_torch.ops import lattice, logz
from bonito_tpu_torch.transformer import model as transformer
from bonito_tpu_torch.util import get_last_checkpoint, load_model

ALPHABET = ["N", "A", "C", "G", "T"]
MIN_EQUAL = 0.99
F32_RTOL, F32_ATOL = 2e-5, 1e-6
LAT_RTOL = 1e-5
# ``ctc_loss``'s lattice branch is f32 over all the lattice's columns in
# both packages (about a tenth of the entries at S 64), whose last bits
# differ with the sum order: 0.978-0.982 equal in the runs seen
LOSS_MIN_EQUAL = 0.95


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The suite runs test files side by side in worker processes that
    use every core already; torch's own pool on top oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_kernels(monkeypatch):
    """bonito_tpu's loss on its kernel route on the CPU: its gates taken
    as if on a TPU and its Pallas entries in interpret mode. No file of
    bonito_tpu changes."""
    monkeypatch.delenv("BONITO_TPU_NO_PALLAS", raising=False)
    monkeypatch.setattr(
        logz_pallas, "supported",
        partial(logz_pallas.supported, require_tpu=False))
    monkeypatch.setattr(
        logz_pallas, "supported_tcn",
        partial(logz_pallas.supported_tcn, require_tpu=False))
    monkeypatch.setattr(
        lattice_pallas, "supported",
        partial(lattice_pallas.supported, require_tpu=False))
    full, tcn, lat = (logz_pallas.logZ_pallas, logz_pallas.logZ_tcn,
                      lattice_pallas.lattice_logZ)
    monkeypatch.setattr(logz_pallas, "logZ_pallas",
                        lambda sd, s: full(sd, s, True))
    monkeypatch.setattr(logz_pallas, "logZ_tcn",
                        lambda sd, m, b: tcn(sd, m, b, True))
    monkeypatch.setattr(lattice_pallas, "lattice_logZ",
                        lambda m, n, b: lat(m, n, b, interpret=True))


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def bf16_step(x):
    """One bf16 step (8 significant bits) of each entry's magnitude."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(x), 1e-30))) - 7)


def assert_bf16_close(out, ref, min_equal=MIN_EQUAL):
    """Each entry within one bf16 step of its magnitude; at least
    ``min_equal`` of them equal."""
    out, ref = _f32(out), _f32(ref)
    assert np.all(np.abs(out - ref) <= bf16_step(ref)), np.abs(out - ref).max()
    assert (out == ref).mean() >= min_equal, (out == ref).mean()


def assert_loss_grad_close(out, ref, lat_ref, min_equal=MIN_EQUAL):
    """A loss gradient sums the lattice branch (f32 in both packages) and
    logZ's branch (rounded to bf16 in both). ``lat_ref`` is the reference's
    lattice branch alone: its gradient with ``normalise_scores=False``,
    since shifting every frame's scores by logZ/T moves no lattice
    posterior. So ``ref - lat_ref`` is its logZ branch. Each entry is
    within one bf16 step of that branch's magnitude (a different f32 sum
    order can round to the neighbouring bf16 value), plus F32 steps of the
    lattice branch (LAT_RTOL; the sum orders differ there too), plus one
    bf16 step of its own magnitude when the gradient itself is bf16; at
    least ``min_equal`` of the entries are equal."""
    bf16_out = out.dtype == torch.bfloat16
    out, ref, lat_ref = _f32(out), _f32(ref), _f32(lat_ref)
    tol = bf16_step(ref - lat_ref) + LAT_RTOL * np.abs(lat_ref)
    if bf16_out:
        tol = tol + bf16_step(ref)
    assert np.all(np.abs(out - ref) <= tol), np.abs(out - ref).max()
    assert (out == ref).mean() >= min_equal, (out == ref).mean()


def assert_f32_close(out, ref, rtol=F32_RTOL, atol=F32_ATOL):
    np.testing.assert_allclose(_f32(out), _f32(ref), rtol=rtol, atol=atol)


def _pair(state_len):
    return JaxCRF(state_len, ALPHABET), CTC_CRF(state_len, ALPHABET)


def _weights(N):
    """A cotangent of logZ that is not all ones, with a zero and a sign."""
    return np.linspace(-1.5, 2.0, N).astype(np.float32)


# ---------------------------------------------------------------------------
# (a) the plain versions of rows 9, 10 and 11 against the Pallas kernels
# ---------------------------------------------------------------------------

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("state_len,T", [(3, 24), (4, 40)])
def test_logz_tcn_plain_matches_pallas(state_len, T, dtype):
    """Row 9 (kernels U, V): value and gradient, in the primal's dtype."""
    jsd, sd = _pair(state_len)
    N, S = 8, 4 ** state_len
    rng = np.random.default_rng(state_len + T)
    mv = (2 * rng.normal(size=(T, S * 4, N))).astype(np.float32)
    w = _weights(N)
    jdt, tdt = DTYPES[dtype]
    ref = logz_pallas.logZ_tcn(jsd, jnp.asarray(mv, jdt), 2.0, True)
    ref_g = jax.grad(lambda m: jnp.sum(
        logz_pallas.logZ_tcn(jsd, m, 2.0, True) * w))(jnp.asarray(mv, jdt))
    m = _t(mv).to(tdt).requires_grad_()
    out = logz.logZ_tcn(sd, m, 2.0)
    (out * _t(w)).sum().backward()
    assert logz.supported_tcn(sd, m, 2.0)
    assert_f32_close(out, ref, rtol=1e-6, atol=0)
    assert m.grad.dtype == tdt and m.grad.shape == m.shape
    assert_bf16_close(m.grad, ref_g)
    with torch.no_grad():  # the forward-only variant: the same value
        torch.testing.assert_close(logz.logZ_tcn(sd, m, 2.0), out.detach(),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("state_len,T", [(3, 24), (4, 40)])
def test_logz_full_plain_matches_pallas(state_len, T, dtype):
    """Row 10 (kernels W, X) through ``CTC_CRF.logZ``, which casts to f32
    before the kernels as bonito_tpu's does."""
    jsd, sd = _pair(state_len)
    N, S = 8, 4 ** state_len
    rng = np.random.default_rng(10 * state_len + T)
    sc = (2 * rng.normal(size=(N, T, 5 * S))).astype(np.float32)
    w = _weights(N)
    jdt, tdt = DTYPES[dtype]
    ref = logz_pallas.logZ_pallas(
        jsd, jnp.asarray(sc, jdt).astype(jnp.float32), True)
    ref_g = jax.grad(lambda s: jnp.sum(logz_pallas.logZ_pallas(
        jsd, s.astype(jnp.float32), True) * w))(jnp.asarray(sc, jdt))
    s = _t(sc).to(tdt).requires_grad_()
    out = sd.logZ(s)
    (out * _t(w)).sum().backward()
    assert logz.supported(sd, s)
    assert_f32_close(out, ref, rtol=1e-6, atol=0)
    assert s.grad.dtype == tdt
    assert_bf16_close(s.grad, ref_g)


@pytest.mark.parametrize("P,T", [(13, 24), (37, 40)])
def test_lattice_plain_matches_pallas(P, T):
    """Row 11 (kernels Y, Z), f32: rows of every length, a length-0 and a
    negative one (targets shorter than state_len), zero cotangents."""
    N = 8
    rng = np.random.default_rng(P + T)
    move = rng.normal(size=(N, T, P - 1)).astype(np.float32)
    lengths = np.array([P, P - 1, 5, 1, 0, -1, P, 7], np.int32)
    w = np.array([1, -2, 3, 0, 0, 1, 0.5, 2], np.float32)
    ref = lattice_pallas.lattice_logZ(jnp.asarray(move), jnp.asarray(lengths),
                                      2.0, interpret=True)
    ref_g = jax.grad(lambda m: jnp.sum(lattice_pallas.lattice_logZ(
        m, jnp.asarray(lengths), 2.0, interpret=True) * w))(jnp.asarray(move))
    m = _t(move).requires_grad_()
    out = lattice.lattice_logZ(m, _t(lengths), 2.0)
    (out * _t(w)).sum().backward()
    assert_f32_close(out, ref)
    assert_f32_close(m.grad, ref_g)
    assert np.all(_f32(m.grad)[3:6] == 0)  # g = 0 rows: 0, not NaN
    with torch.no_grad():
        torch.testing.assert_close(lattice.lattice_logZ(m, _t(lengths), 2.0),
                                   out.detach(), rtol=0, atol=0)


def test_scan_routes_where_the_gates_fail():
    """N not a multiple of 8: bonito_tpu's scans, f32 throughout; the port
    runs the same recurrences unrounded, and a bf16 primal gets its
    gradient cast back."""
    jsd, sd = _pair(3)
    N, T, S = 6, 20, 64
    rng = np.random.default_rng(5)
    mv = (2 * rng.normal(size=(T, 4 * S, N))).astype(np.float32)
    m = _t(mv).to(torch.bfloat16).requires_grad_()
    assert not logz.supported_tcn(sd, m, 2.0)
    out = sd.logZ_tcn(m, 2.0)
    out.sum().backward()
    ref = jsd.logZ_tcn(jnp.asarray(mv, jnp.bfloat16), 2.0)
    ref_g = jax.grad(lambda x: jnp.sum(jsd.logZ_tcn(x, 2.0)))(
        jnp.asarray(mv, jnp.bfloat16))
    assert_f32_close(out, ref, rtol=1e-6)
    assert m.grad.dtype == torch.bfloat16
    assert_bf16_close(m.grad, ref_g, min_equal=0.95)


# ---------------------------------------------------------------------------
# (b) the losses on both routes, (c) their cases
# ---------------------------------------------------------------------------

def _loss_inputs(N, T, state_len, seed, L=14, dtype=np.float32):
    S = 4 ** state_len
    rng = np.random.default_rng(seed)
    mv = (2 * rng.normal(size=(T, 4 * S, N))).astype(dtype)
    targets = rng.integers(1, 5, size=(N, L)).astype(np.int32)
    lengths = rng.integers(state_len, L + 1, size=N).astype(np.int32)
    targets[np.arange(L)[None] >= lengths[:, None]] = 0
    return mv, targets, lengths


def _grads(fn, x, **kw):
    """jax.grad of sum(fn(x)) with ``kw``, and with the lattice branch
    alone (``normalise_scores=False``), for assert_loss_grad_close."""
    g = jax.grad(lambda y: jnp.sum(fn(y, **kw)))(x)
    lat = jax.grad(lambda y: jnp.sum(fn(y, **{**kw, "normalise_scores":
                                              False})))(x)
    return g, lat


def _tcn_loss_pair(jsd, sd, mv, targets, lengths, tdt=torch.float32,
                   jdt=jnp.float32, **kw):
    ref_fn = lambda m, **k: jsd.ctc_loss_tcn(m, 2.0, jnp.asarray(targets),
                                             jnp.asarray(lengths), **k)
    ref = ref_fn(jnp.asarray(mv, jdt), **kw)
    ref_g, lat_g = _grads(ref_fn, jnp.asarray(mv, jdt), **kw)
    m = _t(mv).to(tdt).requires_grad_()
    out = sd.ctc_loss_tcn(m, 2.0, _t(targets), _t(lengths), **kw)
    out.sum().backward()
    return out, ref, m.grad, ref_g, lat_g


@pytest.mark.parametrize("route,N", [("kernel", 8), ("scan", 6)])
def test_ctc_loss_tcn_matches_bonito_tpu(route, N, request):
    if route == "kernel":
        request.getfixturevalue("jax_kernels")
    jsd, sd = _pair(3)
    mv, targets, lengths = _loss_inputs(N, 32, 3, seed=N)
    out, ref, g, ref_g, lat_g = _tcn_loss_pair(jsd, sd, mv, targets,
                                               lengths)
    assert_f32_close(out, ref, rtol=1e-5)
    if route == "kernel":  # the logZ branch rounds to bf16
        assert_loss_grad_close(g, ref_g, lat_g)
    else:
        assert_f32_close(g, ref_g, rtol=1e-4, atol=1e-7)


def test_ctc_loss_tcn_bf16_moves(jax_kernels):
    jsd, sd = _pair(3)
    mv, targets, lengths = _loss_inputs(8, 32, 3, seed=9)
    out, ref, g, ref_g, lat_g = _tcn_loss_pair(
        jsd, sd, mv, targets, lengths, torch.bfloat16, jnp.bfloat16)
    assert_f32_close(out, ref, rtol=1e-5)
    assert g.dtype == torch.bfloat16
    assert_loss_grad_close(g, ref_g, lat_g)


@pytest.mark.parametrize("route,N", [("kernel", 8), ("scan", 6)])
def test_ctc_loss_matches_bonito_tpu(route, N, request):
    if route == "kernel":
        request.getfixturevalue("jax_kernels")
    jsd, sd = _pair(3)
    T, S = 28, 64
    rng = np.random.default_rng(40 + N)
    sc = (2 * rng.normal(size=(N, T, 5 * S))).astype(np.float32)
    _, targets, lengths = _loss_inputs(N, T, 3, seed=41 + N)
    fn = lambda s, **k: jsd.ctc_loss(s, jnp.asarray(targets),
                                     jnp.asarray(lengths), **k)
    ref = fn(jnp.asarray(sc))
    ref_g, lat_g = _grads(fn, jnp.asarray(sc))
    s = _t(sc).requires_grad_()
    out = sd.ctc_loss(s, _t(targets), _t(lengths))
    out.backward()
    assert_f32_close(out, ref, rtol=1e-5)
    if route == "kernel":
        assert_loss_grad_close(s.grad, ref_g, lat_g, LOSS_MIN_EQUAL)
    else:
        assert_f32_close(s.grad, ref_g, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("case", ["short", "clip", "none", "unnormalised"])
def test_loss_cases_match_bonito_tpu(case, jax_kernels):
    """Targets shorter than state_len (the max(., 1) NaN guard: the row
    contributes 0, the gradient stays finite), loss_clip, reduction
    'none' and normalise_scores=False."""
    jsd, sd = _pair(3)
    mv, targets, lengths = _loss_inputs(8, 32, 3, seed=77)
    kw = {}
    if case == "short":
        lengths[[1, 4]] = [0, 2]
        targets[1] = 0
        targets[4, 2:] = 0
        kw = dict(reduction="none")
    elif case == "clip":
        kw = dict(loss_clip=0.5, reduction="none")
    elif case == "none":
        kw = dict(reduction="none")
    else:
        kw = dict(normalise_scores=False)
    out, ref, g, ref_g, lat_g = _tcn_loss_pair(jsd, sd, mv, targets,
                                               lengths, **kw)
    assert_f32_close(out, ref, rtol=1e-5)
    assert np.isfinite(_f32(g)).all()
    assert_loss_grad_close(g, ref_g, lat_g)
    if case == "short":
        assert _f32(out)[1] == 0 and _f32(out)[4] == 0
    if case == "clip":
        assert _f32(out).max() <= 0.5


def _model_pair(seed=3, **model):
    cfg = lstm_crf_config(features=32, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=500, overlap=100)
    cfg["model"].update(model)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(seed))
    pm = checkpoint.params_from_jax(Model(cfg), jax.tree.map(np.asarray,
                                                             jm.params))
    return cfg, jm, pm


def test_target_projection_and_context_bases_round_trip():
    """A [model] config with n_pre_post_context_bases and
    target_projection builds in both packages with equal to_dict outputs,
    and loss/loss_tcn project the targets as bonito_tpu's do."""
    cfg = jax_sup_config(d_model=64, nhead=4, depth=1, dim_feedforward=128,
                         state_len=3)
    cfg["model"]["n_pre_post_context_bases"] = [3, 2]
    cfg["model"]["target_projection"] = [1, 2, 3, 4]
    jm, pm = jtransformer.Model(cfg), transformer.Model(cfg)
    assert (pm.n_pre_context_bases, pm.n_post_context_bases) == (3, 2)
    assert list(pm.target_projection) == [0, 1, 2, 3, 4]
    jd, pd = jm.to_dict(), pm.to_dict()
    assert pd["n_pre_post_context_bases"] == tuple(jd[
        "n_pre_post_context_bases"])
    assert pd["target_projection"] == jd["target_projection"]
    plain = transformer.Model(jax_sup_config(d_model=64, nhead=4, depth=1,
                                             dim_feedforward=128,
                                             state_len=3))
    assert (plain.n_pre_context_bases, plain.n_post_context_bases) == (2, 1)
    assert "target_projection" not in plain.to_dict()

    # the LSTM-CRF family reads the context from [input]
    lcfg = lstm_crf_config(features=32, num_layers=1, state_len=3)
    lcfg["input"]["n_pre_post_context_bases"] = [1, 1]
    assert (Model(lcfg).n_pre_context_bases,
            JaxModel(lcfg).n_pre_context_bases) == (1, 1)

    # projection: labels 1..4 map to 4..1
    cfg2 = lstm_crf_config(features=32, num_layers=1, state_len=3)
    jm2, pm2 = JaxModel(cfg2), Model(cfg2)
    for m in (jm2, pm2):
        m.target_projection = np.array([0, 4, 3, 2, 1])
    mv, targets, lengths = _loss_inputs(6, 24, 3, seed=5)
    ref = jm2.loss_tcn(jnp.asarray(mv), 2.0, jnp.asarray(targets),
                       jnp.asarray(lengths))
    out = pm2.loss_tcn(_t(mv), 2.0, _t(targets), _t(lengths))
    direct = pm2.seqdist.ctc_loss_tcn(_t(mv), 2.0, _t(np.array(
        [0, 4, 3, 2, 1])[targets]), _t(lengths))
    assert_f32_close(out, ref, rtol=1e-5)
    torch.testing.assert_close(out, direct, rtol=0, atol=0)


def test_a_newer_tar_checkpoint_raises(tmp_path):
    """bonito_tpu loads the highest N over .npz and .tar, the .tar on a tie
    of N; the port reads upstream's .tar now and loads the same file
    (each file below holds other weights, so the one that loads shows)."""
    from bonito_tpu.util import get_last_checkpoint as jax_last_checkpoint
    from bonito_tpu_torch.cli.export import torch_state_dict
    from bonito_tpu_torch.config import save_config
    cfg, _, pm = _model_pair()
    cfg["basecaller"]["quantize"] = False
    save_config(cfg, tmp_path / "config.toml")
    checkpoint.save_params(tmp_path / "weights_1.npz", pm)
    assert get_last_checkpoint(tmp_path).endswith("weights_1.npz")
    newer = Model(cfg).init(4)
    torch.save(torch_state_dict(newer), tmp_path / "weights_2.tar")

    def state(**kw):
        return load_model(tmp_path, half=False, device="cpu", **kw
                          ).state_dict()

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in b)
    assert get_last_checkpoint(tmp_path).endswith("weights_2.tar")
    assert get_last_checkpoint(tmp_path) == jax_last_checkpoint(tmp_path)
    assert same(state(), newer.state_dict())
    assert same(state(weights=2), newer.state_dict())
    assert same(state(weights=1), pm.state_dict())
    tie = Model(cfg).init(5)   # a tie: the .tar wins
    torch.save(torch_state_dict(tie), tmp_path / "weights_1.tar")
    (tmp_path / "weights_2.tar").unlink()
    assert get_last_checkpoint(tmp_path).endswith("weights_1.tar")
    assert get_last_checkpoint(tmp_path) == jax_last_checkpoint(tmp_path)
    assert same(state(), tie.state_dict())
    assert same(state(weights=1), pm.state_dict())  # weights=N: .npz first


# ---------------------------------------------------------------------------
# (d) the other recurrences
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scores():
    rng = np.random.default_rng(21)
    return (2 * rng.normal(size=(4, 12, 5 * 64))).astype(np.float32)


@pytest.mark.parametrize("semiring", ["log", "max"])
def test_recurrences_match_bonito_tpu(scores, semiring):
    jsd, sd = _pair(3)
    jS, tS = (JLog, Log) if semiring == "log" else (JMax, Max)
    s, js = _t(scores), jnp.asarray(scores)
    for name in ("forward_scores", "backward_scores", "posteriors"):
        assert_f32_close(getattr(sd, name)(s, tS),
                         getattr(jsd, name)(js, jS), rtol=1e-5, atol=1e-6)
    assert_f32_close(sd.logZ(s, tS), jsd.logZ_scan(js, jS), rtol=1e-6)


def test_viterbi_and_transition_probs_match_bonito_tpu(scores):
    jsd, sd = _pair(3)
    s, js = _t(scores), jnp.asarray(scores)
    np.testing.assert_array_equal(sd.viterbi(s).numpy(),
                                  np.asarray(jsd.viterbi(js)))
    betas = jsd.backward_scores(js)
    tp, ip = sd.compute_transition_probs(s, _t(np.asarray(betas)))
    jtp, jip = jsd.compute_transition_probs(js, betas)
    assert_f32_close(tp, jtp, rtol=1e-5)
    assert_f32_close(ip, jip, rtol=1e-5)


def test_ctc_viterbi_alignments_match_bonito_tpu(scores):
    jsd, sd = _pair(3)
    _, targets, lengths = _loss_inputs(4, 12, 3, seed=2, L=8)
    lengths[1] = 2  # shorter than state_len: no valid lattice
    out = sd.ctc_viterbi_alignments(_t(scores), _t(targets), _t(lengths))
    ref = jsd.ctc_viterbi_alignments(jnp.asarray(scores), jnp.asarray(targets),
                                     jnp.asarray(lengths))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_decode_batch_posteriors_matches_bonito_tpu(scores):
    _, jm, pm = _model_pair()
    assert (pm.decode_batch_posteriors(_t(scores))
            == jm.decode_batch_posteriors(jnp.asarray(scores)))


# ---------------------------------------------------------------------------
# (e) the slice: forward_tcn -> loss_tcn -> d loss / d moves_tcn; forward
#     -> loss -> d loss / d scores
# ---------------------------------------------------------------------------

def test_slice_matches_bonito_tpu(jax_kernels):
    cfg, jm, pm = _model_pair(seed=11)
    N, chunk = 8, 500
    rng = np.random.default_rng(11)
    x = rng.normal(size=(N, chunk, 1)).astype(np.float32)
    T = chunk // 5
    _, targets, lengths = _loss_inputs(N, T, 3, seed=12, L=40)

    jmv, jblank = jm.forward_tcn(jm.params, jnp.asarray(x))
    jfn = lambda m, **k: jm.loss_tcn(m, jblank, jnp.asarray(targets),
                                     jnp.asarray(lengths), **k)
    ref = jfn(jmv)
    ref_g, lat_g = _grads(jfn, jmv)
    with torch.no_grad():
        mv, blank = pm.forward_tcn(_t(x))
    assert blank == jblank
    assert_f32_close(mv, jmv, rtol=2e-4, atol=2e-4)  # the encoders in f32
    # the encoders' last bits move a few of the bf16 roundings inside logZ:
    # at least 0.95 of the gradient's entries equal (seen: 0.994)
    mv = mv.detach().requires_grad_()
    out = pm.loss_tcn(mv, blank, _t(targets), _t(lengths))
    out.backward()
    assert_f32_close(out, ref, rtol=1e-5)
    assert mv.grad.shape == mv.shape and mv.grad.stride() == mv.stride()
    assert_loss_grad_close(mv.grad, ref_g, lat_g, min_equal=0.95)

    jscores = jm.apply(jm.params, jnp.asarray(x))
    jfn = lambda s, **k: jm.loss(s, jnp.asarray(targets),
                                 jnp.asarray(lengths), **k)
    ref = jfn(jscores)
    ref_g, lat_g = _grads(jfn, jscores)
    with torch.no_grad():
        sc = pm(_t(x))
    assert_f32_close(sc, jscores, rtol=2e-4, atol=2e-4)
    sc = sc.detach().requires_grad_()
    out = pm.loss(sc, _t(targets), _t(lengths))
    out.backward()
    assert_f32_close(out, ref, rtol=1e-5)
    # the encoders' last bits on top of LOSS_MIN_EQUAL's f32 lattice
    # branch: at least 0.9 equal (seen: 0.939)
    assert_loss_grad_close(sc.grad, ref_g, lat_g, min_equal=0.9)
