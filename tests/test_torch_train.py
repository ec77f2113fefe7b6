"""The port's train step and trainer on the CPU against bonito_tpu: the
schedules, ``ClipGrad``, the AdamW update with its clip and ``lr_scale``
(against optax), one train step of a narrow LSTM-CRF (convolutions with
BatchNorm, two LSTMs, state_len 3) in f32, with grad accumulation and in
bf16 amp against ``make_train_step`` on bonito_tpu's kernel routes (its
Pallas kernels in interpret mode: the LSTM's ``lstm_pallas_train`` where
its ``supported_train`` holds, the loss's as in tests/test_torch_loss.py),
``Trainer.fit`` resuming as an unbroken run, the ``train`` CLI on the CPU,
and ``smith_waterman``/``accuracy`` against bonito_tpu's.

Tolerances. AdamW's arithmetic is the same in both (f32, another order of
the same operations): UPDATE_TOL. A train step: the losses agree to
LOSS_RTOL and the gradient norms to NORM_RTOL (f32 sums in other orders,
and both round the LSTM's and the loss's inner gradients to bf16, where a
sum order can flip a rounding). Adam's first step moves each parameter by
about lr x lr_scale x sign(gradient), whatever the gradient's size, so the
new parameters agree to UPDATE_TOL except where a gradient entry near 0
changes sign: at least PARAM_MIN_EQUAL of the entries agree (seen: 0.9984),
and every one within 2 x lr x lr_scale. A convolution's bias in front of a
batch-statistics BatchNorm has a gradient of 0 in exact arithmetic (the
norm takes the batch mean out), so its update is Adam's normalisation of
f32 noise in both packages: only the bound holds there. BatchNorm's
statistics: F32_TOL. In bf16 amp the packages are not bit-comparable from
the first convolution on (tests/test_torch_loss.py): the amp step's limits
are AMP_* (pinned beside what was seen)."""

from dataclasses import astuple
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bonito_tpu.ops.lstm as jax_lstm
from bonito_tpu import schedule as jax_schedule
from bonito_tpu import training as jax_training
from bonito_tpu.alignment import smith_waterman as jax_sw
from bonito_tpu.checkpoint import load_params as jax_load_params
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.ops import lattice_pallas, logz_pallas
from bonito_tpu.ops.lstm_pallas import lstm_pallas_train, supported_train
from bonito_tpu.util import accuracy as jax_accuracy
from bonito_tpu_torch import checkpoint, schedule, training
from bonito_tpu_torch.alignment import smith_waterman
from bonito_tpu_torch.cli import main as cli_main
from bonito_tpu_torch.config import save_config
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.util import accuracy

F32_TOL = 2e-5
UPDATE_TOL = 1e-6
LOSS_RTOL, NORM_RTOL = 1e-5, 1e-5
PARAM_MIN_EQUAL = 0.995
# the amp step (seen: loss 8.8e-6 relative, norm 4.8e-6, 0.985 of the
# parameters' entries equal, BatchNorm statistics within 3.9e-4)
AMP_LOSS_RTOL, AMP_NORM_RTOL, AMP_PARAM_MIN_EQUAL, AMP_BN_TOL = (
    1e-4, 1e-4, 0.97, 2e-3)
LR = 2e-3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_kernels(monkeypatch):
    """bonito_tpu's train step on its kernel routes on the CPU: the loss's
    gates taken as if on a TPU and its Pallas entries in interpret mode
    (as tests/test_torch_loss.py), and ``lstm_train`` through the interpret
    ``lstm_pallas_train`` where ``supported_train`` holds, its scan
    elsewhere. No file of bonito_tpu changes."""
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

    def lstm_train(x, w_ih, w_hh, b, reverse=False):
        if supported_train(x, w_hh, require_tpu=False):
            return lstm_pallas_train(x, w_ih, w_hh, b, reverse=reverse,
                                     interpret=True)
        return jax_lstm.lstm_scan(x, w_ih, w_hh, b, reverse=reverse)
    monkeypatch.setattr(jax_lstm, "lstm_train", lstm_train)


# ---------------------------------------------------------------------------
# schedules, ClipGrad, the AdamW update
# ---------------------------------------------------------------------------

SCHEDULES = [
    ("linear_warmup_cosine_decay", {}),
    ("linear_warmup_cosine_decay", {"warmup_steps": 7, "end_ratio": 0.1}),
    ("linear_warmup_const_inverse_sqrt_decay", {}),
    ("linear_warmup_const_inverse_sqrt_decay",
     {"warmup_steps": 5, "decay_start_epoch": 1, "decay_scale": 2.0,
      "linear_cooldown_n_epochs": 1, "linear_cooldown_end_ratio": 0.1}),
    ("linear_cooldown", {"end_ratio": 0.2}),
]


@pytest.mark.parametrize("last_epoch", [0, 2])
@pytest.mark.parametrize("name,kwargs", SCHEDULES)
def test_schedules_match_bonito_tpu(name, kwargs, last_epoch):
    steps, epochs = 11, 4
    ref = getattr(jax_schedule, name)(**kwargs)(steps, epochs, last_epoch)
    out = getattr(schedule, name)(**kwargs)(steps, epochs, last_epoch)
    for step in range(steps * (epochs - last_epoch) + 3):
        assert out(step) == ref(step), step


def test_clip_grad_matches_bonito_tpu():
    ref, out = jax_training.ClipGrad(buffer_size=7), training.ClipGrad(
        buffer_size=7)
    norms = np.random.default_rng(2).lognormal(size=20).tolist()
    norms[5] = float("nan")
    for norm in norms:
        ref.update(norm)
        out.update(norm)
        assert out.max_norm() == ref.max_norm()


def test_adamw_update_matches_optax():
    """Five steps of gradients from numpy through the port's update (the
    global-norm clip, AdamW, the whole update times lr_scale) against
    bonito_tpu's: optax.adamw(lr, weight_decay=0.01, eps=1e-8), the clip
    and lr_scale as ``make_train_step`` applies them. The norms of steps
    1 and 3 exceed the clip."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(3, 5)).astype(np.float32),
              "b": rng.normal(size=5).astype(np.float32)}
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in params.items()} for s in (0.1, 3.0, 0.5, 4.0, 0.2)]
    scales = [0.1, 0.5, 1.0, 0.7, 0.2]

    tx = optax.adamw(LR, weight_decay=0.01, eps=1e-8)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    module = torch.nn.Module()
    for k, v in params.items():
        module.register_parameter(k, torch.nn.Parameter(torch.tensor(v)))
    opt = training.make_optimizer(module, LR)
    for g, lr_scale in zip(grads, scales):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        norm = optax.global_norm(jg)
        jg = jax.tree.map(lambda x: x * jnp.minimum(1.0, 2.0 / (norm + 1e-12)),
                          jg)
        upd, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * lr_scale, upd))
        for k, p in module.named_parameters():
            p.grad = torch.tensor(g[k])
        out_norm = training.clip_and_update(opt, [LR], lr_scale, 2.0)
        np.testing.assert_allclose(out_norm.item(), float(norm), rtol=1e-6)
        for k, p in module.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=UPDATE_TOL)


def test_other_optimisers_and_options_raise():
    module = torch.nn.Linear(2, 2)
    with pytest.raises(NotImplementedError, match="only AdamW"):
        training.make_optimizer(module, LR, package="optax", symbol="sgd")
    with pytest.raises(NotImplementedError, match="per-group"):
        training.make_optimizer(module, [LR, LR])
    with pytest.raises(NotImplementedError, match="nesterov"):
        training.make_optimizer(module, LR, nesterov=True)


# ---------------------------------------------------------------------------
# one train step against make_train_step
# ---------------------------------------------------------------------------

def _model_pair(seed=3):
    cfg = lstm_crf_config(features=32, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=500, overlap=100)
    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(seed))
    # BatchNorm statistics away from (0, 1), so that their update shows
    params = jax.tree.map(np.asarray, jm.params)
    rng = np.random.default_rng(seed)
    for conv in params["encoder"].values():
        if isinstance(conv, dict) and "norm" in conv:
            n = conv["norm"]
            n["mean"] = (0.1 * rng.normal(size=n["mean"].shape)).astype(
                np.float32)
            n["var"] = (1 + 0.1 * rng.random(n["var"].shape)).astype(
                np.float32)
    jm.params = jax.tree.map(jnp.asarray, params)
    pm = checkpoint.params_from_jax(Model(cfg), params)
    return cfg, jm, pm


def _batch(N=8, chunk=300, L=30, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N, chunk, 1)).astype(np.float32)
    lengths = rng.integers(L // 2, L + 1, N).astype(np.int32)
    targets = rng.integers(1, 5, (N, L)).astype(np.int32)
    targets[np.arange(L)[None] >= lengths[:, None]] = 0
    return x, targets, lengths


def _flat_jax(params):
    flat = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = ".".join(str(p.key) for p in path)
        value = np.asarray(jnp.asarray(leaf, jnp.float32))
        if value.ndim == 3 and key.endswith(".w"):
            value = value.transpose(2, 1, 0)  # conv [W, I, O] -> [O, I, W]
        flat[key] = value
    return flat


def _steps(cfg, jm, pm, use_amp, split, lr_scale=0.5):
    batch = _batch()
    tx = optax.adamw(LR, weight_decay=0.01, eps=1e-8)
    jstep = jax_training.make_train_step(jm, tx, use_amp=use_amp,
                                         grad_accum_split=split)
    params, _, jlosses, jnorm = jstep(
        jm.params, tx.init(jm.params), tuple(jnp.asarray(b) for b in batch),
        jnp.float32(lr_scale), jnp.float32(2.0))
    opt = training.make_optimizer(pm, LR)
    step = training.make_train_step(pm, opt, use_amp=use_amp,
                                    grad_accum_split=split)
    losses, norm = step(tuple(torch.from_numpy(b) for b in batch), lr_scale,
                        2.0)
    return (float(jlosses["loss"]), float(jnorm), _flat_jax(params),
            float(losses["loss"]), float(norm),
            {k: v.detach().float().numpy() for k, v in pm.state_dict().items()})


def _hold_params(out, ref, before, min_equal, bn_tol, lr_scale=0.5):
    assert out.keys() == ref.keys()
    equal = total = 0
    for k in ref:
        diff = np.abs(out[k] - ref[k])
        if k.endswith(("norm.mean", "norm.var")):
            np.testing.assert_allclose(out[k], ref[k], rtol=bn_tol,
                                       atol=bn_tol)
            assert not np.array_equal(out[k], before[k]), k
            continue
        assert diff.max() <= 2 * LR * lr_scale * 1.01, (k, diff.max())
        if k.endswith(".b") and k[:-1] + "norm.mean" in ref:
            continue  # a bias in front of BatchNorm: no gradient
        equal += int((diff <= UPDATE_TOL).sum())
        total += diff.size
    assert equal / total >= min_equal, equal / total


@pytest.mark.parametrize("split", [1, 2])
def test_train_step_matches_bonito_tpu(jax_kernels, split):
    cfg, jm, pm = _model_pair()
    before = {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}
    jloss, jnorm, ref, loss, norm, out = _steps(cfg, jm, pm, False, split)
    np.testing.assert_allclose(loss, jloss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(norm, jnorm, rtol=NORM_RTOL)
    _hold_params(out, ref, before, PARAM_MIN_EQUAL, F32_TOL)
    assert not pm.training


def test_amp_train_step_matches_bonito_tpu(jax_kernels):
    cfg, jm, pm = _model_pair()
    before = {k: v.detach().numpy().copy() for k, v in pm.state_dict().items()}
    jloss, jnorm, ref, loss, norm, out = _steps(cfg, jm, pm, True, 1)
    np.testing.assert_allclose(loss, jloss, rtol=AMP_LOSS_RTOL)
    np.testing.assert_allclose(norm, jnorm, rtol=AMP_NORM_RTOL)
    _hold_params(out, ref, before, AMP_PARAM_MIN_EQUAL, AMP_BN_TOL)
    # the master weights stay f32
    assert all(p.dtype == torch.float32 for p in pm.parameters())


# ---------------------------------------------------------------------------
# Trainer.fit: a resumed run continues as an unbroken one; the CLI
# ---------------------------------------------------------------------------

def _small_model(seed=4):
    cfg = lstm_crf_config(features=16, num_layers=2, state_len=3, stride=5)
    return cfg, Model(cfg).init(seed)


def _trainer(model, restore_optim=False):
    train = [_batch(seed=s) for s in (1, 2)]
    valid = [_batch(seed=3)]
    return training.Trainer(
        model, train, valid, use_amp=False,
        lr_scheduler_fn=schedule.linear_cooldown(end_ratio=1.0),
        restore_optim=restore_optim, save_optim_every=1,
        chunks_per_epoch=16, batch_size=8)


def test_resumed_training_continues_as_unbroken(tmp_path):
    """Two epochs straight against one epoch and a resume with the
    optimiser's state (a schedule that does not depend on the run's
    length, as a resume leaves the epoch target unchanged): the same
    weights, optimiser state and logs. The weights load in bonito_tpu."""
    cfg, straight = _small_model()
    _, resumed = _small_model()
    training.Trainer.fit(_trainer(straight), tmp_path / "a", epochs=2)
    _trainer(resumed).fit(tmp_path / "b", epochs=1)
    _, fresh = _small_model(seed=9)  # the resume loads its weights
    _trainer(fresh, restore_optim=True).fit(tmp_path / "b", epochs=2)
    a = checkpoint.load_params(tmp_path / "a" / "weights_2.npz")
    b = checkpoint.load_params(tmp_path / "b" / "weights_2.npz")
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    oa = torch.load(tmp_path / "a" / "optim_2.pt", weights_only=True)
    ob = torch.load(tmp_path / "b" / "optim_2.pt", weights_only=True)
    for i, state in oa["state"].items():
        for k, v in state.items():
            assert torch.equal(v, ob["state"][i][k]), (i, k)
    rows = (tmp_path / "b" / "training.csv").read_text().splitlines()
    assert len(rows) == 3 and rows[0].startswith("time,duration,epoch")
    assert len((tmp_path / "b" / "losses_2.csv").read_text().splitlines()) == 3

    jm = JaxModel(cfg)
    jm.init(jax.random.PRNGKey(0))
    tree = jax_load_params(tmp_path / "b" / "weights_2.npz")
    ref = {k: v.shape for k, v in _flat_jax(jm.params).items()}
    assert {k: v.shape for k, v in _flat_jax(tree).items()} == ref
    scores = jm.apply(tree, jnp.asarray(_batch()[0]))
    assert np.isfinite(np.asarray(scores)).all()


def _npy_dir(path, rows, chunk=300, L=30, seed=6):
    rng = np.random.default_rng(seed)
    path.mkdir(parents=True)
    lengths = rng.integers(L // 2, L + 1, rows)
    refs = rng.integers(1, 5, (rows, L))
    refs[np.arange(L)[None] >= lengths[:, None]] = 0
    np.save(path / "chunks.npy", rng.normal(size=(rows, chunk)).astype(
        np.float16))
    np.save(path / "references.npy", refs.astype(np.uint8))
    np.save(path / "reference_lengths.npy", lengths.astype(np.uint16))


def test_train_cli_on_the_cpu(tmp_path):
    cfg, _ = _small_model()
    save_config(cfg, tmp_path / "config.toml")
    _npy_dir(tmp_path / "data", 24)
    work = tmp_path / "work"
    cli_main(["train", str(work), "--config", str(tmp_path / "config.toml"),
              "--directory", str(tmp_path / "data"), "--device", "cpu",
              "--batch", "8", "--epochs", "1", "--valid-chunks", "8",
              "--no-amp"])
    assert (work / "weights_1.npz").exists() and (work / "config.toml").exists()
    assert len((work / "losses_1.csv").read_text().splitlines()) == 3
    header, row = (work / "training.csv").read_text().splitlines()
    fields = dict(zip(header.split(","), row.split(",")))
    assert np.isfinite(float(fields["validation_loss"]))
    assert 0 <= float(fields["validation_mean"]) <= 100
    with pytest.raises(SystemExit):  # the workdir exists, no -f
        cli_main(["train", str(work), "--config", str(tmp_path / "config.toml"),
                  "--directory", str(tmp_path / "data"), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 12"):
        cli_main(["train", str(tmp_path / "w2"), "--distributed",
                  "--directory", str(tmp_path / "data"), "--device", "cpu"])
    with pytest.raises(KeyError, match="unknown model"):
        cli_main(["train", str(tmp_path / "w3"), "--directory",
                  str(tmp_path / "data"), "--device", "cpu"])
    # duplex runs now: one pair of reads from a BAM, its consensus as fastq
    from bonito_tpu_torch.bam import BAMWriter
    from test_torch_duplex import run
    seq = "ACGTTGCAAGGCTTACCGATGCATGCCATTAGGACT" * 5
    comp = seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    with open(tmp_path / "calls.bam", "wb") as f:
        w = BAMWriter(f, "@HD\tVN:1.6\tSO:unknown\n", [])
        w.write("t", seq, "5" * len(seq))
        w.write("c", comp, "+" * len(comp))
        w.close()
    (tmp_path / "pairs.txt").write_text("template complement\nt c\n")
    from bonito_tpu_torch.cli import duplex
    run(duplex, [str(tmp_path / "calls.bam"), str(tmp_path / "pairs.txt"),
                 "--threads", "0"], tmp_path / "duplex.fastq")
    lines = (tmp_path / "duplex.fastq").read_text().splitlines()
    assert lines[0].split()[0] == "@t;c" and lines[1] == seq


# ---------------------------------------------------------------------------
# accuracy
# ---------------------------------------------------------------------------

def test_smith_waterman_and_accuracy_match_bonito_tpu():
    rng = np.random.default_rng(8)
    letters = np.array(list("ACGT"))
    for i in range(30):
        ref = "".join(rng.choice(letters, rng.integers(20, 200)))
        seq = list(ref[rng.integers(0, 10):])
        for _ in range(rng.integers(0, 20)):  # substitutions, indels
            j = int(rng.integers(0, len(seq)))
            op = rng.integers(0, 3)
            if op == 0:
                seq[j] = str(rng.choice(letters))
            elif op == 1:
                seq.insert(j, str(rng.choice(letters)))
            elif len(seq) > 1:
                del seq[j]
        seq = "".join(seq) if i % 7 else "".join(rng.choice(letters, 40))
        out, want = smith_waterman(seq, ref), jax_sw(seq, ref)
        assert (out is None) == (want is None)
        if out is not None:
            assert astuple(out) == astuple(want)
        for kw in ({}, {"balanced": True}, {"min_coverage": 0.5}):
            assert accuracy(ref, seq, **kw) == jax_accuracy(ref, seq, **kw)
    assert accuracy("ACGT", "") == 0.0
