"""f32 through the port's hand-kernel routes, on the CPU against bonito_tpu:
what ``evaluate`` (``half=False``) and a ``--no-amp`` validation run on the
card. The plain versions of kernel A (projection + recurrence, H above
256) and of kernel F (the small layer, xw kept in f32) in f32 against
bonito_tpu's ``lstm_scan`` and its ``lstm_pallas_fused`` in interpret mode
within the LSTM recurrence's 1e-5; B and C's plain versions on f32 moves
against ``viterbi_decode_tcn`` (sequences and moves identical, qstrings
within one phred step); ``evaluate`` of a wide LSTM-CRF directory (A's
route) as bonito_tpu's; and one f32 train step followed by its validation
(the forward in eval mode, ``loss_tcn``, the TCN decode) against
``make_train_step(use_amp=False)`` and bonito_tpu's validation on the same
parameters. The new f32 kernels of A and F (``csrc/lstm_f32.cu``) with
their sums emulated in the kernels' order, against the plain versions and
bonito_tpu's ``lstm_pallas`` and ``lstm_pallas_fused`` in interpret
mode; and S's f32 kernel (``csrc/lstm_f32.cu``), its sums emulated in
its order, against its plain version and bonito_tpu's ``lstm_pallas_train``
gradient in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bonito_tpu import checkpoint as jckpt
from bonito_tpu import config as jconfig
from bonito_tpu import training as jax_training
from bonito_tpu.cli import evaluate as jax_evaluate
from bonito_tpu.crf.model import Model as JaxModel
from bonito_tpu.crf.seqdist import CTC_CRF as JaxCRF
from bonito_tpu.models import lstm_crf_config
from bonito_tpu.ops import decode_pallas
from bonito_tpu.ops.lstm import lstm_scan
from bonito_tpu.ops.lstm_pallas import (lstm_pallas, lstm_pallas_fused,
                                       lstm_pallas_train)
from bonito_tpu_torch import checkpoint, training
from bonito_tpu_torch.cli import evaluate as port_evaluate
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.ops import (decode, lstm_cuda, lstm_fused_cuda,
                                  lstm_train_cuda)
from bonito_tpu_torch.ops.lstm import lstm, small_h

from test_torch_ctc_cli import npy_dir, report, run_evaluate
from test_torch_train import LR, _batch, _model_pair, jax_kernels  # noqa: F401

LSTM_TOL = 1e-5  # the LSTM recurrence, f32 against f32 (ROADMAP)
# the gates' gradient: with c, the activations and the gradient stored in
# bf16 an f32 sum in another order can round to the neighbouring bf16 value
# (and move the steps after it): within GRAD_STEPS bf16 steps of the
# largest entry, as tests/test_torch_lstm_train.py holds the port to
# bonito_tpu; stored in f32, within GRAD_F32 of the largest entry (f32
# sums of 4H terms in another order, carried back over the steps)
GRAD_STEPS, GRAD_F32 = 2, 1e-5
ALPHABET = ["N", "A", "C", "G", "T"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(seed, N, T, C, H):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.normal(size=(N, T, C))).astype(np.float32)
    w_ih = (rng.normal(size=(C, 4 * H)) / np.sqrt(C)).astype(np.float32)
    w_hh = (rng.normal(size=(H, 4 * H)) / np.sqrt(H)).astype(np.float32)
    b = (0.5 * rng.normal(size=4 * H)).astype(np.float32)
    return x, w_ih, w_hh, b


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("C,H", [(96, 272), (64, 768), (32, 1024)])
def test_a_plain_f32_matches_lstm_scan(C, H, reverse):
    """A wide layer (H above 256: projection, then kernel A's plain
    version, ``lstm_recurrence_plain``, in f32) against ``lstm_scan``, the
    route bonito_tpu's f32 hac LSTM takes (its Pallas gate rejects a 16 MB
    f32 W_hh at H 1024)."""
    x, w_ih, w_hh, b = _layer(H + reverse, 4, 20, C, H)
    assert not small_h(C, H)
    ref = lstm_scan(jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh),
                    jnp.asarray(b), reverse=reverse)
    out = lstm(*map(torch.from_numpy, (x, w_ih, w_hh, b)), reverse=reverse)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=LSTM_TOL)
    xw = torch.from_numpy(x).transpose(0, 1) @ torch.from_numpy(w_ih)
    xw = (xw + torch.from_numpy(b)).contiguous()
    h = lstm_cuda.lstm_recurrence_plain(xw, torch.from_numpy(w_hh), reverse)
    np.testing.assert_array_equal(h.transpose(0, 1).numpy(), out.numpy())


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("C,H", [(96, 96), (32, 32), (64, 128)])
def test_f_plain_f32_matches_pallas_fused_and_scan(C, H, reverse, bias):
    """The small layer (kernel F's plain version in f32, xw kept in f32)
    against bonito_tpu's ``lstm_pallas_fused`` in interpret mode in f32,
    what its ``supported_fused`` sends an f32 fast model through, and
    against ``lstm_scan``."""
    x, w_ih, w_hh, b = _layer(C + H + reverse, 8, 12, C, H)
    b = b if bias else None
    assert small_h(C, H)
    jargs = (jnp.asarray(x), jnp.asarray(w_ih), jnp.asarray(w_hh),
             None if b is None else jnp.asarray(b))
    fused = lstm_pallas_fused(*jargs, reverse=reverse, interpret=True)
    scan = lstm_scan(*jargs, reverse=reverse)
    out = lstm_fused_cuda.lstm_fused_plain(
        torch.from_numpy(x).transpose(0, 1), torch.from_numpy(w_ih),
        torch.from_numpy(w_hh), None if b is None else torch.from_numpy(b),
        reverse=reverse).transpose(0, 1)
    assert out.dtype == torch.float32
    for ref in (fused, scan):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=LSTM_TOL)
    routed = lstm(*map(torch.from_numpy, (x, w_ih, w_hh)),
                  None if b is None else torch.from_numpy(b),
                  reverse=reverse)
    np.testing.assert_array_equal(routed.numpy(), out.numpy())


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("state_len", [2, 3, 4])
def test_b_c_plain_f32_match_viterbi_decode_tcn(state_len, seed):
    """The TCN decode of f32 moves (B and C's plain versions, what the f32
    ring computes bit for bit) against bonito_tpu's ``viterbi_decode_tcn``
    in f32 (its Pallas kernels in interpret mode)."""
    S = 4 ** state_len
    rng = np.random.default_rng(seed + state_len)
    mv = (3.0 * rng.normal(size=(30, S * 4, 6))).astype(np.float32)
    ref = decode_pallas.viterbi_decode_tcn(
        JaxCRF(state_len, ALPHABET), jnp.asarray(mv), 2.0, qscale=1.05,
        qbias=0.2, interpret=True)
    out = decode.viterbi_decode_tcn(CTC_CRF(state_len, ALPHABET),
                                    torch.from_numpy(mv), 2.0, qscale=1.05,
                                    qbias=0.2)
    for k in ("sequence", "moves"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    dq = out["qstring"].numpy().astype(int) - np.asarray(ref["qstring"])
    assert np.abs(dq).max() <= 1
    assert 0 < out["moves"].numpy().mean() < 1


@pytest.fixture(scope="module")
def wide_dir(tmp_path_factory):
    """An LSTM-CRF directory at H 272 (above F's 256: projection + kernel
    A), written by bonito_tpu, its CRF weight scaled so that it emits."""
    model = tmp_path_factory.mktemp("wide") / "model"
    model.mkdir()
    cfg = lstm_crf_config(features=272, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=1000, overlap=200)
    cfg["basecaller"]["quantize"] = False
    m = JaxModel(cfg)
    m.init(jax.random.PRNGKey(14))
    crf = str(next(i for i, layer in enumerate(cfg["encoder"]["sublayers"])
                   if layer["type"] == "linearcrfencoder"))
    m.params["encoder"][crf]["w"] = m.params["encoder"][crf]["w"] * 10
    jconfig.save_config(cfg, model / "config.toml")
    jckpt.save_params(model / "weights_1.npz", m.params)
    return model


def test_evaluate_of_a_wide_lstm_crf_equals_bonito_tpus(wide_dir, tmp_path):
    """``evaluate`` in f32 through kernel A's route (its plain version on
    the CPU) and the full-score decode: the report and the three files
    equal bonito_tpu's."""
    data = npy_dir(tmp_path / "data", 40, 1000)
    ref = run_evaluate(jax_evaluate, wide_dir, data, tmp_path / "jax", [])
    out = run_evaluate(port_evaluate, wide_dir, data, tmp_path / "port",
                       ["--device", "cpu"])
    assert report(out) == report(ref)
    for name in ("seqs.fasta", "refs.fasta", "summ.txt"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text()), name
    seqs = (tmp_path / "port" / "seqs.fasta").read_text().splitlines()[1::2]
    assert sum(map(len, seqs)) > 100


@pytest.mark.parametrize("features", [32, 272], ids=["F", "A"])
def test_no_amp_step_and_validation_match_bonito_tpu(jax_kernels, features,
                                                     tmp_path):  # noqa: F811
    """One f32 train step (``make_train_step(use_amp=False)`` in both), then
    the validation of a batch on the port's new parameters, which
    bonito_tpu's Trainer reads from the port's ``weights_1.npz``: the loss
    within 1e-5, the same calls and accuracies."""
    cfg, jm, pm = _model_pair()
    if features != 32:
        cfg = lstm_crf_config(features=features, num_layers=2, state_len=3,
                              stride=5, batchsize=8, chunksize=500,
                              overlap=100)
        jm = JaxModel(cfg)
        jm.init(jax.random.PRNGKey(3))
        pm = checkpoint.params_from_jax(
            Model(cfg), jax.tree.map(np.asarray, jm.params))
    tx = optax.adamw(LR, weight_decay=0.01, eps=1e-8)
    batch = _batch()
    jstep = jax_training.make_train_step(jm, tx, use_amp=False)
    _, _, jlosses, _ = jstep(jm.params, tx.init(jm.params),
                             tuple(jnp.asarray(b) for b in batch),
                             jnp.float32(0.5), jnp.float32(2.0))
    step = training.make_train_step(pm, training.make_optimizer(pm, LR),
                                    use_amp=False)
    losses, _ = step(tuple(torch.from_numpy(b) for b in batch), 0.5, 2.0)
    np.testing.assert_allclose(float(losses["loss"]),
                               float(jlosses["loss"]), rtol=1e-5)

    checkpoint.save_params(tmp_path / "weights_1.npz", pm)
    jm.params = jax.tree.map(jnp.asarray,
                             jckpt.load_params(tmp_path / "weights_1.npz"))
    valid = _batch(seed=3)
    jseqs, _, jaccs, jl = jax_training.Trainer(
        jm, None, [valid], use_amp=False).validate_one_step(valid)
    seqs, _, accs, pl = training.Trainer(
        pm, None, [valid], use_amp=False).validate_one_step(valid)
    np.testing.assert_allclose(pl["loss"], jl["loss"], rtol=1e-5)
    assert seqs == jseqs and accs == jaccs
    assert not pm.training


@pytest.mark.parametrize("N,C,H,rows,block,registers,in_smem,smem,old", [
    # fast: W_ih's 144 KB in smem
    (1024, 96, 96, 8, 4, True, True, 227328, 165888),
    (37, 64, 128, 1, 32, False, True, 214016, 153600),
    # W_ih of 4 MB through L2
    (20, 1024, 256, 1, 18, False, False, 223232, 73728),
    (9, 32, 32, 1, 32, False, True, 41216, 22528)])
def test_f32_plan_of_kernel_f(N, C, H, rows, block, registers, in_smem, smem,
                              old):
    """F's f32 kernel's shape rule (pure Python; the C entry takes the plan
    as given and refuses shared memory other than ``csrc/lstm_f32.cu:
    f32_rows_smem_floats``'s for its layout) on an H100's 132 SMs: a thread
    a gate column, 1 to 8 rows a block (the fewest whose grid fits one
    wave), the x product ``block`` steps a pass, W_hh's column in registers
    at H 96 only, W_ih in shared memory where it fits the 227 KB a block
    may ask for. Beside it the earlier f32 kernel's layout (``csrc/
    lstm_fused.cu:f32_smem_floats``), which ``lstm_fused_old_kernel`` and a
    plan of None take: 8 rows a block, the step's rows of x, h and the
    gates beside W_ih."""
    plan = lstm_fused_cuda.f32_plan(N, C, H, 132)
    assert plan == {"dtype": "f32", "rows": rows, "threads": 4 * H,
                    "ctas": -(-N // rows), "block": block,
                    "whh_in_registers": registers, "wih_in_smem": in_smem,
                    "smem": smem}
    assert plan["smem"] <= lstm_fused_cuda.SMEM_LIMIT
    assert lstm_fused_cuda.f32_old_layout(N, C, H) == {
        "dtype": "f32", "rows": 8, "threads": 4 * H, "ctas": -(-N // 8),
        "whh_in_registers": registers, "wih_in_smem": in_smem, "smem": old}
    with pytest.raises(ValueError, match="kernel F"):
        lstm_fused_cuda.f32_plan(N, C + 8, H, 132)


# The new f32 kernels' order of sums, emulated here in torch. fmaf rounds
# once; the emulation takes the product exactly in f64 and rounds the sum to
# f64 and then to f32 (a double rounding fmaf does not have: a last-bit
# difference now and then), so it stands for the order, not for the bits.
def _fma(acc, a, b):
    return (acc.double() + a.double() * b.double()).float()


def _gates(gates, c):
    i, f, g, o = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _a32_emulated(xw, w_hh, plan, reverse):
    """csrc/lstm_f32.cu's kernel A on ``plan``: each k-slice s sums, in its
    warp's order, the k of each chunk from ch kc + s kc / ks on, one fmaf
    a k; the slices' sums added in slice order, then to xw."""
    T, N, G = xw.shape
    H = G // 4
    ks, kc = plan["k_slices"], plan["kc"]
    kn = kc // ks
    h = torch.zeros(N, H)
    c = torch.zeros(N, H)
    out = torch.empty(T, N, H)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        total = None
        for s in range(ks):
            acc = torch.zeros(N, G)
            for ch in range(H // kc):
                k0 = ch * kc + s * kn
                for k in range(k0, k0 + kn):
                    acc = _fma(acc, h[:, k:k + 1], w_hh[k])
            total = acc if total is None else total + acc
        h, c = _gates(xw[t] + total, c)
        out[t] = h
    return out


def _f32_emulated(x, w_ih, w_hh, b, plan, reverse):
    """csrc/lstm_f32.cu's kernel F on ``plan``: xw + b for a block of
    ``block`` steps first (each sum over k in order, the bias added last),
    then each step's h product over k in order (with 1 or 2 rows a block
    in 4 / rows sums of every (4 / rows)-th k, added in order), gates = xw
    + that."""
    T, N, C = x.shape
    H = w_hh.shape[0]
    order = list(range(T - 1, -1, -1) if reverse else range(T))
    h = torch.zeros(N, H)
    c = torch.zeros(N, H)
    out = torch.empty(T, N, H)
    bias = torch.zeros(4 * H) if b is None else b
    for j0 in range(0, T, plan["block"]):
        xs = {}
        for t in order[j0:j0 + plan["block"]]:
            acc = torch.zeros(N, 4 * H)
            for k in range(C):
                acc = _fma(acc, x[t][:, k:k + 1], w_ih[k])
            xs[t] = acc + bias
        chains = 4 // plan["rows"] if plan["rows"] < 4 else 1
        for t in order[j0:j0 + plan["block"]]:
            acc = [torch.zeros(N, 4 * H) for _ in range(chains)]
            for k in range(H):
                acc[k % chains] = _fma(acc[k % chains], h[:, k:k + 1],
                                       w_hh[k])
            total = acc[0]
            for a in acc[1:]:
                total = total + a
            h, c = _gates(xs[t] + total, c)
            out[t] = h
    return out


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,C,H", [(40, 32, 64), (96, 16, 128)])
def test_a32_order_of_sums_matches_plain_and_lstm_pallas(N, C, H, reverse):
    """Kernel A's f32 persistent kernel, its sums emulated in their order on
    its plan (k-slices over chunks), against its plain version and
    bonito_tpu's ``lstm_pallas`` in f32 in interpret mode, within the LSTM
    recurrence's 1e-5."""
    x, w_ih, w_hh, b = _layer(N + H + reverse, N, 6, C, H)
    plan = lstm_cuda.f32_plan(N, H, 132)
    assert plan["kc"] // plan["k_slices"] % 8 == 0
    xw = (torch.from_numpy(x).transpose(0, 1) @ torch.from_numpy(w_ih)
          + torch.from_numpy(b)).contiguous()
    w = torch.from_numpy(w_hh)
    out = _a32_emulated(xw, w, plan, reverse)
    plain = lstm_cuda.lstm_recurrence_plain(xw, w, reverse)
    torch.testing.assert_close(out, plain, rtol=0, atol=LSTM_TOL)
    ref = lstm_pallas(*map(jnp.asarray, (x, w_ih, w_hh, b)), reverse=reverse,
                      interpret=True)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=LSTM_TOL)


@pytest.mark.parametrize("reverse,bias", [(False, True), (True, False)])
@pytest.mark.parametrize("N,C,H", [(16, 96, 96), (9, 32, 32), (19, 32, 48),
                                   (256, 32, 32), (600, 32, 48)])
def test_f32_kernel_f_order_of_sums_matches_plain_and_pallas(N, C, H, reverse,
                                                             bias):
    """Kernel F's f32 kernel, its sums emulated in their order on its plan
    (the x product a block of steps ahead), against its plain version and
    bonito_tpu's ``lstm_pallas_fused`` in f32 in interpret mode, within
    1e-5."""
    x, w_ih, w_hh, b = _layer(N + C + H + reverse, N, 10, C, H)
    b = b if bias else None
    plan = lstm_fused_cuda.f32_plan(N, C, H, 132)
    plan = {**plan, "block": 4}  # several blocks in 10 steps
    xt = torch.from_numpy(x).transpose(0, 1).contiguous()
    args = (torch.from_numpy(w_ih), torch.from_numpy(w_hh),
            None if b is None else torch.from_numpy(b))
    out = _f32_emulated(xt, *args, plan, reverse)
    plain = lstm_fused_cuda.lstm_fused_plain(xt, *args, reverse=reverse)
    torch.testing.assert_close(out, plain, rtol=0, atol=LSTM_TOL)
    ref = lstm_pallas_fused(jnp.asarray(x), jnp.asarray(w_ih),
                            jnp.asarray(w_hh),
                            None if b is None else jnp.asarray(b),
                            reverse=reverse, interpret=True)
    np.testing.assert_allclose(out.transpose(0, 1).numpy(), np.asarray(ref),
                               rtol=0, atol=LSTM_TOL)


def _s32_emulated(w_hh, acts, c, g_h, plan, reverse, round_bf16):
    """csrc/lstm_f32.cu's kernel S on ``plan``: lane (k-slice s, k lane l)
    of the consumer warps sums, one fmaf a k, every 8th k of each chunk's
    kc / k_slices k from ch kc + s kc / k_slices + l, in order; the 8 k
    lanes' sums meet in the shuffle tree ((l0 + l4) + (l2 + l6)) + ((l1 +
    l5) + (l3 + l7)), the k-slices' sums are added in slice order, then
    g_h; the gradient's math in f32, stored in bf16 (``round_bf16``) or
    f32, the product's next input in f32."""
    T, N, G = acts.shape
    H = G // 4
    ks, kc = plan["k_slices"], plan["kc"]
    kn = kc // ks
    # the k each (slice, lane) sums, in its order: [ks, 8, positions]
    order = torch.tensor([[[ch * kc + s * kn + lane + 8 * i
                            for ch in range(G // kc)
                            for i in range(kn // 8)]
                           for lane in range(8)] for s in range(ks)])
    store = torch.bfloat16 if round_bf16 else torch.float32
    dgates = torch.empty(T, N, G, dtype=store)
    dc = torch.zeros(N, H)
    prev = None  # the previous step's f32 dgates
    steps = list(range(T) if reverse else range(T - 1, -1, -1))
    for j, t in enumerate(steps):
        dh = torch.zeros(N, H)
        if prev is not None:
            acc = torch.zeros(ks, 8, N, H)
            for pos in range(order.shape[2]):
                k = order[:, :, pos]                       # [ks, 8]
                a = prev[:, k].permute(1, 2, 0)[..., None]  # [ks, 8, N, 1]
                b = w_hh[:, k].permute(1, 2, 0)[:, :, None]  # [ks, 8, 1, H]
                acc = _fma(acc, a, b)
            q = acc[:, :4] + acc[:, 4:]
            r = q[:, :2] + q[:, 2:]
            part = r[:, 0] + r[:, 1]                       # [ks, N, H]
            dh = part[0]
            for s in range(1, ks):
                dh = dh + part[s]
        dh = dh + g_h[t].float()
        a = acts[t].float()
        i, f, g, o = (a[:, q * H:(q + 1) * H] for q in range(4))
        tc = torch.tanh(c[t].float())
        cp = (torch.zeros(N, H) if j == T - 1
              else c[t + 1 if reverse else t - 1].float())
        do = dh * tc
        dcv = dc + dh * o * (1.0 - tc * tc)
        prev = torch.cat([dcv * g * i * (1.0 - i), dcv * cp * f * (1.0 - f),
                          dcv * i * (1.0 - g * g), do * o * (1.0 - o)], 1)
        dgates[t] = prev.to(store)
        dc = dcv * f
    return dgates


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("N,H,chunks", [(16, 32, "plan"), (40, 64, "plan"),
                                        (40, 64, "narrow"), (9, 48, "narrow")])
def test_s32_order_of_sums_matches_plain_and_lstm_pallas_train(
        N, H, chunks, round_bf16, reverse):
    """Kernel S's f32 persistent kernel, its sums emulated in their order
    on its plan (or with the narrowest chunks the plan's k-slices allow, so
    that each sum runs over several chunks), on R's plain output: against
    S's plain version within GRAD_STEPS bf16 steps of the largest gradient
    where stored in bf16 and within GRAD_F32 of it in f32; and, stored in
    bf16 as bonito_tpu stores it, against the gradient of bonito_tpu's
    ``lstm_pallas_train`` in f32 in interpret mode (``jax.vjp`` through an
    identity projection, so that the input's gradient is the gates') within
    GRAD_STEPS bf16 steps of the largest."""
    x, _, w_hh, _ = _layer(N + H + reverse, N, 6, 4 * H, H)
    rng = np.random.default_rng(N + H)
    g = rng.normal(size=(N, 6, H)).astype(np.float32)
    plan = lstm_train_cuda.f32_backward_plan(N, H, 132, round_bf16)
    if chunks == "narrow":
        plan = {**plan, "kc": 8 * plan["k_slices"]}
    assert (4 * H) % plan["kc"] == 0 and 4 * H // plan["kc"] >= (
        2 if chunks == "narrow" else 1)
    xw = torch.from_numpy(x).transpose(0, 1).contiguous()
    w = torch.from_numpy(w_hh)
    g_h = torch.from_numpy(g).transpose(0, 1).contiguous()
    _, c, acts = lstm_train_cuda.lstm_train_forward_plain(xw, w, reverse,
                                                          round_bf16)
    out = _s32_emulated(w, acts, c, g_h, plan, reverse, round_bf16).float()
    plain = lstm_train_cuda.lstm_train_backward_plain(
        w, acts, c, g_h, reverse, round_bf16).float()
    big = plain.abs().max().item()
    tol = GRAD_STEPS * 2.0 ** -7 * big if round_bf16 else GRAD_F32 * big
    torch.testing.assert_close(out, plain, rtol=0, atol=tol)
    if not round_bf16:
        return
    eye = np.eye(4 * H, dtype=np.float32)
    _, vjp = jax.vjp(lambda a: lstm_pallas_train(
        a, jnp.asarray(eye), jnp.asarray(w_hh), None, reverse=reverse,
        interpret=True), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0]).transpose(1, 0, 2)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=GRAD_STEPS * 2.0 ** -7 * big)
