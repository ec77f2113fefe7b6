#!/usr/bin/env python3
"""
Where one device step of the PyTorch/CUDA port spends the card's time.

    python3 scripts/profile_hac_step.py [int8 | fast | fastrev | sup | train |
                                         suptrain | evaluate [fast]]

from the root of a checkout, on a machine with a CUDA card. Builds a
random full-width model (as chip_smoke.py does, without the trip through
a model directory): the bf16 hac model; with ``int8`` the quantised hac
model on its default route (kernel D chain, int8 head); with ``fast`` the
fast model as shipped (quantize=true: dequantised weights through kernel
F, then the fused-head decode G + J); with ``fastrev`` the same model's
reverse strand (``--revcomp``: kernel F, the head's full scores, the
full-score decode M + Q read in reverse-complement order); with ``sup``
the transformer model as shipped (bf16: the layout pin P, 18 fused
attention launches K, the TCN decode B + C). It runs one warm-up batch (hac 96 x 9996 samples, fast
1024 x 6000, sup 128 x 12000) through ``make_compute_fn``, then traces
two more with ``torch.profiler`` and prints, for the traced window: its
wall time, the device time by kernel name (count, total, mean), the device
busy share (sum of kernel times over the wall time; one stream, so kernels
do not overlap) and the card's name and power limit. Beside it, the host's
time to prepare one batch (the int8 signal wire), which the pipeline runs
in a thread of its own.

With ``train`` it traces two train steps of hac instead (after a warm-up
step): ``lstm_crf_config()`` with f32 master weights, the bf16 forward,
batch 128 x 6000 samples with targets of 250 to 500 bases, AdamW 2e-3 and
the clip at 2.0 (``training.make_train_step``, kernels R, S, U, V, Y, Z),
and prints the same table. With ``suptrain`` it does the same for the sup
train step: the shipped sup model with f32 master weights, the bf16
forward, batch 32 x 12288 samples with targets of 1024 bases, AdamW 2e-3
and the clip at 2.0 (kernels P twice, H and O once a layer, U, V, Y, Z).

With ``evaluate`` it traces what ``evaluate`` runs for a batch at its
defaults: the hac model (with ``fast`` the fast model) in f32, as
``evaluate`` loads it (half=False, quantize off), its CRF weight scaled as
chip_smoke.py's so that it emits, on 256 chunks of 3000 samples: the
forward (kernel A's f32 instance, or F's, with the convs and
projections) and ``decode_batch`` on the full scores (M, Q, then the
host's sequences). It traces two batches on the new f32 kernels and two
with the earlier f32 kernels in their place (A's plan swapped for None,
the LSTM layer's kernel F for ``lstm_fused_old_kernel``), and prints both
tables.
"""

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bonito_tpu_torch import nn  # noqa: E402
from bonito_tpu_torch.crf.basecall import make_compute_fn  # noqa: E402
from bonito_tpu_torch.crf.model import Model  # noqa: E402
from bonito_tpu_torch.models import MODELS, lstm_crf_config  # noqa: E402
from bonito_tpu_torch.transformer.model import Model as SupModel  # noqa: E402

STEPS = 2
FAST = "dna_r10.4.1_e8.2_400bps_fast@v4.3"
SUP = "dna_r10.4.1_e8.2_400bps_sup@v5.0"


def device_us(event):
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return getattr(event, name)
    return 0.0


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_hac_step: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    if sys.argv[1:] not in ([], ["int8"], ["fast"], ["fastrev"], ["sup"],
                            ["train"], ["suptrain"], ["evaluate"],
                            ["evaluate", "fast"]):
        raise SystemExit(__doc__)
    which = (sys.argv[1:] or ["bf16"])[0]
    if which == "evaluate":
        evaluate_batch(card, "fast" in sys.argv[2:])
        return
    if which in ("train", "suptrain"):
        sup = which == "suptrain"
        step, batch = sup_train_step() if sup else train_step()
        step(batch, 1.0, 2.0)  # warm-up: build, cuBLAS, cuDNN
        report(card, f"{'sup' if sup else 'hac'} train step (f32 master "
               f"weights, bf16 forward)", *batch[0].shape[:2],
               lambda: step(batch, 1.0, 2.0), rows_shown=25 if sup else 20)
        return
    cfg = (MODELS[FAST]() if which in ("fast", "fastrev") else MODELS[SUP]()
           if which == "sup" else lstm_crf_config())
    batch = cfg["basecaller"]["batchsize"]
    model = (SupModel if which == "sup" else Model)(cfg).init(1)
    chunk = cfg["basecaller"]["chunksize"] // model.stride * model.stride
    nn.fuse_bn(model.encoder)
    model.to_bf16()
    if which in ("int8", "fast", "fastrev"):
        model.quantize()
    model.to("cuda")
    compute = make_compute_fn(model, batch, chunk,
                              reverse=which == "fastrev")
    signal = np.random.default_rng(1).normal(size=(batch, chunk)).astype(
        np.float32)
    prepared = compute.prepare(signal)
    compute.fetch(compute.dispatch(prepared))  # warm-up: build, cuBLAS, cuDNN
    t0 = time.perf_counter()
    for _ in range(3):
        compute.prepare(signal)
    prepare_ms = (time.perf_counter() - t0) / 3 * 1e3

    name = {"fast": "fast, quantize=true",
            "fastrev": "fast, quantize=true, reverse strand",
            "sup": "sup, bf16"}.get(which, f"hac, {which}")
    print(f"host prepare (int8 wire, numpy) {prepare_ms:.4g} ms per batch")
    report(card, name, batch, chunk,
           lambda: compute.fetch(compute.dispatch(prepared)),
           rows_shown=25 if which == "sup" else 15)


def evaluate_batch(card, fast):
    """``evaluate``'s batch at its defaults, traced on the new f32 kernels
    and on the earlier ones."""
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.ops import lstm_cuda, lstm_fused_cuda
    cfg = MODELS[FAST]() if fast else lstm_crf_config()
    model = Model(cfg).init(1)
    _, (_, crf), _ = model.decode_head()
    with torch.no_grad():
        crf.w.mul_(13.5 if fast else 8.0)  # chip_smoke.py's CRF scales
    model.to("cuda").requires_grad_(False)  # as load_model: BN unfused
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(256, 3000, 1)).astype(np.float32)).to("cuda")

    def run():
        with torch.inference_mode():
            return model.decode_batch(model(x))
    run()  # warm-up: build, cuDNN
    name = f"{'fast' if fast else 'hac'} in f32, evaluate's batch"
    report(card, f"{name}, the new f32 kernels", 256, 3000, run,
           rows_shown=15)
    rules = (lstm_cuda.f32_plan, ops_lstm.lstm_fused)
    lstm_cuda.f32_plan = lambda *a, **kw: None
    ops_lstm.lstm_fused = lstm_fused_cuda.lstm_fused_old_kernel
    try:
        run()
        report(card, f"{name}, the earlier f32 kernels", 256, 3000, run,
               rows_shown=15)
    finally:
        lstm_cuda.f32_plan, ops_lstm.lstm_fused = rules


def train_step():
    """hac's train step and one batch on the card."""
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    model = Model(lstm_crf_config()).init(1).to("cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(128, 6000, 1)).astype(np.float32))
    lengths = rng.integers(250, 501, 128)
    targets = rng.integers(1, 5, (128, 500))
    targets[np.arange(500)[None] >= lengths[:, None]] = 0
    batch = tuple(t.to("cuda") for t in (x, torch.from_numpy(targets),
                                         torch.from_numpy(lengths)))
    return make_train_step(model, make_optimizer(model, 2e-3)), batch


def sup_train_step():
    """The shipped sup model's train step and one batch of the JAX
    package's sup train bench on the card."""
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    model = SupModel(MODELS[SUP]()).init(1).to("cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(32, 12288, 1)).astype(np.float32))
    targets = torch.from_numpy(rng.integers(1, 5, (32, 1024)))
    lengths = torch.full((32,), 1024)
    batch = tuple(t.to("cuda") for t in (x, targets, lengths))
    return make_train_step(model, make_optimizer(model, 2e-3)), batch


def report(card, name, batch, chunk, run, rows_shown):
    """Trace STEPS calls of ``run`` and print the device time by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    rows = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
            if device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"card: {card}; model: {name}, batch {batch} x {chunk} samples")
    print(f"{STEPS} device steps traced: wall {wall_us / 1e3:.4g} ms, "
          f"{wall_us / 1e3 / STEPS:.4g} ms per step")
    print(f"{'device time by kernel':<60} {'count':>7} {'total ms':>10} "
          f"{'mean us':>9}")
    for key, count, us in rows[:rows_shown]:
        print(f"{key[:60]:<60} {count:>7} {us / 1e3:>10.4g} "
              f"{us / count:>9.4g}")
    print(f"device busy {busy / 1e3:.4g} ms of {wall_us / 1e3:.4g} ms: "
          f"busy share {busy / wall_us:.4f}, idle share "
          f"{1 - busy / wall_us:.4f} (on {card})")
    if not rows:
        raise SystemExit("profile_hac_step: the profiler saw no device time")


if __name__ == "__main__":
    main()
