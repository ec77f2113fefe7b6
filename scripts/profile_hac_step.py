#!/usr/bin/env python3
"""
Where one hac device step of the PyTorch/CUDA port spends the card's time.

    python3 scripts/profile_hac_step.py [int8]

from the root of a checkout, on a machine with a CUDA card. Builds a
random full-width hac model (as chip_smoke.py does, without the trip
through a model directory) — the bf16 model, or with ``int8`` the
quantised one on its default route (kernel D chain, int8 head) —, runs one warm-up batch of 96 x 9996 samples
through ``make_compute_fn``, then traces two more with ``torch.profiler``
and prints, for the traced window: its wall time, the device time by
kernel name (count, total, mean), the device busy share (sum of kernel
times over the wall time; one stream, so kernels do not overlap) and the
card's name and power limit.
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
from bonito_tpu_torch.models import lstm_crf_config  # noqa: E402

BATCH, CHUNK, STEPS = 96, 9996, 2


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
    if sys.argv[1:] not in ([], ["int8"]):
        raise SystemExit(__doc__)
    quantize = sys.argv[1:] == ["int8"]
    model = Model(lstm_crf_config(quantize=quantize)).init(1)
    nn.fuse_bn(model.encoder)
    model.to_bf16()
    if quantize:
        model.quantize()
    model.to("cuda")
    compute = make_compute_fn(model, BATCH, CHUNK)
    signal = np.random.default_rng(1).normal(size=(BATCH, CHUNK))
    prepared = compute.prepare(signal.astype(np.float32))
    compute.fetch(compute.dispatch(prepared))  # warm-up: build, cuBLAS, cuDNN

    activities = [torch.profiler.ProfilerActivity.CPU,
                  torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            compute.fetch(compute.dispatch(prepared))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6

    rows = [(e.key, e.count, device_us(e)) for e in prof.key_averages()
            if device_us(e) > 0 and e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[2])
    busy = sum(r[2] for r in rows)
    print(f"card: {card}; model: hac, {'int8' if quantize else 'bf16'}")
    print(f"{STEPS} device steps traced: wall {wall_us / 1e3:.4g} ms, "
          f"{wall_us / 1e3 / STEPS:.4g} ms per step")
    print(f"{'device time by kernel':<60} {'count':>7} {'total ms':>10} "
          f"{'mean us':>9}")
    for key, count, us in rows[:15]:
        print(f"{key[:60]:<60} {count:>7} {us / 1e3:>10.4g} "
              f"{us / count:>9.4g}")
    print(f"device busy {busy / 1e3:.4g} ms of {wall_us / 1e3:.4g} ms: "
          f"busy share {busy / wall_us:.4f}, idle share "
          f"{1 - busy / wall_us:.4f} (on {card})")
    if not rows:
        raise SystemExit("profile_hac_step: the profiler saw no device time")


if __name__ == "__main__":
    main()
