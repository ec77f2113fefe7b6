#!/usr/bin/env python3
"""
Times kernels D and E of the PyTorch/CUDA port (the int8 LSTM layers,
``bonito_tpu_torch/csrc/lstm_int8.cu``) at hac widths under other tile
constants than the source's, to show where its choices came from.

    python3 scripts/sweep_lstm_int8.py

from the root of a checkout, on a machine with a CUDA card and nvcc. For
each variant (rows per block, k-values per staged chunk, pipeline stages)
it copies the package into ``bonito_tpu_torch/build/sweep/<variant>/``,
rewrites the constants in the copy's source, builds it, checks D (int8
output) and E against their plain versions at N=96, T=1666, C=H=1024 and
prints their times per layer call (CUDA events, 3 runs after a warm-up)
with the card's name and power limit. The first variant is the source as
it stands.
"""

import math
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PACKAGE = ROOT / "bonito_tpu_torch"
SWEEP = PACKAGE / "build" / "sweep"
N, T, H = 96, 1666, 1024

# (rows per block for a batch of 96, KC, NSTAGE); None keeps the source's
VARIANTS = [(None, None, None), (48, 512, 3), (48, 768, 2), (48, 1024, 1),
            (48, 256, 2), (48, 256, 3), (48, 128, 3), (48, 64, 6),
            (32, 256, 3), (32, 256, 2), (32, 512, 2)]


def rewrite(cu, py, rows, kc, nstage):
    def const(text, name, value):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        if n != 1:
            raise SystemExit(f"sweep: constant {name} not found once")
        return text
    if kc is not None:  # the constants of the tile that will run
        cu = const(const(cu, f"KC{rows}", kc), f"NSTAGE{rows}", nstage)
    if rows == 32:  # never take the 48-row tile
        if "l.Np % 48 == 0" not in cu or "ROW_BLOCKS = (48, 32)" not in py:
            raise SystemExit("sweep: the row-tile rule has moved")
        cu = cu.replace("l.Np % 48 == 0", "false")
        py = py.replace("ROW_BLOCKS = (48, 32)", "ROW_BLOCKS = (32, 32)")
    return cu, py


def measure():
    """Runs inside a variant's copy of the package (PYTHONPATH)."""
    import torch
    from bonito_tpu_torch.ops import int8, lstm_int8_cuda as L
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(3)
    x_q = torch.randint(-127, 128, (T, N, H), generator=g,
                        dtype=torch.int8).to(dev)
    w_ih_q, ih_scales = int8.quantize_cols(
        (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).numpy())
    w_hh_q, scales = int8.quantize_whh(
        (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).numpy())
    w_ih_q, w_hh_q = (torch.from_numpy(w).to(dev) for w in (w_ih_q, w_hh_q))
    ih_scales = torch.from_numpy(ih_scales).to(dev) * int8.H_STEP
    scales = torch.from_numpy(scales).to(dev)
    b = (0.5 * torch.randn(4 * H, generator=g)).to(dev)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)

    def ms(fn, reps=3):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    d = lambda: L.lstm_int8_fused(x_q, w_ih_q, w_hh_q, ih_scales, scales, b,
                                  out_int8=True)
    e = lambda: L.lstm_int8_recurrence(xw, w_hh_q, scales)
    ref_d = L.lstm_int8_fused_plain(x_q, w_ih_q, w_hh_q, ih_scales, scales,
                                    b, out_int8=True)
    ref_e = L.lstm_int8_recurrence_plain(xw, w_hh_q, scales)
    err_d = (d().int() - ref_d.int()).abs().max().item()
    err_e = (e().float() - ref_e.float()).abs().max().item() * 127
    if err_d > 1 or err_e > 1.5:
        raise SystemExit(f"sweep: D {err_d} / E {err_e} int8 steps from plain")
    print(f"D {ms(d):.4g} ms, E {ms(e):.4g} ms per layer call; max |h - "
          f"plain| D {err_d} / E {err_e:.3g} int8 steps", flush=True)


def main():
    if len(sys.argv) > 1:
        return measure()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}; hac widths N={N}, T={T}, C=H={H}")
    cu = (PACKAGE / "csrc" / "lstm_int8.cu").read_text()
    py = (PACKAGE / "ops" / "lstm_int8_cuda.py").read_text()
    for rows, kc, nstage in VARIANTS:
        name = ("source" if rows is None
                else f"rows{rows}_kc{kc}_stages{nstage}")
        copy = SWEEP / name
        if copy.exists():
            shutil.rmtree(copy)
        shutil.copytree(PACKAGE, copy / "bonito_tpu_torch",
                        ignore=shutil.ignore_patterns("build", "__pycache__"))
        new_cu, new_py = rewrite(cu, py, rows, kc, nstage)
        (copy / "bonito_tpu_torch/csrc/lstm_int8.cu").write_text(new_cu)
        (copy / "bonito_tpu_torch/ops/lstm_int8_cuda.py").write_text(new_py)
        print(f"{name}: ", end="", flush=True)
        subprocess.run([sys.executable, __file__, "measure"], check=True,
                       env={**os.environ, "PYTHONPATH": str(copy)})


if __name__ == "__main__":
    main()
