#!/usr/bin/env python3
"""
Where the time of kernels B and C on the ring goes (the PyTorch/CUDA port),
at hac's and sup's decode shapes:

    python3 scripts/decode_split.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds ``csrc/decode_tcn_ring.cu`` once per variant with nvcc for sm_90a
(all at once, ``-DDECODE_CUT=<parts>`` into
``bonito_tpu_torch/build/decode_split/``), prints each variant's registers,
stack frame and spills, and times each through the kernels' C entries (CUDA
events, 5 runs after a warm-up), with the card's name and power limit.

At hac (N 96, T 1666, S 1024) and sup (N 128, T 2000, S 1024), on random
bf16 moves clamped to +-5:

- the source at the plan (``ops.decode_cuda.decode_plan``), after a check
  against the earlier kernels (every output bit for bit), with the earlier
  kernels' times beside it, and at other ring depths;
- the source with one part left out: the ring's copies and waits (the rows
  are then whatever the slots hold), the exps (expf(m) taken as m), the
  block reduction (the warps' maxes and C's sums across lanes; each warp
  reads its own max), the stores of the outputs (with what feeds only them:
  B's normalised move-in, C's qscore), C's traceback (the end state
  throughout), and all of them.

What a part adds is the source's time less the variant's; the variants'
outputs are wrong by design and only timed.
"""

import ctypes
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import build, decode_cuda  # noqa: E402

OUT = build.BUILD / "decode_split"
SOURCE = "decode_tcn_ring.cu"
# csrc/decode_tcn_ring.cu's CUT_* bits
PARTS = {"waits": 1, "exps": 2, "reduction": 4, "stores": 8, "traceback": 16}
VARIANTS = {"source": [], "no ring waits": ["waits"], "no exps": ["exps"],
            "no block reduction": ["reduction"], "no stores": ["stores"],
            "no traceback (C)": ["traceback"], "none of them": list(PARTS)}
RINGS = (2, 4, 6, 8, 12, 16)
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def ms_of(fn, reps=5):
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


def ptxas_lines(report):
    rows, kernel, frame = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*(decode_tcn_(?:fwd|bwd)"
                      r"_ring_kernel)", line)
        if m:
            kernel = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if kernel and m:
            frame = f"stack {m.group(1)} B, spills {m.group(2)}/{m.group(3)} B"
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            rows.append(f"{kernel}: {m.group(1)} registers, {frame}")
            kernel = None
    return rows


def build_variants():
    """One library per variant: its two C entries."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, parts) in enumerate(VARIANTS.items()):
        cut = sum(PARTS[p] for p in parts)
        procs[name] = (i, subprocess.Popen(
            [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
             f"-DDECODE_CUT={cut}", "-I", str(build.CSRC),
             "-o", str(OUT / f"lib_{i}.so"), str(build.CSRC / SOURCE)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (i, proc) in procs.items():
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        for row in ptxas_lines(o + err):
            print(f"  {name}, {row}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib_{i}.so"))
        lib.decode_tcn_fwd_ring.argtypes = build.SIGNATURES[
            "decode_tcn_fwd_ring"]
        lib.decode_tcn_bwd_ring.argtypes = build.SIGNATURES[
            "decode_tcn_bwd_ring"]
        libs[name] = lib
    return libs


def split(libs, card, dev, what, N, T, S=1024, blank=2.0):
    plan = decode_cuda.decode_plan(N, T, S, torch.cuda.get_device_properties(
        dev).multi_processor_count)
    g = torch.Generator().manual_seed(N + T)
    moves = (3 * torch.randn(N, T, 4 * S, generator=g)).clamp(-5, 5).to(
        dev, torch.bfloat16)
    fwd = decode_cuda.tcn_forward_old_kernel(moves, blank)
    old = decode_cuda.tcn_backward_old_kernel(moves, *fwd, blank,
                                              qscale=1.05, qbias=0.2)
    outs = [torch.empty_like(x) for x in fwd]
    seq = torch.empty(3, N, T, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run_b(name, ring):
        build.check(libs[name].decode_tcn_fwd_ring(
            moves.data_ptr(), *[x.data_ptr() for x in outs], N, T, S, ring,
            math.exp(blank), blank, stream), name)

    def run_c(name, ring):
        build.check(libs[name].decode_tcn_bwd_ring(
            moves.data_ptr(), *[x.data_ptr() for x in fwd],
            seq[0].data_ptr(), seq[1].data_ptr(), seq[2].data_ptr(), N, T, S,
            ring, math.exp(blank), 1.05, 0.2, stream), name)

    print(f"{card}; {what}: N={N}, T={T}, S={S}; plan {plan}", flush=True)
    rb, rc = plan["fwd"]["ring"], plan["bwd"]["ring"]
    run_b("source", rb)
    run_c("source", rc)
    torch.cuda.synchronize()
    same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(outs, fwd)]
    same += [torch.equal(seq[i], old[k])
             for i, k in enumerate(("sequence", "qstring", "moves"))]
    print(f"  the source vs the earlier kernels, bit for bit (move_in, "
          f"choices, c, logZ, end state; sequence, qstring, moves): {same}",
          flush=True)
    if not all(same):
        raise RuntimeError("decode_split: the source disagrees with the "
                           "earlier kernels")
    print(f"  the earlier kernels: B "
          f"{ms_of(lambda: decode_cuda.tcn_forward_old_kernel(moves, blank)):.4g}"
          f" ms, C "
          f"{ms_of(lambda: decode_cuda.tcn_backward_old_kernel(moves, *fwd, blank)):.4g}"
          f" ms", flush=True)
    for ring in RINGS:
        print(f"  the source on a ring of {ring}: B "
              f"{ms_of(lambda: run_b('source', ring)):.4g} ms, C "
              f"{ms_of(lambda: run_c('source', ring)):.4g} ms", flush=True)
    base = None
    for name in libs:
        ms = (ms_of(lambda: run_b(name, rb)), ms_of(lambda: run_c(name, rc)))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base[0] - ms[0]:.4g} and "
            f"{base[1] - ms[1]:.4g} ms")
        print(f"  the plan, {name}: B {ms[0]:.4g} ms, C {ms[1]:.4g} ms{more}",
              flush=True)


def main():
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants()
    split(libs, card, dev, "B and C at hac", 96, 1666)
    split(libs, card, dev, "B and C at sup", 128, 2000)
    return 0


if __name__ == "__main__":
    sys.exit(main())
