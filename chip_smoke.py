#!/usr/bin/env python3
"""
Smoke run of the PyTorch/CUDA port (bonito_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout, on a machine with a CUDA card, nvcc and
PyTorch built for CUDA. In order, it:

 1. prints the card's name, power limit and count;
 2. builds the port's kernels from ``bonito_tpu_torch/csrc`` with nvcc for
    sm_90a and prints each kernel's registers, shared memory and spills;
 3. holds each kernel against its plain PyTorch version on the card at
    hac widths (N=96, T=1666, C=H=1024, S=1024): A, B, C in bf16, the int8
    LSTM kernels D (both outputs) and E, every one in both directions;
 4. writes two full-width hac model directories with the port's own code
    (random weights from a seed, the CRF weight scaled up so that the
    output mixes stays and moves): one whose config says quantize=false,
    one with the config's own default, quantize=true;
 5. basecalls synthetic reads through ``load_model`` + ``basecall`` on
    the card (batch 96, chunk 9996) on three paths and checks the output
    of each: bf16 (quantize=false; kernels A, B, C; 48 reads), int8 fused
    (the default directory loaded with quantize=None; D, B, C; 144 reads)
    and int8 two-stage (the same with route="two_stage"; E, B, C; 20
    reads); then holds one batch's move scores on the int8 path against
    the same path with D's plain version in the kernel's place;
 6. checks from the launch counts, set to 0 before each path and read
    after it, that each path launched its kernels and no other LSTM kernel;
 7. prints samples/s, the device step and peak memory of the bf16 and
    int8 paths beside the card's name and power;
 8. times each kernel, its plain version and a PyTorch library call where
    one computes the same function, and prints one ``kernels`` JSON line.

The last line is {"ok": true, "device": {...}}. Any failed phase raises, so
the script exits non-zero and prints no result; it does the same when no
CUDA device is available, or when the bonito_tpu_torch package is absent.
It imports nothing of JAX or bonito_tpu.
"""

import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

H100_BF16_OPS = 989e12    # dense bf16 tensor-core FLOP/s (data sheet, SXM)
H100_INT8_OPS = 1979e12   # dense int8 tensor-core OP/s (data sheet, SXM)
H100_F32_OPS = 67e12      # f32 FLOP/s outside the tensor cores
H100_BYTES = 3.35e12      # HBM3 bytes/s
SEED = 1

# hac geometry (dna_r10.4.1_e8.2_400bps_hac@v4.3): batch 96, chunk 10000
# rounded to the stride 6 -> 9996 samples -> T = 1666 frames
N, T, H, STATE_LEN = 96, 1666, 1024, 5
S = 4 ** STATE_LEN
LSTM_ATOL, LSTM_MEAN_TOL = 1.6e-2, 1e-4  # see check_lstm
INT8_MAX_STEPS, INT8_MEAN_STEPS = 1, 0.001  # see check_lstm_int8
# A random hac model's moves carry a large per-column offset, so over a
# 1666-frame chunk its Viterbi path settles either on staying or on one
# periodic cycle of moves. With the weights of seed 1 the CRF weight x 5
# (what tests/golden/hac_shipped_shape.json uses) gives almost only stays;
# x 8 gives a cycle through all four bases (seed 0 x 8 a homopolymer).
CRF_SCALE = 8.0


def log(msg):
    print(msg, flush=True)


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=1):
    import torch
    for _ in range(warmup):
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


def bound(n_bytes, n_ops, peak_ops):
    t_bytes = n_bytes / H100_BYTES * 1e3
    t_ops = n_ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ptxas_summary(report):
    """One line per kernel: demangled-enough name, registers, smem, spills."""
    rows, name, spills = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            base = re.search(r"(lstm_step_bf16|lstm_int8_step|"
                             r"decode_tcn_(?:fwd|bwd))", m.group(1))
            tmpl = "bf16" if "bfloat16" in m.group(1) else "f32"
            name = base.group(1) if base else m.group(1)
            if "decode" in name:
                name = f"{name}<{tmpl}>"
            flags = re.search(r"lstm_int8_stepILi(\d+)ELb(\d)ELb(\d)E",
                              m.group(1))
            if flags:
                name = (f"{name}<rows={flags.group(1)}, fused="
                        f"{flags.group(2)}, out_int8={flags.group(3)}>")
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spills = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            rows.append(f"  {name}: {m.group(1)} registers, {m.group(2) or 0} "
                        f"B static smem, {spills}")
            name = None
    return rows


def check_lstm(torch, lstm_cuda, dev):
    """Kernel A against its plain version, both directions, bf16. Both
    round h to bf16 every step but sum the f32 products in another order,
    so a rounding can flip and the trajectories drift apart by a few bf16
    steps of |h| <= 1 (one bf16 step is 2**-8 on [0.5, 1)); the tolerance
    is four such steps on the max and LSTM_MEAN_TOL on the mean absolute
    difference."""
    g = torch.Generator().manual_seed(SEED)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)
    w_hh = (torch.randn(H, 4 * H, generator=g) / math.sqrt(H)).to(
        dev, torch.bfloat16)
    errs = []
    for reverse in (False, True):
        out = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
        torch.cuda.synchronize()
        ref = lstm_cuda.lstm_recurrence_plain(xw, w_hh, reverse=reverse)
        diff = (out.float() - ref.float()).abs()
        err, mean = diff.max().item(), diff.mean().item()
        log(f"  kernel A reverse={reverse}: max |h - plain| {err:.3g}, "
            f"mean {mean:.3g} (tolerance {LSTM_ATOL} / {LSTM_MEAN_TOL})")
        require(torch.isfinite(out.float()).all().item(), "kernel A: non-finite h")
        require(err <= LSTM_ATOL and mean <= LSTM_MEAN_TOL,
                f"kernel A disagrees with its plain version: max {err}, "
                f"mean {mean}")
        errs.append(err)
    return xw, w_hh, max(errs)


def check_lstm_int8(torch, int8, lstm_int8_cuda, dev):
    """Kernels D and E against their plain versions, both directions, D
    with int8 and with bf16 output. Kernel and plain version do the same
    exact integer sums and the same f32 operations in the same order;
    only expf/tanhf can differ in the last bit and move an h across a
    half step. Differences are counted in int8 steps of 1/127: at most
    INT8_MAX_STEPS, INT8_MEAN_STEPS on the mean (none was seen: every run
    so far gave equal outputs)."""
    g = torch.Generator().manual_seed(SEED + 2)
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
    d_args = (x_q, w_ih_q, w_hh_q, ih_scales, scales, b)
    e_args = (xw, w_hh_q, scales)
    cases = [("D", lstm_int8_cuda.lstm_int8_fused,
              lstm_int8_cuda.lstm_int8_fused_plain, d_args,
              dict(reverse=r, out_int8=o))
             for r in (False, True) for o in (True, False)]
    cases += [("E", lstm_int8_cuda.lstm_int8_recurrence,
               lstm_int8_cuda.lstm_int8_recurrence_plain, e_args,
               dict(reverse=r)) for r in (False, True)]
    errs = {"D": 0.0, "E": 0.0}
    for name, kernel, plain, args, kw in cases:
        out = kernel(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, **kw)
        require(out.dtype == ref.dtype, f"kernel {name}: dtype {out.dtype}")
        unit = 1.0 if out.dtype == torch.int8 else 127.0
        steps = (out.float() - ref.float()).abs() * unit
        worst, mean = steps.max().item(), steps.mean().item()
        spread = out.float().std().item() / (127.0 / unit)
        log(f"  kernel {name} {kw}: max |h - plain| {worst:.3g} int8 steps, "
            f"mean {mean:.3g} (tolerance {INT8_MAX_STEPS} / "
            f"{INT8_MEAN_STEPS}); std of h {spread:.3f}")
        # bf16 output: a bf16 step of h is up to half an int8 step
        limit = INT8_MAX_STEPS + (0 if out.dtype == torch.int8 else 0.5)
        require(spread > 0.05, f"kernel {name}: h does not vary")
        require(worst <= limit and mean <= INT8_MEAN_STEPS,
                f"kernel {name} disagrees with its plain version: max "
                f"{worst}, mean {mean} int8 steps")
        errs[name] = max(errs[name], worst / 127.0)
    return d_args, e_args, errs


def check_decode(torch, decode_cuda, dev):
    """Kernels B and C against their plain versions on the same bf16
    moves: choices, end states, sequence and moves identical (the max
    semiring does the same f32 adds in both), qstring within one step."""
    g = torch.Generator().manual_seed(SEED + 1)
    moves = (3 * torch.randn(N, T, 4 * S, generator=g)).clamp(-5, 5).to(
        dev, torch.bfloat16)
    blank = 2.0
    fwd = decode_cuda.tcn_forward(moves, blank)
    out = decode_cuda.tcn_backward(moves, *fwd, blank, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    ref_fwd = decode_cuda.tcn_forward_plain(moves, blank)
    ref = decode_cuda.tcn_backward_plain(moves, *ref_fwd, blank, qscale=1.05,
                                         qbias=0.2)
    require(torch.equal(fwd[1], ref_fwd[1]), "kernel B: choices differ")
    require(torch.equal(fwd[4], ref_fwd[4]), "kernel B: end states differ")
    err_b = (fwd[0] - ref_fwd[0]).abs().max().item()
    err_lz = (fwd[3] - ref_fwd[3]).abs().max().item()
    log(f"  kernel B: choices and end states identical; max |move_in - "
        f"plain| {err_b:.3g}, max |logZ - plain| {err_lz:.3g}")
    require(err_b <= 1e-4 and err_lz <= 1e-3 * T,
            f"kernel B disagrees with its plain version: {err_b}, {err_lz}")
    for k in ("sequence", "moves"):
        require(torch.equal(out[k], ref[k]), f"kernel C: {k} differs")
    dq = (out["qstring"].int() - ref["qstring"].int()).abs().max().item()
    frac = out["moves"].float().mean().item()
    log(f"  kernel C: sequence and moves identical; max |dq| {dq}; "
        f"{frac:.3f} of frames move")
    require(dq <= 1, f"kernel C: qstring off by {dq}")
    return moves, blank, fwd, err_b, float(dq)


class Read:
    def __init__(self, read_id, signal):
        self.read_id = read_id
        self.signal = signal


def run_path(torch, name, model, reads, counters, basecall, chunk):
    """Basecall ``reads`` through ``basecall`` with every launch count set
    to 0 just before and read just after; check what came back."""
    bc = model.config["basecaller"]
    chunksize, overlap, batchsize = bc["chunksize"], bc["overlap"], bc["batchsize"]
    require((chunksize, batchsize) == (9996, 96), f"unexpected {bc}")
    n_chunks = sum(chunk(r.signal, chunksize, overlap).shape[0] for r in reads)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated() / 2 ** 30
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    results = {r.read_id: res for r, res in basecall(
        model, iter(reads), chunksize=chunksize, overlap=overlap,
        batchsize=batchsize)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    require(results.keys() == {r.read_id for r in reads},
            f"{name}: not every read came back")
    total_bases = 0
    for read in reads:
        res = results[read.read_id]
        seq, qs, mv = res["sequence"], res["qstring"], res["moves"]
        require(len(seq) == int(mv.sum()) == len(qs),
                f"{name} {read.read_id}: sequence/moves/qstring lengths differ")
        require(len(mv) == len(read.signal) // model.stride
                or len(read.signal) >= chunksize,
                f"{name} {read.read_id}: short read frames")
        total_bases += len(seq)
    frac = total_bases / sum(len(r["moves"]) for r in results.values())
    letters = set("".join(r["sequence"] for r in results.values()))
    samples = int(sum(len(r.signal) for r in reads))
    log(f"  {name}: {len(reads)} reads, {n_chunks} chunks, {total_bases} "
        f"bases, {frac:.3f} of frames emit, letters {sorted(letters)}; "
        f"{samples / wall:.6g} samples/s over {wall:.3f} s, peak memory "
        f"{peak:.3f} GiB ({held:.3f} GiB of it held before the path: the "
        f"three models and the checks' tensors); launches {launches}")
    require(0.01 < frac < 1 and letters == set("ACGT"),
            f"{name}: degenerate output")
    return {"launches": launches, "batches": launches["B"], "wall": wall,
            "samples": samples, "peak": peak, "held": held}


def device_step(np, model, reads, make_compute_fn, chunk):
    """One prepared batch and the time of its device step (upload,
    forward, decode, fetch)."""
    bc = model.config["basecaller"]
    compute = make_compute_fn(model, bc["batchsize"], bc["chunksize"])
    prepared = compute.prepare(np.concatenate(
        [chunk(r.signal, bc["chunksize"], bc["overlap"])
         for r in reads[2:20]])[:bc["batchsize"]])
    ms = cuda_ms(lambda: compute.fetch(compute.dispatch(prepared)), reps=3)
    return prepared, ms


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from bonito_tpu_torch import checkpoint
    from bonito_tpu_torch.config import save_config
    from bonito_tpu_torch.crf.basecall import basecall, make_compute_fn
    from bonito_tpu_torch.crf.model import Model
    from bonito_tpu_torch.models import lstm_crf_config
    from bonito_tpu_torch.ops import (build, decode_cuda, int8, lstm_cuda,
                                      lstm_int8_cuda)
    from bonito_tpu_torch.ops import lstm as ops_lstm
    from bonito_tpu_torch.util import chunk, load_model

    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[1] card: {card}; torch.cuda: {kind} x {count}; torch "
        f"{torch.__version__} CUDA {torch.version.cuda}")
    require(count >= 1, "no CUDA device counted")

    t0 = time.perf_counter()
    lib_path = build.build()
    build.library()
    log(f"[2] built {Path(lib_path).name} in {time.perf_counter() - t0:.1f} s")
    for row in ptxas_summary(build.ptxas_report):
        log(row)

    log(f"[3] kernels vs plain at hac widths (N={N}, T={T}, C=H={H}, S={S})")
    xw, w_hh, err_a = check_lstm(torch, lstm_cuda, dev)
    d_args, e_args, err_int8 = check_lstm_int8(torch, int8, lstm_int8_cuda, dev)
    moves, blank, fwd, err_b, err_c = check_decode(torch, decode_cuda, dev)

    log("[4] hac model directories from the port's own code")
    dirs = {}
    for name, quantize in (("bf16", False), ("int8", True)):
        model_dir = build.BUILD / f"chip_smoke_hac_{name}"
        if model_dir.exists():
            shutil.rmtree(model_dir)
        model_dir.mkdir(parents=True)
        cfg = lstm_crf_config(quantize=quantize)
        model = Model(cfg).init(SEED)
        _, (_, crf), _ = model.decode_head()
        with torch.no_grad():
            crf.w.mul_(CRF_SCALE)
        save_config(cfg, model_dir / "config.toml")
        checkpoint.save_params(model_dir / "weights_1.npz", model)
        dirs[name] = model_dir
        del model
    require(lstm_crf_config()["basecaller"]["quantize"] is True,
            "the config's default is no longer quantize=true")

    log("[5] load_model + basecall on the card, three paths")
    rng = np.random.default_rng(SEED)
    lengths = np.concatenate([[3000, 9000], rng.integers(20000, 110000, 142)])
    reads = [Read(f"read{i}", rng.normal(size=int(n)).astype(np.float32))
             for i, n in enumerate(lengths)]
    counters = {"A": lstm_cuda.lstm_recurrence,
                "B": decode_cuda.tcn_forward, "C": decode_cuda.tcn_backward,
                "D": lstm_int8_cuda.lstm_int8_fused,
                "E": lstm_int8_cuda.lstm_int8_recurrence}
    models = {
        "bf16": load_model(dirs["bf16"], half=True, fuse_bn=True,
                           quantize=None, device="cuda"),
        "int8": load_model(dirs["int8"], half=True, fuse_bn=True,
                           quantize=None, device="cuda"),
        "two_stage": load_model(dirs["int8"], half=True, fuse_bn=True,
                                quantize=None, device="cuda",
                                route="two_stage"),
    }
    lstms = [m for m in models["int8"].encoder.modules()
             if hasattr(m, "quantize_params")]
    require(len(lstms) == 5 and all(
        m.quantized and m.int8_out and m.w_hh_q.dtype == torch.int8
        for m in lstms), "the default directory did not load quantised")
    require(not any(m.quantized for m in models["bf16"].encoder.modules()
                    if hasattr(m, "quantize_params")),
            "quantize=false in the config was not honoured")
    n_reads = {"bf16": 48, "int8": 144, "two_stage": 20}
    runs = {name: run_path(torch, name, models[name], reads[:n_reads[name]],
                           counters, basecall, chunk) for name in models}

    # one batch's move scores: kernel D's chain against its plain version's
    prepared, step_int8 = device_step(np, models["int8"], reads,
                                      make_compute_fn, chunk)
    _, step_bf16 = device_step(np, models["bf16"], reads, make_compute_fn,
                               chunk)
    _, x_wire, sig_scale = prepared
    with torch.inference_mode():
        xc = (torch.from_numpy(x_wire).to(dev, torch.bfloat16)
              * torch.from_numpy(sig_scale).to(dev, torch.bfloat16)[:, None])
        mv_kernel, _ = models["int8"].forward_tcn(xc[..., None])
        ops_lstm.lstm_int8_fused = lstm_int8_cuda.lstm_int8_fused_plain
        try:
            mv_plain, _ = models["int8"].forward_tcn(xc[..., None])
        finally:
            ops_lstm.lstm_int8_fused = lstm_int8_cuda.lstm_int8_fused
        diff = (mv_kernel.float() - mv_plain.float()).abs()
        worst, mean = diff.max().item(), diff.mean().item()
    log(f"  int8 path, one batch's moves {tuple(mv_kernel.shape)} through "
        f"kernel D vs its plain version: max |diff| {worst:.3g}, mean "
        f"{mean:.3g} (tolerance 0.5 / 1e-3); all finite: "
        f"{torch.isfinite(mv_kernel.float()).all().item()}")
    require(torch.isfinite(mv_kernel.float()).all().item(),
            "int8 path: non-finite move scores")
    require(worst <= 0.5 and mean <= 1e-3,
            "int8 path: the kernels' moves disagree with the plain versions'")
    del mv_kernel, mv_plain, diff

    log("[6] launches on each path (counts set to 0 before it, read after)")
    own = {"bf16": "A", "int8": "D", "two_stage": "E"}
    for name, run in runs.items():
        per_batch = {k: v / run["batches"] for k, v in run["launches"].items()}
        log(f"  {name}: {run['batches']} batches, per batch {per_batch}")
        for k, n in run["launches"].items():
            if k in ("B", "C") or k == own[name]:
                require(n > 0, f"kernel {k} never launched on the {name} path")
            else:
                require(n == 0, f"kernel {k} launched on the {name} path")
        require(per_batch[own[name]] == 5 and per_batch["C"] == 1,
                f"{name}: expected 5 LSTM and 1 + 1 decode launches per batch")

    log(f"[7] on {card}:")
    for name, step in (("bf16", step_bf16), ("int8", step_int8)):
        run = runs[name]
        log(f"  {name}: {run['samples'] / run['wall']:.6g} samples/s over "
            f"{run['wall']:.3f} s ({run['samples']} samples, "
            f"{run['batches']} batches of 96), peak memory "
            f"{run['peak']:.3f} GiB, {run['peak'] - run['held']:.3f} GiB "
            f"above what was held before the path; device step (upload, forward, decode, "
            f"fetch) {step:.4g} ms per batch = "
            f"{96 * 9996 / step * 1e3:.6g} samples/s")

    log("[8] kernel times at hac shapes (CUDA events)")
    x_lstm = torch.randn(T, N, H, device=dev, dtype=torch.bfloat16)
    w_ih = (torch.randn(H, 4 * H, device=dev) / math.sqrt(H)).to(torch.bfloat16)
    ms_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence(xw, w_hh), reps=3)
    plain_a = cuda_ms(lambda: lstm_cuda.lstm_recurrence_plain(xw, w_hh),
                      reps=1, warmup=0)
    proj = cuda_ms(lambda: torch.matmul(x_lstm, w_ih), reps=5)
    cudnn = torch.nn.LSTM(H, H, device=dev, dtype=torch.bfloat16)
    cudnn.flatten_parameters()
    with torch.no_grad():
        lib_a = cuda_ms(lambda: cudnn(x_lstm), reps=5)
    log(f"  A: projection matmul {proj:.4g} ms + kernel {ms_a:.4g} ms vs "
        f"one cuDNN torch.nn.LSTM layer {lib_a:.4g} ms")
    bytes_a = T * N * 4 * H * 2 + H * 4 * H * 2 + T * N * H * 2
    bound_a = bound(bytes_a, 2 * N * H * 4 * H * T, H100_BF16_OPS)

    ms_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused(
        *d_args, out_int8=True), reps=3)
    plain_d = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_fused_plain(
        *d_args, out_int8=True), reps=1, warmup=0)
    ms_e = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_recurrence(*e_args),
                   reps=3)
    plain_e = cuda_ms(lambda: lstm_int8_cuda.lstm_int8_recurrence_plain(
        *e_args), reps=1, warmup=0)
    # D: int8 x in, both int8 weights, three f32 rows, int8 h out
    bound_d = bound(T * N * H + 2 * H * 4 * H + 3 * 4 * H * 4 + T * N * H,
                    2 * N * T * (H + H) * 4 * H, H100_INT8_OPS)
    # E: bf16 xw in, int8 W_hh, one f32 row, bf16 h out
    bound_e = bound(T * N * 4 * H * 2 + H * 4 * H + 4 * H * 4 + T * N * H * 2,
                    2 * N * T * H * 4 * H, H100_INT8_OPS)
    lstm0 = lstms[0]
    project = cuda_ms(lambda: int8.project_int8(
        x_lstm, lstm0.w_ih_q, lstm0.ih_scales, lstm0.b, torch.bfloat16),
        reps=3)
    quantise = cuda_ms(lambda: int8.quantize_dynamic(x_lstm), reps=3)
    _, (_, crf), _ = models["int8"].decode_head()
    perm = models["int8"]._tcn_perm(dev)
    h_q = d_args[0].transpose(0, 1)
    head_int8 = cuda_ms(lambda: crf.project(h_q, perm, torch.bfloat16), reps=3)
    _, (_, crf_bf16), _ = models["bf16"].decode_head()
    head_bf16 = cuda_ms(lambda: crf_bf16.project(x_lstm.transpose(0, 1), perm),
                        reps=3)
    log(f"  int8 path outside the kernels: layer 0's dynamic quantise "
        f"{quantise:.4g} ms; int8 head in slabs of {crf.SLAB_ROWS} rows "
        f"(torch._int_mm + f32 rescale) {head_int8:.4g} ms vs the bf16 head "
        f"matmul {head_bf16:.4g} ms; two-stage project_int8 (quantise, "
        f"torch._int_mm, rescale) {project:.4g} ms per layer")

    ms_b = cuda_ms(lambda: decode_cuda.tcn_forward(moves, blank), reps=3)
    plain_b = cuda_ms(lambda: decode_cuda.tcn_forward_plain(moves, blank),
                      reps=1, warmup=0)
    ms_c = cuda_ms(lambda: decode_cuda.tcn_backward(moves, *fwd, blank),
                   reps=3)
    plain_c = cuda_ms(lambda: decode_cuda.tcn_backward_plain(
        moves, *fwd, blank), reps=1, warmup=0)
    R = S // 4
    move_bytes = N * T * 4 * S * 2
    # B: moves in; move-in f32, choices, c, logZ and end state out
    bound_b = bound(move_bytes + N * T * S * 5 + N * T * 4 + N * 8,
                    20 * N * T * S, H100_F32_OPS)
    # C: moves in; the emitted base's quarter of move-in, one choice per
    # frame (the traceback's), c, logZ, end state; three [N, T] planes out
    bound_c = bound(move_bytes + N * T * R * 4 + N * T * 5 + N * 8 + 3 * N * T,
                    20 * N * T * S, H100_F32_OPS)

    for name, ms_lstm, step in (("bf16", ms_a, step_bf16),
                                ("int8", ms_d, step_int8)):
        kernels_ms = 5 * ms_lstm + ms_b + ms_c
        log(f"  {name} path per batch: 5 x {own[name]} {5 * ms_lstm:.4g} ms + "
            f"B {ms_b:.4g} ms + C {ms_c:.4g} ms = {kernels_ms:.4g} ms of the "
            f"{step:.4g} ms device step; the rest {step - kernels_ms:.4g} ms")
    src_int8 = "bonito_tpu_torch/csrc/lstm_int8.cu"
    # launches: the count on the path that is the kernel's own (A: bf16,
    # D, B, C: int8 fused, E: int8 two-stage); by_path has every path's
    entries = [
        ("lstm_recurrence", "A", "bf16", "bonito_tpu_torch/csrc/lstm.cu",
         "bonito_tpu/ops/lstm_pallas.py:54", err_a, ms_a, plain_a, bound_a,
         lib_a),
        ("decode_tcn_fwd", "B", "int8", "bonito_tpu_torch/csrc/decode_tcn.cu",
         "bonito_tpu/ops/decode_pallas.py:183", err_b, ms_b, plain_b, bound_b,
         None),
        ("decode_tcn_bwd", "C", "int8", "bonito_tpu_torch/csrc/decode_tcn.cu",
         "bonito_tpu/ops/decode_pallas.py:246", err_c, ms_c, plain_c, bound_c,
         None),
        ("lstm_int8_fused", "D", "int8", src_int8,
         "bonito_tpu/ops/lstm_pallas.py:478", err_int8["D"], ms_d, plain_d,
         bound_d, None),
        ("lstm_int8_recurrence", "E", "two_stage", src_int8,
         "bonito_tpu/ops/lstm_pallas.py:355", err_int8["E"], ms_e, plain_e,
         bound_e, None),
    ]
    kernels = []
    for name, key, path, src, rep, err, ms, plain, (bms, by), lib in entries:
        n = runs[path]["launches"][key]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "by_path": {p: r["launches"][key] for p, r in runs.items()}})
        log(f"  {name}: {ms:.4g} ms (plain {plain:.4g} ms, bound {bms:.4g} ms "
            f"by {by}), {n} launches on the {path} path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
