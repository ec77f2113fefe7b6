#!/usr/bin/env python3
"""
Where a step of kernel A's persistent form goes (the bf16 LSTM recurrence
of the PyTorch/CUDA port, ``bonito_tpu_torch/csrc/lstm.cu``), at hac widths
(N=96, T=1666, H=1024).

    python3 scripts/lstm_step_split.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
copies ``csrc/lstm.cu`` into ``bonito_tpu_torch/build/step_split/``, builds
one library per variant with nvcc for sm_90a (all at once), and times each
through the persistent kernel's C entry (CUDA events, 3 runs after a
warm-up), with the card's name and power limit:

- the source as it stands, at the plan's k-chunks, ring and cluster
  (``ops.lstm_cuda.persistent_plan``: two CTAs share each load of h), the
  same without the sharing, and at narrower chunks, after a check against
  the plain version (``lstm_recurrence_plain``, T=33, both directions);
- the same kernel with one part of each step left out: the wait at the row
  slice's counter, the h loads, the products, the gate math (the gates'
  sum is stored in place of h), and all four (with a cluster, not the
  wait); with a cluster also the two proxy fences that order the bulk
  copies against the generic loads and stores. What a part adds is the
  source's time less the variant's; the variants' outputs are wrong by
  design (or, without the fences, unordered) and only timed.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import build, lstm_cuda  # noqa: E402

OUT = build.BUILD / "step_split"
N, T, H = 96, 1666, 1024

# the text each cut replaces in the persistent kernel, and what with
CUTS = {
    "wait": ("while (ld_acquire(p.flags + slice) < target)",
             "while (!CUT_WAIT && ld_acquire(p.flags + slice) < target)"),
    "load_first": ("if (ch < n_chunks) load_chunk(ch);",
                   "if (!CUT_LOAD && ch < n_chunks) load_chunk(ch);"),
    "load_next": ("if (ch + stages - 1 < n_chunks) "
                  "load_chunk(ch + stages - 1);",
                  "if (!CUT_LOAD && ch + stages - 1 < n_chunks) "
                  "load_chunk(ch + stages - 1);"),
    "load_arm": ("            if (tid == 0)\n                for (int c = 0;",
                 "            if (!CUT_LOAD && tid == 0)\n"
                 "                for (int c = 0;"),
    "load_copy": ("            if (tid < share) {",
                  "            if (!CUT_LOAD && tid < share) {"),
    "load_wait": ("while (!mbar_try_wait(mbar + ch, (unsigned)(step & 1)))",
                  "while (!CUT_LOAD && "
                  "!mbar_try_wait(mbar + ch, (unsigned)(step & 1)))"),
    "fence_global": ('asm volatile("fence.proxy.async.global;\\n"',
                     'if (!CUT_FENCE) asm volatile('
                     '"fence.proxy.async.global;\\n"'),
    "fence_shared": ("        if (shared_h)\n            asm volatile(",
                     "        if (shared_h && !CUT_FENCE)\n"
                     "            asm volatile("),
    "mma": ("for (int kt = ks; kt < kc / 16; kt += PKS) {",
            "for (int kt = ks; !CUT_MMA && kt < kc / 16; kt += PKS) {"),
    "gates": ("            const float ig = sigmoid_f(gt[0]);",
              "            if (CUT_GATES) {\n"
              "                p.out[t * out_t + (size_t)(row0 + r) * H"
              " + u0 + u] = __float2bfloat16(gt[0] + gt[1] + gt[2] + gt[3]);"
              "\n"
              "                continue;\n            }\n"
              "            const float ig = sigmoid_f(gt[0]);"),
}
VARIANTS = {"source": [], "no wait": ["WAIT"], "no h loads": ["LOAD"],
            "no products": ["MMA"], "no gate math": ["GATES"],
            "none of the four": ["WAIT", "LOAD", "MMA", "GATES"],
            "no proxy fences": ["FENCE"]}


def main():
    if not torch.cuda.is_available():
        print("lstm_step_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    text = (build.CSRC / "lstm.cu").read_text()
    for old, new in CUTS.values():
        if text.count(old) != 1:
            raise RuntimeError(f"lstm_step_split: the source no longer has "
                               f"one {old!r}")
        text = text.replace(old, new)
    text = "".join(f"#ifndef CUT_{k}\n#define CUT_{k} 0\n#endif\n"
                   for k in ("WAIT", "LOAD", "MMA", "GATES", "FENCE")) + text
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "lstm_cut.cu"
    src.write_text(text)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-shared",
         *[f"-DCUT_{c}=1" for c in cuts], "-o",
         str(OUT / f"lib_{i}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, cuts) in enumerate(VARIANTS.items())}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for i, name in enumerate(VARIANTS):
        fn = ctypes.CDLL(str(OUT / f"lib_{i}.so")).lstm_recurrence_persistent
        fn.argtypes = [P, P, P, P, P] + [I] * 11 + [P]
        libs[name] = fn

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lstm_cuda.persistent_plan(N, H, sms)

    def run(name, xw, w, t_len, kc, stages, cluster, reverse=0):
        out = torch.empty(t_len, N, H, dtype=torch.bfloat16, device=dev)
        hbuf = torch.zeros(2, plan["slices"] * plan["rows"], H,
                           dtype=torch.bfloat16, device=dev)
        flags = torch.zeros(plan["slices"], dtype=torch.int32, device=dev)
        build.check(libs[name](
            xw.data_ptr(), w.t().contiguous().data_ptr(), out.data_ptr(),
            hbuf.data_ptr(), flags.data_ptr(), t_len, N, 0, N, H,
            plan["rows"] // 16, plan["slices"], kc, stages, cluster, reverse,
            torch.cuda.current_stream().cuda_stream), name)
        return out

    def ms_of(fn, reps=3):
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

    g = torch.Generator().manual_seed(1)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev,
                                                           torch.bfloat16)
    print(f"{card}; N={N}, T={T}, H={H}; plan {plan}", flush=True)
    # the plan's chunks and cluster, the same without sharing h, narrower
    # chunks
    chunks = [(plan["kc"], plan["stages"], plan["cluster"]),
              (plan["kc"], plan["stages"], 1), (256, 2, 1), (128, 4, 1)]
    for kc, stages, cluster in chunks:
        for reverse in (0, 1):
            out = run("source", xw[:33], w, 33, kc, stages, cluster, reverse)
            ref = lstm_cuda.lstm_recurrence_plain(xw[:33], w,
                                                  reverse=bool(reverse))
            diff = (out.float() - ref.float()).abs()
            print(f"  k-chunks of {kc}, {stages} stages, cluster {cluster}, "
                  f"reverse={reverse}: "
                  f"max |h - plain| {diff.max().item():.3g}, mean "
                  f"{diff.mean().item():.3g} (T=33)", flush=True)
    for kc, stages, cluster in chunks:
        base = None
        for name, cuts in VARIANTS.items():
            # without the wait, a CTA of a cluster could copy into a peer
            # that still reads: a race, not a timing; without a cluster
            # there are no proxy fences to leave out
            if cluster > 1 and "WAIT" in cuts or cluster == 1 \
                    and "FENCE" in cuts:
                continue
            ms = ms_of(lambda: run(name, xw, w, T, kc, stages, cluster))
            base = ms if base is None else base
            more = "" if name == "source" else (
                f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
            print(f"  k-chunks of {kc}, {stages} stages, cluster {cluster}, "
                  f"{name}: {ms:.4g} ms "
                  f"a layer = {ms / T * 1e3:.4g} us a step{more}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
