#!/usr/bin/env python3
"""
Where a step of the port's persistent LSTM kernels goes (the PyTorch/CUDA
port, ``bonito_tpu_torch/csrc``): kernel A, the bf16 recurrence
(``lstm.cu`` over ``lstm_persistent.cuh``), or kernel D, the int8 layer
(``lstm_int8.cu``), at hac widths (N=96, T=1666, C=H=1024), or kernel S,
the train step's backward through time (``lstm_train.cu``), at hac
training widths (N=128, T=1000, H=1024; N may be given after ``s``), or
kernel F, the fast LSTM layer on its mma kernel (``lstm_fused.cu``), at
fast widths (N=1024, T=1200, C=H=96), or the f32 kernels of A and F
(``lstm_f32.cu``): A at hac (N=96, T=1666, H=1024) or at N and T given
after ``a32`` (``evaluate``'s batch: 256 500), F at fast widths or at N and
T given after ``f32`` (256 500), or the f32 kernels of R and S
(``lstm_f32.cu``, ``train --no-amp``) at hac's H 1024 and the --no-amp
batch (N=16, T=500) or at N, T and H given after ``r32`` or ``s32``.

    python3 scripts/lstm_step_split.py [a | d | s [N] | f | a32 [N T] |
                                        f32 [N T] | r32 [N T H] |
                                        s32 [N T H]]

from the root of a checkout, on a machine with a CUDA card and nvcc (``a``
when no kernel is named). It copies the kernel's sources into
``bonito_tpu_torch/build/step_split/``, builds one library per variant
with nvcc for sm_90a (all at once), and times each through the persistent
kernel's C entry (CUDA events, 3 runs after a warm-up), with the card's
name and power limit.

A:
- the source as it stands, at the plan's k-chunks, ring and cluster
  (``ops.lstm_cuda.persistent_plan``: two CTAs share each load of h), the
  same without the sharing, and at narrower chunks, after a check against
  the plain version (``lstm_recurrence_plain``, T=33, both directions);
- the same kernel with one part of each step left out: the wait at the row
  slice's counter, the h loads, the products, the gate math (the gates'
  sum is stored in place of h), and all four (with a cluster, not the
  wait); with a cluster also the two proxy fences that order the bulk
  copies against the generic loads and stores.

D (int8 out, as the hac chain runs it):
- the source at the plan (``ops.lstm_int8_cuda.persistent_plan``: two CTAs
  share each load of h and x, a ring of one chunk) and without the sharing
  (two chunks of H / 2, each CTA loading its own), after a check against
  the plain version (``lstm_int8_fused_plain``, T=33, both directions);
- the same kernel with one part left out: the wait at the row slice's
  counter (without the sharing only, as for A), the h loads, the h
  product, the x product (x's rows, their wait, the products and the
  partial sums),
  the gate math (the gates' sum is stored in place of h_q), all five
  (with a cluster, not the wait), and with a cluster the proxy fences.

S (on random activations and cell states, which S takes as given):
- for each cluster size, the plan ``ops.lstm_train_cuda.backward_plan``
  would make if the card held clusters of that size only: checked against
  the plain version (``lstm_train_backward_plain``, T=33, both
  directions), then timed at the plan's ring and at rings of 2 and 4
  slots where they fit; the plan that the card's clusters give is one of
  them;
- the source at the plan with one part of each step left out: the wait at
  the row slice's counter, the dgates loads (and their waits), the
  products (each warp still stores its zero partial sums), the exchange
  (the sum of the warps' partials, the stores into the owners' shared
  memory and the cluster's barrier), the elementwise part (dh is stored in
  place of the gates' gradient), and all five.

F (``-DLSTM_CUT=<parts>``, csrc/lstm_fused.cu's CUT_* bits):
- the source at the plan (``ops.lstm_fused_cuda.fused_plan``), checked
  against the earlier kernel (bit for bit, T=1200, both directions, with
  and without a bias) and the plain version (``lstm_fused_plain``, T=33),
  with the earlier kernel's time beside it, and the registers of each
  variant;
- the same kernel with one part of each step left out: the h product
  (its sums zeros), the x product, the gate math (the gates' sum is h),
  the block barrier, the stores of h to the output, and all five;
- the source with tanh.approx.f32 in place of tanhf, timed, and its drift
  from the plain version (T=1200) beside the source's.

A32 (``-DA32_CUT=<parts>``, csrc/lstm_f32.cu's A_CUT_* bits):
- the source at the plan (``ops.lstm_cuda.f32_plan``), checked against
  the plain version (``lstm_recurrence_plain``, T=33, both directions),
  and at the plan's neighbouring chunk widths and ring depths where they
  fit, with the earlier f32 kernel's time (R's f32 step kernel) beside
  them;
- the source with one part of each step left out: the producer's wait at
  the counter, the copies of h (and their waits), the product, the gate
  math (the gates' sum is stored in place of h), and all four.

F32 (``-DF32_CUT=<parts>``, csrc/lstm_f32.cu's F_CUT_* bits):
- the source at the plan (``ops.lstm_fused_cuda.f32_plan``), checked
  against the plain version (``lstm_fused_plain``, T=33, both directions),
  with the earlier f32 kernel's time beside it, at the plan's rows a block
  and at the other row counts that fit, and the registers of each variant;
- the same kernel with one part of each step left out: the h product, the
  x product (a block's pass), the gate math (the gates' sum is h), the
  step's barrier, the stores of h to the output, and all five.

R32 (``-DA32_CUT=<parts>``: R runs A's f32 kernel with its stores):
- R's kernel at its plan (``ops.lstm_cuda.f32_plan``), its h checked
  against A's f32 kernel at that plan (bit for bit) and the plain version
  (``lstm_train_forward_plain``, T=33, both directions), timed beside A's
  kernel (what R's stores of c and the activations add) and R's step
  kernel;
- the same with one part of each step left out, as A32's.

S32 (``-DS32_CUT=<parts>``, csrc/lstm_f32.cu's S_CUT_* bits), on R's
output at random xw (c and the activations stored in bf16, as the path
stores them at these widths):
- the source at the plan (``ops.lstm_train_cuda.f32_backward_plan``),
  checked against the plain version (``lstm_train_backward_plain``, T=33,
  both directions), and at the plan's neighbouring chunk widths, ring
  depths and k-slice counts where they fit, with S's step kernel's time
  beside them;
- the source with one part of each step left out: the producer's wait at
  the counter, the copies of dgates (and their waits), the product (its
  partials zeros), the gradient's math (dh is stored in place of the
  gates' gradient), and all four.

What a part adds is the source's time less the variant's; the variants'
outputs are wrong by design (or, without the fences or F's barrier,
unordered) and only timed.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import (  # noqa: E402
    build, int8, lstm_cuda, lstm_fused_cuda, lstm_int8_cuda, lstm_train_cuda)

OUT = build.BUILD / "step_split"
HEADER = "lstm_persistent.cuh"

# A: the text each cut replaces in the persistent kernel, and what with
CUTS_A = {
    "wait": ("if (tid == 0) wait_count(p.flags + slice, (unsigned)step",
             "if (!CUT_WAIT && tid == 0) wait_count(p.flags + slice, "
             "(unsigned)step"),
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
    "load_wait": ("                mbar_wait(mbar + ch, (unsigned)(step & 1));",
                  "                if (!CUT_LOAD) "
                  "mbar_wait(mbar + ch, (unsigned)(step & 1));"),
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
VARIANTS_A = {"source": [], "no wait": ["WAIT"], "no h loads": ["LOAD"],
              "no products": ["MMA"], "no gate math": ["GATES"],
              "none of the four": ["WAIT", "LOAD", "MMA", "GATES"],
              "no proxy fences": ["FENCE"]}

# D: the same for its persistent kernel in lstm_int8.cu
CUTS_D = {
    "wait": ("if (tid == 0) wait_count(p.flags + slice, (unsigned)step",
             "if (!CUT_WAIT && tid == 0) wait_count(p.flags + slice, "
             "(unsigned)step"),
    "load_first": ("if (ch < n_chunks) load_chunk(ch);",
                   "if (!CUT_LOAD && ch < n_chunks) load_chunk(ch);"),
    "load_next": ("if (ch + stages - 1 < n_chunks) "
                  "load_chunk(ch + stages - 1);",
                  "if (!CUT_LOAD && ch + stages - 1 < n_chunks) "
                  "load_chunk(ch + stages - 1);"),
    "load_arm": ("            if (tid == 0)\n"
                 "                for (int ch = 0; ch < n_chunks; ++ch)",
                 "            if (!CUT_LOAD && tid == 0)\n"
                 "                for (int ch = 0; ch < n_chunks; ++ch)"),
    "load_copy": ("            if (lane == 0) {\n                // h_in",
                  "            if (!CUT_LOAD && lane == 0) {\n"
                  "                // h_in"),
    "load_wait": ("                mbar_wait(mbar + ch, (unsigned)(step & 1));",
                  "                if (!CUT_LOAD) "
                  "mbar_wait(mbar + ch, (unsigned)(step & 1));"),
    "fence_global": ('asm volatile("fence.proxy.async.global;\\n"',
                     'if (!CUT_FENCE) asm volatile('
                     '"fence.proxy.async.global;\\n"'),
    "fence_shared": ("        if (shared_h)\n"
                     "            asm volatile(\"fence.proxy",
                     "        if (shared_h && !CUT_FENCE)\n"
                     "            asm volatile(\"fence.proxy"),
    "mma": ("for (int kt = ks; kt < kc / IKS; kt += PKS) {",
            "for (int kt = ks; !CUT_MMA && kt < kc / IKS; kt += PKS) {"),
    "x": ("if constexpr (FUSED) x_product(",
          "if constexpr (FUSED && !CUT_X) x_product("),
    "x_first": ("if constexpr (FUSED) load_x(p.reverse ? p.T - 1 : 0);",
                "if constexpr (FUSED && !CUT_X) "
                "load_x(p.reverse ? p.T - 1 : 0);"),
    "x_wait": ("if (shared_h)   // and the peer's warps with theirs",
               "if (shared_h && !CUT_X)"),
    "x_next": ("if (step + 1 < p.T) load_x(p.reverse ? t - 1 : t + 1);",
               "if (!CUT_X && step + 1 < p.T) "
               "load_x(p.reverse ? t - 1 : t + 1);"),
    "gates": ("            const float ig = sigmoid_f(gt[0]);",
              "            if (CUT_GATES) {\n"
              "                h_out[(size_t)(row0 + er[i]) * H + u0 + uu] = "
              "(signed char)__float2int_rz(gt[0] + gt[1] + gt[2] + gt[3]);\n"
              "                continue;\n            }\n"
              "            const float ig = sigmoid_f(gt[0]);"),
}
VARIANTS_D = {"source": [], "no wait": ["WAIT"], "no h loads": ["LOAD"],
              "no h product": ["MMA"], "no x product": ["X"],
              "no gate math": ["GATES"],
              "none of the five": ["WAIT", "LOAD", "MMA", "X", "GATES"],
              "no proxy fences": ["FENCE"]}

# S: the same for its kernel in lstm_train.cu
CUTS_S = {
    "wait": ("if (tid == 0) wait_count(p.flags + slice,",
             "if (!CUT_WAIT && tid == 0) wait_count(p.flags + slice,"),
    "load_first": ("for (int ch = 0; ch < stages; ++ch) load(ch);",
                   "for (int ch = 0; !CUT_LOAD && ch < stages; ++ch) "
                   "load(ch);"),
    "load_next": ("if (warp == 0 && ch + stages < NCH) {",
                  "if (!CUT_LOAD && warp == 0 && ch + stages < NCH) {"),
    "load_wait": ("                mbar_wait(full + s, parity);",
                  "                if (!CUT_LOAD) mbar_wait(full + s, parity);"),
    "mma": ("                    if (kt >= KT) break;\n"
            "                    uint32_t b[4];",
            "                    if (CUT_MMA || kt >= KT) break;\n"
            "                    uint32_t b[4];"),
    "exchange_in": ("            // their sum, four units at a time,",
                    "#if !CUT_EXCHANGE\n"
                    "            // their sum, four units at a time,"),
    "exchange_out": ("            cluster_sync();\n        }\n",
                     "            cluster_sync();\n#endif\n        }\n"),
    "elementwise": ("            const float ig = __low2float(xa[i][0]);",
                    "            if (CUT_ELEM) {\n"
                    "                p.dgates[t * pl_g + (size_t)(row0 + r) * G"
                    " + u0 + u] = __float2bfloat16(dh);\n"
                    "                continue;\n            }\n"
                    "            const float ig = __low2float(xa[i][0]);"),
}
VARIANTS_S = {"source": [], "no wait": ["WAIT"], "no dgates loads": ["LOAD"],
              "no products": ["MMA"], "no exchange": ["EXCHANGE"],
              "no elementwise part": ["ELEM"],
              "none of the five": ["WAIT", "LOAD", "MMA", "EXCHANGE",
                                   "ELEM"]}

P, I = ctypes.c_void_p, ctypes.c_int
MODES = {
    # source compiled, file cut, cuts, variants, C entry, its argtypes
    "a": ("lstm.cu", HEADER, CUTS_A, VARIANTS_A,
          "lstm_recurrence_persistent", [P] * 5 + [I] * 11 + [P]),
    "d": ("lstm_int8.cu", "lstm_int8.cu", CUTS_D, VARIANTS_D,
          "lstm_int8_fused_persistent",
          [P] * 7 + [I] + [P] * 2 + [I] * 12 + [P]),
    "s": ("lstm_train.cu", "lstm_train.cu", CUTS_S, VARIANTS_S,
          "lstm_train_bwd_persistent", [P] * 6 + [I] * 10 + [P]),
}


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


def build_variants(mode):
    """One library per variant of the mode's kernel: its entry by name."""
    source, cut_file, cuts, variants, entry, argtypes = MODES[mode]
    flags = sorted({c for names in variants.values() for c in names})
    text = (build.CSRC / cut_file).read_text()
    for old, new in cuts.values():
        if text.count(old) != 1:
            raise RuntimeError(f"lstm_step_split: {cut_file} no longer has "
                               f"one {old!r}")
        text = text.replace(old, new)
    text = "".join(f"#ifndef CUT_{k}\n#define CUT_{k} 0\n#endif\n"
                   for k in flags) + text
    OUT.mkdir(parents=True, exist_ok=True)
    for name in {source, HEADER}:
        (OUT / name).write_text((build.CSRC / name).read_text())
    (OUT / cut_file).write_text(text)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-shared",
         *[f"-DCUT_{c}=1" for c in cuts_on], "-o",
         str(OUT / f"lib_{mode}_{i}.so"), str(OUT / source)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, cuts_on) in enumerate(variants.items())}
    for name, proc in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
    libs = {}
    for i, name in enumerate(variants):
        fn = getattr(ctypes.CDLL(str(OUT / f"lib_{mode}_{i}.so")), entry)
        fn.argtypes = argtypes
        libs[name] = fn
    return libs


# F: csrc/lstm_fused.cu's LSTM_CUT bits
PARTS_F = {"h": 1, "x": 2, "gates": 4, "barrier": 8, "stores": 16,
           "tanh_approx": 32}
VARIANTS_F = {"source": [], "no h product": ["h"], "no x product": ["x"],
              "no gate math": ["gates"], "no barrier": ["barrier"],
              "no out stores": ["stores"],
              "none of the five": ["h", "x", "gates", "barrier", "stores"],
              "tanh.approx.f32": ["tanh_approx"]}


def build_f():
    """One library of csrc/lstm_fused.cu per F variant, -DLSTM_CUT=<bits>:
    its two entries (the mma kernel and the earlier kernel)."""
    out = OUT / "f"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         f"-DLSTM_CUT={sum(PARTS_F[p] for p in parts)}", "-I",
         str(build.CSRC), "-o", str(out / f"lib_f_{i}.so"),
         str(build.CSRC / "lstm_fused.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, parts) in enumerate(VARIANTS_F.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        kernel, frame = None, ""
        for line in (o + err).splitlines():
            m = re.search(r"Compiling entry function '\w*lstm_fused_mma"
                          r"_kernelILi6ELi6EE", line)
            kernel = kernel or bool(m)
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if kernel and m:
                frame = f", stack {m.group(1)} B, spills {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if kernel and m:
                print(f"  {name}, the mma kernel at C=H=96: {m.group(1)} "
                      f"registers{frame}", flush=True)
                kernel = False
        lib = ctypes.CDLL(str(out / f"lib_f_{i}.so"))
        for entry in ("lstm_fused_mma", "lstm_fused_bf16"):
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def split_f(card, dev):
    N, T, H = 1024, 1200, 96
    libs = build_f()
    plan = lstm_fused_cuda.fused_plan(
        N, H, H, torch.cuda.get_device_properties(dev).multi_processor_count)
    g = torch.Generator().manual_seed(4)
    x = torch.tanh(torch.randn(T, N, H, generator=g)).to(dev, torch.bfloat16)
    w_ih, w_hh = ((torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(
        dev, torch.bfloat16) for _ in range(2))
    b = (0.5 * torch.randn(4 * H, generator=g)).to(dev)
    zero = torch.zeros(4 * H, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, xs, bias, reverse=0, old=False):
        out = torch.empty(xs.shape[0], N, H, dtype=torch.bfloat16,
                          device=dev)
        entry = "lstm_fused_bf16" if old else "lstm_fused_mma"
        build.check(getattr(libs[name], entry)(
            xs.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
            out.data_ptr(), xs.shape[0], N, H, H, reverse, stream), name)
        return out

    print(f"{card}; kernel F, N={N}, T={T}, C=H={H}; plan {plan}",
          flush=True)
    x33 = x[:33].contiguous()
    for reverse in (0, 1):
        for bias in (b, zero):
            same = torch.equal(run("source", x, bias, reverse),
                               run("source", x, bias, reverse, old=True))
            ref = lstm_fused_cuda.lstm_fused_plain(x33, w_ih, w_hh, bias,
                                                   reverse=bool(reverse))
            diff = (run("source", x33, bias, reverse).float()
                    - ref.float()).abs()
            print(f"  reverse={reverse}, bias={bias is b}: equal to the "
                  f"earlier kernel bit for bit {same}; max |h - plain| "
                  f"{diff.max().item():.3g}, mean {diff.mean().item():.3g} "
                  f"(T=33)", flush=True)
            if not same:
                raise RuntimeError("lstm_step_split: F's mma kernel differs "
                                   "from its earlier kernel")
    ref = lstm_fused_cuda.lstm_fused_plain(x, w_ih, w_hh, b)
    for name in ("source", "tanh.approx.f32"):
        diff = (run(name, x, b).float() - ref.float()).abs()
        print(f"  {name}: max |h - plain| {diff.max().item():.3g}, mean "
              f"{diff.mean().item():.3g} (T=1200)", flush=True)
    ms = ms_of(lambda: run("source", x, b, old=True))
    print(f"  the earlier kernel: {ms:.4g} ms a layer = "
          f"{ms / T * 1e3:.4g} us a step", flush=True)

    base = None
    for name in VARIANTS_F:
        ms = ms_of(lambda: run(name, x, b))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


# A32 and F32: csrc/lstm_f32.cu's A_CUT_* and F_CUT_* bits
PARTS_A32 = {"wait": 1, "load": 2, "products": 4, "gates": 8}
VARIANTS_A32 = {"source": [], "no wait": ["wait"], "no h loads": ["load"],
                "no products": ["products"], "no gate math": ["gates"],
                "none of the four": ["wait", "load", "products", "gates"]}
PARTS_S32 = {"wait": 1, "load": 2, "products": 4, "elementwise": 8}
VARIANTS_S32 = {"source": [], "no wait": ["wait"],
                "no dgates loads": ["load"], "no products": ["products"],
                "no gradient math": ["elementwise"],
                "none of the four": ["wait", "load", "products",
                                     "elementwise"]}
PARTS_F32 = {"h": 1, "x": 2, "gates": 4, "barrier": 8, "stores": 16}
VARIANTS_F32 = {"source": [], "no h product": ["h"], "no x product": ["x"],
                "no gate math": ["gates"], "no barrier": ["barrier"],
                "no out stores": ["stores"],
                "none of the five": ["h", "x", "gates", "barrier", "stores"]}


def build_f32(macro, parts, variants, kernel_re):
    """One library of csrc/lstm_f32.cu per variant, -D<macro>=<bits>, with
    the registers and spills ptxas reports for the kernels matching
    ``kernel_re``."""
    out = OUT / macro.lower()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         f"-D{macro}={sum(parts[p] for p in cut)}", "-I", str(build.CSRC),
         "-o", str(out / f"lib_{i}.so"), str(build.CSRC / "lstm_f32.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, cut) in enumerate(variants.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        kernel, frame = None, ""
        for line in (o + err).splitlines():
            m = re.search(r"Compiling entry function '(\w*(" + kernel_re
                          + r")\w*)'", line)
            kernel = m.group(1) if m else kernel
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores", line)
            if kernel and m:
                frame = f", stack {m.group(1)} B, spills {m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if kernel and m and name == "source":
                print(f"  {kernel[-40:]}: {m.group(1)} registers{frame}",
                      flush=True)
            if m:
                kernel = None
        lib = ctypes.CDLL(str(out / f"lib_{i}.so"))
        for entry in ("lstm_recurrence_f32_persistent", "lstm_fused_f32_rows",
                      "lstm_train_fwd_f32_persistent",
                      "lstm_train_bwd_f32_persistent"):
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def split_a32(card, dev, N=96, T=1666):
    H = 1024
    libs = build_f32("A32_CUT", PARTS_A32, VARIANTS_A32, "lstm_a32_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(1)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)

    def run(name, plan, xs, reverse=0):
        t_len = xs.shape[0]
        out = torch.empty(t_len, N, H, device=dev)
        hbuf = torch.empty(2, H, plan["rows"] + lstm_cuda.F32_PAD,
                           device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for n0 in range(0, N, plan["n_launch"]):
            hbuf.zero_()
            flag.zero_()
            build.check(libs[name].lstm_recurrence_f32_persistent(
                xs.data_ptr(), w.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
                flag.data_ptr(), t_len, N, n0, min(plan["n_launch"], N - n0),
                H, plan["rows"], plan["k_slices"], plan["kc"],
                plan["stages"], reverse,
                torch.cuda.current_stream().cuda_stream), name)
        return out

    plan = lstm_cuda.f32_plan(N, H, sms)
    print(f"{card}; kernel A in f32, N={N}, T={T}, H={H}; plan {plan}",
          flush=True)
    x33 = xw[:33].contiguous()
    for reverse in (0, 1):
        ref = lstm_cuda.lstm_recurrence_plain(x33, w, reverse=bool(reverse))
        diff = (run("source", plan, x33, reverse) - ref).abs()
        print(f"  reverse={reverse}: max |h - plain| "
              f"{diff.max().item():.3g}, mean {diff.mean().item():.3g} "
              f"(T=33)", flush=True)
    ms = ms_of(lambda: lstm_cuda.lstm_recurrence_old_kernel(xw, w))
    print(f"  the earlier f32 kernel: {ms:.4g} ms a layer = "
          f"{ms / T * 1e3:.4g} us a step", flush=True)
    # the plan's neighbours: chunks half and twice as wide, rings one slot
    # deeper and shallower, where the C entry takes them
    for kc, stages in sorted({(plan["kc"] // 2, plan["stages"]),
                              (plan["kc"] * 2, plan["stages"]),
                              (plan["kc"], plan["stages"] + 1),
                              (plan["kc"], plan["stages"] - 1),
                              (plan["kc"] // 2, plan["stages"] * 2)}):
        other = {**plan, "kc": kc, "stages": stages}
        if (kc % (8 * plan["k_slices"]) or H % kc or not 2 <= stages <= 8
                or lstm_cuda.f32_smem_bytes(H, plan["rows"],
                                            plan["k_slices"], kc, stages)
                > lstm_cuda.SMEM_LIMIT):
            continue
        ms = ms_of(lambda: run("source", other, xw))
        print(f"  chunks of {kc} k, {stages} slots: {ms:.4g} ms a "
              f"layer = {ms / T * 1e3:.4g} us a step", flush=True)
    base = None
    for name in VARIANTS_A32:
        ms = ms_of(lambda: run(name, plan, xw))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  at the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def split_r32(card, dev, N=16, T=500, H=1024):
    libs = build_f32("A32_CUT", PARTS_A32, VARIANTS_A32, "lstm_a32_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(1)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    plan = lstm_cuda.f32_plan(N, H, sms)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, xs, reverse=0, train=True):
        t_len = xs.shape[0]
        h = torch.empty(t_len, N, H, device=dev)
        c = torch.empty(t_len, N, H, dtype=torch.bfloat16, device=dev)
        acts = torch.empty(t_len, N, 4 * H, dtype=torch.bfloat16, device=dev)
        hbuf = torch.empty(2, H, plan["rows"] + lstm_cuda.F32_PAD,
                           device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for n0 in range(0, N, plan["n_launch"]):
            hbuf.zero_()
            flag.zero_()
            args = (t_len, N, n0, min(plan["n_launch"], N - n0), H,
                    plan["rows"], plan["k_slices"], plan["kc"],
                    plan["stages"])
            if train:
                rc = libs[name].lstm_train_fwd_f32_persistent(
                    xs.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(),
                    acts.data_ptr(), hbuf.data_ptr(), flag.data_ptr(), *args,
                    1, reverse, stream)
            else:
                rc = libs[name].lstm_recurrence_f32_persistent(
                    xs.data_ptr(), w.data_ptr(), h.data_ptr(),
                    hbuf.data_ptr(), flag.data_ptr(), *args, reverse, stream)
            build.check(rc, name)
        return h, c, acts

    print(f"{card}; kernel R in f32, N={N}, T={T}, H={H}; plan {plan}",
          flush=True)
    x33 = xw[:33].contiguous()
    for reverse in (0, 1):
        h, c, acts = run("source", x33, reverse)
        a, _, _ = run("source", x33, reverse, train=False)
        ref = lstm_train_cuda.lstm_train_forward_plain(x33, w, bool(reverse))
        diffs = [(v.float() - r.float()).abs().max().item()
                 for v, r in zip((h, c, acts), ref)]
        print(f"  reverse={reverse}: h equal to A's bit for bit "
              f"{torch.equal(h, a)}; max |h - plain| {diffs[0]:.3g}, c "
              f"{diffs[1]:.3g}, acts {diffs[2]:.3g} (bf16; T=33)",
              flush=True)
        if not torch.equal(h, a):
            raise RuntimeError("lstm_step_split: R's h differs from A's")
    ms = ms_of(lambda: lstm_train_cuda.lstm_train_forward_step(xw, w))
    print(f"  R's step kernel: {ms:.4g} ms a layer = {ms / T * 1e3:.4g} us "
          f"a step", flush=True)
    ms = ms_of(lambda: run("source", xw, train=False))
    print(f"  A's f32 kernel at the plan (no stores): {ms:.4g} ms a layer = "
          f"{ms / T * 1e3:.4g} us a step", flush=True)
    base = None
    for name in VARIANTS_A32:
        ms = ms_of(lambda: run(name, xw))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  R at the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def split_s32(card, dev, N=16, T=500, H=1024):
    libs = build_f32("S32_CUT", PARTS_S32, VARIANTS_S32, "lstm_s32_kernel")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(1)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
    g_h = torch.randn(T, N, H, generator=g).to(dev)
    _, c, acts = lstm_train_cuda.lstm_train_forward(xw, w)
    plan = lstm_train_cuda.f32_backward_plan(N, H, sms)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, pl, t_len=T, reverse=0):
        a, cs, gh = (v[:t_len].contiguous() for v in (acts, c, g_h))
        dg = torch.empty(t_len, N, 4 * H, dtype=torch.bfloat16, device=dev)
        gbuf = torch.empty(2, 4 * H, pl["ldr"], device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for n0 in range(0, N, pl["n_launch"]):
            gbuf.zero_()
            flag.zero_()
            build.check(libs[name].lstm_train_bwd_f32_persistent(
                w.data_ptr(), a.data_ptr(), cs.data_ptr(), gh.data_ptr(),
                dg.data_ptr(), gbuf.data_ptr(), flag.data_ptr(), t_len, N,
                n0, min(pl["n_launch"], N - n0), H, pl["rows"],
                pl["k_slices"], pl["kc"], pl["stages"], 1, reverse, stream),
                name)
        return dg

    print(f"{card}; kernel S in f32, N={N}, T={T}, H={H}; plan {plan}",
          flush=True)
    for reverse in (0, 1):
        out = run("source", plan, 33, reverse)
        ref = lstm_train_cuda.lstm_train_backward_plain(
            w, acts[:33], c[:33], g_h[:33], bool(reverse))
        big = ref.float().abs().max().item()
        diff = (out.float() - ref.float()).abs().max().item()
        print(f"  reverse={reverse}: max |dgates - plain| {diff:.3g}, "
              f"{diff / big:.3g} of the largest (T=33)", flush=True)
    ms = ms_of(lambda: lstm_train_cuda.lstm_train_backward_step(w, acts, c,
                                                                g_h))
    print(f"  S's step kernel: {ms:.4g} ms a layer = {ms / T * 1e3:.4g} us "
          f"a step", flush=True)
    # the plan's neighbours: chunks half and twice as wide, rings one slot
    # deeper and shallower, half and twice the k-slices, where the C entry
    # takes them
    G, ks0 = 4 * H, plan["k_slices"]
    others = {(plan["kc"] // 2, plan["stages"], ks0),
              (plan["kc"] * 2, plan["stages"], ks0),
              (plan["kc"], plan["stages"] + 1, ks0),
              (plan["kc"], plan["stages"] - 1, ks0),
              (plan["kc"], plan["stages"], ks0 // 2),
              (plan["kc"], plan["stages"], ks0 * 2)}
    for kc, stages, ks in sorted(others):
        other = {**plan, "kc": kc, "stages": stages, "k_slices": ks}
        if (not 1 <= ks <= 8 or plan["row_tiles"] * ks > 16 or kc % (8 * ks)
                or G % kc or not 2 <= stages <= 8
                or lstm_train_cuda.f32_backward_smem(
                    H, plan["rows"], ks, kc, stages)
                > lstm_train_cuda.SMEM_LIMIT):
            continue
        ms = ms_of(lambda: run("source", other))
        print(f"  chunks of {kc} k, {stages} slots, {ks} k-slices: "
              f"{ms:.4g} ms a layer = {ms / T * 1e3:.4g} us a step",
              flush=True)
    base = None
    for name in VARIANTS_S32:
        ms = ms_of(lambda: run(name, plan))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  at the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def split_f32(card, dev, N=1024, T=1200):
    H = 96
    libs = build_f32("F32_CUT", PARTS_F32, VARIANTS_F32,
                     "lstm_f32_rows_kernelILi6E")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator().manual_seed(4)
    x = torch.tanh(torch.randn(T, N, H, generator=g)).to(dev)
    w_ih, w_hh = ((torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev)
                  for _ in range(2))
    b = (0.5 * torch.randn(4 * H, generator=g)).to(dev)

    def run(name, plan, xs, reverse=0):
        out = torch.empty(xs.shape[0], N, H, device=dev)
        build.check(libs[name].lstm_fused_f32_rows(
            xs.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), b.data_ptr(),
            out.data_ptr(), xs.shape[0], N, H, H, reverse, plan["rows"],
            plan["block"], int(plan["whh_in_registers"]),
            int(plan["wih_in_smem"]), plan["smem"],
            torch.cuda.current_stream().cuda_stream), name)
        return out

    plan = lstm_fused_cuda.f32_plan(N, H, H, sms)
    print(f"{card}; kernel F in f32, N={N}, T={T}, C=H={H}; plan {plan}",
          flush=True)
    x33 = x[:33].contiguous()
    for reverse in (0, 1):
        ref = lstm_fused_cuda.lstm_fused_plain(x33, w_ih, w_hh, b,
                                               reverse=bool(reverse))
        diff = (run("source", plan, x33, reverse) - ref).abs()
        print(f"  reverse={reverse}: max |h - plain| {diff.max().item():.3g},"
              f" mean {diff.mean().item():.3g} (T=33)", flush=True)
    ms = ms_of(lambda: lstm_fused_cuda.lstm_fused_old_kernel(x, w_ih, w_hh,
                                                             b))
    print(f"  the earlier f32 kernel: {ms:.4g} ms a layer = "
          f"{ms / T * 1e3:.4g} us a step", flush=True)
    # the other row counts a block, each at the largest block that fits
    for rows in lstm_fused_cuda.F32_ROWS:
        step = max(1, lstm_fused_cuda.F32_PASS // rows)
        fits = [blk for blk in range(step, lstm_fused_cuda.F32_MAX_BLOCK + 1,
                                     step)
                if lstm_fused_cuda.f32_smem_bytes(H, H, rows, blk, True)
                <= lstm_fused_cuda.SMEM_LIMIT]
        if rows == plan["rows"] or not fits:
            continue
        other = {**plan, "rows": rows, "block": fits[-1],
                 "smem": lstm_fused_cuda.f32_smem_bytes(H, H, rows, fits[-1],
                                                        True)}
        ms = ms_of(lambda: run("source", other, x))
        print(f"  {rows} rows a block ({-(-N // rows)} blocks), the x "
              f"product {fits[-1]} steps a pass: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step", flush=True)
    base = None
    for name in VARIANTS_F32:
        ms = ms_of(lambda: run(name, plan, x))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def split_a(card, dev):
    N, T, H = 96, 1666, 1024
    libs = build_variants("a")
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

    g = torch.Generator().manual_seed(1)
    xw = torch.randn(T, N, 4 * H, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev,
                                                           torch.bfloat16)
    print(f"{card}; kernel A, N={N}, T={T}, H={H}; plan {plan}", flush=True)
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
        for name, cuts in VARIANTS_A.items():
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


def split_d(card, dev):
    N, T, H = 96, 1666, 1024
    libs = build_variants("d")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lstm_int8_cuda.persistent_plan(N, H, H, sms)
    g = torch.Generator().manual_seed(1)
    x_q = torch.randint(-127, 128, (T, N, H), generator=g,
                        dtype=torch.int8).to(dev)
    w_ih_q, ih_scales = int8.quantize_cols(
        (torch.randn(H, 4 * H, generator=g) / H ** 0.5).numpy())
    w_hh_q, scales = int8.quantize_whh(
        (torch.randn(H, 4 * H, generator=g) / H ** 0.5).numpy())
    w_ih_q, w_hh_q = (torch.from_numpy(w).to(dev) for w in (w_ih_q, w_hh_q))
    ihsc = torch.from_numpy(ih_scales).to(dev) * int8.H_STEP
    sc = torch.from_numpy(scales).to(dev)
    b = (0.5 * torch.randn(4 * H, generator=g)).to(dev)
    wihT, whhT = w_ih_q.t().contiguous(), w_hh_q.t().contiguous()

    # the plan's ring, and without the sharing a ring of two half-width
    # chunks that each CTA loads itself
    rings = {plan["cluster"]: (plan["kc"], plan["stages"]), 1: (H // 2, 2)}

    def run(name, x, cluster, reverse=0):
        t_len = x.shape[0]
        kc, stages = rings[cluster]
        out = torch.empty(t_len, N, H, dtype=torch.int8, device=dev)
        hbuf = torch.zeros(2, plan["slices"] * plan["rows"], H,
                           dtype=torch.int8, device=dev)
        flags = torch.zeros(plan["slices"], dtype=torch.int32, device=dev)
        build.check(libs[name](
            x.data_ptr(), wihT.data_ptr(), whhT.data_ptr(), ihsc.data_ptr(),
            sc.data_ptr(), b.data_ptr(), out.data_ptr(), 1, hbuf.data_ptr(),
            flags.data_ptr(), t_len, N, 0, N, H, H, plan["rows"] // 16,
            plan["slices"], kc, stages, cluster, reverse,
            torch.cuda.current_stream().cuda_stream), name)
        return out

    print(f"{card}; kernel D, N={N}, T={T}, C=H={H}; plan {plan}",
          flush=True)
    x33 = x_q[:33].contiguous()
    for cluster in sorted({plan["cluster"], 1}, reverse=True):
        for reverse in (0, 1):
            out = run("source", x33, cluster, reverse)
            ref = lstm_int8_cuda.lstm_int8_fused_plain(
                x33, w_ih_q, w_hh_q, ihsc, sc, b, reverse=bool(reverse),
                out_int8=True)
            diff = (out.float() - ref.float()).abs()
            print(f"  cluster {cluster}, reverse={reverse}: max |h_q - plain| "
                  f"{diff.max().item():.3g} int8 steps, mean "
                  f"{diff.mean().item():.3g} (T=33)", flush=True)
    for cluster in sorted({plan["cluster"], 1}, reverse=True):
        base = None
        for name, cuts in VARIANTS_D.items():
            # as for A: without the wait, a CTA of a cluster could copy into
            # a peer that still reads
            if cluster > 1 and "WAIT" in cuts or cluster == 1 \
                    and "FENCE" in cuts:
                continue
            ms = ms_of(lambda: run(name, x_q, cluster))
            base = ms if base is None else base
            more = "" if name == "source" else (
                f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
            print(f"  cluster {cluster}, {name}: {ms:.4g} ms a layer = "
                  f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def split_s(card, dev, N=128):
    T, H = 1000, 1024
    libs = build_variants("s")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    count = ctypes.CDLL(str(OUT / "lib_s_0.so")).lstm_train_bwd_clusters
    count.argtypes = [I, build.IP]
    resident = {}
    for cl in lstm_train_cuda.CLUSTERS:
        n = ctypes.c_int(0)
        build.check(count(cl, ctypes.byref(n)), "lstm_train_bwd_clusters")
        resident[cl] = n.value * cl
    plan = lstm_train_cuda.backward_plan(N, H, sms, resident)
    # each cluster size's own plan: backward_plan as if the card held no
    # other size
    plans = {cl: lstm_train_cuda.backward_plan(N, H, sms, {cl: resident[cl]})
             for cl in lstm_train_cuda.CLUSTERS}

    g = torch.Generator().manual_seed(1)
    acts = torch.sigmoid(torch.randn(T, N, 4 * H, generator=g)).to(
        dev, torch.bfloat16)
    c = torch.randn(T, N, H, generator=g).to(dev, torch.bfloat16)
    g_h = torch.randn(T, N, H, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(dev,
                                                           torch.bfloat16)

    def run(name, pl, t_len, stages=None, reverse=0):
        # as the wrapper: a launch per row group
        a, cc, gg = (x[:t_len].contiguous() for x in (acts, c, g_h))
        out = torch.empty(t_len, N, 4 * H, dtype=torch.bfloat16, device=dev)
        flags = torch.empty(pl["slices"], dtype=torch.int32, device=dev)
        for n0 in range(0, N, pl["n_launch"]):
            flags.zero_()
            build.check(libs[name](
                w.data_ptr(), a.data_ptr(), cc.data_ptr(), gg.data_ptr(),
                out.data_ptr(), flags.data_ptr(), t_len, N, n0,
                min(pl["n_launch"], N - n0), H, pl["rows"] // 16,
                pl["slices"], pl["cluster"], stages or pl["stages"], reverse,
                torch.cuda.current_stream().cuda_stream), name)
        return out

    print(f"{card}; kernel S, N={N}, T={T}, H={H}; CTAs resident in "
          f"clusters of each size: {resident}; plan {plan}", flush=True)
    for cl, pl in plans.items():
        if pl is None:
            print(f"  clusters of {cl}: no plan", flush=True)
            continue
        for reverse in (0, 1):
            out = run("source", pl, 33, reverse=reverse)
            ref = lstm_train_cuda.lstm_train_backward_plain(
                w, acts[:33], c[:33], g_h[:33], bool(reverse))
            diff = (out.float() - ref.float()).abs()
            big = ref.float().abs().max().item()
            print(f"  clusters of {cl}, reverse={reverse}: max |dgates - "
                  f"plain| {diff.max().item() / big:.3g} of the largest, "
                  f"mean {diff.mean().item() / big:.3g} (T=33)", flush=True)
        # the plan's ring, and rings of 2 and 4 slots where they fit
        rows, n_chunks = pl["rows"], pl["rows"] // pl["chunk_rows"]
        for stages in sorted({pl["stages"], 2, 4}):
            if n_chunks % stages or lstm_train_cuda.backward_smem(
                    H, rows, cl, stages) > lstm_train_cuda.SMEM_LIMIT:
                continue
            ms = ms_of(lambda: run("source", pl, T, stages))
            print(f"  clusters of {cl}: {pl['slices']} slices of {rows} "
                  f"rows, {pl['ctas']} CTAs, {pl['launches']} launch(es), "
                  f"{pl['k_cols']} gate columns a CTA "
                  f"({rows * pl['k_cols'] * 2 // 1024} KB of dgates a "
                  f"step), a ring of {stages} slots of {pl['chunk_rows']} "
                  f"rows: {ms:.4g} ms a layer = {ms / T * 1e3:.4g} us a "
                  f"step", flush=True)
    base = None
    for name in VARIANTS_S:
        ms = ms_of(lambda: run(name, plan, T))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {(base - ms) / T * 1e3:.3g} us")
        print(f"  the plan, {name}: {ms:.4g} ms a layer = "
              f"{ms / T * 1e3:.4g} us a step{more}", flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "a"
    kinds = (*MODES, "f", "a32", "f32", "r32", "s32")
    if mode not in kinds:
        print(f"lstm_step_split: a kernel of {sorted(kinds)}, not "
              f"{mode!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("lstm_step_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    if mode == "a":
        split_a(card, dev)
    elif mode == "d":
        split_d(card, dev)
    elif mode == "f":
        split_f(card, dev)
    elif mode in ("a32", "f32"):
        shape = [int(n) for n in sys.argv[2:4]]
        (split_a32 if mode == "a32" else split_f32)(card, dev, *shape)
    elif mode in ("r32", "s32"):
        shape = [int(n) for n in sys.argv[2:5]]
        (split_r32 if mode == "r32" else split_s32)(card, dev, *shape)
    else:
        split_s(card, dev, *(int(n) for n in sys.argv[2:3]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
