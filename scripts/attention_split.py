#!/usr/bin/env python3
"""
Where the time of the attention's stretch kernels goes (the PyTorch/CUDA
port), at sup's shapes:

    python3 scripts/attention_split.py        # K and H
    python3 scripts/attention_split.py o      # O
    python3 scripts/attention_split.py f32    # K and H on f32 qkv

from the root of a checkout, on a machine with a CUDA card and nvcc. It
copies a kernel's source and the headers it includes into
``bonito_tpu_torch/build/attention_split/``, builds one library per variant
with nvcc for sm_90a (all at once), prints each variant's registers, stack
frame and spills, and times each through the kernel's C entry (CUDA events,
10 runs after a warm-up), with the card's name and power limit.

K and H (``csrc/attention_window.cu``; H is K's instance with lse), K at
inference (N 128, T 1000, 8 heads of 64, window (127, 128), bf16) and H at
training (N 32, T 1024):

- the source at the plan (``ops.attention_cuda.window_plan``), after a
  check against the plain version and the earlier kernel (one bf16 step of
  the largest output), and at other stretches (the ring, the CTAs and the
  leading windows they stage change with it), with the earlier kernel's
  time beside them;
- the source with one part left out: the copies (the cp.async of q, k
  and v; their wait stays), the rotary (the in-place rotation of q and k
  and its tables' loads), pass 1 (the consumers' scores, max and sum),
  pass 2 (the scores again, p and p . v), and all four. Left without both
  passes the kernel still stores o (zeros) and lse.

K and H in f32 (the same source's f32 instance, ``StageF32``), K at
``evaluate``'s batch (N 256, T 250) and H at training (N 32, T 1024): the
source at the plan and other stretches beside the earlier kernel, then with
the producers' staging left out (the f32 loads, the rotation, the rounding
and the stores: the ring keeps its zeros), pass 1, pass 2, both passes
(the staging alone) and all three; beside them two stagings not kept, from
an edited copy: 4 units a thread a batch (2 in the source), and the next
batch's loads issued before the current batch is stored (both spill).

O (``csrc/attention_window_bwd.cu``) at training (N 32, T 1024): the same
for its plan (``window_bwd_plan``) and stretches, and with one part left
out: the copies (of both kinds' tiles and rings), the rotary (q and k), the
s and dp products (both kinds'; s and dp are then 0), the dq product, the
dk and dv products, and all five; a product left out still feeds its
operand (ds or p) into the sums, so that the work before it stays. Beside
them, the source with the producers' rotary in K's batches of four chunk
pairs (two in the source), to show what that costs in spills.

What a part adds is the source's time less the variant's; the variants'
outputs are wrong by design and only timed.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import attention_cuda, build  # noqa: E402
from bonito_tpu_torch.transformer.model import rotary_freqs  # noqa: E402

OUT = build.BUILD / "attention_split"
HEADERS = ("lstm_persistent.cuh", "attention_window.cuh")
WINDOW = (127, 128)

# each of K's passes walks its key tiles in three loops: the edge tiles,
# the tiles every row sees whole, the edge tiles
LOOPS = [("kt_lo", "kt_in_lo"), ("kt_in_lo", "kt_in_hi"), ("kt_in_hi", "kt_hi")]
# the rotary's batch loop (csrc/attention_window.cuh), shared by K and O
ROTARY = ("            on[k] = false;\n            if (e < items) {",
          "            on[k] = false;\n"
          "            if (!CUT_ROTARY && e < items) {")
# per kernel: its source, C entry, argument types, the text each cut
# replaces (in the source or a header; each once, or every time where
# marked "all") and what with, and the variants (the cuts' flags)
KERNELS = {
    "k": {
        "source": "attention_window.cu",
        "entry": "fused_rotary_window_attention_stretch",
        "argtypes": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
        "cuts": {
            "copy_q": ("cp_async16(d, base", "if (!CUT_COPY) cp_async16(d, base"),
            "copy_kv": ("                cp_async16(dk, src + hd);\n"
                        "                cp_async16(dv, src + 2 * hd);",
                        "                if (!CUT_COPY) {\n"
                        "                    cp_async16(dk, src + hd);\n"
                        "                    cp_async16(dv, src + 2 * hd);\n"
                        "                }"),
            "rotary": ROTARY,
            **{f"pass1_{lo}": (
                f"            for (int kt = {lo}; kt < {hi}; ++kt) {{\n"
                "                float sc[2][4];\n"
                "                scores(krow(kt), sc);",
                f"            for (int kt = {lo}; !CUT_PASS1 && kt < {hi}; "
                "++kt) {\n"
                "                float sc[2][4];\n"
                "                scores(krow(kt), sc);") for lo, hi in LOOPS},
            **{f"pass2_{lo}": (
                f"            for (int kt = {lo}; kt < {hi}; ++kt) {{\n"
                "                float sc[2][4];\n"
                "                const int kr = krow(kt);",
                f"            for (int kt = {lo}; !CUT_PASS2 && kt < {hi}; "
                "++kt) {\n"
                "                float sc[2][4];\n"
                "                const int kr = krow(kt);") for lo, hi in LOOPS},
        },
        "variants": {"source": [], "no copies": ["COPY"],
                     "no rotary": ["ROTARY"], "no pass 1": ["PASS1"],
                     "no pass 2": ["PASS2"],
                     "none of the four": ["COPY", "ROTARY", "PASS1", "PASS2"]},
    },
    "f32": {
        "source": "attention_window.cu",
        "entry": "fused_rotary_window_attention_stretch",
        "argtypes": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11
        + [ctypes.c_void_p],
        "cuts": {
            "stage": ("        const int nb = (total + NT * RB - 1) / (NT * RB);",
                      "        const int nb = CUT_STAGE ? 0 "
                      ": (total + NT * RB - 1) / (NT * RB);"),
            **{f"pass{i}_{lo}": (
                f"            for (int kt = {lo}; kt < {hi}; ++kt) {{\n"
                "                float sc[2][4];\n"
                + ("                scores(krow(kt), sc);" if i == 1 else
                   "                const int kr = krow(kt);"),
                f"            for (int kt = {lo}; !CUT_PASS{i} && kt < {hi}; "
                "++kt) {\n"
                "                float sc[2][4];\n"
                + ("                scores(krow(kt), sc);" if i == 1 else
                   "                const int kr = krow(kt);"))
               for i in (1, 2) for lo, hi in LOOPS},
            # two designs of the staging not kept: 4 units a thread a
            # batch, and the next batch's loads issued before the current
            # one is stored
            "rb4": ("template <int DP, int NT, int RB = 2>\nstruct StageF32 {",
                    "template <int DP, int NT, int RB = CUT_RB4 ? 4 : 2>\n"
                    "struct StageF32 {"),
            "ahead": ("        for (int j = 0; j < nb; ++j) {\n"
                      "            Batch bt;\n",
                      "        if (CUT_AHEAD) {\n"
                      "            Batch x, y;\n"
                      "            if (nb > 0) load(x, i, 0);\n"
                      "            for (int j = 0; j < nb; j += 2) {\n"
                      "                if (j + 1 < nb) load(y, i, j + 1);\n"
                      "                apply(x);\n"
                      "                if (j + 1 < nb) {\n"
                      "                    if (j + 2 < nb) load(x, i, j + 2);\n"
                      "                    apply(y);\n"
                      "                }\n"
                      "            }\n"
                      "            return;\n"
                      "        }\n"
                      "        for (int j = 0; j < nb; ++j) {\n"
                      "            Batch bt;\n"),
        },
        "variants": {"source": [], "no staging": ["STAGE"],
                     "no pass 1": ["PASS1"], "no pass 2": ["PASS2"],
                     "the staging alone": ["PASS1", "PASS2"],
                     "none of the three": ["STAGE", "PASS1", "PASS2"],
                     "staging 4 units a batch": ["RB4"],
                     "staging two batches in flight": ["AHEAD"]},
    },
    "o": {
        "source": "attention_window_bwd.cu",
        "entry": "fused_rotary_window_attention_bwd_stretch",
        "argtypes": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 10
        + [ctypes.c_void_p],
        "cuts": {
            **{f"copy_{x}": (f"cp_async16({d}, src.{x} +",
                             f"if (!CUT_COPY) cp_async16({d}, src.{x} +")
               for x, d in (("ar", "dr"), ("ap", "dp"), ("rr", "dr"),
                            ("rp", "dp"))},
            "rotary": ROTARY,
            "sdp": ("row_products<DP>(", "if (!CUT_SDP) row_products<DP>(",
                    "all"),
            "dq": ("col_products<DP>(acc, da, Rs, cr, arow, acol);  // ds . k",
                   "if (!CUT_DQ) col_products<DP>(acc, da, Rs, cr, arow, "
                   "acol); else acc[0][0] += __uint_as_float(da[0] ^ da[1] "
                   "^ da[2] ^ da[3]);"),
            "dk": ("col_products<DP>(acc, da, Rs, cr, arow, acol); // ds^T . q",
                   "if (!CUT_DKDV) col_products<DP>(acc, da, Rs, cr, arow, "
                   "acol); else acc[0][0] += __uint_as_float(da[0] ^ da[1] "
                   "^ da[2] ^ da[3]);"),
            "dv": ("col_products<DP>(acc, pa, Ps, cr, arow, acol); // p^T . do",
                   "if (!CUT_DKDV) col_products<DP>(acc, pa, Ps, cr, arow, "
                   "acol); else acc[0][0] += __uint_as_float(pa[0] ^ pa[1] "
                   "^ pa[2] ^ pa[3]);"),
            "batch": ("constexpr int RB = 2;",
                      "constexpr int RB = CUT_BATCH ? 4 : 2;"),
        },
        "variants": {"source": [], "no copies": ["COPY"],
                     "no rotary": ["ROTARY"], "no s and dp": ["SDP"],
                     "no dq product": ["DQ"],
                     "no dk and dv products": ["DKDV"],
                     "none of the five": ["COPY", "ROTARY", "SDP", "DQ",
                                          "DKDV"],
                     "rotary in batches of 4": ["BATCH"]},
    },
}


def ms_of(fn, reps=10):
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


def ptxas_lines(report, every):
    """Each kernel instance's registers, stack frame and spills (only the
    head dim of 64, sup's, unless ``every``)."""
    rows, kernel, frame = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '\w*window_attention_(?:bwd_)?"
                      r"kernelI(13__nv_bfloat16|f)?Li(\d+)E(?:Lb(\d)E)?E",
                      line)
        if m:
            kernel = (("f32, " if m.group(1) == "f" else "")
                      + f"head dim up to {m.group(2)}"
                      + (f", lse={m.group(3)}" if m.group(3) else ""))
            if not every and m.group(2) != "64":
                kernel = None
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if kernel and m:
            frame = f"stack {m.group(1)} B, spills {m.group(2)}/{m.group(3)} B"
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            rows.append(f"{kernel}: {m.group(1)} registers, {frame}")
            kernel = None
    return rows


def build_variants(kind):
    """One library per variant of ``kind``'s kernel: its C entry by name."""
    spec = KERNELS[kind]
    out = OUT / kind
    names = (spec["source"], *HEADERS)
    texts = {n: (build.CSRC / n).read_text() for n in names}
    for old, new, *every in spec["cuts"].values():
        count = sum(t.count(old) for t in texts.values())
        if count == 0 or (count != 1 and not every):
            raise RuntimeError(f"attention_split: the sources no longer have "
                               f"one {old!r}")
        texts = {n: t.replace(old, new) for n, t in texts.items()}
    flags = sorted({c for cuts in spec["variants"].values() for c in cuts})
    texts[spec["source"]] = "".join(
        f"#ifndef CUT_{k}\n#define CUT_{k} 0\n#endif\n" for k in flags) \
        + texts[spec["source"]]
    out.mkdir(parents=True, exist_ok=True)
    for n, t in texts.items():
        (out / n).write_text(t)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         *[f"-DCUT_{c}=1" for c in cuts], "-o", str(out / f"lib_{i}.so"),
         str(out / spec["source"])],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, cuts) in enumerate(spec["variants"].items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        for row in ptxas_lines(o + err, name == "source"):
            print(f"  {name}, {row}", flush=True)
        fn = getattr(ctypes.CDLL(str(out / f"lib_{i}.so")), spec["entry"])
        fn.argtypes = spec["argtypes"]
        libs[name] = fn
    return libs


def split(libs, card, dev, what, N, T, with_lse, dtype=torch.bfloat16):
    H, D, r = 8, 64, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = attention_cuda.window_plan(N, T, H, D, WINDOW, dtype, sms)
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(dev, dtype)
    cos, sin = rotary_freqs(T, r, device=dev)
    out = torch.empty(N, T, H, D, dtype=dtype, device=dev)
    lse = torch.empty(N, H, T, device=dev) if with_lse else None

    def run(name, stretch=plan["stretch"]):
        build.check(libs[name](
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, N, T, H, D, r // 2,
            WINDOW[0], WINDOW[1], T, stretch, plan["ring"],
            int(dtype == torch.float32),
            torch.cuda.current_stream().cuda_stream), name)

    print(f"{card}; {what}: N={N}, T={T}, H={H}, D={D}, window {WINDOW}, "
          f"{dtype}; plan {plan}", flush=True)
    run("source")
    torch.cuda.synchronize()
    ref = attention_cuda.fused_rotary_window_attention_plain(
        qkv, cos, sin, WINDOW).float()
    old = attention_cuda.fused_rotary_window_attention_old_kernel(
        qkv, cos, sin, WINDOW, with_lse=with_lse)
    old = (old[0] if with_lse else old)
    print(f"  the source vs the plain version: max |o - plain| "
          f"{(out.float() - ref).abs().max().item():.3g} (the earlier "
          f"kernel's {(old.float() - ref).abs().max().item():.3g}) at max "
          f"|o| {ref.abs().max().item():.3g}", flush=True)
    old_ms = ms_of(lambda: attention_cuda.
                   fused_rotary_window_attention_old_kernel(
                       qkv, cos, sin, WINDOW, with_lse=with_lse))
    print(f"  the earlier kernel: {old_ms:.4g} ms", flush=True)
    for stretch in sorted({1, 2, 4, 8, plan["tiles"], plan["stretch"]}):
        n_str = -(-plan["tiles"] // stretch)
        print(f"  the source at a stretch of {stretch} tiles ({N * H * n_str}"
              f" CTAs): {ms_of(lambda: run('source', stretch)):.4g} ms",
              flush=True)
    base = None
    for name in libs:
        ms = ms_of(lambda: run(name))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(f"  the plan, {name}: {ms:.4g} ms{more}", flush=True)


def split_o(libs, card, dev, N=32, T=1024):
    """O at sup training: checked, at its plan and other stretches, and
    with each part left out."""
    H, D, r = 8, 64, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = attention_cuda.window_bwd_plan(N, T, H, D, WINDOW, torch.bfloat16,
                                          sms)
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(dev, torch.bfloat16)
    do = torch.randn(N, T, H, D, generator=g).to(dev, torch.bfloat16)
    cos, sin = rotary_freqs(T, r, device=dev)
    o, lse = attention_cuda.fused_rotary_window_attention_train(
        qkv, cos, sin, WINDOW)
    rows = torch.empty(N, H, plan["tiles"] * 64, 2, device=dev)
    dqkv = torch.empty_like(qkv)

    def run(name, stretch=plan["stretch"]):
        build.check(libs[name](
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), lse.data_ptr(),
            o.data_ptr(), do.data_ptr(), rows.data_ptr(), dqkv.data_ptr(), N,
            T, H, D, r // 2, WINDOW[0], WINDOW[1], T, stretch, plan["ring"],
            torch.cuda.current_stream().cuda_stream), name)

    def earlier():
        return attention_cuda.fused_rotary_window_attention_bwd_old_kernel(
            qkv, cos, sin, lse, o, do, WINDOW)

    print(f"{card}; O at sup training: N={N}, T={T}, H={H}, D={D}, window "
          f"{WINDOW}; plan {plan}", flush=True)
    run("source")
    torch.cuda.synchronize()
    ref = attention_cuda.fused_rotary_window_attention_bwd_plain(
        qkv, cos, sin, lse, o, do, WINDOW).float()
    old = earlier().float()
    for i, c in enumerate("qkv"):
        want = ref[:, :, i]
        print(f"  the source vs the plain version: max |d{c} - plain| "
              f"{(dqkv[:, :, i].float() - want).abs().max().item():.3g} (the "
              f"earlier kernel's {(old[:, :, i] - want).abs().max().item():.3g}"
              f") at max |d{c}| {want.abs().max().item():.3g}", flush=True)
    print(f"  the earlier kernel: {ms_of(earlier):.4g} ms", flush=True)
    for stretch in sorted({1, 2, 4, 8, plan["tiles"], plan["stretch"]}):
        n_str = -(-plan["tiles"] // stretch)
        print(f"  the source at a stretch of {stretch} tiles "
              f"({2 * N * H * n_str} CTAs): "
              f"{ms_of(lambda: run('source', stretch)):.4g} ms", flush=True)
    base = None
    for name in libs:
        ms = ms_of(lambda: run(name))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(f"  the plan, {name}: {ms:.4g} ms{more}", flush=True)


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "k"
    if mode not in KERNELS:
        print(f"attention_split: the mode is k (K and H), f32 (K and H on "
              f"f32 qkv) or o (O), not {mode!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attention_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants(mode)
    if mode == "k":
        split(libs, card, dev, "K at sup inference", 128, 1000, False)
        split(libs, card, dev, "H at sup training", 32, 1024, True)
    elif mode == "f32":
        split(libs, card, dev, "K in f32 at evaluate's batch", 256, 250,
              False, torch.float32)
        split(libs, card, dev, "H in f32 at sup training", 32, 1024, True,
              torch.float32)
    else:
        split_o(libs, card, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
