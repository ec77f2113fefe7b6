#!/usr/bin/env python3
"""
Where the time of kernel K's stretch kernel goes (the PyTorch/CUDA port,
``bonito_tpu_torch/csrc/attention_window.cu``; H is its instance with
lse), at sup's shapes: K at inference (N 128, T 1000, 8 heads of 64,
window (127, 128), bf16) and H at training (N 32, T 1024).

    python3 scripts/attention_split.py

from the root of a checkout, on a machine with a CUDA card and nvcc. It
copies the kernel's source into ``bonito_tpu_torch/build/attention_split/``,
builds one library per variant with nvcc for sm_90a (all at once), and
times each through the stretch kernel's C entry (CUDA events, 10 runs after
a warm-up), with the card's name and power limit:

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
SOURCE = "attention_window.cu"
HEADER = "lstm_persistent.cuh"
ENTRY = "fused_rotary_window_attention_stretch"
WINDOW = (127, 128)

# each pass walks its key tiles in three loops: the edge tiles, the
# tiles every row sees whole, the edge tiles
LOOPS = [("kt_lo", "kt_in_lo"), ("kt_in_lo", "kt_in_hi"), ("kt_in_hi", "kt_hi")]
# the text each cut replaces in the kernel, and what with
CUTS = {
    "copy_q": ("cp_async16(d, base", "if (!CUT_COPY) cp_async16(d, base"),
    "copy_kv": ("                cp_async16(dk, src + hd);\n"
                "                cp_async16(dv, src + 2 * hd);",
                "                if (!CUT_COPY) {\n"
                "                    cp_async16(dk, src + hd);\n"
                "                    cp_async16(dv, src + 2 * hd);\n"
                "                }"),
    "rotary": ("            on[k] = false;\n            if (e < items) {",
               "            on[k] = false;\n"
               "            if (!CUT_ROTARY && e < items) {"),
    **{f"pass1_{lo}": (f"            for (int kt = {lo}; kt < {hi}; ++kt) {{\n"
                       "                float sc[2][4];\n"
                       "                scores(krow(kt), sc);",
                       f"            for (int kt = {lo}; !CUT_PASS1 && kt < {hi}; "
                       "++kt) {\n"
                       "                float sc[2][4];\n"
                       "                scores(krow(kt), sc);")
       for lo, hi in LOOPS},
    **{f"pass2_{lo}": (f"            for (int kt = {lo}; kt < {hi}; ++kt) {{\n"
                       "                float sc[2][4];\n"
                       "                const int kr = krow(kt);",
                       f"            for (int kt = {lo}; !CUT_PASS2 && kt < {hi}; "
                       "++kt) {\n"
                       "                float sc[2][4];\n"
                       "                const int kr = krow(kt);")
       for lo, hi in LOOPS},
}
VARIANTS = {"source": [], "no copies": ["COPY"], "no rotary": ["ROTARY"],
            "no pass 1": ["PASS1"], "no pass 2": ["PASS2"],
            "none of the four": ["COPY", "ROTARY", "PASS1", "PASS2"]}

P, I = ctypes.c_void_p, ctypes.c_int


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


def build_variants():
    """One library per variant: its C entry by name."""
    flags = sorted({c for names in VARIANTS.values() for c in names})
    text = (build.CSRC / SOURCE).read_text()
    for old, new in CUTS.values():
        if text.count(old) != 1:
            raise RuntimeError(f"attention_split: {SOURCE} no longer has one "
                               f"{old!r}")
        text = text.replace(old, new)
    text = "".join(f"#ifndef CUT_{k}\n#define CUT_{k} 0\n#endif\n"
                   for k in flags) + text
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / HEADER).write_text((build.CSRC / HEADER).read_text())
    (OUT / SOURCE).write_text(text)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         *[f"-DCUT_{c}=1" for c in cuts], "-o", str(OUT / f"lib_{i}.so"),
         str(OUT / SOURCE)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, cuts) in enumerate(VARIANTS.items())}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        if name == "source":  # each instance's registers and spills
            kernel = None
            for line in (out + err).splitlines():
                m = re.search(r"Compiling entry function '\w*window_attention"
                              r"_kernelILi(\d+)ELb(\d)EE", line)
                if m:
                    kernel = f"head dim up to {m.group(1)}, lse={m.group(2)}"
                m = re.search(r"(\d+) bytes spill stores.*?(\d+) bytes spill "
                              r"loads|Used (\d+) registers", line)
                if kernel and m:
                    print(f"  the source's instance ({kernel}): "
                          f"{line.split(':', 1)[-1].strip()}", flush=True)
    libs = {}
    for i, name in enumerate(VARIANTS):
        fn = getattr(ctypes.CDLL(str(OUT / f"lib_{i}.so")), ENTRY)
        fn.argtypes = [P] * 5 + [I] * 10 + [P]
        libs[name] = fn
    return libs


def split(libs, card, dev, what, N, T, with_lse):
    H, D, r = 8, 64, 64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = attention_cuda.window_plan(N, T, H, D, WINDOW, torch.bfloat16, sms)
    g = torch.Generator().manual_seed(1)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(dev, torch.bfloat16)
    cos, sin = rotary_freqs(T, r, device=dev)
    out = torch.empty(N, T, H, D, dtype=torch.bfloat16, device=dev)
    lse = torch.empty(N, H, T, device=dev) if with_lse else None

    def run(name, stretch=plan["stretch"]):
        build.check(libs[name](
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, N, T, H, D, r // 2,
            WINDOW[0], WINDOW[1], T, stretch, plan["ring"],
            torch.cuda.current_stream().cuda_stream), name)

    print(f"{card}; {what}: N={N}, T={T}, H={H}, D={D}, window {WINDOW}; "
          f"plan {plan}", flush=True)
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
    for name in VARIANTS:
        ms = ms_of(lambda: run(name))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(f"  the plan, {name}: {ms:.4g} ms{more}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("attention_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants()
    split(libs, card, dev, "K at sup inference", 128, 1000, False)
    split(libs, card, dev, "H at sup training", 32, 1024, True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
