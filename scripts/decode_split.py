#!/usr/bin/env python3
"""
Where the time of the decode's ring kernels goes (the PyTorch/CUDA port):
B and C (the TCN decode) and M and Q (the full-score decode, on the reverse
strand read in place, as the reverse paths run them), at hac's, sup's and
fast's decode shapes:

    python3 scripts/decode_split.py [bc | mq | j | g | gw]

from the root of a checkout, on a machine with a CUDA card and nvcc (B, C
and M, Q without an argument). It builds ``csrc/decode_tcn_ring.cu`` (B, C)
and ``csrc/decode_full.cu`` (M, Q; both include the ring of
``csrc/decode_ring.cuh``) once per variant with nvcc for sm_90a (all at
once, ``-DDECODE_CUT=<parts>`` into ``bonito_tpu_torch/build/decode_split/``),
prints each ring kernel's registers, stack frame and spills, and times each
through the kernels' C entries (CUDA events, 5 runs after a warm-up), with
the card's name and power limit.

B and C at hac (N 96, T 1666, S 1024) and sup (N 128, T 2000, S 1024) on
random bf16 moves clamped to +-5; M and Q there and at fast (N 1024, T 1200,
S 64) on random bf16 full scores clamped to +-5, reverse strand:

- the source at the plan (``ops.decode_cuda.decode_plan``,
  ``ops.decode_full_cuda.decode_full_plan``), after a check against the
  earlier kernels (every output bit for bit), with the earlier kernels'
  times beside it, and at other ring depths;
- the source with one part left out: the ring's copies and waits (the rows
  are then whatever the slots hold), the exps (expf(m) taken as m), the
  block reduction (the warps' maxes and the mass sums across lanes; each
  warp reads its own max), the stores of the outputs (with what feeds only
  them: the normalised move-in, the qscore), the backward pass's traceback
  (the end state throughout), and all of them.

J, the fused-head decode's backward pass on its ring (``j``: builds
``csrc/decode_tcn_fused.cu`` once per variant, ``-DJ_CUT=<parts>``), on
the fast head (N 1024, 1200 frames, H 96, S 64, clamped to +-5) and a
head of two phases (N 24, 50 x 2 frames, H 32, tanh x 5 and a bias), after
G's forward pass on the same head:

- the source at the plan (``ops.decode_fused_cuda.fused_decode_plan``),
  after a check against the earlier J (sequence, qstring, moves bit for
  bit), with the earlier kernel's and G's times beside it; at rings of 2,
  4 and 8 chunks where they fit;
- a copy at one state a thread (``J_ONE_STATE``: two consumer warps a row,
  meeting at the row's named barrier, their maxes through shared memory;
  26 warps), checked against the earlier J as the source is, at the
  plan's ring;
- the source with one part left out: the head warps (products, exps and
  the tile's stores), the ring's copies and the waits for them, the
  epilogue warp's qscores and stores, and all three.

G, the fused-head decode's forward pass on its ring (``g``: builds
``csrc/decode_tcn_fused.cu`` once per variant, ``-DG_CUT=<parts>``), on
the same two heads:

- the source at the plan (``fused_decode_plan``'s "fwd"), after a check
  against the earlier G (move-in, choices, c, logZ, end state bit for
  bit), with the earlier kernel's and J's times beside it; at rings of 2,
  4 and 8 chunks;
- the source with one part left out: the head warps (products, scores,
  exps and the tile's stores), the ring's copies and the waits for them,
  the consumers' stores of move-in, choices and c, and all three.

GW and JW, the fused-head decode at 1024 states (``gw``): GW's head product
(``csrc/head_product.cu``, built once per variant, ``-DHP_CUT=<parts>`` or
another tile or ring, ``-DHP_BM``, ``-DHP_BN``, ``-DHP_BK``,
``-DHP_STAGES``) on
random heads of hac's width (N 96, Th 1666, H 1024, U 1, clamped to +-5)
and sup's (N 128, Th 1000, H 512, U 2, tanh x 5 and a bias):

- each variant's registers, stack frame and spills; the source and each
  tile checked against the library's product (which equals
  ``head_moves_plain``'s bits, checked here too), bit for bit;
- the product at the plan with one part left out: the epilogue (bias,
  tanh, scale, clamp), the output's stores, the conversion of the staged
  bf16 to the f32 tiles, the copies into the ring and their waits (all, or
  those of h or of wT alone), and the first four (the FFMA loop and its
  shared loads alone); at other tiles and ring depths;
- beside them, in the same run: GW and JW (the product and the two passes
  on the f32 ring), the passes alone, the earlier GW and JW, and
  ``torch.matmul`` in f32 (TF32 off) on the same operands.
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
from bonito_tpu_torch.crf.model import HeadSplit  # noqa: E402
from bonito_tpu_torch.ops import (  # noqa: E402
    build, decode_cuda, decode_full_cuda, decode_fused_cuda)

OUT = build.BUILD / "decode_split"
SOURCES = {"bc": "decode_tcn_ring.cu", "mq": "decode_full.cu"}
ENTRIES = {"bc": ("decode_tcn_fwd_ring", "decode_tcn_bwd_ring"),
           "mq": ("decode_full_fwd_ring", "decode_full_bwd_ring")}
# csrc/decode_ring.cuh's CUT_* bits
PARTS = {"waits": 1, "exps": 2, "reduction": 4, "stores": 8, "traceback": 16}
VARIANTS = {"source": [], "no ring waits": ["waits"], "no exps": ["exps"],
            "no block reduction": ["reduction"], "no stores": ["stores"],
            "no traceback (C, Q)": ["traceback"], "none of them": list(PARTS)}
RINGS = (2, 4, 8, 16)
SMEM = 232448  # the most shared memory a block may ask for
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
        m = re.search(r"Compiling entry function '\w*(decode_(?:fwd|bwd)"
                      r"_ring_kernel\w*?)'", line)
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


def build_variants(pairs):
    """One library per variant and source: its two C entries."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {}
    for i, (name, parts) in enumerate(VARIANTS.items()):
        cut = sum(PARTS[p] for p in parts)
        for pair in pairs:
            lib = OUT / f"lib_{pair}_{i}.so"
            procs[pair, name] = (lib, subprocess.Popen(
                [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
                 f"-DDECODE_CUT={cut}", "-I", str(build.CSRC),
                 "-o", str(lib), str(build.CSRC / SOURCES[pair])],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for (pair, name), (path, proc) in procs.items():
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {pair}, {name}:\n{err}")
        for row in ptxas_lines(o + err):
            print(f"  {name}, {row}", flush=True)
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES[pair]:
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs.setdefault(pair, {})[name] = lib
    return libs


def time_parts(run_fwd, run_bwd, names, plan, what, fits):
    """The plan's ring at other depths (``fits(ring, backward)``: within
    the card's shared memory), then each variant at the plan."""
    rf, rb = plan["fwd"]["ring"], plan["bwd"]["ring"]
    for ring in RINGS:
        ms = [f"{ms_of(lambda: run('source', ring)):.4g} ms"
              if fits(ring, backward) else "does not fit"
              for run, backward in ((run_fwd, False), (run_bwd, True))]
        print(f"  the source on a ring of {ring}: {what[0]} {ms[0]}, "
              f"{what[1]} {ms[1]}", flush=True)
    base = None
    for name in names:
        ms = (ms_of(lambda: run_fwd(name, rf)),
              ms_of(lambda: run_bwd(name, rb)))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base[0] - ms[0]:.4g} and "
            f"{base[1] - ms[1]:.4g} ms")
        print(f"  the plan, {name}: {what[0]} {ms[0]:.4g} ms, {what[1]} "
              f"{ms[1]:.4g} ms{more}", flush=True)


def same_bits(fwd, out, old_fwd, old):
    """move_in, choices, c, logZ, end state; sequence, qstring, moves: each
    equal bit for bit, or not."""
    torch.cuda.synchronize()
    same = [torch.equal(a.view(torch.uint8), b.view(torch.uint8))
            for a, b in zip(fwd, old_fwd)]
    return same + [torch.equal(out[i], old[k])
                   for i, k in enumerate(("sequence", "qstring", "moves"))]


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
    run_b("source", plan["fwd"]["ring"])
    run_c("source", plan["bwd"]["ring"])
    same = same_bits(outs, seq, fwd, old)
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
    time_parts(run_b, run_c, libs, plan, "BC", lambda ring, backward:
               decode_cuda.ring_smem(S, ring, backward) <= SMEM)


def split_full(libs, card, dev, what, N, T, S):
    """M and Q on the reverse strand read in place, as split does B and
    C."""
    f = decode_full_cuda
    plan = f.decode_full_plan(N, T, S, torch.bfloat16,
                              torch.cuda.get_device_properties(dev)
                              .multi_processor_count)
    g = torch.Generator().manual_seed(N + T + S)
    scores = (3 * torch.randn(N, T, 5 * S, generator=g)).clamp(-5, 5).to(
        dev, torch.bfloat16)
    fwd = f.full_forward_old_kernel(scores, reverse=True)
    old = f.full_backward_old_kernel(scores, *fwd, qscale=1.05, qbias=0.2,
                                     reverse=True)
    outs = [torch.empty_like(x) for x in fwd]
    seq = torch.empty(3, N, T, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run_m(name, ring):
        build.check(libs[name].decode_full_fwd_ring(
            scores.data_ptr(), 0, 1, *[x.data_ptr() for x in outs], N, T, S,
            ring, stream), name)

    def run_q(name, ring):
        build.check(libs[name].decode_full_bwd_ring(
            scores.data_ptr(), 0, 1, *[x.data_ptr() for x in fwd],
            seq[0].data_ptr(), seq[1].data_ptr(), seq[2].data_ptr(), N, T, S,
            ring, 1.05, 0.2, stream), name)

    print(f"{card}; {what}: N={N}, T={T}, S={S}, bf16, the reverse strand "
          f"read in place; plan {plan}", flush=True)
    run_m("source", plan["fwd"]["ring"])
    run_q("source", plan["bwd"]["ring"])
    same = same_bits(outs, seq, fwd, old)
    print(f"  the source vs the earlier kernels, bit for bit (move_in, "
          f"choices, c, logZ, end state; sequence, qstring, moves): {same}",
          flush=True)
    if not all(same):
        raise RuntimeError("decode_split: M and Q disagree with the earlier "
                           "kernels")
    ms_m = ms_of(lambda: f.full_forward_old_kernel(scores, reverse=True))
    ms_q = ms_of(lambda: f.full_backward_old_kernel(scores, *fwd,
                                                    reverse=True))
    print(f"  the earlier kernels: M {ms_m:.4g} ms, Q {ms_q:.4g} ms",
          flush=True)
    time_parts(run_m, run_q, libs, plan, "MQ", lambda ring, backward:
               decode_cuda.ring_smem(S, ring, backward, 10 * S) <= SMEM)


# J: csrc/decode_tcn_fused.cu's J_CUT bits
PARTS_J = {"head": 1, "waits": 2, "epilogue": 4}
VARIANTS_J = {"source": [], "no head warps": ["head"],
              "no ring waits": ["waits"], "no epilogue warp": ["epilogue"],
              "none of the three": list(PARTS_J)}
J_HEADS = {"the fast head": (1024, 1200, 96, 1, False, 3.0),
           "a head of two phases": (24, 50, 32, 2, True, 0.5)}


# J at one state a thread, two consumer warps a row (measured slower and
# not kept): edits of csrc/decode_tcn_fused.cu
J_ONE_STATE = [
    ("constexpr int JCW = JRB;   // consumer warps: one a row",
     "constexpr int JCW = 2 * JRB;  // consumer warps: two a row"),
    ("constexpr int JSPT = JS / 32;", "constexpr int JSPT = JS / 64;"),
    # the record holds both warps' maxes
    ("return S / 32 + 2; }", "return S / 32 + 3; }"),
    # the warps' maxes of two parities, [2][JRB][2], in front of the records
    ("off_rec(off_beta + round_up(2 * JRB * S * 4, 128)),",
     "off_rec(off_beta + round_up(2 * JRB * S * 4, 128) + 128),"),
    ("    float* rec = reinterpret_cast<float*>(jsm + L.off_rec);\n",
     "    float* rec = reinterpret_cast<float*>(jsm + L.off_rec);\n"
     "    float* part = rec - 2 * JRB * 2;\n"),
    ("const unsigned consumers = 32u * live;",
     "const unsigned consumers = 64u * live;"),
    ("beta[JRB * S + e] = 1.f;\n",
     "beta[JRB * S + e] = 1.f;\n    if (tid < 2 * JRB) part[2 * JRB + tid] = 1.f;\n"),
    ("const float mx = r[NRUN];", "const float mx = fmaxf(r[NRUN], r[NRUN + 1]);"),
    ("    const int row = w;\n", "    const int row = w / 2, wr = w % 2;\n"),
    ("            // traceback, the same in every thread of the row\n",
     "            {\n"
     "                const float* pp = part + ((par ^ 1) * JRB + row) * 2;\n"
     "                inv = 1.f / fmaxf(pp[0], pp[1]);\n"
     "            }\n"
     "            // traceback, the same in every thread of the row\n"),
    ("const int ps = 32 * i + lane, rs = ps % R;",
     "const int ps = 32 * (wr * JSPT + i) + lane, rs = ps % R;"),
    ("Bn[32 * i + lane] = braw[i];", "Bn[32 * (wr * JSPT + i) + lane] = braw[i];"),
    ("r[i] = run[i];\n                r[NRUN] = wmax;",
     "r[wr * JSPT + i] = run[i];\n"
     "                part[(par * JRB + row) * 2 + wr] = wmax;\n"
     "                r[NRUN + wr] = wmax;"),
    ("            inv = 1.f / wmax;\n", ""),
    ("            par ^= 1;\n            __syncwarp();\n",
     "            par ^= 1;\n"
     "            asm volatile(\"bar.sync %0, 64;\\n\" :: \"r\"(1 + row) : \"memory\");\n"),
]


def one_state_source():
    """``csrc/decode_tcn_fused.cu`` with ``J_ONE_STATE``, written beside the
    split's libraries."""
    cu = (build.CSRC / "decode_tcn_fused.cu").read_text()
    for old, new in J_ONE_STATE:
        if cu.count(old) != 1:
            raise SystemExit(f"decode_split: the one-state copy's anchor "
                             f"{old[:60]!r} is not in "
                             f"csrc/decode_tcn_fused.cu once")
        cu = cu.replace(old, new)
    path = OUT / "decode_tcn_fused_one_state.cu"
    path.write_text(cu)
    return path


def build_fused(key):
    """One library of csrc/decode_tcn_fused.cu per variant of J (``key``
    "j", with its one-state copy) or G ("g"): the ring entry."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    parts_of, variants, letter, pass_ = (
        (PARTS_J, VARIANTS_J, "J", "bwd") if key == "j"
        else (PARTS_G, VARIANTS_G, "G", "fwd"))
    sources = {name: (build.CSRC / "decode_tcn_fused.cu",
                      sum(parts_of[p] for p in parts))
               for name, parts in variants.items()}
    if key == "j":
        sources["one state a thread"] = (one_state_source(), 0)
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         f"-D{letter}_CUT={cut}", "-I", str(build.CSRC),
         "-o", str(OUT / f"lib_{key}_{i}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, (src, cut)) in enumerate(sources.items())}
    libs = {}
    entry = f"decode_fused_{pass_}_ring_bf16"
    for i, (name, proc) in enumerate(procs.items()):
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {letter}, {name}:\n{err}")
        kernel, frame = None, ""
        for line in (o + err).splitlines():
            m = re.search(rf"Compiling entry function '\w*decode_fused_{pass_}"
                          r"_ringILi(\d+)ELi(\d+)EE", line)
            if m:
                kernel = (f"{letter}<H {16 * int(m.group(1))}, {m.group(2)} "
                          f"m-tiles a head warp>")
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if kernel and m:
                frame = (f"stack {m.group(1)} B, spills {m.group(2)}/"
                         f"{m.group(3)} B")
            m = re.search(r"Used (\d+) registers", line)
            if kernel and m:
                print(f"  {name}, {kernel}: {m.group(1)} registers, {frame}",
                      flush=True)
                kernel = None
        lib = ctypes.CDLL(str(OUT / f"lib_{key}_{i}.so"))
        getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def fused_head(dev, N, Th, H, U, tanh, gain, S=64):
    """The random head split_j and split_g decode, from a seed of its
    shape."""
    g = torch.Generator().manual_seed(N + Th)
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(dev, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / math.sqrt(H)).to(
        dev, torch.bfloat16)
    bias = (0.3 * torch.randn(U, 4 * S, generator=g)).to(dev) if tanh \
        else None
    return HeadSplit(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                     None if tanh else -5.0, None if tanh else 5.0, 2.0)


def split_j(libs, card, dev, what, N, Th, H, U, tanh, gain, S=64):
    f = decode_fused_cuda
    head = fused_head(dev, N, Th, H, U, tanh, gain, S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = f.fused_decode_plan(N, Th * U, S, H, U, sms)["bwd"]
    fwd = f.tcn_fused_forward(head)
    old = f.tcn_fused_backward_old_kernel(head, *fwd, qscale=1.05, qbias=0.2)
    hh, w, b = f._operands(head)
    out = torch.empty(3, N, Th * U, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, ring):
        f._launched(libs[name].decode_fused_bwd_ring_bf16(
            hh.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(x.data_ptr() for x in fwd), out[0].data_ptr(),
            out[1].data_ptr(), out[2].data_ptr(), Th, N, H, S, U, ring,
            math.exp(2.0), 1.05, 0.2, *f._head_ops(head), stream), name, S, H,
            U)

    print(f"{card}; J on {what}: N={N}, T={Th * U}, H={H}, S={S}, U={U}; "
          f"plan {plan}", flush=True)
    for name in ("source", "one state a thread"):
        run(name, plan["ring"])
        torch.cuda.synchronize()
        same = [torch.equal(out[i], old[k])
                for i, k in enumerate(("sequence", "qstring", "moves"))]
        print(f"  {name} vs the earlier J, bit for bit (sequence, qstring, "
              f"moves): {same}", flush=True)
        if not all(same):
            raise RuntimeError(f"decode_split: J's ring ({name}) disagrees "
                               f"with the earlier kernel")
    print(f"  the earlier J "
          f"{ms_of(lambda: f.tcn_fused_backward_old_kernel(head, *fwd)):.4g}"
          f" ms; G {ms_of(lambda: f.tcn_fused_forward(head)):.4g} ms",
          flush=True)
    for ring in (2, 4, 8):
        fits = f.j_ring_smem(S, H, U, ring) <= SMEM
        ms = (f"{ms_of(lambda: run('source', ring)):.4g} ms" if fits
              else "does not fit")
        print(f"  the source, a ring of {ring} chunks: {ms}", flush=True)
    print(f"  one state a thread, a ring of {plan['ring']} chunks: "
          f"{ms_of(lambda: run('one state a thread', plan['ring'])):.4g} ms",
          flush=True)
    base = None
    for name in VARIANTS_J:
        ms = ms_of(lambda: run(name, plan["ring"]))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(f"  the plan, {name}: {ms:.4g} ms{more}", flush=True)


# G: csrc/decode_tcn_fused.cu's G_CUT bits
PARTS_G = {"head": 1, "waits": 2, "stores": 4}
VARIANTS_G = {"source": [], "no head warps": ["head"],
              "no ring waits": ["waits"], "no stores": ["stores"],
              "none of the three": list(PARTS_G)}


def split_g(libs, card, dev, what, N, Th, H, U, tanh, gain, S=64):
    f = decode_fused_cuda
    head = fused_head(dev, N, Th, H, U, tanh, gain, S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = f.fused_decode_plan(N, Th * U, S, H, U, sms)["fwd"]
    old = f.tcn_fused_forward_old_kernel(head)
    hh, w, b = f._operands(head, f.fused_rows(S, dev))
    out = [torch.empty_like(x) for x in old]
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, ring):
        f._launched(libs[name].decode_fused_fwd_ring_bf16(
            hh.data_ptr(), w.data_ptr(), b.data_ptr(),
            *(x.data_ptr() for x in out), Th, N, H, S, U, ring,
            math.exp(2.0), 2.0, *f._head_ops(head), stream), name, S, H, U)

    print(f"{card}; G on {what}: N={N}, T={Th * U}, H={H}, S={S}, U={U}; "
          f"plan {plan}", flush=True)
    run("source", plan["ring"])
    torch.cuda.synchronize()
    same = [torch.equal(a.view(torch.uint8), c.view(torch.uint8))
            for a, c in zip(out, old)]
    print(f"  the source vs the earlier G, bit for bit (move_in, choices, "
          f"c, logZ, end state): {same}", flush=True)
    if not all(same):
        raise RuntimeError("decode_split: G's ring disagrees with the "
                           "earlier kernel")
    print(f"  the earlier G "
          f"{ms_of(lambda: f.tcn_fused_forward_old_kernel(head)):.4g} ms; J "
          f"{ms_of(lambda: f.tcn_fused_backward(head, *old)):.4g} ms",
          flush=True)
    for ring in (2, 4, 8):
        fits = f.g_ring_smem(S, H, U, ring) <= SMEM
        ms = (f"{ms_of(lambda: run('source', ring)):.4g} ms" if fits
              else "does not fit")
        print(f"  the source, a ring of {ring} chunks: {ms}", flush=True)
    base = None
    for name in VARIANTS_G:
        ms = ms_of(lambda: run(name, plan["ring"]))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(f"  the plan, {name}: {ms:.4g} ms{more}", flush=True)


# GW's head product: csrc/head_product.cu's HP_CUT bits, and its tiles
PARTS_GW = {"epilogue": 1, "stores": 2, "conversion": 4, "copies": 8,
            "copies of h": 16, "copies of wT": 32}
VARIANTS_GW = {
    "source": {},
    **{f"no {part}": {"HP_CUT": bit} for part, bit in PARTS_GW.items()},
    "none of the first four": {"HP_CUT": 15},
    "tile 128 x 64": {"HP_BN": 64}, "tile 64 x 128": {"HP_BM": 64},
    "k 32 a step, ring of 3": {"HP_BK": 32, "HP_STAGES": 3},
    "ring of 2": {"HP_STAGES": 2}, "ring of 3": {"HP_STAGES": 3},
    "ring of 6": {"HP_STAGES": 6},
    "ring of 2, k 32 a step": {"HP_STAGES": 2, "HP_BK": 32},
    "ring of 2, tile 64 x 128": {"HP_STAGES": 2, "HP_BM": 64},
    "ring of 2, no copies": {"HP_STAGES": 2, "HP_CUT": 8}}
GW_HEADS = {"hac": (96, 1666, 1024, 1, False, 3.0),
            "sup": (128, 1000, 512, 2, True, 0.5)}


def build_gw():
    """One library of csrc/head_product.cu per variant: its C entry, the
    threads of its tile (for the grid: 512 threads an SM)."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    procs = {name: subprocess.Popen(
        [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
         *(f"-D{k}={v}" for k, v in defs.items()), "-I", str(build.CSRC),
         "-o", str(OUT / f"lib_gw_{i}.so"),
         str(build.CSRC / "head_product.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i, (name, defs) in enumerate(VARIANTS_GW.items())}
    libs = {}
    for i, (name, proc) in enumerate(procs.items()):
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on GW's product, {name}:\n{err}")
        regs = re.findall(r"Used (\d+) registers", o + err)
        frame = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                           r"stores, (\d+) bytes spill loads", o + err)
        print(f"  {name}: {regs} registers, stack/spills {frame}",
              flush=True)
        lib = ctypes.CDLL(str(OUT / f"lib_gw_{i}.so"))
        lib.head_product_wide.argtypes = build.SIGNATURES["head_product_wide"]
        defs = VARIANTS_GW[name]
        threads = (defs.get("HP_BM", 128) // 8) * (defs.get("HP_BN", 128)
                                                  // 8)
        libs[name] = (lib, threads)
    return libs


def split_gw(libs, card, dev, what, N, Th, H, U, tanh, gain, S=1024):
    f = decode_fused_cuda
    head = fused_head(dev, N, Th, H, U, tanh, gain, S)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = f.wide_decode_plan(N, Th, H, S, U, sms)
    cols = U * 4 * S
    hh, w, b = f._operands(head)
    out = torch.empty(N, Th * U, 4 * S, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name):
        lib, threads = libs[name]
        f._launched(lib.head_product_wide(
            hh.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), Th, N,
            H, cols, sms * (512 // threads), *f._head_ops(head), stream),
            name, S, H, U)

    print(f"{card}; GW's head product at {what}: N={N}, Th={Th}, H={H}, "
          f"S={S}, U={U}; plan {plan}", flush=True)
    want = f.head_product(head)
    plain = f.head_moves_plain(head)
    torch.cuda.synchronize()
    print(f"  the library's product vs head_moves_plain, bit for bit: "
          f"{torch.equal(want.view(torch.int32), plain.view(torch.int32))}",
          flush=True)
    del plain
    for name in VARIANTS_GW:
        if "HP_CUT" not in VARIANTS_GW[name]:
            out.fill_(float("nan"))
            run(name)
            torch.cuda.synchronize()
            same = torch.equal(out.view(torch.int32), want.view(torch.int32))
            print(f"  {name} vs the library's product, bit for bit: {same}",
                  flush=True)
            if not same:
                raise RuntimeError(f"decode_split: GW's product ({name}) "
                                   f"disagrees")
    base = None
    for name in VARIANTS_GW:
        ms = ms_of(lambda: run(name))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f" ({base - ms:+.4g} ms against the source)")
        print(f"  {name}: {ms:.4g} ms{more}", flush=True)
    moves = f.move_buffer(head)
    fwd = f.tcn_fused_forward(head, moves_out=moves)
    old_fwd = f.tcn_fused_forward_wide_old_kernel(head)
    t = {"GW": ms_of(lambda: f.tcn_fused_forward(head, moves_out=moves)),
         "the product": ms_of(lambda: f.head_product(head, moves)),
         "JW": ms_of(lambda: f.tcn_fused_backward(head, *fwd, moves=moves)),
         "the earlier GW": ms_of(
             lambda: f.tcn_fused_forward_wide_old_kernel(head), reps=2),
         "the earlier JW": ms_of(
             lambda: f.tcn_fused_backward_wide_old_kernel(head, *old_fwd),
             reps=2)}
    t["GW's forward pass"] = t["GW"] - t["the product"]
    a = head.h.float().transpose(0, 1).reshape(N * Th, H)
    wt = head.wT.float().reshape(cols, H).t()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t["torch.matmul f32"] = ms_of(lambda: torch.matmul(a, wt))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    f32_bound = 2 * N * Th * H * cols / 67e12 * 1e3
    print("  " + ", ".join(f"{k} {v:.4g} ms" for k, v in t.items())
          + f"; the f32 cores' bound of the product {f32_bound:.4g} ms",
          flush=True)


def main():
    if not torch.cuda.is_available():
        print("decode_split: no CUDA device", file=sys.stderr)
        return 1
    pairs = sys.argv[1:] or list(SOURCES)
    if not set(pairs) <= {*SOURCES, "j", "g", "gw"}:
        print(f"decode_split: expected any of {[*SOURCES, 'j', 'g', 'gw']}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    for key, split_fused in (("j", split_j), ("g", split_g)):
        if key in pairs:
            libs = build_fused(key)
            for what, shape in J_HEADS.items():
                split_fused(libs, card, dev, what, *shape)
    if "gw" in pairs:
        libs = build_gw()
        for what, shape in GW_HEADS.items():
            split_gw(libs, card, dev, what, *shape)
    pairs = [p for p in pairs if p not in ("j", "g", "gw")]
    if not pairs:
        return 0
    libs = build_variants(pairs)
    if "bc" in pairs:
        split(libs["bc"], card, dev, "B and C at hac", 96, 1666)
        split(libs["bc"], card, dev, "B and C at sup", 128, 2000)
    if "mq" in pairs:
        for what, N, T, S in (("M and Q at hac", 96, 1666, 1024),
                              ("M and Q at sup", 128, 2000, 1024),
                              ("M and Q at fast", 1024, 1200, 64)):
            split_full(libs["mq"], card, dev, what, N, T, S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
