#!/usr/bin/env python3
"""
Where the time of kernels Z and Y goes (the PyTorch/CUDA port): the
gradient of the alignment lattice's logZ and its forward pass, each split
over warps (``csrc/lattice.cu``: lattice_bwd_split, lattice_fwd_split), at
hac's, fast's and sup's training shapes:

    python3 scripts/lattice_split.py [z | y]

(Z when no kernel is named) from the root of a checkout, on a machine with
a CUDA card and nvcc. It
builds ``csrc/lattice.cu`` once per variant with nvcc for sm_90a (all at
once, ``-DLATTICE_CUT=<parts>``, into
``bonito_tpu_torch/build/lattice_split/``), prints each instance's
registers, stack frame and spills, and times each through the C entries
(CUDA events, 5 runs after a warm-up), with the card's name and power
limit.

At hac (N 128, T 1000, P 496), fast (N 128, T 1200, P 598) and sup (N 32,
T 2048, P 1020), on moves of 2 times a normal draw and lengths from P / 2
to P (as chip_smoke.py's), Y's stack from the main library:

- the source at the plan (``ops.lattice_cuda.lattice_plan``) after a check
  against the earlier kernel (dmove bit for bit), with the earlier kernel's
  time beside it; then every instance built (1 or 2 positions a thread,
  each at its prefetch depths), each checked the same way;
- the source at the plan with one part left out: the frame's block
  barrier (the warp above's edge value read unordered), the exps and logs
  (each taken as its argument), the stores of dmove (their values summed),
  the reads of move and stack after the first prefetched frames, and all
  of them.

- a copy with the design measured against the source and not kept
  (``RING_EDITS``): no block barrier; each warp's edge value handed on
  through a ring of 32 slots in shared memory, the value and its frame in
  one 8-byte word, lane 0 polling the slot it needs (read a frame early)
  and publishing its own once the warp below has finished the frame that
  read the slot; checked bit for bit and timed at the plan's instance.

``y`` does the same for Y (``ops.lattice_cuda.lattice_fwd_plan``), with
the stack and without it (validation's instance): the earlier Y's times,
every instance built (1 or 2 positions a thread at each prefetch depth),
each checked against the earlier Y (stack, logZ and the no-stack logZ bit
for bit), and the plan with each part left out (the barrier, the exps and
logs, the stack's stores, the reads of move after the first prefetched
frames, all of them).

What a part adds is the source's time less the variant's; the cut
variants' outputs are wrong by design and only timed. Each line gives the
time a frame beside the total.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import build, lattice, lattice_cuda  # noqa: E402

OUT = build.BUILD / "lattice_split"
SOURCE = "lattice.cu"
ENTRY = "lattice_bwd_split"
# LATTICE_CUT's bits (csrc/lattice.cu)
PARTS = {"barrier": 1, "exps": 2, "stores": 4, "loads": 8}
VARIANTS = {"source": [], "no block barrier": ["barrier"],
            "no exps or logs": ["exps"], "no stores": ["stores"],
            "no loads": ["loads"], "none of them": list(PARTS)}
# (positions a thread, prefetch depth): the instances of lattice_bwd_split
INSTANCES = [(k, depth) for k in lattice_cuda.Z_POSITIONS
             for depth in lattice_cuda.Z_DEPTHS[k]]
# and of lattice_fwd_split (each with the stack and without it), with the
# depths measured against the source's and not kept, added to every
# library built here (``Y_EDIT``)
Y_ENTRY = "lattice_fwd_split"
Y_EDIT = ("    Y_CASE(1, 32) Y_CASE(2, 8)\n",
          "    Y_CASE(1, 16) Y_CASE(1, 32) Y_CASE(2, 8) Y_CASE(2, 16)\n")
Y_INSTANCES = [(1, 16), (1, 32), (2, 8), (2, 16)]
RING_SOURCE = "lattice_edge_ring.cu"  # written into OUT
# the edge ring in place of the block barrier: edits of csrc/lattice.cu
RING_HELPERS = r"""
constexpr int ZE = 32;  // slots of the ring between two warps
constexpr unsigned ZNONE = 0xffffffffu;  // the frame of a slot never written
constexpr long long ZSPINS = 1LL << 26;  // a wait that cannot end traps

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned long long ld_slot(
    const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.volatile.shared.u64 %0, [%1];\n"
                 : "=l"(v) : "r"(smem_addr(p)) : "memory");
    return v;
}

__device__ __forceinline__ void st_slot(unsigned long long* p, float v,
                                        unsigned frame) {
    asm volatile("st.volatile.shared.u64 [%0], %1;\n"
                 :: "r"(smem_addr(p)),
                    "l"((unsigned long long)frame << 32 | __float_as_uint(v))
                 : "memory");
}

__device__ __forceinline__ int ld_count(const int* p) {
    int v;
    asm volatile("ld.volatile.shared.b32 %0, [%1];\n"
                 : "=r"(v) : "r"(smem_addr(p)) : "memory");
    return v;
}

__device__ __forceinline__ void st_count(int* p, int v) {
    asm volatile("st.volatile.shared.b32 [%0], %1;\n"
                 :: "r"(smem_addr(p)), "r"(v) : "memory");
}
"""
RING_EDITS = [
    ("constexpr int ZWARPS = 32;  // warps a CTA, at most\n",
     "constexpr int ZWARPS = 32;  // warps a CTA, at most\n" + RING_HELPERS),
    ("    // each warp's first position's beta, by the parity of its frame\n"
     "    __shared__ float edge[2][ZWARPS];\n",
     "    __shared__ unsigned long long edge[ZWARPS][ZE];\n"
     "    __shared__ int count[ZWARPS];\n"),
    ("    if (lane == 0) edge[T & 1][w] = b[0];\n    __syncthreads();\n",
     "    if (lane == 0) {\n"
     "        for (int e = 0; e < ZE; ++e)\n"
     "            st_slot(&edge[w][e], b[0], e == T % ZE ? (unsigned)T "
     ": ZNONE);\n"
     "        st_count(&count[w], T);\n"
     "    }\n    __syncthreads();\n"
     "    unsigned long long pending =\n"
     "        lane == 0 && above ? ld_slot(&edge[w + 1][T % ZE]) : 0ull;\n"
     "    int below = T;\n"),
    ("            const float up = lane == 0 && above ? edge[(t + 1) & 1][w + 1]\n"
     "                                                : NEG;\n",
     "            float up = NEG;\n"
     "            if (lane == 0 && above) {\n"
     "                long long spins = 0;\n"
     "                while ((unsigned)(pending >> 32) != (unsigned)(t + 1)) {\n"
     "                    if (++spins > ZSPINS) __trap();\n"
     "                    pending = ld_slot(&edge[w + 1][(t + 1) % ZE]);\n"
     "                }\n"
     "                up = __uint_as_float((unsigned)pending);\n"
     "            }\n"),
    ("#pragma unroll\n            for (int j = 0; j < K; ++j) {\n"
     "                const int p = p0 + 32 * j;\n"
     "                const float mv = pm[d][j], a = pa[d][j];\n",
     "            if (lane == 0 && above && t > 0)\n"
     "                pending = ld_slot(&edge[w + 1][t % ZE]);\n"
     "#pragma unroll\n            for (int j = 0; j < K; ++j) {\n"
     "                const int p = p0 + 32 * j;\n"
     "                const float mv = pm[d][j], a = pa[d][j];\n"),
    ("            if (lane == 0) edge[t & 1][w] = b[0];\n"
     "            if (!zcut(ZCUT_BARRIER)) __syncthreads();\n",
     "            if (lane == 0) {\n"
     "                if (w > 0) {\n"
     "                    long long spins = 0;\n"
     "                    while (below > t + ZE - 1) {\n"
     "                        if (++spins > ZSPINS) __trap();\n"
     "                        below = ld_count(&count[w - 1]);\n"
     "                    }\n"
     "                    st_slot(&edge[w][t % ZE], b[0], (unsigned)t);\n"
     "                }\n"
     "                st_count(&count[w], t);\n"
     "            }\n"),
]
SHAPES = (("hac", 128, 1000, 496), ("fast", 128, 1200, 598),
          ("sup", 32, 2048, 1020))
BLANK = 2.0


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
        m = re.search(r"Compiling entry function '\w*lattice_bwd_split_kernel"
                      r"ILi(\d+)ELi(\d+)E", line)
        if m:
            kernel = f"Z<{m.group(1)} positions, depth {m.group(2)}>"
        m = re.search(r"Compiling entry function '\w*lattice_fwd_split_kernel"
                      r"ILi(\d+)ELi(\d+)ELb(\d)E", line)
        if m:
            kernel = (f"Y<{m.group(1)} positions, depth {m.group(2)}, "
                      f"stack {m.group(3)}>")
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if kernel and m:
            frame = f"stack {m.group(1)} B, spills {m.group(2)}/{m.group(3)} B"
        m = re.search(r"Used (\d+) registers", line)
        if kernel and m:
            rows.append(f"{kernel}: {m.group(1)} registers, {frame}")
            kernel = None
    return rows


def y_depths(cu):
    """``csrc/lattice.cu`` with Y's other depths (``Y_EDIT``)."""
    old, new = Y_EDIT
    if cu.count(old) != 1:
        raise SystemExit("lattice_split: Y's instances are not in "
                         "csrc/lattice.cu as expected")
    return cu.replace(old, new)


def ring_source():
    """``csrc/lattice.cu`` with ``RING_EDITS`` (and ``Y_EDIT``), written
    beside the split's libraries."""
    cu = y_depths((build.CSRC / SOURCE).read_text())
    for old, new in RING_EDITS:
        if cu.count(old) != 1:
            raise SystemExit(f"lattice_split: the ring copy's anchor "
                             f"{old[:60]!r} is not in csrc/lattice.cu once")
        cu = cu.replace(old, new)
    path = OUT / RING_SOURCE
    path.write_text(cu)
    return path


def build_variants(kernel):
    """One library per variant, and for Z (``kernel`` "z") one of the
    edge-ring copy: the C entries; the source's registers for ``kernel``'s
    instances."""
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = build._nvcc()
    source = OUT / SOURCE
    source.write_text(y_depths((build.CSRC / SOURCE).read_text()))
    sources = {name: (source, sum(PARTS[p] for p in parts))
               for name, parts in VARIANTS.items()}
    if kernel == "z":
        sources["the edge ring"] = (ring_source(), 0)
    procs = {}
    for i, (name, (src, cut)) in enumerate(sources.items()):
        lib = OUT / f"lib_lattice_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
             f"-DLATTICE_CUT={cut}", "-I", str(build.CSRC), "-o", str(lib),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        if name == "source":
            for row in ptxas_lines(o + err):
                if row.startswith(kernel.upper() + "<"):
                    print(f"  {name}, {row}", flush=True)
        lib = ctypes.CDLL(str(path))
        for entry in (ENTRY, Y_ENTRY):
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def split(libs, card, dev, what, N, T, P):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lattice_cuda.lattice_plan(N, T, P, sms)
    g = torch.Generator(device=dev).manual_seed(N + T + P)
    move = 2 * torch.randn(N, T, P - 1, device=dev, generator=g)
    lengths = torch.randint(P // 2, P + 1, (N,), device=dev, generator=g,
                            dtype=torch.int32)
    stack, lz = lattice_cuda.lattice_forward(move, lengths, BLANK)
    cot = -1.0 / (lengths.float() * N)
    gz, sg = lattice.cotangent(cot, lz)
    old = lattice_cuda.lattice_backward_old_kernel(move, stack, lengths, gz,
                                                   sg, BLANK)
    out = torch.empty_like(old)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, k, depth):
        build.check(getattr(libs[name], ENTRY)(
            move.data_ptr(), stack.data_ptr(), lengths.data_ptr(),
            gz.data_ptr(), sg.data_ptr(), out.data_ptr(), N, T, P, k, depth,
            BLANK, stream), name)

    def same(k, depth, name="source"):
        out.fill_(float("nan"))
        run(name, k, depth)
        torch.cuda.synchronize()
        return torch.equal(out.view(torch.int32), old.view(torch.int32))

    def line(label, ms):
        return f"  {label}: {ms:.4g} ms ({ms / T * 1e3:.4g} us a frame)"

    k0, d0 = plan["positions_per_thread"], plan["prefetch"]
    print(f"{card}; Z at {what}: N={N}, T={T}, P={P}; plan {plan}",
          flush=True)
    print(line("the earlier kernel", ms_of(
        lambda: lattice_cuda.lattice_backward_old_kernel(
            move, stack, lengths, gz, sg, BLANK))), flush=True)
    for k, depth in INSTANCES:
        if -(-P // (32 * k)) > lattice_cuda.Z_WARPS_MAX:
            continue
        ok = same(k, depth)
        print(line(f"{k} positions a thread ({-(-P // (32 * k))} warps), "
                   f"{depth} frames ahead (bits equal: {ok})",
                   ms_of(lambda: run("source", k, depth))), flush=True)
        if not ok:
            raise RuntimeError(f"lattice_split: Z at {k} positions, depth "
                               f"{depth} disagrees with the earlier kernel "
                               f"at {what}")
    ok = same(k0, d0, "the edge ring")
    print(line(f"the edge ring in place of the barrier, the plan's instance "
               f"(bits equal: {ok})",
               ms_of(lambda: run("the edge ring", k0, d0))), flush=True)
    if not ok:
        raise RuntimeError(f"lattice_split: the edge ring disagrees with the "
                           f"earlier kernel at {what}")
    base = None
    for name in VARIANTS:
        ms = ms_of(lambda: run(name, k0, d0))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(line(f"the plan, {name}", ms) + more, flush=True)


def split_y(libs, card, dev, what, N, T, P):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = lattice_cuda.lattice_fwd_plan(N, T, P, sms)
    g = torch.Generator(device=dev).manual_seed(N + T + P)
    move = 2 * torch.randn(N, T, P - 1, device=dev, generator=g)
    lengths = torch.randint(P // 2, P + 1, (N,), device=dev, generator=g,
                            dtype=torch.int32)
    old_stack, old_lz = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, BLANK)
    _, old_only = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, BLANK, with_stack=False)
    stack, lz, lz_only = (torch.empty_like(old_stack),
                          torch.empty_like(old_lz), torch.empty_like(old_lz))
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, k, depth, with_stack=True):
        build.check(getattr(libs[name], Y_ENTRY)(
            move.data_ptr(), lengths.data_ptr(),
            stack.data_ptr() if with_stack else None,
            (lz if with_stack else lz_only).data_ptr(), N, T, P, k, depth,
            BLANK, stream), name)

    def same(k, depth):
        for x in (stack, lz, lz_only):
            x.fill_(float("nan"))
        run("source", k, depth)
        run("source", k, depth, with_stack=False)
        torch.cuda.synchronize()
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in ((stack, old_stack), (lz, old_lz),
                                (lz_only, old_only)))

    def line(label, ms, ms_only):
        return (f"  {label}: {ms:.4g} ms ({ms / T * 1e3:.4g} us a frame), "
                f"without the stack {ms_only:.4g} ms")

    k0, d0 = plan["positions_per_thread"], plan["prefetch"]
    print(f"{card}; Y at {what}: N={N}, T={T}, P={P}; plan {plan}",
          flush=True)
    print(line("the earlier kernel", ms_of(
        lambda: lattice_cuda.lattice_forward_old_kernel(move, lengths,
                                                        BLANK)),
        ms_of(lambda: lattice_cuda.lattice_forward_old_kernel(
            move, lengths, BLANK, with_stack=False))), flush=True)
    for k, depth in Y_INSTANCES:
        if -(-P // (32 * k)) > lattice_cuda.Z_WARPS_MAX:
            continue
        ok = same(k, depth)
        print(line(f"{k} positions a thread ({-(-P // (32 * k))} warps), "
                   f"{depth} frames ahead (bits equal: {ok})",
                   ms_of(lambda: run("source", k, depth)),
                   ms_of(lambda: run("source", k, depth, False))),
              flush=True)
        if not ok:
            raise RuntimeError(f"lattice_split: Y at {k} positions, depth "
                               f"{depth} disagrees with the earlier kernel "
                               f"at {what}")
    base = None
    for name in VARIANTS:
        ms = (ms_of(lambda: run(name, k0, d0)),
              ms_of(lambda: run(name, k0, d0, False)))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base[0] - ms[0]:.4g} and "
            f"{base[1] - ms[1]:.4g} ms")
        print(line(f"the plan, {name}", *ms) + more, flush=True)


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "z"
    if kernel not in ("z", "y"):
        print("usage: lattice_split.py [z | y]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("lattice_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants(kernel)
    for what, N, T, P in SHAPES:
        (split if kernel == "z" else split_y)(libs, card, dev, what, N, T, P)
    return 0


if __name__ == "__main__":
    sys.exit(main())
