#!/usr/bin/env python3
"""
Where the time of the loss's ring kernels U and V goes (the PyTorch/CUDA
port): logZ of the TCN moves with its alpha stack, and its gradient, at
hac's, sup's and fast's training shapes; with ``x``, the same for kernel X
(the gradient of logZ of the full scores, ``logz_full_bwd_ring``); with
``w``, for kernel W (logZ of the full scores, ``logz_full_fwd_ring``):

    python3 scripts/logz_split.py [x | w]

from the root of a checkout, on a machine with a CUDA card and nvcc. It
builds ``csrc/logz_ring.cu`` once per variant with nvcc for sm_90a (all at
once, ``-DLOGZ_CUT=<parts>``, into ``bonito_tpu_torch/build/logz_split/``),
and once more from a copy with the designs that were measured against it
and not kept (``VARIANT_EDITS``), prints each ring kernel's registers,
stack frame and spills, and times each through the kernels' C entries (CUDA
events, 5 runs after a warm-up), with the card's name and power limit.

At hac (N 128, T 1000, S 1024), sup (N 32, T 2048, S 1024) and fast (N 128,
T 1200, S 64), and at hac's batch with 256 states, on random bf16 moves (5 tanh of a normal draw, as a head gives
them), with round_bf16 as the train step runs them:

- the source at the plan (``ops.logz_cuda.logz_plan``), after a check
  against the earlier kernels of ``csrc/logz.cu`` (stack, logZ, the
  no-stack logZ and the gradient, bit for bit), with the earlier kernels'
  times beside it; then at 1 and 4 states a thread (and 2, from the copy)
  and at ring depths 2, 4, 8 and 16;
- the source with one part left out: the ring's copies and waits (the rows
  are then whatever the slots hold), the exps and logs (each taken as its
  argument), the stores of the stack or the gradient (the gradient's values
  still summed, so that their exps stay), and all of them;
- the copy with the stores sent by bulk copies instead: U's stack as one
  bulk store a frame of the parity buffer, V's gradient staged in shared
  memory and sent as one bulk store a frame.

``x``: at hac (N 128, T 1000, S 1024), sup (N 32, T 2048) and fast (N
128, T 1200, S 64) on f32 scores (2 times a normal draw) with round_bf16
and an f32 gradient, as ``loss`` runs X, the alpha stack from W: the
source at the plan (``logz_plan(..., full=True)``), checked against the
earlier X (the gradient bit for bit), with the earlier X's time beside
it; 32 to 640 consumer threads (the chain's S / k and more for the
gradient's pass), each also with the chain's warps out of the pass (from
a copy); rings of 2, 4, 8 and 16 frames where they fit in shared memory;
the plan with the ring's waits, the exps and logs, the gradient's stores,
or all of them left out; and the copies with the designs measured against
the source and not kept (``X_EDITS``), checked and timed: V's lane layout
(each read of a frame's moves takes one predecessor j for the whole warp,
a 4-way bank conflict at S 1024, where the source's lane q reads j = (k +
q / 8) mod 4 in its k-th read), and the chain's warps out of the
gradient's pass (the pass by the other consumers only).

``w``: at the same shapes and scores as ``x``, with round_bf16 as ``loss``
runs W: the source at the plan (``logz_plan(..., full=True)["fwd"]``),
checked against the earlier W (the stack, logZ and the no-stack logZ, bit
for bit), with the earlier W's times beside it, with and without the
stack; 1 and 4 states a thread where the C entry takes them; rings of 2,
4, 8 and 16 frames where they fit in shared memory (each checked); the
plan with the ring's waits, the exps and logs, the stack's stores, or all
of them left out.

What a part adds is the source's time less the variant's; the cut
variants' outputs are wrong by design and only timed (the copy's are
checked). Each line gives the time a frame beside the total.
"""

import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
from bonito_tpu_torch.ops import build, logz_cuda  # noqa: E402

OUT = build.BUILD / "logz_split"
SOURCE = "logz_ring.cu"
VARIANT_SOURCE = "logz_ring_variants.cu"  # written into OUT
ENTRIES = ("logz_tcn_fwd_ring", "logz_tcn_bwd_ring")
# LOGZ_CUT's bits (csrc/logz_ring.cu, csrc/logz_steps.cuh)
PARTS = {"waits": 1, "exps": 2, "stores": 4}
VARIANTS = {"source": [], "no ring waits": ["waits"],
            "no exps or logs": ["exps"], "no stores": ["stores"],
            "none of them": list(PARTS), "variants": ["copy"],
            "bulk stores": ["copy", "bulk"]}
RINGS = (2, 4, 8, 16)
SHAPES = (("hac", 128, 1000, 1024), ("sup", 32, 2048, 1024),
          ("fast", 128, 1200, 64), ("hac's batch at state_len 4", 128, 1000,
                                    256))
BLANK = 2.0
THREADS_K2 = 512 + 32  # the copy's CTA at 2 states a thread
X_ENTRY = "logz_full_bwd_ring"
X_VARIANTS = {"source": [], "no ring waits": ["waits"],
              "no exps or logs": ["exps"], "no stores": ["stores"],
              "none of them": list(PARTS), "V's lane layout": ["lanes"],
              "the chain out of the pass": ["split"]}
X_SHAPES = (("hac", 128, 1000, 1024), ("sup", 32, 2048, 1024),
            ("fast", 128, 1200, 64))
X_CONSUMERS = (32, 64, 96, 128, 192, 256, 320, 384, 448, 512, 640)
W_ENTRY = "logz_full_fwd_ring"
W_VARIANTS = {"source": [], "no ring waits": ["waits"],
              "no exps or logs": ["exps"], "no stores": ["stores"],
              "none of them": list(PARTS)}
# the designs measured against X's source and not kept, as edits of it
X_EDITS = {
    "lanes": ("    auto pj = [&](int k) { return j0 + ((k + (q >> 3)) & "
              "(K - 1)); };\n",
              "    auto pj = [&](int k) { return j0 + k; };\n"),
    "split": ("        for (int col = tid; col < W; col += nc) {\n",
              "        const int g0 = logz_consumers(S, K);\n"
              "        for (int col = tid - g0; col < W; col += nc - g0) {\n"
              "            if (col < 0) break;\n"),
}

# 2 states a thread (a CTA of 16 consumer warps at S 1024), and the stores
# sent as one bulk store a frame (-DLOGZ_STACK_BULK=1: U's stack from the
# parity buffer; -DLOGZ_GRAD_BULK=1: V's gradient staged in shared memory):
# the designs measured against the source and not kept, as edits of it
BULK_HELPERS = r"""
#ifndef LOGZ_STACK_BULK
#define LOGZ_STACK_BULK 0
#endif
#ifndef LOGZ_GRAD_BULK
#define LOGZ_GRAD_BULK 0
#endif

namespace {

constexpr bool STACK_BULK = LOGZ_STACK_BULK != 0;
constexpr bool GRAD_BULK = LOGZ_GRAD_BULK != 0;
constexpr int GRAD_SLOTS = 3;  // the staged gradient rows

// what a thread wrote to shared memory made visible to the async proxy
__device__ __forceinline__ void fence_async_shared() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes of this CTA's shared memory to global memory, in the issuing
// thread's bulk group
__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           unsigned bytes) {
    asm volatile(
        "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
        :: "l"(__cvta_generic_to_global(dst)), "r"(smem_u32(src)),
           "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// wait until at most N of the thread's bulk stores still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace
"""
VARIANT_EDITS = [
    ('#include "ring.cuh"\n', '#include "ring.cuh"\n' + BULK_HELPERS),
    # 2 states a thread: 16 consumer warps at S 1024
    ("constexpr int LOGZ_THREADS = 256 + 32;",
     "constexpr int LOGZ_THREADS = 512 + 32;\n"
     "__host__ __device__ constexpr int logz_bound(int K) {\n"
     "    return K == 2 ? 512 + 32 : 256 + 32;\n}"),
    ("template <typename In, bool ROUND, bool STACK, int K>\n"
     "__global__ void __launch_bounds__(LOGZ_THREADS, 1)\n"
     "logz_fwd_ring_kernel(",
     "template <typename In, bool ROUND, bool STACK, int K>\n"
     "__global__ void __launch_bounds__(logz_bound(K), 1)\n"
     "logz_fwd_ring_kernel("),
    ("template <typename In, typename Out, bool ROUND, int K>\n"
     "__global__ void __launch_bounds__(LOGZ_THREADS, 1)\n"
     "logz_bwd_ring_kernel(",
     "template <typename In, typename Out, bool ROUND, int K>\n"
     "__global__ void __launch_bounds__(logz_bound(K), 1)\n"
     "logz_bwd_ring_kernel("),
    ("(K != 1 && K != 4)", "(K != 1 && K != 2 && K != 4)"),
    ("""        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {""", """        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else if constexpr (K == 2) {
        const float2 a = *reinterpret_cast<const float2*>(p);
        v[0] = a.x; v[1] = a.y;
    } else {"""),
    ("""        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else""", """        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else if constexpr (K == 2)
        *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
    else"""),
    ("""    if (K == 4)
        return launch_fwd<In, ROUND, STACK, 4>(moves, stack, logz, N, T, S,
                                               ring, blank, st);
""", """    if (K == 4)
        return launch_fwd<In, ROUND, STACK, 4>(moves, stack, logz, N, T, S,
                                               ring, blank, st);
    if (K == 2)
        return launch_fwd<In, ROUND, STACK, 2>(moves, stack, logz, N, T, S,
                                               ring, blank, st);
"""),
    ("""    if (K == 4)
        return launch_bwd<In, Out, ROUND, 4>(moves, stack, logz, g, grad, N,
                                             T, S, ring, blank, st);
""", """    if (K == 4)
        return launch_bwd<In, Out, ROUND, 4>(moves, stack, logz, g, grad, N,
                                             T, S, ring, blank, st);
    if (K == 2)
        return launch_bwd<In, Out, ROUND, 2>(moves, stack, logz, g, grad, N,
                                             T, S, ring, blank, st);
"""),
    # U: alpha_t sent from its parity buffer by the producer's lane 0
    ("""    for (int i = tid; i < S; i += blockDim.x) alpha[i] = 0.f;
""", """    for (int i = tid; i < S; i += blockDim.x) alpha[i] = 0.f;
    if (STACK && STACK_BULK) fence_async_shared();
"""),
    ("""        for (int t = 0; t < T; ++t) {
            __syncthreads();  // the rows of frames up to t + 1 are read
            if (lane == 0) issue(min(T, t + 2 + ring));
        }
""", """        for (int t = 0; t < T; ++t) {
            if (STACK && STACK_BULK && lane == 0 && !lcut(LCUT_STORES)) {
                // alpha_t, complete since the last barrier, read before
                // the barrier after which frame t + 1 writes its parity
                bulk_store(stack + (row0 + t) * S, alpha + (t & 1) * S,
                           4u * S);
                bulk_wait_read<0>();
            }
            __syncthreads();  // the rows of frames up to t + 1 are read
            if (lane == 0) issue(min(T, t + 2 + ring));
        }
        if (STACK && STACK_BULK && lane == 0) bulk_wait_all();
"""),
    ("if (STACK && active && !lcut(LCUT_STORES))",
     "if (STACK && !STACK_BULK && active && !lcut(LCUT_STORES))"),
    ("""        if (active) store_k<K>(an + s0, nxt);
""", """        if (active) store_k<K>(an + s0, nxt);
        if (STACK && STACK_BULK) fence_async_shared();
"""),
    # V: the gradient row staged in shared memory, sent by the producer's
    # lane 0 after the frame's barrier
    ("""                                                size_t in_bytes) {
    return logz_head(ring) + (size_t)8 * S
        + ring * (NB * S * in_bytes + (size_t)4 * S);""",
     """                                                size_t in_bytes,
                                                size_t out_bytes) {
    return logz_head(ring) + (size_t)8 * S
        + ring * (NB * S * in_bytes + (size_t)4 * S)
        + (GRAD_BULK ? GRAD_SLOTS * NB * S * out_bytes : 0);"""),
    ("logz_bwd_smem(S, ring, sizeof(In));",
     "logz_bwd_smem(S, ring, sizeof(In), sizeof(Out));"),
    ("""    const unsigned row_bytes = (unsigned)(NB * S * sizeof(In));
    const unsigned slot_bytes = row_bytes + 4u * S;
    uint64_t* full = reinterpret_cast<uint64_t*>(logz_smem);
    float* beta = reinterpret_cast<float*>(logz_smem + logz_head(ring));
    unsigned char* rows = reinterpret_cast<unsigned char*>(beta + 2 * S);
""", """    const unsigned row_bytes = (unsigned)(NB * S * sizeof(In));
    const unsigned slot_bytes = row_bytes + 4u * S;
    uint64_t* full = reinterpret_cast<uint64_t*>(logz_smem);
    float* beta = reinterpret_cast<float*>(logz_smem + logz_head(ring));
    unsigned char* rows = reinterpret_cast<unsigned char*>(beta + 2 * S);
    Out* staged = reinterpret_cast<Out*>(rows + (size_t)ring * slot_bytes);
"""),
    ("""            __syncthreads();  // the slots of frames up to i + 1 are read
            if (lane == 0) issue(min(T, i + 2 + ring));
        }
""", """            __syncthreads();  // frames up to i + 1 read, i's gradient staged
            if (lane == 0) {
                if (GRAD_BULK && !lcut(LCUT_STORES)) {
                    // frame i + 2 writes the row of frame i - 1: its store
                    // has read it before the next barrier
                    bulk_store(grad + (row0 + T - 1 - i) * NB * S,
                               staged + (size_t)(i % GRAD_SLOTS) * NB * S,
                               (unsigned)(NB * S * sizeof(Out)));
                    bulk_wait_read<1>();
                }
                issue(min(T, i + 2 + ring));
            }
        }
        if (GRAD_BULK && lane == 0) bulk_wait_all();
"""),
    ("""        Out* dst = grad + (row0 + t) * NB * S;""",
     """        Out* dst = GRAD_BULK ? staged + (size_t)(i % GRAD_SLOTS) * NB * S
                             : grad + (row0 + t) * NB * S;"""),
    ("""            for (int k = 0; k < K; ++k) bn[(c * K + k) * R + q] = nxt[k];
        }
        if (i + 2 < T) cur.next();""",
     """            for (int k = 0; k < K; ++k) bn[(c * K + k) * R + q] = nxt[k];
        }
        if (GRAD_BULK) fence_async_shared();
        if (i + 2 < T) cur.next();"""),
]



def variant_source(cu):
    """``csrc/logz_ring.cu`` with ``VARIANT_EDITS``."""
    for old, new in VARIANT_EDITS:
        if cu.count(old) != 1:
            raise SystemExit(f"logz_split: the variant's anchor {old[:60]!r} "
                             f"is not in csrc/logz_ring.cu once")
        cu = cu.replace(old, new)
    return cu


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
        m = re.search(r"Compiling entry function '\w*(logz_(?:full_)?"
                      r"(?:fwd|bwd)_ring_kernel\w*?)'", line)
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


def x_source(cu, edit):
    """``csrc/logz_ring.cu`` with ``X_EDITS[edit]``."""
    old, new = X_EDITS[edit]
    if cu.count(old) != 1:
        raise SystemExit(f"logz_split: {old!r} is not in csrc/logz_ring.cu "
                         f"once")
    return cu.replace(old, new)


def build_variants(kernel="uv"):
    """One library per variant (``VARIANTS``, or ``X_VARIANTS`` for
    ``kernel`` "x", ``W_VARIANTS`` for "w"): its C entries."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu = (build.CSRC / SOURCE).read_text()
    (OUT / VARIANT_SOURCE).write_text(variant_source(cu))
    for edit in X_EDITS:
        (OUT / f"logz_ring_x_{edit}.cu").write_text(x_source(cu, edit))
    nvcc = build._nvcc()
    procs = {}
    variants = {"x": X_VARIANTS, "w": W_VARIANTS}.get(kernel, VARIANTS)
    for i, (name, parts) in enumerate(variants.items()):
        cut = sum(PARTS.get(p, 0) for p in parts)
        flags = [f"-DLOGZ_CUT={cut}"]
        if "bulk" in parts:
            flags += ["-DLOGZ_STACK_BULK=1", "-DLOGZ_GRAD_BULK=1"]
        edit = next((p for p in parts if p in X_EDITS), None)
        src = (OUT / VARIANT_SOURCE if "copy" in parts else
               OUT / f"logz_ring_x_{edit}.cu" if edit else
               build.CSRC / SOURCE)
        lib = OUT / f"lib_logz_{i}.so"
        procs[name] = (lib, subprocess.Popen(
            [nvcc, *build.ARCH, *build.FLAGS, "-Xptxas", "-v", "-shared",
             *flags, "-I", str(build.CSRC), "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in procs.items():
        o, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        if name in ("source", "bulk stores", "V's lane layout"):
            for row in ptxas_lines(o + err):
                if kernel == "x" and "full_bwd" in row and "IffLb1E" in row:
                    print(f"  {name}, {row}", flush=True)
                elif kernel == "w" and "full_fwd" in row and "IfLb1E" in row:
                    print(f"  {name}, {row}", flush=True)
                elif (kernel != "x" and "full" not in row
                      and "13__nv_bfloat16" in row and "Lb1E" in row):
                    print(f"  {name}, {row}", flush=True)
        lib = ctypes.CDLL(str(path))
        for entry in ENTRIES + (X_ENTRY, W_ENTRY):
            getattr(lib, entry).argtypes = build.SIGNATURES[entry]
        libs[name] = lib
    return libs


def split(libs, card, dev, what, N, T, S):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = logz_cuda.logz_plan(N, T, S, torch.bfloat16, sms)
    g = torch.Generator(device=dev).manual_seed(N + T + S)
    moves = (5 * torch.tanh(torch.randn(N, T, 4 * S, device=dev,
                                        generator=g))).to(torch.bfloat16)
    cot = 1.0 / torch.arange(1, N + 1, device=dev, dtype=torch.float32)
    stack_old, lz_old = logz_cuda.tcn_forward_old_kernel(moves, BLANK)
    _, lz_only_old = logz_cuda.tcn_forward_old_kernel(moves, BLANK,
                                                      with_stack=False)
    grad_old = logz_cuda.tcn_backward_old_kernel(moves, stack_old, lz_old,
                                                 cot, BLANK)
    stack = torch.empty_like(stack_old)
    lz = torch.empty_like(lz_old)
    lz_only = torch.empty_like(lz_old)
    grad = torch.empty_like(grad_old)
    stream = torch.cuda.current_stream().cuda_stream

    def run_u(name, k, ring, with_stack=True):
        build.check(libs[name].logz_tcn_fwd_ring(
            moves.data_ptr(), 0, 1, stack.data_ptr() if with_stack else None,
            (lz if with_stack else lz_only).data_ptr(), N, T, S, k, ring,
            BLANK, stream), name)

    def run_v(name, k, ring):
        build.check(libs[name].logz_tcn_bwd_ring(
            moves.data_ptr(), 0, 1, stack_old.data_ptr(), lz_old.data_ptr(),
            cot.data_ptr(), grad.data_ptr(), 0, N, T, S, k, ring, BLANK,
            stream), name)

    def same(name, k, ring):
        for x in (stack, lz, lz_only, grad):
            x.fill_(float("nan"))
        run_u(name, k, ring)
        run_u(name, k, ring, with_stack=False)
        run_v(name, k, ring)
        torch.cuda.synchronize()
        return [torch.equal(a.view(torch.int16 if a.dtype == torch.bfloat16
                                   else torch.int32),
                            b.view(torch.int16 if b.dtype == torch.bfloat16
                                   else torch.int32))
                for a, b in ((stack, stack_old), (lz, lz_old),
                             (lz_only, lz_only_old), (grad, grad_old))]

    k0, r0 = plan["states_per_thread"], plan["fwd"]["ring"]
    print(f"{card}; U and V at {what}: N={N}, T={T}, S={S}, bf16, "
          f"round_bf16; plan {plan}", flush=True)
    for name in ("source", "variants", "bulk stores"):
        ok = same(name, k0, r0)
        print(f"  {name} vs the earlier kernels, bit for bit (stack, logZ, "
              f"no-stack logZ, gradient): {ok}", flush=True)
        if not all(ok):
            raise RuntimeError(f"logz_split: {name} disagrees with the "
                               f"earlier kernels at {what}")

    def line(label, u, u_only, v):
        return (f"  {label}: U {u:.4g} ms ({u / T * 1e3:.4g} us a frame), "
                f"U without its stack {u_only:.4g}, V {v:.4g} ms "
                f"({v / T * 1e3:.4g} us a frame)")
    print(line("the earlier kernels",
               ms_of(lambda: logz_cuda.tcn_forward_old_kernel(moves, BLANK)),
               ms_of(lambda: logz_cuda.tcn_forward_old_kernel(
                   moves, BLANK, with_stack=False)),
               ms_of(lambda: logz_cuda.tcn_backward_old_kernel(
                   moves, stack_old, lz_old, cot, BLANK))), flush=True)
    for k, name in ((1, "source"), (2, "variants"), (4, "source")):
        if logz_cuda.ring_consumers(S, k) + 32 > (
                THREADS_K2 if k == 2 else logz_cuda.THREADS):
            continue
        ok = same(name, k, r0)
        print(line(f"the {'source' if name == 'source' else 'copy'}, {k} "
                   f"states a thread (bits equal: {all(ok)})",
                   ms_of(lambda: run_u(name, k, r0)),
                   ms_of(lambda: run_u(name, k, r0, False)),
                   ms_of(lambda: run_v(name, k, r0))), flush=True)
        if not all(ok):
            raise RuntimeError(f"logz_split: {k} states a thread disagree")
    for ring in RINGS:
        print(line(f"the source on a ring of {ring}",
                   ms_of(lambda: run_u("source", k0, ring)),
                   ms_of(lambda: run_u("source", k0, ring, False)),
                   ms_of(lambda: run_v("source", k0, ring))), flush=True)
    base = None
    for name in (v for v in VARIANTS if v != "variants"):
        ms = (ms_of(lambda: run_u(name, k0, r0)),
              ms_of(lambda: run_u(name, k0, r0, False)),
              ms_of(lambda: run_v(name, k0, r0)))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base[0] - ms[0]:.4g}, "
            f"{base[1] - ms[1]:.4g} and {base[2] - ms[2]:.4g} ms")
        print(line(f"the plan, {name}", *ms) + more, flush=True)


def split_x(libs, card, dev, what, N, T, S):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = logz_cuda.logz_plan(N, T, S, torch.float32, sms, full=True)
    g = torch.Generator(device=dev).manual_seed(N + T + S)
    scores = 2 * torch.randn(N, T, 5 * S, device=dev, generator=g)
    cot = 1.0 / torch.arange(1, N + 1, device=dev, dtype=torch.float32)
    stack, lz = logz_cuda.full_forward(scores)
    old = logz_cuda.full_backward_old_kernel(scores, stack, lz, cot)
    grad = torch.empty_like(old)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, nc, ring):
        build.check(getattr(libs[name], X_ENTRY)(
            scores.data_ptr(), 1, 1, stack.data_ptr(), lz.data_ptr(),
            cot.data_ptr(), grad.data_ptr(), 1, N, T, S, k0, nc, ring,
            stream), name)

    def same(name, nc, ring):
        grad.fill_(float("nan"))
        run(name, nc, ring)
        torch.cuda.synchronize()
        return torch.equal(grad.view(torch.int32), old.view(torch.int32))

    def line(label, ms):
        return f"  {label}: {ms:.4g} ms ({ms / T * 1e3:.4g} us a frame)"

    k0, r0 = plan["states_per_thread"], plan["bwd"]["ring"]
    c0 = plan["consumer_threads"]
    print(f"{card}; X at {what}: N={N}, T={T}, S={S}, f32, round_bf16, "
          f"f32 gradient; plan {plan}", flush=True)
    print(line("the earlier kernel", ms_of(
        lambda: logz_cuda.full_backward_old_kernel(scores, stack, lz, cot))),
        flush=True)
    for name in ("source", "V's lane layout"):
        ok = same(name, c0, r0)
        print(line(f"{name} at the plan (bits equal: {ok})",
                   ms_of(lambda: run(name, c0, r0))), flush=True)
        if not ok:
            raise RuntimeError(f"logz_split: X's {name} disagrees with the "
                               f"earlier kernel at {what}")
    chain = logz_cuda.ring_consumers(S, k0)
    for nc in X_CONSUMERS:
        for name in ("source", "the chain out of the pass"):
            if nc < chain or (name != "source" and nc <= chain):
                continue
            ok = same(name, nc, r0)
            print(line(f"{name} with {nc} consumer threads (bits equal: "
                       f"{ok})", ms_of(lambda: run(name, nc, r0))),
                  flush=True)
            if not ok:
                raise RuntimeError(f"logz_split: X's {name} with {nc} "
                                   f"consumers disagrees at {what}")
    for ring in RINGS:
        if logz_cuda.logz_smem(S, ring, torch.float32, True, True) > 232448:
            continue
        ok = same("source", c0, ring)
        print(line(f"the source on a ring of {ring} (bits equal: {ok})",
                   ms_of(lambda: run("source", c0, ring))), flush=True)
    base = None
    for name in X_VARIANTS:
        if X_VARIANTS[name] and X_VARIANTS[name][0] in X_EDITS:
            continue
        ms = ms_of(lambda: run(name, c0, r0))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base - ms:.4g} ms")
        print(line(f"the plan, {name}", ms) + more, flush=True)


def split_w(libs, card, dev, what, N, T, S):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = logz_cuda.logz_plan(N, T, S, torch.float32, sms, full=True)
    g = torch.Generator(device=dev).manual_seed(N + T + S)
    scores = 2 * torch.randn(N, T, 5 * S, device=dev, generator=g)
    old_stack, old_lz = logz_cuda.full_forward_old_kernel(scores)
    _, old_only = logz_cuda.full_forward_old_kernel(scores, with_stack=False)
    stack = torch.empty_like(old_stack)
    lz = torch.empty_like(old_lz)
    lz_only = torch.empty_like(old_lz)
    stream = torch.cuda.current_stream().cuda_stream

    def run(name, k, ring, with_stack=True):
        build.check(getattr(libs[name], W_ENTRY)(
            scores.data_ptr(), 1, 1, stack.data_ptr() if with_stack else None,
            (lz if with_stack else lz_only).data_ptr(), N, T, S, k, ring,
            stream), name)

    def same(name, k, ring):
        for x in (stack, lz, lz_only):
            x.fill_(float("nan"))
        run(name, k, ring)
        run(name, k, ring, with_stack=False)
        torch.cuda.synchronize()
        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in ((stack, old_stack), (lz, old_lz),
                                (lz_only, old_only)))

    def line(label, w, w_only):
        return (f"  {label}: W {w:.4g} ms ({w / T * 1e3:.4g} us a frame), "
                f"W without its stack {w_only:.4g} ms")

    k0, r0 = plan["states_per_thread"], plan["fwd"]["ring"]
    print(f"{card}; W at {what}: N={N}, T={T}, S={S}, f32, round_bf16; "
          f"plan {plan['fwd']}, {k0} states a thread", flush=True)
    print(line("the earlier kernel",
               ms_of(lambda: logz_cuda.full_forward_old_kernel(scores)),
               ms_of(lambda: logz_cuda.full_forward_old_kernel(
                   scores, with_stack=False))), flush=True)
    for k in (1, 4):
        if logz_cuda.ring_consumers(S, k) + 32 > logz_cuda.THREADS:
            continue
        ok = same("source", k, r0)
        print(line(f"the source, {k} states a thread (bits equal: {ok})",
                   ms_of(lambda: run("source", k, r0)),
                   ms_of(lambda: run("source", k, r0, False))), flush=True)
        if not ok:
            raise RuntimeError(f"logz_split: W at {k} states a thread "
                               f"disagrees with the earlier W at {what}")
    for ring in RINGS:
        if logz_cuda.logz_smem(S, ring, torch.float32, False, True) > 232448:
            continue
        ok = same("source", k0, ring)
        print(line(f"the source on a ring of {ring} (bits equal: {ok})",
                   ms_of(lambda: run("source", k0, ring)),
                   ms_of(lambda: run("source", k0, ring, False))), flush=True)
        if not ok:
            raise RuntimeError(f"logz_split: W on a ring of {ring} "
                               f"disagrees with the earlier W at {what}")
    base = None
    for name in W_VARIANTS:
        ms = (ms_of(lambda: run(name, k0, r0)),
              ms_of(lambda: run(name, k0, r0, False)))
        base = ms if base is None else base
        more = "" if name == "source" else (
            f"; the part(s) left out add {base[0] - ms[0]:.4g} and "
            f"{base[1] - ms[1]:.4g} ms")
        print(line(f"the plan, {name}", *ms) + more, flush=True)


def main():
    kernel = sys.argv[1] if len(sys.argv) > 1 else "uv"
    if kernel not in ("uv", "x", "w"):
        print("usage: logz_split.py [x | w]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("logz_split: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = torch.device("cuda")
    libs = build_variants(kernel)
    if kernel in ("x", "w"):
        for what, N, T, S in X_SHAPES:
            (split_x if kernel == "x" else split_w)(libs, card, dev, what, N,
                                                   T, S)
        return 0
    for what, N, T, S in SHAPES:
        split(libs, card, dev, what, N, T, S)
    return 0


if __name__ == "__main__":
    sys.exit(main())
