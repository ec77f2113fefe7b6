"""
Builds the hand-written Hopper kernels in ``csrc/*.cu`` (with the headers
``csrc/*.cuh`` they include) into one shared library with a plain C
interface and loads it with ctypes.

Each source compiles in its own ``nvcc`` process, all started together,
for sm_90a (``wgmma``/``setmaxnreg`` exist only for the ``a`` target);
the objects link into ``build/libbonito_tpu_torch-<hash>.so``, named by
the sources' content hash so a stale build never loads. ``-Xptxas -v``
reports each kernel's registers, shared memory and spills into
``ptxas_report``. The build happens at first use, never at import, and
a failure raises: there is no fallback to the plain versions.

Every C entry point takes device pointers and the CUDA stream as
``void*`` and returns the ``cudaError_t`` of its launches;
``check(rc, name)`` raises when that is not 0.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD = PACKAGE / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-O3", "-std=c++17", "-Xcompiler", "-fPIC"]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
L = ctypes.c_longlong
LP = ctypes.POINTER(ctypes.c_longlong)  # a host array of 64-bit integers
IP = ctypes.POINTER(ctypes.c_int)  # a host int the C function writes

# C entry points: name -> argtypes (restype is int, the cudaError_t)
SIGNATURES = {
    # xw, w_hh, out, hbuf, cbuf, T, N, Np, H, reverse, stream
    "lstm_recurrence_bf16": [P, P, P, P, P, I, I, I, I, I, P],
    # kernel A's earlier f32 kernel (R's f32 step kernel): as
    # lstm_recurrence_bf16, all in f32
    "lstm_recurrence_f32": [P, P, P, P, P, I, I, I, I, I, P],
    # kernel A in f32, persistent (csrc/lstm_f32.cu): xw, whh, out, hbuf,
    # flag, T, N, n0, rows, H, R, ks, kc, stages, reverse, stream
    "lstm_recurrence_f32_persistent": [P, P, P, P, P, I, I, I, I, I, I, I, I,
                                       I, I, P],
    # xw, wt, out, hbuf, flags, T, N, n0, rows, H, mt, slices, kc, stages,
    # cluster, reverse, stream
    "lstm_recurrence_persistent": [P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                                   I, I, P],
    # x_q, w_ih_q^T, w_hh_q^T, ih_scales, scales, b, out, out_int8, hbuf,
    # cbuf, T, N, Np, C, H, reverse, stream
    "lstm_int8_fused": [P, P, P, P, P, P, P, I, P, P, I, I, I, I, I, I, P],
    # xw, w_hh_q^T, scales, out, hbuf, cbuf, T, N, Np, H, reverse, stream
    "lstm_int8_recurrence": [P, P, P, P, P, P, I, I, I, I, I, P],
    # x_q, w_ih_q^T, w_hh_q^T, ih_scales, scales, b, out, out_int8, hbuf,
    # flags, T, N, n0, rows, C, H, mt, slices, kc, stages, cluster, reverse,
    # stream
    "lstm_int8_fused_persistent": [P, P, P, P, P, P, P, I, P, P, I, I, I, I,
                                   I, I, I, I, I, I, I, I, P],
    # xw, w_hh_q^T, scales, out, hbuf, flags, T, N, n0, rows, H, mt, slices,
    # kc, stages, cluster, reverse, stream
    "lstm_int8_recurrence_persistent": [P, P, P, P, P, P, I, I, I, I, I, I, I,
                                        I, I, I, I, P],
    # x, w_ih, w_hh, bias, out, T, N, C, H, reverse, stream
    "lstm_fused_bf16": [P, P, P, P, P, I, I, I, I, I, P],
    # kernel F on its mma kernel: as F
    "lstm_fused_mma": [P, P, P, P, P, I, I, I, I, I, P],
    # kernel F's earlier f32 kernel (csrc/lstm_fused.cu): as F, all in f32,
    # with whh_in_registers, wih_in_smem, smem
    "lstm_fused_f32": [P, P, P, P, P, I, I, I, I, I, I, I, I, P],
    # kernel F in f32 (csrc/lstm_f32.cu): x, wih, whh, bias, out, T, N, C,
    # H, reverse, rows, block, whh_in_registers, wih_in_smem, smem, stream
    "lstm_fused_f32_rows": [P, P, P, P, P, I, I, I, I, I, I, I, I, I, I, P],
    # moves, move_in, choices, c, logz, end_state, N, T, S, p_stay,
    # blank, stream
    "decode_tcn_fwd_bf16": [P, P, P, P, P, P, I, I, I, F, F, P],
    # moves, move_in, choices, c, logz, end_state, sequence, qstring,
    # moves_out, N, T, S, p_stay, qscale, qbias, stream
    "decode_tcn_bwd_bf16": [P, P, P, P, P, P, P, P, P, I, I, I, F, F, F, P],
    # the same on f32 moves
    "decode_tcn_fwd_f32": [P, P, P, P, P, P, I, I, I, F, F, P],
    "decode_tcn_bwd_f32": [P, P, P, P, P, P, P, P, P, I, I, I, F, F, F, P],
    # kernels B and C on a ring of frames (csrc/decode_tcn_ring.cu): as the
    # two above, with the ring's depth after S
    "decode_tcn_fwd_ring": [P, P, P, P, P, P, I, I, I, I, F, F, P],
    "decode_tcn_bwd_ring": [P, P, P, P, P, P, P, P, P, I, I, I, I, F, F, F,
                            P],
    # the same on f32 moves: GW's forward pass and kernel JW
    "decode_tcn_fwd_ring_f32": [P, P, P, P, P, P, I, I, I, I, F, F, P],
    "decode_tcn_bwd_ring_f32": [P, P, P, P, P, P, P, P, P, I, I, I, I, F, F,
                                F, P],
    # GW's head product (csrc/head_product.cu): h, wT, bias, out, Th, N, H,
    # cols, ctas, act_tanh, scale, clamp, cmin, cmax, stream
    "head_product_wide": [P, P, P, P, I, I, I, I, I, I, F, I, F, F, P],
    # scores, is_f32, reverse, move_in, choices, c, logz, end_state, N, T,
    # S, stream
    "decode_full_fwd": [P, I, I, P, P, P, P, P, I, I, I, P],
    # scores, is_f32, reverse, move_in, choices, c, logz, end_state,
    # sequence, qstring, moves_out, N, T, S, qscale, qbias, stream
    "decode_full_bwd": [P, I, I, P, P, P, P, P, P, P, P, I, I, I, F, F, P],
    # kernels M and Q on a ring of frames (csrc/decode_full.cu with
    # csrc/decode_ring.cuh): as the two above, with the ring's depth after S
    "decode_full_fwd_ring": [P, I, I, P, P, P, P, P, I, I, I, I, P],
    "decode_full_bwd_ring": [P, I, I, P, P, P, P, P, P, P, P, I, I, I, I, F,
                             F, P],
    # h, w, bias, move_in, choices, c, logz, end_state, Th, N, H, S, U,
    # p_stay, blank, act_tanh, scale, clamp, cmin, cmax, stream
    "decode_fused_fwd_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, I, F, F,
                              I, F, I, F, F, P],
    # h, w, bias, move_in, choices, c, logz, end_state, sequence, qstring,
    # moves_out, Th, N, H, S, U, p_stay, qscale, qbias, act_tanh, scale,
    # clamp, cmin, cmax, stream
    "decode_fused_bwd_bf16": [P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                              F, F, F, I, F, I, F, F, P],
    # kernel G on its ring: as G, with the ring's depth after U
    "decode_fused_fwd_ring_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                                   F, F, I, F, I, F, F, P],
    # kernel J on its ring: as J, with the ring's depth after U
    "decode_fused_bwd_ring_bf16": [P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                   I, I, I, F, F, F, I, F, I, F, F, P],
    # the earlier GW and JW: as G and J, the weights laid out k-major
    "decode_fused_wide_fwd_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, I, F,
                                   F, I, F, I, F, F, P],
    "decode_fused_wide_bwd_bf16": [P, P, P, P, P, P, P, P, P, P, P, I, I, I,
                                   I, I, F, F, F, I, F, I, F, F, P],
    # qkv, cos, sin, out, N, T, H, D, r2, left, right, t_real, is_f32, stream
    "fused_rotary_window_attention": [P, P, P, P, I, I, I, I, I, I, I, I, I,
                                      P],
    # qkv, cos, sin, out, lse, N, T, H, D, r2, left, right, t_real, is_f32,
    # stream
    "fused_rotary_window_attention_lse": [P, P, P, P, P, I, I, I, I, I, I, I,
                                          I, I, P],
    # qkv, cos, sin, out, lse (or null), N, T, H, D, r2, left, right, t_real,
    # stretch, ring, is_f32, stream
    "fused_rotary_window_attention_stretch": [P, P, P, P, P, I, I, I, I, I,
                                              I, I, I, I, I, I, P],
    # qkv, cos, sin, lse, o, dout, dqkv, N, T, H, D, r2, left, right, t_real,
    # is_f32, stream
    "fused_rotary_window_attention_bwd": [P, P, P, P, P, P, P, I, I, I, I, I,
                                          I, I, I, I, P],
    # qkv, cos, sin, lse, o, dout, rows, dqkv, N, T, H, D, r2, left, right,
    # t_real, stretch, ring, stream
    "fused_rotary_window_attention_bwd_stretch": [P, P, P, P, P, P, P, P, I,
                                                  I, I, I, I, I, I, I, I, I,
                                                  P],
    # q, k, v, out, strides[12], N, H, T, D, dp, left, right, is_f32, stream
    "local_attention": [P, P, P, P, LP, I, I, I, I, I, I, I, I, P],
    # in, out, nd, sizes[nd], strides[nd], unit, stream
    "relayout_gather_any": [P, P, I, LP, LP, I, P],
    # the earlier tile transpose (16-byte rows): in, out, B, R, C, sb, sc,
    # unit, stream
    "relayout_transpose_any": [P, P, L, I, I, L, L, I, P],
    # the tile transpose at any shape and start: as the one above
    "relayout_transpose_tiles_any": [P, P, L, I, I, L, L, I, P],
    # scores, is_f32, is_full, round, stack (or null), logz, N, T, S,
    # blank, stream
    "logz_fwd": [P, I, I, I, P, P, I, I, I, F, P],
    # scores, is_f32, is_full, round, stack, logz, g, grad, out_f32, N, T,
    # S, blank, stream
    "logz_bwd": [P, I, I, I, P, P, P, P, I, I, I, I, F, P],
    # kernels U and V on a ring of frames (csrc/logz_ring.cu): moves,
    # is_f32, round, stack (or null), logz, N, T, S, states a thread, ring,
    # blank, stream
    "logz_tcn_fwd_ring": [P, I, I, P, P, I, I, I, I, I, F, P],
    # moves, is_f32, round, stack, logz, g, grad, out_f32, N, T, S, states a
    # thread, ring, blank, stream
    "logz_tcn_bwd_ring": [P, I, I, P, P, P, P, I, I, I, I, I, I, F, P],
    # kernel W on a ring of frames: scores, is_f32, round, stack (or null),
    # logz, N, T, S, states a thread, ring, stream
    "logz_full_fwd_ring": [P, I, I, P, P, I, I, I, I, I, P],
    # kernel X on a ring of frames: scores, is_f32, round, stack, logz, g,
    # grad, out_f32, N, T, S, states a thread, consumer threads, ring,
    # stream
    "logz_full_bwd_ring": [P, I, I, P, P, P, P, I, I, I, I, I, I, I, P],
    # move, lengths, stack (or null), logz, N, T, P, blank, stream
    "lattice_fwd": [P, P, P, P, I, I, I, F, P],
    # move, stack, lengths, log|g| - logz, sign(g), dmove, N, T, P, blank,
    # stream
    "lattice_bwd": [P, P, P, P, P, P, I, I, I, F, P],
    # kernel Y split over warps: as lattice_fwd, with positions a thread and
    # the prefetch depth after P
    "lattice_fwd_split": [P, P, P, P, I, I, I, I, I, F, P],
    # kernel Z split over warps: as lattice_bwd, with positions a thread and
    # the prefetch depth after P
    "lattice_bwd_split": [P, P, P, P, P, P, I, I, I, I, I, F, P],
    # xw, w_hh, h, c, acts, hbuf, cbuf, is_f32, round_bf16, T, N, Np, H,
    # reverse, stream
    "lstm_train_fwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # w_hh, acts, c, g_h, dgates, dgbuf, dcbuf, is_f32, round_bf16, T, N, Np,
    # H, reverse, stream
    "lstm_train_bwd": [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P],
    # xw, wt, h, c, acts, hbuf, flags, T, N, n0, rows, H, mt, slices, kc,
    # stages, cluster, reverse, stream
    "lstm_train_fwd_persistent": [P, P, P, P, P, P, P, I, I, I, I, I, I, I,
                                  I, I, I, I, P],
    # w_hh, acts, c, g_h, dgates, flags, T, N, n0, rows, H, mt, slices,
    # cluster, stages, reverse, stream
    "lstm_train_bwd_persistent": [P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                                  I, I, P],
    # cluster, &clusters
    "lstm_train_bwd_clusters": [I, IP],
    # kernel R in f32 (csrc/lstm_f32.cu): xw, whh, h, c, acts, hbuf, flag,
    # T, N, n0, rows, H, R, ks, kc, stages, round_bf16, reverse, stream
    "lstm_train_fwd_f32_persistent": [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                      I, I, I, I, I, P],
    # kernel S in f32 (csrc/lstm_f32.cu): whh, acts, c, g_h, dgates, gbuf,
    # flag, T, N, n0, rows, H, R, ks, kc, stages, round_bf16, reverse,
    # stream
    "lstm_train_bwd_f32_persistent": [P, P, P, P, P, P, P, I, I, I, I, I, I,
                                      I, I, I, I, I, P],
}

ptxas_report = ""  # nvcc -Xptxas -v output of the library's build
_lib = None
_lock = threading.Lock()


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest():
    h = hashlib.sha1()
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(ARCH + FLAGS).encode())
    return h.hexdigest()[:12]


def _run(procs):
    failed, logs = [], []
    for src, proc in procs:
        out, err = proc.communicate()
        logs.append(f"== {src.name}\n{out}{err}")
        if proc.returncode != 0:
            failed.append(src.name)
    return failed, "\n".join(logs)


def build():
    """Compile and link the library if this source tree has not been;
    returns its path."""
    global ptxas_report
    sources = _sources()
    digest = _digest()
    lib = BUILD / f"libbonito_tpu_torch-{digest}.so"
    report = lib.with_suffix(".ptxas.txt")
    if lib.exists():
        ptxas_report = report.read_text() if report.exists() else ""
        return lib
    nvcc = _nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}-{threading.get_ident()}"
    objs = [BUILD / f"{src.stem}-{digest}-{tag}.o" for src in sources]
    procs = [(src, subprocess.Popen(
        [nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-c",
         str(src), "-o", str(obj)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for src, obj in zip(sources, objs)]
    failed, log = _run(procs)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
    ptxas_report = log
    report.write_text(log)
    tmp = BUILD / f"{lib.name}.{tag}.tmp"
    link = subprocess.run(
        [nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)],
        capture_output=True, text=True)
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    return lib


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc, name):
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {rc}")


# what ``refuse_grad`` names in place of an inference-only kernel
TRAIN_ROUTE = ("an LSTM trains through ops.lstm.lstm_train (kernels R and S), "
               "which model.train() selects")
NO_GRAD_ROUTE = "an int8 model does not train: run it under torch.no_grad()"
DECODE_ROUTE = "a decode has no gradient: run it under torch.no_grad()"


def refuse_grad(name, tensors, route):
    """A kernel writes into memory that autograd does not see, so its result
    would carry no gradient back to ``tensors``: raise where one is wanted
    (grad mode on and a tensor that requires grad). ``route`` names what to
    call instead."""
    import torch
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"kernel {name} keeps no autograd graph, and a gradient is "
            f"wanted through its input: {route}")


def stream_of(tensor):
    """The current torch stream on ``tensor``'s device, as a ctypes pointer."""
    import torch
    return torch.cuda.current_stream(tensor.device).cuda_stream
