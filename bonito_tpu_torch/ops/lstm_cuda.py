"""
Kernel A — the LSTM recurrence (``csrc/lstm.cu``) — with its plain
PyTorch version and its launch count.

Replaces ``bonito_tpu/ops/lstm_pallas.py:lstm_pallas`` (``_lstm_kernel``).
On an H100 the recurrence is 2*N*H*4H*T tensor-core operations per layer
against ~1.6 GB of xw/h traffic at hac, but it is serial in T: what bounds
this first design is per-step latency (one launch per step; every block
re-reads W_hh and h_prev from L2). ``csrc/lstm.cu`` says how the kernel
is laid out and what its redesign is.

``lstm_recurrence`` runs the plain version for a tensor on the CPU and
the kernel for a tensor on the card; it never falls back from one to the
other.
"""

import torch

from bonito_tpu_torch.ops import build
from bonito_tpu_torch.ops.lstm_train_cuda import lstm_train_forward_plain

ROW_BLOCK = 32  # batch rows per CUDA block (RB in csrc/lstm.cu)


def lstm_recurrence_plain(xw, w_hh, reverse=False):
    """xw [T, N, 4H] in the model dtype, w_hh [H, 4H] -> h [T, N, H] in
    the model dtype. Each step: gates = f32(xw[t]) + f32(dtype(h) @ w_hh)
    (f32 accumulation), torch gate order (i, f, g, o); h and c are carried
    in f32. ``reverse`` walks t = T-1 .. 0 and writes each step at t. It is
    the h of kernel R's plain version, which keeps c and the gates too."""
    return lstm_train_forward_plain(xw, w_hh, reverse)[0]


def lstm_recurrence(xw, w_hh, reverse=False):
    """The recurrence of ``lstm_recurrence_plain``: the plain version for
    a CPU tensor, kernel A for a CUDA tensor (bf16 only)."""
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh, reverse=reverse)
    build.refuse_grad("A", [xw, w_hh], build.TRAIN_ROUTE)
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(f"kernel A needs xw and w_hh on one CUDA device, "
                         f"got {xw.device} and {w_hh.device}")
    if xw.dtype != torch.bfloat16 or w_hh.dtype != torch.bfloat16:
        raise TypeError(f"kernel A takes bf16 xw and w_hh (a half=True "
                        f"model), got {xw.dtype} and {w_hh.dtype}")
    T, N, G = xw.shape
    H = G // 4
    if G != 4 * H or H % 16 or tuple(w_hh.shape) != (H, 4 * H) or T < 1:
        raise ValueError(f"kernel A: xw {tuple(xw.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} need [T, N, 4H], [H, 4H] "
                         f"with H a multiple of 16")
    if not xw.is_contiguous():
        raise ValueError("kernel A: xw must be contiguous")
    w = w_hh.contiguous()
    if w.data_ptr() % 32:  # WMMA loads need 32-byte alignment
        w = w.clone()
    lib = build.library()
    Np = -(-N // ROW_BLOCK) * ROW_BLOCK
    out = torch.empty(T, N, H, dtype=xw.dtype, device=xw.device)
    hbuf = torch.zeros(2, Np, H, dtype=xw.dtype, device=xw.device)
    cbuf = torch.zeros(N, H, dtype=torch.float32, device=xw.device)
    lstm_recurrence.launches += 1
    build.check(lib.lstm_recurrence_bf16(
        xw.data_ptr(), w.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
        cbuf.data_ptr(), T, N, Np, H, int(bool(reverse)),
        build.stream_of(xw)), "lstm_recurrence_bf16")
    return out


lstm_recurrence.launches = 0
