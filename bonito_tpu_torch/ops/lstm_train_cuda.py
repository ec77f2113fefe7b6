"""
Kernels R and S — the LSTM recurrence of a training step and its backward
through time (``csrc/lstm_train.cu``) — with their plain PyTorch versions
and their launch counts.

R replaces ``bonito_tpu/ops/lstm_pallas.py:_lstm_train_fwd_kernel`` and S
``_lstm_train_bwd_kernel`` (``lstm_pallas_train`` via ``_lstm_rec``). R is
kernel A's recurrence that also keeps what S needs: the cell state c and
the post-activation gates. S walks the recurrence's steps last to first and
writes the gradient of the gates; ``ops.lstm.lstm_train`` forms dW_hh and
the projection's gradients from it with torch.matmul. Each is 2*N*H*4H*T
tensor-core operations per layer, serial in T: one launch per step, so
per-step latency bounds this first design, as it bounds A.

``round_bf16`` stores c, the gates and their gradient in bf16, as
bonito_tpu's kernels do; without it they stay f32 (where bonito_tpu's
gate sends a shape to its scan instead). The wrappers run the plain
version for a tensor on the CPU and the kernel for a tensor on the card
(xw and W_hh both bf16, or both f32 for training without amp; H a multiple
of 16); they never fall back from one to the other.
"""

import torch

from bonito_tpu_torch.ops import build

ROW_BLOCK = 32  # batch rows per CUDA block (RB in csrc/lstm_train.cu)


def _store(round_bf16):
    return torch.bfloat16 if round_bf16 else torch.float32


def lstm_train_forward_plain(xw, w_hh, reverse=False, round_bf16=True):
    """xw [T, N, 4H] in the model dtype, w_hh [H, 4H] -> (h [T, N, H] in
    the model dtype, c [T, N, H] and the activations [i, f, g, o] [T, N,
    4H], both bf16 with ``round_bf16`` else f32). Each step as kernel A's
    plain version: gates = f32(xw[t]) + f32(dtype(h) @ w_hh), h and c
    carried in f32; ``reverse`` walks t = T-1 .. 0, writing each step at t."""
    T, N, G = xw.shape
    H = G // 4
    dtype, store = xw.dtype, _store(round_bf16)
    w = w_hh.to(dtype).float()
    h = torch.zeros(N, H, dtype=torch.float32, device=xw.device)
    c = torch.zeros(N, H, dtype=torch.float32, device=xw.device)
    hs = torch.empty(T, N, H, dtype=dtype, device=xw.device)
    cs = torch.empty(T, N, H, dtype=store, device=xw.device)
    acts = torch.empty(T, N, G, dtype=store, device=xw.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[t].float() + torch.matmul(h.to(dtype).float(), w)
        i = torch.sigmoid(gates[:, :H])
        f = torch.sigmoid(gates[:, H:2 * H])
        g = torch.tanh(gates[:, 2 * H:3 * H])
        o = torch.sigmoid(gates[:, 3 * H:])
        c = f * c + i * g
        h = o * torch.tanh(c)
        hs[t] = h.to(dtype)
        cs[t] = c.to(store)
        acts[t] = torch.cat([i, f, g, o], dim=1).to(store)
    return hs, cs, acts


def lstm_train_backward_plain(w_hh, acts, c, g_h, reverse=False,
                              round_bf16=True):
    """The gradient of the gates [T, N, 4H] (bf16 with ``round_bf16`` else
    f32) from R's acts and c and the gradient of h, g_h [T, N, H]. dh and
    dc are carried in f32; the next dh is dtype(dgates) @ w_hh^T with f32
    sums, dtype that of w_hh (the model's)."""
    T, N, G = acts.shape
    H = G // 4
    store = _store(round_bf16)
    w = w_hh.float()
    dgates = torch.empty(T, N, G, dtype=store, device=acts.device)
    dh = torch.zeros(N, H, dtype=torch.float32, device=acts.device)
    dc = torch.zeros(N, H, dtype=torch.float32, device=acts.device)
    zero = torch.zeros(N, H, dtype=torch.float32, device=acts.device)
    steps = range(T) if reverse else range(T - 1, -1, -1)
    for j, t in enumerate(steps):
        a = acts[t].float()
        i, f, g, o = (a[:, q * H:(q + 1) * H] for q in range(4))
        tc = torch.tanh(c[t].float())
        cp = zero if j == T - 1 else c[t + 1 if reverse else t - 1].float()
        dh = dh + g_h[t].float()
        do = dh * tc
        dc = dc + dh * o * (1.0 - tc * tc)
        d = torch.cat([dc * g * i * (1.0 - i), dc * cp * f * (1.0 - f),
                       dc * i * (1.0 - g * g), do * o * (1.0 - o)], dim=1)
        dgates[t] = d.to(store)
        dh = torch.matmul(d.to(w_hh.dtype).float(), w.t())
        dc = dc * f
    return dgates


def _check(name, w_hh, **tensors):
    """(T, N, H) of the tensors kernel ``name`` takes: W_hh [H, 4H] in bf16
    or f32 (H a multiple of 16) and contiguous tensors of the given shapes
    and types on the same CUDA device."""
    dev = w_hh.device
    if dev.type != "cuda":
        raise ValueError(f"kernel {name} needs CUDA tensors, got {dev}")
    if w_hh.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"kernel {name} takes bf16 or f32 tensors, got W_hh "
                        f"in {w_hh.dtype}")
    H = w_hh.shape[0]
    if tuple(w_hh.shape) != (H, 4 * H) or H % 16 or H == 0:
        raise ValueError(f"kernel {name}: W_hh {tuple(w_hh.shape)} needs "
                         f"[H, 4H] with H a multiple of 16")
    T = N = None
    for key, (x, dtypes, width) in tensors.items():
        if x.dim() != 3 or x.shape[2] != width or x.dtype not in dtypes:
            raise ValueError(f"kernel {name}: {key} {tuple(x.shape)} "
                             f"{x.dtype} needs [T, N, {width}] in {dtypes}")
        T, N = (x.shape[0], x.shape[1]) if T is None else (T, N)
        if tuple(x.shape[:2]) != (T, N) or T < 1 or N < 1:
            raise ValueError(f"kernel {name}: {key} {tuple(x.shape)} does "
                             f"not match [T, N] = {(T, N)}")
        if x.device != dev or not x.is_contiguous():
            raise ValueError(f"kernel {name}: {key} must be contiguous on "
                             f"{dev}")
    return T, N, H


def _weights(w_hh):
    w = w_hh.contiguous()
    return w.clone() if w.data_ptr() % 32 else w  # WMMA loads: 32 bytes


def lstm_train_forward(xw, w_hh, reverse=False, round_bf16=True):
    """R: ``lstm_train_forward_plain`` for CPU tensors, the kernel for
    CUDA ones."""
    if xw.device.type == "cpu":
        return lstm_train_forward_plain(xw, w_hh, reverse, round_bf16)
    G, io = 4 * w_hh.shape[0], w_hh.dtype
    T, N, H = _check("R", w_hh, xw=(xw, (io,), G))
    lib = build.library()
    dev, store = xw.device, _store(round_bf16)
    Np = -(-N // ROW_BLOCK) * ROW_BLOCK
    h = torch.empty(T, N, H, dtype=io, device=dev)
    c = torch.empty(T, N, H, dtype=store, device=dev)
    acts = torch.empty(T, N, G, dtype=store, device=dev)
    hbuf = torch.zeros(2, Np, H, dtype=io, device=dev)
    cbuf = torch.zeros(N, H, dtype=torch.float32, device=dev)
    lstm_train_forward.launches += 1
    build.check(lib.lstm_train_fwd(
        xw.data_ptr(), _weights(w_hh).data_ptr(), h.data_ptr(), c.data_ptr(),
        acts.data_ptr(), hbuf.data_ptr(), cbuf.data_ptr(),
        int(io == torch.float32), int(round_bf16), T, N, Np, H,
        int(bool(reverse)), build.stream_of(xw)), "lstm_train_fwd")
    return h, c, acts


def lstm_train_backward(w_hh, acts, c, g_h, reverse=False, round_bf16=True):
    """S: ``lstm_train_backward_plain`` for CPU tensors, the kernel for
    CUDA ones."""
    if acts.device.type == "cpu":
        return lstm_train_backward_plain(w_hh, acts, c, g_h, reverse,
                                         round_bf16)
    store, io = _store(round_bf16), w_hh.dtype
    H = w_hh.shape[0]
    T, N, _ = _check("S", w_hh, acts=(acts, (store,), 4 * H),
                     c=(c, (store,), H), g_h=(g_h, (io,), H))
    lib = build.library()
    dev = acts.device
    Np = -(-N // ROW_BLOCK) * ROW_BLOCK
    dgates = torch.empty(T, N, 4 * H, dtype=store, device=dev)
    dgbuf = torch.zeros(2, Np, 4 * H, dtype=io, device=dev)
    dcbuf = torch.zeros(N, H, dtype=torch.float32, device=dev)
    lstm_train_backward.launches += 1
    build.check(lib.lstm_train_bwd(
        _weights(w_hh).data_ptr(), acts.data_ptr(), c.data_ptr(),
        g_h.data_ptr(), dgates.data_ptr(), dgbuf.data_ptr(),
        dcbuf.data_ptr(), int(io == torch.float32), int(round_bf16), T, N, Np,
        H, int(bool(reverse)), build.stream_of(acts)), "lstm_train_bwd")
    return dgates


lstm_train_forward.launches = 0
lstm_train_backward.launches = 0
