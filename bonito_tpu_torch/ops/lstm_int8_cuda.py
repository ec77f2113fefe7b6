"""
Kernels D and E — the int8 LSTM layers (``csrc/lstm_int8.cu``) — with
their plain PyTorch versions and their launch counts.

D, ``lstm_int8_fused``, replaces ``bonito_tpu/ops/lstm_pallas.py:
lstm_pallas_int8_fused`` (``_lstm_kernel_int8_fused``): int8 input
projection and int8 recurrence in one kernel, from an int8 input stream,
with h carried and (``out_int8``) emitted as ``round(h * 127)``. E,
``lstm_int8_recurrence``, replaces ``lstm_pallas_int8``
(``_lstm_kernel_int8``): the int8 recurrence over a precomputed xw.

Both are time-major, like kernel A: x_q [T, N, C], xw [T, N, 4H], out
[T, N, H]. The plain versions do the same integer arithmetic step by step
(the int8 products as f64 matmuls, exact below 2**53, converted to f32 as
an int32 would be) and run for tensors on the CPU; a tensor on the card
launches the kernel or raises. ``csrc/lstm_int8.cu`` says how the kernels
are laid out and what bounds them.
"""

import torch

from bonito_tpu_torch.ops import build

ROW_BLOCKS = (48, 32)  # batch rows per CUDA block (RB in csrc/lstm_int8.cu)
TILE = 16       # C and H must be multiples of the WMMA tile


def fused_supported(C, H):
    """The shapes kernel D takes: int8 WMMA tiles need C and H to be
    multiples of 16 (rows of 16-byte multiples)."""
    return C % TILE == 0 and H % TILE == 0


def _row(v, G, device):
    """A [1, G] or [G] scale/bias row as a contiguous f32 [G] tensor."""
    v = v.to(device=device, dtype=torch.float32).reshape(-1).contiguous()
    if v.numel() != G:
        raise ValueError(f"expected {G} per-column values, got {v.numel()}")
    return v


def _gates_to_hc(gates, c):
    i, f, g, o = gates.chunk(4, dim=1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def _steps(T, reverse):
    return range(T - 1, -1, -1) if reverse else range(T)


def lstm_int8_fused_plain(x_q, w_ih_q, w_hh_q, ih_scales, scales, b,
                          reverse=False, out_int8=False):
    """x_q [T, N, C] int8; w_ih_q [C, 4H], w_hh_q [H, 4H] int8; ih_scales
    (the input's activation step folded in), scales, b: [4H] f32 (b may be
    None) -> [T, N, H] int8 ``round(h * 127)`` or bf16 h. Each step:
    xw = f32(x_q[t] @ w_ih_q) * ih_scales + b; gates = xw + f32(h_q @
    w_hh_q) * scales; torch gate order; c in f32; h_q starts at zero."""
    T, N, C = x_q.shape
    H = w_hh_q.shape[0]
    dev = x_q.device
    w_ih = w_ih_q.double()
    w_hh = w_hh_q.double()
    ihsc = _row(ih_scales, 4 * H, dev)
    sc = _row(scales, 4 * H, dev)
    bias = torch.zeros(4 * H, device=dev) if b is None else _row(b, 4 * H, dev)
    h_q = torch.zeros(N, H, dtype=torch.float64, device=dev)
    c = torch.zeros(N, H, dtype=torch.float32, device=dev)
    out = torch.empty(T, N, H, device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    for t in _steps(T, reverse):
        xw = torch.matmul(x_q[t].double(), w_ih).float() * ihsc + bias
        gates = xw + torch.matmul(h_q, w_hh).float() * sc
        h, c = _gates_to_hc(gates, c)
        h_r = torch.round(h * 127.0)
        out[t] = h_r.to(torch.int8) if out_int8 else h.to(torch.bfloat16)
        h_q = h_r.double()
    return out


def lstm_int8_recurrence_plain(xw, w_hh_q, scales, reverse=False):
    """xw [T, N, 4H] in the model dtype, w_hh_q [H, 4H] int8, scales [4H]
    f32 -> h [T, N, H] in xw's dtype. Each step: h_q = round(h * 127) from
    the f32 h carried; gates = f32(xw[t]) + f32(h_q @ w_hh_q) * scales."""
    T, N, G = xw.shape
    H = G // 4
    dev = xw.device
    w_hh = w_hh_q.double()
    sc = _row(scales, G, dev)
    h = torch.zeros(N, H, dtype=torch.float32, device=dev)
    c = torch.zeros(N, H, dtype=torch.float32, device=dev)
    out = torch.empty(T, N, H, dtype=xw.dtype, device=dev)
    for t in _steps(T, reverse):
        h_q = torch.round(h * 127.0).double()
        gates = xw[t].float() + torch.matmul(h_q, w_hh).float() * sc
        h, c = _gates_to_hc(gates, c)
        out[t] = h.to(xw.dtype)
    return out


def _check_int8(name, **tensors):
    for key, t in tensors.items():
        if t.dtype != torch.int8:
            raise TypeError(f"{name}: {key} must be int8, got {t.dtype}")


def _on_one_card(name, first, *others):
    if first.device.type != "cuda" or any(
            t.device != first.device for t in others):
        raise ValueError(f"{name} needs its tensors on one CUDA device, got "
                         f"{[str(t.device) for t in (first, *others)]}")


def padded_rows(N):
    """N rounded up to whole row blocks: the kernels tile 48 rows where
    that wastes none (hac's batch of 96), else 32."""
    wide, narrow = ROW_BLOCKS
    return N if N % wide == 0 else -(-N // narrow) * narrow


def _scratch(N, H, device):
    Np = padded_rows(N)
    hbuf = torch.zeros(2, Np, H, dtype=torch.int8, device=device)
    cbuf = torch.zeros(N, H, dtype=torch.float32, device=device)
    return Np, hbuf, cbuf


def lstm_int8_fused(x_q, w_ih_q, w_hh_q, ih_scales, scales, b,
                    reverse=False, out_int8=False):
    """``lstm_int8_fused_plain``'s function: the plain version for a CPU
    tensor, kernel D for a CUDA tensor (C and H multiples of 16)."""
    _check_int8("kernel D", x_q=x_q, w_ih_q=w_ih_q, w_hh_q=w_hh_q)
    if x_q.device.type == "cpu":
        return lstm_int8_fused_plain(x_q, w_ih_q, w_hh_q, ih_scales, scales,
                                     b, reverse=reverse, out_int8=out_int8)
    build.refuse_grad("D", [ih_scales, scales, b], build.NO_GRAD_ROUTE)
    _on_one_card("kernel D", x_q, w_ih_q, w_hh_q)
    T, N, C = x_q.shape
    H = w_hh_q.shape[0]
    if (tuple(w_ih_q.shape) != (C, 4 * H) or T < 1
            or tuple(w_hh_q.shape) != (H, 4 * H) or not fused_supported(C, H)):
        raise ValueError(
            f"kernel D: x_q {tuple(x_q.shape)}, w_ih_q {tuple(w_ih_q.shape)} "
            f"and w_hh_q {tuple(w_hh_q.shape)} need [T, N, C], [C, 4H], "
            f"[H, 4H] with C and H multiples of {TILE}")
    dev = x_q.device
    Np, hbuf, cbuf = _scratch(N, H, dev)
    if Np != N:  # the kernel reads whole row tiles of every step
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, Np - N))
    x_q = x_q.contiguous()
    # k-contiguous weights for the tiles' 32-bit loads (fresh, aligned copies)
    w_ih_t = w_ih_q.t().contiguous()
    w_hh_t = w_hh_q.t().contiguous()
    ihsc = _row(ih_scales, 4 * H, dev)
    sc = _row(scales, 4 * H, dev)
    bias = torch.zeros(4 * H, device=dev) if b is None else _row(b, 4 * H, dev)
    out = torch.empty(T, N, H, device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    lstm_int8_fused.launches += 1
    build.check(build.library().lstm_int8_fused(
        x_q.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(),
        ihsc.data_ptr(), sc.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(bool(out_int8)), hbuf.data_ptr(), cbuf.data_ptr(), T, N, Np, C,
        H, int(bool(reverse)), build.stream_of(x_q)), "lstm_int8_fused")
    return out


def lstm_int8_recurrence(xw, w_hh_q, scales, reverse=False):
    """``lstm_int8_recurrence_plain``'s function: the plain version for a
    CPU tensor, kernel E for a CUDA tensor (bf16 xw, H a multiple of 16)."""
    _check_int8("kernel E", w_hh_q=w_hh_q)
    if xw.device.type == "cpu":
        return lstm_int8_recurrence_plain(xw, w_hh_q, scales, reverse=reverse)
    build.refuse_grad("E", [xw, scales], build.NO_GRAD_ROUTE)
    _on_one_card("kernel E", xw, w_hh_q)
    if xw.dtype != torch.bfloat16:
        raise TypeError(f"kernel E takes a bf16 xw (a half=True model), got "
                        f"{xw.dtype}")
    T, N, G = xw.shape
    H = G // 4
    if G != 4 * H or H % TILE or tuple(w_hh_q.shape) != (H, G) or T < 1:
        raise ValueError(f"kernel E: xw {tuple(xw.shape)} and w_hh_q "
                         f"{tuple(w_hh_q.shape)} need [T, N, 4H], [H, 4H] "
                         f"with H a multiple of {TILE}")
    if not xw.is_contiguous():
        raise ValueError("kernel E: xw must be contiguous")
    dev = xw.device
    Np, hbuf, cbuf = _scratch(N, H, dev)
    w_hh_t = w_hh_q.t().contiguous()
    sc = _row(scales, G, dev)
    out = torch.empty(T, N, H, dtype=torch.bfloat16, device=dev)
    lstm_int8_recurrence.launches += 1
    build.check(build.library().lstm_int8_recurrence(
        xw.data_ptr(), w_hh_t.data_ptr(), sc.data_ptr(), out.data_ptr(),
        hbuf.data_ptr(), cbuf.data_ptr(), T, N, Np, H, int(bool(reverse)),
        build.stream_of(xw)), "lstm_int8_recurrence")
    return out


lstm_int8_fused.launches = 0
lstm_int8_recurrence.launches = 0
