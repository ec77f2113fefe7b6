"""
Kernels D and E — the int8 LSTM layers (``csrc/lstm_int8.cu``) — with
their plain PyTorch versions, their launch counts and their shape rule.

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
launches the kernel or raises.

On the card each is a persistent kernel: one cooperative launch walks
the whole layer, each CTA holding its slice of W_hh_q in shared memory
(and D its slice of W_ih_q in registers), the CTAs of a row slice meeting
once a step. The shape rule, ``persistent_plan(N, C, H, sms, fused)``, is
pure Python: rows per CTA, row slices, the ring of h chunks, whether two
CTAs share each load of h, the staging of x and the number of launches
(row groups), or None where the slices cannot stay resident; then the
step kernel runs, one launch per timestep from one C call. Each C call
counts one launch: a row group's persistent launch, or the step kernel's
call. The two give the same output bit for bit. ``csrc/lstm_int8.cu``
says how the kernels are laid out and what bounds them.
"""

import torch

from bonito_tpu_torch.ops import build

ROW_BLOCKS = (48, 32)  # batch rows per block of the step kernel (RB)
TILE = 16       # C and H must be multiples of the WMMA tile
# the persistent kernel (csrc/lstm_int8.cu: lstm_int8_persistent)
UNITS = 16      # hidden units per CTA (PU)
MAX_ROWS = 64   # batch rows per CTA: four m-tiles of 16
K_STEP = 32     # k of one int8 product (m16n8k32): C and H multiples of it
MAX_KC = 1024   # the widest k-chunk of h, bytes
MAX_C = 1024    # D: W_ih's slice in registers, 8 k-steps a warp at most
K_SLICES = 4    # k-slices, a slot of int32 partial sums each (PKS)
PAD = 16        # bytes of padding per shared int8 row
LDP = 72        # int32 partial sums per row: 64 gate columns + 8 (LDP)
SMEM_LIMIT = 232448  # 227 KB, the most a block may ask for


def _cdiv(a, b):
    return -(-a // b)


def fused_supported(C, H):
    """The shapes kernel D takes: int8 WMMA tiles need C and H to be
    multiples of 16 (rows of 16-byte multiples)."""
    return C % TILE == 0 and H % TILE == 0


def smem_bytes(C, H, rows, kc, stages, fused=True):
    """Shared memory of one CTA: W_hh_q's slice (4 x UNITS columns of H
    bytes), the ring of h chunks under the h product's int32 partial sums,
    in D x's rows of one step and the x product's partial sums, and an
    mbarrier per ring stage plus D's one for x."""
    part = K_SLICES * rows * LDP * 4
    w = 4 * UNITS * (H + PAD)
    ring = max(stages * rows * (kc + PAD), part)
    x = rows * (C + PAD) + part if fused else 0
    return w + ring + x + 8 * (stages + (1 if fused else 0))


def persistent_plan(N, C, H, sms, fused=True):
    """The persistent kernel's plan for N batch rows, C input and H hidden
    units on a card of ``sms`` SMs: kernel D's with ``fused``, else E's
    (which has no input product: C is not read). None where the slices
    cannot stay resident: C or H not a multiple of 32 (the k of one int8
    product), D's C above 1024 (W_ih_q's slice leaves the registers), H /
    16 CTAs beyond the SMs, or the shared memory exceeded. Then the step
    kernel runs.

    A CTA owns 16 units and one slice of ``rows`` batch rows (16 to 64);
    a launch has H / 16 x ``slices`` CTAs, at most one an SM, and covers
    ``n_launch`` batch rows; ``launches`` row groups cover N. Rows are
    spread evenly. The ring of h chunks takes the widest k-chunk that
    fits (H itself at hac: one bulk copy a row). Where the ring holds all
    of a step's chunks (``stages`` of them) and H / 16 is even,
    ``cluster`` is 2: the CTAs of two neighbouring unit blocks share each
    load of h, and in D of x (bulk copies multicast to both); else each
    CTA loads its own through 2 to 8 stages. In D, ``x_bytes`` holds x's
    rows of one step (staged whole, a step ahead) and the x product's
    partial sums. The kernel launches exactly this plan, or fails where
    the card cannot hold its grid."""
    if N < 1 or H < 16 or H % 16 or (fused and (C is None or C < 16
                                                 or C % 16)):
        raise ValueError(f"kernels D and E: N {N}, C {C} and H {H}: N >= 1, "
                         f"C (D) and H multiples of 16")
    g_u = H // UNITS
    if H % K_STEP or g_u > sms or (fused and (C % K_STEP or C > MAX_C)):
        return None
    C = C if fused else 0
    # k-chunks: H cut into chunks of a multiple of 32 bytes, at most 1024
    # wide, the widest first (bulk copies cost by count, not bytes)
    kcs = [H // n for n in range(1, H // K_STEP + 1)
           if H % n == 0 and (H // n) % K_STEP == 0 and H // n <= MAX_KC]
    slices_max = sms // g_u
    for rows_max in range(MAX_ROWS, 0, -16):
        launches = _cdiv(N, slices_max * rows_max)
        n_launch = _cdiv(N, launches)
        slices = min(slices_max, _cdiv(n_launch, 16))
        rows = _cdiv(_cdiv(n_launch, slices), 16) * 16
        slices = _cdiv(n_launch, rows)
        for kc in kcs:
            # a ring of the whole step, shared by pairs (H / 16 is even);
            # else 2 to 8 stages, each CTA loading its own
            whole = H // kc
            rings = ([(whole, 2)] if g_u % 2 == 0 and whole <= 8 else []) + [
                (st, 1) for st in range(min(8, max(whole, 2)), 1, -1)]
            for stages, cluster in rings:
                smem = smem_bytes(C, H, rows, kc, stages, fused)
                if smem <= SMEM_LIMIT:
                    return {"units": UNITS, "unit_blocks": g_u,
                            "rows": rows, "slices": slices,
                            "ctas": g_u * slices, "n_launch": n_launch,
                            "launches": launches, "kc": kc,
                            "stages": stages, "cluster": cluster,
                            "x_bytes": (rows * (C + PAD)
                                        + K_SLICES * rows * LDP * 4
                                        if fused else 0),
                            "smem": smem}
    return None


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


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fused_operands(x_q, w_ih_q, w_hh_q, ih_scales, scales, b):
    """Kernel D's checks, and its operands as the kernels read them."""
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
    # k-contiguous weights for the tiles' loads (fresh, aligned copies)
    return (x_q.contiguous(), w_ih_q.t().contiguous(),
            w_hh_q.t().contiguous(), _row(ih_scales, 4 * H, dev),
            _row(scales, 4 * H, dev),
            torch.zeros(4 * H, device=dev) if b is None
            else _row(b, 4 * H, dev))


def _recurrence_operands(xw, w_hh_q, scales):
    """Kernel E's checks, and its operands as the kernels read them."""
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
    return xw, w_hh_q.t().contiguous(), _row(scales, G, xw.device)


def _fused_step(x_q, w_ih_t, w_hh_t, ihsc, sc, bias, reverse, out_int8):
    T, N, C = x_q.shape
    H = w_hh_t.shape[1]
    dev = x_q.device
    Np, hbuf, cbuf = _scratch(N, H, dev)
    if Np != N:  # the step kernel reads whole row tiles of every step
        x_q = torch.nn.functional.pad(x_q, (0, 0, 0, Np - N)).contiguous()
    out = torch.empty(T, N, H, device=dev,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    build.check(build.library().lstm_int8_fused(
        x_q.data_ptr(), w_ih_t.data_ptr(), w_hh_t.data_ptr(),
        ihsc.data_ptr(), sc.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(bool(out_int8)), hbuf.data_ptr(), cbuf.data_ptr(), T, N, Np, C,
        H, int(bool(reverse)), build.stream_of(x_q)), "lstm_int8_fused")
    return out


def _recurrence_step(xw, w_hh_t, sc, reverse):
    T, N, G = xw.shape
    H = G // 4
    Np, hbuf, cbuf = _scratch(N, H, xw.device)
    out = torch.empty(T, N, H, dtype=torch.bfloat16, device=xw.device)
    build.check(build.library().lstm_int8_recurrence(
        xw.data_ptr(), w_hh_t.data_ptr(), sc.data_ptr(), out.data_ptr(),
        hbuf.data_ptr(), cbuf.data_ptr(), T, N, Np, H, int(bool(reverse)),
        build.stream_of(xw)), "lstm_int8_recurrence")
    return out


def _row_groups(plan, N, H, device):
    """The persistent launches' row groups (n0, rows) and their scratch:
    h_q's ping-pong planes and the row slices' counters, zeroed before
    each launch."""
    hbuf = torch.empty(2, plan["slices"] * plan["rows"], H, dtype=torch.int8,
                       device=device)
    flags = torch.empty(plan["slices"], dtype=torch.int32, device=device)
    for n0 in range(0, N, plan["n_launch"]):
        hbuf.zero_()
        flags.zero_()
        yield n0, min(plan["n_launch"], N - n0), hbuf, flags


def _plan_args(plan):
    return (plan["rows"] // 16, plan["slices"], plan["kc"], plan["stages"],
            plan["cluster"])


def lstm_int8_fused(x_q, w_ih_q, w_hh_q, ih_scales, scales, b,
                    reverse=False, out_int8=False):
    """``lstm_int8_fused_plain``'s function: the plain version for a CPU
    tensor, kernel D for a CUDA tensor (C and H multiples of 16): its
    persistent kernel where ``persistent_plan`` gives a plan (recorded in
    ``lstm_int8_fused.plan``), else its step kernel."""
    _check_int8("kernel D", x_q=x_q, w_ih_q=w_ih_q, w_hh_q=w_hh_q)
    if x_q.device.type == "cpu":
        return lstm_int8_fused_plain(x_q, w_ih_q, w_hh_q, ih_scales, scales,
                                     b, reverse=reverse, out_int8=out_int8)
    ops = _fused_operands(x_q, w_ih_q, w_hh_q, ih_scales, scales, b)
    x_q = ops[0]
    T, N, C = x_q.shape
    H = w_hh_q.shape[0]
    plan = persistent_plan(N, C, H, _sms(x_q.device))
    lstm_int8_fused.plan = plan
    if plan is None:
        lstm_int8_fused.launches += 1
        return _fused_step(*ops, reverse, out_int8)
    out = torch.empty(T, N, H, device=x_q.device,
                      dtype=torch.int8 if out_int8 else torch.bfloat16)
    lib = build.library()
    for n0, rows, hbuf, flags in _row_groups(plan, N, H, x_q.device):
        lstm_int8_fused.launches += 1
        build.check(lib.lstm_int8_fused_persistent(
            *(t.data_ptr() for t in ops), out.data_ptr(),
            int(bool(out_int8)), hbuf.data_ptr(), flags.data_ptr(), T, N,
            n0, rows, C, H, *_plan_args(plan), int(bool(reverse)),
            build.stream_of(x_q)), "lstm_int8_fused_persistent")
    return out


def lstm_int8_fused_step_kernel(x_q, w_ih_q, w_hh_q, ih_scales, scales, b,
                                reverse=False, out_int8=False):
    """Kernel D's step kernel, whatever the plan (CUDA tensors only): the
    wrapper's route where the plan is None, and what chip_smoke.py and the
    card tests hold the persistent kernel against. It counts no launch."""
    _check_int8("kernel D", x_q=x_q, w_ih_q=w_ih_q, w_hh_q=w_hh_q)
    return _fused_step(*_fused_operands(x_q, w_ih_q, w_hh_q, ih_scales,
                                        scales, b), reverse, out_int8)


def lstm_int8_recurrence(xw, w_hh_q, scales, reverse=False):
    """``lstm_int8_recurrence_plain``'s function: the plain version for a
    CPU tensor, kernel E for a CUDA tensor (bf16 xw, H a multiple of 16):
    its persistent kernel where ``persistent_plan(..., fused=False)`` gives
    a plan (recorded in ``lstm_int8_recurrence.plan``), else its step
    kernel."""
    _check_int8("kernel E", w_hh_q=w_hh_q)
    if xw.device.type == "cpu":
        return lstm_int8_recurrence_plain(xw, w_hh_q, scales, reverse=reverse)
    ops = _recurrence_operands(xw, w_hh_q, scales)
    T, N, G = xw.shape
    H = G // 4
    plan = persistent_plan(N, None, H, _sms(xw.device), fused=False)
    lstm_int8_recurrence.plan = plan
    if plan is None:
        lstm_int8_recurrence.launches += 1
        return _recurrence_step(*ops, reverse)
    out = torch.empty(T, N, H, dtype=torch.bfloat16, device=xw.device)
    lib = build.library()
    for n0, rows, hbuf, flags in _row_groups(plan, N, H, xw.device):
        lstm_int8_recurrence.launches += 1
        build.check(lib.lstm_int8_recurrence_persistent(
            *(t.data_ptr() for t in ops), out.data_ptr(), hbuf.data_ptr(),
            flags.data_ptr(), T, N, n0, rows, H, *_plan_args(plan),
            int(bool(reverse)), build.stream_of(xw)),
            "lstm_int8_recurrence_persistent")
    return out


def lstm_int8_recurrence_step_kernel(xw, w_hh_q, scales, reverse=False):
    """Kernel E's step kernel, whatever the plan (CUDA tensors only), as
    ``lstm_int8_fused_step_kernel``. It counts no launch."""
    _check_int8("kernel E", w_hh_q=w_hh_q)
    return _recurrence_step(*_recurrence_operands(xw, w_hh_q, scales),
                            reverse)


lstm_int8_fused.launches = 0
lstm_int8_recurrence.launches = 0
lstm_int8_fused.plan = None  # the plan of the last call (None: step kernel)
lstm_int8_recurrence.plan = None
