"""
Kernel F — the LSTM layer with its input projection inside
(``csrc/lstm_fused.cu``) — with its plain PyTorch version and its launch
count.

Replaces ``bonito_tpu/ops/lstm_pallas.py:lstm_pallas_fused``
(``_lstm_kernel_fused``), the route of every small-H model (fast, H = 96).
What sets it apart from projection + kernel A is its arithmetic, not only
its traffic: ``xw = x @ w_ih + b`` is accumulated and **kept in f32** (A
reads an xw rounded to the model dtype), then every step adds
``dtype(h) @ w_hh`` in f32; h and c are carried in f32 and h is written in
the model dtype. The [T, N, 4H] gate-input tensor never exists in device
memory.

Time-major like kernels A, D and E: x [T, N, C] -> h [T, N, H].
``lstm_fused`` runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; it never falls back from one to the
other. On the card the shape rule ``fused_plan`` picks the kernel: the
mma kernel (the gate math in the product's registers, one barrier a step)
where it gives a plan, else the earlier kernel; ``lstm_fused_old_kernel``
runs the earlier kernel whatever the plan (no count), for comparisons.
``csrc/lstm_fused.cu`` says how both are laid out and what bounds them.
An f32 model takes the f32 kernel (``csrc/lstm_f32.cu``) on ``f32_plan``'s
plan: 1 to 8 rows a block so that the grid fills the card, the x product a
block of steps ahead, the four gates of a unit swapped by shuffles, one
barrier a step; ``f32_old_layout`` is the earlier f32 kernel's
(``csrc/lstm_fused.cu:lstm_fused_f32``).
"""

import functools

import torch

from bonito_tpu_torch.ops import build

TILE = 16     # C and H must be multiples of the WMMA k-tile
MAX_H = 256   # the widest f32 gate tile a block keeps in shared memory
MAX_C = 1024  # the widest input rows its ring of staged steps holds
# C = H of the mma kernel's instances (csrc/lstm_fused.cu:mma_kernel): a
# thread keeps (C + H) / 2 registers of weights, and at 4H threads a block
# an H100's 65,536 registers leave 168 a thread at H = 96
MMA_WIDTHS = (16, 32, 48, 64, 80, 96)
MMA_ROWS = 8  # batch rows a block: the n of mma.sync m16n8k16
MMA_SLOTS = 5  # the ring of x rows: 4 steps in flight and the one read


def fused_supported(C, H):
    """The shapes kernel F takes: C and H multiples of 16 (WMMA tiles), H
    up to 256 and C up to 1024 (a block's gate tile and staged inputs must
    fit shared memory). Only C = H = 96, the fast models' shape, keeps its
    weights in registers; any other reads them through L2 every step."""
    return (C % TILE == 0 and H % TILE == 0 and 0 < H <= MAX_H
            and 0 < C <= MAX_C)


def lstm_fused_plain(x, w_ih, w_hh, b, reverse=False):
    """x [T, N, C] in the model dtype; w_ih [C, 4H], w_hh [H, 4H]; b [4H]
    or None (zeros) -> h [T, N, H] in the model dtype. The projection is
    taken over operands in the model dtype with f32 accumulation, the bias
    is added in f32 and the sum stays f32; each step:
    gates = xw[t] + f32(dtype(h) @ w_hh), torch gate order (i, f, g, o);
    h and c are carried in f32. ``reverse`` walks t = T-1 .. 0 and writes
    each step at t. Nothing depends on any blocking of T."""
    T, N, C = x.shape
    H = w_hh.shape[0]
    dtype = x.dtype
    xw = torch.matmul(x.float(), w_ih.to(dtype).float())
    if b is not None:
        xw = xw + b.float()
    w = w_hh.to(dtype).float()
    h = torch.zeros(N, H, dtype=torch.float32, device=x.device)
    c = torch.zeros(N, H, dtype=torch.float32, device=x.device)
    out = torch.empty(T, N, H, dtype=dtype, device=x.device)
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates = xw[t] + torch.matmul(h.to(dtype).float(), w)
        i, f, g, o = gates.chunk(4, dim=1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        out[t] = h.to(dtype)
    return out


def gate_columns(H):
    """The mma kernel's column order, which it applies as it loads its
    weights: row p = 32w + 8k + r of its A operand is column k*H + 8w + r
    of W (gate k of unit 8w + r), so that warp w's two m16 tiles hold i, f
    and g, o of units 8w .. 8w + 7."""
    return torch.arange(4 * H).view(4, H // 8, 8).permute(1, 0, 2).reshape(-1)


@functools.lru_cache(maxsize=None)
def _plan(C, H, ctas, sms):
    if C != H or H not in MMA_WIDTHS:
        return None
    # the ring of x rows and h in two buffers, bf16 rows padded by 8
    smem = 2 * (MMA_SLOTS * MMA_ROWS * (C + 8) + 2 * MMA_ROWS * (H + 8))
    return {"rows": MMA_ROWS, "warps": H // 8, "threads": 4 * H,
            "units_a_warp": 8, "ctas": ctas,
            "waves": None if sms is None else -(-ctas // sms),
            "weight_registers": (C + H) // 2, "smem": smem}


def fused_plan(N, C, H, sms=None):
    """The mma kernel's plan for x [T, N, C] and W_hh [H, 4H] on a card of
    ``sms`` SMs: rows a block (8, the n of m16n8k16), warps (H / 8, each 8
    units of all 8 rows: 4H threads, the gate columns in ``gate_columns``
    order), the registers a thread keeps its weights in and the shared
    memory; or None where the mma kernel is not built for the shape
    (C != H, or H not in MMA_WIDTHS: its weights must fit a thread's
    registers), and the earlier kernel runs. Raises for a shape kernel F
    does not take at all."""
    if N < 1 or not fused_supported(C, H):
        raise ValueError(f"kernel F takes N >= 1 and C, H multiples of "
                         f"{TILE}, at most {MAX_C} and {MAX_H}: got N={N}, "
                         f"C={C}, H={H}")
    return _plan(C, H, -(-N // MMA_ROWS), sms)


F32_OLD_ROWS = 8  # batch rows a block of the earlier f32 kernel
F32_REGISTER_H = 96  # the one H whose W_hh column a thread keeps (fast's)
SMEM_LIMIT = 232448  # the most shared memory a block may ask for
F32_ROWS = (1, 2, 4, 8)  # batch rows a block of the f32 kernel: instances
F32_PASS = 32  # (step, row)s of the x product a pass of a block's threads
F32_MAX_BLOCK = 32  # steps of the x product at once, at most


def _check(N, C, H):
    if N < 1 or not fused_supported(C, H):
        raise ValueError(f"kernel F takes N >= 1 and C, H multiples of "
                         f"{TILE}, at most {MAX_C} and {MAX_H}: got N={N}, "
                         f"C={C}, H={H}")


def f32_smem_bytes(C, H, rows, block, wih_in_smem):
    """Shared memory of one block of the f32 kernel (``csrc/lstm_f32.cu:
    f32_rows_smem_floats``): W_ih where it is kept there, xw + b of
    ``block`` steps, their x rows twice (the next block's arrive while
    this one runs), h in two buffers."""
    return 4 * ((C * 4 * H if wih_in_smem else 0) + block * rows * 4 * H
                + 2 * block * rows * C + 2 * rows * H)


def f32_plan(N, C, H, sms):
    """The f32 kernel's plan (``csrc/lstm_f32.cu:lstm_fused_f32_rows``,
    which takes it as given) for x [T, N, C] and W_hh [H, 4H] on a card
    of ``sms`` SMs: ``rows`` a block, the fewest of F32_ROWS that still
    fit the grid in one wave (8 where none does: N above 8 x sms), so
    that a small batch fills the card too; a thread per gate column (4H),
    W_hh's column in its registers at H 96 (the one instance built so;
    else read through L2 every step); the x product (xw + b) ``block``
    steps at a time into shared memory: the most steps (at most
    F32_MAX_BLOCK) that fit beside W_ih and fill the threads' passes of
    F32_PASS (step, row)s, else the most that fit, or, where W_ih does not
    fit beside one step, the same beside nothing (W_ih then read through
    L2); and the shared memory that layout asks for. Raises for a shape
    kernel F does not take; never None for one it takes (one step of 8
    rows at C 1024 and H 256 takes 112 KB beside nothing)."""
    _check(N, C, H)
    rows = next((r for r in F32_ROWS if -(-N // r) <= sms), F32_ROWS[-1])

    def fits(wih_in_smem):
        return [b for b in range(F32_MAX_BLOCK, 0, -1)
                if f32_smem_bytes(C, H, rows, b, wih_in_smem) <= SMEM_LIMIT]
    wih_in_smem = bool(fits(True))
    blocks = fits(wih_in_smem)
    block = ([b for b in blocks if b * rows % F32_PASS == 0] or blocks)[0]
    return {"dtype": "f32", "rows": rows, "threads": 4 * H,
            "ctas": -(-N // rows), "block": block,
            "whh_in_registers": H == F32_REGISTER_H,
            "wih_in_smem": wih_in_smem,
            "smem": f32_smem_bytes(C, H, rows, block, wih_in_smem)}


def f32_old_layout(N, C, H):
    """The earlier f32 kernel's layout (``csrc/lstm_fused.cu:
    lstm_fused_f32``, which takes it as given): 8 rows a block, a thread
    per gate column, W_hh's column in registers at H 96, W_ih in shared
    memory where it fits beside the step's rows of x, h and the gates."""
    _check(N, C, H)
    rows = F32_OLD_ROWS * (C + H + 4 * H) * 4
    wih_in_smem = C * 4 * H * 4 + rows <= SMEM_LIMIT
    return {"dtype": "f32", "rows": F32_OLD_ROWS, "threads": 4 * H,
            "ctas": -(-N // F32_OLD_ROWS),
            "whh_in_registers": H == F32_REGISTER_H,
            "wih_in_smem": wih_in_smem,
            "smem": rows + (C * 4 * H * 4 if wih_in_smem else 0)}


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(w):
    """A contiguous weight at a 32-byte address (WMMA tile loads)."""
    w = w.contiguous()
    return w.clone() if w.data_ptr() % 32 else w


def lstm_fused(x, w_ih, w_hh, b, reverse=False):
    """``lstm_fused_plain``'s function: the plain version for a CPU
    tensor, kernel F for a CUDA tensor (C and H as ``fused_supported``
    says). bf16: the mma kernel where ``fused_plan`` gives a plan, else the
    earlier kernel; f32: the f32 kernel on ``f32_plan``'s plan (which
    every shape F takes has). ``lstm_fused.plan`` holds the last call's
    plan."""
    if x.device.type == "cpu":
        return lstm_fused_plain(x, w_ih, w_hh, b, reverse=reverse)
    return _launch(lstm_fused, x, w_ih, w_hh, b, reverse)


def lstm_fused_old_kernel(x, w_ih, w_hh, b, reverse=False):
    """Kernel F's earlier kernel for x's dtype whatever the plan (bf16:
    ``lstm_fused_bf16``; f32: ``lstm_fused_f32`` on ``f32_old_layout``),
    for comparisons; counts no launch."""
    return _launch(None, x, w_ih, w_hh, b, reverse)


def _launch(counter, x, w_ih, w_hh, b, reverse):
    """F's checks and launch: the mma kernel on ``fused_plan``'s plan (f32:
    the f32 kernel on ``f32_plan``'s), the earlier kernel where
    ``fused_plan`` gives None or where ``counter`` is None (the
    comparisons' route, which counts nothing)."""
    build.refuse_grad("F", [x, w_ih, w_hh, b], build.TRAIN_ROUTE)
    if x.device.type != "cuda" or any(
            t.device != x.device for t in (w_ih, w_hh)):
        raise ValueError(f"kernel F needs x, w_ih and w_hh on one CUDA "
                         f"device, got {x.device}, {w_ih.device} and "
                         f"{w_hh.device}")
    if (x.dtype not in (torch.bfloat16, torch.float32)
            or any(t.dtype != x.dtype for t in (w_ih, w_hh))):
        raise TypeError(f"kernel F takes x, w_ih and w_hh all bf16 or all "
                        f"f32, got {x.dtype}, {w_ih.dtype} and {w_hh.dtype}")
    T, N, C = x.shape
    H = w_hh.shape[0]
    if (tuple(w_ih.shape) != (C, 4 * H) or tuple(w_hh.shape) != (H, 4 * H)
            or T < 1 or N < 1 or not fused_supported(C, H)):
        raise ValueError(
            f"kernel F: x {tuple(x.shape)}, w_ih {tuple(w_ih.shape)} and "
            f"w_hh {tuple(w_hh.shape)} need [T, N, C], [C, 4H], [H, 4H] with "
            f"C and H multiples of {TILE}, at most {MAX_C} and {MAX_H}")
    x = x.contiguous()
    bias = (torch.zeros(4 * H, device=x.device) if b is None
            else b.to(device=x.device, dtype=torch.float32).contiguous())
    if bias.numel() != 4 * H:
        raise ValueError(f"kernel F: b has {bias.numel()} values, not {4 * H}")
    out = torch.empty(T, N, H, dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        x, w_ih = _aligned(x), _aligned(w_ih)  # 16-byte loads and copies
        args = (x.data_ptr(), w_ih.data_ptr(), w_hh.contiguous().data_ptr(),
                bias.data_ptr(), out.data_ptr(), T, N, C, H,
                int(bool(reverse)))
        lib, stream = build.library(), build.stream_of(x)
        if counter is None:
            old = f32_old_layout(N, C, H)
            build.check(lib.lstm_fused_f32(
                *args, int(old["whh_in_registers"]), int(old["wih_in_smem"]),
                old["smem"], stream), "lstm_fused_f32")
            return out
        plan = counter.plan = f32_plan(N, C, H, _sms(x.device))
        counter.launches += 1
        build.check(lib.lstm_fused_f32_rows(
            *args, plan["rows"], plan["block"],
            int(plan["whh_in_registers"]), int(plan["wih_in_smem"]),
            plan["smem"], stream), "lstm_fused_f32_rows")
        return out
    plan = None
    if counter is not None:
        plan = fused_plan(N, C, H, _sms(x.device))
        counter.plan = plan
        counter.launches += 1
    entry = "lstm_fused_bf16" if plan is None else "lstm_fused_mma"
    if plan is None:
        w_ih, w_hh = _aligned(w_ih), _aligned(w_hh)
    else:
        w_ih, w_hh = w_ih.contiguous(), w_hh.contiguous()
    build.check(getattr(build.library(), entry)(
        x.data_ptr(), w_ih.data_ptr(), w_hh.data_ptr(), bias.data_ptr(),
        out.data_ptr(), T, N, C, H, int(bool(reverse)), build.stream_of(x)),
        entry)
    return out


lstm_fused.launches = 0
lstm_fused.plan = None
