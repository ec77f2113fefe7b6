"""
Kernel A — the LSTM recurrence (``csrc/lstm.cu``) — with its plain
PyTorch version, its launch count and its shape rule.

Replaces ``bonito_tpu/ops/lstm_pallas.py:lstm_pallas`` (``_lstm_kernel``).
On an H100 the recurrence is 2*N*H*4H*T tensor-core operations per layer
against ~1.6 GB of xw/h traffic at hac, but it is serial in T, so what
a design pays per step decides. A is a persistent kernel: one cooperative
launch walks the whole layer, each CTA holding its slice of W_hh in
shared memory, the CTAs of a row slice meeting once a step.
``csrc/lstm.cu`` says how the kernel is laid out and what bounds it.

In f32 (an f32 model: ``evaluate``, a ``--no-amp`` validation) A runs
its own persistent kernel (``csrc/lstm_f32.cu``) on ``f32_plan``'s plan:
8 units a CTA, f32 W_hh's slice (128 KB at H 1024) in shared memory, h
streamed by a producer warp through a ring of bulk copies, the product on
the f32 cores. Where that plan is None the
earlier f32 kernel runs: R's f32 step kernel storing h only
(``csrc/lstm_train.cu:lstm_recurrence_f32``), one count a call.
``lstm_recurrence_old_kernel`` runs the earlier kernel (the step kernel)
whatever the plan and counts nothing, for comparisons.

The shape rule, ``persistent_plan(N, H, sms)``, is pure Python: it picks
the rows per CTA, the row slices, the ring of h chunks, whether two CTAs
share each load of h, and the number of launches (row groups: batch rows
are independent, so a batch larger than one grid holds runs as several
launches of the same kernel), or None where W_hh's slice cannot stay in
shared memory beside the ring. Then A runs as its step kernel, one launch
per timestep from one C call. Each C call counts one launch: a row
group's persistent launch, or the step kernel's call.

``lstm_recurrence`` runs the plain version for a tensor on the CPU and
the kernel for a tensor on the card; it never falls back from one to the
other.
"""

import torch

from bonito_tpu_torch.ops import build

ROW_BLOCK = 32     # batch rows per block of the step kernel (RB)
UNITS = 16         # hidden units per CTA of the persistent kernel (PU)
MAX_ROWS = 64      # batch rows per CTA: four m-tiles of 16
MAX_KC = 512       # the widest k-chunk of h
K_SLICES = 4       # k-slices, a slot of partial sums each (PKS)
PAD = 8            # bf16 (or f32) padding per shared-memory row
SMEM_LIMIT = 232448  # 227 KB, the most a block may ask for


def _cdiv(a, b):
    return -(-a // b)


def smem_bytes(H, rows, kc, stages, cluster=1):
    """Shared memory of one CTA: W_hh's slice (4 x UNITS columns of H), then
    the ring of h chunks, which the k-slices' f32 partials reuse, and with
    a cluster an mbarrier per chunk."""
    w = 4 * UNITS * (H + PAD) * 2
    ring = stages * rows * (kc + PAD) * 2
    part = K_SLICES * rows * (4 * UNITS + PAD) * 4
    return w + max(ring, part) + (8 * stages if cluster > 1 else 0)


def persistent_plan(N, H, sms):
    """The persistent kernel's plan for N batch rows and H hidden units on
    a card of ``sms`` SMs, or None where it cannot hold W_hh (H / 16 CTAs
    beyond the SMs, or W_hh's slice and a ring of two stages of 16 rows
    beyond the shared memory): then the step kernel runs.

    A CTA owns 16 units and one slice of ``rows`` batch rows (16 to 64);
    a launch has H / 16 x ``slices`` CTAs, at most one an SM, and covers
    ``n_launch`` batch rows; ``launches`` row groups cover N. Rows are
    spread evenly. The ring of h chunks takes the widest k-chunk that fits
    (each chunk costs a barrier of the CTA; scripts/lstm_step_split.py
    times the choices at hac), then as many stages as fit, up to all of a
    step's chunks (at most 8, at least 2). Where the ring holds all of
    a step's chunks and H / 16 is even, ``cluster`` is 2: the CTAs of two
    neighbouring unit blocks share each load of h (bulk copies multicast to
    both), which halves the L2 traffic of the step. The kernel launches
    exactly this plan, or fails where the card cannot hold its grid."""
    if N < 1 or H < 16 or H % 16:
        raise ValueError(f"kernel A: N {N} and H {H}: N >= 1, H a "
                         f"multiple of 16")
    g_u = H // UNITS
    if g_u > sms:
        return None
    # k-chunks: H split into 2 or more chunks of a multiple of 16, at most
    # 512 wide, the widest first (H itself where no split is a multiple of
    # 16)
    kcs = [H // n for n in range(2, H // 16 + 1)
           if H % n == 0 and (H // n) % 16 == 0 and H // n <= MAX_KC] or [H]
    slices_max = sms // g_u
    for rows_max in range(MAX_ROWS, 0, -16):
        launches = _cdiv(N, slices_max * rows_max)
        n_launch = _cdiv(N, launches)
        slices = min(slices_max, _cdiv(n_launch, 16))
        rows = _cdiv(_cdiv(n_launch, slices), 16) * 16
        slices = _cdiv(n_launch, rows)
        for kc in kcs:
            for stages in range(min(8, max(H // kc, 2)), 1, -1):
                cluster = 2 if g_u % 2 == 0 and stages == H // kc else 1
                smem = smem_bytes(H, rows, kc, stages, cluster)
                if smem <= SMEM_LIMIT:
                    return {"units": UNITS, "unit_blocks": g_u,
                            "rows": rows, "slices": slices,
                            "ctas": g_u * slices, "n_launch": n_launch,
                            "launches": launches, "kc": kc,
                            "stages": stages, "cluster": cluster,
                            "smem": smem}
    return None


F32_UNITS = 8        # hidden units per CTA of the f32 persistent kernel
F32_MAX_ROWS = 256   # batch rows per launch (row groups beyond)
F32_MAX_WARPS = 12   # consumer warps: row tiles of 32 x k-slices
F32_PAD = 8          # floats of padding per k-row of h
F32_LDP = 40         # row stride (floats) of the k-slices' partial sums


def f32_smem_bytes(H, rows, k_slices, kc, stages):
    """Shared memory of one CTA of the f32 kernel (``csrc/lstm_f32.cu:
    a32_smem``): W_hh's slice (H x 32 f32), the ring of h chunks or the
    k-slices' partial sums over it, the step's xw of the CTA's columns,
    two mbarriers a slot."""
    ring = stages * kc * (rows + F32_PAD)
    part = k_slices * rows * F32_LDP
    return ((H * 4 * F32_UNITS + max(ring, part) + rows * F32_LDP) * 4
            + 16 * stages)


def f32_plan(N, H, sms):
    """The f32 persistent kernel's plan for N batch rows and H hidden units
    on a card of ``sms`` SMs, or None where W_hh's f32 slice cannot stay
    in shared memory (H / 8 CTAs beyond the SMs, or the slice and a ring
    of two chunks beyond 227 KB): then the earlier f32 kernel runs.

    A CTA owns 8 units (32 gate columns) of every row of a launch: H / 8
    CTAs, one an SM, in one cooperative launch per row group of at most
    256 rows (``launches``; rows spread evenly). ``rows`` is a launch's row
    count rounded up to 32 (a warp's tile); ``row_tiles`` = rows / 32 and
    ``k_slices`` (8, 4, 2 or 1: at most 12 consumer warps, so that a
    thread may keep 128 registers beside the producer warp; fewer where no
    chunk of a multiple of 8 x k_slices divides H) split the product, whose
    partial sums meet in shared memory. The ring takes the widest k-chunk
    (dividing H, a multiple of 8 x k_slices, at most 256) that leaves room
    for three slots beside the slice (two where no chunk does), then as
    many slots as fit, up to 8 and a step's chunks (at least 2)."""
    if N < 1 or H < 16 or H % 16:
        raise ValueError(f"kernel A in f32: N {N} and H {H}: N >= 1, H a "
                         f"multiple of 16")
    g_u = H // F32_UNITS
    if g_u > sms:
        return None
    launches = _cdiv(N, F32_MAX_ROWS)
    n_launch = _cdiv(N, launches)
    rows = _cdiv(n_launch, 32) * 32
    tiles = rows // 32
    ks = next(k for k in (8, 4, 2, 1) if tiles * k <= F32_MAX_WARPS)
    while ks > 1 and not any(H % kc == 0
                             for kc in range(8 * ks, 257, 8 * ks)):
        ks //= 2  # narrow H: fewer k-slices, so that a chunk divides H
    kcs = [kc for kc in range(min(H, 256), 0, -8)
           if H % kc == 0 and kc % (8 * ks) == 0]
    for least in (3, 2):
        for kc in kcs:
            top = min(8, max(2, H // kc))
            if top < least:
                continue
            fits = [st for st in range(least, top + 1)
                    if f32_smem_bytes(H, rows, ks, kc, st) <= SMEM_LIMIT]
            if fits:
                stages = max(fits)
                return {"dtype": "f32", "units": F32_UNITS,
                        "ctas": g_u, "rows": rows, "row_tiles": tiles,
                        "k_slices": ks, "warps": tiles * ks + 1,
                        "threads": (tiles * ks + 1) * 32,
                        "n_launch": n_launch, "launches": launches,
                        "kc": kc, "stages": stages,
                        "smem": f32_smem_bytes(H, rows, ks, kc, stages)}
    return None


def recurrence_plain(xw, w_hh, reverse=False, store=torch.bfloat16):
    """xw [T, N, 4H] in the model dtype, w_hh [H, 4H] -> (h [T, N, H] in
    the model dtype, c [T, N, H] and the activations [i, f, g, o] [T, N,
    4H], both in ``store``). Each step: gates = f32(xw[t]) + f32(dtype(h)
    @ w_hh) (f32 accumulation), torch gate order (i, f, g, o); h and c are
    carried in f32. ``reverse`` walks t = T-1 .. 0 and writes each step at
    t. Kernel A's plain version keeps h; kernel R's keeps all three."""
    T, N, G = xw.shape
    H = G // 4
    dtype = xw.dtype
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


def lstm_recurrence_plain(xw, w_hh, reverse=False):
    """xw [T, N, 4H] in the model dtype, w_hh [H, 4H] -> h [T, N, H] in
    the model dtype: the h of ``recurrence_plain``."""
    return recurrence_plain(xw, w_hh, reverse)[0]


def lstm_recurrence(xw, w_hh, reverse=False):
    """The recurrence of ``lstm_recurrence_plain``: the plain version for
    a CPU tensor, kernel A for a CUDA tensor: bf16 (the persistent kernel
    on ``persistent_plan``'s plan, else the step kernel) or f32 (the f32
    persistent kernel on ``f32_plan``'s plan, else the earlier f32 step
    kernel; h in f32). ``lstm_recurrence.plan`` holds the last call's
    plan (None: a step kernel)."""
    if xw.device.type == "cpu":
        return lstm_recurrence_plain(xw, w_hh, reverse=reverse)
    return _launch(lstm_recurrence, xw, w_hh, reverse)


def lstm_recurrence_old_kernel(xw, w_hh, reverse=False):
    """Kernel A's step kernel for xw's dtype whatever the plan (in f32 the
    earlier f32 kernel, R's f32 step kernel), for comparisons; counts no
    launch."""
    return _launch(None, xw, w_hh, reverse)


def _launch(counter, xw, w_hh, reverse):
    """A's checks and launch: the persistent kernel of the dtype's plan, the
    step kernel where it gives None or where ``counter`` is None (the
    comparisons' route, which counts nothing)."""
    build.refuse_grad("A", [xw, w_hh], build.TRAIN_ROUTE)
    if xw.device.type != "cuda" or w_hh.device != xw.device:
        raise ValueError(f"kernel A needs xw and w_hh on one CUDA device, "
                         f"got {xw.device} and {w_hh.device}")
    if (xw.dtype not in (torch.bfloat16, torch.float32)
            or w_hh.dtype != xw.dtype):
        raise TypeError(f"kernel A takes xw and w_hh both bf16 or both f32, "
                        f"got {xw.dtype} and {w_hh.dtype}")
    T, N, G = xw.shape
    H = G // 4
    if G != 4 * H or H % 16 or tuple(w_hh.shape) != (H, 4 * H) or T < 1:
        raise ValueError(f"kernel A: xw {tuple(xw.shape)} and w_hh "
                         f"{tuple(w_hh.shape)} need [T, N, 4H], [H, 4H] "
                         f"with H a multiple of 16")
    if not xw.is_contiguous():
        raise ValueError("kernel A: xw must be contiguous")
    lib = build.library()
    out = torch.empty(T, N, H, dtype=xw.dtype, device=xw.device)
    sms = torch.cuda.get_device_properties(xw.device).multi_processor_count
    f32 = xw.dtype == torch.float32
    plan = None
    if counter is not None:
        plan = f32_plan(N, H, sms) if f32 else persistent_plan(N, H, sms)
        counter.plan = plan
    stream = build.stream_of(xw)
    if plan is None:
        w = w_hh.contiguous()
        if w.data_ptr() % 32:  # WMMA and float4 loads need the alignment
            w = w.clone()
        Np = -(-N // ROW_BLOCK) * ROW_BLOCK
        hbuf = torch.zeros(2, Np, H, dtype=xw.dtype, device=xw.device)
        cbuf = torch.zeros(N, H, dtype=torch.float32, device=xw.device)
        entry = "lstm_recurrence_f32" if f32 else "lstm_recurrence_bf16"
        if counter is not None:
            counter.launches += 1
        build.check(getattr(lib, entry)(
            xw.data_ptr(), w.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
            cbuf.data_ptr(), T, N, Np, H, int(bool(reverse)), stream), entry)
        return out
    if f32:
        w = w_hh.contiguous()
        if w.data_ptr() % 16:  # W_hh's slice arrives by 16-byte copies
            w = w.clone()
        if xw.data_ptr() % 16:  # and xw by 16-byte copies
            xw = xw.clone()
        rows = plan["rows"]
        hbuf = torch.empty(2, H, rows + F32_PAD, dtype=xw.dtype,
                           device=xw.device)
        flag = torch.empty(1, dtype=torch.int32, device=xw.device)
        for n0 in range(0, N, plan["n_launch"]):
            hbuf.zero_()
            flag.zero_()
            counter.launches += 1
            build.check(lib.lstm_recurrence_f32_persistent(
                xw.data_ptr(), w.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
                flag.data_ptr(), T, N, n0, min(plan["n_launch"], N - n0), H,
                rows, plan["k_slices"], plan["kc"], plan["stages"],
                int(bool(reverse)), stream), "lstm_recurrence_f32_persistent")
        return out
    wt = w_hh.t().contiguous()  # [4H, H]: a gate column's k contiguous
    rows, slices = plan["rows"], plan["slices"]
    hbuf = torch.empty(2, slices * rows, H, dtype=xw.dtype, device=xw.device)
    flags = torch.empty(slices, dtype=torch.int32, device=xw.device)
    for n0 in range(0, N, plan["n_launch"]):
        hbuf.zero_()
        flags.zero_()
        counter.launches += 1
        build.check(lib.lstm_recurrence_persistent(
            xw.data_ptr(), wt.data_ptr(), out.data_ptr(), hbuf.data_ptr(),
            flags.data_ptr(), T, N, n0, min(plan["n_launch"], N - n0), H,
            rows // 16, slices, plan["kc"], plan["stages"], plan["cluster"],
            int(bool(reverse)), stream), "lstm_recurrence_persistent")
    return out


lstm_recurrence.launches = 0
lstm_recurrence.plan = None  # the plan of the last call (None: step kernel)
