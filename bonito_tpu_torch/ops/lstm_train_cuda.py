"""
Kernels R and S — the LSTM recurrence of a training step and its backward
through time (``csrc/lstm_train.cu``) — with their plain PyTorch versions,
their launch counts and their shape rules.

R replaces ``bonito_tpu/ops/lstm_pallas.py:_lstm_train_fwd_kernel`` and S
``_lstm_train_bwd_kernel`` (``lstm_pallas_train`` via ``_lstm_rec``). R is
kernel A's recurrence that also keeps what S needs: the cell state c and
the post-activation gates. S walks the recurrence's steps last to first and
writes the gradient of the gates; ``ops.lstm.lstm_train`` forms dW_hh and
the projection's gradients from it with torch.matmul. Each is 2*N*H*4H*T
tensor-core operations per layer, serial in T, so what a step costs
decides.

Both are persistent kernels where their plans take the shape: one
cooperative launch per row group walks the whole layer, with W_hh in the
SMs' shared memory. For a bf16 model (``csrc/lstm_train.cu``) R is kernel
A's kernel with R's stores (``forward_plan``: A's ``persistent_plan``); in
S the CTAs of a cluster split the 4H gate columns of the product between
them and swap the partial sums through distributed shared memory
(``backward_plan``). For an f32 model (training without amp,
``csrc/lstm_f32.cu``) R is A's f32 kernel with R's stores (``forward_plan``:
A's ``f32_plan``) and S is that layout turned around: a CTA holds 8 rows of
f32 W_hh and streams the previous step's f32 dgates through a ring of bulk
copies (``f32_backward_plan``); both take c and the gates stored in bf16 or
in f32. Where a plan is None — a bf16 model that stores in f32
(``round_bf16=False``), or an H beyond the SMs or the shared memory — the
first design runs: one launch per timestep from a loop in one C call.
Each C call counts one launch: a row group's persistent launch, or the
step kernel's call. Each wrapper keeps the plan that ran in ``.plan``
(None: the step kernel). ``lstm_train_forward_step`` and
``lstm_train_backward_step`` run the step kernels whatever the plan, count
nothing, and serve comparisons only.

``round_bf16`` stores c, the gates and their gradient in bf16, as
bonito_tpu's kernels do; without it they stay f32 (where bonito_tpu's
gate sends a shape to its scan instead). The wrappers run the plain
version for a tensor on the CPU and the kernel for a tensor on the card
(xw and W_hh both bf16, or both f32 for training without amp; H a multiple
of 16); they never fall back from one to the other.
"""

import ctypes

import torch

from bonito_tpu_torch.ops import build
# kernel A's: R runs A's kernel; S's CTAs are laid out as A's (16 units,
# 16 to 64 rows), its ring's rows padded alike
from bonito_tpu_torch.ops.lstm_cuda import (F32_PAD, F32_UNITS, MAX_ROWS, PAD,
                                            SMEM_LIMIT, UNITS, _cdiv,
                                            f32_plan, persistent_plan,
                                            recurrence_plain)

ROW_BLOCK = 32  # batch rows per block of the step kernels (RB)
MAX_H = 1024    # S holds W_hh's block in registers: H / 8 a thread
CLUSTERS = (2, 1)  # S's cluster sizes, the wider first (csrc/lstm_train.cu
                   # says why no wider)
MAX_STAGES = 4  # slots of S's ring, at most
WARPS = 8       # warps a CTA of S: k-slices of its columns
S32_MAX_ROWS = 256   # S in f32: batch rows per launch (row groups beyond)
S32_MAX_WARPS = 16   # consumer warps: row tiles of 16 x k-slices
S32_MAX_KC = 512     # the widest chunk of dgates' k
S32_LDP = 9          # row stride (floats) of the k-slices' partial sums


def _store(round_bf16):
    return torch.bfloat16 if round_bf16 else torch.float32


def forward_plan(N, H, sms, dtype=torch.bfloat16, round_bf16=True):
    """R's plan for N batch rows and H hidden units on a card of ``sms``
    SMs: kernel A's plan for the model's dtype (R's stores go straight to
    global memory and need no shared memory): ``persistent_plan`` for a
    bf16 model that stores c and the activations in bf16, ``f32_plan`` for
    an f32 model (either storage); None for a bf16 model storing in f32,
    or where A's plan is None: then the step kernel runs."""
    if N < 1 or H < 16 or H % 16:
        raise ValueError(f"kernel R: N {N} and H {H}: N >= 1, H a "
                         f"multiple of 16")
    if dtype == torch.float32:
        return f32_plan(N, H, sms)
    if not round_bf16:
        return None
    return persistent_plan(N, H, sms)


def chunk_rows(rows):
    """dgates rows a slot of S's ring holds: two n-tiles of 8, one where a
    CTA has 16 rows (so that its ring still has two chunks)."""
    return 16 if rows >= 32 else 8


def backward_smem(H, rows, cluster, stages):
    """Shared memory of one CTA of S's persistent kernel: the ring of
    dgates chunks (``chunk_rows`` rows of the CTA's 4H / cluster columns a
    slot), the warps' f32 partial sums (a k-slice each, over its rows and
    the cluster's 16 x cluster units), the partial dh it receives (a slot
    per rank of its cluster), a full and an empty mbarrier per ring slot.
    W_hh's block is in registers."""
    ring = stages * chunk_rows(rows) * (4 * H // cluster + PAD) * 2
    part = WARPS * rows * (16 * cluster + 4) * 4
    return ring + part + cluster * rows * UNITS * 4 + 16 * stages


def s32_ldr(rows):
    """The row stride (floats) of a k of dgates in S's f32 planes and
    ring: ``rows``, or rows + 16 where rows is a multiple of 32, so that
    the 16-byte loads of 8 lanes (4 row groups x 2 k) hit distinct banks
    (``csrc/lstm_f32.cu:s32_ldr``)."""
    return rows if rows % 32 else rows + 16


def f32_backward_smem(H, rows, k_slices, kc, stages, round_bf16=True):
    """Shared memory of one CTA of S's f32 kernel (``csrc/lstm_f32.cu:
    s32_smem``): 8 rows of f32 W_hh (4H x 8), the ring of dgates chunks or
    the k-slices' partial sums over it, a row of the step's inputs (acts
    32, c_t and c_prev 8 each in the storage type, g_h 8 f32) per batch
    row, two mbarriers a slot."""
    st = 2 if round_bf16 else 4
    ring = stages * kc * s32_ldr(rows)
    part = k_slices * rows * S32_LDP
    return ((4 * H * F32_UNITS + max(ring, part)) * 4
            + rows * (48 * st + 32) + 16 * stages)


def f32_backward_plan(N, H, sms, round_bf16=True):
    """S's f32 kernel's plan for N batch rows and H hidden units on a card
    of ``sms`` SMs, or None where W_hh's 8 rows cannot stay in shared
    memory (H / 8 CTAs beyond the SMs, or the rows and a ring of two
    chunks beyond 227 KB, as at H 2048): then the step kernel runs. Chosen
    as A's ``f32_plan`` chooses its own.

    A CTA owns 8 units of every row of a launch: H / 8 CTAs, one an SM,
    in one cooperative launch per row group of at most 256 rows
    (``launches``; rows spread evenly). ``rows`` is a launch's row count
    rounded up to 16 (a warp's tile); ``row_tiles`` = rows / 16 and
    ``k_slices`` (8, 4, 2 or 1: at most 16 consumer warps; fewer where no
    chunk of a multiple of 8 x k_slices divides 4H) split the product.
    The ring takes the widest chunk of k (dividing 4H, a multiple of 8 x
    k_slices, at most 512) that leaves room for three slots beside W_hh's
    rows (two where no chunk does), then as many slots as fit, up to 8 and
    a step's chunks (at least 2)."""
    if N < 1 or H < 16 or H % 16:
        raise ValueError(f"kernel S in f32: N {N} and H {H}: N >= 1, H a "
                         f"multiple of 16")
    g_u = H // F32_UNITS
    if g_u > sms:
        return None
    G = 4 * H
    launches = _cdiv(N, S32_MAX_ROWS)
    n_launch = _cdiv(N, launches)
    rows = _cdiv(n_launch, 16) * 16
    tiles = rows // 16
    ks = next(k for k in (8, 4, 2, 1) if tiles * k <= S32_MAX_WARPS)
    while ks > 1 and not any(G % kc == 0 for kc in
                             range(8 * ks, S32_MAX_KC + 1, 8 * ks)):
        ks //= 2
    kcs = [kc for kc in range(min(G, S32_MAX_KC), 0, -8)
           if G % kc == 0 and kc % (8 * ks) == 0]
    for least in (3, 2):
        for kc in kcs:
            top = min(8, max(2, G // kc))
            if top < least:
                continue
            fits = [st for st in range(least, top + 1)
                    if f32_backward_smem(H, rows, ks, kc, st, round_bf16)
                    <= SMEM_LIMIT]
            if fits:
                stages = max(fits)
                return {"dtype": "f32", "units": F32_UNITS, "ctas": g_u,
                        "rows": rows, "row_tiles": tiles, "k_slices": ks,
                        "warps": tiles * ks + 1,
                        "threads": (tiles * ks + 1) * 32,
                        "n_launch": n_launch, "launches": launches,
                        "kc": kc, "stages": stages, "ldr": s32_ldr(rows),
                        "smem": f32_backward_smem(H, rows, ks, kc, stages,
                                                  round_bf16)}
    return None


def backward_plan(N, H, sms, resident, dtype=torch.bfloat16,
                  round_bf16=True):
    """S's plan for N batch rows and H hidden units on a card of ``sms``
    SMs, where ``resident[c]`` CTAs can be resident at once in clusters of
    c (``CLUSTERS``; ``resident_ctas``): for an f32 model
    ``f32_backward_plan``; for a bf16 model None where it stores in f32,
    or where no cluster size fits (H above MAX_H, H / 16 CTAs beyond the
    SMs, a k-slice no multiple of 16, or the ring beyond the shared
    memory): then the step kernel runs.

    A CTA owns 16 units and one slice of ``rows`` batch rows (16 to 64) in
    the elementwise part; a launch has H / 16 x ``slices`` CTAs and covers
    ``n_launch`` batch rows, ``launches`` row groups cover N, rows spread
    evenly (as kernel A's ``persistent_plan``). The ``cluster`` CTAs of a
    cluster (neighbouring unit blocks of one slice) split the gate columns
    of the product: each holds, in its warps' registers, W_hh's rows of the
    cluster's 16 x cluster units over its ``k_cols`` = 4H / cluster
    columns (from rank x k_cols), computes the partial dh of all those
    units over them and sends each owner its part. A CTA reads its rows'
    k_cols columns of dgates a step, ``chunk_rows`` rows (a copy each) at
    a time through a ring of ``stages`` slots. Of the plans that fit, the
    one with the fewest launches, then the wider cluster (half the bytes a
    CTA reads a step). The kernel launches exactly this plan, or fails
    where the card cannot hold its grid in those clusters."""
    if N < 1 or H < 16 or H % 16:
        raise ValueError(f"kernel S: N {N} and H {H}: N >= 1, H a "
                         f"multiple of 16")
    if dtype == torch.float32:
        return f32_backward_plan(N, H, sms, round_bf16)
    if not round_bf16 or H > MAX_H:
        return None
    g_u = H // UNITS
    best = None
    for cluster in CLUSTERS:
        slices_max = min(sms, resident.get(cluster, 0)) // g_u
        k_cols = 4 * H // cluster
        if g_u % cluster or slices_max < 1 or k_cols % (16 * WARPS):
            continue
        plan = None
        for rows_max in range(MAX_ROWS, 0, -16):
            launches = _cdiv(N, slices_max * rows_max)
            n_launch = _cdiv(N, launches)
            slices = min(slices_max, _cdiv(n_launch, 16))
            rows = _cdiv(_cdiv(n_launch, slices), 16) * 16
            slices = _cdiv(n_launch, rows)
            # the ring: as many slots as fit, 2 to MAX_STAGES (a chunk's
            # copies in flight while another is read), dividing the step's
            # chunks
            n_chunks = rows // chunk_rows(rows)
            fits = [st for st in range(2, MAX_STAGES + 1)
                    if n_chunks % st == 0 and backward_smem(
                        H, rows, cluster, st) <= SMEM_LIMIT]
            if fits:
                stages = max(fits)
                plan = {"units": UNITS, "unit_blocks": g_u, "rows": rows,
                        "slices": slices, "ctas": g_u * slices,
                        "n_launch": n_launch, "launches": launches,
                        "cluster": cluster, "k_cols": k_cols,
                        "chunk_rows": chunk_rows(rows), "stages": stages,
                        "smem": backward_smem(H, rows, cluster, stages)}
                break
        if plan and (best is None or plan["launches"] < best["launches"]):
            best = plan
    return best


_resident = {}  # card -> {cluster: CTAs resident at once}


def resident_ctas(device):
    """How many CTAs of S's persistent kernel ``device``'s card holds at
    once in clusters of each size (the occupancy API, at one CTA an SM)."""
    device = torch.device(device)
    key = (device.index if device.index is not None
           else torch.cuda.current_device())
    if key not in _resident:
        lib = build.library()
        out = {}
        with torch.cuda.device(device):
            for cluster in CLUSTERS:
                n = ctypes.c_int(0)
                build.check(lib.lstm_train_bwd_clusters(
                    cluster, ctypes.byref(n)), "lstm_train_bwd_clusters")
                out[cluster] = n.value * cluster
        _resident[key] = out
    return _resident[key]


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def lstm_train_forward_plain(xw, w_hh, reverse=False, round_bf16=True):
    """xw [T, N, 4H] in the model dtype, w_hh [H, 4H] -> (h [T, N, H] in
    the model dtype, c [T, N, H] and the activations [i, f, g, o] [T, N,
    4H], both bf16 with ``round_bf16`` else f32): kernel A's plain version
    (``lstm_cuda.recurrence_plain``) with c and the activations kept."""
    return recurrence_plain(xw, w_hh, reverse, _store(round_bf16))


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


def _aligned(x):
    return x.clone() if x.data_ptr() % 16 else x  # 16-byte copies


def lstm_train_forward(xw, w_hh, reverse=False, round_bf16=True):
    """R: ``lstm_train_forward_plain`` for CPU tensors, the kernel for
    CUDA ones (the persistent kernel where ``forward_plan`` takes the
    shape, else the step kernel)."""
    if xw.device.type == "cpu":
        return lstm_train_forward_plain(xw, w_hh, reverse, round_bf16)
    return _forward(lstm_train_forward, xw, w_hh, reverse, round_bf16)


def lstm_train_forward_step(xw, w_hh, reverse=False, round_bf16=True):
    """R's step kernel whatever the plan, for comparisons; counts no
    launch."""
    return _forward(None, xw, w_hh, reverse, round_bf16)


def _forward(counter, xw, w_hh, reverse, round_bf16):
    """R's checks and launch: the persistent kernel of the plan, the step
    kernel where it is None or where ``counter`` is None (the comparisons'
    route, which counts nothing)."""
    G, io = 4 * w_hh.shape[0], w_hh.dtype
    T, N, H = _check("R", w_hh, xw=(xw, (io,), G))
    lib = build.library()
    dev, store = xw.device, _store(round_bf16)
    h = torch.empty(T, N, H, dtype=io, device=dev)
    c = torch.empty(T, N, H, dtype=store, device=dev)
    acts = torch.empty(T, N, G, dtype=store, device=dev)
    plan = None
    if counter is not None:
        plan = forward_plan(N, H, _sms(dev), io, round_bf16)
        counter.plan = plan
    stream = build.stream_of(xw)
    if plan is None:
        Np = -(-N // ROW_BLOCK) * ROW_BLOCK
        hbuf = torch.zeros(2, Np, H, dtype=io, device=dev)
        cbuf = torch.zeros(N, H, dtype=torch.float32, device=dev)
        if counter is not None:
            counter.launches += 1
        build.check(lib.lstm_train_fwd(
            xw.data_ptr(), _weights(w_hh).data_ptr(), h.data_ptr(),
            c.data_ptr(), acts.data_ptr(), hbuf.data_ptr(), cbuf.data_ptr(),
            int(io == torch.float32), int(round_bf16), T, N, Np, H,
            int(bool(reverse)), stream), "lstm_train_fwd")
        return h, c, acts
    if io == torch.float32:
        w, xw = _aligned(w_hh.contiguous()), _aligned(xw)
        rows = plan["rows"]
        hbuf = torch.empty(2, H, rows + F32_PAD, dtype=io, device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for n0 in range(0, N, plan["n_launch"]):
            hbuf.zero_()
            flag.zero_()
            counter.launches += 1
            build.check(lib.lstm_train_fwd_f32_persistent(
                xw.data_ptr(), w.data_ptr(), h.data_ptr(), c.data_ptr(),
                acts.data_ptr(), hbuf.data_ptr(), flag.data_ptr(), T, N, n0,
                min(plan["n_launch"], N - n0), H, rows, plan["k_slices"],
                plan["kc"], plan["stages"], int(round_bf16),
                int(bool(reverse)), stream), "lstm_train_fwd_f32_persistent")
        return h, c, acts
    wt = w_hh.t().contiguous()  # [4H, H]: a gate column's k contiguous
    rows, slices = plan["rows"], plan["slices"]
    hbuf = torch.empty(2, slices * rows, H, dtype=io, device=dev)
    flags = torch.empty(slices, dtype=torch.int32, device=dev)
    for n0 in range(0, N, plan["n_launch"]):
        hbuf.zero_()
        flags.zero_()
        counter.launches += 1
        build.check(lib.lstm_train_fwd_persistent(
            xw.data_ptr(), wt.data_ptr(), h.data_ptr(), c.data_ptr(),
            acts.data_ptr(), hbuf.data_ptr(), flags.data_ptr(), T, N, n0,
            min(plan["n_launch"], N - n0), H, rows // 16, slices, plan["kc"],
            plan["stages"], plan["cluster"], int(bool(reverse)), stream),
            "lstm_train_fwd_persistent")
    return h, c, acts


def lstm_train_backward(w_hh, acts, c, g_h, reverse=False, round_bf16=True):
    """S: ``lstm_train_backward_plain`` for CPU tensors, the kernel for
    CUDA ones (the persistent kernel where ``backward_plan`` takes the
    shape, else the step kernel)."""
    if acts.device.type == "cpu":
        return lstm_train_backward_plain(w_hh, acts, c, g_h, reverse,
                                         round_bf16)
    return _backward(lstm_train_backward, w_hh, acts, c, g_h, reverse,
                     round_bf16)


def lstm_train_backward_step(w_hh, acts, c, g_h, reverse=False,
                             round_bf16=True):
    """S's step kernel whatever the plan, for comparisons; counts no
    launch."""
    return _backward(None, w_hh, acts, c, g_h, reverse, round_bf16)


def _backward(counter, w_hh, acts, c, g_h, reverse, round_bf16):
    """S's checks and launch, as ``_forward``'s."""
    store, io = _store(round_bf16), w_hh.dtype
    H = w_hh.shape[0]
    T, N, _ = _check("S", w_hh, acts=(acts, (store,), 4 * H),
                     c=(c, (store,), H), g_h=(g_h, (io,), H))
    lib = build.library()
    dev = acts.device
    dgates = torch.empty(T, N, 4 * H, dtype=store, device=dev)
    plan = None
    if counter is not None:
        plan = backward_plan(N, H, _sms(dev), resident_ctas(dev), io,
                             round_bf16)
        counter.plan = plan
    stream = build.stream_of(acts)
    if plan is None:
        Np = -(-N // ROW_BLOCK) * ROW_BLOCK
        dgbuf = torch.zeros(2, Np, 4 * H, dtype=io, device=dev)
        dcbuf = torch.zeros(N, H, dtype=torch.float32, device=dev)
        if counter is not None:
            counter.launches += 1
        build.check(lib.lstm_train_bwd(
            _weights(w_hh).data_ptr(), acts.data_ptr(), c.data_ptr(),
            g_h.data_ptr(), dgates.data_ptr(), dgbuf.data_ptr(),
            dcbuf.data_ptr(), int(io == torch.float32), int(round_bf16), T,
            N, Np, H, int(bool(reverse)), stream), "lstm_train_bwd")
        return dgates
    if io == torch.float32:
        w = w_hh.contiguous()
        acts, c, g_h = _aligned(acts), _aligned(c), _aligned(g_h)
        gbuf = torch.empty(2, 4 * H, plan["ldr"], dtype=io, device=dev)
        flag = torch.empty(1, dtype=torch.int32, device=dev)
        for n0 in range(0, N, plan["n_launch"]):
            gbuf.zero_()
            flag.zero_()
            counter.launches += 1
            build.check(lib.lstm_train_bwd_f32_persistent(
                w.data_ptr(), acts.data_ptr(), c.data_ptr(), g_h.data_ptr(),
                dgates.data_ptr(), gbuf.data_ptr(), flag.data_ptr(), T, N,
                n0, min(plan["n_launch"], N - n0), H, plan["rows"],
                plan["k_slices"], plan["kc"], plan["stages"],
                int(round_bf16), int(bool(reverse)), stream),
                "lstm_train_bwd_f32_persistent")
        return dgates
    w = _weights(w_hh)
    flags = torch.empty(plan["slices"], dtype=torch.int32, device=dev)
    for n0 in range(0, N, plan["n_launch"]):
        flags.zero_()
        counter.launches += 1
        build.check(lib.lstm_train_bwd_persistent(
            w.data_ptr(), acts.data_ptr(), c.data_ptr(), g_h.data_ptr(),
            dgates.data_ptr(), flags.data_ptr(), T, N, n0,
            min(plan["n_launch"], N - n0), H, plan["rows"] // 16,
            plan["slices"], plan["cluster"], plan["stages"],
            int(bool(reverse)), stream), "lstm_train_bwd_persistent")
    return dgates


lstm_train_forward.launches = 0
lstm_train_backward.launches = 0
lstm_train_forward.plan = None   # the plan of the last call (None: the
lstm_train_backward.plan = None  # step kernel)
