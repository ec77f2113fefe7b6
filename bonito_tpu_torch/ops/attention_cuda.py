"""
Kernels K, H, O and L — banded self-attention (``csrc/attention.cu``) —
with their plain PyTorch versions and launch counts.

K, ``fused_rotary_window_attention``, replaces
``bonito_tpu/ops/attention_pallas.py:fused_rotary_window_attention``
(``_fused_kernel_dt``): rotary embedding of q and k, the band-masked
softmax and both products in one kernel, from qkv [N, T, 3, H, D] as the
projection wrote it to [N, T, H, D]. It is the attention of every sup
layer (18 launches per batch). It rounds where the TPU kernel rounds, for
bf16 and f32 input alike: rotary in f32 then bf16, scores from bf16
operands with f32 accumulation, softmax in f32, ``p / sum`` rounded to
bf16, ``p . v`` accumulated in f32 and cast last. The TPU kernel
normalises before the second product, so kernel and plain version do too
(two passes over the scores, no online softmax): they then differ by the
order of f32 sums and the last bit of exp only.

On the card K runs, where ``window_plan`` gives a plan (bf16 or f32 and
any window and head K takes), the stretch kernel of
``csrc/attention_window.cu``: one CTA walks a stretch of consecutive
64-query tiles of one (n, h) and stages each key row once into a ring in
shared memory, producer warps copying (cp.async; from f32 through
registers, rotated and rounded to bf16 on the way) and rotating the next
tile's rows while consumer warps compute the current one. The plan is pure
Python: the stretch, the ring and the CTAs, from the shape and the card's
SMs. Where it is None the earlier kernel of ``csrc/attention.cu`` runs,
one block per 64-query tile; ``fused_rotary_window_attention_old_kernel``
runs that one whatever the plan, for comparisons. Both count one launch
per call.

H and O, ``fused_rotary_window_attention_train`` and
``fused_rotary_window_attention_bwd``, replace ``attention_pallas.py:
fused_rotary_window_attention_train`` (``_fused_fwd_kernel_dt``,
``_fused_bwd_kernel_dt``), the training twin: H is K that also returns each
query's log-sum-exp (lse [N, H, T] f32; its o is K's bit for bit), O the
flash-style backward from qkv, lse, o and the cotangent to dqkv, rotary's
inverse included, rounding where the TPU kernel rounds (``csrc/attention.cu``
lists the points). ``ops.attention.fused_attention_train`` is the autograd
Function around them, 18 + 18 launches per sup train step. On the card O
runs, where ``window_bwd_plan`` gives a plan (bf16, the shapes K takes), the
stretch kernel of ``csrc/attention_window_bwd.cu``: CTAs of two kinds, one
walking query tiles with a ring of key blocks (dq), the other key tiles with
a ring of query blocks (dk, dv), after a row pass that gathers each query's
lse and Di; ``fused_rotary_window_attention_bwd_old_kernel`` runs the
earlier kernel of ``csrc/attention.cu`` whatever the plan, for comparisons.

L, ``local_attention``, replaces ``attention_pallas.py:
local_attention_pallas`` (``_kernel``), the banded attention of the
non-fused route (``ops.attention.attend``): q, k, v [N, H, T, D] with
rotary already applied, f32 scores, p and sums, normalised at the end.
Unlike the TPU kernel it takes any T. Its bf16 instance runs both products
on the tensor cores (the inputs' exact values; p split into three bf16
terms), at the head dim ``padded_head_dim`` picks; its f32 instance stays
on the f32 cores.

Query i sees key j iff ``-left <= j - i <= right`` (and ``j < t_real`` for
K); a masked score is -1e30, not -inf. A row that sees no key gives 0
(the TPU kernels give an unspecified mean of v there; such rows are
padding that the caller drops).

Each wrapper runs the plain version for a tensor on the CPU and the
kernel for a tensor on the card; it never falls back from one to the
other. A kernel's result carries no autograd graph, so on the card each
wrapper raises where a gradient is wanted through its input: the
differentiable routes are ``ops.attention.fused_attention_train`` (H, O)
and ``ops.attention.attend(..., differentiable=True)``. The plain versions
on the CPU stay differentiable as any torch code. ``csrc/attention.cu``
says how the kernels are laid out and what bounds them.
"""

import ctypes
import functools

import torch

from bonito_tpu_torch.ops import build

NEG = -1e30
BLOCK = 128        # bonito_tpu's attention block: the band must fit one
MAX_D = 128        # the widest head the kernels keep on chip
SLAB = 1 << 28     # score entries a plain version holds at a time


def _window_fits(window):
    left, right = window
    return 0 <= left < BLOCK and 0 <= right <= BLOCK


# kernel K's stretch kernel (csrc/attention_window.cu)
WINDOW_TILE = 64        # queries a tile, keys a block of the ring (WQ)
WINDOW_WARPS = 6        # 4 consumer warps of 16 query rows, 2 producers
WINDOW_HEAD_DIMS = (32, 64, 128)  # the instances: D is zero-padded up
WINDOW_DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}  # of qkv
SMEM_LIMIT = 232448     # 227 KB, the most a block may ask for
SM_SMEM = 233472        # 228 KB an SM; each resident block reserves 1 KB


def _cdiv(a, b):
    return -(-a // b)


def window_smem(ring, head_dim):
    """Shared memory of one CTA of the stretch kernel: the ring's k and v
    blocks, two tiles of q (bf16 rows of the padded head dim) and four
    mbarriers."""
    return (2 * ring + 2) * WINDOW_TILE * head_dim * 2 + 32


def window_plan(N, T, H, D, window, dtype, sms):
    """The stretch kernel's plan for qkv [N, T, 3, H, D] of ``dtype`` (bf16
    or f32) and a band ``window`` = (left, right) on a card of ``sms`` SMs,
    or None where the kernel does not take the shape (another dtype; a head
    or window beyond what K takes): then K and H run the earlier kernel.
    Both dtypes keep bf16 rows in the ring (f32 qkv is rotated and rounded
    as it is staged), so their plans differ in ``dtype`` alone.

    Tile t of 64 queries sees the key blocks t - back .. t + ahead (back =
    ceil(left / 64), ahead = floor((63 + right) / 64)); the ring holds two
    more, so the producers fill a tile's new block while the consumers
    read the tile before. One CTA walks ``stretch`` consecutive tiles of
    one (n, h): its first tile stages the leading window, each later tile
    one block. The stretch is the one whose waves of CTAs (``resident`` a
    SM) cost least, counting a tile's work as one and a stretch's first
    tile as two; the longest among equals."""
    left, right = (int(w) for w in window)
    if (dtype not in WINDOW_DTYPES or D % 8 or not 8 <= D <= MAX_D
            or not _window_fits(window) or min(N, T, H, sms) < 1):
        return None
    head_dim = next(p for p in WINDOW_HEAD_DIMS if p >= D)
    back = _cdiv(left, WINDOW_TILE)
    ahead = (WINDOW_TILE - 1 + right) // WINDOW_TILE
    ring = back + ahead + 2
    smem = window_smem(ring, head_dim)
    if smem > SMEM_LIMIT:
        return None
    # the kernel asks for two CTAs an SM at a head dim up to 64, one above
    resident = min(2 if head_dim <= 64 else 1, SM_SMEM // (smem + 1024))
    n_tiles = _cdiv(T, WINDOW_TILE)
    slots = sms * resident
    best = None
    for stretch in range(1, n_tiles + 1):
        ctas = N * H * _cdiv(n_tiles, stretch)
        cost = _cdiv(ctas, slots) * (stretch + 1)
        if best is None or cost <= best[0]:
            best = (cost, stretch, ctas)
    _, stretch, ctas = best
    if ctas > 2 ** 31 - 1:
        return None
    return {"tile": WINDOW_TILE, "stretch": stretch,
            "stretches": _cdiv(n_tiles, stretch), "tiles": n_tiles,
            "ctas": ctas, "waves": _cdiv(ctas, slots), "resident": resident,
            "ring": ring, "back": back, "ahead": ahead,
            "head_dim": head_dim, "warps": WINDOW_WARPS, "smem": smem,
            "dtype": WINDOW_DTYPES[dtype]}


# kernel O's stretch kernel (csrc/attention_window_bwd.cu): products a
# visible pair in a tile of each kind (s, dp and dq; s, dp and dk, then s
# again and dv)
WINDOW_BWD_TILE_COST = {"dk": 5, "dq": 3}


def window_bwd_smem(ring, head_dim):
    """Shared memory of one CTA of O's stretch kernel: the ring's two kinds
    of rows (k and v, or q and do), the tile's two (q and do, or k and v)
    and six mbarriers."""
    return (2 * ring + 2) * WINDOW_TILE * head_dim * 2 + 48


def _makespan(runs, slots):
    """When the last CTA ends, CTAs of the (count, cost) ``runs`` starting
    in launch order, each on the first of ``slots`` slots to come free."""
    free = {0: slots}  # the time a slot comes free -> slots
    for count, cost in runs:
        while count > 0:
            at = min(free)
            k = min(free[at], count)
            free[at] -= k
            if not free[at]:
                del free[at]
            free[at + cost] = free.get(at + cost, 0) + k
            count -= k
    return max(free)


@functools.lru_cache(maxsize=64)
def window_bwd_plan(N, T, H, D, window, dtype, sms):
    """O's stretch kernel's plan for qkv [N, T, 3, H, D] of ``dtype`` and
    a band ``window`` = (left, right) on a card of ``sms`` SMs, or None
    where the kernel does not take the shape (f32; a head or window beyond
    what K takes): then O runs the earlier kernel.

    One launch holds two kinds of CTA, the dk kind first: a dq CTA walks
    ``stretch`` consecutive 64-query tiles of one (n, h) with a ring of key
    blocks, tile t seeing blocks t - back .. t + ahead (back =
    ceil(left / 64), ahead = ceil(right / 64)); a dk CTA walks 64-key tiles
    with a ring of query blocks over the mirrored band (back and ahead
    swapped). Both rings hold back + ahead + 2 blocks. Each kind's CTAs
    come in order of their stretch (every (n, h)'s first, then every
    second, ...). The stretch is the one whose CTAs, each starting in that
    order on the first of the card's slots (``resident`` a SM) to come
    free, end soonest, a tile of each kind costing its products a pair
    (``WINDOW_BWD_TILE_COST``) and a stretch's first tile twice that; the
    longest among equals. Cached (``window`` a tuple): the search takes
    longer on the host than the kernel on the card at sup training, and
    every layer of a step asks for the same plan; callers read the dict it
    returns and do not change it."""
    left, right = (int(w) for w in window)
    if (dtype != torch.bfloat16 or D % 8 or not 8 <= D <= MAX_D
            or not _window_fits(window) or min(N, T, H, sms) < 1):
        return None
    head_dim = next(p for p in WINDOW_HEAD_DIMS if p >= D)
    wl, wr = _cdiv(left, WINDOW_TILE), _cdiv(right, WINDOW_TILE)
    ring = wl + wr + 2
    smem = window_bwd_smem(ring, head_dim)
    if smem > SMEM_LIMIT:
        return None
    resident = min(2 if head_dim <= 64 else 1, SM_SMEM // (smem + 1024))
    n_tiles = _cdiv(T, WINDOW_TILE)
    slots = sms * resident
    best = None
    for stretch in range(1, n_tiles + 1):
        n_str = _cdiv(n_tiles, stretch)
        last = n_tiles - (n_str - 1) * stretch
        runs = []
        for kind in ("dk", "dq"):
            w = WINDOW_BWD_TILE_COST[kind]
            runs += [(N * H * (n_str - 1), w * (stretch + 1)),
                     (N * H, w * (last + 1))]
        cost = _makespan(runs, slots)
        if best is None or cost <= best[0]:
            best = (cost, stretch, n_str)
    _, stretch, n_str = best
    ctas = 2 * N * H * n_str
    if ctas > 2 ** 31 - 1:
        return None
    return {"tile": WINDOW_TILE, "stretch": stretch, "stretches": n_str,
            "tiles": n_tiles, "ctas": ctas, "waves": _cdiv(ctas, slots),
            "resident": resident, "ring": ring,
            "dq": {"back": wl, "ahead": wr}, "dk": {"back": wr, "ahead": wl},
            "head_dim": head_dim, "warps": WINDOW_WARPS, "smem": smem}


def window_bwd_entry(plan):
    """The C entry that O launches for ``plan``."""
    return ("fused_rotary_window_attention_bwd_stretch" if plan is not None
            else "fused_rotary_window_attention_bwd")


def window_entry(plan, with_lse):
    """The C entry that K (H, ``with_lse``) launches for ``plan``."""
    if plan is not None:
        return "fused_rotary_window_attention_stretch"
    return ("fused_rotary_window_attention_lse" if with_lse
            else "fused_rotary_window_attention")


def fused_supported(qkv, window, rotary_dim):
    """The shapes kernel K takes — bonito_tpu's ``fused_supported`` without
    its TPU terms (the backend and the VMEM budget), and with the widest
    head the kernel holds: a band inside one 128-block, D a multiple of 8
    up to 128, rotary_dim a multiple of 16 up to D. Any T, N and H."""
    if qkv.dim() != 5 or qkv.shape[2] != 3 or window is None:
        return False
    D = qkv.shape[4]
    return (_window_fits(window) and D % 8 == 0 and 0 < D <= MAX_D
            and rotary_dim % 16 == 0 and 0 < rotary_dim <= D)


# the head dims kernel L's bf16 instance is built for (D is zero-padded up
# to the next; its tiles of 64 queries and 64 keys are fixed in the kernel)
L_PADDED = (16, 32, 48, 64, 96, 128)


def padded_head_dim(D):
    """The head dim kernel L's bf16 instance runs at for heads of D: the
    least of ``L_PADDED`` that is at least D (40 becomes 48). The wrapper
    passes it to the kernel, which instantiates one template for each."""
    return next(p for p in L_PADDED if p >= D)


def local_supported(q, window):
    """The shapes kernel L takes: bonito_tpu's ``supported`` without the
    T % 128 and backend terms, with D up to 128."""
    D = q.shape[-1]
    return (q.dim() == 4 and window is not None and _window_fits(window)
            and D % 8 == 0 and 0 < D <= MAX_D)


def band_mask(T, window, t_real=None, device=None):
    """[T, T] bool: key j visible to query i."""
    left, right = window
    i = torch.arange(T, device=device)[:, None]
    j = torch.arange(T, device=device)[None, :]
    mask = (j - i >= -left) & (j - i <= right)
    if t_real is not None:
        mask = mask & (j < t_real)
    return mask


def rotary_inv_f32(x, cos, sin):
    """The inverse (transpose) of ``rotary_f32``, the rotation by -theta,
    as bonito_tpu's ``_rot_dt_inv``."""
    r2 = cos.shape[-1]
    x1, x2, rest = x[..., :r2], x[..., r2:2 * r2], x[..., 2 * r2:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c + x2 * s, x2 * c - x1 * s, rest], dim=-1)


def rotary_f32(x, cos, sin):
    """Non-interleaved rotary on the leading 2 * r2 of the head dim, in
    f32, every product and sum rounded on its own. x [N, T, H, D] f32;
    cos/sin [T, r2] f32."""
    r2 = cos.shape[-1]
    x1, x2, rest = x[..., :r2], x[..., r2:2 * r2], x[..., 2 * r2:]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s, rest], dim=-1)


def _slabs(N, H, T):
    step = max(1, SLAB // (H * T * T))
    return [(n, min(n + step, N)) for n in range(0, N, step)]


def _rotated_bf16(x, cos, sin):
    """q, k, v of an f32 slab of qkv [n, T, 3, H, D] as the kernels multiply
    them: q and k rotated in f32, all three rounded to bf16; [n, H, T, D]
    f32."""
    bf16 = torch.bfloat16
    q = rotary_f32(x[:, :, 0], cos, sin).to(bf16).float().transpose(1, 2)
    k = rotary_f32(x[:, :, 1], cos, sin).to(bf16).float().transpose(1, 2)
    v = x[:, :, 2].to(bf16).float().transpose(1, 2)
    return q, k, v


def _fused_plain(qkv, cos, sin, window, t_real, with_lse):
    N, T, _, H, D = qkv.shape
    mask = band_mask(T, window, t_real, qkv.device)
    cos, sin = cos.float(), sin.float()
    scale = 1.0 / D ** 0.5
    out = torch.empty(N, T, H, D, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(N, H, T, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    for a, b in _slabs(N, H, T):
        q, k, v = _rotated_bf16(qkv[a:b].float(), cos, sin)
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG)
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        den = p.sum(-1, keepdim=True)
        if with_lse:
            lse[a:b] = (m + torch.log(den))[..., 0]
        p = torch.where(mask, p / den, 0.0).to(torch.bfloat16).float()
        out[a:b] = torch.matmul(p, v).transpose(1, 2).to(qkv.dtype)
    return out, lse


def fused_rotary_window_attention_plain(qkv, cos, sin, window, t_real=None):
    """qkv [N, T, 3, H, D] (bf16 or f32); cos/sin [T, r2] f32 ->
    [N, T, H, D] in qkv's dtype, rounding as the module says. ``t_real``
    masks the keys at and beyond it (a stream the caller padded)."""
    return _fused_plain(qkv, cos, sin, window, t_real, False)[0]


def fused_rotary_window_attention_train_plain(qkv, cos, sin, window,
                                              t_real=None):
    """H's function: (``fused_rotary_window_attention_plain``'s o, lse
    [N, H, T] f32 = max + log(sum) of each query's scaled, masked scores;
    about -1e30 where a query sees no key)."""
    return _fused_plain(qkv, cos, sin, window, t_real, True)


def fused_rotary_window_attention_bwd_plain(qkv, cos, sin, lse, o, do,
                                            window, t_real=None):
    """O's function: dqkv [N, T, 3, H, D] in qkv's dtype from qkv, cos/sin,
    H's lse and o, and o's cotangent ``do``, with the TPU kernel's rounding
    points: p = exp(s - lse) (0 where masked), dp = bf16(do) . bf16(v), Di
    = sum do o in f32, ds = bf16(p (dp - Di) / sqrt(D)), dq and dk
    accumulated in f32 from bf16 operands and rotated back by -theta in
    f32, dv = bf16(p)^T . bf16(do). cos and sin get no gradient."""
    N, T, _, H, D = qkv.shape
    bf16 = torch.bfloat16
    mask = band_mask(T, window, t_real, qkv.device)
    cos, sin = cos.float(), sin.float()
    scale = 1.0 / D ** 0.5
    dqkv = torch.empty_like(qkv, memory_format=torch.contiguous_format)
    for a, b in _slabs(N, H, T):
        q, k, v = _rotated_bf16(qkv[a:b].float(), cos, sin)
        d_o = do[a:b].float().transpose(1, 2)
        s = torch.matmul(q, k.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse[a:b, :, :, None]), 0.0)
        dp = torch.matmul(d_o.to(bf16).float(), v.transpose(-1, -2))
        di = (d_o * o[a:b].float().transpose(1, 2)).sum(-1, keepdim=True)
        ds = (p * (dp - di) * scale).to(bf16).float()
        dq = rotary_inv_f32(torch.matmul(ds, k).transpose(1, 2), cos, sin)
        dk = rotary_inv_f32(torch.matmul(ds.transpose(-1, -2), q)
                            .transpose(1, 2), cos, sin)
        dv = torch.matmul(p.to(bf16).float().transpose(-1, -2),
                          d_o.to(bf16).float()).transpose(1, 2)
        dqkv[a:b] = torch.stack([dq, dk, dv], dim=2).to(qkv.dtype)
    return dqkv


def local_attention_plain(q, k, v, window):
    """q, k, v [N, H, T, D] -> [N, H, T, D] in q's dtype: f32 operands,
    band-masked softmax, ``(p . v) / sum``."""
    N, H, T, D = q.shape
    mask = band_mask(T, window, None, q.device)
    scale = 1.0 / D ** 0.5
    out = torch.empty_like(q)
    for a, b in _slabs(N, H, T):
        s = torch.matmul(q[a:b].float(),
                         k[a:b].float().transpose(-1, -2)) * scale
        s = torch.where(mask, s, NEG)
        p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        o = torch.matmul(p, v[a:b].float()) / p.sum(-1, keepdim=True)
        out[a:b] = o.to(q.dtype)
    return out


def _check_types(name, tensors):
    first = tensors[0]
    if first.device.type != "cuda" or any(
            t.device != first.device for t in tensors):
        raise ValueError(f"kernel {name} needs its tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if first.dtype not in (torch.bfloat16, torch.float32) or any(
            t.dtype != first.dtype for t in tensors):
        raise TypeError(f"kernel {name} takes bf16 or f32 tensors of one "
                        f"type, got {[t.dtype for t in tensors]}")


def _check_packed(name, **tensors):
    """Kernel K's vector loads need contiguous tensors at 16-byte
    addresses; the wrapper copies nothing on the card."""
    for what, x in tensors.items():
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(
                f"kernel {name} needs a contiguous {what} at a 16-byte "
                f"address, got strides {tuple(x.stride())} at offset "
                f"{x.data_ptr() % 16} (ops.relayout.pin_layout copies one)")


FUSED_GRAD_ROUTE = ("ops.attention.fused_attention_train (kernels H and O) "
                    "is the differentiable route")


def _check_fused(name, qkv, cos, sin, window, t_real):
    """Kernels K, H and O's checks of qkv, cos, sin, the window and t_real;
    returns (rotary_dim, t_real)."""
    _check_types(name, [qkv])
    if cos.device != qkv.device or sin.device != qkv.device:
        raise ValueError(f"kernel {name} needs cos and sin on {qkv.device}")
    if cos.dtype != torch.float32 or sin.dtype != torch.float32:
        raise TypeError(f"kernel {name} takes f32 cos and sin, got "
                        f"{cos.dtype} and {sin.dtype}")
    rotary_dim = 2 * cos.shape[-1]
    if not fused_supported(qkv, window, rotary_dim):
        raise ValueError(
            f"kernel {name}: qkv {tuple(qkv.shape)}, window {window}, "
            f"rotary_dim {rotary_dim} need [N, T, 3, H, D] with D a multiple "
            f"of 8 up to {MAX_D}, 0 <= left < {BLOCK}, 0 <= right <= {BLOCK} "
            f"and rotary_dim a multiple of 16 up to D")
    N, T = qkv.shape[:2]
    t_real = T if t_real is None else int(t_real)
    if (tuple(cos.shape) != (T, rotary_dim // 2) or cos.shape != sin.shape
            or N < 1 or T < 1 or not 1 <= t_real <= T):
        raise ValueError(
            f"kernel {name}: cos {tuple(cos.shape)} and sin "
            f"{tuple(sin.shape)} must be [T, rotary_dim / 2] for qkv "
            f"{tuple(qkv.shape)}, and t_real {t_real} in 1 .. T")
    _check_packed(name, qkv=qkv, cos=cos, sin=sin)
    return rotary_dim, t_real


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _fused_forward(name, counter, qkv, cos, sin, window, t_real, with_lse):
    """K's (H's, ``with_lse``) checks and launch: the stretch kernel on the
    plan ``window_plan`` gives, the earlier kernel where it gives None or
    where ``counter`` is None (the comparisons' route, which counts
    nothing). Returns (out, lse or None)."""
    build.refuse_grad(name, [qkv], FUSED_GRAD_ROUTE)
    rotary_dim, t_real = _check_fused(name, qkv, cos, sin, window, t_real)
    N, T, _, H, D = qkv.shape
    out = torch.empty(N, T, H, D, dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty(N, H, T, dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    plan = None
    if counter is not None:
        plan = window_plan(N, T, H, D, window, qkv.dtype, _sms(qkv.device))
        counter.plan = plan
        counter.launches += 1
    entry = window_entry(plan, with_lse)
    args = [qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr()]
    if with_lse or plan is not None:
        args.append(lse.data_ptr() if with_lse else None)
    args += [N, T, H, D, rotary_dim // 2, int(window[0]), int(window[1]),
             t_real]
    if plan is not None:
        args += [plan["stretch"], plan["ring"]]
    args.append(int(qkv.dtype == torch.float32))
    build.check(getattr(build.library(), entry)(*args, build.stream_of(qkv)),
                entry)
    return out, lse


def fused_rotary_window_attention(qkv, cos, sin, window, t_real=None):
    """``fused_rotary_window_attention_plain``'s function: the plain
    version for a CPU tensor, kernel K for a CUDA tensor (bf16 or f32;
    shapes as ``fused_supported`` says): the stretch kernel on
    ``window_plan``'s plan (recorded in ``.plan``), else the earlier
    kernel. A build or launch failure raises."""
    if qkv.device.type == "cpu":
        return fused_rotary_window_attention_plain(qkv, cos, sin, window,
                                                   t_real)
    return _fused_forward("K", fused_rotary_window_attention, qkv, cos, sin,
                          window, t_real, False)[0]


def fused_rotary_window_attention_train(qkv, cos, sin, window, t_real=None):
    """``fused_rotary_window_attention_train_plain``'s function, (o, lse):
    the plain version for a CPU tensor, kernel H for a CUDA tensor (as K
    takes it, on K's route)."""
    if qkv.device.type == "cpu":
        return fused_rotary_window_attention_train_plain(qkv, cos, sin,
                                                         window, t_real)
    return _fused_forward("H", fused_rotary_window_attention_train, qkv, cos,
                          sin, window, t_real, True)


def fused_rotary_window_attention_old_kernel(qkv, cos, sin, window,
                                             t_real=None, with_lse=False):
    """K's (H's, ``with_lse``: (o, lse)) earlier kernel, one block per
    64-query tile, whatever the plan (CUDA tensors only): the route where
    ``window_plan`` gives None, and what chip_smoke.py and the card tests
    hold the stretch kernel against. It counts no launch."""
    out, lse = _fused_forward("H" if with_lse else "K", None, qkv, cos, sin,
                              window, t_real, with_lse)
    return (out, lse) if with_lse else out


def _fused_backward(counter, qkv, cos, sin, lse, o, do, window, t_real):
    """O's checks and launch: the stretch kernel on the plan
    ``window_bwd_plan`` gives, the earlier kernel where it gives None or
    where ``counter`` is None (the comparisons' route, which counts
    nothing)."""
    build.refuse_grad("O", [qkv, o, do], FUSED_GRAD_ROUTE)
    rotary_dim, t_real = _check_fused("O", qkv, cos, sin, window, t_real)
    _check_types("O", [qkv, o, do])
    N, T, _, H, D = qkv.shape
    if (tuple(o.shape) != (N, T, H, D) or o.shape != do.shape
            or tuple(lse.shape) != (N, H, T) or lse.dtype != torch.float32
            or lse.device != qkv.device):
        raise ValueError(
            f"kernel O: o {tuple(o.shape)} and do {tuple(do.shape)} must be "
            f"[N, T, H, D] and lse {tuple(lse.shape)} {lse.dtype} [N, H, T] "
            f"f32 for qkv {tuple(qkv.shape)}")
    _check_packed("O", o=o, do=do, lse=lse)
    dqkv = torch.empty_like(qkv)
    plan = None
    if counter is not None:
        plan = window_bwd_plan(N, T, H, D, tuple(window), qkv.dtype,
                               _sms(qkv.device))
        counter.plan = plan
        counter.launches += 1
    entry = window_bwd_entry(plan)
    args = [qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), lse.data_ptr(),
            o.data_ptr(), do.data_ptr()]
    if plan is not None:
        # each query's (lse, Di), padded to whole tiles: the row pass's
        rows = torch.empty(N, H, plan["tiles"] * WINDOW_TILE, 2,
                           dtype=torch.float32, device=qkv.device)
        args.append(rows.data_ptr())
    args += [dqkv.data_ptr(), N, T, H, D, rotary_dim // 2, int(window[0]),
             int(window[1]), t_real]
    args += ([plan["stretch"], plan["ring"]] if plan is not None
             else [int(qkv.dtype == torch.float32)])
    build.check(getattr(build.library(), entry)(*args, build.stream_of(qkv)),
                entry)
    return dqkv


def fused_rotary_window_attention_bwd(qkv, cos, sin, lse, o, do, window,
                                      t_real=None):
    """``fused_rotary_window_attention_bwd_plain``'s function: the plain
    version for CPU tensors, kernel O for CUDA tensors (qkv, o and do of one
    type, contiguous; lse [N, H, T] f32 as H wrote it): the stretch kernel
    on ``window_bwd_plan``'s plan (recorded in ``.plan``), else the earlier
    kernel."""
    if qkv.device.type == "cpu":
        return fused_rotary_window_attention_bwd_plain(qkv, cos, sin, lse, o,
                                                       do, window, t_real)
    return _fused_backward(fused_rotary_window_attention_bwd, qkv, cos, sin,
                           lse, o, do, window, t_real)


def fused_rotary_window_attention_bwd_old_kernel(qkv, cos, sin, lse, o, do,
                                                 window, t_real=None):
    """O's earlier kernel, one block per 64-token tile and kind, whatever
    the plan (CUDA tensors only): the route where ``window_bwd_plan`` gives
    None, and what chip_smoke.py and the card tests hold the stretch kernel
    against. It counts no launch."""
    return _fused_backward(None, qkv, cos, sin, lse, o, do, window, t_real)


def local_attention(q, k, v, window):
    """``local_attention_plain``'s function: the plain version for a CPU
    tensor, kernel L for CUDA tensors (bf16 or f32, D a multiple of 8 up
    to 128, a band inside one 128-block; any strides with a contiguous D).
    The result has q's strides."""
    if q.device.type == "cpu":
        return local_attention_plain(q, k, v, window)
    build.refuse_grad("L", [q, k, v], "ops.attention.attend(..., "
                      "differentiable=True) is the differentiable route")
    _check_types("L", [q, k, v])
    if not local_supported(q, window) or k.shape != q.shape \
            or v.shape != q.shape or q.numel() == 0:
        raise ValueError(
            f"kernel L: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, window {window} need three [N, H, T, D] with "
            f"D a multiple of 8 up to {MAX_D}, 0 <= left < {BLOCK} and "
            f"0 <= right <= {BLOCK}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(
            f"kernel L needs a contiguous head dim, got strides "
            f"{[tuple(t.stride()) for t in (q, k, v)]} "
            f"(ops.relayout.pin_layout copies one)")
    out = torch.empty_like(q)  # q's strides: dense, D contiguous
    if out.stride(-1) != 1:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    N, H, T, D = q.shape
    dp = padded_head_dim(D)
    local_attention.launches += 1
    build.check(build.library().local_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        (ctypes.c_longlong * 12)(*strides), N, H, T, D, dp, int(window[0]),
        int(window[1]), int(q.dtype == torch.float32), build.stream_of(q)),
        "local_attention")
    return out


fused_rotary_window_attention.launches = 0
fused_rotary_window_attention_train.launches = 0
fused_rotary_window_attention.plan = None  # the last call's (None: earlier)
fused_rotary_window_attention_train.plan = None
fused_rotary_window_attention_bwd.launches = 0
fused_rotary_window_attention_bwd.plan = None
local_attention.launches = 0
