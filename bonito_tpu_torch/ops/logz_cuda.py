"""
Kernels U, V, W and X — the CRF partition function and its gradient for
the training loss (``csrc/logz.cu``) — with their launch counts. The plain
versions, the autograd Functions and the routes are in ``ops/logz.py``.

U replaces ``bonito_tpu/ops/logz_pallas.py:_fwd_kernel_tcn`` (and
``_fwd_kernel_tcn_nockpt``: U without its stack), V ``_bwd_kernel_tcn``,
W ``_fwd_kernel`` (and ``_fwd_kernel_nockpt``), X ``_bwd_kernel``. U and V
read the decode layout: moves [N, T, nb*S], each frame's columns in
(b, j, r) order, with a constant stay ``blank`` — the memory that
``Model.forward_tcn``'s [T, S*nb, N] view lies on. W and X read full
scores [N, T, S*(nb+1)] with a stay plane. The recursion over T is
serial: one CTA per batch row, one recursion step per frame.

On the card U, V, W and X run on the ring of ``csrc/logz_ring.cu`` (each
frame's row staged ahead in shared memory by a producer warp, 1 or 4
states a consumer thread, one barrier a frame; W is U's kernel over the
full scores' slot) where ``logz_plan`` gives a plan; ``tcn_forward.plan``,
``tcn_backward.plan``, ``full_forward.plan`` and ``full_backward.plan``
hold the last call's. The earlier kernels of ``csrc/logz.cu`` (one thread
per state, the frame's row loaded when the frame starts) run where it
gives None (pointers that are not 16-byte aligned, W's and X's rows of
bf16 at S 4) and in the ``*_old_kernel`` wrappers, which count no launch;
every output of the ring equals theirs bit for bit.

Each wrapper launches a kernel for a CUDA tensor and raises for anything
else; it never runs the plain version.
"""

import torch

from bonito_tpu_torch.ops import build

NB = 4  # n_base; the kernels are written for the 4-letter alphabet
STATES = (4, 16, 64, 256, 1024)  # S = 4**k
# frames the ring of csrc/logz_ring.cu holds (its C entries take 2 to 16):
# a frame's copy is issued about RING - 1 frames before its row is read
RING = 8
# the states a consumer thread of the ring takes, by S (scripts/
# logz_split.py times 1 and 4 a thread: four won at S 1024, eight warps;
# one at S 64 and 256, where four leave warps empty or idle lanes)
STATES_PER_THREAD = {4: 1, 16: 1, 64: 1, 256: 1, 1024: 4}
# the most threads a CTA of the ring has (``LOGZ_THREADS``): 8 consumer
# warps and the producer
THREADS = 288
# kernel X's consumer threads by S (the first S / k of them also take the
# chain; all of them the gradient's pass over the frame's 5S columns): one
# column a thread up to 384 threads, as measured fastest at S 64 and 1024
# (scripts/logz_split.py x on an H100: 320 and 384 threads; 256 not
# measured), within the C entry's ``X_THREADS`` a CTA (csrc/logz_ring.cu)
X_CONSUMERS = {4: 32, 16: 96, 64: 320, 256: 384, 1024: 384}
X_THREADS = 640 + 32


def ring_consumers(S, k):
    """The ring's consumer threads: S / k, rounded up to whole warps."""
    return -(-(S // k) // 32) * 32


def logz_smem(S, ring, dtype, backward, full=False):
    """Shared memory of one CTA of the ring kernels (``logz_fwd_smem``,
    ``logz_bwd_smem`` and ``logz_full_bwd_smem`` of csrc/logz_ring.cu): the
    mbarriers, alpha (U, W) or beta (V, X) of two parities, and the ring of
    slots: a frame's 4S moves (5S scores when ``full``) in ``dtype``, and
    for V and X also its row of the alpha stack (4S bytes)."""
    head = (ring * 8 + 15) // 16 * 16
    row = (NB + 1 if full else NB) * S * dtype.itemsize
    return head + 8 * S + ring * (row + (4 * S if backward else 0))


def logz_plan(N, T, S, dtype, sms=None, aligned=True, full=False):
    """The plan of kernels U and V (W and X with ``full``: scores [N, T,
    5S]) on the ring (``csrc/logz_ring.cu``) for moves [N, T, 4S] of
    ``dtype`` (what ``_check`` takes: bf16 or f32, S in ``STATES``) on a
    card of ``sms`` SMs, or None where a pointer is not 16-byte aligned
    (``aligned`` false) or, for W and X, a frame's row of scores is no
    whole number of 16-byte pieces (bf16 at S 4: 40 B): the ring's bulk
    copies need both; then the earlier kernels run. One CTA per batch row:
    S / k consumer threads of k states each (k by S,
    ``STATES_PER_THREAD``; rounded up to whole warps) and a producer warp,
    rings of ``RING`` frames. With ``full`` the top-level consumers are X's
    (``X_CONSUMERS``; the first S / k of them take the chain), and the
    forward part, W's, carries its own ``threads``: U's S / k consumers
    and the producer."""
    if not aligned or (full and (NB + 1) * S * dtype.itemsize % 16):
        return None
    k = STATES_PER_THREAD[S]
    consumers = X_CONSUMERS[S] if full else ring_consumers(S, k)
    plan = {"threads": consumers + 32, "consumer_threads": consumers,
            "states_per_thread": k, "ctas": N,
            "waves": None if sms is None else -(-N // sms)}
    for name, backward in (("fwd", False), ("bwd", True)):
        plan[name] = {"ring": RING,
                      "smem": logz_smem(S, RING, dtype, backward, full)}
    if full:
        plan["fwd"]["threads"] = ring_consumers(S, k) + 32
    return plan


def logz_entry(plan, backward, full=False):
    """The C entry a plan of U, V, W or X (``full``) launches: the
    ring's, or the earlier kernel's where the plan, or its part for the
    pass, is None."""
    if plan is None or plan["bwd" if backward else "fwd"] is None:
        return "logz_bwd" if backward else "logz_fwd"
    if full:
        return "logz_full_bwd_ring" if backward else "logz_full_fwd_ring"
    return "logz_tcn_bwd_ring" if backward else "logz_tcn_fwd_ring"


def _check(scores, full, name):
    """(N, T, S) of a score tensor kernel ``name`` takes: a contiguous
    bf16 or f32 CUDA tensor [N, T, S*nb] (S*(nb+1) when ``full``)."""
    if scores.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {scores.device}")
    if scores.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} takes bf16 or f32 scores, got "
                        f"{scores.dtype}")
    if scores.dim() != 3 or not scores.is_contiguous():
        raise ValueError(f"{name} takes contiguous scores [N, T, C]")
    N, T, C = scores.shape
    width = NB + 1 if full else NB
    S = C // width
    if C != width * S or S not in STATES or N < 1 or T < 1:
        raise ValueError(f"{name}: scores {tuple(scores.shape)} need "
                         f"{width}*S columns with S in {STATES}")
    return N, T, S


def _check_f32(name, device, **tensors):
    for key, (x, shape) in tensors.items():
        if (tuple(x.shape) != shape or x.dtype != torch.float32
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"{name}: {key} must be a contiguous f32 "
                             f"{shape} on {device}")


def _plan(counter, scores, full, *tensors):
    """The plan a counted launch of U, V, W or X takes (recorded in
    ``counter.plan``); None where ``counter`` is None (the comparisons'
    route, which counts nothing)."""
    if counter is None:
        return None
    N, T, C = scores.shape
    plan = logz_plan(
        N, T, C // (NB + 1 if full else NB), scores.dtype,
        torch.cuda.get_device_properties(scores.device).multi_processor_count,
        aligned=all(t.data_ptr() % 16 == 0
                    for t in (scores, *tensors) if t is not None), full=full)
    counter.plan = plan
    counter.launches += 1
    return plan


def _forward(counter, name, scores, full, blank, round_bf16, with_stack):
    """U's or W's checks and launch: on the ring where ``logz_plan`` gives
    a plan, the earlier kernel elsewhere."""
    N, T, S = _check(scores, full, name)
    lib = build.library()
    dev = scores.device
    stack = torch.empty(N, T, S, device=dev) if with_stack else None
    logz = torch.empty(N, device=dev)
    plan = _plan(counter, scores, full, stack)
    entry = logz_entry(plan, False, full)
    ring = entry != "logz_fwd"
    args = [scores.data_ptr(), int(scores.dtype == torch.float32)]
    args += [] if ring else [int(full)]
    args += [int(round_bf16), None if stack is None else stack.data_ptr(),
             logz.data_ptr(), N, T, S]
    args += [plan["states_per_thread"], plan["fwd"]["ring"]] if ring else []
    args += [] if entry == "logz_full_fwd_ring" else [float(blank)]
    build.check(getattr(lib, entry)(*args, build.stream_of(scores)), entry)
    return stack, logz


def _backward(counter, name, scores, full, stack, logz, g, blank,
              round_bf16, out_dtype):
    """V's or X's checks and launch, routed as ``_forward``'s."""
    N, T, S = _check(scores, full, name)
    _check_f32(name, scores.device, stack=(stack, (N, T, S)),
               logz=(logz, (N,)), g=(g, (N,)))
    out_dtype = scores.dtype if out_dtype is None else out_dtype
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name} writes bf16 or f32, not {out_dtype}")
    lib = build.library()
    grad = torch.empty(scores.shape, dtype=out_dtype, device=scores.device)
    plan = _plan(counter, scores, full, stack, grad)
    entry = logz_entry(plan, True, full)
    ring = entry != "logz_bwd"
    args = [scores.data_ptr(), int(scores.dtype == torch.float32)]
    args += [] if ring else [int(full)]
    args += [int(round_bf16), stack.data_ptr(), logz.data_ptr(),
             g.data_ptr(), grad.data_ptr(), int(out_dtype == torch.float32),
             N, T, S]
    args += [plan["states_per_thread"]] if ring else []
    args += [plan["consumer_threads"]] if entry == "logz_full_bwd_ring" else []
    args += [plan["bwd"]["ring"]] if ring else []
    args += [] if entry == "logz_full_bwd_ring" else [float(blank)]
    build.check(getattr(lib, entry)(*args, build.stream_of(scores)), entry)
    return grad


def tcn_forward(moves, blank, round_bf16=True, with_stack=True):
    """Kernel U: moves [N, T, nb*S] (TCN column order), stay ``blank`` ->
    (alpha stack [N, T, S] f32 or None, logZ [N] f32). On the ring where
    ``logz_plan`` gives a plan (recorded in ``.plan``), else the earlier
    kernel."""
    return _forward(tcn_forward, "kernel U", moves, False, blank,
                    round_bf16, with_stack)


def tcn_backward(moves, stack, logz, g, blank, round_bf16=True,
                 out_dtype=None):
    """Kernel V: d logZ / d moves x g, [N, T, nb*S] in ``out_dtype`` (the
    moves' own by default); routed as ``tcn_forward``."""
    return _backward(tcn_backward, "kernel V", moves, False, stack, logz, g,
                     blank, round_bf16, out_dtype)


def tcn_forward_old_kernel(moves, blank, round_bf16=True, with_stack=True):
    """U's earlier kernel (``csrc/logz.cu``) whatever the plan (CUDA
    tensors only): the route where ``logz_plan`` gives None, and what
    chip_smoke.py and the card tests hold the ring against. It counts no
    launch."""
    return _forward(None, "kernel U", moves, False, blank, round_bf16,
                    with_stack)


def tcn_backward_old_kernel(moves, stack, logz, g, blank, round_bf16=True,
                            out_dtype=None):
    """V's earlier kernel, as ``tcn_forward_old_kernel``."""
    return _backward(None, "kernel V", moves, False, stack, logz, g, blank,
                     round_bf16, out_dtype)


def full_forward(scores, round_bf16=True, with_stack=True):
    """Kernel W: full scores [N, T, (nb+1)*S] -> (alpha stack or None,
    logZ [N] f32); on the ring where ``logz_plan(..., full=True)`` gives a
    plan (recorded in ``.plan``), else the earlier kernel."""
    return _forward(full_forward, "kernel W", scores, True, 0.0, round_bf16,
                    with_stack)


def full_backward(scores, stack, logz, g, round_bf16=True, out_dtype=None):
    """Kernel X: d logZ / d scores x g, [N, T, (nb+1)*S]; on the ring where
    ``logz_plan(..., full=True)`` gives a plan (recorded in ``.plan``),
    else the earlier kernel."""
    return _backward(full_backward, "kernel X", scores, True, stack, logz, g,
                     0.0, round_bf16, out_dtype)


def full_forward_old_kernel(scores, round_bf16=True, with_stack=True):
    """W's earlier kernel, as ``tcn_forward_old_kernel``."""
    return _forward(None, "kernel W", scores, True, 0.0, round_bf16,
                    with_stack)


def full_backward_old_kernel(scores, stack, logz, g, round_bf16=True,
                             out_dtype=None):
    """X's earlier kernel, as ``tcn_forward_old_kernel``."""
    return _backward(None, "kernel X", scores, True, stack, logz, g, 0.0,
                     round_bf16, out_dtype)


tcn_forward.launches = 0
tcn_backward.launches = 0
tcn_forward.plan = None  # the last call's (None: the earlier kernel)
tcn_backward.plan = None
full_forward.launches = 0
full_backward.launches = 0
full_forward.plan = None
full_backward.plan = None
