"""
Kernels B and C — the TCN decode's forward and backward passes
(``csrc/decode_tcn.cu``) — with their plain PyTorch versions and launch
counts.

B replaces ``bonito_tpu/ops/decode_pallas.py:_fwd_kernel_tcn`` and C
``_bwd_kernel_tcn`` plus the qscore epilogue of ``viterbi_decode_tcn``.
Both are bound by bytes on an H100 (the 1.31 GB bf16 move tensor at hac
is read by both passes) but are serial in T, so the pace is the latency
of a frame. On the card they run ``csrc/decode_tcn_ring.cu`` on the plan
``decode_plan`` gives: one CTA per batch row, four states a thread, the
frames' rows staged ahead through a ring in shared memory, one barrier a
frame. Where it gives None the earlier kernels of ``csrc/decode_tcn.cu``
(one thread per state, four barriers a frame) run; ``csrc/decode_passes.
cuh`` has the math.

Moves here are [N, T, nb*S] with each frame's columns in (b, j, r) order
(column (b*nb + j)*R + r: into state s = r*nb + b from p = j*R + r). The
stay score is a constant ``blank`` for the kernels; the plain versions
also take a per-state stay plane [N, T, S], which makes them the plain
versions of kernels M and Q too (``ops/decode_full_cuda.py``).

The plain versions take the kernels' f32 steps one for one: every
product and sum rounded on its own, the sums over j or b in order, the sums
over states in the kernels' block order (``block_sum``). On the card they
give the kernels' bits, qualities included (``csrc/decode_passes.cuh`` says
why that matters).

``tcn_forward``/``tcn_backward`` run the plain version for a tensor on the
CPU and the kernel for a tensor on the card; never one for the other. The
kernels take bf16 moves (a half=True model) or f32 moves (an f32 model: a
``--no-amp`` validation), each on its own instance of the ring and of the
earlier kernels.
"""

import math

import torch

from bonito_tpu_torch.ops import build

NB = 4  # n_base; the kernels are written for the 4-letter alphabet


def _stay_prob(stay, t):
    if isinstance(stay, torch.Tensor):
        return torch.exp(stay[:, t].float())
    return math.exp(stay)


def _stay_score(stay, t):
    if isinstance(stay, torch.Tensor):
        return stay[:, t].float()
    return stay


def block_sum(x):
    """Sum over the last dim in the order of the kernels' block-wide
    sum: an xor butterfly over each warp of 32 states (zeros past the
    end), then over the warps' partials."""
    while x.shape[-1] > 1:
        x = torch.nn.functional.pad(x, (0, -x.shape[-1] % 32))
        x = x.reshape(*x.shape[:-1], -1, 32)
        for o in (16, 8, 4, 2, 1):
            x = x[..., :o] + x[..., o:2 * o]
        x = x[..., 0]
    return x[..., 0]


def tcn_forward_plain(moves, stay):
    """moves [N, T, nb*S]; stay a float or [N, T, S] -> (move_in [N, T, S]
    f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32, end_state [N]
    int32)."""
    N, T, Cm = moves.shape
    S = Cm // NB
    R = S // NB
    dev = moves.device
    A = torch.ones(N, S, device=dev)
    amax = torch.zeros(N, S, device=dev)
    c = torch.zeros(N, device=dev)
    move_in = torch.empty(N, T, S, device=dev)
    choices = torch.empty(N, T, S, dtype=torch.uint8, device=dev)
    cs = torch.empty(N, T, device=dev)
    for t in range(T):
        mv = moves[:, t].float().reshape(N, NB, NB, R)            # [N, b, j, r]
        # sum semiring in probability space, renormalised by the max
        p = torch.exp(mv) * A.reshape(N, 1, NB, R)
        mi = p[:, :, 0] + p[:, :, 1] + p[:, :, 2] + p[:, :, 3]    # [N, b, r]
        mi = mi.transpose(1, 2).reshape(N, S)                     # s = r*nb + b
        a_raw = _stay_prob(stay, t) * A + mi
        m = a_raw.amax(1, keepdim=True)
        inv = 1.0 / m
        A = a_raw * inv
        c = c + torch.log(m[:, 0])
        move_in[:, t] = mi * inv
        cs[:, t] = c
        # max semiring: first j on ties, a move only if strictly better
        cand = mv + amax.reshape(N, 1, NB, R)
        mbest, jbest = cand.max(2)                                # [N, b, r]
        mbest = mbest.transpose(1, 2).reshape(N, S)
        jbest = jbest.transpose(1, 2).reshape(N, S)
        stay_m = _stay_score(stay, t) + amax
        is_move = mbest > stay_m
        amax = torch.where(is_move, mbest, stay_m)
        choices[:, t] = torch.where(is_move, jbest + 1, 0).to(torch.uint8)
    logz = torch.log(block_sum(A)) + c
    end_state = torch.argmax(amax, 1).to(torch.int32)
    return move_in, choices, cs, logz, end_state


def qstring_codes(prob, qscale, qbias):
    """phred+33 codes of a posterior probability, rounded half to even."""
    err = torch.clamp(1.0 - prob, 1e-4, 1.0)
    q = -10.0 * torch.log10(err) * qscale + qbias
    return (torch.round(q) + 33.0).to(torch.uint8)


def tcn_backward_plain(moves, move_in, choices, cs, logz, end_state, stay,
                       qscale=1.0, qbias=0.0):
    """The backward pass, traceback and emission of the decode ->
    {"sequence", "qstring", "moves"}, each [N, T] uint8."""
    N, T, Cm = moves.shape
    S = Cm // NB
    R = S // NB
    dev = moves.device
    rows = torch.arange(N, device=dev)
    states = torch.arange(S, device=dev)
    B = torch.ones(N, S, device=dev)
    d = torch.zeros(N, device=dev)
    state = end_state.long()
    moved = torch.empty(N, T, dtype=torch.bool, device=dev)
    bases = torch.empty(N, T, dtype=torch.long, device=dev)
    probs = torch.empty(N, T, device=dev)
    for t in range(T - 1, -1, -1):
        mv = moves[:, t].float().reshape(N, NB, NB, R)            # [N, b, j, r]
        choice = choices[rows, t, state].long()
        is_move = choice != 0
        base = state % NB + 1
        prev = torch.where(is_move, state // NB + (choice - 1).clamp(min=0) * R,
                           state)
        # posterior mass of the emitted base: the stored move-in already
        # sums the predecessors; the states s with s % nb = base - 1
        bmass = block_sum(torch.where(
            states % NB == (base - 1)[:, None], move_in[:, t] * B, 0.0))
        probs[:, t] = bmass * torch.exp(cs[:, t] + d - logz)
        moved[:, t] = is_move
        bases[:, t] = base
        # beta to frame t: B[p = j*R + r]
        Bv = B.reshape(N, R, NB).transpose(1, 2)                  # [N, b, r]
        p = torch.exp(mv) * Bv[:, :, None]
        mo = p[:, 0] + p[:, 1] + p[:, 2] + p[:, 3]                # [N, j, r]
        b_raw = _stay_prob(stay, t) * B + mo.reshape(N, S)
        n = b_raw.amax(1, keepdim=True)
        B = b_raw * (1.0 / n)
        d = d + torch.log(n[:, 0])
        state = prev
    zero = torch.zeros((), dtype=torch.uint8, device=dev)
    return {
        "sequence": torch.where(moved, bases.to(torch.uint8), zero),
        "qstring": torch.where(moved, qstring_codes(probs, qscale, qbias), zero),
        "moves": moved.to(torch.uint8),
    }


def _check_cuda(moves):
    if moves.device.type != "cuda":
        raise ValueError(f"decode kernels need a CUDA tensor, got {moves.device}")
    if moves.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode kernels take bf16 or f32 moves, got "
                        f"{moves.dtype}")
    if moves.dim() != 3 or not moves.is_contiguous():
        raise ValueError("decode kernels take contiguous moves [N, T, nb*S]")
    N, T, Cm = moves.shape
    S = Cm // NB
    if Cm != NB * S or S % NB or S > 1024 or N < 1 or T < 1:
        raise ValueError(f"decode kernels: moves {tuple(moves.shape)} needs "
                         f"nb*S columns with S a multiple of 4, at most 1024")
    return N, T, S


def check_forward_outputs(kernel, device, N, T, S, move_in, choices, cs,
                          logz, end_state):
    """Raise unless the forward pass's outputs are what a backward kernel
    reads: contiguous, of their shapes and types, on ``device``."""
    for name, x, shape, dtype in (
            ("move_in", move_in, (N, T, S), torch.float32),
            ("choices", choices, (N, T, S), torch.uint8),
            ("c", cs, (N, T), torch.float32),
            ("logz", logz, (N,), torch.float32),
            ("end_state", end_state, (N,), torch.int32)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != device or not x.is_contiguous()):
            raise ValueError(f"{kernel}: {name} must be a contiguous {dtype} "
                             f"{shape} on {device}")


# frames the ring of csrc/decode_ring.cuh holds (its C entries take 1 or 2
# to 16): a frame's copy is issued about RING - 1 frames before its row
# is read; 4 kept pace at hac and 8 at sup (scripts/decode_split.py)
RING = 8
SMEM = 232448  # the most shared memory a block may ask for


def ring_smem(S, ring, backward, row=None):
    """Shared memory of one CTA of the ring kernels (``fwd_smem``/
    ``bwd_smem`` of csrc/decode_ring.cuh): the mbarriers, the partials, the
    raw values of two frames (B, M: alpha and amax; C, Q: beta, and each
    consumer thread's share of two frames' posterior mass) and the ring of
    slots: a frame's row of ``row`` bytes (B's bf16 moves, 8S, by default;
    M's scores), and for C and Q also its move_in and choices."""
    head = (ring * 8 + 15) // 16 * 16 + (2 * 64 + 64) * 4
    row = 8 * S if row is None else row
    if backward:
        consumers = -(-(S // NB) // 32) * 32
        return head + 8 * S + 8 * consumers + ring * (row + 5 * S)
    return head + 16 * S + ring * row


def decode_plan(N, T, S, sms=None, dtype=torch.bfloat16):
    """The plan of kernels B and C on the ring (``csrc/decode_tcn_ring.cu``)
    for moves [N, T, 4S] of ``dtype`` on a card of ``sms`` SMs, or None
    where the ring does not take the shape: S a multiple of 16 (a frame's
    choices, S bytes, are copied in 16-byte pieces), at most 1024. Then the
    earlier kernels run. One CTA per batch row: S / 4 consumer threads
    (rounded up to whole warps) with four states each, a producer warp that
    copies the frames and an epilogue warp that does the per-frame work of
    one thread. An f32 model's moves take the f32 instance, which is also
    the ring of GW's and JW's passes (``ops.decode_fused_cuda.
    wide_decode_plan``): a slot of 16S bytes (21S for the backward pass),
    RING frames fit at 1024 states too."""
    if N < 1 or T < 1 or S % 16 or not 16 <= S <= 1024:
        return None
    row = NB * S * (4 if dtype == torch.float32 else 2)
    consumers = -(-(S // NB) // 32) * 32
    plan = {"threads": consumers + 64, "consumer_threads": consumers,
            "states_per_thread": NB, "ctas": N,
            "waves": None if sms is None else -(-N // sms)}
    for name, backward in (("fwd", False), ("bwd", True)):
        smem = ring_smem(S, RING, backward, row)
        if smem > SMEM:
            return None
        plan[name] = {"ring": RING, "smem": smem}
    return plan


def decode_entry(plan, backward, dtype=torch.bfloat16):
    """The C entry a plan launches on moves of ``dtype``: the ring's, or
    the earlier kernel's where the plan is None."""
    name = "decode_tcn_" + ("bwd" if backward else "fwd")
    if plan is not None:
        return name + ("_ring_f32" if dtype == torch.float32 else "_ring")
    return name + ("_f32" if dtype == torch.float32 else "_bf16")


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def _aligned(*tensors):
    """The ring's bulk copies read 16-byte aligned rows."""
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _forward(counter, moves, blank):
    """B's checks and launch: the ring on ``decode_plan``'s plan, the
    earlier kernel where it gives None (or where the rows are not 16-byte
    aligned) or where ``counter`` is None (the comparisons' route, which
    counts nothing)."""
    build.refuse_grad("B", [moves], build.DECODE_ROUTE)
    N, T, S = _check_cuda(moves)
    lib = build.library()
    dev = moves.device
    move_in = torch.empty(N, T, S, device=dev)
    choices = torch.empty(N, T, S, dtype=torch.uint8, device=dev)
    cs = torch.empty(N, T, device=dev)
    logz = torch.empty(N, device=dev)
    end_state = torch.empty(N, dtype=torch.int32, device=dev)
    plan = None
    if counter is not None:
        plan = (decode_plan(N, T, S, _sms(dev), moves.dtype)
                if _aligned(moves) else None)
        counter.plan = plan
        counter.launches += 1
    entry = decode_entry(plan, False, moves.dtype)
    args = [moves.data_ptr(), move_in.data_ptr(), choices.data_ptr(),
            cs.data_ptr(), logz.data_ptr(), end_state.data_ptr(), N, T, S]
    args += [] if plan is None else [plan["fwd"]["ring"]]
    args += [math.exp(blank), blank]
    build.check(getattr(lib, entry)(*args, build.stream_of(moves)), entry)
    return move_in, choices, cs, logz, end_state


def _backward(counter, moves, move_in, choices, cs, logz, end_state, blank,
              qscale, qbias):
    """C's checks and launch, routed as ``_forward``'s."""
    build.refuse_grad("C", [moves], build.DECODE_ROUTE)
    N, T, S = _check_cuda(moves)
    check_forward_outputs("kernel C", moves.device, N, T, S, move_in, choices,
                          cs, logz, end_state)
    lib = build.library()
    out = torch.empty(3, N, T, dtype=torch.uint8, device=moves.device)
    plan = None
    if counter is not None:
        plan = (decode_plan(N, T, S, _sms(moves.device), moves.dtype)
                if _aligned(moves, move_in, choices) else None)
        counter.plan = plan
        counter.launches += 1
    args = [moves.data_ptr(), move_in.data_ptr(), choices.data_ptr(),
            cs.data_ptr(), logz.data_ptr(), end_state.data_ptr(),
            out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), N, T, S]
    entry = decode_entry(plan, True, moves.dtype)
    args += [] if plan is None else [plan["bwd"]["ring"]]
    args += [math.exp(blank), float(qscale), float(qbias)]
    build.check(getattr(lib, entry)(*args, build.stream_of(moves)), entry)
    return {"sequence": out[0], "qstring": out[1], "moves": out[2]}


def tcn_forward(moves, blank):
    """The forward pass of ``tcn_forward_plain`` with a constant stay
    ``blank``: the plain version for a CPU tensor, kernel B on the card (on
    ``decode_plan``'s plan, recorded in ``.plan``, else the earlier
    kernel)."""
    if moves.device.type == "cpu":
        return tcn_forward_plain(moves, blank)
    return _forward(tcn_forward, moves, blank)


def tcn_backward(moves, move_in, choices, cs, logz, end_state, blank,
                 qscale=1.0, qbias=0.0):
    """The backward pass of ``tcn_backward_plain`` with a constant stay
    ``blank``: the plain version for a CPU tensor, kernel C on the card
    (routed as ``tcn_forward``)."""
    if moves.device.type == "cpu":
        return tcn_backward_plain(moves, move_in, choices, cs, logz,
                                  end_state, blank, qscale, qbias)
    return _backward(tcn_backward, moves, move_in, choices, cs, logz,
                     end_state, blank, qscale, qbias)


def tcn_forward_old_kernel(moves, blank):
    """B's earlier kernel (``csrc/decode_tcn.cu``) whatever the plan (CUDA
    tensors only): the route where ``decode_plan`` gives None, and what
    chip_smoke.py and the card tests hold the ring against. It counts no
    launch."""
    return _forward(None, moves, blank)


def tcn_backward_old_kernel(moves, move_in, choices, cs, logz, end_state,
                            blank, qscale=1.0, qbias=0.0):
    """C's earlier kernel, as ``tcn_forward_old_kernel``."""
    return _backward(None, moves, move_in, choices, cs, logz, end_state,
                     blank, qscale, qbias)


tcn_forward.launches = 0
tcn_backward.launches = 0
tcn_forward.plan = None  # the last call's (None: the earlier kernel)
tcn_backward.plan = None
