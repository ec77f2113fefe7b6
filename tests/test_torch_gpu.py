"""Kernel-vs-plain tests of the port's CUDA kernels at small sizes. They
need the card and skip elsewhere. This file imports no JAX, so on a
machine without it run it with ``--noconftest`` (README, "PyTorch/CUDA
port")."""

import numpy as np
import pytest
import torch

from bonito_tpu_torch.crf.model import HeadSplit as Head
from bonito_tpu_torch.crf.model import Model
from bonito_tpu_torch.crf.seqdist import CTC_CRF
from bonito_tpu_torch.models import lstm_crf_config
from bonito_tpu_torch.ops import (attention, attention_cuda, build, decode,
                                  decode_cuda, decode_full_cuda,
                                  decode_fused_cuda, int8, lattice,
                                  lattice_cuda, logz, logz_cuda, lstm_cuda,
                                  lstm_fused_cuda, lstm_int8_cuda,
                                  lstm_train_cuda, relayout)
from bonito_tpu_torch.ops.lstm import lstm, lstm_int8

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,H", [
    (8, 9, 16), (40, 17, 64), (96, 5, 128),
    (96, 33, 1024),     # hac: one launch of 64 x 2 CTAs in clusters of 2
    (200, 7, 1024),     # more rows than one grid holds: two row groups
    (1, 3, 96),
    (1024, 3, 96),      # 132 CTAs, every one an SM, in 66 clusters of 2
    (8, 5, 2048)])      # W_hh beyond shared memory: the step kernel
def test_lstm_kernel_matches_plain(cuda, N, T, H, reverse):
    """Kernel A on each branch of its shape rule (lstm_cuda.persistent_plan:
    one persistent launch per row group, or the step kernel's one call),
    with the launches that branch counts."""
    g = torch.Generator().manual_seed(N + T + H)
    xw = torch.randn(T, N, 4 * H, generator=g).to(cuda, torch.bfloat16)
    w_hh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = lstm_cuda.persistent_plan(N, H, sms)
    assert (plan is None) == (H == 2048)
    assert plan is None or plan["launches"] == (2 if N == 200 else 1)
    before = lstm_cuda.lstm_recurrence.launches
    out = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_cuda.lstm_recurrence.launches == before + (
        1 if plan is None else plan["launches"])
    assert lstm_cuda.lstm_recurrence.plan == plan  # what the kernel ran
    ref = lstm_cuda.lstm_recurrence_plain(xw, w_hh, reverse=reverse)
    # both round h to bf16 each step; f32 sums in another order can flip
    # one bf16 rounding, which then propagates: 2 bf16 ulps of |h| <= 1
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)


def test_lstm_kernel_rejects_f32(cuda):
    xw = torch.zeros(2, 8, 64, device=cuda)
    with pytest.raises(TypeError, match="bf16"):
        lstm_cuda.lstm_recurrence(xw, torch.zeros(16, 64, device=cuda))


@pytest.mark.parametrize("state_len,N,T", [(3, 8, 30), (5, 3, 12), (2, 4, 9),
                                           (5, 2, 200), (1, 3, 7)])
def test_decode_kernels_match_plain(cuda, state_len, N, T):
    """Kernels B and C on the shape rule's route (decode_cuda.decode_plan:
    the ring for S a multiple of 16, state_len 2 and up; the earlier
    kernels for S 4), the plan recorded; T 200 at S 1024 is well beyond
    the ring's depth."""
    S = 4 ** state_len
    g = torch.Generator().manual_seed(S + N)
    moves = (3 * torch.randn(N, T, 4 * S, generator=g)).to(cuda, torch.bfloat16)
    fwd = decode_cuda.tcn_forward(moves, 2.0)
    out = decode_cuda.tcn_backward(moves, *fwd, 2.0, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = decode_cuda.decode_plan(N, T, S, sms)
    assert (plan is None) == (state_len == 1)
    assert decode_cuda.tcn_forward.plan == plan
    assert decode_cuda.tcn_backward.plan == plan
    ref_fwd = decode_cuda.tcn_forward_plain(moves, 2.0)
    ref = decode_cuda.tcn_backward_plain(moves, *ref_fwd, 2.0, qscale=1.05,
                                         qbias=0.2)
    torch.testing.assert_close(fwd[1], ref_fwd[1], rtol=0, atol=0)  # choices
    torch.testing.assert_close(fwd[4], ref_fwd[4], rtol=0, atol=0)  # end
    torch.testing.assert_close(fwd[0], ref_fwd[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fwd[3], ref_fwd[3], rtol=1e-5, atol=1e-4)
    for k in ("sequence", "moves"):
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    dq = (out["qstring"].int() - ref["qstring"].int()).abs().max().item()
    assert dq <= 1


def _bits(x):
    return x.contiguous().view(torch.uint8)


@pytest.mark.parametrize("S,N,T", [(1024, 3, 12), (1024, 96, 300),
                                   (1024, 1, 1), (1024, 2, 8), (1024, 2, 9),
                                   (64, 8, 30), (16, 4, 9), (256, 5, 40),
                                   (48, 3, 17)])
def test_decode_ring_matches_the_earlier_kernels(cuda, S, N, T):
    """B and C on the ring against their earlier kernels on the same moves,
    bit for bit on all eight outputs (move_in, choices, c, logZ, end state;
    sequence, qstring, moves): T below, at (8) and beyond the ring's depth,
    one frame, one row, S 48 (a warp with idle threads)."""
    g = torch.Generator().manual_seed(S + N + T)
    moves = (3 * torch.randn(N, T, 4 * S, generator=g)).clamp(-5, 5).to(
        cuda, torch.bfloat16)
    fwd = decode_cuda.tcn_forward(moves, 2.0)
    out = decode_cuda.tcn_backward(moves, *fwd, 2.0, qscale=1.05, qbias=0.2)
    assert decode_cuda.tcn_forward.plan is not None
    assert decode_cuda.tcn_backward.plan is not None
    old_fwd = decode_cuda.tcn_forward_old_kernel(moves, 2.0)
    old = decode_cuda.tcn_backward_old_kernel(moves, *old_fwd, 2.0,
                                              qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    for a, b in zip(fwd, old_fwd):
        assert torch.equal(_bits(a), _bits(b))
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(out[k], old[k]), k


def test_decode_old_kernels_count_no_launch(cuda):
    moves = torch.zeros(2, 4, 4 * 64, device=cuda, dtype=torch.bfloat16)
    b, c = decode_cuda.tcn_forward.launches, decode_cuda.tcn_backward.launches
    fwd = decode_cuda.tcn_forward_old_kernel(moves, 2.0)
    decode_cuda.tcn_backward_old_kernel(moves, *fwd, 2.0)
    torch.cuda.synchronize()
    assert (decode_cuda.tcn_forward.launches,
            decode_cuda.tcn_backward.launches) == (b, c)


def test_decode_kernels_reject_f32(cuda):
    with pytest.raises(TypeError, match="bf16"):
        decode_cuda.tcn_forward(torch.zeros(2, 4, 4 * 64, device=cuda), 2.0)


def test_decode_launch_counts(cuda):
    moves = torch.zeros(2, 4, 4 * 64, device=cuda, dtype=torch.bfloat16)
    b, c = decode_cuda.tcn_forward.launches, decode_cuda.tcn_backward.launches
    fwd = decode_cuda.tcn_forward(moves, 2.0)
    decode_cuda.tcn_backward(moves, *fwd, 2.0)
    torch.cuda.synchronize()
    assert decode_cuda.tcn_forward.launches == b + 1
    assert decode_cuda.tcn_backward.launches == c + 1
    np.testing.assert_array_equal(fwd[4].cpu().numpy(), [0, 0])


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state_len,N,T", [(1, 3, 7), (2, 4, 9), (3, 8, 30),
                                           (4, 2, 11), (5, 3, 12)])
def test_full_decode_kernels_match_plain(cuda, state_len, N, T, dtype,
                                         reverse):
    """Kernels M and Q against their plain versions on full scores with a
    stay plane (and on the reverse strand read in place): choices, end
    states, sequence and moves identical (the max semiring does the same f32
    adds in both), qstring within one step; on the ring (decode_full_plan)
    but for state_len 1."""
    S = 4 ** state_len
    g = torch.Generator().manual_seed(S + N + T)
    scores = (3 * torch.randn(N, T, 5 * S, generator=g)).to(cuda, dtype)
    m, q = decode_full_cuda.full_forward, decode_full_cuda.full_backward
    before = (m.launches, q.launches)
    fwd = m(scores, reverse=reverse)
    out = q(scores, *fwd, qscale=1.05, qbias=0.2, reverse=reverse)
    torch.cuda.synchronize()
    assert (m.launches, q.launches) == (before[0] + 1, before[1] + 1)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = decode_full_cuda.decode_full_plan(N, T, S, dtype, sms)
    assert (plan is None) == (state_len == 1)
    assert m.plan == plan and q.plan == plan
    ref_fwd = decode_full_cuda.full_forward_plain(scores, reverse=reverse)
    ref = decode_full_cuda.full_backward_plain(scores, *ref_fwd, qscale=1.05,
                                               qbias=0.2, reverse=reverse)
    torch.testing.assert_close(fwd[1], ref_fwd[1], rtol=0, atol=0)  # choices
    torch.testing.assert_close(fwd[4], ref_fwd[4], rtol=0, atol=0)  # end
    torch.testing.assert_close(fwd[0], ref_fwd[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fwd[3], ref_fwd[3], rtol=1e-5, atol=1e-4)
    for k in ("sequence", "moves"):
        torch.testing.assert_close(out[k], ref[k], rtol=0, atol=0)
    dq = (out["qstring"].int() - ref["qstring"].int()).abs().max().item()
    assert dq <= 1


FULL_RING_SHAPES = [(1024, 3, 12), (1024, 96, 300), (1024, 1, 1),
                    (1024, 2, 8), (1024, 2, 9), (1024, 2, 1666), (64, 8, 30),
                    (16, 4, 9), (256, 5, 40)]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N,T", FULL_RING_SHAPES)
def test_full_ring_matches_the_earlier_kernels(cuda, S, N, T, dtype,
                                               reverse):
    """M and Q on the ring against their earlier kernels on the same
    scores, bit for bit on all eight outputs (move_in, choices, c, logZ,
    end state; sequence, qstring, moves): T 1 to hac's 1666, below, at (8)
    and beyond the ring's depth, one row, S 16 to 1024, bf16 and f32, each
    strand."""
    g = torch.Generator().manual_seed(S + N + T)
    scores = (3 * torch.randn(N, T, 5 * S, generator=g)).clamp(-5, 5).to(
        cuda, dtype)
    q = dict(qscale=1.05, qbias=0.2, reverse=reverse)
    fwd = decode_full_cuda.full_forward(scores, reverse=reverse)
    out = decode_full_cuda.full_backward(scores, *fwd, **q)
    assert decode_full_cuda.full_forward.plan is not None
    assert decode_full_cuda.full_backward.plan is not None
    old_fwd = decode_full_cuda.full_forward_old_kernel(scores,
                                                       reverse=reverse)
    old = decode_full_cuda.full_backward_old_kernel(scores, *old_fwd, **q)
    torch.cuda.synchronize()
    for a, b in zip(fwd, old_fwd):
        assert torch.equal(_bits(a), _bits(b))
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(out[k], old[k]), k


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state_len,N,T", [(1, 3, 7), (2, 4, 9), (3, 8, 30),
                                           (5, 3, 12), (5, 4, 400)])
def test_full_reverse_entry_equals_the_copy(cuda, state_len, N, T, dtype):
    """The reverse strand read in place equals M and Q on
    seqdist.reverse_complement(scores) bit for bit: c, logZ, the end state
    and the decoded frames as they are, move_in and choices in the forward
    strand's order of states (rc_states); on the ring, and on the earlier
    kernels for state_len 1."""
    S = 4 ** state_len
    g = torch.Generator().manual_seed(S + N + T + 1)
    scores = (3 * torch.randn(N, T, 5 * S, generator=g)).to(cuda, dtype)
    rc = CTC_CRF(state_len, "NACGT").reverse_complement(scores)
    fwd = decode_full_cuda.full_forward(scores, reverse=True)
    out = decode_full_cuda.full_backward(scores, *fwd, qscale=1.05,
                                         qbias=0.2, reverse=True)
    ref_fwd = decode_full_cuda.full_forward(rc)
    ref = decode_full_cuda.full_backward(rc, *ref_fwd, qscale=1.05,
                                         qbias=0.2)
    torch.cuda.synchronize()
    cols = decode_full_cuda.rc_states(S).to(cuda)
    assert torch.equal(_bits(fwd[0]), _bits(ref_fwd[0][..., cols]))
    assert torch.equal(fwd[1], ref_fwd[1][..., cols])
    for a, b in zip(fwd[2:], ref_fwd[2:]):
        assert torch.equal(_bits(a), _bits(b))
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(out[k], ref[k]), k
    dec = decode.viterbi_decode(CTC_CRF(state_len, "NACGT"), scores,
                                qscale=1.05, qbias=0.2, reverse=True)
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(dec[k], ref[k]), k


def test_full_old_kernels_count_no_launch(cuda):
    scores = torch.zeros(2, 4, 5 * 64, device=cuda, dtype=torch.bfloat16)
    m, q = decode_full_cuda.full_forward, decode_full_cuda.full_backward
    before = (m.launches, q.launches)
    for reverse in (False, True):
        fwd = decode_full_cuda.full_forward_old_kernel(scores, reverse)
        decode_full_cuda.full_backward_old_kernel(scores, *fwd,
                                                  reverse=reverse)
    torch.cuda.synchronize()
    assert (m.launches, q.launches) == before


def test_full_decode_kernels_reject_what_they_do_not_take(cuda):
    """No fallback: a wrong dtype, a state count outside the gate, a
    strided tensor or a forward output on the CPU raise."""
    scores = torch.zeros(2, 4, 5 * 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        decode_full_cuda.full_forward(scores.half())
    for S in (8, 32, 2048):
        with pytest.raises(ValueError, match="4\\*\\*k"):
            decode_full_cuda.full_forward(
                torch.zeros(2, 4, 5 * S, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        decode_full_cuda.full_forward(scores.transpose(0, 1))
    for reverse in (False, True):
        with pytest.raises(ValueError, match="contiguous"):
            decode.viterbi_decode(CTC_CRF(3, "NACGT"),
                                  scores.transpose(0, 1), reverse=reverse)
    fwd = decode_full_cuda.full_forward(scores)
    with pytest.raises(ValueError, match="move_in"):
        decode_full_cuda.full_backward(scores, fwd[0].cpu(), *fwd[1:])
    with pytest.raises(ValueError, match="choices"):
        decode_full_cuda.full_backward(scores, fwd[0], fwd[1].float(),
                                       *fwd[2:])


def test_decode_batch_decodes_an_array_on_the_card(cuda):
    """A numpy array handed to a model on the card is decoded there, by M
    and Q, as a CUDA tensor is, and calls what the plain versions call."""
    cfg = lstm_crf_config(features=32, num_layers=1, state_len=2)
    x = (2 * np.random.default_rng(4).normal(size=(3, 30, 80))).astype(
        np.float32)
    model = Model(cfg).to(cuda)
    m, q = decode_full_cuda.full_forward, decode_full_cuda.full_backward
    before = (m.launches, q.launches)
    out = model.decode_batch(x)
    assert (m.launches, q.launches) == (before[0] + 1, before[1] + 1)
    assert out == model.decode_batch(torch.from_numpy(x).to(cuda))
    assert out == Model(cfg).decode_batch(x)
    assert all(len(s) > 5 for s in out)


def _int8_layer(cuda, seed, N, T, C, H):
    g = torch.Generator().manual_seed(seed)
    x_q = torch.randint(-127, 128, (T, N, C), generator=g, dtype=torch.int8)
    w_ih_q, ih_scales = int8.quantize_cols(
        (torch.randn(C, 4 * H, generator=g) / C ** 0.5).numpy())
    w_hh_q, scales = int8.quantize_whh(
        (torch.randn(H, 4 * H, generator=g) / H ** 0.5).numpy())
    b = 0.5 * torch.randn(4 * H, generator=g)
    to = lambda a: torch.as_tensor(a).to(cuda)
    return (to(x_q), to(w_ih_q), to(w_hh_q), to(ih_scales) / 127.0,
            to(scales), to(b))


@pytest.mark.parametrize("out_int8", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,C,H", [(8, 9, 16, 16), (40, 17, 48, 64),
                                     (96, 5, 128, 128), (8, 3, 272, 528),
                                     (48, 3, 1040, 528)])
def test_int8_fused_kernel_matches_plain(cuda, N, T, C, H, reverse, out_int8):
    """Kernel D: the same integer sums and the same f32 operations as the
    plain version; only expf/tanhf differ in the last bit, which can move
    an h across a half step: one int8 step, on under 1% of the entries.
    The shapes take the 32-row tile (N 8, 40) and the 48-row one (96, 48),
    k-ranges of less than one staged chunk and of several with a tail."""
    args = _int8_layer(cuda, N + T + H, N, T, C, H)
    plan = lstm_int8_cuda.persistent_plan(N, C, H, _sms(cuda))
    before = lstm_int8_cuda.lstm_int8_fused.launches
    out = lstm_int8_cuda.lstm_int8_fused(*args, reverse=reverse,
                                         out_int8=out_int8)
    torch.cuda.synchronize()
    assert lstm_int8_cuda.lstm_int8_fused.launches == before + (
        1 if plan is None else plan["launches"])
    ref = lstm_int8_cuda.lstm_int8_fused_plain(*args, reverse=reverse,
                                               out_int8=out_int8)
    assert out.dtype == ref.dtype == (torch.int8 if out_int8
                                      else torch.bfloat16)
    diff = (out.float() - ref.float()).abs()
    if out_int8:
        assert diff.max().item() <= 1 and (diff == 0).float().mean() >= 0.99
    else:
        assert diff.max().item() <= 1 / 127 + 2 ** -8


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,H", [(8, 9, 16), (40, 17, 64), (96, 5, 128),
                                   (8, 3, 528), (48, 3, 1040)])
def test_int8_recurrence_kernel_matches_plain(cuda, N, T, H, reverse):
    _, _, w_hh_q, _, scales, _ = _int8_layer(cuda, N + T + H, N, T, H, H)
    g = torch.Generator().manual_seed(N)
    xw = torch.randn(T, N, 4 * H, generator=g).to(cuda, torch.bfloat16)
    plan = lstm_int8_cuda.persistent_plan(N, None, H, _sms(cuda),
                                          fused=False)
    before = lstm_int8_cuda.lstm_int8_recurrence.launches
    out = lstm_int8_cuda.lstm_int8_recurrence(xw, w_hh_q, scales,
                                              reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_int8_cuda.lstm_int8_recurrence.launches == before + (
        1 if plan is None else plan["launches"])
    ref = lstm_int8_cuda.lstm_int8_recurrence_plain(xw, w_hh_q, scales,
                                                    reverse=reverse)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1 / 127 + 2 ** -8)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


# the persistent D and E (lstm_int8_cuda.persistent_plan), in pairs of CTAs
# that share each load: odd N, whose last row slice has padding rows (37, H
# 64: 16-row slices); H 32, one pair; C 992 (31 k-steps, one k-slice short)
# with H 160; 32-row slices (61 rows); hac widths (48-row slices, 128 CTAs);
# 64-row slices (D with a narrow input); row groups (200 rows: D three of
# 48-row slices, E two of 64)
INT8_PERSISTENT = [(37, 9, 64, 64), (5, 7, 96, 32), (19, 6, 992, 160),
                   (61, 4, 512, 1024), (96, 33, 1024, 1024),
                   (128, 3, 128, 1024), (200, 5, 1024, 1024)]


@pytest.mark.parametrize("out_int8", [False, True])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,C,H", INT8_PERSISTENT)
def test_int8_fused_persistent_equals_its_step_kernel(cuda, N, T, C, H,
                                                       reverse, out_int8):
    """Kernel D's persistent launches give its step kernel's output bit for
    bit (exact int32 sums, the same f32 operations), and so stay within the
    step kernel's tolerance of the plain version."""
    args = _int8_layer(cuda, N + T + C + H, N, T, C, H)
    plan = lstm_int8_cuda.persistent_plan(N, C, H, _sms(cuda))
    assert plan is not None
    assert plan["launches"] == (3 if N == 200 else 1)
    before = lstm_int8_cuda.lstm_int8_fused.launches
    out = lstm_int8_cuda.lstm_int8_fused(*args, reverse=reverse,
                                         out_int8=out_int8)
    torch.cuda.synchronize()
    assert lstm_int8_cuda.lstm_int8_fused.launches == before + plan["launches"]
    assert lstm_int8_cuda.lstm_int8_fused.plan == plan
    step = lstm_int8_cuda.lstm_int8_fused_step_kernel(
        *args, reverse=reverse, out_int8=out_int8)
    torch.cuda.synchronize()
    assert lstm_int8_cuda.lstm_int8_fused.launches == before + plan["launches"]
    assert out.dtype == step.dtype and torch.equal(out, step)
    ref = lstm_int8_cuda.lstm_int8_fused_plain(*args, reverse=reverse,
                                               out_int8=out_int8)
    diff = (out.float() - ref.float()).abs()
    if out_int8:
        assert diff.max().item() <= 1 and (diff == 0).float().mean() >= 0.99
    else:
        assert diff.max().item() <= 1 / 127 + 2 ** -8


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,H", [(n, t, h) for n, t, _, h in
                                   INT8_PERSISTENT] + [
    (64, 3, 2048)])     # W_hh's 132 KB slice: no ring of a whole step
def test_int8_recurrence_persistent_equals_its_step_kernel(cuda, N, T, H,
                                                           reverse):
    _, _, w_hh_q, _, scales, _ = _int8_layer(cuda, N + T + H, N, T, H, H)
    g = torch.Generator().manual_seed(N)
    xw = torch.randn(T, N, 4 * H, generator=g).to(cuda, torch.bfloat16)
    plan = lstm_int8_cuda.persistent_plan(N, None, H, _sms(cuda),
                                          fused=False)
    assert plan is not None
    assert plan["launches"] == (2 if N == 200 else 1)
    assert plan["cluster"] == (1 if H == 2048 else 2)
    before = lstm_int8_cuda.lstm_int8_recurrence.launches
    out = lstm_int8_cuda.lstm_int8_recurrence(xw, w_hh_q, scales,
                                              reverse=reverse)
    step = lstm_int8_cuda.lstm_int8_recurrence_step_kernel(
        xw, w_hh_q, scales, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_int8_cuda.lstm_int8_recurrence.launches == (
        before + plan["launches"])
    assert lstm_int8_cuda.lstm_int8_recurrence.plan == plan
    assert torch.equal(out, step)
    ref = lstm_int8_cuda.lstm_int8_recurrence_plain(xw, w_hh_q, scales,
                                                    reverse=reverse)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0,
                               atol=1 / 127 + 2 ** -8)


def test_int8_kernels_reject_what_they_do_not_take(cuda):
    x_q, w_ih_q, w_hh_q, ihsc, scales, b = _int8_layer(cuda, 1, 8, 3, 16, 16)
    with pytest.raises(TypeError, match="int8"):
        lstm_int8_cuda.lstm_int8_fused(x_q.float(), w_ih_q, w_hh_q, ihsc,
                                       scales, b)
    with pytest.raises(ValueError, match="multiples of 16"):
        lstm_int8_cuda.lstm_int8_fused(x_q[..., :8].contiguous(), w_ih_q[:8],
                                       w_hh_q, ihsc, scales, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_int8_cuda.lstm_int8_fused(x_q, w_ih_q.cpu(), w_hh_q, ihsc,
                                       scales, b)
    with pytest.raises(TypeError, match="bf16"):
        lstm_int8_cuda.lstm_int8_recurrence(
            torch.zeros(3, 8, 64, device=cuda), w_hh_q, scales)


@pytest.mark.parametrize("route", ["fused", "two_stage", "dequant"])
def test_lstm_int8_routes_agree_on_the_card(cuda, route):
    """Each route of the dispatcher through its kernel (D; project_int8 +
    E; the dequantised weights through A) against the fused route's plain
    version: they quantise alike, so they stay within a few int8 steps."""
    N, T, H = 32, 12, 64
    x_q, w_ih_q, w_hh_q, ihsc, scales, b = _int8_layer(cuda, 3, N, T, H, H)
    x = (x_q.float() / 127).to(torch.bfloat16).transpose(0, 1)
    ih_scales = ihsc * 127.0
    out = lstm_int8(x, None, w_hh_q, scales, b, w_ih_q=w_ih_q,
                    ih_scales=ih_scales, route=route)
    ref = lstm_int8(x.cpu(), None, w_hh_q.cpu(), scales.cpu(), b.cpu(),
                    w_ih_q=w_ih_q.cpu(), ih_scales=ih_scales.cpu(),
                    route="fused")
    assert out.dtype == torch.bfloat16 and out.shape == (N, T, H)
    assert (out.float().cpu() - ref.float()).abs().max().item() <= 0.06


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,C,H", [(8, 9, 16, 16), (19, 17, 32, 48),
                                     (64, 40, 96, 96), (16, 5, 112, 112),
                                     (8, 4, 1024, 96), (8, 6, 256, 256)])
def test_fused_lstm_kernel_matches_plain(cuda, N, T, C, H, reverse, bias):
    """Kernel F: the same bf16 products summed in f32 in another order, h
    rounded to bf16 each step: 2 bf16 steps of |h| <= 1, as for kernel A.
    The shapes take a ragged last row block (N 19), the fast shape (C = H =
    96: weight fragments in registers) and others (fragments through L2),
    up to the widest the kernel takes."""
    g = torch.Generator().manual_seed(N + T + H)
    x = torch.tanh(torch.randn(T, N, C, generator=g)).to(cuda, torch.bfloat16)
    w_ih = (torch.randn(C, 4 * H, generator=g) / C ** 0.5).to(
        cuda, torch.bfloat16)
    w_hh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    b = (0.5 * torch.randn(4 * H, generator=g)).to(cuda) if bias else None
    before = lstm_fused_cuda.lstm_fused.launches
    out = lstm_fused_cuda.lstm_fused(x, w_ih, w_hh, b, reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_fused_cuda.lstm_fused.launches == before + 1
    ref = lstm_fused_cuda.lstm_fused_plain(x, w_ih, w_hh, b, reverse=reverse)
    assert out.dtype == torch.bfloat16 and out.shape == (T, N, H)
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=2e-2)
    assert (out.float() - ref.float()).abs().mean().item() <= 1e-4


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,H", [(64, 40, 96), (1024, 25, 96), (19, 17, 32),
                                   (8, 9, 16), (1, 7, 80), (5, 33, 48)])
def test_fused_lstm_mma_kernel_equals_its_earlier_kernel(cuda, N, T, H,
                                                         reverse, bias):
    """Kernel F on its mma kernel (``fused_plan`` gives a plan at C = H up
    to 96): one launch counted, the plan it ran, and h equal to the earlier
    kernel's bit for bit (the same HMMA over the same k, the same f32 steps
    of the gate math), a ragged last block and one row among the shapes."""
    g = torch.Generator().manual_seed(N + T + H)
    x = torch.tanh(torch.randn(T, N, H, generator=g)).to(cuda, torch.bfloat16)
    w_ih, w_hh = ((torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16) for _ in range(2))
    b = (0.5 * torch.randn(4 * H, generator=g)).to(cuda) if bias else None
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = lstm_fused_cuda.fused_plan(N, H, H, sms)
    assert plan is not None
    before = lstm_fused_cuda.lstm_fused.launches
    out = lstm_fused_cuda.lstm_fused(x, w_ih, w_hh, b, reverse=reverse)
    old = lstm_fused_cuda.lstm_fused_old_kernel(x, w_ih, w_hh, b,
                                                reverse=reverse)
    torch.cuda.synchronize()
    assert lstm_fused_cuda.lstm_fused.launches == before + 1
    assert lstm_fused_cuda.lstm_fused.plan == plan
    assert torch.equal(out, old)


def test_fused_lstm_kernel_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(3, 8, 16, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16"):
        lstm_fused_cuda.lstm_fused(x.float(), w, w, None)
    with pytest.raises(ValueError, match="multiples of 16"):
        lstm_fused_cuda.lstm_fused(x[..., :8], w[:8], w, None)
    with pytest.raises(ValueError, match="one CUDA device"):
        lstm_fused_cuda.lstm_fused(x, w.cpu(), w, None)


def test_lstm_gate_launches_the_fused_kernel_for_a_small_layer(cuda):
    """``lstm`` by shape: kernel F for H = 96, projection + kernel A for
    H = 272 (over F's width), and never both."""
    counts = lambda: (lstm_fused_cuda.lstm_fused.launches,
                      lstm_cuda.lstm_recurrence.launches)
    for H, want in ((96, (1, 0)), (272, (0, 1))):
        x = torch.zeros(8, 5, 96, device=cuda, dtype=torch.bfloat16)
        w_ih = torch.zeros(96, 4 * H, device=cuda, dtype=torch.bfloat16)
        w_hh = torch.zeros(H, 4 * H, device=cuda, dtype=torch.bfloat16)
        before = counts()
        assert lstm(x, w_ih, w_hh, None).shape == (8, 5, H)
        assert tuple(a - b for a, b in zip(counts(), before)) == want


@pytest.mark.parametrize("N,Th,H,S,U,tanh", [
    (8, 9, 32, 64, 1, False), (5, 7, 32, 64, 2, True), (6, 10, 16, 16, 2, True),
    (3, 6, 16, 4, 1, False), (4, 5, 96, 256, 1, False),
    (9, 13, 256, 64, 3, True), (64, 60, 96, 64, 1, False),
    (4, 24, 1024, 1024, 1, False), (6, 12, 512, 1024, 2, True),
    (3, 19, 64, 1024, 1, True), (5, 11, 512, 1024, 2, False),
    (2, 13, 256, 512, 1, True)])
def test_fused_decode_kernels_match_plain(cuda, N, Th, H, S, U, tanh):
    """Kernels G and J (S <= 256): the head sums run in WMMA tiles, another
    order than the plain version's, so a near-tie may fall the other way;
    at these sizes none was seen, and at most 0.1% of frames may differ.
    The shapes take ragged row blocks and chunks, rows inside one warp (S 4,
    16) and over several (64, 256), one to three upsample phases, and
    weights in shared memory and (H 256 with 3 phases, S 256) read through
    L2. GW and JW (S 512, 1024) take the plain versions' f32 steps and give
    their bits: hac's head (H 1024, U 1, clamped) and sup's (H 512, U 2,
    tanh x 5 and a bias), odd N, and a Th that leaves a partial chunk of
    their 8 output frames (19, 11, 13)."""
    g = torch.Generator().manual_seed(N + Th + S)
    gain = 0.5 if tanh else 3.0
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(cuda, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    bias = (0.3 * torch.randn(U, 4 * S, generator=g)).to(cuda) if tanh else None
    head = Head(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                None if tanh else -5.0, None if tanh else 5.0, 2.0)
    wide = S > decode_fused_cuda.MAX_S
    counts = lambda: (
        decode_fused_cuda.tcn_fused_forward.launches,
        decode_fused_cuda.tcn_fused_backward.launches,
        decode_fused_cuda.tcn_fused_forward_wide.launches,
        decode_fused_cuda.tcn_fused_backward_wide.launches)
    before = counts()
    fwd = decode_fused_cuda.tcn_fused_forward(head)
    out = decode_fused_cuda.tcn_fused_backward(head, *fwd, qscale=1.05,
                                               qbias=0.2)
    torch.cuda.synchronize()
    launched = (0, 0, 1, 1) if wide else (1, 1, 0, 0)
    assert counts() == tuple(b + d for b, d in zip(before, launched))
    ref_fwd = decode_fused_cuda.tcn_fused_forward_plain(head)
    ref = decode_fused_cuda.tcn_fused_backward_plain(head, *ref_fwd,
                                                     qscale=1.05, qbias=0.2)
    T = Th * U
    assert fwd[0].shape == (N, T, S) and out["sequence"].shape == (N, T)
    torch.testing.assert_close(fwd[0], ref_fwd[0], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(fwd[3], ref_fwd[3], rtol=1e-5, atol=1e-3)
    same = ((out["moves"] == ref["moves"])
            & (out["sequence"] == ref["sequence"]))
    assert (~same).sum().item() <= 1e-3 * same.numel()
    dq = (out["qstring"].int() - ref["qstring"].int()).abs()[same]
    assert dq.max().item() <= 1
    assert 0 < out["moves"].float().mean().item() < 1
    if wide:
        assert all(torch.equal(a, b) for a, b in zip(fwd, ref_fwd))
        assert all(torch.equal(out[k], ref[k]) for k in ref)


@pytest.mark.parametrize("N,Th,H,U,tanh", [
    (8, 9, 32, 1, False), (5, 7, 32, 2, True), (64, 60, 96, 1, False),
    (19, 13, 96, 1, False), (24, 50, 32, 2, True), (1, 1, 96, 1, False),
    (1024, 40, 96, 1, False)])
def test_fused_decode_ring_equals_its_earlier_kernel(cuda, N, Th, H, U, tanh):
    """Kernel J on its ring (``fused_decode_plan`` gives a plan at S 64, H
    32 or 96, U 1 or 2): one launch counted, the plan it ran, and sequence,
    qstring and moves equal to the earlier J's bit for bit on G's outputs,
    ragged rows and chunks, one frame and the fast batch among the
    shapes."""
    S = 64
    g = torch.Generator().manual_seed(N + Th + H)
    gain = 0.5 if tanh else 3.0
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(cuda, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    bias = (0.3 * torch.randn(U, 4 * S, generator=g)).to(cuda) if tanh else None
    head = Head(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                None if tanh else -5.0, None if tanh else 5.0, 2.0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = decode_fused_cuda.fused_decode_plan(N, Th * U, S, H, U, sms)["bwd"]
    assert plan is not None
    fwd = decode_fused_cuda.tcn_fused_forward(head)
    before = decode_fused_cuda.tcn_fused_backward.launches
    out = decode_fused_cuda.tcn_fused_backward(head, *fwd, qscale=1.05,
                                               qbias=0.2)
    old = decode_fused_cuda.tcn_fused_backward_old_kernel(
        head, *fwd, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    assert decode_fused_cuda.tcn_fused_backward.launches == before + 1
    assert decode_fused_cuda.tcn_fused_backward.plan == plan
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(out[k], old[k]), k


@pytest.mark.parametrize("N,Th,H,U,tanh", [
    (8, 9, 32, 1, False), (5, 7, 32, 2, True), (64, 60, 96, 1, False),
    (19, 13, 96, 1, False), (24, 50, 32, 2, True), (1, 1, 96, 1, False),
    (1024, 40, 96, 1, False), (1024, 1200, 96, 1, False)])
def test_fused_forward_ring_equals_its_earlier_kernel(cuda, N, Th, H, U,
                                                      tanh):
    """Kernel G on its ring (``fused_decode_plan``'s "fwd" at S 64, H 32 or
    96, U 1 or 2): one launch counted, the plan it ran, and move-in,
    choices, c, logZ and the end state equal to the earlier G's bit for
    bit, ragged rows and chunks, one frame, the two-phase tanh head and the
    fast batch among the shapes; on the fast head and the two-phase head
    also against the plain version, as test_fused_decode_kernels_match_plain
    holds G."""
    S = 64
    g = torch.Generator().manual_seed(N + Th + H)
    gain = 0.5 if tanh else 3.0
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(cuda, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    bias = (0.3 * torch.randn(U, 4 * S, generator=g)).to(cuda) if tanh else None
    head = Head(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                None if tanh else -5.0, None if tanh else 5.0, 2.0)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = decode_fused_cuda.fused_decode_plan(N, Th * U, S, H, U, sms)["fwd"]
    assert plan is not None
    before = decode_fused_cuda.tcn_fused_forward.launches
    fwd = decode_fused_cuda.tcn_fused_forward(head)
    old = decode_fused_cuda.tcn_fused_forward_old_kernel(head)
    torch.cuda.synchronize()
    assert decode_fused_cuda.tcn_fused_forward.launches == before + 1
    assert decode_fused_cuda.tcn_fused_forward.plan == plan
    for a, b in zip(fwd, old):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    if (N, Th) in ((1024, 1200), (24, 50)):
        ref = decode_fused_cuda.tcn_fused_forward_plain(head)
        torch.testing.assert_close(fwd[0], ref[0], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(fwd[3], ref[3], rtol=1e-5, atol=1e-3)
        assert (fwd[1] != ref[1]).float().mean().item() <= 1e-3


def test_fused_decode_kernels_reject_what_they_do_not_take(cuda):
    h = torch.zeros(4, 2, 16, device=cuda, dtype=torch.bfloat16)
    wT = torch.zeros(1, 64, 16, device=cuda, dtype=torch.bfloat16)
    ok = Head(h, wT, None, False, 1.0, -5.0, 5.0, 2.0)
    with pytest.raises(TypeError, match="bf16"):
        decode_fused_cuda.tcn_fused_forward(ok._replace(h=h.float()))
    with pytest.raises(ValueError, match="power of two"):
        decode_fused_cuda.tcn_fused_forward(ok._replace(
            wT=torch.zeros(1, 4 * 2048, 16, device=cuda,
                           dtype=torch.bfloat16)))
    wide = lambda U, H: ok._replace(
        h=torch.zeros(4, 2, H, device=cuda, dtype=torch.bfloat16),
        wT=torch.zeros(U, 4 * 1024, H, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="H up to 1024"):
        decode_fused_cuda.tcn_fused_forward(wide(1, 2048))
    with pytest.raises(ValueError, match="U in"):
        decode_fused_cuda.tcn_fused_backward(wide(3, 16), *[None] * 5)
    with pytest.raises(ValueError, match="one CUDA device"):
        decode_fused_cuda.tcn_fused_forward(ok._replace(wT=wT.cpu()))
    with pytest.raises(ValueError, match="bias"):
        decode_fused_cuda.tcn_fused_forward(ok._replace(
            bias=torch.zeros(2, 64, device=cuda)))


def _wide_head(cuda, N, Th, H, S, U, act, seed):
    """A random head of S states for GW and JW: ``act`` "clamp" (hac's:
    no bias, clamped to +-5), "tanh" (sup's: tanh x 5 and a bias) or
    "bias" (a bias, nothing else)."""
    g = torch.Generator().manual_seed(seed)
    gain = 0.5 if act == "tanh" else 3.0
    h = torch.tanh(torch.randn(Th, N, H, generator=g)).to(cuda, torch.bfloat16)
    wT = (gain * torch.randn(U, 4 * S, H, generator=g) / H ** 0.5).to(
        cuda, torch.bfloat16)
    bias = ((0.3 * torch.randn(U, 4 * S, generator=g)).to(cuda)
            if act != "clamp" else None)
    tanh = act == "tanh"
    clamp = act == "clamp"
    return Head(h, wT, bias, tanh, 5.0 if tanh else 1.0,
                -5.0 if clamp else None, 5.0 if clamp else None, 2.0)


@pytest.mark.parametrize("N,Th,H,S,U,act", [
    (4, 24, 1024, 1024, 1, "clamp"), (6, 12, 512, 1024, 2, "tanh"),
    (3, 19, 64, 1024, 1, "tanh"), (5, 11, 512, 1024, 2, "bias"),
    (2, 13, 256, 512, 1, "tanh"), (7, 45, 128, 512, 2, "clamp"),
    (1, 1, 16, 1024, 1, "clamp"), (33, 9, 48, 512, 1, "bias"),
    (96, 40, 1024, 1024, 1, "clamp"), (16, 70, 512, 1024, 2, "tanh")])
def test_wide_decode_equals_its_earlier_kernels(cuda, N, Th, H, S, U, act):
    """GW (the head product, then the forward pass on B's ring in f32) and
    JW (the backward pass on C's ring over the same moves) on the route
    ``viterbi_decode_head`` takes: one product, one launch each counted,
    the plans recorded, every output equal to the earlier GW's and JW's bit
    for bit (move-in, choices, c, logZ, end state; sequence, qstring,
    moves), and the moves to ``head_moves_plain``'s. U 1 and 2, S 512 and
    1024, with and without bias, tanh and clamp, and N * Th no multiple of
    the product's 128-row tile; JW handed the moves launches no product."""
    head = _wide_head(cuda, N, Th, H, S, U, act, N + Th + H)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = decode_fused_cuda.wide_decode_plan(N, Th, H, S, U, sms)
    assert plan is not None
    f = decode_fused_cuda
    counts = lambda: (f.head_product.launches,
                      f.tcn_fused_forward_wide.launches,
                      f.tcn_fused_backward_wide.launches)
    before = counts()
    moves = f.move_buffer(head)
    fwd = f.tcn_fused_forward(head, moves_out=moves)
    assert counts() == (before[0] + 1, before[1] + 1, before[2])
    out = f.tcn_fused_backward(head, *fwd, qscale=1.05, qbias=0.2,
                               moves=moves)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    assert f.tcn_fused_forward_wide.plan == plan
    assert f.tcn_fused_backward_wide.plan == plan
    assert f.head_product.plan == plan["product"]
    old_fwd = f.tcn_fused_forward_wide_old_kernel(head)
    old = f.tcn_fused_backward_wide_old_kernel(head, *old_fwd, qscale=1.05,
                                               qbias=0.2)
    torch.cuda.synchronize()
    assert counts() == (before[0] + 1, before[1] + 1, before[2] + 1)
    for a, b in zip(fwd, old_fwd):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    for k in ("sequence", "qstring", "moves"):
        assert torch.equal(out[k], old[k]), k
    want = f.head_moves_plain(head)
    assert torch.equal(moves.view(torch.int32), want.view(torch.int32))
    if N * Th * U > 1:  # one frame decodes to one move or one stay
        assert 0 < out["moves"].float().mean().item() < 1


def test_wide_decode_without_moves_takes_the_product_itself(cuda):
    """GW and JW called alone, as ``tcn_fused_forward(head)`` and
    ``tcn_fused_backward(head, *fwd)``: each takes the product (two
    launches of it), with the same outputs as with the moves handed over;
    the route's moves of another shape or type raise."""
    head = _wide_head(cuda, 5, 17, 64, 1024, 2, "tanh", 3)
    f = decode_fused_cuda
    before = f.head_product.launches
    fwd = f.tcn_fused_forward(head)
    out = f.tcn_fused_backward(head, *fwd, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    assert f.head_product.launches == before + 2
    moves = f.move_buffer(head)
    fwd2 = f.tcn_fused_forward(head, moves_out=moves)
    out2 = f.tcn_fused_backward(head, *fwd2, qscale=1.05, qbias=0.2,
                                moves=moves)
    for a, b in zip(fwd, fwd2):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert all(torch.equal(out[k], out2[k]) for k in out)
    with pytest.raises(ValueError, match="moves"):
        f.tcn_fused_backward(head, *fwd, moves=moves[:, :-1])
    with pytest.raises(ValueError, match="moves"):
        f.tcn_fused_forward(head, moves_out=moves.to(torch.bfloat16))


def test_wide_decode_on_its_earlier_kernels_without_a_plan(cuda,
                                                           monkeypatch):
    """Where ``wide_decode_plan`` gives None (as chip_smoke.py's turns
    make it), GW and JW run the earlier kernels, counted as GW and JW, no
    product is launched and ``move_buffer`` gives None."""
    head = _wide_head(cuda, 3, 10, 64, 1024, 1, "clamp", 4)
    f = decode_fused_cuda
    monkeypatch.setattr(f, "wide_decode_plan", lambda *a, **k: None)
    assert f.move_buffer(head) is None
    counts = lambda: (f.head_product.launches,
                      f.tcn_fused_forward_wide.launches,
                      f.tcn_fused_backward_wide.launches)
    before = counts()
    out = decode.viterbi_decode_head(CTC_CRF(5, ["N", "A", "C", "G", "T"]),
                                     head, qscale=1.05, qbias=0.2)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1] + 1, before[2] + 1)
    old_fwd = f.tcn_fused_forward_wide_old_kernel(head)
    old = f.tcn_fused_backward_wide_old_kernel(head, *old_fwd, qscale=1.05,
                                               qbias=0.2)
    assert all(torch.equal(out[k], old[k]) for k in old)


@pytest.mark.parametrize("N,Th,H,cols", [
    (96, 30, 1024, 4096), (128, 9, 512, 8192), (5, 11, 512, 8192),
    (1, 1, 16, 4096), (3, 50, 32, 2048)])
def test_head_product_equals_head_moves_plain(cuda, N, Th, H, cols):
    """GW's head product alone: ``head_moves_plain``'s bits (each output
    one f32 sum over k in order), ragged row tiles among the shapes."""
    S, U = (1024, cols // 4096) if cols >= 4096 else (cols // 4, 1)
    head = _wide_head(cuda, N, Th, H, S, U, "tanh" if H == 512 else "clamp",
                      N * Th)
    before = decode_fused_cuda.head_product.launches
    out = decode_fused_cuda.head_product(head)
    torch.cuda.synchronize()
    assert decode_fused_cuda.head_product.launches == before + 1
    want = decode_fused_cuda.head_moves_plain(head)
    assert out.shape == (N, Th * U, 4 * S)
    assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def _freqs(T, r, device):
    inv = 1.0 / (10000.0 ** (np.arange(0, r, 2) / r))
    f = np.outer(np.arange(T), inv)
    return (torch.tensor(np.cos(f), dtype=torch.float32, device=device),
            torch.tensor(np.sin(f), dtype=torch.float32, device=device))


@pytest.mark.parametrize("N,T,H,D,r,window,t_real,dtype", [
    (2, 64, 2, 64, 64, (127, 128), None, torch.bfloat16),
    (3, 200, 4, 16, 16, (63, 64), None, torch.bfloat16),
    (2, 300, 2, 32, 16, (100, 20), 250, torch.bfloat16),
    (2, 130, 2, 24, 16, (15, 16), None, torch.float32),
    (2, 257, 1, 128, 64, (127, 128), None, torch.bfloat16),
    (2, 100, 3, 40, 32, (5, 0), 77, torch.float32),
    (1, 1, 1, 16, 16, (127, 128), None, torch.bfloat16),
    (16, 1000, 8, 64, 64, (127, 128), None, torch.bfloat16),  # sup widths
    (16, 1024, 8, 64, 64, (127, 128), 1000, torch.bfloat16),
    (4, 1000, 8, 64, 32, (127, 128), 937, torch.bfloat16)])
def test_fused_attention_kernel_matches_plain(cuda, N, T, H, D, r, window,
                                              t_real, dtype):
    """Kernel K: the same bf16 operands and the same rounding points as
    the plain version; f32 sums in another order and exp's last bit can
    flip a bf16 rounding of p or of the output: one bf16 step of the
    largest output on the max, 1e-5 on the mean. Ragged T, a padded stream
    (t_real), partial rotary, heads of 16 to 128 and one that is no
    multiple of 16, f32 input."""
    g = torch.Generator().manual_seed(N + T + D)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, dtype)
    cos, sin = _freqs(T, r, cuda)
    fused = attention_cuda.fused_rotary_window_attention
    before = fused.launches
    out = fused(qkv, cos, sin, window, t_real)
    torch.cuda.synchronize()
    assert fused.launches == before + 1
    ref = attention_cuda.fused_rotary_window_attention_plain(
        qkv, cos, sin, window, t_real)
    assert out.shape == (N, T, H, D) and out.dtype == dtype
    assert torch.isfinite(out.float()).all()
    diff = (out.float() - ref.float()).abs()
    step = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    assert diff.max().item() <= step and diff.mean().item() <= 1e-5


# bf16 shapes that K and H take on the stretch kernel: sup inference and
# training widths, ragged T, t_real < T, heads of 16 to 128, small windows
WINDOW_CASES = [
    (2, 64, 2, 64, 64, (127, 128), None),
    (3, 200, 4, 16, 16, (63, 64), None),
    (2, 300, 2, 32, 16, (100, 20), 250),
    (2, 257, 1, 128, 64, (127, 128), None),
    (2, 100, 3, 40, 32, (5, 0), 77),
    (2, 130, 2, 24, 16, (0, 128), None),
    (1, 1, 1, 16, 16, (127, 128), None),
    (16, 1000, 8, 64, 64, (127, 128), None),
    (8, 1024, 8, 64, 32, (127, 128), 1000),
    (4, 1000, 8, 64, 64, (127, 128), 937)]


@pytest.mark.parametrize("N,T,H,D,r,window,t_real", WINDOW_CASES)
def test_window_kernel_matches_the_earlier_kernel(cuda, N, T, H, D, r,
                                                  window, t_real):
    """K and H take the stretch kernel at these shapes (a plan), and it
    computes the earlier kernel's function: each within one bf16 step of
    the largest output of the plain version, so the two within two; H's o
    equals K's bit for bit on both routes, and the lse of the two routes
    within 16 f32 steps of its largest magnitude."""
    g = torch.Generator().manual_seed(N + T + D + r + 1)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, torch.bfloat16)
    cos, sin = _freqs(T, r, cuda)
    k_new = attention_cuda.fused_rotary_window_attention(qkv, cos, sin,
                                                         window, t_real)
    assert attention_cuda.fused_rotary_window_attention.plan is not None
    o_new, lse_new = attention_cuda.fused_rotary_window_attention_train(
        qkv, cos, sin, window, t_real)
    assert attention_cuda.fused_rotary_window_attention_train.plan is not None
    old = attention_cuda.fused_rotary_window_attention_old_kernel
    k_old = old(qkv, cos, sin, window, t_real)
    o_old, lse_old = old(qkv, cos, sin, window, t_real, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o_new, k_new) and torch.equal(o_old, k_old)
    ref = attention_cuda.fused_rotary_window_attention_plain(
        qkv, cos, sin, window, t_real).float()
    step = 2.0 ** (np.floor(np.log2(max(ref.abs().max().item(), 1e-30))) - 7)
    assert (k_new.float() - k_old.float()).abs().max().item() <= 2 * step
    assert (k_new.float() - ref).abs().max().item() <= step
    top = lse_old.abs().max().item()
    assert (lse_new - lse_old).abs().max().item() <= 16 * 2.0 ** (
        np.floor(np.log2(top)) - 23)


@pytest.mark.parametrize("with_lse", [False, True])
@pytest.mark.parametrize("N,T,H,D,r,window,t_real", [
    (3, 1000, 2, 64, 64, (127, 128), 937),
    (2, 700, 2, 32, 16, (100, 20), None),
    (2, 520, 1, 128, 64, (0, 128), None)])
def test_window_kernel_does_not_depend_on_the_stretch(cuda, N, T, H, D, r,
                                                      window, t_real,
                                                      with_lse):
    """The stretch kernel's C entry at stretches of 1 tile (every tile
    stages its own window), 3 and all of T (the ring wraps round): each
    tile computes the same bits whatever its CTA walked before it."""
    from bonito_tpu_torch.ops import build
    g = torch.Generator().manual_seed(T + D)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, torch.bfloat16)
    cos, sin = _freqs(T, r, cuda)
    plan = attention_cuda.window_plan(N, T, H, D, window, torch.bfloat16,
                                      torch.cuda.get_device_properties(
                                          cuda).multi_processor_count)
    outs = []
    for stretch in (1, 3, -(-T // 64)):
        out = torch.empty(N, T, H, D, dtype=torch.bfloat16, device=cuda)
        lse = torch.empty(N, H, T, device=cuda) if with_lse else None
        build.check(build.library().fused_rotary_window_attention_stretch(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), out.data_ptr(),
            lse.data_ptr() if with_lse else None, N, T, H, D, r // 2,
            window[0], window[1], t_real or T, stretch, plan["ring"],
            torch.cuda.current_stream().cuda_stream), "stretch")
        outs.append((out, lse))
    torch.cuda.synchronize()
    for out, lse in outs[1:]:
        assert torch.equal(out, outs[0][0])
        assert not with_lse or torch.equal(lse, outs[0][1])


@pytest.mark.parametrize("N,T,H,D,window,dtype", [
    (2, 64, 2, 64, (127, 128), torch.float32),
    (3, 200, 4, 40, (63, 64), torch.float32),
    (2, 300, 2, 128, (100, 20), torch.bfloat16),
    (2, 77, 3, 8, (3, 4), torch.float32),
    (8, 1000, 8, 64, (127, 128), torch.float32),   # sup widths
    (8, 1024, 8, 64, (127, 128), torch.bfloat16),
    (32, 1000, 8, 40, (127, 128), torch.bfloat16),  # heads of 40, a batch
    # the bf16 instance on the tensor cores: heads of 40 (padded to 48), 64
    # and 128, T no multiple of the 64-token tile, a narrow band and one
    # that reaches past the tile on both sides
    (2, 77, 3, 40, (3, 4), torch.bfloat16),
    (2, 300, 2, 64, (3, 4), torch.bfloat16),
    (3, 200, 2, 128, (127, 128), torch.bfloat16),
    (2, 130, 4, 40, (100, 90), torch.bfloat16),
    (1, 1, 1, 8, (127, 128), torch.bfloat16)])
def test_local_attention_kernel_matches_plain(cuda, N, T, H, D, window, dtype):
    """Kernel L on strided [N, H, T, D] views of a packed qkv: f32 scores,
    p and sums (in bf16, from the inputs' exact values on the tensor cores,
    p split into three bf16 terms), so 2e-5 in f32 (bonito_tpu's tolerance
    for its kernel) and one bf16 step of the output in bf16."""
    g = torch.Generator().manual_seed(N + T + D)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, dtype)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    before = attention_cuda.local_attention.launches
    out = attention.attend(q, k, v, window)
    torch.cuda.synchronize()
    assert attention_cuda.local_attention.launches == before + 1
    ref = attention_cuda.local_attention_plain(q, k, v, window)
    assert out.shape == (N, H, T, D) and out.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2.0 ** -7
    torch.testing.assert_close(out.float(), ref.float(), rtol=0, atol=tol)


@pytest.mark.parametrize("offset", [0, 2])
def test_local_attention_bf16_takes_any_alignment(cuda, offset):
    """Kernel L's bf16 instance copies 16 bytes at a time where q, k, v and
    out allow it, element by element where they do not: heads of 40 viewed
    from rows of 48, at an offset of 0 elements (the first branch) or 2
    (the second). Both meet one bf16 step of the output, and the mean 1e-5."""
    g = torch.Generator().manual_seed(offset)
    buf = torch.randn(2, 150, 3, 4, 48, generator=g).to(cuda, torch.bfloat16)
    q, k, v = (buf[:, :, i, :, offset:offset + 40].transpose(1, 2)
               for i in range(3))
    before = attention_cuda.local_attention.launches
    out = attention_cuda.local_attention(q, k, v, (127, 128))
    torch.cuda.synchronize()
    assert attention_cuda.local_attention.launches == before + 1
    ref = attention_cuda.local_attention_plain(q, k, v, (127, 128))
    diff = (out.float() - ref.float()).abs()
    step = 2.0 ** (np.floor(np.log2(ref.float().abs().max().item())) - 7)
    assert diff.max().item() <= step and diff.mean().item() <= 1e-5


def test_attention_kernels_reject_what_they_do_not_take(cuda):
    """A CUDA input outside a kernel's shapes raises; nothing takes the
    plain version in its place."""
    fused = attention_cuda.fused_rotary_window_attention
    qkv = torch.zeros(1, 32, 3, 2, 40, device=cuda, dtype=torch.bfloat16)
    cos, sin = _freqs(32, 40, cuda)
    before = fused.launches, attention_cuda.local_attention.launches
    with pytest.raises(ValueError, match="rotary_dim a multiple of 16"):
        fused(qkv, cos, sin, (127, 128))
    ok = torch.zeros(1, 32, 3, 2, 32, device=cuda, dtype=torch.bfloat16)
    cos, sin = _freqs(32, 32, cuda)
    with pytest.raises(ValueError, match="left < 128"):
        fused(ok, cos, sin, (128, 128))
    with pytest.raises(TypeError, match="bf16 or f32"):
        fused(ok.half(), cos, sin, (127, 128))
    with pytest.raises(ValueError, match="cos and sin on"):
        fused(ok, cos.cpu(), sin.cpu(), (127, 128))
    with pytest.raises(ValueError, match="t_real"):
        fused(ok, cos, sin, (127, 128), t_real=33)
    with pytest.raises(ValueError, match="contiguous qkv at a 16-byte"):
        fused(ok.expand(2, 32, 3, 2, 32), cos, sin, (127, 128))
    with pytest.raises(ValueError, match="contiguous qkv at a 16-byte"):
        fused(torch.zeros(ok.numel() + 1, device=cuda, dtype=torch.bfloat16)
              [1:].view(ok.shape), cos, sin, (127, 128))
    q = torch.zeros(1, 2, 32, 20, device=cuda)
    with pytest.raises(ValueError, match="multiple of 8"):
        attention_cuda.local_attention(q, q, q, (127, 128))
    q = torch.zeros(1, 2, 16, 32, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        attention_cuda.local_attention(q, q, q, (127, 128))
    assert (fused.launches, attention_cuda.local_attention.launches) == before


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32,
                                   torch.uint8, torch.float64])
@pytest.mark.parametrize("shape,view", [
    ((16, 512, 1000), lambda x: x.transpose(1, 2)),   # the sup stack input
    ((16, 1000, 512), lambda x: x),
    ((4, 50, 36), lambda x: x[:, 3:40:2, 1:30]),
    ((6, 7, 5, 3), lambda x: x.permute(3, 1, 0, 2)),
    ((16, 64, 24), lambda x: x.transpose(1, 2)),
    ((8, 40, 64), lambda x: x[:, :, 8:40]),
    ((3, 1, 40), lambda x: x.expand(3, 6, 40))])
def test_pin_layout_kernel_is_a_contiguous_identical_copy(cuda, shape, view,
                                                          dtype):
    """Kernel P on each of its variants (tile transpose, 16-byte rows,
    element gather): bit-identical, contiguous, one launch."""
    g = torch.Generator().manual_seed(len(shape))
    x = view((torch.randn(*shape, generator=g) * 50).to(cuda).to(dtype))
    before = relayout.pin_layout.launches
    out = relayout.pin_layout(x)
    torch.cuda.synchronize()
    assert relayout.pin_layout.launches == before + 1
    assert out.is_contiguous() and out.data_ptr() != x.data_ptr()
    assert torch.equal(out, x)


def test_pin_layout_rejects_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="bytes"):
        relayout.pin_layout(torch.zeros(4, 4, device=cuda,
                                        dtype=torch.complex128))


def _grad_close(out, ref, min_equal=0.99):
    """Each entry within one bf16 step of its magnitude (another f32 sum
    order can round to the neighbouring bf16 value); most equal."""
    out, ref = out.float(), ref.float()
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert bool(((out - ref).abs() <= step).all())
    assert (out == ref).float().mean().item() >= min_equal


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("state_len,N,T", [(3, 8, 30), (5, 3, 12),
                                           (2, 5, 9)])
def test_logz_kernels_match_plain(cuda, state_len, N, T, dtype, round_bf16,
                                  full):
    """U + V (TCN moves, constant stay) and W + X (full scores): the alpha
    stack and logZ, the forward-only variant, and the gradient in bf16 or
    f32, rounded to bf16 first or not."""
    S = 4 ** state_len
    g = torch.Generator().manual_seed(S + N + T)
    scores = (3 * torch.randn(N, T, (5 if full else 4) * S, generator=g)).to(
        cuda, dtype)
    cot = torch.linspace(-1.5, 2.0, N, device=cuda)
    if full:
        fwd, bwd = logz_cuda.full_forward, logz_cuda.full_backward
        ref_fwd, ref_bwd = logz.full_forward_plain, logz.full_backward_plain
        args = ()
    else:
        fwd, bwd = logz_cuda.tcn_forward, logz_cuda.tcn_backward
        ref_fwd = lambda s, r, w: logz.forward_plain(s, 1.5, r, w)
        ref_bwd = lambda s, *a, **k: logz.backward_plain(s, 1.5, *a, **k)[0]
        args = (1.5,)
    before = (fwd.launches, bwd.launches)
    stack, lz = fwd(scores, *args, round_bf16=round_bf16)
    _, lz_only = fwd(scores, *args, round_bf16=round_bf16, with_stack=False)
    grad = bwd(scores, stack, lz, cot, *args, round_bf16=round_bf16)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 2, before[1] + 1)
    ref_stack, ref_lz = ref_fwd(scores, round_bf16, True)
    torch.testing.assert_close(stack, ref_stack, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(lz, ref_lz, rtol=1e-6, atol=1e-4)
    assert torch.equal(lz, lz_only)
    ref = ref_bwd(scores, ref_stack, ref_lz, cot, round_bf16=round_bf16,
                  out_dtype=dtype)
    assert grad.dtype == dtype and grad.shape == scores.shape
    if round_bf16 or dtype == torch.bfloat16:
        _grad_close(grad, ref)
    else:
        torch.testing.assert_close(grad, ref, rtol=1e-4, atol=1e-7)


# (S, N, T): every S the kernels take, T below (5), at (8) and beyond (9,
# 40, 100) the ring's depth, one row, one frame
LOGZ_RING_SHAPES = [(4, 3, 7), (16, 4, 9), (64, 8, 30), (256, 5, 40),
                    (1024, 3, 12), (1024, 1, 1), (1024, 2, 8), (64, 1, 5),
                    (1024, 32, 100)]


def _logz_inputs(cuda, S, N, T, dtype):
    g = torch.Generator().manual_seed(S + N + T)
    moves = (5 * torch.tanh(torch.randn(N, T, 4 * S, generator=g))).to(
        cuda, dtype)
    cot = torch.linspace(-1.5, 2.0, N, device=cuda)
    cot[0] = 0.0  # a zero cotangent: row 0's gradient is 0
    return moves, cot


@pytest.mark.parametrize("out_dtype", [None, torch.float32])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N,T", LOGZ_RING_SHAPES)
def test_logz_ring_matches_the_earlier_kernels(cuda, S, N, T, dtype,
                                               round_bf16, out_dtype):
    """U and V on the ring (the plan's) against their earlier kernels on
    the same moves, bit for bit: the alpha stack, logZ, the no-stack logZ
    and the gradient in the moves' dtype or f32."""
    moves, cot = _logz_inputs(cuda, S, N, T, dtype)
    stack, lz = logz_cuda.tcn_forward(moves, 1.5, round_bf16)
    _, lz_only = logz_cuda.tcn_forward(moves, 1.5, round_bf16,
                                       with_stack=False)
    grad = logz_cuda.tcn_backward(moves, stack, lz, cot, 1.5, round_bf16,
                                  out_dtype)
    assert logz_cuda.tcn_forward.plan == logz_cuda.logz_plan(
        N, T, S, dtype, _sms(cuda))
    assert logz_cuda.tcn_backward.plan == logz_cuda.tcn_forward.plan
    old_stack, old_lz = logz_cuda.tcn_forward_old_kernel(moves, 1.5,
                                                         round_bf16)
    _, old_only = logz_cuda.tcn_forward_old_kernel(moves, 1.5, round_bf16,
                                                   with_stack=False)
    old = logz_cuda.tcn_backward_old_kernel(moves, old_stack, old_lz, cot,
                                            1.5, round_bf16, out_dtype)
    torch.cuda.synchronize()
    for a, b in ((stack, old_stack), (lz, old_lz), (lz_only, old_only),
                 (lz, lz_only), (grad, old)):
        assert torch.equal(_bits(a), _bits(b))
    assert grad.dtype == (dtype if out_dtype is None else out_dtype)
    assert not grad[0].any() and bool(torch.isfinite(grad.float()).all())


@pytest.mark.parametrize("S,N,T", [(4, 3, 7), (16, 4, 9), (64, 8, 30),
                                   (256, 5, 40), (1024, 3, 12)])
def test_logz_ring_bits_do_not_depend_on_the_assignment(cuda, S, N, T):
    """The ring's C entries at every number of states a thread they take
    (1 and 4 up to S 256; 4 at S 1024) and at rings of 2, 3 and 16
    frames (where they fit in shared memory) give the plan's bits: stack,
    logZ and gradient (f32 moves, f32 gradient, not rounded)."""
    lib = build.library()
    moves, cot = _logz_inputs(cuda, S, N, T, torch.float32)
    stack, lz = logz_cuda.tcn_forward(moves, 1.5, False)
    grad = logz_cuda.tcn_backward(moves, stack, lz, cot, 1.5, False)
    stream = torch.cuda.current_stream().cuda_stream
    for k in (1, 4):
        if logz_cuda.ring_consumers(S, k) + 32 > logz_cuda.THREADS:
            continue
        for ring in (2, 3, 16):
            if logz_cuda.logz_smem(S, ring, torch.float32, True) > 232448:
                continue
            st, z, gr = (torch.full_like(stack, float("nan")),
                         torch.full_like(lz, float("nan")),
                         torch.full_like(grad, float("nan")))
            build.check(lib.logz_tcn_fwd_ring(
                moves.data_ptr(), 1, 0, st.data_ptr(), z.data_ptr(), N, T, S,
                k, ring, 1.5, stream), "logz_tcn_fwd_ring")
            build.check(lib.logz_tcn_bwd_ring(
                moves.data_ptr(), 1, 0, st.data_ptr(), z.data_ptr(),
                cot.data_ptr(), gr.data_ptr(), 1, N, T, S, k, ring, 1.5,
                stream), "logz_tcn_bwd_ring")
            torch.cuda.synchronize()
            for a, b in ((st, stack), (z, lz), (gr, grad)):
                assert torch.equal(_bits(a), _bits(b)), (k, ring)


def test_logz_old_kernels_count_no_launch(cuda):
    moves = torch.zeros(2, 4, 4 * 64, device=cuda, dtype=torch.bfloat16)
    before = (logz_cuda.tcn_forward.launches,
              logz_cuda.tcn_backward.launches)
    stack, lz = logz_cuda.tcn_forward_old_kernel(moves, 2.0)
    logz_cuda.tcn_backward_old_kernel(moves, stack, lz,
                                      torch.ones(2, device=cuda), 2.0)
    torch.cuda.synchronize()
    assert (logz_cuda.tcn_forward.launches,
            logz_cuda.tcn_backward.launches) == before


def test_logz_ring_takes_unaligned_moves_to_the_earlier_kernel(cuda):
    """Moves whose rows do not start 16 bytes apart from an aligned base
    (a view at an offset of 2 bytes): no plan, the earlier kernel, the
    same bits."""
    base = torch.randn(2 * 5 * 4 * 16 + 1, device=cuda).to(torch.bfloat16)
    moves = base[1:].view(2, 5, 4 * 16)
    stack, lz = logz_cuda.tcn_forward(moves, 1.5)
    assert logz_cuda.tcn_forward.plan is None
    old_stack, old_lz = logz_cuda.tcn_forward_old_kernel(moves, 1.5)
    torch.cuda.synchronize()
    assert torch.equal(_bits(stack), _bits(old_stack))
    assert torch.equal(_bits(lz), _bits(old_lz))


@pytest.mark.parametrize("P,N,T", [(13, 8, 24), (37, 5, 40), (1100, 3, 20),
                                   (1, 4, 6)])
def test_lattice_kernels_match_plain(cuda, P, N, T):
    """Y + Z: P not a multiple of 32, above 1024 and 1; rows of length 0
    and -1 (a target shorter than state_len), a zero cotangent; the
    forward without its stack."""
    g = torch.Generator().manual_seed(P + N)
    move = torch.randn(N, T, P - 1, generator=g).to(cuda)
    lengths = torch.tensor([P, 0, -1, max(P // 2, 1), P, 1, 3, P][:N],
                           dtype=torch.int32, device=cuda)
    cot = torch.tensor([1.0, 0.0, 0.0, -2.0, 0.5, 3.0, 1.0, 2.0][:N],
                       device=cuda)
    before = (lattice_cuda.lattice_forward.launches,
              lattice_cuda.lattice_backward.launches)
    stack, lz = lattice_cuda.lattice_forward(move, lengths, 2.0)
    _, lz_only = lattice_cuda.lattice_forward(move, lengths, 2.0,
                                              with_stack=False)
    gz, sg = lattice.cotangent(cot, lz)
    dmove = lattice_cuda.lattice_backward(move, stack, lengths, gz, sg, 2.0)
    torch.cuda.synchronize()
    assert (lattice_cuda.lattice_forward.launches,
            lattice_cuda.lattice_backward.launches) == (before[0] + 2,
                                                        before[1] + 1)
    ref_stack, ref_lz = lattice.forward_plain(move, lengths, 2.0)
    torch.testing.assert_close(stack, ref_stack, rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(lz, ref_lz, rtol=1e-6, atol=1e-4)
    assert torch.equal(lz, lz_only)
    assert lz[1].item() == 0 and lz[2].item() == 0
    ref = lattice.backward_plain(move, ref_stack, lengths, gz, sg, 2.0)
    torch.testing.assert_close(dmove, ref, rtol=1e-5, atol=1e-7)
    assert bool(torch.isfinite(dmove).all()) and not dmove[1:3].any()


@pytest.mark.parametrize("N,T,P", [
    (128, 1000, 496), (128, 1200, 598), (32, 2048, 1020),  # training
    (6, 40, 597), (5, 33, 33), (4, 17, 2), (3, 21, 31), (3, 7, 1025),
    (2, 9, 2048)])
def test_lattice_backward_split_equals_its_earlier_kernel(cuda, N, T, P):
    """Kernel Z split over warps (``lattice_plan``: hac's, fast's and sup's
    training shapes, P odd, P - 1 no multiple of 4, P below a warp, and
    two positions a thread above 32 warps of one): one launch counted, the
    plan it ran,
    and dmove equal to the earlier Z's bit for bit, with rows of length 0,
    1 and -1 and cotangents of sign -1, 0 and +1."""
    g = torch.Generator(device=cuda).manual_seed(N + T + P)
    move = 2 * torch.randn(N, T, P - 1, device=cuda, generator=g)
    lengths = torch.randint(P // 2, P + 1, (N,), device=cuda, generator=g,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, -1], dtype=torch.int32)[:N]
    cot = torch.randn(N, device=cuda, generator=g)
    cot[1:3] = 0.0
    stack, lz = lattice_cuda.lattice_forward(move, lengths, 2.0)
    gz, sg = lattice.cotangent(cot, lz)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = lattice_cuda.lattice_plan(N, T, P, sms)
    assert plan is not None
    before = lattice_cuda.lattice_backward.launches
    dmove = lattice_cuda.lattice_backward(move, stack, lengths, gz, sg, 2.0)
    old = lattice_cuda.lattice_backward_old_kernel(move, stack, lengths, gz,
                                                   sg, 2.0)
    torch.cuda.synchronize()
    assert lattice_cuda.lattice_backward.launches == before + 1
    assert lattice_cuda.lattice_backward.plan == plan
    assert torch.equal(dmove.view(torch.int32), old.view(torch.int32))


# P from 2 to 2048: below a warp, around the warps' edges, P - 1 no
# multiple of 4, two positions a thread above 1024, and the training shapes
Y_SHAPES = [(128, 1000, 496), (128, 1200, 598), (32, 2048, 1020),
            (4, 17, 2), (5, 9, 3), (3, 21, 31), (3, 20, 32), (3, 20, 33),
            (6, 40, 597), (3, 8, 1024), (3, 7, 1025), (2, 9, 2048),
            (2, 1, 65), (3, 40, 33)]


@pytest.mark.parametrize("with_stack", [True, False])
@pytest.mark.parametrize("N,T,P", Y_SHAPES)
def test_lattice_forward_split_equals_its_earlier_kernel(cuda, N, T, P,
                                                         with_stack):
    """Kernel Y split over warps (``lattice_fwd_plan``) against the
    earlier Y on the same moves, bit for bit: the stack and logZ, and the
    forward without its stack; rows of length 0, 1, -1, P, above P and
    between. One launch counted, the plan it ran recorded."""
    g = torch.Generator(device=cuda).manual_seed(N + T + P)
    move = 2 * torch.randn(N, T, P - 1, device=cuda, generator=g)
    lengths = torch.randint(P // 2, P + 1, (N,), device=cuda, generator=g,
                            dtype=torch.int32)
    lengths[:3] = torch.tensor([0, 1, -1], dtype=torch.int32)[:N]
    lengths[3:4] = P + 1
    plan = lattice_cuda.lattice_fwd_plan(N, T, P, _sms(cuda))
    assert plan is not None
    before = lattice_cuda.lattice_forward.launches
    stack, lz = lattice_cuda.lattice_forward(move, lengths, 2.0, with_stack)
    old_stack, old_lz = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, 2.0, with_stack)
    torch.cuda.synchronize()
    assert lattice_cuda.lattice_forward.launches == before + 1
    assert lattice_cuda.lattice_forward.plan == plan
    assert torch.equal(_bits(lz), _bits(old_lz))
    assert (stack is None) == (old_stack is None) == (not with_stack)
    if with_stack:
        assert torch.equal(_bits(stack), _bits(old_stack))
    zero = [i for i in (0, 2, 3) if i < N]  # lengths 0, -1 and P + 1
    assert not lz[zero].any()


@pytest.mark.parametrize("k,depth", [(k, d) for k in (1, 2)
                                     for d in lattice_cuda.Y_DEPTHS[k]])
def test_lattice_forward_split_bits_do_not_depend_on_the_instance(cuda, k,
                                                                  depth):
    """Every instance of ``lattice_fwd_split`` (1 or 2 positions a thread,
    each prefetch depth built) gives the earlier Y's stack and logZ."""
    N, T, P = 5, 45, 300
    g = torch.Generator(device=cuda).manual_seed(7)
    move = 2 * torch.randn(N, T, P - 1, device=cuda, generator=g)
    lengths = torch.tensor([P, 0, 150, P - 1, 1], dtype=torch.int32,
                           device=cuda)
    old_stack, old_lz = lattice_cuda.lattice_forward_old_kernel(
        move, lengths, 2.0)
    stack, lz = torch.full_like(old_stack, float("nan")), torch.empty_like(
        old_lz)
    build.check(build.library().lattice_fwd_split(
        move.data_ptr(), lengths.data_ptr(), stack.data_ptr(), lz.data_ptr(),
        N, T, P, k, depth, 2.0, torch.cuda.current_stream().cuda_stream),
        "lattice_fwd_split")
    torch.cuda.synchronize()
    assert torch.equal(_bits(stack), _bits(old_stack))
    assert torch.equal(_bits(lz), _bits(old_lz))


def test_lattice_old_kernels_count_no_launch(cuda):
    move = torch.randn(3, 5, 40, device=cuda)
    lengths = torch.tensor([41, 20, 0], dtype=torch.int32, device=cuda)
    before = (lattice_cuda.lattice_forward.launches,
              lattice_cuda.lattice_backward.launches)
    stack, lz = lattice_cuda.lattice_forward_old_kernel(move, lengths, 2.0)
    gz, sg = lattice.cotangent(torch.ones(3, device=cuda), lz)
    lattice_cuda.lattice_backward_old_kernel(move, stack, lengths, gz, sg,
                                             2.0)
    torch.cuda.synchronize()
    assert (lattice_cuda.lattice_forward.launches,
            lattice_cuda.lattice_backward.launches) == before


def _full_inputs(cuda, S, N, T, dtype):
    g = torch.Generator().manual_seed(S + N + T)
    scores = (3 * torch.randn(N, T, 5 * S, generator=g)).to(cuda, dtype)
    cot = torch.linspace(-1.5, 2.0, N, device=cuda)
    cot[0] = 0.0  # a zero cotangent: row 0's gradient is 0
    return scores, cot


@pytest.mark.parametrize("out_dtype", [None, torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N,T", LOGZ_RING_SHAPES)
def test_logz_full_ring_matches_the_earlier_kernel(cuda, S, N, T, dtype,
                                                   round_bf16, out_dtype):
    """X on the ring (``logz_plan(..., full=True)``) against the earlier
    X on the same scores and stack, bit for bit, in the scores' dtype, f32
    or bf16; bf16 scores at S 4 (rows of 40 B) take the earlier X."""
    scores, cot = _full_inputs(cuda, S, N, T, dtype)
    stack, lz = logz_cuda.full_forward(scores, round_bf16)
    before = logz_cuda.full_backward.launches
    grad = logz_cuda.full_backward(scores, stack, lz, cot, round_bf16,
                                   out_dtype)
    plan = logz_cuda.logz_plan(N, T, S, dtype, _sms(cuda), full=True)
    assert logz_cuda.full_backward.plan == plan
    assert (plan is None) == (S == 4 and dtype == torch.bfloat16)
    old = logz_cuda.full_backward_old_kernel(scores, stack, lz, cot,
                                             round_bf16, out_dtype)
    torch.cuda.synchronize()
    assert logz_cuda.full_backward.launches == before + 1
    assert torch.equal(_bits(grad), _bits(old))
    assert grad.dtype == (dtype if out_dtype is None else out_dtype)
    assert not grad[0].any() and bool(torch.isfinite(grad.float()).all())


@pytest.mark.parametrize("S,N,T", [(4, 3, 7), (16, 4, 9), (64, 8, 30),
                                   (256, 5, 40), (1024, 3, 12)])
def test_logz_full_ring_bits_do_not_depend_on_the_ring(cuda, S, N, T):
    """X's C entry at every number of predecessors a thread it takes,
    with the chain's consumer threads alone, the plan's and 640, and rings
    of 2, 3 and 16 frames (where they fit in shared memory), gives the
    plan's gradient (f32 scores and gradient, not rounded)."""
    lib = build.library()
    scores, cot = _full_inputs(cuda, S, N, T, torch.float32)
    stack, lz = logz_cuda.full_forward(scores, False)
    grad = logz_cuda.full_backward(scores, stack, lz, cot, False)
    stream = torch.cuda.current_stream().cuda_stream
    for k in (1, 4):
        if logz_cuda.ring_consumers(S, k) + 32 > logz_cuda.THREADS:
            continue
        chain = logz_cuda.ring_consumers(S, k)
        for nc in sorted({chain, logz_cuda.X_CONSUMERS[S], 640}):
            if nc < chain:
                continue
            for ring in (2, 3, 16):
                if logz_cuda.logz_smem(S, ring, torch.float32, True,
                                       True) > 232448:
                    continue
                gr = torch.full_like(grad, float("nan"))
                build.check(lib.logz_full_bwd_ring(
                    scores.data_ptr(), 1, 0, stack.data_ptr(), lz.data_ptr(),
                    cot.data_ptr(), gr.data_ptr(), 1, N, T, S, k, nc, ring,
                    stream), "logz_full_bwd_ring")
                torch.cuda.synchronize()
                assert torch.equal(_bits(gr), _bits(grad)), (k, nc, ring)


def test_logz_full_old_kernel_counts_no_launch(cuda):
    scores = torch.zeros(2, 4, 5 * 64, device=cuda)
    stack, lz = logz_cuda.full_forward(scores)
    before = logz_cuda.full_backward.launches
    logz_cuda.full_backward_old_kernel(scores, stack, lz,
                                       torch.ones(2, device=cuda))
    torch.cuda.synchronize()
    assert logz_cuda.full_backward.launches == before


def test_logz_full_ring_takes_unaligned_scores_to_the_earlier_kernel(cuda):
    """Scores whose rows do not start 16 bytes apart from an aligned base
    (a view at an offset of 4 bytes): no plan, the earlier X, the same
    bits."""
    base = torch.randn(2 * 5 * 5 * 16 + 1, device=cuda)
    scores = base[1:].view(2, 5, 5 * 16)
    stack, lz = logz_cuda.full_forward(scores)
    cot = torch.tensor([1.0, -0.5], device=cuda)
    grad = logz_cuda.full_backward(scores, stack, lz, cot)
    assert logz_cuda.full_backward.plan is None
    old = logz_cuda.full_backward_old_kernel(scores, stack, lz, cot)
    torch.cuda.synchronize()
    assert torch.equal(_bits(grad), _bits(old))


@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N,T", LOGZ_RING_SHAPES)
def test_logz_full_fwd_ring_matches_the_earlier_kernel(cuda, S, N, T, dtype,
                                                       round_bf16):
    """W on the ring (``logz_plan(..., full=True)["fwd"]``) against the
    earlier W on the same scores, bit for bit: the alpha stack, logZ and
    the no-stack logZ; one launch counted a call, the plan recorded; bf16
    scores at S 4 (rows of 40 B) take the earlier W."""
    scores, _ = _full_inputs(cuda, S, N, T, dtype)
    before = logz_cuda.full_forward.launches
    stack, lz = logz_cuda.full_forward(scores, round_bf16)
    plan = logz_cuda.logz_plan(N, T, S, dtype, _sms(cuda), full=True)
    assert logz_cuda.full_forward.plan == plan
    assert (plan is None) == (S == 4 and dtype == torch.bfloat16)
    _, lz_only = logz_cuda.full_forward(scores, round_bf16, with_stack=False)
    old_stack, old_lz = logz_cuda.full_forward_old_kernel(scores, round_bf16)
    _, old_only = logz_cuda.full_forward_old_kernel(scores, round_bf16,
                                                    with_stack=False)
    torch.cuda.synchronize()
    assert logz_cuda.full_forward.launches == before + 2
    for a, b in ((stack, old_stack), (lz, old_lz), (lz_only, old_only),
                 (lz, lz_only)):
        assert torch.equal(_bits(a), _bits(b))
    assert bool(torch.isfinite(stack).all()) and bool(torch.isfinite(lz).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("S,N,T", [(4, 3, 7), (16, 4, 9), (64, 8, 30),
                                   (256, 5, 40), (1024, 3, 12)])
def test_logz_full_fwd_ring_bits_do_not_depend_on_the_ring(cuda, S, N, T,
                                                           dtype):
    """W's C entry at every number of states a thread it takes (1 and 4
    up to S 256, 4 at S 1024) and rings of 2, 3 and 16 frames (where they
    fit in shared memory), rounded to bf16 and not, with the stack and
    without, gives the earlier W's stack and logZ; it refuses bf16 rows at
    S 4 (40 B, no whole number of 16-byte pieces)."""
    lib = build.library()
    scores, _ = _full_inputs(cuda, S, N, T, dtype)
    stream = torch.cuda.current_stream().cuda_stream
    refused = S == 4 and dtype == torch.bfloat16
    for rnd in (True, False):
        old_stack, old_lz = logz_cuda.full_forward_old_kernel(scores, rnd)
        for k in (1, 4):
            if logz_cuda.ring_consumers(S, k) + 32 > logz_cuda.THREADS:
                continue
            for ring in (2, 3, 16):
                if logz_cuda.logz_smem(S, ring, dtype, False,
                                       True) > 232448:
                    continue
                st = torch.full_like(old_stack, float("nan"))
                z, z_only = (torch.full_like(old_lz, float("nan"))
                             for _ in range(2))
                rcs = [lib.logz_full_fwd_ring(
                    scores.data_ptr(), int(dtype == torch.float32), int(rnd),
                    None if out is None else out.data_ptr(), lz.data_ptr(),
                    N, T, S, k, ring, stream)
                    for out, lz in ((st, z), (None, z_only))]
                if refused:
                    assert all(rcs), (k, ring)
                    continue
                for rc in rcs:
                    build.check(rc, "logz_full_fwd_ring")
                torch.cuda.synchronize()
                for a, b in ((st, old_stack), (z, old_lz), (z_only, old_lz)):
                    assert torch.equal(_bits(a), _bits(b)), (rnd, k, ring)


def test_logz_full_fwd_old_kernel_counts_no_launch(cuda):
    scores = torch.zeros(2, 4, 5 * 64, device=cuda)
    before = logz_cuda.full_forward.launches
    logz_cuda.full_forward_old_kernel(scores)
    logz_cuda.full_forward_old_kernel(scores, with_stack=False)
    torch.cuda.synchronize()
    assert logz_cuda.full_forward.launches == before


def test_logz_full_fwd_ring_takes_unaligned_scores_to_the_earlier_kernel(
        cuda):
    """Scores whose rows do not start 16 bytes apart from an aligned base
    (a view at an offset of 4 bytes): no plan, the earlier W, the same
    bits."""
    base = torch.randn(2 * 5 * 5 * 16 + 1, device=cuda)
    scores = base[1:].view(2, 5, 5 * 16)
    stack, lz = logz_cuda.full_forward(scores)
    assert logz_cuda.full_forward.plan is None
    old_stack, old_lz = logz_cuda.full_forward_old_kernel(scores)
    torch.cuda.synchronize()
    assert torch.equal(_bits(stack), _bits(old_stack))
    assert torch.equal(_bits(lz), _bits(old_lz))


def test_loss_launches_its_kernels(cuda):
    """loss_tcn with its backward runs U, V, Y and Z once each (U and V on
    the ring: the plan recorded); under no_grad U and Y without their
    stacks; loss runs W and X (both on the ring: the plan recorded)."""
    sd = CTC_CRF(3, "NACGT")
    N, T, S, L = 8, 40, 64, 20
    g = torch.Generator().manual_seed(3)
    moves = (2 * torch.randn(N, T, 4 * S, generator=g)).to(
        cuda, torch.bfloat16)
    targets = torch.randint(1, 5, (N, L), generator=g)
    lengths = torch.randint(10, L + 1, (N,), generator=g)
    kernels = (logz_cuda.tcn_forward, logz_cuda.tcn_backward,
               lattice_cuda.lattice_forward, lattice_cuda.lattice_backward,
               logz_cuda.full_forward, logz_cuda.full_backward)
    for k in kernels:
        k.launches = 0
    mv = moves.permute(1, 2, 0).detach().requires_grad_()
    loss = sd.ctc_loss_tcn(mv, 2.0, targets, lengths)
    loss.backward()
    assert mv.grad.dtype == torch.bfloat16 and mv.grad.stride() == mv.stride()
    with torch.no_grad():
        valid = sd.ctc_loss_tcn(mv, 2.0, targets, lengths)
    torch.testing.assert_close(valid, loss.detach(), rtol=0, atol=0)
    plan = logz_cuda.logz_plan(N, T, S, torch.bfloat16, _sms(cuda))
    assert plan is not None
    assert logz_cuda.tcn_forward.plan == plan
    assert logz_cuda.tcn_backward.plan == plan
    scores = torch.randn(N, T, 5 * S, generator=g).to(cuda).requires_grad_()
    sd.ctc_loss(scores, targets, lengths).backward()
    torch.cuda.synchronize()
    assert [k.launches for k in kernels] == [2, 1, 2, 1, 1, 1]
    assert bool(torch.isfinite(scores.grad).all())
    full = logz_cuda.logz_plan(N, T, S, torch.float32, _sms(cuda), full=True)
    assert full is not None
    assert logz_cuda.full_forward.plan == logz_cuda.full_backward.plan == full


def test_loss_kernels_reject_what_they_do_not_take(cuda):
    before = (logz_cuda.tcn_forward.launches,
              lattice_cuda.lattice_forward.launches)
    three = CTC_CRF(3, "NACG")  # n_base 3
    with pytest.raises(ValueError, match="no kernel"):
        three.logZ_tcn(torch.zeros(4, 27 * 3, 8, device=cuda), 2.0)
    big = CTC_CRF(6, "NACGT")   # 4096 states
    with pytest.raises(ValueError, match="no kernel"):
        big.logZ(torch.zeros(8, 2, 5 * 4096, device=cuda))
    with pytest.raises(TypeError, match="bf16 or f32"):
        logz_cuda.tcn_forward(torch.zeros(2, 3, 256, device=cuda,
                                          dtype=torch.float16), 2.0)
    with pytest.raises(ValueError, match="f32 moves"):
        lattice_cuda.lattice_forward(
            torch.zeros(2, 3, 4, device=cuda, dtype=torch.bfloat16),
            torch.ones(2, dtype=torch.int32, device=cuda), 2.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        lattice_cuda.lattice_forward(torch.zeros(2, 3, 4),
                                     torch.ones(2, dtype=torch.int32), 2.0)
    assert (logz_cuda.tcn_forward.launches,
            lattice_cuda.lattice_forward.launches) == before


# ---------------------------------------------------------------------------
# kernels R and S: the LSTM recurrence of a train step and its BPTT
# ---------------------------------------------------------------------------

# S's cluster size at each shape on an H100 (132 SMs, 132 CTAs resident in
# clusters of 1 or 2): at H 96 a warp's share of 4H / 2 columns is no
# whole number of k-steps
H100_RESIDENT = {1: 132, 2: 132}
H100_CLUSTER = {(40, 64): 2, (128, 96): 1, (128, 1024): 2, (64, 1024): 2,
                (32, 1024): 2, (200, 1024): 2}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("round_bf16", [True, False])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("N,T,H", [
    (8, 9, 16), (40, 17, 64), (128, 6, 96),
    (128, 33, 1024),    # hac training: R as A (128 CTAs), S in clusters
    (64, 33, 1024),     # the train CLI's default batch: 2 slices of 32
    (32, 33, 1024),     # a small batch: 2 slices of 16, 8-row chunks
    (200, 7, 1024),     # more rows than one grid holds: two row groups
    (8, 5, 2048)])      # W_hh beyond shared memory: the step kernels
def test_lstm_train_kernels_match_plain(cuda, N, T, H, reverse, round_bf16,
                                        dtype):
    """R against its plain version as kernel A against its own (in bf16 h
    is rounded each step and f32 sums run in another order: a flipped
    rounding drifts by a few bf16 steps); S on R's own output against its
    plain version on the same tensors: its product's f32 sums in another
    order, within two bf16 steps of the largest gradient (and of c, which
    is not bounded). Each on the branch of its shape rule
    (``forward_plan``, ``backward_plan``: the persistent kernels for bf16
    storage of a bf16 model where they fit, else the step kernels, which
    also run an f32 model with f32 products), with the launches that branch
    counts and the plan it ran; on an H100, S in each of its cluster
    sizes. Where R runs A's plan, its h is A's bit for bit."""
    g = torch.Generator().manual_seed(N + T + H)
    xw = torch.randn(T, N, 4 * H, generator=g).to(cuda, dtype)
    w_hh = (torch.randn(H, 4 * H, generator=g) / H ** 0.5).to(cuda, dtype)
    g_h = torch.randn(T, N, H, generator=g).to(cuda, dtype)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    fplan = lstm_train_cuda.forward_plan(N, H, sms, dtype, round_bf16)
    bplan = lstm_train_cuda.backward_plan(
        N, H, sms, lstm_train_cuda.resident_ctas(cuda), dtype, round_bf16)
    bf16 = dtype == torch.bfloat16 and round_bf16
    assert (fplan is not None) == (bf16 and H != 2048)
    # S: a warp's k-slice of 4H / cluster columns is no multiple of 16 at
    # H 16; H 2048 is beyond the registers that hold W_hh's block
    assert (bplan is not None) == (bf16 and H not in (16, 2048))
    for plan in (fplan, bplan):
        assert plan is None or plan["launches"] == (2 if N == 200 else 1)
    if bplan is not None and lstm_train_cuda.resident_ctas(cuda) \
            == H100_RESIDENT:
        assert bplan["cluster"] == H100_CLUSTER[N, H]
    before = (lstm_train_cuda.lstm_train_forward.launches,
              lstm_train_cuda.lstm_train_backward.launches)
    h, c, acts = lstm_train_cuda.lstm_train_forward(xw, w_hh, reverse,
                                                    round_bf16)
    dg = lstm_train_cuda.lstm_train_backward(w_hh, acts, c, g_h, reverse,
                                             round_bf16)
    torch.cuda.synchronize()
    assert (lstm_train_cuda.lstm_train_forward.launches,
            lstm_train_cuda.lstm_train_backward.launches) == (
        before[0] + (fplan["launches"] if fplan else 1),
        before[1] + (bplan["launches"] if bplan else 1))
    assert lstm_train_cuda.lstm_train_forward.plan == fplan
    assert lstm_train_cuda.lstm_train_backward.plan == bplan
    store = torch.bfloat16 if round_bf16 else torch.float32
    assert h.dtype == dtype and c.dtype == acts.dtype == store
    assert dg.dtype == store
    if fplan is not None:
        a = lstm_cuda.lstm_recurrence(xw, w_hh, reverse=reverse)
        torch.cuda.synchronize()
        assert lstm_cuda.lstm_recurrence.plan == fplan
        assert torch.equal(h, a)
    ref_h, ref_c, ref_a = lstm_train_cuda.lstm_train_forward_plain(
        xw, w_hh, reverse, round_bf16)
    torch.testing.assert_close(h.float(), ref_h.float(), rtol=0, atol=2e-2)
    torch.testing.assert_close(acts.float(), ref_a.float(), rtol=0,
                               atol=2e-2)
    torch.testing.assert_close(c.float(), ref_c.float(), rtol=0, atol=2e-2 *
                               max(1.0, ref_c.float().abs().max().item()))
    ref_dg = lstm_train_cuda.lstm_train_backward_plain(w_hh, acts, c, g_h,
                                                       reverse, round_bf16)
    big = ref_dg.float().abs().max().item()
    torch.testing.assert_close(dg.float(), ref_dg.float(), rtol=0,
                               atol=2 * 2.0 ** -7 * big)
    assert bool(torch.isfinite(dg.float()).all())


@pytest.mark.parametrize("use_amp", [True, False])
def test_train_step_launches_r_and_s(cuda, use_amp):
    """One train step of a narrow LSTM-CRF on the card, in bf16 amp and in
    f32: R and S once per LSTM layer, U, V, Y, Z once each, and never
    kernel A or F."""
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    cfg = lstm_crf_config(features=64, num_layers=2, state_len=3, stride=5)
    model = Model(cfg).init(3).to(cuda)
    step = make_train_step(model, make_optimizer(model, 2e-3),
                           use_amp=use_amp)
    g = torch.Generator().manual_seed(5)
    N, chunk, L = 16, 500, 40
    x = torch.randn(N, chunk, 1, generator=g).to(cuda)
    lengths = torch.randint(L // 2, L + 1, (N,), generator=g)
    targets = torch.randint(1, 5, (N, L), generator=g)
    targets[torch.arange(L)[None] >= lengths[:, None]] = 0
    kernels = {"R": lstm_train_cuda.lstm_train_forward,
               "S": lstm_train_cuda.lstm_train_backward,
               "U": logz_cuda.tcn_forward, "V": logz_cuda.tcn_backward,
               "Y": lattice_cuda.lattice_forward,
               "Z": lattice_cuda.lattice_backward,
               "A": lstm_cuda.lstm_recurrence, "F": lstm_fused_cuda.lstm_fused}
    for k in kernels.values():
        k.launches = 0
    lstm0 = next(m for m in model.modules() if hasattr(m, "w_hh"))
    w0 = lstm0.w_hh.detach().clone()
    losses, norm = step((x, targets.to(cuda), lengths.to(cuda)), 1.0, 2.0)
    torch.cuda.synchronize()
    assert {k: f.launches for k, f in kernels.items()} == {
        "R": 2, "S": 2, "U": 1, "V": 1, "Y": 1, "Z": 1, "A": 0, "F": 0}
    assert bool(torch.isfinite(losses["loss"])) and bool(torch.isfinite(norm))
    assert not torch.equal(lstm0.w_hh.detach(), w0)
    assert not model.training


def test_lstm_train_kernels_reject_what_they_do_not_take(cuda):
    before = (lstm_train_cuda.lstm_train_forward.launches,
              lstm_train_cuda.lstm_train_backward.launches)
    w = torch.zeros(16, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bf16 or f32"):
        lstm_train_cuda.lstm_train_forward(
            torch.zeros(2, 8, 64, device=cuda, dtype=torch.float16), w.half())
    with pytest.raises(ValueError, match="xw"):  # xw and W_hh of two types
        lstm_train_cuda.lstm_train_forward(
            torch.zeros(2, 8, 64, device=cuda), w)
    with pytest.raises(ValueError, match="multiple of 16"):
        lstm_train_cuda.lstm_train_forward(
            torch.zeros(2, 8, 96, device=cuda, dtype=torch.bfloat16),
            torch.zeros(24, 96, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        lstm_train_cuda.lstm_train_forward(
            torch.zeros(8, 2, 64, device=cuda,
                        dtype=torch.bfloat16).transpose(0, 1), w)
    with pytest.raises(ValueError, match="acts"):
        lstm_train_cuda.lstm_train_backward(
            w, torch.zeros(2, 8, 64, device=cuda), torch.zeros(
                2, 8, 16, device=cuda, dtype=torch.bfloat16),
            torch.zeros(2, 8, 16, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA"):
        lstm_train_cuda.lstm_train_backward(
            w.cpu(), torch.zeros(2, 8, 64, device=cuda), torch.zeros(
                2, 8, 16, device=cuda), torch.zeros(2, 8, 16, device=cuda))
    assert (lstm_train_cuda.lstm_train_forward.launches,
            lstm_train_cuda.lstm_train_backward.launches) == before


@pytest.mark.parametrize("N,T,H,D,r,window,t_real,dtype", [
    (2, 64, 2, 64, 64, (127, 128), None, torch.bfloat16),
    (3, 200, 4, 16, 16, (63, 64), None, torch.bfloat16),
    (2, 300, 2, 32, 16, (100, 20), 250, torch.bfloat16),
    (2, 130, 2, 24, 16, (15, 16), None, torch.float32),
    (2, 257, 1, 128, 64, (127, 128), None, torch.bfloat16),
    (2, 100, 3, 40, 32, (5, 0), 77, torch.float32),
    (1, 1, 1, 16, 16, (127, 128), None, torch.bfloat16),
    (8, 1000, 8, 64, 64, (127, 128), None, torch.bfloat16),  # sup training
    (8, 1024, 8, 64, 64, (127, 128), 1000, torch.float32),
    (8, 1024, 8, 64, 32, (127, 128), None, torch.bfloat16),
    (4, 1000, 8, 64, 64, (127, 128), 937, torch.bfloat16)])
def test_fused_train_kernels_match_plain(cuda, N, T, H, D, r, window, t_real,
                                         dtype):
    """Kernels H and O against their plain versions on the same inputs
    (O's o and lse are H's). H: o equal to K's bit for bit and within one
    bf16 step of the largest output of the plain version (as K); lse within
    16 f32 steps of its largest magnitude (exp, log and sums in another
    order). O: each of dq, dk, dv within one bf16 step of its largest
    magnitude on the max (a flipped bf16 rounding of p, ds or the output)
    and 2^-16 of it on the mean. In bf16 O runs its stretch kernel, on the
    plan ``window_bwd_plan`` gives; in f32 its earlier kernel."""
    g = torch.Generator().manual_seed(N + T + D + r)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, dtype)
    do = torch.randn(N, T, H, D, generator=g).to(cuda, dtype)
    cos, sin = _freqs(T, r, cuda)
    fwd = attention_cuda.fused_rotary_window_attention_train
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    before = fwd.launches, bwd.launches
    o, lse = fwd(qkv, cos, sin, window, t_real)
    dqkv = bwd(qkv, cos, sin, lse, o, do, window, t_real)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    plan = attention_cuda.window_bwd_plan(
        N, T, H, D, window, dtype,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    assert bwd.plan == plan and (plan is None) == (dtype == torch.float32)
    assert torch.equal(o, attention_cuda.fused_rotary_window_attention(
        qkv, cos, sin, window, t_real))
    ref_o, ref_lse = attention_cuda.fused_rotary_window_attention_train_plain(
        qkv, cos, sin, window, t_real)
    ref = attention_cuda.fused_rotary_window_attention_bwd_plain(
        qkv, cos, sin, lse, o, do, window, t_real)
    assert lse.shape == (N, H, T) and lse.dtype == torch.float32
    assert dqkv.shape == qkv.shape and dqkv.dtype == dtype
    assert bool(torch.isfinite(dqkv.float()).all())

    def step(x):
        return 2.0 ** (np.floor(np.log2(max(x.abs().max().item(), 1e-30)))
                       - 7)
    assert (o.float() - ref_o.float()).abs().max().item() <= step(
        ref_o.float())
    top = ref_lse.abs().max().item()
    assert (lse - ref_lse).abs().max().item() <= 16 * 2.0 ** (
        np.floor(np.log2(top)) - 23)
    for i in range(3):
        out, want = dqkv[:, :, i].float(), ref[:, :, i].float()
        diff = (out - want).abs()
        assert diff.max().item() <= step(want), (i, diff.max().item())
        assert diff.mean().item() <= 2.0 ** -16 * want.abs().max().item()


@pytest.mark.parametrize("N,T,H,D,r,window,t_real", WINDOW_CASES)
def test_window_bwd_kernel_matches_the_earlier_kernel(cuda, N, T, H, D, r,
                                                      window, t_real):
    """O takes its stretch kernel at these shapes (a plan), and it computes
    the earlier kernel's function: each of dq, dk and dv within one bf16
    step of the earlier kernel's largest value on the same inputs, and dk
    and dv 0 for the keys at or beyond t_real, which no query sees."""
    g = torch.Generator().manual_seed(N + T + D + r + 2)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, torch.bfloat16)
    do = torch.randn(N, T, H, D, generator=g).to(cuda, torch.bfloat16)
    cos, sin = _freqs(T, r, cuda)
    o, lse = attention_cuda.fused_rotary_window_attention_train(
        qkv, cos, sin, window, t_real)
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    before = bwd.launches
    new = bwd(qkv, cos, sin, lse, o, do, window, t_real)
    assert bwd.plan is not None and bwd.launches == before + 1
    old = attention_cuda.fused_rotary_window_attention_bwd_old_kernel(
        qkv, cos, sin, lse, o, do, window, t_real)
    torch.cuda.synchronize()
    assert bwd.launches == before + 1
    assert bool(torch.isfinite(new.float()).all())
    for i in range(3):
        want = old[:, :, i].float()
        step = 2.0 ** (np.floor(np.log2(max(want.abs().max().item(), 1e-30)))
                       - 7)
        assert (new[:, :, i].float() - want).abs().max().item() <= step, i
    t_real = T if t_real is None else t_real
    assert not new[:, t_real:, 1:].any() and not old[:, t_real:, 1:].any()


@pytest.mark.parametrize("N,T,H,D,r,window,t_real", [
    (3, 1000, 2, 64, 64, (127, 128), 937),
    (2, 700, 2, 32, 16, (100, 20), None),
    (2, 700, 2, 40, 32, (5, 0), 650),
    (2, 520, 1, 128, 64, (0, 128), None)])
def test_window_bwd_kernel_does_not_depend_on_the_stretch(cuda, N, T, H, D,
                                                          r, window, t_real):
    """O's stretch kernel's C entry at stretches of 1 tile (every tile
    stages its own window), 3 and all of T (the rings wrap round): each
    tile of each kind computes the same bits whatever its CTA walked before
    it."""
    from bonito_tpu_torch.ops import build
    g = torch.Generator().manual_seed(T + D + 3)
    qkv = torch.randn(N, T, 3, H, D, generator=g).to(cuda, torch.bfloat16)
    do = torch.randn(N, T, H, D, generator=g).to(cuda, torch.bfloat16)
    cos, sin = _freqs(T, r, cuda)
    o, lse = attention_cuda.fused_rotary_window_attention_train(
        qkv, cos, sin, window, t_real)
    plan = attention_cuda.window_bwd_plan(
        N, T, H, D, window, torch.bfloat16,
        torch.cuda.get_device_properties(cuda).multi_processor_count)
    outs = []
    for stretch in (1, 3, plan["tiles"]):
        dqkv = torch.empty_like(qkv)
        rows = torch.empty(N, H, plan["tiles"] * 64, 2, device=cuda)
        build.check(build.library().fused_rotary_window_attention_bwd_stretch(
            qkv.data_ptr(), cos.data_ptr(), sin.data_ptr(), lse.data_ptr(),
            o.data_ptr(), do.data_ptr(), rows.data_ptr(), dqkv.data_ptr(), N,
            T, H, D, r // 2, window[0], window[1], t_real or T, stretch,
            plan["ring"], torch.cuda.current_stream().cuda_stream), "stretch")
        outs.append(dqkv)
    torch.cuda.synchronize()
    for dqkv in outs[1:]:
        assert torch.equal(dqkv, outs[0])


def test_fused_attention_function_keeps_the_graph(cuda):
    """The Function on the card: H forward, O backward, one launch each;
    x.grad is O's result, cos and sin get zeros."""
    g = torch.Generator().manual_seed(3)
    qkv = torch.randn(2, 150, 3, 2, 32, generator=g).to(cuda, torch.bfloat16)
    do = torch.randn(2, 150, 2, 32, generator=g).to(cuda, torch.bfloat16)
    cos, sin = _freqs(150, 32, cuda)
    x = qkv.clone().requires_grad_()
    fwd = attention_cuda.fused_rotary_window_attention_train
    bwd = attention_cuda.fused_rotary_window_attention_bwd
    before = fwd.launches, bwd.launches
    o = attention.fused_attention_train(x, cos, sin, (127, 128))
    assert o.grad_fn is not None
    o.backward(do)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    o2, lse = fwd(qkv, cos, sin, (127, 128))
    assert torch.equal(o.detach(), o2)
    assert torch.equal(x.grad, bwd(qkv, cos, sin, lse, o2, do, (127, 128)))


def test_raw_attention_kernels_refuse_a_gradient(cuda):
    """K and L write into memory autograd does not see: where a gradient
    is wanted they raise and name the differentiable route; under no_grad
    they run."""
    qkv = torch.randn(1, 40, 3, 2, 16, device=cuda).requires_grad_()
    cos, sin = _freqs(40, 16, cuda)
    with pytest.raises(RuntimeError, match="fused_attention_train"):
        attention_cuda.fused_rotary_window_attention(qkv, cos, sin, (7, 8))
    q = torch.randn(1, 2, 40, 16, device=cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="differentiable=True"):
        attention_cuda.local_attention(q, q, q, (7, 8))
    with torch.no_grad():
        attention_cuda.fused_rotary_window_attention(qkv, cos, sin, (7, 8))
        attention_cuda.local_attention(q, q, q, (7, 8))
    moves = torch.randn(2, 5, 256, device=cuda,
                        dtype=torch.bfloat16).requires_grad_()
    with pytest.raises(RuntimeError, match="no_grad"):
        decode_cuda.tcn_forward(moves, 2.0)


def test_pin_layout_backward_is_the_identity_on_the_card(cuda):
    """P forward and P on the cotangent: two launches, x.grad equal to the
    transposed cotangent, every bit."""
    x = torch.randn(4, 64, 100, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2).requires_grad_()
    g = torch.randn(4, 64, 100, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    before = relayout.pin_layout.launches
    y = relayout.pin_layout(x)
    assert y.is_contiguous() and torch.equal(y, x)
    y.backward(g)
    torch.cuda.synchronize()
    assert relayout.pin_layout.launches == before + 2
    assert torch.equal(x.grad, g)


def _sup_counters():
    return {"H": attention_cuda.fused_rotary_window_attention_train,
            "O": attention_cuda.fused_rotary_window_attention_bwd,
            "K": attention_cuda.fused_rotary_window_attention,
            "L": attention_cuda.local_attention, "P": relayout.pin_layout,
            "U": logz_cuda.tcn_forward, "V": logz_cuda.tcn_backward,
            "Y": lattice_cuda.lattice_forward,
            "Z": lattice_cuda.lattice_backward}


def _sup_batch(cuda, N=8, chunk=1536, L=50):
    g = torch.Generator().manual_seed(5)
    x = torch.randn(N, chunk, 1, generator=g).to(cuda)
    lengths = torch.randint(L // 2, L + 1, (N,), generator=g)
    targets = torch.randint(1, 5, (N, L), generator=g)
    targets[torch.arange(L)[None] >= lengths[:, None]] = 0
    return x, targets.to(cuda), lengths.to(cuda)


def test_sup_backward_reaches_every_parameter(cuda):
    """The fault this slice repaired: a backward through a sup model on the
    card gives every convolution and each wqkv a gradient (the layout pin
    and the fused attention keep the graph), through P twice and H, O once
    per layer, never K or L."""
    from bonito_tpu_torch.models import transformer_crf_config
    from bonito_tpu_torch.transformer.model import Model as SupModel
    cfg = transformer_crf_config(d_model=64, nhead=4, depth=2,
                                 dim_feedforward=128, state_len=3)
    model = SupModel(cfg).init(3).to(cuda)
    x, targets, lengths = _sup_batch(cuda)
    counters = _sup_counters()
    for k in counters.values():
        k.launches = 0
    model.train()
    moves, blank = model.forward_tcn(x.to(torch.bfloat16))
    model.loss_tcn(moves, blank, targets, lengths).backward()
    torch.cuda.synchronize()
    model.eval()
    assert {k: c.launches for k, c in counters.items()} == {
        "H": 2, "O": 2, "K": 0, "L": 0, "P": 2, "U": 1, "V": 1, "Y": 1,
        "Z": 1}
    for name, p in model.named_parameters():
        if name.endswith("wqkv") or (".conv." in name and name.endswith(
                ".w")):
            assert p.grad is not None and p.grad.abs().max().item() > 0, name


@pytest.mark.parametrize("use_amp", [True, False])
@pytest.mark.parametrize("heads", [(64, 4), (80, 2)])  # fused; local (of 40)
def test_sup_train_step_launches(cuda, heads, use_amp):
    """One sup train step on the card, bf16 amp and f32: P 2, H and O once a
    layer on the fused route (none on the local route, heads of 40, where
    the blocked plain torch attention keeps the graph), U, V, Y, Z once,
    never K or L; every parameter but a convolution's bias in front of
    BatchNorm moves."""
    from bonito_tpu_torch.models import transformer_crf_config
    from bonito_tpu_torch.training import make_optimizer, make_train_step
    from bonito_tpu_torch.transformer.model import Model as SupModel
    d_model, nhead = heads
    cfg = transformer_crf_config(d_model=d_model, nhead=nhead, depth=2,
                                 dim_feedforward=128, state_len=3)
    model = SupModel(cfg).init(3).to(cuda)
    step = make_train_step(model, make_optimizer(model, 2e-3),
                           use_amp=use_amp)
    before = {k: p.detach().clone() for k, p in model.named_parameters()}
    counters = _sup_counters()
    for k in counters.values():
        k.launches = 0
    losses, norm = step(_sup_batch(cuda), 1.0, 2.0)
    torch.cuda.synchronize()
    fused = 2 if nhead == 4 else 0
    assert {k: c.launches for k, c in counters.items()} == {
        "H": fused, "O": fused, "K": 0, "L": 0, "P": 2, "U": 1, "V": 1,
        "Y": 1, "Z": 1}
    assert bool(torch.isfinite(losses["loss"])) and bool(torch.isfinite(norm))
    still = [k for k, p in model.named_parameters()
             if torch.equal(p.detach(), before[k])
             and not (k.endswith(".b") and k[:-1] + "norm.scale" in before)]
    assert not still, still


# ---------------------------------------------------------------------------
# the basecaller CLI on the card
# ---------------------------------------------------------------------------

def _cli_to(out, argv):
    """``python -m bonito_tpu_torch basecaller`` in this process with fd 1
    on ``out`` (the format comes from its name)."""
    import io
    import os
    import sys
    from bonito_tpu_torch.cli import main
    saved, stdout, stderr = os.dup(1), sys.stdout, sys.stderr
    with open(out, "wb") as f:
        os.dup2(f.fileno(), 1)
        sys.stdout = io.TextIOWrapper(io.BufferedWriter(
            io.FileIO(1, "w", closefd=False)))
        sys.stderr = io.StringIO()
        try:
            main(["basecaller"] + argv + ["--output-dir", str(out.parent)])
            sys.stdout.flush()
        finally:
            os.dup2(saved, 1)
            os.close(saved)
            sys.stdout, sys.stderr = stdout, stderr


# the CLI on the card against --device cpu: bf16 in both, as the CLI loads
# a model, and bf16 is not bit-comparable between the card's kernels and
# cuDNN and the CPU's plain versions (ROADMAP Queue 3): a share of frames
# may decode otherwise (seen: 2 of 4940 frames, NVIDIA H100 80GB HBM3,
# torch 2.11.0+cu128)
CLI_MIN_EQUAL = 0.999


def test_basecaller_cli_on_the_card_equals_the_cpu(cuda, tmp_path):
    """A small fast-geometry model (H 96, two layers, state_len 3: F, G, J)
    in bf16 as the CLI loads it, a pod5 directory of two files from the
    port's writer, two reader processes: the BAM on the card holds the
    records of ``--device cpu`` (the plain versions): the same reads,
    flags and reader tags (RG, ns, ts, mx, ch, st, du, rn, f5, sm, sd, sv),
    at least CLI_MIN_EQUAL of the frames' moves alike and, on the reads
    whose moves are all alike, of the bases, with qstrings within one phred
    step where the bases are alike;
    with F twice and G, J once per batch and no other kernel."""
    from uuid import UUID
    from bonito_tpu_torch import checkpoint, config, pod5
    from bonito_tpu_torch.util import chunk
    from bam_records import parse_bam, parse_tags
    cfg = lstm_crf_config(features=96, num_layers=2, state_len=3, stride=5,
                          batchsize=8, chunksize=1000, overlap=200)
    cfg["basecaller"]["quantize"] = False
    model = Model(cfg).init(3)
    _, (_, crf), _ = model.decode_head()
    with torch.no_grad():
        crf.w.mul_(10)
    (tmp_path / "model").mkdir()
    config.save_config(cfg, tmp_path / "model" / "config.toml")
    checkpoint.save_params(tmp_path / "model" / "weights_1.npz", model)
    rng = np.random.default_rng(3)
    lengths = [3000, 7000, 1200, 9000, 500, 4000]
    reads = [{"read_id": str(UUID(int=i + 1)),
              "signal": np.rint((90 + 23 * rng.normal(size=n)) / 0.2
                                ).astype(np.int16),
              "calibration_scale": 0.2} for i, n in enumerate(lengths)]
    (tmp_path / "reads").mkdir()
    pod5.write_pod5(tmp_path / "reads" / "a.pod5", reads[:4])
    pod5.write_pod5(tmp_path / "reads" / "b.pod5", reads[4:], compress=False)
    argv = [str(tmp_path / "model"), str(tmp_path / "reads"), "--n-proc", "2",
            "--no-trim"]
    counters = {"F": lstm_fused_cuda.lstm_fused,
                "G": decode_fused_cuda.tcn_fused_forward,
                "J": decode_fused_cuda.tcn_fused_backward,
                "A": lstm_cuda.lstm_recurrence, "B": decode_cuda.tcn_forward,
                "C": decode_cuda.tcn_backward,
                "D": lstm_int8_cuda.lstm_int8_fused,
                "M": decode_full_cuda.full_forward,
                "Q": decode_full_cuda.full_backward}
    before = {k: fn.launches for k, fn in counters.items()}
    (tmp_path / "card").mkdir()
    _cli_to(tmp_path / "card" / "out.bam", argv)
    torch.cuda.synchronize()
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    (tmp_path / "cpu").mkdir()
    _cli_to(tmp_path / "cpu" / "out.bam", argv + ["--device", "cpu"])
    card = parse_bam((tmp_path / "card" / "out.bam").read_bytes())
    cpu = parse_bam((tmp_path / "cpu" / "out.bam").read_bytes())
    assert card[0] == cpu[0] and len(card[2]) == len(cpu[2]) == len(reads)
    equal = frames = same_bases = bases = 0
    for x, y in zip(card[2], cpu[2]):
        assert x[1] == y[1] and x[0][4] == y[0][4]  # name, flag
        tx, ty = parse_tags(x[5]), parse_tags(y[5])
        mx, my = tx.pop("mv"), ty.pop("mv")
        tx.pop("qs"), ty.pop("qs")
        assert tx == ty and len(mx) == len(my) and mx[0] == my[0]
        equal += int((mx[1:] == my[1:]).sum())
        frames += len(mx) - 1
        if np.array_equal(mx, my):  # then base i of one is base i of other
            sx = np.frombuffer(x[3], np.uint8)
            sy = np.frombuffer(y[3], np.uint8)
            alike = np.stack([sx >> 4 == sy >> 4, sx & 15 == sy & 15],
                             1).ravel()[:len(x[4])]
            same_bases += int(alike.sum())
            bases += len(alike)
            d = (np.frombuffer(x[4].encode(), np.uint8).astype(int)
                 - np.frombuffer(y[4].encode(), np.uint8))
            assert np.abs(d[alike]).max(initial=0) <= 1
    print(f"card vs cpu: {equal} of {frames} frames' moves alike "
          f"({equal / frames:.5f}); on the reads with all moves alike, "
          f"{same_bases} of {bases} bases")
    assert equal >= CLI_MIN_EQUAL * frames
    assert same_bases >= CLI_MIN_EQUAL * bases
    n_chunks = sum(chunk(np.zeros(n), 1000, 200).shape[0] for n in lengths)
    batches = -(-n_chunks // 8)
    assert launches == {"F": 2 * batches, "G": batches, "J": batches,
                        "A": 0, "B": 0, "C": 0, "D": 0, "M": 0, "Q": 0}
    assert len((tmp_path / "card" / "out_summary.tsv").read_text()
               .splitlines()) == len(reads) + 1
