// Kernels M and Q: the two-pass Viterbi + posterior CRF decode from full
// score tensors, whose stay scores are a plane of their own.
//
// Replace bonito_tpu/ops/decode_pallas.py:viterbi_decode_pallas — M is
// `_fwd_kernel` (forward pass), Q is `_bwd_kernel` (backward pass)
// together with that function's qscore epilogue. The passes are B's and
// C's; only the frame's layout differs.
//
// Layout. Scores are read as [N, T, S*(nb+1)] in bf16 or f32, the memory
// the CRF head writes: state s owns the nb+1 adjacent columns s*(nb+1) ..
// s*(nb+1)+nb, the stay first, then the move from predecessor p = j*R + s/nb
// in column s*(nb+1)+1+j. The TPU version splits this tensor with XLA
// transposes into a stay plane and a (b, j, r)-ordered move block before
// its kernels; here each frame's row is copied as it lies and every thread
// reads its states' values. At hac (N=96, T=1666, S=1024, bf16) both passes
// read the 1.64 GB score tensor; M writes 0.66 GB of f32 move-in and 0.16 GB
// of choices, Q reads a quarter of the move-in back.
//
// The reverse strand (`reverse`): the scores of seqdist.reverse_complement
// read from the forward strand's scores in place (crf_frames.cuh,
// RevFullFrame, has the map), the same function as M and Q on the copy, bit
// for bit, with one copy of the scores fewer; move_in and choices keep the
// states in the forward strand's order (reverse state s in column
// rc_sl(s)), where the ring kernels store them in whole warps.
//
// Two designs. The ring kernels (decode_ring.cuh, FullRows: a CTA a row of
// four states a thread, frames staged ahead through a ring, one barrier a
// frame) for S a multiple of 16, on the ring ops/decode_full_cuda.py's
// decode_full_plan gives; the earlier kernels (decode_passes.cuh: a block a
// row, a thread a state, the frame's row loaded when it starts) for S 4 and
// what the plan refuses, and for the comparisons. Both take the same f32
// steps, so every output is the same bits.

#include "decode_passes.cuh"
#include "decode_ring.cuh"

namespace {

// S = 4**state_len, 4 to 1024 states (a thread each)
bool bad_shape(int N, int T, int S) {
    return N < 1 || T < 1 || S < NB || S > 1024 || (S & (S - 1)) != 0
        || (S & 0x55555555) == 0;
}

int state_len(int S) { return (__builtin_ffs(S) - 1) / 2; }

}  // namespace

extern "C" {

// scores [N, T, (NB+1)*S] (bf16, or f32 when is_f32; the forward strand's
// when reverse) -> move_in [N, T, S] f32, choices [N, T, S] uint8, c [N, T]
// f32, logz [N] f32, end_state [N] int32
int decode_full_fwd(const void* scores, int is_f32, int reverse,
                    void* move_in, void* choices, void* c, void* logz,
                    void* end_state, int N, int T, int S, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    if (reverse) {
        auto launch = is_f32 ? launch_fwd<RevFullFrame, float>
                             : launch_fwd<RevFullFrame, __nv_bfloat16>;
        return launch(scores, move_in, choices, c, logz, end_state, N, T, S,
                      RevFullFrame{state_len(S)}, stream);
    }
    auto launch = is_f32 ? launch_fwd<FullFrame, float>
                         : launch_fwd<FullFrame, __nv_bfloat16>;
    return launch(scores, move_in, choices, c, logz, end_state, N, T, S,
                  FullFrame{}, stream);
}

// the forward's outputs -> sequence, qstring, moves_out, each [N, T] uint8
int decode_full_bwd(const void* scores, int is_f32, int reverse,
                    const void* move_in, const void* choices, const void* c,
                    const void* logz, const void* end_state, void* seq,
                    void* qstr, void* mvout, int N, int T, int S,
                    float qscale, float qbias, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    if (reverse) {
        auto launch = is_f32 ? launch_bwd<RevFullFrame, float>
                             : launch_bwd<RevFullFrame, __nv_bfloat16>;
        return launch(scores, move_in, choices, c, logz, end_state, seq,
                      qstr, mvout, N, T, S, qscale, qbias,
                      RevFullFrame{state_len(S)}, stream);
    }
    auto launch = is_f32 ? launch_bwd<FullFrame, float>
                         : launch_bwd<FullFrame, __nv_bfloat16>;
    return launch(scores, move_in, choices, c, logz, end_state, seq, qstr,
                  mvout, N, T, S, qscale, qbias, FullFrame{}, stream);
}

// kernel M on a ring of `ring` frames: as decode_full_fwd
int decode_full_fwd_ring(const void* scores, int is_f32, int reverse,
                         void* move_in, void* choices, void* c, void* logz,
                         void* end_state, int N, int T, int S, int ring,
                         void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    const float* f = static_cast<const float*>(scores);
    const bf16* h = static_cast<const bf16*>(scores);
    if (is_f32)
        return reverse
            ? launch_fwd_ring(FullRows<float, true>{f}, scores, move_in,
                              choices, c, logz, end_state, N, T, S, ring,
                              stream)
            : launch_fwd_ring(FullRows<float, false>{f}, scores, move_in,
                              choices, c, logz, end_state, N, T, S, ring,
                              stream);
    return reverse
        ? launch_fwd_ring(FullRows<bf16, true>{h}, scores, move_in, choices,
                          c, logz, end_state, N, T, S, ring, stream)
        : launch_fwd_ring(FullRows<bf16, false>{h}, scores, move_in, choices,
                          c, logz, end_state, N, T, S, ring, stream);
}

// kernel Q on a ring of `ring` frames (at least 2): as decode_full_bwd
int decode_full_bwd_ring(const void* scores, int is_f32, int reverse,
                         const void* move_in, const void* choices,
                         const void* c, const void* logz,
                         const void* end_state, void* seq, void* qstr,
                         void* mvout, int N, int T, int S, int ring,
                         float qscale, float qbias, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    const float* f = static_cast<const float*>(scores);
    const bf16* h = static_cast<const bf16*>(scores);
    if (is_f32)
        return reverse
            ? launch_bwd_ring(FullRows<float, true>{f}, scores, move_in,
                              choices, c, logz, end_state, seq, qstr, mvout,
                              N, T, S, ring, qscale, qbias, stream)
            : launch_bwd_ring(FullRows<float, false>{f}, scores, move_in,
                              choices, c, logz, end_state, seq, qstr, mvout,
                              N, T, S, ring, qscale, qbias, stream);
    return reverse
        ? launch_bwd_ring(FullRows<bf16, true>{h}, scores, move_in, choices,
                          c, logz, end_state, seq, qstr, mvout, N, T, S,
                          ring, qscale, qbias, stream)
        : launch_bwd_ring(FullRows<bf16, false>{h}, scores, move_in, choices,
                          c, logz, end_state, seq, qstr, mvout, N, T, S,
                          ring, qscale, qbias, stream);
}

}  // extern "C"
