// Kernels M and Q: the two-pass Viterbi + posterior CRF decode from full
// score tensors, whose stay scores are a plane of their own.
//
// Replace bonito_tpu/ops/decode_pallas.py:viterbi_decode_pallas — M is
// `_fwd_kernel` (forward pass), Q is `_bwd_kernel` (backward pass)
// together with that function's qscore epilogue. The passes are B's and
// C's (decode_passes.cuh has the math, what bounds them and the design);
// only the frame's layout differs.
//
// Layout. Scores are read as [N, T, S*(nb+1)] in bf16 or f32, the memory
// the CRF head writes (and seqdist.reverse_complement returns): state s
// owns the nb+1 adjacent columns s*(nb+1) .. s*(nb+1)+nb, the stay first,
// then the move from predecessor p = j*R + s/nb in column s*(nb+1)+1+j.
// The TPU version splits this tensor with XLA transposes into a stay plane
// and a (b, j, r)-ordered move block before its kernels; here a block
// copies each frame's row as it lies and every thread reads its state's
// five values. At hac (N=96, T=1666, S=1024, bf16) both passes read the
// 1.64 GB score tensor; M writes 0.66 GB of f32 move-in and 0.16 GB of
// choices, Q reads a quarter of the move-in back.

#include "decode_passes.cuh"

namespace {

// S = 4**state_len, 4 to 1024 states (a thread each)
bool bad_shape(int N, int T, int S) {
    return N < 1 || T < 1 || S < NB || S > 1024 || (S & (S - 1)) != 0
        || (S & 0x55555555) == 0;
}

}  // namespace

extern "C" {

// scores [N, T, (NB+1)*S] (bf16, or f32 when is_f32) -> move_in [N, T, S]
// f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32, end_state [N]
// int32
int decode_full_fwd(const void* scores, int is_f32, void* move_in,
                    void* choices, void* c, void* logz, void* end_state,
                    int N, int T, int S, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    auto launch = is_f32 ? launch_fwd<FullFrame, float>
                         : launch_fwd<FullFrame, __nv_bfloat16>;
    return launch(scores, move_in, choices, c, logz, end_state, N, T, S,
                  FullFrame{}, stream);
}

// the forward's outputs -> sequence, qstring, moves_out, each [N, T] uint8
int decode_full_bwd(const void* scores, int is_f32, const void* move_in,
                    const void* choices, const void* c, const void* logz,
                    const void* end_state, void* seq, void* qstr,
                    void* mvout, int N, int T, int S, float qscale,
                    float qbias, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    auto launch = is_f32 ? launch_bwd<FullFrame, float>
                         : launch_bwd<FullFrame, __nv_bfloat16>;
    return launch(scores, move_in, choices, c, logz, end_state, seq, qstr,
                  mvout, N, T, S, qscale, qbias, FullFrame{}, stream);
}

}  // extern "C"
