// Kernels B and C: the two-pass Viterbi + posterior CRF decode over the
// TCN move layout with a constant stay score.
//
// Replace bonito_tpu/ops/decode_pallas.py:viterbi_decode_tcn — B is
// `_fwd_kernel_tcn` (forward pass), C is `_bwd_kernel_tcn` (backward pass)
// together with that function's qscore epilogue. The passes themselves,
// their math, what bounds them and the design are in decode_passes.cuh.
//
// Layout. Move scores are read as [N, T, nb*S] with the columns of each
// frame in (b, j, r) order: column (b*nb + j)*R + r is the move into state
// s = r*nb + b from predecessor p = j*R + r (R = S/nb, nb = 4). That is
// the memory of the [N, T, Cm] head matmul output; ops/decode.py hands
// bonito_tpu's [T, Cm, N] contract to these kernels as a permuted view of
// it, so no transpose is paid. The stay score is the constant `blank`
// (P_stay = exp(blank)). At hac (N=96, T=1666, S=1024) both read the 1.31
// GB bf16 move tensor; B writes 0.66 GB of f32 move-in and 0.16 GB of
// choices, C reads a quarter of the move-in back (the chosen base's
// states). An f32 model's moves take the _f32 instances (where the ring of
// decode_tcn_ring.cu takes no plan: S 4).

#include "decode_passes.cuh"

namespace {

bool bad_shape(int N, int T, int S) {
    return N < 1 || T < 1 || S < NB || S % NB != 0 || S > 1024;
}

}  // namespace

extern "C" {

// moves [N, T, NB*S] bf16 -> move_in [N, T, S] f32, choices [N, T, S]
// uint8, c [N, T] f32, logz [N] f32, end_state [N] int32
int decode_tcn_fwd_bf16(const void* moves, void* move_in, void* choices,
                        void* c, void* logz, void* end_state, int N, int T,
                        int S, float p_stay, float blank, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    return launch_fwd<TcnFrame, __nv_bfloat16>(
        moves, move_in, choices, c, logz, end_state, N, T, S,
        TcnFrame{blank, p_stay}, stream);
}

// the forward's outputs -> sequence, qstring, moves_out, each [N, T] uint8
int decode_tcn_bwd_bf16(const void* moves, const void* move_in,
                        const void* choices, const void* c, const void* logz,
                        const void* end_state, void* seq, void* qstr,
                        void* mvout, int N, int T, int S, float p_stay,
                        float qscale, float qbias, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    return launch_bwd<TcnFrame, __nv_bfloat16>(
        moves, move_in, choices, c, logz, end_state, seq, qstr, mvout, N, T,
        S, qscale, qbias, TcnFrame{0.f, p_stay}, stream);
}

// the same two passes on f32 moves [N, T, NB*S] (an f32 model's TCN
// decode where the ring takes no plan: S not a multiple of 16)
int decode_tcn_fwd_f32(const void* moves, void* move_in, void* choices,
                       void* c, void* logz, void* end_state, int N, int T,
                       int S, float p_stay, float blank, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    return launch_fwd<TcnFrame, float>(
        moves, move_in, choices, c, logz, end_state, N, T, S,
        TcnFrame{blank, p_stay}, stream);
}

int decode_tcn_bwd_f32(const void* moves, const void* move_in,
                       const void* choices, const void* c, const void* logz,
                       const void* end_state, void* seq, void* qstr,
                       void* mvout, int N, int T, int S, float p_stay,
                       float qscale, float qbias, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    return launch_bwd<TcnFrame, float>(
        moves, move_in, choices, c, logz, end_state, seq, qstr, mvout, N, T,
        S, qscale, qbias, TcnFrame{0.f, p_stay}, stream);
}

}  // extern "C"
