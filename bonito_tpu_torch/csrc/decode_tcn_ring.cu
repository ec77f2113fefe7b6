// Kernels B and C for the H100: the two passes of the TCN decode of
// csrc/decode_tcn.cu -- the same function, with the same f32 steps, so the
// same bits on every output -- on the ring of csrc/decode_ring.cuh, which
// has the design: each frame's row staged ahead through a ring in shared
// memory, one block-wide barrier a frame.
//
// B replaces bonito_tpu/ops/decode_pallas.py `_fwd_kernel_tcn`, C
// `_bwd_kernel_tcn` with the qscore epilogue of `viterbi_decode_tcn`. The
// math, the layout of the moves and what the passes compute are in
// csrc/decode_passes.cuh and csrc/decode_tcn.cu; those earlier kernels stay
// (ops/decode_cuda.py launches them where decode_plan gives no plan, and
// chip_smoke.py holds these against them).
//
// The layout (TcnRows): a frame's row is its [4S] bf16 moves, 8S bytes a
// slot (C's slot: moves, move_in, choices, 13S); consumer r reads the moves
// into its states 4r .. 4r+3 at stride R (column (b*nb + j)*R + r), the
// stay is the constant blank. scripts/decode_split.py times the kernels
// with each part left out (DECODE_CUT, 0 in the library).
//
// The f32 instances (TcnRows<float>: 16S bytes a slot, 21S for the
// backward pass) are B and C on an f32 model's moves (a --no-amp
// validation) and the passes of kernels GW and JW, the fused-head decode
// at 512 and 1024 states, over the f32 moves of the head product
// (csrc/head_product.cu). Their frame steps are the f32 steps of
// csrc/decode_passes.cuh that the earlier GW and JW took
// (csrc/decode_tcn_fused_wide.cu), on the same f32 moves: the same bits.

#include "decode_ring.cuh"

extern "C" {

// kernel B on a ring of `ring` frames: as decode_tcn_fwd_bf16
int decode_tcn_fwd_ring(const void* moves, void* move_in, void* choices,
                        void* c, void* logz, void* end_state, int N, int T,
                        int S, int ring, float p_stay, float blank,
                        void* stream) {
    const TcnRows<bf16> l = {static_cast<const bf16*>(moves), blank, p_stay};
    return launch_fwd_ring(l, moves, move_in, choices, c, logz, end_state, N,
                           T, S, ring, stream);
}

// kernel C on a ring of `ring` frames (at least 2): as decode_tcn_bwd_bf16
int decode_tcn_bwd_ring(const void* moves, const void* move_in,
                        const void* choices, const void* c, const void* logz,
                        const void* end_state, void* seq, void* qstr,
                        void* mvout, int N, int T, int S, int ring,
                        float p_stay, float qscale, float qbias,
                        void* stream) {
    const TcnRows<bf16> l = {static_cast<const bf16*>(moves), 0.f, p_stay};
    return launch_bwd_ring(l, moves, move_in, choices, c, logz, end_state,
                           seq, qstr, mvout, N, T, S, ring, qscale, qbias,
                           stream);
}

// kernel GW's forward pass: as decode_tcn_fwd_ring on f32 moves [N, T, 4S]
int decode_tcn_fwd_ring_f32(const void* moves, void* move_in, void* choices,
                            void* c, void* logz, void* end_state, int N,
                            int T, int S, int ring, float p_stay, float blank,
                            void* stream) {
    const TcnRows<float> l = {static_cast<const float*>(moves), blank,
                              p_stay};
    return launch_fwd_ring(l, moves, move_in, choices, c, logz, end_state, N,
                           T, S, ring, stream);
}

// kernel JW: as decode_tcn_bwd_ring on f32 moves [N, T, 4S]
int decode_tcn_bwd_ring_f32(const void* moves, const void* move_in,
                            const void* choices, const void* c,
                            const void* logz, const void* end_state,
                            void* seq, void* qstr, void* mvout, int N, int T,
                            int S, int ring, float p_stay, float qscale,
                            float qbias, void* stream) {
    const TcnRows<float> l = {static_cast<const float*>(moves), 0.f, p_stay};
    return launch_bwd_ring(l, moves, move_in, choices, c, logz, end_state,
                           seq, qstr, mvout, N, T, S, ring, qscale, qbias,
                           stream);
}

}  // extern "C"
