// The two passes of the Viterbi + posterior CRF decode, written once for
// every layout of a frame's scores (included by decode_tcn.cu, kernels B
// and C, decode_full.cu, kernels M and Q, and decode_tcn_fused_wide.cu,
// kernels GW and JW).
//
// A Frame (crf_frames.cuh, with the block-wide reductions) says where a
// frame's scores sit; the kernels hold each frame's row in shared memory
// as f32 and read it through the Frame. The reverse strand read in place
// (RevFullFrame) also takes its rows in reverse order and keeps move_in and
// choices in the forward strand's order of states (frame_of, out_of). fwd_frame and bwd_frame are one
// frame of each pass: B, C, M and Q copy the row from device memory, GW
// and JW compute it from the head.
//
// Forward, per batch row n and frame t (alpha in probability space,
// renormalised by its max with a log correction c; the max semiring in log
// space):
//     move_in[s] = sum_j exp(move(s, j)) * A[j*R + s/nb]
//     A <- (exp(stay[s])*A + move_in) / max,  c += log(max)
//     cand_j = move(s, j) + amax[j*R + s/nb]; jbest = first j of the max;
//     the move wins only if strictly greater than stay[s] + amax[s]
// storing move_in/max (f32), c and the choice (uint8: 0 stay, j+1 move).
// After T frames: logZ = log(sum A) + c, end_state = first argmax amax.
//
// Backward, t = T-1 .. 0, with beta B (init 1), its log correction d and
// the traceback state (one integer per row — no one-hot on the GPU):
//     choice = choices[t, state]; base = state % nb + 1;
//     prob = sum_r move_in[t, r*nb+base-1] * B[r*nb+base-1]
//            * exp(c_t + d - logZ)
//     B[p=j*R+r] <- (exp(stay[p])*B[p] + sum_b exp(move(r*nb+b, j))
//                    * B[r*nb+b]) / max
//     q = rint(-10*log10(clip(1-prob, 1e-4, 1))*qscale + qbias) + 33
// and writes sequence, qstring and moves per frame.
//
// Every product and sum is rounded on its own (__fmul_rn/__fadd_rn: no FMA
// contraction), the sums over j or b run in order 0..nb-1 and the block
// sums in the butterfly order below: the f32 steps of the plain versions
// (ops/decode_cuda.py). The log corrections c and d grow to thousands over
// a chunk (|logZ| about 7000 at hac), where one f32 step is 5e-4, and the
// posterior's exp(c + d - logZ) cancels them: any difference in how they
// were summed shows up in the qualities of confident frames (at q 40 a
// relative error of 5e-4 in prob is 8 phred steps). With the same steps,
// kernel and plain version give the same bits.
//
// What bounds them on an H100: bytes (the score tensor is read by both
// passes, move_in written by one and a quarter of it read by the other),
// well under a millisecond at hac shapes at 3.35 TB/s. The recursion over
// T is serial, so the design is latency-bound instead: one block per batch
// row, one thread per state, alpha/beta and the frame's row in shared
// memory, one block-wide max (and for the backward a sum) per frame.

#pragma once

#include "crf_frames.cuh"

namespace {

template <typename In>
__device__ void load_row(const In* __restrict__ src, float* dst, int n) {
    for (int i = threadIdx.x; i < n; i += blockDim.x)
        dst[i] = to_f32(src[i]);
}

// One frame of the forward pass, for thread s of a block whose first S
// threads hold a state each (the rest idle): `row` is the frame's scores
// in shared memory, read through the Frame; alpha A and the max-semiring
// amax ([S] each, shared) are updated in place, every read of them
// preceding the barriers of the block max; c is the running log
// correction. Writes state s's move-in and choice of the frame and, from
// thread 0, its c.
template <class Frame>
__device__ __forceinline__ void fwd_frame(const Frame& f, const float* row,
                                          int S, float* A, float* amax,
                                          float& c, float* red,
                                          float* __restrict__ move_in,
                                          uint8_t* __restrict__ choices,
                                          float* __restrict__ cs) {
    const int s = threadIdx.x, R = S / NB, r = s / NB;
    const bool active = s < S;
    float acc = 0.f, a_raw = -INFINITY, best = 0.f, stay_m = 0.f;
    int jbest = 0;
    if (active) {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float m = f.move(row, S, s, j);
            const int p = j * R + r;
            acc = __fadd_rn(acc, __fmul_rn(expf(m), A[p]));
            const float cand = m + amax[p];
            if (j == 0 || cand > best) { best = cand; jbest = j; }
        }
        a_raw = __fadd_rn(__fmul_rn(f.stay_prob(row, s), A[s]), acc);
        stay_m = f.stay(row, s) + amax[s];
    }
    const float mx = block_max(a_raw, red);
    const float inv = 1.f / mx;
    c += logf(mx);
    if (active) {
        const bool is_move = best > stay_m;
        A[s] = a_raw * inv;
        amax[s] = is_move ? best : stay_m;
        move_in[out_of(f, s)] = acc * inv;
        choices[out_of(f, s)] = is_move ? (uint8_t)(jbest + 1) : (uint8_t)0;
    }
    if (threadIdx.x == 0) *cs = c;
}

// After the last frame: logZ = log(sum A) + c and the first argmax of
// amax, written by thread 0.
__device__ __forceinline__ void fwd_end(const float* A, const float* amax,
                                        int S, float c, float* red,
                                        int* redi, float* __restrict__ logz,
                                        int* __restrict__ end_state) {
    const int s = threadIdx.x;
    const bool active = s < S;
    float sum = active ? A[s] : 0.f, unused = -INFINITY;
    block_sum_max(sum, unused, red);
    float v = active ? amax[s] : -INFINITY;
    int idx = active ? s : INT_MAX;
    block_argmax(v, idx, red, redi);
    if (threadIdx.x == 0) {
        *logz = logf(sum) + c;
        *end_state = idx;
    }
}

// One frame of the backward pass (frames in reverse order), for thread s
// as predecessor p = j*R + r: `row` as for fwd_frame; beta B ([S], shared)
// updated in place; d its running log correction; `state` the traceback
// state, the same in every thread. move_in, choices and c point at the
// frame's own [S], [S] and scalar; seq, qstr and mvout at its outputs,
// which thread 0 writes.
template <class Frame>
__device__ __forceinline__ void bwd_frame(const Frame& f, const float* row,
                                          int S, float* B, float& d,
                                          int& state, float lz, float* red,
                                          const float* __restrict__ move_in,
                                          const uint8_t* __restrict__ choices,
                                          const float* __restrict__ cs,
                                          float qscale, float qbias,
                                          uint8_t* __restrict__ seq,
                                          uint8_t* __restrict__ qstr,
                                          uint8_t* __restrict__ mvout) {
    const int s = threadIdx.x, R = S / NB;
    const bool active = s < S;
    const int j = s / R, r = s % R;
    // traceback: uniform across the block
    const int choice = choices[out_of(f, state)];
    const bool is_move = choice != 0;
    const int base = state % NB + 1;
    const int prev = is_move ? state / NB + (choice - 1) * R : state;

    float v = 0.f, b_raw = -INFINITY;
    if (active) {
        if (s % NB == base - 1) v = move_in[out_of(f, s)] * B[s];
        float acc = 0.f;
#pragma unroll
        for (int bb = 0; bb < NB; ++bb)
            acc = __fadd_rn(acc, __fmul_rn(expf(f.move(row, S, r * NB + bb, j)),
                                           B[r * NB + bb]));
        b_raw = __fadd_rn(__fmul_rn(f.stay_prob(row, s), B[s]), acc);
    }
    float bmass = v, mx = b_raw;
    block_sum_max(bmass, mx, red);
    if (active) B[s] = b_raw * (1.f / mx);
    if (threadIdx.x == 0) {
        // rounded on their own, as the plain version's and the ring's
        const float prob = __fmul_rn(bmass, expf(*cs + d - lz));
        const float err = fminf(fmaxf(__fsub_rn(1.f, prob), 1e-4f), 1.f);
        const float q = __fadd_rn(__fmul_rn(-10.f * log10f(err), qscale),
                                  qbias);
        const int qc = (int)rintf(q) + 33;
        *seq = is_move ? (uint8_t)base : (uint8_t)0;
        *qstr = is_move ? (uint8_t)qc : (uint8_t)0;
        *mvout = is_move ? 1 : 0;
    }
    d += logf(mx);
    state = prev;
}

template <class Frame, typename In>
__global__ void decode_fwd(const In* __restrict__ scores,  // [N, T, width]
                           float* __restrict__ move_in,    // [N, T, S]
                           uint8_t* __restrict__ choices,  // [N, T, S]
                           float* __restrict__ cs,         // [N, T]
                           float* __restrict__ logz,       // [N]
                           int* __restrict__ end_state,    // [N]
                           int T, int S, Frame f)
{
    extern __shared__ float smem[];
    __shared__ float red[64];
    __shared__ int redi[32];
    const int W = f.width(S);
    float* row = smem;         // [W] this frame's scores
    float* A = row + W;        // [S] alpha (probability space)
    float* amax = A + S;       // [S] max-semiring alpha
    const int n = blockIdx.x;
    const int s = threadIdx.x;

    if (s < S) { A[s] = 1.f; amax[s] = 0.f; }
    float c = 0.f;
    const In* srow = scores + (size_t)n * T * W;
    for (int t = 0; t < T; ++t) {
        __syncthreads();  // last frame's A/amax visible; row free
        load_row(srow + (size_t)frame_of(f, t, T) * W, row, W);
        __syncthreads();
        const size_t frame = (size_t)n * T + t;
        fwd_frame(f, row, S, A, amax, c, red, move_in + frame * S,
                  choices + frame * S, cs + frame);
    }
    fwd_end(A, amax, S, c, red, redi, logz + n, end_state + n);
}

template <class Frame, typename In>
__global__ void decode_bwd(const In* __restrict__ scores,      // [N, T, width]
                           const float* __restrict__ move_in,  // [N, T, S]
                           const uint8_t* __restrict__ choices,
                           const float* __restrict__ cs,       // [N, T]
                           const float* __restrict__ logz,     // [N]
                           const int* __restrict__ end_state,  // [N]
                           uint8_t* __restrict__ seq,          // [N, T]
                           uint8_t* __restrict__ qstr,         // [N, T]
                           uint8_t* __restrict__ mvout,        // [N, T]
                           int T, int S, float qscale, float qbias, Frame f)
{
    extern __shared__ float smem[];
    __shared__ float red[64];
    const int W = f.width(S);
    float* row = smem;         // [W]
    float* B = row + W;        // [S] beta (probability space)
    const int n = blockIdx.x;

    if (threadIdx.x < S) B[threadIdx.x] = 1.f;
    float d = 0.f;
    int state = end_state[n];
    const float lz = logz[n];
    const In* srow = scores + (size_t)n * T * W;
    for (int t = T - 1; t >= 0; --t) {
        __syncthreads();
        load_row(srow + (size_t)frame_of(f, t, T) * W, row, W);
        __syncthreads();
        const size_t frame = (size_t)n * T + t;
        bwd_frame(f, row, S, B, d, state, lz, red, move_in + frame * S,
                  choices + frame * S, cs + frame, qscale, qbias,
                  seq + frame, qstr + frame, mvout + frame);
    }
}

inline int threads_for(int S) { return ((S + 31) / 32) * 32; }

// One launch of each pass over N batch rows: one block per row.
template <class Frame, typename In>
int launch_fwd(const void* scores, void* move_in, void* choices, void* c,
               void* logz, void* end_state, int N, int T, int S, Frame f,
               void* stream) {
    const size_t smem = (size_t)(f.width(S) + 2 * S) * sizeof(float);
    decode_fwd<Frame, In><<<N, threads_for(S), smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const In*>(scores), static_cast<float*>(move_in),
        static_cast<uint8_t*>(choices), static_cast<float*>(c),
        static_cast<float*>(logz), static_cast<int*>(end_state), T, S, f);
    return (int)cudaGetLastError();
}

template <class Frame, typename In>
int launch_bwd(const void* scores, const void* move_in, const void* choices,
               const void* c, const void* logz, const void* end_state,
               void* seq, void* qstr, void* mvout, int N, int T, int S,
               float qscale, float qbias, Frame f, void* stream) {
    const size_t smem = (size_t)(f.width(S) + S) * sizeof(float);
    decode_bwd<Frame, In><<<N, threads_for(S), smem,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const In*>(scores), static_cast<const float*>(move_in),
        static_cast<const uint8_t*>(choices), static_cast<const float*>(c),
        static_cast<const float*>(logz), static_cast<const int*>(end_state),
        static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
        static_cast<uint8_t*>(mvout), T, S, qscale, qbias, f);
    return (int)cudaGetLastError();
}

}  // namespace
