// What the CRF kernels share: the alphabet size, the block-wide
// reductions and the layouts of a frame's scores (included by
// decode_passes.cuh, kernels B, C, M, Q, and by logz.cu, kernels U-X).
//
// A Frame says where a frame's scores sit: how many values a frame has
// (width), the score of the move into state s from slot j (the
// predecessor p = j*R + s/nb, R = S/nb, nb = 4), the stay score of state
// s with its probability exp(stay), and for the value at position i of
// the frame's row which state and slot it is (slot: j, or -1 for a stay).
// The kernels copy each frame's row into shared memory as f32 and read it
// through the Frame.
//
// TcnFrame: the [N, T, nb*S] move scores the head matmul writes, each
// frame's columns in (b, j, r) order: column (b*nb + j)*R + r is the move
// into state s = r*nb + b from p = j*R + r; the stay is the constant
// `blank` (p_stay = exp(blank)).
// FullFrame: full scores [N, T, (nb+1)*S]; state s owns the nb+1 adjacent
// columns s*(nb+1) .. s*(nb+1)+nb, the stay first, then the move from
// predecessor p = j*R + s/nb in column s*(nb+1)+1+j.
// RevFullFrame: the reverse strand's full scores read from the forward
// strand's in place (seqdist.reverse_complement, written as indexing). With
// rc_k(x) the reverse of x's k base-4 digits, each complemented (d -> 3-d),
// and S = 4**sl: the reverse strand's frame t is the forward frame T-1-t,
// its stay of state s the forward column rc_sl(s)*(nb+1), its move into s
// from slot j the column (rc_{sl-1}(s/nb)*nb + 3-j)*(nb+1) + 1 + 3 - s%nb.
// Its move_in and choices are stored with the states in the forward
// strand's order: reverse state s in column rc_sl(s) (out_of), where the
// ring kernels (decode_ring.cuh) store them in whole warps.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int NB = 4;

__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
    return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }

// Block-wide reductions over blockDim.x (a multiple of 32). Every thread
// returns the same bits: the xor butterfly pairs equal values, and every
// warp reduces the per-warp partials in the same order. The leading
// barrier keeps `red` from being overwritten while a warp still reads it
// from the previous call.
__device__ float block_max(float v, float* red) {
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    __syncthreads();
    if (l == 0) red[w] = v;
    __syncthreads();
    v = l < nw ? red[l] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1)
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    return v;
}

__device__ void block_sum_max(float& sum, float& mx, float* red) {
    for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    __syncthreads();
    if (l == 0) {
        red[w] = sum;
        red[32 + w] = mx;
    }
    __syncthreads();
    sum = l < nw ? red[l] : 0.f;
    mx = l < nw ? red[32 + l] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
}

// first index of the maximum on ties
__device__ void block_argmax(float& v, int& i, float* redv, int* redi) {
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
        if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
    }
    const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
    const int nw = blockDim.x >> 5;
    __syncthreads();
    if (l == 0) { redv[w] = v; redi[w] = i; }
    __syncthreads();
    v = l < nw ? redv[l] : -INFINITY;
    i = l < nw ? redi[l] : INT_MAX;
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
        if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
    }
}

// the reverse complement of the `digits` base-4 digits of x: the digits in
// reverse order, each d taken as 3 - d
__host__ __device__ __forceinline__ int rc_digits(int x, int digits) {
    int y = 0;
    for (int k = 0; k < digits; ++k) {
        y = y * NB + (NB - 1 - x % NB);
        x /= NB;
    }
    return y;
}

struct TcnFrame {
    float blank, p_stay;
    __host__ __device__ int width(int S) const { return NB * S; }
    __device__ float move(const float* row, int S, int s, int j) const {
        return row[((s % NB) * NB + j) * (S / NB) + s / NB];
    }
    __device__ float stay(const float*, int) const { return blank; }
    __device__ float stay_prob(const float*, int) const { return p_stay; }
    __device__ void slot(int i, int S, int& s, int& j) const {
        const int R = S / NB;
        j = (i / R) % NB;
        s = (i % R) * NB + i / (NB * R);
    }
};

struct FullFrame {
    __host__ __device__ int width(int S) const { return (NB + 1) * S; }
    __device__ float move(const float* row, int, int s, int j) const {
        return row[s * (NB + 1) + 1 + j];
    }
    __device__ float stay(const float* row, int s) const {
        return row[s * (NB + 1)];
    }
    __device__ float stay_prob(const float* row, int s) const {
        return expf(stay(row, s));
    }
    __device__ void slot(int i, int, int& s, int& j) const {
        s = i / (NB + 1);
        j = i % (NB + 1) - 1;
    }
};

struct RevFullFrame {
    int digits;  // state_len: S = 4**digits
    __host__ __device__ int width(int S) const { return (NB + 1) * S; }
    __device__ float move(const float* row, int, int s, int j) const {
        const int p = rc_digits(s / NB, digits - 1) * NB + NB - 1 - j;
        return row[p * (NB + 1) + NB - s % NB];
    }
    __device__ float stay(const float* row, int s) const {
        return row[rc_digits(s, digits) * (NB + 1)];
    }
    __device__ float stay_prob(const float* row, int s) const {
        return expf(stay(row, s));
    }
};

// Where a pass reads frame t's row (the frame of the scores) and stores
// state s's move_in and choice (the column): t and s but for the reverse
// strand read in place.
template <class Frame>
__device__ __forceinline__ int frame_of(const Frame&, int t, int) {
    return t;
}
__device__ __forceinline__ int frame_of(const RevFullFrame&, int t, int T) {
    return T - 1 - t;
}
template <class Frame>
__device__ __forceinline__ int out_of(const Frame&, int s) { return s; }
__device__ __forceinline__ int out_of(const RevFullFrame& f, int s) {
    return rc_digits(s, f.digits);
}

}  // namespace
