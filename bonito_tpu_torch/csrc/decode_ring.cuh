// The two passes of the decode for the H100, written once for every layout
// of a frame's scores: kernels B and C (csrc/decode_tcn_ring.cu, the TCN
// route's moves) and M and Q (csrc/decode_full.cu, full scores with a stay
// plane, the reverse strand's read in place among them). They compute the
// earlier kernels' function (csrc/decode_passes.cuh has the math) with the
// same f32 steps, so the same bits on every output, with each frame's row
// staged ahead through a ring in shared memory and one block-wide barrier a
// frame.
//
// What bounds them on an H100: bytes (at hac, N 96, T 1666, S 1024, 0.64 ms
// for B, 0.73 for M), but the recursion over T is serial, so the pace is the
// latency of one frame. The earlier kernels spend 3-4 us a frame: the
// frame's row is loaded from device memory only when the frame starts, four
// barriers of 32 warps a frame, and 4096 or 5120 exps right before the
// reduction. Here, per batch row, one CTA of S/4 consumer threads (four
// states each), a producer warp and an epilogue warp:
//   the ring   the producer's lane 0 copies the rows of frames ahead
//              (cp.async.bulk, one mbarrier `full` a slot counting the
//              bytes) into `ring` slots: the frame's scores, and for the
//              backward pass also its move_in row and choices. The frame
//              barrier is the slot's `empty`: a slot is refilled only after
//              the barrier of the last frame whose threads read it (the
//              plumbing, shared with the loss's U and V: csrc/ring.cuh).
//   one barrier a frame  consumer thread q holds the states of one block of
//              four (B, C, M, Q: states 4q .. 4q+3; the reverse strand's M
//              and Q: states 4 rc(q) + b, below) whose predecessors are the
//              same four states of the previous frame. Each thread writes
//              its raw values (alpha before normalising, amax; beta) and its
//              warp's max (one redux.sync) into buffers of the frame's
//              parity; after the one __syncthreads every thread takes the
//              warps' max itself and reads its inputs as raw * (1 / max),
//              which rounds as the earlier kernel's stored raw * inv does.
//   exps off the chain  the next frame's row is waited for, read and its
//              exps taken in pieces between the steps of this frame's
//              chain, in the same block of code, so they fill its stalls.
//   the epilogue warp  does what one thread did each frame, a frame behind
//              the consumers: the forward pass's log correction c and its
//              stores; the backward pass's posterior mass (each consumer
//              leaves its state's share, the warp sums them in block_sum's
//              tree), qscore and the three output bytes, from the
//              traceback's choice and base that consumer 0 leaves beside
//              the maxes, with c read 32 frames ahead into registers; and at
//              the end logZ and the end state.
//              Neither it nor the producer is on the consumers' chain.
// A layout (TcnRows, FullRows) says where a frame's row comes from and how
// consumer q reads its values from the slot: the TCN moves at stride R
// (column (b*nb + j)*R + q), the full scores' block of the 20 adjacent
// values of states 4q .. 4q+3 (loaded in 8- or 16-byte pieces).
//
// The reverse strand read in place (FullRows<In, true>): frame t is the
// forward frame T-1-t, and with rc(x) the reverse complement of x's base-4
// digits (crf_frames.cuh) the moves into the reverse states 4 rc(q) + b are
// again the 20 values of forward block q, read through the map
// move(b, j) = block[5(3-j) + 1 + 3-b]. So consumer q takes r = rc(q), and
// every per-state array is kept with the states in the forward strand's
// order: reverse state s at rc_sl(s). Then each thread's own states sit at
// (3-b)*R + q and its predecessors j*R + r at 4q + 3-j, the transpose of
// the forward strand's 4q + b and j*R + q: the reads and stores of shared
// memory and of move_in and choices stay in whole warps. The states' sums
// and the end state take the states in their own order.
//
// The sums keep the earlier kernels' order: over j or b in order 0..3, each
// product and sum rounded on its own; a state sum (the backward pass's mass,
// the forward pass's closing logZ) as an xor butterfly over each run of 32
// consecutive states, then over the runs' partials (block_sum's tree: for
// the mass, threads 8k .. 8k+7 hold run k's shares, summed as lanes xor 4,
// 2, 1 in one lane of the epilogue warp). scripts/decode_split.py times the
// kernels with each part left out (DECODE_CUT, 0 in the library).

#pragma once

#include "crf_frames.cuh"
#include "ring.cuh"

#ifndef DECODE_CUT
#define DECODE_CUT 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

// the parts scripts/decode_split.py leaves out
constexpr int CUT_WAITS = 1;    // the ring's copies and waits
constexpr int CUT_EXPS = 2;     // expf(m) taken as m
constexpr int CUT_REDUCE = 4;   // the warp and block maxes, the mass sums
constexpr int CUT_STORES = 8;   // the outputs' stores
constexpr int CUT_TRACE = 16;   // the traceback: the end state throughout

__device__ __forceinline__ constexpr bool cut(int part) {
    return (DECODE_CUT & part) != 0;
}

constexpr int RING_THREADS = 256 + 64;  // S 1024: 8 consumer warps + 2

__host__ __device__ inline int ring_consumers(int S) {
    return (S / NB + 31) / 32 * 32;
}

// shared memory: the mbarriers, the parities' partials ([2][64]: the
// consumer warps' maxes, the traceback word at 8), the end's partials, the
// raw values of two parities (forward: alpha and amax; backward: beta, then
// each consumer's share of the mass), the ring of slots: a frame's row of
// `row` bytes, and for the backward pass its move_in and choices
__host__ __device__ inline size_t ring_head(int ring) {
    return (size_t)(ring * 8 + 15) / 16 * 16 + (2 * 64 + 64) * sizeof(float);
}
__host__ __device__ inline size_t bwd_slot(int S, size_t row) {
    return row + (size_t)5 * S;
}
__host__ __device__ inline size_t fwd_smem(int S, int ring, size_t row) {
    return ring_head(ring) + (size_t)16 * S + ring * row;
}
__host__ __device__ inline size_t bwd_smem(int S, int ring, size_t row) {
    return ring_head(ring) + (size_t)8 * S + (size_t)8 * ring_consumers(S)
        + ring * bwd_slot(S, row);
}

// The raw values are never negative (sums of products of exps and
// non-negative numbers), and a non-negative float orders as its bits do:
// a warp's max is one redux.sync on the bits (0 for an idle thread). Any
// order of a max gives the same bits. (A NaN, which finite moves do not
// give, wins here as in the plain version's amax.)
__device__ __forceinline__ float warp_max(float v) {
    if (cut(CUT_REDUCE)) return v;
    return __uint_as_float(__reduce_max_sync(0xffffffffu, __float_as_uint(v)));
}

// the max of the consumer warps' partials of a parity (at most 8), in
// registers
__device__ __forceinline__ float frame_max(const float* part, int nwc,
                                           int w) {
    if (cut(CUT_REDUCE)) return part[w];
    const float4 a = *reinterpret_cast<const float4*>(part);
    const float4 b = *reinterpret_cast<const float4*>(part + 4);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float m = v[0];
#pragma unroll
    for (int k = 1; k < 8; ++k)
        if (k < nwc) m = fmaxf(m, v[k]);
    return m;
}

// ------------------------------------------------------------ the layouts
// A consumer's values of one frame: mv[b*4 + j] the move into its state b
// from slot j, ex its exp; st[k], pst[k] a stay and its probability (the
// forward pass: of its state b = k; the backward pass: of its predecessor
// j = k). TcnRows keeps no stay: its st and pst return the constants.
struct Vals {
    float mv[16], ex[16], st[4], pst[4];
};

__device__ __forceinline__ float exp_of(float m) {
    return cut(CUT_EXPS) ? m : expf(m);
}

// B and C: [N, T, 4S] moves, each frame's columns in (b, j, r) order
// (TcnFrame's), the stay the constant blank; bf16 (B and C) or f32 (GW's
// and JW's passes over the head product's moves, csrc/head_product.cu)
template <typename In>
struct TcnRows {
    static constexpr bool REV = false;
    const In* moves;
    float blank, p_stay;
    struct Raw {};
    __host__ __device__ static size_t row_bytes(int S) {
        return (size_t)NB * S * sizeof(In);
    }
    __device__ const void* row(size_t row0, int t, int, int S) const {
        return moves + (row0 + t) * NB * S;
    }
    template <bool FWD>
    __device__ void fetch(const unsigned char*, int, int, Raw&) const {}
    // piece K: the moves into state 4q + K from slots j = 0..3, columns
    // (K*nb + j)*R + q
    template <bool FWD, int K>
    __device__ void piece(const unsigned char* slot, int R, int q,
                          const Raw&, Vals& v) const {
        const In* row = reinterpret_cast<const In*>(slot);
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float m = to_f32(row[(K * NB + j) * R + q]);
            if (FWD) v.mv[K * NB + j] = m;
            v.ex[K * NB + j] = exp_of(m);
        }
    }
    __device__ float st(const Vals&, int) const { return blank; }
    __device__ float pst(const Vals&, int) const { return p_stay; }
};

// M and Q: full scores [N, T, 5S] in bf16 or f32; REV: the reverse strand
// read from the forward strand's scores in place
template <typename In, bool Rev>
struct FullRows {
    static constexpr bool REV = Rev;
    const In* scores;
    // the 20 values of the thread's block; the four stays that lie outside
    // it (the forward pass's own stays on the reverse strand, the backward
    // pass's predecessors' on the forward strand)
    struct Raw { float v[20], x[4]; };
    __host__ __device__ static size_t row_bytes(int S) {
        return (size_t)(NB + 1) * S * sizeof(In);
    }
    __device__ const void* row(size_t row0, int t, int T, int S) const {
        return scores + (row0 + (Rev ? T - 1 - t : t)) * (NB + 1) * S;
    }
    template <bool FWD>
    __device__ void fetch(const unsigned char* slot, int R, int q,
                          Raw& raw) const {
        const In* row = reinterpret_cast<const In*>(slot);
        load_block(row + 20 * q, raw.v);
        if (FWD == Rev) {
#pragma unroll
            for (int k = 0; k < NB; ++k)
                raw.x[k] = to_f32(row[((Rev ? NB - 1 - k : k) * R + q)
                                      * (NB + 1)]);
        }
    }
    template <bool FWD, int K>
    __device__ void piece(const unsigned char*, int, int, const Raw& raw,
                          Vals& v) const {
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float m = raw.v[Rev ? (NB - 1 - j) * (NB + 1) + NB - K
                                      : K * (NB + 1) + 1 + j];
            if (FWD) v.mv[K * NB + j] = m;
            v.ex[K * NB + j] = exp_of(m);
        }
        const float s = FWD == Rev ? raw.x[K]
                                   : raw.v[(Rev ? NB - 1 - K : K) * (NB + 1)];
        v.st[K] = s;
        v.pst[K] = exp_of(s);
    }
    __device__ float st(const Vals& v, int k) const { return v.st[k]; }
    __device__ float pst(const Vals& v, int k) const { return v.pst[k]; }

    // 20 adjacent values: five 8-byte (bf16) or 16-byte (f32) loads
    __device__ static void load_block(const bf16* p, float (&v)[20]) {
        const uint2* u = reinterpret_cast<const uint2*>(p);
#pragma unroll
        for (int c = 0; c < 5; ++c) {
            const uint2 w = u[c];
            v[4 * c] = __uint_as_float(w.x << 16);
            v[4 * c + 1] = __uint_as_float(w.x & 0xffff0000u);
            v[4 * c + 2] = __uint_as_float(w.y << 16);
            v[4 * c + 3] = __uint_as_float(w.y & 0xffff0000u);
        }
    }
    __device__ static void load_block(const float* p, float (&v)[20]) {
        const float4* u = reinterpret_cast<const float4*>(p);
#pragma unroll
        for (int c = 0; c < 5; ++c) {
            const float4 w = u[c];
            v[4 * c] = w.x;
            v[4 * c + 1] = w.y;
            v[4 * c + 2] = w.z;
            v[4 * c + 3] = w.w;
        }
    }
};

// Where consumer q's values sit in a per-state array (shared alpha, amax,
// beta, and move_in and choices): its own states b (the forward strand's
// 4q + b; the reverse strand's (3-b)*R + q) and its predecessors j (j*R + q;
// 4q + 3-j). Four adjacent values go as one float4.
template <bool REV>
__device__ __forceinline__ int own_at(int R, int q, int b) {
    return REV ? (NB - 1 - b) * R + q : NB * q + b;
}

template <bool REV, bool OWN>
__device__ __forceinline__ void load4(const float* x, int R, int q,
                                      float (&v)[4]) {
    if (OWN != REV) {  // four adjacent values at 4q
        const float4 a = *reinterpret_cast<const float4*>(x + NB * q);
        const float w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
        for (int k = 0; k < NB; ++k) v[k] = w[REV ? NB - 1 - k : k];
    } else {  // at stride R
#pragma unroll
        for (int k = 0; k < NB; ++k) v[k] = x[(REV ? NB - 1 - k : k) * R + q];
    }
}

template <bool REV, bool OWN>
__device__ __forceinline__ void store4(float* x, int R, int q,
                                       const float (&v)[4]) {
    if (OWN != REV) {
        *reinterpret_cast<float4*>(x + NB * q) =
            REV ? make_float4(v[3], v[2], v[1], v[0])
                : make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
        for (int k = 0; k < NB; ++k) x[(REV ? NB - 1 - k : k) * R + q] = v[k];
    }
}

// the states' base-4 digits below the first (R = 4**digits), for rc
__device__ __forceinline__ int digits_of(int R) {
    return (__ffs(R) - 1) / 2;
}

// --------------------------------------------------------- forward pass
struct FwdArgs {
    float* move_in;
    uint8_t* choices;
    float* cs;
    float* logz;
    int* end_state;
    int T, S, ring;
};

// the registers a consumer carries from frame to frame
struct FwdCarry {
    float acc[4];   // move-in of the frame before, not yet normalised
    float ar[4];    // its raw alpha
    float am[4];    // its amax
};

// frame t of consumer q: the row of t in v; the next frame's row read into
// vn on the way. A thread past the states (q >= R, where S / 4 is no
// multiple of 32) computes thread 0's and stores nothing, so that the frame
// is one block of code with no branch but the wait.
template <class L>
__device__ __forceinline__ void ring_fwd_frame(
    const L& l, const FwdArgs& a, int t, int q, bool active, int lane, int w,
    int nwc, const float* part_p, float* part_c, const float* araw_p,
    float* araw_c, const float* amx_p, float* amx_c,
    const unsigned char* ring, Cursor& cur, uint64_t* full,
    typename L::Raw& raw, const Vals& v, Vals& vn, FwdCarry& k)
{
    constexpr bool REV = L::REV;
    const int S = a.S, R = S / NB;
    const size_t row0 = (size_t)blockIdx.x * a.T;
    const unsigned char* nrow = ring + cur.slot * L::row_bytes(S);
    // the next row's exps in four pieces between the steps of the chain
    if (!cut(CUT_WAITS)) mbar_wait(full + cur.slot, (unsigned)cur.phase);
    l.template fetch<true>(nrow, R, q, raw);
    l.template piece<true, 0>(nrow, R, q, raw, vn);
    const float inv = 1.f / frame_max(part_p, nwc, w);
    l.template piece<true, 1>(nrow, R, q, raw, vn);
    float Ap[4], Mp[4], As[4], Ms[4];
    load4<REV, false>(araw_p, R, q, Ap);
    load4<REV, false>(amx_p, R, q, Mp);
    load4<REV, true>(araw_p, R, q, As);
    load4<REV, true>(amx_p, R, q, Ms);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        Ap[j] = __fmul_rn(Ap[j], inv);
        As[j] = __fmul_rn(As[j], inv);
    }
    if (active && t > 0 && !cut(CUT_STORES)) {
        float mi[4];
#pragma unroll
        for (int b = 0; b < NB; ++b) mi[b] = __fmul_rn(k.acc[b], inv);
        store4<REV, true>(a.move_in + (row0 + t - 1) * S, R, q, mi);
    }
    l.template piece<true, 2>(nrow, R, q, raw, vn);
    uint32_t ch = 0;  // state b's choice in byte b
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        float acc = 0.f, best = 0.f;
        int jbest = 0;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            acc = __fadd_rn(acc, __fmul_rn(v.ex[b * NB + j], Ap[j]));
            const float cand = __fadd_rn(v.mv[b * NB + j], Mp[j]);
            if (j == 0 || cand > best) { best = cand; jbest = j; }
        }
        const float stay_m = __fadd_rn(l.st(v, b), Ms[b]);
        const bool is_move = best > stay_m;
        k.acc[b] = acc;
        k.ar[b] = __fadd_rn(__fmul_rn(l.pst(v, b), As[b]), acc);
        k.am[b] = is_move ? best : stay_m;
        ch |= (is_move ? (uint32_t)(jbest + 1) : 0u) << (8 * b);
    }
    l.template piece<true, 3>(nrow, R, q, raw, vn);
    if (active) {
        store4<REV, true>(araw_c, R, q, k.ar);
        store4<REV, true>(amx_c, R, q, k.am);
        if (!cut(CUT_STORES)) {
            uint8_t* c = a.choices + (row0 + t) * S;
            if (REV) {
#pragma unroll
                for (int b = 0; b < NB; ++b)
                    c[own_at<REV>(R, q, b)] = (uint8_t)(ch >> (8 * b));
            } else {
                *reinterpret_cast<uint32_t*>(c + NB * q) = ch;
            }
        }
    }
    const float lmax = warp_max(active ? fmaxf(fmaxf(k.ar[0], k.ar[1]),
                                               fmaxf(k.ar[2], k.ar[3]))
                                       : 0.f);
    if (lane == 0) part_c[w] = lmax;
    if (t + 2 < a.T) cur.next();
    __syncthreads();
}

template <class L>
__global__ void __launch_bounds__(RING_THREADS, 1)
decode_fwd_ring_kernel(const L l, const FwdArgs a)
{
    extern __shared__ __align__(16) unsigned char ring_smem[];
    const int S = a.S, R = S / NB, NC = ring_consumers(S), nwc = NC / 32;
    const int T = a.T, ring = a.ring;
    const size_t row_bytes = L::row_bytes(S);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
    float* part =
        reinterpret_cast<float*>(ring_smem + (ring * 8 + 15) / 16 * 16);
    float* endp = part + 128;        // [8] maxes at 32, [8] indices at 40
    float* araw = endp + 64;         // [2][S]
    float* amx = araw + 2 * S;       // [2][S]
    unsigned char* rows = reinterpret_cast<unsigned char*>(amx + 2 * S);
    // after the last frame: its alpha, normalised, in the states' order
    float* endv = araw + (T & 1) * S;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const size_t row0 = (size_t)blockIdx.x * T;

    // frame -1 in parity 1: alpha 1, amax 0, read through a max of 1
    for (int i = tid; i < S; i += blockDim.x) {
        araw[S + i] = 1.f;
        amx[S + i] = 0.f;
    }
    if (tid < 32) part[64 + tid] = 1.f;
    if (tid == NC) {
        for (int s = 0; s < ring; ++s) mbar_init(full + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (w == nwc) {
        // --------------------------------------------------- producer warp
        const unsigned bytes = (unsigned)row_bytes;
        int issued = 0;
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                if (!cut(CUT_WAITS))
                    fill(full + s, rows + s * row_bytes, bytes,
                         issued >= ring, l.row(row0, issued, T, S), bytes);
            }
        };
        if (lane == 0) issue(min(ring, T));
        for (int t = 0; t < T; ++t) {
            __syncthreads();
            // the rows of frames up to t + 1 have been read
            if (lane == 0) issue(min(T, t + 2 + ring));
        }
        __syncthreads();
        return;
    }
    if (w == nwc + 1) {
        // --------------------------------------------------- epilogue warp
        float c = 0.f;
        for (int t = 0; t < T; ++t) {
            __syncthreads();  // frame t's maxes are in parity t & 1
            c += logf(frame_max(part + (t & 1) * 64, nwc, 0));
            if (lane == 0 && !cut(CUT_STORES)) a.cs[row0 + t] = c;
        }
        __syncthreads();  // the consumers' end values and partials
        // logZ's sum in block_sum's tree: the butterfly of each run of 32
        // states (run k's in lane k), then of the runs
        float sum = 0.f;
        for (int k = 0; 32 * k < S; ++k) {
            float x = 32 * k + lane < S ? endv[32 * k + lane] : 0.f;
            for (int o = 16; o > 0; o >>= 1)
                x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
            if (lane == k) sum = x;
        }
        for (int o = 16; o > 0; o >>= 1)
            sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, o));
        float v = lane < nwc ? endp[32 + lane] : -INFINITY;
        int idx = lane < nwc ? __float_as_int(endp[40 + lane]) : INT_MAX;
        for (int o = 16; o > 0; o >>= 1) {
            const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
            const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
            if (v2 > v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
        }
        if (lane == 0) {
            a.logz[blockIdx.x] = logf(sum) + c;
            a.end_state[blockIdx.x] = idx;
        }
        return;
    }

    // -------------------------------------------------------- consumers
    const bool active = tid < R;
    const int q = active ? tid : 0;
    // the first of the thread's four states, in the strand's order
    const int s0 = NB * (L::REV ? rc_digits(q, digits_of(R)) : q);
    typename L::Raw raw;
    Vals v0, v1;
    if (!cut(CUT_WAITS)) mbar_wait(full, 0u);
    l.template fetch<true>(rows, R, q, raw);
    l.template piece<true, 0>(rows, R, q, raw, v0);
    l.template piece<true, 1>(rows, R, q, raw, v0);
    l.template piece<true, 2>(rows, R, q, raw, v0);
    l.template piece<true, 3>(rows, R, q, raw, v0);
    // the next frame's slot: frame min(t + 1, T - 1)
    Cursor cur = {0, 0, ring};
    if (T > 1) cur.next();
    FwdCarry k = {};
    int t = 0;
    for (; t + 1 < T; t += 2) {
        ring_fwd_frame(l, a, t, q, active, lane, w, nwc, part + 64, part,
                       araw + S, araw, amx + S, amx, rows, cur, full, raw, v0,
                       v1, k);
        ring_fwd_frame(l, a, t + 1, q, active, lane, w, nwc, part, part + 64,
                       araw, araw + S, amx, amx + S, rows, cur, full, raw, v1,
                       v0, k);
    }
    if (t < T)
        ring_fwd_frame(l, a, t, q, active, lane, w, nwc, part + 64, part,
                       araw + S, araw, amx + S, amx, rows, cur, full, raw, v0,
                       v1, k);

    // the last frame's max: its move-in, and the end (the states' alpha for
    // the epilogue warp's sum in the parity no frame reads again; the first
    // argmax of amax, four states a thread in their order, then the warp's)
    constexpr bool REV = L::REV;
    const float inv = 1.f / frame_max(part + ((T - 1) & 1) * 64, nwc, w);
    float best = -INFINITY;
    int ib = INT_MAX;
    if (active) {
        float mi[4];
#pragma unroll
        for (int b = 0; b < NB; ++b) mi[b] = __fmul_rn(k.acc[b], inv);
        if (!cut(CUT_STORES))
            store4<REV, true>(a.move_in + (row0 + T - 1) * S, R, q, mi);
        *reinterpret_cast<float4*>(endv + s0) =
            make_float4(__fmul_rn(k.ar[0], inv), __fmul_rn(k.ar[1], inv),
                        __fmul_rn(k.ar[2], inv), __fmul_rn(k.ar[3], inv));
        best = k.am[0];
        ib = s0;
#pragma unroll
        for (int b = 1; b < NB; ++b)
            if (k.am[b] > best) { best = k.am[b]; ib = s0 + b; }
    }
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, best, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, ib, o);
        if (v2 > best || (v2 == best && i2 < ib)) { best = v2; ib = i2; }
    }
    if (lane == 0) {
        endp[32 + w] = best;
        endp[40 + w] = __int_as_float(ib);
    }
    __syncthreads();
}

// -------------------------------------------------------- backward pass
struct BwdArgs {
    const float* move_in;
    const uint8_t* choices;
    const float* cs;
    const float* logz;
    const int* end_state;
    uint8_t* seq;
    uint8_t* qstr;
    uint8_t* mvout;
    int T, S, ring;
    float qscale, qbias;
};

// frame i (t = T-1-i) of consumer q, whose traceback state is `state` (the
// reverse strand: its column rc_sl(state)): the row of i in v, its move_in
// and choices in `slot`; the next frame's row read into vn on the way. A
// thread past the states computes thread 0's and stores nothing, as in
// ring_fwd_frame.
template <class L>
__device__ __forceinline__ void ring_bwd_frame(
    const L& l, const BwdArgs& a, int i, int q, bool active, int lane, int w,
    int nwc, const float* part_p, float* part_c, const float* braw_p,
    float* braw_c, float* vb_c, const unsigned char* slot,
    const unsigned char* ring, Cursor& cur, uint64_t* full,
    typename L::Raw& raw, int& state, const Vals& v, Vals& vn)
{
    constexpr bool REV = L::REV;
    const int S = a.S, R = S / NB;
    const size_t row_bytes = L::row_bytes(S);
    const unsigned char* nrow = ring + cur.slot * bwd_slot(S, row_bytes);
    // the next row's exps in two pieces between the steps of the chain
    if (!cut(CUT_WAITS)) mbar_wait(full + cur.slot, (unsigned)cur.phase);
    l.template fetch<false>(nrow, R, q, raw);
    l.template piece<false, 0>(nrow, R, q, raw, vn);
    l.template piece<false, 1>(nrow, R, q, raw, vn);
    const float inv = 1.f / frame_max(part_p, nwc, w);
    float Bs[4];
    load4<REV, true>(braw_p, R, q, Bs);
#pragma unroll
    for (int b = 0; b < NB; ++b) Bs[b] = __fmul_rn(Bs[b], inv);
    // traceback, the same in every thread: the mass of the emitted base's
    // state of this thread (the other three add zeros to the sum)
    const int choice = cut(CUT_TRACE) ? 0 : slot[row_bytes + 4 * S + state];
    const int base = REV ? NB - 1 - state / R : state % NB;
    if (threadIdx.x == 0) part_c[8] = __int_as_float(choice | base << 8);
    const float* mvin = reinterpret_cast<const float*>(slot + row_bytes);
    const float Bb = base == 0 ? Bs[0] : base == 1 ? Bs[1]
                   : base == 2 ? Bs[2] : Bs[3];
    float vv = active ? __fmul_rn(mvin[own_at<REV>(R, q, base)], Bb) : 0.f;
    if (choice != 0)
        state = REV ? state % R * NB + NB - choice
                    : state / NB + (choice - 1) * R;
    if (cut(CUT_WAITS)) state %= S;  // choices of unfilled slots
    l.template piece<false, 2>(nrow, R, q, raw, vn);
    l.template piece<false, 3>(nrow, R, q, raw, vn);
    float Bp[4], br[4];
    load4<REV, false>(braw_p, R, q, Bp);
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < NB; ++b)
            acc = __fadd_rn(acc, __fmul_rn(v.ex[b * NB + j], Bs[b]));
        br[j] = __fadd_rn(__fmul_rn(l.pst(v, j), __fmul_rn(Bp[j], inv)), acc);
    }
    if (active) store4<REV, false>(braw_c, R, q, br);
    const float lmax = warp_max(active ? fmaxf(fmaxf(br[0], br[1]),
                                               fmaxf(br[2], br[3]))
                                       : 0.f);
    vb_c[threadIdx.x] = vv;  // the epilogue warp sums them
    if (lane == 0) part_c[w] = lmax;
    if (i + 2 < a.T) cur.next();
    __syncthreads();
}

template <class L>
__global__ void __launch_bounds__(RING_THREADS, 1)
decode_bwd_ring_kernel(const L l, const BwdArgs a)
{
    extern __shared__ __align__(16) unsigned char ring_smem[];
    const int S = a.S, R = S / NB, NC = ring_consumers(S), nwc = NC / 32;
    const int T = a.T, ring = a.ring;
    const size_t row_bytes = L::row_bytes(S);
    const size_t slot_bytes = bwd_slot(S, row_bytes);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring_smem);
    float* part =
        reinterpret_cast<float*>(ring_smem + (ring * 8 + 15) / 16 * 16);
    float* braw = part + 128 + 64;   // [2][S]
    float* vb = braw + 2 * S;        // [2][NC]: each thread's mass share
    unsigned char* rows = reinterpret_cast<unsigned char*>(vb + 2 * NC);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n = blockIdx.x;
    const size_t row0 = (size_t)n * T;

    // frame T in parity 1: beta 1, read through a max of 1
    for (int i = tid; i < S; i += blockDim.x) braw[S + i] = 1.f;
    if (tid < 32) part[64 + tid] = 1.f;
    if (tid == NC) {
        for (int s = 0; s < ring; ++s) mbar_init(full + s, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (w == nwc) {
        // --------------------------------------------------- producer warp
        int issued = 0;  // frames i = 0, 1, ... (t = T-1-i) in the ring
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring, t = T - 1 - issued;
                const size_t f = row0 + t;
                if (!cut(CUT_WAITS))
                    fill(full + s, rows + s * slot_bytes,
                         (unsigned)slot_bytes, issued >= ring,
                         l.row(row0, t, T, S), (unsigned)row_bytes,
                         a.move_in + f * S, 4u * S, a.choices + f * S,
                         (unsigned)S);
            }
        };
        if (lane == 0) issue(min(ring, T));
        for (int i = 0; i < T; ++i) {
            __syncthreads();
            // frame i's slot has been read
            if (lane == 0) issue(min(T, i + 1 + ring));
        }
        return;
    }
    if (w == nwc + 1) {
        // --------------------------------------------------- epilogue warp
        const float lz = a.logz[n];
        float d = 0.f;
        // the shares of run k = lane: those of states 4r + base, r = 8k ..
        // 8k+7, held by thread r (the reverse strand: rc(r))
        int holder[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            const int r = 8 * lane + e;
            holder[e] = L::REV && r < R ? rc_digits(r, digits_of(R)) : r;
        }
        // c of frames i = 32g + lane, a group ahead
        auto c_of = [&](int g) {
            const int t = T - 1 - (32 * g + lane);
            return t >= 0 ? a.cs[row0 + t] : 0.f;
        };
        float c_now = c_of(0), c_next = c_of(1);
        for (int i = 0; i < T; ++i) {
            const int t = T - 1 - i;
            __syncthreads();  // frame i's partials are in parity i & 1
            const float* pp = part + (i & 1) * 64;
            // the mass: lane k sums run k (states xor 16, 8, 4 of the run
            // are its threads xor 4, 2, 1; xor 2 and 1 add the zeros of the
            // other bases), then the butterfly over the 32 runs' sums
            float bm = 0.f;
            if (lane < NC / 8) {
                const float* vbi = vb + (i & 1) * NC;
                float u[8];
                if (L::REV) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) u[e] = vbi[holder[e]];
                } else {
                    const float4* p = reinterpret_cast<const float4*>(
                        vbi + 8 * lane);
                    const float4 lo = p[0], hi = p[1];
                    u[0] = lo.x; u[1] = lo.y; u[2] = lo.z; u[3] = lo.w;
                    u[4] = hi.x; u[5] = hi.y; u[6] = hi.z; u[7] = hi.w;
                }
                if (cut(CUT_REDUCE)) {
                    bm = u[0];
                } else {
                    bm = __fadd_rn(__fadd_rn(__fadd_rn(u[0], u[4]),
                                             __fadd_rn(u[2], u[6])),
                                   __fadd_rn(__fadd_rn(u[1], u[5]),
                                             __fadd_rn(u[3], u[7])));
                }
            }
            if (!cut(CUT_REDUCE))
                for (int o = 16; o > 0; o >>= 1)
                    bm = __fadd_rn(bm, __shfl_xor_sync(0xffffffffu, bm, o));
            const float mx = frame_max(pp, nwc, 0);
            // the consumers' traceback: frame i's choice and base
            const int trace = __float_as_int(pp[8]);
            const bool is_move = (trace & 255) != 0;
            const int base = (trace >> 8) + 1;
            if ((i & 31) == 0 && i > 0) {
                c_now = c_next;
                c_next = c_of(i / 32 + 1);
            }
            const float c = __shfl_sync(0xffffffffu, c_now, i & 31);
            if (lane == 0) {
                // each product and difference rounded on its own, as the
                // plain version's (a contracted fma(-bm, e, 1) moved a
                // qstring by one step where rint met a half)
                const float prob = __fmul_rn(bm, expf(c + d - lz));
                const float err = fminf(fmaxf(__fsub_rn(1.f, prob), 1e-4f),
                                        1.f);
                const float qv = __fadd_rn(__fmul_rn(-10.f * log10f(err),
                                                     a.qscale), a.qbias);
                const int qc = (int)rintf(qv) + 33;
                if (!cut(CUT_STORES)) {
                    a.seq[row0 + t] = is_move ? (uint8_t)base : (uint8_t)0;
                    a.qstr[row0 + t] = is_move ? (uint8_t)qc : (uint8_t)0;
                    a.mvout[row0 + t] = is_move ? 1 : 0;
                }
            }
            d += logf(mx);
        }
        return;
    }

    // -------------------------------------------------------- consumers
    const bool active = tid < R;
    const int q = active ? tid : 0;
    const int es = a.end_state[n];
    int state = L::REV ? rc_digits(es, digits_of(R) + 1) : es;
    typename L::Raw raw;
    Vals v0, v1;
    if (!cut(CUT_WAITS)) mbar_wait(full, 0u);
    l.template fetch<false>(rows, R, q, raw);
    l.template piece<false, 0>(rows, R, q, raw, v0);
    l.template piece<false, 1>(rows, R, q, raw, v0);
    l.template piece<false, 2>(rows, R, q, raw, v0);
    l.template piece<false, 3>(rows, R, q, raw, v0);
    Cursor cur = {0, 0, ring};
    if (T > 1) cur.next();
    Cursor now = {0, 0, ring};  // this frame's slot
    int i = 0;
    for (; i + 1 < T; i += 2) {
        ring_bwd_frame(l, a, i, q, active, lane, w, nwc, part + 64, part,
                       braw + S, braw, vb, rows + now.slot * slot_bytes, rows,
                       cur, full, raw, state, v0, v1);
        now.next();
        ring_bwd_frame(l, a, i + 1, q, active, lane, w, nwc, part, part + 64,
                       braw, braw + S, vb + NC, rows + now.slot * slot_bytes,
                       rows, cur, full, raw, state, v1, v0);
        now.next();
    }
    if (i < T)
        ring_bwd_frame(l, a, i, q, active, lane, w, nwc, part + 64, part,
                       braw + S, braw, vb, rows + now.slot * slot_bytes, rows,
                       cur, full, raw, state, v0, v1);
}

// the ring's shapes: S a multiple of 16 (a frame's choices, S bytes, are
// copied in 16-byte pieces), at most 1024; a ring of `least` to RING_MAX
bool bad_ring_shape(int N, int T, int S, int ring, int least) {
    return N < 1 || T < 1 || S < 16 || S % 16 != 0 || S > 1024
        || ring < least || ring > RING_MAX;
}

// One launch of each pass over N batch rows, a CTA a row, on a ring of
// `ring` frames (the backward pass: at least 2).
template <class L>
int launch_fwd_ring(const L& l, const void* src, void* move_in,
                    void* choices, void* c, void* logz, void* end_state,
                    int N, int T, int S, int ring, void* stream) {
    if (bad_ring_shape(N, T, S, ring, 1) || !aligned16(src)
        || !aligned16(move_in) || !aligned16(choices))
        return (int)cudaErrorInvalidValue;
    const size_t smem = fwd_smem(S, ring, L::row_bytes(S));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        decode_fwd_ring_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const FwdArgs a = {static_cast<float*>(move_in),
                       static_cast<uint8_t*>(choices), static_cast<float*>(c),
                       static_cast<float*>(logz),
                       static_cast<int*>(end_state), T, S, ring};
    decode_fwd_ring_kernel<L><<<N, ring_consumers(S) + 64, smem,
                                static_cast<cudaStream_t>(stream)>>>(l, a);
    return (int)cudaGetLastError();
}

template <class L>
int launch_bwd_ring(const L& l, const void* src, const void* move_in,
                    const void* choices, const void* c, const void* logz,
                    const void* end_state, void* seq, void* qstr,
                    void* mvout, int N, int T, int S, int ring, float qscale,
                    float qbias, void* stream) {
    if (bad_ring_shape(N, T, S, ring, 2) || !aligned16(src)
        || !aligned16(move_in) || !aligned16(choices))
        return (int)cudaErrorInvalidValue;
    const size_t smem = bwd_smem(S, ring, L::row_bytes(S));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        decode_bwd_ring_kernel<L>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const BwdArgs a = {static_cast<const float*>(move_in),
                       static_cast<const uint8_t*>(choices),
                       static_cast<const float*>(c),
                       static_cast<const float*>(logz),
                       static_cast<const int*>(end_state),
                       static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
                       static_cast<uint8_t*>(mvout), T, S, ring, qscale,
                       qbias};
    decode_bwd_ring_kernel<L><<<N, ring_consumers(S) + 64, smem,
                                static_cast<cudaStream_t>(stream)>>>(l, a);
    return (int)cudaGetLastError();
}

}  // namespace
