// Kernels B and C for the H100: the two passes of the TCN decode of
// csrc/decode_tcn.cu -- the same function, with the same f32 steps, so the
// same bits on every output -- with each frame's row staged ahead through a
// ring in shared memory and one block-wide barrier a frame.
//
// B replaces bonito_tpu/ops/decode_pallas.py `_fwd_kernel_tcn`, C
// `_bwd_kernel_tcn` with the qscore epilogue of `viterbi_decode_tcn`. The
// math, the layout of the moves and what the passes compute are in
// csrc/decode_passes.cuh and csrc/decode_tcn.cu; those earlier kernels stay
// (ops/decode_cuda.py launches them where decode_plan gives no plan, and
// chip_smoke.py holds these against them).
//
// What bounds them on an H100: bytes (at hac, N 96, T 1666, S 1024, 0.64 ms
// for B, 0.44 for C), but the recursion over T is serial, so the pace is the
// latency of one frame. The earlier kernels spend about 3 us a frame: the
// frame's 8 KB row is loaded from device memory only when the frame starts,
// four barriers of 32 warps a frame, and 4096 exps right before the
// reduction. Here, per batch row, one CTA of S/4 consumer threads (four
// states each), a producer warp and an epilogue warp:
//   the ring   the producer's lane 0 copies the rows of frames ahead
//              (cp.async.bulk, one mbarrier `full` a slot counting the
//              bytes) into `ring` slots: the bf16 moves, and for C also the
//              frame's move_in row and choices. The frame barrier is the
//              slot's `empty`: a slot is refilled only after the barrier of
//              the last frame whose threads read it.
//   one barrier a frame  consumer thread r holds states 4r .. 4r+3 (B) or
//              predecessors j*R + r (C), whose inputs are the same four
//              values of the previous frame. Each thread writes its raw
//              values (alpha before normalising, amax; beta) and its warp's
//              max (one redux.sync) into buffers of the frame's parity;
//              after the one __syncthreads every thread takes the warps'
//              max itself and reads its inputs as raw * (1 / max), which
//              rounds as the earlier kernel's stored raw * inv does.
//   exps off the chain  the next frame's row is waited for, read and its
//              exps taken in pieces between the steps of this frame's
//              chain, in the same block of code, so they fill its stalls.
//   the epilogue warp  does what one thread did each frame, a frame behind
//              the consumers: B's log correction c and its stores; C's
//              posterior mass (each consumer leaves its state's share, the
//              warp sums them in block_sum's tree), qscore and the three
//              output bytes, from the traceback's choice and state that
//              consumer 0 leaves beside the maxes, with c read 32 frames
//              ahead into registers.
//              Neither it nor the producer is on the consumers' chain (one
//              warp doing both was, in C: its per-frame work outlasted the
//              consumers').
//   stores     move_in a float4 and choices one 32-bit word a thread, a
//              warp's in one 512- or 128-byte run.
// The sums keep the earlier kernels' order: over j or b in order 0..3, each
// product and sum rounded on its own; a state sum (C's mass, B's closing
// logZ) as an xor butterfly over each run of 32 consecutive states (eight
// threads here: lanes xor 4, 2, 1, then the thread's own four, b xor 2 and
// 1; for C's mass the same levels over eight threads' shares in one lane of
// the epilogue warp), then over the runs' partials. scripts/decode_split.py times the
// kernels with each part left out (DECODE_CUT, 0 in the library).

#include "crf_frames.cuh"
#include "lstm_persistent.cuh"

#ifndef DECODE_CUT
#define DECODE_CUT 0
#endif

namespace {

typedef __nv_bfloat16 bf16;

// the parts scripts/decode_split.py leaves out
constexpr int CUT_WAITS = 1;    // the ring's copies and waits
constexpr int CUT_EXPS = 2;     // expf(m) taken as m
constexpr int CUT_REDUCE = 4;   // the warp and block maxes, C's mass sums
constexpr int CUT_STORES = 8;   // the outputs' stores
constexpr int CUT_TRACE = 16;   // C's traceback: the end state throughout

__device__ __forceinline__ constexpr bool cut(int part) {
    return (DECODE_CUT & part) != 0;
}

constexpr int RING_MAX = 16;
constexpr int RING_THREADS = 256 + 64;  // S 1024: 8 consumer warps + 2

__host__ __device__ inline int ring_consumers(int S) {
    return (S / NB + 31) / 32 * 32;
}

// shared memory: the mbarriers, the parities' partials ([2][64]: the
// consumer warps' maxes, C's traceback word at 8), the end's partials (B),
// the raw values of two parities (B: alpha and amax; C: beta, then each
// consumer's share of the mass), the ring
__host__ __device__ inline size_t ring_head(int ring) {
    return (size_t)(ring * 8 + 15) / 16 * 16 + (2 * 64 + 64) * sizeof(float);
}
__host__ __device__ inline size_t fwd_slot(int S) { return (size_t)8 * S; }
__host__ __device__ inline size_t bwd_slot(int S) { return (size_t)13 * S; }
__host__ __device__ inline size_t fwd_smem(int S, int ring) {
    return ring_head(ring) + (size_t)16 * S + ring * fwd_slot(S);
}
__host__ __device__ inline size_t bwd_smem(int S, int ring) {
    return ring_head(ring) + (size_t)8 * S + (size_t)8 * ring_consumers(S)
        + ring * bwd_slot(S);
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

// one frame's row of moves ([4S] bf16 from the ring), as consumer r reads
// it: mv[b*4 + j] is the move into state 4r + b from slot j, ex its exp
template <bool RAW, int K0 = 0, int K1 = 16>
__device__ __forceinline__ void read_row(const bf16* row, int R, int r,
                                         float (&mv)[16], float (&ex)[16]) {
#pragma unroll
    for (int k = K0; k < K1; ++k) {
        const float m = to_f32(row[k * R + r]);
        if (RAW) mv[k] = m;
        ex[k] = cut(CUT_EXPS) ? m : expf(m);
    }
}

// lane 0 of the producer warp: frame u's slot of `bytes` from the pieces
// (src, bytes) given, after the reads of its last frame (fenced against the
// async proxy where the slot was filled before)
__device__ __forceinline__ void fill(uint64_t* full, unsigned char* slot,
                                     unsigned bytes, bool refill,
                                     const void* a, unsigned na,
                                     const void* b = nullptr, unsigned nb = 0,
                                     const void* c = nullptr,
                                     unsigned nc = 0) {
    if (cut(CUT_WAITS)) return;
    if (refill) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(full, bytes);
    bulk_copy(slot, a, na, full);
    if (nb) bulk_copy(slot + na, b, nb, full);
    if (nc) bulk_copy(slot + na + nb, c, nc, full);
}

// slot and phase of the next frame's row, advanced a frame at a time
struct Cursor {
    int slot, phase, ring;
    __device__ __forceinline__ void next() {
        if (++slot == ring) { slot = 0; phase ^= 1; }
    }
};

// ---------------------------------------------------------------- kernel B
struct FwdArgs {
    const bf16* moves;
    float* move_in;
    uint8_t* choices;
    float* cs;
    float* logz;
    int* end_state;
    int T, S, ring;
    float p_stay, blank;
};

// the registers a consumer carries from frame to frame
struct FwdCarry {
    float acc[4];   // move-in of the frame before, not yet normalised
    float ar[4];    // its raw alpha
    float am[4];    // its amax
};

// frame t of consumer r: the row of t in (mv, ex); the next frame's row
// read into (mvn, exn) on the way. A thread past the states (r >= R, where
// S / 4 is no multiple of 32) computes thread 0's and stores nothing, so
// that the frame is one block of code with no branch but the wait.
__device__ __forceinline__ void fwd_frame(
    const FwdArgs& a, int t, int r, bool active, int lane, int w, int nwc,
    const float* part_p, float* part_c, const float* araw_p, float* araw_c,
    const float* amx_p, float* amx_c, const unsigned char* ring, Cursor& cur,
    uint64_t* full, const float (&mv)[16], const float (&ex)[16],
    float (&mvn)[16], float (&exn)[16], FwdCarry& k)
{
    const int S = a.S, R = S / NB;
    const size_t row0 = (size_t)blockIdx.x * a.T;
    const bf16* nrow = reinterpret_cast<const bf16*>(ring + cur.slot * fwd_slot(S));
    // the next row's exps in four pieces between the steps of the chain
    if (!cut(CUT_WAITS)) mbar_wait(full + cur.slot, (unsigned)cur.phase);
    read_row<true, 0, 4>(nrow, R, r, mvn, exn);
    const float inv = 1.f / frame_max(part_p, nwc, w);
    read_row<true, 4, 8>(nrow, R, r, mvn, exn);
    float Ap[4], Mp[4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        Ap[j] = __fmul_rn(araw_p[j * R + r], inv);
        Mp[j] = amx_p[j * R + r];
    }
    const float4 ao = *reinterpret_cast<const float4*>(araw_p + NB * r);
    const float4 mo = *reinterpret_cast<const float4*>(amx_p + NB * r);
    const float As[4] = {__fmul_rn(ao.x, inv), __fmul_rn(ao.y, inv),
                         __fmul_rn(ao.z, inv), __fmul_rn(ao.w, inv)};
    const float Ms[4] = {mo.x, mo.y, mo.z, mo.w};
    if (active && t > 0 && !cut(CUT_STORES))
        *reinterpret_cast<float4*>(a.move_in + (row0 + t - 1) * S + NB * r) =
            make_float4(__fmul_rn(k.acc[0], inv), __fmul_rn(k.acc[1], inv),
                        __fmul_rn(k.acc[2], inv), __fmul_rn(k.acc[3], inv));
    read_row<true, 8, 12>(nrow, R, r, mvn, exn);
    uint32_t ch = 0;
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        float acc = 0.f, best = 0.f;
        int jbest = 0;
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            acc = __fadd_rn(acc, __fmul_rn(ex[b * NB + j], Ap[j]));
            const float cand = __fadd_rn(mv[b * NB + j], Mp[j]);
            if (j == 0 || cand > best) { best = cand; jbest = j; }
        }
        const float stay_m = __fadd_rn(a.blank, Ms[b]);
        const bool is_move = best > stay_m;
        k.acc[b] = acc;
        k.ar[b] = __fadd_rn(__fmul_rn(a.p_stay, As[b]), acc);
        k.am[b] = is_move ? best : stay_m;
        ch |= (is_move ? (uint32_t)(jbest + 1) : 0u) << (8 * b);
    }
    read_row<true, 12, 16>(nrow, R, r, mvn, exn);
    if (active) {
        *reinterpret_cast<float4*>(araw_c + NB * r) =
            make_float4(k.ar[0], k.ar[1], k.ar[2], k.ar[3]);
        *reinterpret_cast<float4*>(amx_c + NB * r) =
            make_float4(k.am[0], k.am[1], k.am[2], k.am[3]);
        if (!cut(CUT_STORES))
            *reinterpret_cast<uint32_t*>(a.choices + (row0 + t) * S + NB * r) = ch;
    }
    const float lmax = warp_max(active ? fmaxf(fmaxf(k.ar[0], k.ar[1]),
                                               fmaxf(k.ar[2], k.ar[3]))
                                       : 0.f);
    if (lane == 0) part_c[w] = lmax;
    if (t + 2 < a.T) cur.next();
    __syncthreads();
}

__global__ void __launch_bounds__(RING_THREADS, 1)
decode_tcn_fwd_ring_kernel(FwdArgs a)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = a.S, R = S / NB, NC = ring_consumers(S), nwc = NC / 32;
    const int T = a.T, ring = a.ring;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* part = reinterpret_cast<float*>(smem + (ring * 8 + 15) / 16 * 16);
    float* endp = part + 128;        // [32] run sums, [8] maxes, [8] indices
    float* araw = endp + 64;         // [2][S]
    float* amx = araw + 2 * S;       // [2][S]
    unsigned char* rows = reinterpret_cast<unsigned char*>(amx + 2 * S);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const size_t row0 = (size_t)blockIdx.x * T;
    const bf16* src = a.moves + row0 * NB * S;

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
        const unsigned bytes = (unsigned)fwd_slot(S);
        int issued = 0;
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                fill(full + s, rows + s * fwd_slot(S), bytes, issued >= ring,
                     src + (size_t)issued * NB * S, bytes);
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
        __syncthreads();  // the consumers' end partials
        float sum = lane < (S + 31) / 32 ? endp[lane] : 0.f;
        for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
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
    const int r = active ? tid : 0;
    float mv0[16], ex0[16], mv1[16], ex1[16];
    if (!cut(CUT_WAITS)) mbar_wait(full, 0u);
    read_row<true>(reinterpret_cast<const bf16*>(rows), R, r, mv0, ex0);
    // the next frame's slot: frame min(t + 1, T - 1)
    Cursor cur = {0, 0, ring};
    if (T > 1) cur.next();
    FwdCarry k = {};
    int t = 0;
    for (; t + 1 < T; t += 2) {
        fwd_frame(a, t, r, active, lane, w, nwc, part + 64, part, araw + S,
                  araw, amx + S, amx, rows, cur, full, mv0, ex0, mv1, ex1, k);
        fwd_frame(a, t + 1, r, active, lane, w, nwc, part, part + 64, araw,
                  araw + S, amx, amx + S, rows, cur, full, mv1, ex1, mv0, ex0,
                  k);
    }
    if (t < T)
        fwd_frame(a, t, r, active, lane, w, nwc, part + 64, part, araw + S,
                  araw, amx + S, amx, rows, cur, full, mv0, ex0, mv1, ex1, k);

    // the last frame's max: its move-in, and the end
    const float inv = 1.f / frame_max(part + ((T - 1) & 1) * 64, nwc, w);
    float v[4] = {0.f, 0.f, 0.f, 0.f}, best = -INFINITY;
    int ib = INT_MAX;
    if (active) {
        if (!cut(CUT_STORES))
            *reinterpret_cast<float4*>(a.move_in + (row0 + T - 1) * S + NB * r) =
                make_float4(__fmul_rn(k.acc[0], inv), __fmul_rn(k.acc[1], inv),
                            __fmul_rn(k.acc[2], inv), __fmul_rn(k.acc[3], inv));
        best = k.am[0];
        ib = NB * r;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            v[b] = __fmul_rn(k.ar[b], inv);
            if (k.am[b] > best) { best = k.am[b]; ib = NB * r + b; }
        }
    }
    // logZ's sum: the butterfly of each run of 32 states, b's levels last
#pragma unroll
    for (int o = 4; o > 0; o >>= 1)
#pragma unroll
        for (int b = 0; b < NB; ++b)
            v[b] = __fadd_rn(v[b], __shfl_xor_sync(0xffffffffu, v[b], o));
    if ((lane & 7) == 0)
        endp[w * 4 + lane / 8] = __fadd_rn(__fadd_rn(v[0], v[2]),
                                           __fadd_rn(v[1], v[3]));
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

// ---------------------------------------------------------------- kernel C
struct BwdArgs {
    const bf16* moves;
    const float* move_in;
    const uint8_t* choices;
    const float* cs;
    const float* logz;
    const int* end_state;
    uint8_t* seq;
    uint8_t* qstr;
    uint8_t* mvout;
    int T, S, ring;
    float p_stay, qscale, qbias;
};

// frame i (t = T-1-i) of consumer r, whose traceback state is `state`:
// the row of i in ex, its move_in and choices in `slot`; the next frame's
// row read into exn on the way. A thread past the states computes thread
// 0's and stores nothing, as in fwd_frame.
__device__ __forceinline__ void bwd_frame(
    const BwdArgs& a, int i, int r, bool active, int lane, int w, int nwc,
    const float* part_p, float* part_c, const float* braw_p, float* braw_c,
    float* vb_c, const unsigned char* slot, const unsigned char* ring,
    Cursor& cur,
    uint64_t* full, int& state, const float (&ex)[16], float (&exn)[16])
{
    const int S = a.S, R = S / NB;
    float unused[16];
    const bf16* nrow = reinterpret_cast<const bf16*>(ring + cur.slot * bwd_slot(S));
    // the next row's exps in two pieces between the steps of the chain
    if (!cut(CUT_WAITS)) mbar_wait(full + cur.slot, (unsigned)cur.phase);
    read_row<false, 0, 8>(nrow, R, r, unused, exn);
    const float inv = 1.f / frame_max(part_p, nwc, w);
    const float4 bo = *reinterpret_cast<const float4*>(braw_p + NB * r);
    const float Bs[4] = {__fmul_rn(bo.x, inv), __fmul_rn(bo.y, inv),
                         __fmul_rn(bo.z, inv), __fmul_rn(bo.w, inv)};
    // traceback, the same in every thread: the mass of the emitted base's
    // state of this thread (the other three add zeros to the sum)
    const int choice = cut(CUT_TRACE) ? 0 : slot[12 * S + state];
    if (threadIdx.x == 0) part_c[8] = __int_as_float(choice | state << 8);
    const int base = state % NB;
    const float* mvin = reinterpret_cast<const float*>(slot + 8 * S);
    const float Bb = base == 0 ? Bs[0] : base == 1 ? Bs[1]
                   : base == 2 ? Bs[2] : Bs[3];
    float v = active ? __fmul_rn(mvin[NB * r + base], Bb) : 0.f;
    if (choice != 0) state = state / NB + (choice - 1) * R;
    if (cut(CUT_WAITS)) state %= S;  // choices of unfilled slots
    read_row<false, 8, 16>(nrow, R, r, unused, exn);
    float br[4];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int b = 0; b < NB; ++b)
            acc = __fadd_rn(acc, __fmul_rn(ex[b * NB + j], Bs[b]));
        br[j] = __fadd_rn(__fmul_rn(a.p_stay,
                                    __fmul_rn(braw_p[j * R + r], inv)), acc);
    }
    if (active) {
#pragma unroll
        for (int j = 0; j < NB; ++j) braw_c[j * R + r] = br[j];
    }
    const float lmax = warp_max(active ? fmaxf(fmaxf(br[0], br[1]),
                                               fmaxf(br[2], br[3]))
                                       : 0.f);
    vb_c[threadIdx.x] = v;  // the epilogue warp sums them
    if (lane == 0) part_c[w] = lmax;
    if (i + 2 < a.T) cur.next();
    __syncthreads();
}

__global__ void __launch_bounds__(RING_THREADS, 1)
decode_tcn_bwd_ring_kernel(BwdArgs a)
{
    extern __shared__ __align__(16) unsigned char smem[];
    const int S = a.S, R = S / NB, NC = ring_consumers(S), nwc = NC / 32;
    const int T = a.T, ring = a.ring;
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    float* part = reinterpret_cast<float*>(smem + (ring * 8 + 15) / 16 * 16);
    float* braw = part + 128 + 64;   // [2][S]
    float* vb = braw + 2 * S;        // [2][NC]: each thread's share of the mass
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
    const size_t slot_bytes = bwd_slot(S);

    if (w == nwc) {
        // --------------------------------------------------- producer warp
        int issued = 0;  // frames i = 0, 1, ... (t = T-1-i) in the ring
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                const size_t f = row0 + (T - 1 - issued);
                fill(full + s, rows + s * slot_bytes, (unsigned)slot_bytes,
                     issued >= ring, a.moves + f * NB * S, 8u * S,
                     a.move_in + f * S, 4u * S, a.choices + f * S, (unsigned)S);
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
            // the mass: lane k sums run k (the threads 8k .. 8k+7, states
            // xor 16, 8, 4 of the run; xor 2 and 1 add the zeros of the
            // other bases), then the butterfly over the 32 runs' sums
            float bm = 0.f;
            if (lane < NC / 8) {
                const float4* q = reinterpret_cast<const float4*>(
                    vb + (i & 1) * NC + 8 * lane);
                const float4 lo = q[0], hi = q[1];
                if (cut(CUT_REDUCE)) {
                    bm = lo.x;
                } else {
                    bm = __fadd_rn(__fadd_rn(__fadd_rn(lo.x, hi.x),
                                             __fadd_rn(lo.z, hi.z)),
                                   __fadd_rn(__fadd_rn(lo.y, hi.y),
                                             __fadd_rn(lo.w, hi.w)));
                }
            }
            if (!cut(CUT_REDUCE))
                for (int o = 16; o > 0; o >>= 1)
                    bm = __fadd_rn(bm, __shfl_xor_sync(0xffffffffu, bm, o));
            const float mx = frame_max(pp, nwc, 0);
            // the consumers' traceback: frame i's choice and state
            const int trace = __float_as_int(pp[8]);
            const bool is_move = (trace & 255) != 0;
            const int base = (trace >> 8) % NB + 1;
            if ((i & 31) == 0 && i > 0) {
                c_now = c_next;
                c_next = c_of(i / 32 + 1);
            }
            const float c = __shfl_sync(0xffffffffu, c_now, i & 31);
            if (lane == 0) {
                const float prob = bm * expf(c + d - lz);
                const float err = fminf(fmaxf(1.f - prob, 1e-4f), 1.f);
                const float q = __fadd_rn(__fmul_rn(-10.f * log10f(err),
                                                    a.qscale), a.qbias);
                const int qc = (int)rintf(q) + 33;
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
    const int r = active ? tid : 0;
    int state = a.end_state[n];
    float ex0[16], ex1[16], unused[16];
    if (!cut(CUT_WAITS)) mbar_wait(full, 0u);
    read_row<false>(reinterpret_cast<const bf16*>(rows), R, r, unused, ex0);
    Cursor cur = {0, 0, ring};
    if (T > 1) cur.next();
    Cursor now = {0, 0, ring};  // this frame's slot
    int i = 0;
    for (; i + 1 < T; i += 2) {
        bwd_frame(a, i, r, active, lane, w, nwc, part + 64, part, braw + S,
                  braw, vb, rows + now.slot * slot_bytes, rows, cur, full,
                  state, ex0, ex1);
        now.next();
        bwd_frame(a, i + 1, r, active, lane, w, nwc, part, part + 64, braw,
                  braw + S, vb + NC, rows + now.slot * slot_bytes, rows, cur,
                  full, state, ex1, ex0);
        now.next();
    }
    if (i < T)
        bwd_frame(a, i, r, active, lane, w, nwc, part + 64, part, braw + S,
                  braw, vb, rows + now.slot * slot_bytes, rows, cur, full,
                  state, ex0, ex1);
}

bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

bool bad_ring_shape(int N, int T, int S, int ring, int least) {
    return N < 1 || T < 1 || S < 16 || S % 16 != 0 || S > 1024
        || ring < least || ring > RING_MAX;
}

}  // namespace

extern "C" {

// kernel B on a ring of `ring` frames: as decode_tcn_fwd_bf16
int decode_tcn_fwd_ring(const void* moves, void* move_in, void* choices,
                        void* c, void* logz, void* end_state, int N, int T,
                        int S, int ring, float p_stay, float blank,
                        void* stream) {
    if (bad_ring_shape(N, T, S, ring, 1) || !aligned16(moves)
        || !aligned16(move_in) || !aligned16(choices))
        return (int)cudaErrorInvalidValue;
    const size_t smem = fwd_smem(S, ring);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        decode_tcn_fwd_ring_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    FwdArgs a = {static_cast<const bf16*>(moves), static_cast<float*>(move_in),
                 static_cast<uint8_t*>(choices), static_cast<float*>(c),
                 static_cast<float*>(logz), static_cast<int*>(end_state), T,
                 S, ring, p_stay, blank};
    decode_tcn_fwd_ring_kernel<<<N, ring_consumers(S) + 64, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// kernel C on a ring of `ring` frames (at least 2): as decode_tcn_bwd_bf16
int decode_tcn_bwd_ring(const void* moves, const void* move_in,
                        const void* choices, const void* c, const void* logz,
                        const void* end_state, void* seq, void* qstr,
                        void* mvout, int N, int T, int S, int ring,
                        float p_stay, float qscale, float qbias,
                        void* stream) {
    if (bad_ring_shape(N, T, S, ring, 2) || !aligned16(moves)
        || !aligned16(move_in) || !aligned16(choices))
        return (int)cudaErrorInvalidValue;
    const size_t smem = bwd_smem(S, ring);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        decode_tcn_bwd_ring_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    BwdArgs a = {static_cast<const bf16*>(moves),
                 static_cast<const float*>(move_in),
                 static_cast<const uint8_t*>(choices),
                 static_cast<const float*>(c), static_cast<const float*>(logz),
                 static_cast<const int*>(end_state),
                 static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
                 static_cast<uint8_t*>(mvout), T, S, ring, p_stay, qscale,
                 qbias};
    decode_tcn_bwd_ring_kernel<<<N, ring_consumers(S) + 64, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

}  // extern "C"
