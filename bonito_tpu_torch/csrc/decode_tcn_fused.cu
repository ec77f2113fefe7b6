// Kernels G and J: the two-pass Viterbi + posterior CRF decode with the CRF
// head inside.
//
// Replace bonito_tpu/ops/decode_pallas.py:viterbi_decode_tcn_fused -- G is
// `_fwd_kernel_tcn_fused` (forward pass), J is `_bwd_kernel_tcn_fused`
// (backward pass) with that function's qscore epilogue, and both hold
// `_head_mv`. The route of the small state spaces (fast: S = 64, H = 96,
// N = 1024, T = 1200).
//
// Input is the encoder output h [T/U, N, H] bf16 (time-major, the LSTM's
// own layout) and the head's folded weights w [U, nb*S, H] bf16 with a bias
// [U, nb*S] f32: output frame t = th*U + p takes phase p of encoder frame th,
//
//     mv = clip(scale * tanh?(w[p] @ h[th] + bias[p]))        (f32)
//
// one score per move, rows in the TCN (b, j, r) order: row (b*nb + j)*R + r
// is the move into state s = r*nb + b from predecessor p = j*R + r (R =
// S/nb, nb = 4). The stay score is the constant `blank`. Both passes compute
// mv themselves, so the [T, nb*S, N] move tensor is never written to device
// memory and never rounded to bf16. From mv on the math is that of kernels B
// and C (decode_tcn.cu): G carries alpha in probability space (renormalised
// by its max, log correction c) and the max semiring with its choices (first
// j on ties, a move only if strictly better than staying), and ends with
// logZ and the first argmax state; J carries beta, its correction d and one
// integer of traceback state per row, and emits sequence, qstring (phred of
// the emitted base's posterior, rounded half to even) and moves per frame.
//
// What bounds them on an H100: at fast widths each pass is 2*T*N*H*nb*S =
// 6e10 operations for the head (0.06 ms on the tensor cores); G reads 0.24
// GB of h and writes 0.31 GB of move-in and 0.08 GB of choices, J reads the
// same back (0.2 ms at 3.35 TB/s): bytes. The recursion is serial in T, so
// what bounds the design is the time of one frame.
//
// The earlier design (G, and J where fused_decode_plan gives no plan): a
// block owns RB = 4 batch rows (256 blocks at N = 1024, two to an SM) with
// one thread per (row, state). The head product does not depend on
// the decode's state, so it is taken FB = 4 encoder frames at a time: the 16
// columns (frame, row) of a chunk make the n side of 16x16x16 bf16 WMMA
// products with the move rows on the m side, f32 sums stored to shared
// memory, and then the serial recursion walks the chunk's frames reading its
// four scores per thread from there (bias, tanh, scale and clamp applied on
// the read). The weights stay in the block's shared memory (48 KB at fast
// widths, rows padded by 16 bytes; G takes them with its rows regrouped as
// (j, s), so that a thread's reads are conflict-free) unless they do not fit,
// in which case fragments are read through L2. The next chunk's h rows -- and
// in J its move-in, choices and c -- arrive by cp.async while this one is
// decoded, so no frame waits for device memory; J's traceback, a dependent
// read per frame, reads shared memory. alpha/beta ping-pong between two
// buffers: one block barrier per frame, one more where a row spans warps.
//
// J on its ring (decode_fused_bwd_ring, ops/decode_fused_cuda.py:
// fused_decode_plan: S 64, H 32 or 96, U 1 or 2), a CTA of 8 batch rows in
// warps of their own:
//   the producer  lane 0 bulk-copies each chunk's h rows (one copy an
//              encoder frame) and, per row, its frames of move-in and
//              choices into a ring of chunks (csrc/ring.cuh's fill; a slot
//              refilled once its readers arrived on `empty`);
//   8 head warps  hold their m-tiles of the weights in registers and, a
//              chunk ahead of the consumers, compute the chunk's head sums
//              (mma.sync m16n8k16, an encoder frame's 8 rows the n: the
//              same HMMA and k order as head_product) and the exps of the
//              move scores into one of two tiles;
//   8 consumer warps  one a row, two states a thread: beta's step from the
//              tile's exps with the earlier kernel's f32 steps, the row's
//              max (a redux on the bits) and 1 / max in registers, the
//              mass's butterfly over each run of 32 states, the traceback;
//              __syncwarp once a frame, no block barrier;
//   the epilogue warp  lane r: row r's posterior, qscore and three bytes a
//              frame from the records the consumers leave, a chunk behind.
// Every output equals the earlier J's bit for bit. On an H100 at fast
// widths it takes about 0.83 ms against the earlier J's 2.23; the head
// warps' exps and the consumers' chain set the pace (PERF.md;
// scripts/decode_split.py j leaves out each part, J_CUT). One state a
// thread, two consumer warps a row meeting at a named barrier, took about
// 1.07 ms (26 warps leave 72 registers a thread: the head warps spill); the
// split tool builds it from an edited copy of this file.
//
// G on the same ring (decode_fused_fwd_ring, fused_decode_plan's "fwd":
// the instances J builds), a CTA of 8 batch rows in 17 warps:
//   the producer  lane 0 bulk-copies each chunk's h rows (4 / U encoder
//              frames, one copy a frame) into a ring of chunks;
//   8 head warps  J's, with the weights' rows in G's (j, s) order: a chunk
//              ahead of the consumers, each move's score head_act(sum +
//              bias) and its exp into one of two tiles (float2 pairs);
//   8 consumer warps  one a row, two states a thread: alpha's step and the
//              max semiring's with the earlier G's f32 steps (alpha kept
//              raw, read times 1 / the last frame's max as the earlier G
//              stored it), the row's max (a redux on the bits), c, and the
//              stores of move-in, choices and c a frame; __syncwarp once a
//              frame, no block barrier; at the end logZ (row_sum_max's runs
//              in order) and the first argmax.
// Every output equals the earlier G's bit for bit (scripts/decode_split.py
// g leaves out each part, G_CUT).
//
// Later work: S > 256 (a row per block or per cluster).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <climits>
#include <cmath>
#include <cstdint>

#include "ring.cuh"

#ifndef J_CUT
#define J_CUT 0
#endif
#ifndef G_CUT
#define G_CUT 0
#endif

using namespace nvcuda;

namespace {

constexpr int NB = 4;
constexpr int RB = 4;               // batch rows per block
constexpr int FB = 4;               // encoder frames per chunk
constexpr int NCOL = RB * FB;       // the n of a 16x16x16 tile

typedef __nv_bfloat16 bf16;

struct HeadOps {
    int act_tanh;
    float scale;
    int clamp;
    float cmin, cmax;
};

__host__ __device__ constexpr int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

__host__ __device__ inline int threads_for(int S) {
    const int t = round_up(RB * S, 32);
    return t < 128 ? 128 : t;
}

// Shared memory of a block, in bytes from its start. With `resident` the
// weights sit in front as [U * nb*S, H + PAD] bf16. `backward` adds J's
// staged chunks of move-in, choices and c.
struct Layout {
    int ldw, ldh, ldm;
    int off_h, off_mv, off_bias, off_ab, off_amax, off_red;
    int off_min, off_ch, off_cs, total;
    __host__ __device__ Layout(int H, int S, int U, bool resident,
                               bool backward) {
        const int Cm = NB * S;
        ldw = H + PAD;
        ldh = H + PAD;
        ldm = Cm + 4;
        int off = resident ? round_up(U * Cm * ldw * 2, 128) : 0;
        off_h = off;     off += round_up(2 * NCOL * ldh * 2, 128);
        off_mv = off;    off += round_up(U * NCOL * ldm * 4, 128);
        off_bias = off;  off += round_up(U * Cm * 4, 128);
        off_ab = off;    off += round_up(2 * RB * S * 4, 128);
        off_amax = off;  off += backward ? 0 : round_up(2 * RB * S * 4, 128);
        off_red = off;   off += round_up(RB * 32 * 2 * 4, 128);
        const int FU = FB * U;  // output frames per chunk
        const int staged = backward ? 2 * RB * FU : 0;  // frames staged
        off_min = off;  off += round_up(staged * S * 4, 128);
        off_ch = off;   off += round_up(staged * S, 128);
        off_cs = off;   off += round_up(staged * 4, 128);
        total = off;
    }
};

__device__ __forceinline__ float head_act(float z, const HeadOps& o) {
    if (o.act_tanh) z = tanhf(z);
    z *= o.scale;
    if (o.clamp) z = fminf(fmaxf(z, o.cmin), o.cmax);
    return z;
}

// One thread per (row, state) of the block; threads past RB*S only help
// with copies and products.
struct Lane {
    int S, width, nw;   // lanes a row spans within a warp; warps per row
    int row, s;
    bool active;
    __device__ Lane(int S_) : S(S_) {
        width = S < 32 ? S : 32;
        nw = (S + 31) / 32;
        active = (int)threadIdx.x < RB * S;
        row = active ? threadIdx.x / S : 0;
        s = threadIdx.x % S;
    }
};

// Reductions over the S threads of a row. S is a power of two below 32 or a
// multiple of 32, and rows start at multiples of S, so the xor butterfly of
// `width` lanes stays inside one row; rows that span warps meet in `red`
// ([RB][32][2] floats). Every thread of the block must call them (they hold
// a barrier when nw > 1), and every thread of a row returns the same bits.
// `red` is free again after the next block barrier.
__device__ __forceinline__ void row_sum_max(float& sum, float& mx,
                                            const Lane& g, float* red) {
    for (int o = g.width >> 1; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (g.nw > 1) {
        float* mine = red + g.row * 64;
        if (g.active && (g.s & 31) == 0) {
            mine[2 * (g.s >> 5)] = sum;
            mine[2 * (g.s >> 5) + 1] = mx;
        }
        __syncthreads();
        sum = 0.f;
        mx = -INFINITY;
        for (int i = 0; i < g.nw; ++i) {
            sum += mine[2 * i];
            mx = fmaxf(mx, mine[2 * i + 1]);
        }
    }
}

// first index of the maximum on ties
__device__ __forceinline__ void row_argmax(float& v, int& i, const Lane& g,
                                           float* red) {
    for (int o = g.width >> 1; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, i, o);
        if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
    }
    if (g.nw > 1) {
        float* mine = red + g.row * 64;
        if (g.active && (g.s & 31) == 0) {
            mine[2 * (g.s >> 5)] = v;
            mine[2 * (g.s >> 5) + 1] = __int_as_float(i);
        }
        __syncthreads();
        v = -INFINITY;
        i = INT_MAX;
        for (int k = 0; k < g.nw; ++k) {
            const float v2 = mine[2 * k];
            const int i2 = __float_as_int(mine[2 * k + 1]);
            if (v2 > v || (v2 == v && i2 < i)) { v = v2; i = i2; }
        }
    }
}

// Copy the weights [rows, H] into shared memory with padded rows.
__device__ __forceinline__ void load_weights(bf16* ws,
                                             const bf16* __restrict__ w,
                                             int rows, int H, int ldw) {
    const int units = H / 8;
    for (int e = threadIdx.x; e < rows * units; e += blockDim.x) {
        const int row = e / units, u = e % units;
        *reinterpret_cast<int4*>(ws + (size_t)row * ldw + 8 * u) =
            *reinterpret_cast<const int4*>(w + (size_t)row * H + 8 * u);
    }
}

// Start the copy of encoder frames th0 .. th0 + FB of the block's rows into
// dst [NCOL][ldh]: column f*RB + row. Frames past Th and rows past N become
// zeros.
__device__ __forceinline__ void stage_h(bf16* dst,
                                        const bf16* __restrict__ h, int th0,
                                        int Th, int N, int n0, int H,
                                        int ldh) {
    const int units = H / 8;
    for (int e = threadIdx.x; e < NCOL * units; e += blockDim.x) {
        const int col = e / units, u = e % units;
        const int th = th0 + col / RB, n = n0 + col % RB;
        bf16* d = dst + col * ldh + 8 * u;
        if (th < Th && n < N)
            __pipeline_memcpy_async(
                d, h + ((size_t)th * N + n) * H + 8 * u, 16);
        else
            *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
    }
}

// mv[p][col][m] = sum_k w[p][m][k] * hs[col][k] for every phase p and move
// row m: a warp per 16 move rows.
__device__ __forceinline__ void head_product(float* mv, int ldm,
                                             const bf16* w, int ldw,
                                             const bf16* hs, int ldh, int U,
                                             int Cm, int H) {
    const int warp = threadIdx.x / 32, nwarp = blockDim.x / 32;
    const int mtiles = Cm / 16;
    for (int tile = warp; tile < U * mtiles; tile += nwarp) {
        const int p = tile / mtiles, m0 = (tile % mtiles) * 16;
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
        wmma::fill_fragment(acc, 0.f);
        for (int kt = 0; kt < H / 16; ++kt) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16,
                           wmma::row_major> a;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16,
                           wmma::col_major> b;
            wmma::load_matrix_sync(
                a, w + (size_t)(p * Cm + m0) * ldw + 16 * kt, ldw);
            wmma::load_matrix_sync(b, hs + 16 * kt, ldh);
            wmma::mma_sync(acc, a, b, acc);
        }
        // element (m, col) lands at mv[p][col][m0 + m]
        wmma::store_matrix_sync(mv + (size_t)p * NCOL * ldm + m0, acc, ldm,
                                wmma::mem_col_major);
    }
}

template <bool RESIDENT>
__global__ void decode_fused_fwd(const bf16* __restrict__ h,     // [Th, N, H]
                                 const bf16* __restrict__ w,  // [U, (j, s), H]
                                 const float* __restrict__ bias, // [U, (j, s)]
                                 float* __restrict__ move_in,    // [N, T, S]
                                 uint8_t* __restrict__ choices,  // [N, T, S]
                                 float* __restrict__ cs,         // [N, T]
                                 float* __restrict__ logz,       // [N]
                                 int* __restrict__ end_state,    // [N]
                                 int Th, int N, int H, int S, int U,
                                 float p_stay, float blank, HeadOps ops)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L(H, S, U, RESIDENT, false);
    const int Cm = NB * S, R = S / NB, T = Th * U;
    bf16* ws = reinterpret_cast<bf16*>(smem);
    bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
    float* mv = reinterpret_cast<float*>(smem + L.off_mv);
    float* bs = reinterpret_cast<float*>(smem + L.off_bias);
    float* A = reinterpret_cast<float*>(smem + L.off_ab);      // [2][RB][S]
    float* amax = reinterpret_cast<float*>(smem + L.off_amax); // [2][RB][S]
    float* red = reinterpret_cast<float*>(smem + L.off_red);

    const Lane g(S);
    const int n0 = blockIdx.x * RB;
    const int n = n0 + g.row;
    const int s = g.s, r = s / NB;
    const bool live = g.active && n < N;

    if (RESIDENT) load_weights(ws, w, U * Cm, H, L.ldw);
    for (int e = threadIdx.x; e < U * Cm; e += blockDim.x) bs[e] = bias[e];
    for (int e = threadIdx.x; e < RB * S; e += blockDim.x) {
        A[e] = 1.f;
        amax[e] = 0.f;
    }
    const bf16* wp = RESIDENT ? ws : w;
    const int ldw = RESIDENT ? L.ldw : H;

    const int nchunk = (Th + FB - 1) / FB;
    stage_h(hs, h, 0, Th, N, n0, H, L.ldh);
    __pipeline_commit();
    float c = 0.f;
    int cur = 0;
    for (int k = 0; k < nchunk; ++k) {
        __pipeline_wait_prior(0);
        __syncthreads();  // this chunk's h here; mv and the other buffer free
        // the next chunk's rows arrive while this one is decoded
        if (k + 1 < nchunk)
            stage_h(hs + ((k + 1) & 1) * NCOL * L.ldh, h, (k + 1) * FB, Th, N,
                    n0, H, L.ldh);
        __pipeline_commit();
        head_product(mv, L.ldm, wp, ldw, hs + (k & 1) * NCOL * L.ldh, L.ldh,
                     U, Cm, H);
        const int nf = min(FB, Th - k * FB);
        for (int f = 0; f < nf; ++f) {
            for (int p = 0; p < U; ++p) {
                __syncthreads();  // mv, and the last frame's A/amax, visible
                const int t = (k * FB + f) * U + p;
                const float* mrow =
                    mv + (size_t)(p * NCOL + f * RB + g.row) * L.ldm;
                const float* brow = bs + p * Cm;
                const float* Ac = A + (cur * RB + g.row) * S;
                const float* xc = amax + (cur * RB + g.row) * S;
                float acc = 0.f, a_raw = -INFINITY, best = 0.f, stay_m = 0.f;
                int jbest = 0;
                if (g.active) {
#pragma unroll
                    for (int j = 0; j < NB; ++j) {
                        const float m = head_act(
                            mrow[j * S + s] + brow[j * S + s], ops);
                        const int q = j * R + r;
                        acc += expf(m) * Ac[q];
                        const float cand = m + xc[q];
                        if (j == 0 || cand > best) { best = cand; jbest = j; }
                    }
                    a_raw = p_stay * Ac[s] + acc;
                    stay_m = blank + xc[s];
                }
                float unused = 0.f, mx = a_raw;
                row_sum_max(unused, mx, g, red);
                const float inv = 1.f / mx;
                c += logf(mx);
                if (g.active) {
                    const bool is_move = best > stay_m;
                    const int nxt = ((cur ^ 1) * RB + g.row) * S + s;
                    A[nxt] = a_raw * inv;
                    amax[nxt] = is_move ? best : stay_m;
                    if (live) {
                        const size_t o = ((size_t)n * T + t) * S + s;
                        move_in[o] = acc * inv;
                        choices[o] = is_move ? (uint8_t)(jbest + 1)
                                             : (uint8_t)0;
                        if (s == 0) cs[(size_t)n * T + t] = c;
                    }
                }
                cur ^= 1;
            }
        }
    }
    __syncthreads();
    float sum = g.active ? A[(cur * RB + g.row) * S + s] : 0.f;
    float unused = -INFINITY;
    row_sum_max(sum, unused, g, red);
    __syncthreads();  // red is used again
    float v = g.active ? amax[(cur * RB + g.row) * S + s] : -INFINITY;
    int idx = g.active ? s : INT_MAX;
    row_argmax(v, idx, g, red);
    if (live && s == 0) {
        logz[n] = logf(sum) + c;
        end_state[n] = idx;
    }
}

template <bool RESIDENT>
__global__ void decode_fused_bwd(const bf16* __restrict__ h,     // [Th, N, H]
                                 const bf16* __restrict__ w,     // [U, nb*S, H]
                                 const float* __restrict__ bias, // [U, nb*S]
                                 const float* __restrict__ move_in, // [N, T, S]
                                 const uint8_t* __restrict__ choices,
                                 const float* __restrict__ cs,       // [N, T]
                                 const float* __restrict__ logz,     // [N]
                                 const int* __restrict__ end_state,  // [N]
                                 uint8_t* __restrict__ seq,          // [N, T]
                                 uint8_t* __restrict__ qstr,         // [N, T]
                                 uint8_t* __restrict__ mvout,        // [N, T]
                                 int Th, int N, int H, int S, int U,
                                 float p_stay, float qscale, float qbias,
                                 HeadOps ops)
{
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L(H, S, U, RESIDENT, true);
    const int Cm = NB * S, R = S / NB, T = Th * U;
    const int FU = FB * U;  // output frames per chunk
    bf16* ws = reinterpret_cast<bf16*>(smem);
    bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
    float* mv = reinterpret_cast<float*>(smem + L.off_mv);
    float* bs = reinterpret_cast<float*>(smem + L.off_bias);
    float* B = reinterpret_cast<float*>(smem + L.off_ab);       // [2][RB][S]
    float* red = reinterpret_cast<float*>(smem + L.off_red);
    // staged per chunk: move-in and choices [2][RB][FU][S], c [2][RB][FU]
    float* min_s = reinterpret_cast<float*>(smem + L.off_min);
    uint8_t* ch_s = smem + L.off_ch;
    float* cs_s = reinterpret_cast<float*>(smem + L.off_cs);

    const Lane g(S);
    const int n0 = blockIdx.x * RB;
    const int n = n0 + g.row;
    const int s = g.s, j = s / R, r = s % R;  // this thread as p = j*R + r
    const bool live = g.active && n < N;

    if (RESIDENT) load_weights(ws, w, U * Cm, H, L.ldw);
    for (int e = threadIdx.x; e < U * Cm; e += blockDim.x) bs[e] = bias[e];
    for (int e = threadIdx.x; e < RB * S; e += blockDim.x) B[e] = 1.f;
    const bf16* wp = RESIDENT ? ws : w;
    const int ldw = RESIDENT ? L.ldw : H;

    // start the copies of chunk k into buffer `buf`: its h rows and, per
    // row, its frames of move-in, choices and c (contiguous in t)
    auto stage = [&](int k, int buf) {
        stage_h(hs + buf * NCOL * L.ldh, h, k * FB, Th, N, n0, H, L.ldh);
        const int t0 = k * FU;
        const int nt = min(FU, T - t0);
        const int per_row = FU * S / 4;  // 4-byte pieces of choices
        for (int e = threadIdx.x; e < RB * per_row; e += blockDim.x) {
            const int row = e / per_row, i = e % per_row;
            const int lf = 4 * i / S;    // the piece's frame of the chunk
            const bool ok = n0 + row < N && lf < nt;
            const size_t src = ((size_t)(n0 + row) * T + t0) * S + 4 * i;
            float* dm = min_s + (size_t)(buf * RB + row) * FU * S + 4 * i;
            uint8_t* dc = ch_s + (size_t)(buf * RB + row) * FU * S + 4 * i;
            if (ok) {
                __pipeline_memcpy_async(dm, move_in + src, 16);
                __pipeline_memcpy_async(dc, choices + src, 4);
            } else {
                *reinterpret_cast<int4*>(dm) = make_int4(0, 0, 0, 0);
                *reinterpret_cast<int*>(dc) = 0;
            }
        }
        for (int e = threadIdx.x; e < RB * FU; e += blockDim.x) {
            const int row = e / FU, lf = e % FU;
            float* d = cs_s + (buf * RB + row) * FU + lf;
            if (n0 + row < N && lf < nt)
                __pipeline_memcpy_async(
                    d, cs + (size_t)(n0 + row) * T + t0 + lf, 4);
            else
                *d = 0.f;
        }
    };

    const int nchunk = (Th + FB - 1) / FB;
    stage(nchunk - 1, 0);
    __pipeline_commit();
    float d = 0.f;
    int state = live ? end_state[n] : 0;
    const float lz = live ? logz[n] : 0.f;
    int cur = 0;
    for (int k = nchunk - 1, it = 0; k >= 0; --k, ++it) {
        const int buf = it & 1;
        __pipeline_wait_prior(0);
        __syncthreads();  // this chunk's inputs here; mv and the other
                          // buffer, which the last chunk's frames read, free
        if (k > 0) stage(k - 1, buf ^ 1);
        __pipeline_commit();
        head_product(mv, L.ldm, wp, ldw, hs + buf * NCOL * L.ldh, L.ldh, U,
                     Cm, H);
        const int nf = min(FB, Th - k * FB);
        for (int f = nf - 1; f >= 0; --f) {
            for (int p = U - 1; p >= 0; --p) {
                __syncthreads();  // mv, and the last frame's B, visible
                const int lf = f * U + p;
                const int t = k * FU + lf;
                const size_t at = (size_t)(buf * RB + g.row) * FU + lf;
                // traceback: the same for every thread of the row
                const int choice = ch_s[at * S + state];
                const bool is_move = choice != 0;
                const int base = state % NB + 1;
                const int prev = is_move ? state / NB + (choice - 1) * R
                                         : state;
                const float* mrow =
                    mv + (size_t)(p * NCOL + f * RB + g.row) * L.ldm;
                const float* brow = bs + p * Cm;
                const float* Bc = B + (cur * RB + g.row) * S;
                float v = 0.f, b_raw = -INFINITY;
                if (g.active) {
                    if (s % NB == base - 1) v = min_s[at * S + s] * Bc[s];
                    float acc = 0.f;
#pragma unroll
                    for (int bb = 0; bb < NB; ++bb) {
                        const float m = head_act(
                            mrow[bb * S + s] + brow[bb * S + s], ops);
                        acc += expf(m) * Bc[r * NB + bb];
                    }
                    b_raw = p_stay * Bc[s] + acc;
                }
                float bmass = v, mx = b_raw;
                row_sum_max(bmass, mx, g, red);
                if (g.active)
                    B[((cur ^ 1) * RB + g.row) * S + s] = b_raw * (1.f / mx);
                if (live && s == 0) {
                    const float prob = bmass * expf(cs_s[at] + d - lz);
                    const float err = fminf(fmaxf(1.f - prob, 1e-4f), 1.f);
                    const float q = -10.f * log10f(err) * qscale + qbias;
                    const int qc = (int)rintf(q) + 33;
                    const size_t o = (size_t)n * T + t;
                    seq[o] = is_move ? (uint8_t)base : (uint8_t)0;
                    qstr[o] = is_move ? (uint8_t)qc : (uint8_t)0;
                    mvout[o] = is_move ? 1 : 0;
                }
                d += logf(mx);
                state = prev;
                cur ^= 1;
            }
        }
    }
}

// ------------------------------------------------- kernel J on the ring
// the parts scripts/decode_split.py j leaves out (J_CUT bits)
constexpr int JCUT_HEAD = 1;      // the head warps' products and exps
constexpr int JCUT_WAITS = 2;     // the ring's copies and the waits for them
constexpr int JCUT_EPILOGUE = 4;  // the epilogue's masses, qscores, stores

__device__ __forceinline__ constexpr bool jcut(int part) {
    return (J_CUT & part) != 0;
}

constexpr int JS = 64;     // states: the instances built
constexpr int JRB = 8;     // batch rows a CTA: an encoder frame's rows make
                           // the n of a head tile (mma.sync m16n8k16)
constexpr int JCW = JRB;   // consumer warps: one a row
constexpr int JSPT = JS / 32;  // states a consumer thread
constexpr int JHW = 8;     // head warps
constexpr int JWARPS = JCW + JHW + 2;  // and the producer, the epilogue warp
constexpr int JUMAX = 2;   // upsample phases the ring kernel takes
constexpr int JFU = FB * JUMAX;  // output frames of a chunk, at most
constexpr int JRING_MAX = 8;

// a frame's record for the epilogue: the mass's sum over each run of 32
// states, the row's max, the traceback word
__host__ __device__ constexpr int jrec(int S) { return S / 32 + 2; }

// Shared memory, in bytes from its start: the mbarriers; beta of two
// parities (raw, [2][JRB][S]); two chunks' records ([2][JRB][fu][jrec(S)])
// and exps ([2][fu][JRB][ldt]); the ring of chunks: each slot the chunk's h
// rows ([FB][JRB][H] bf16) and, per row, its frames of move-in ([fu][S]
// f32) and choices ([fu][S]).
struct JLayout {
    int fu, ldt, slot_h, slot_min, slot_bytes;
    int off_beta, off_rec, off_tile, off_ring, total;
    __host__ __device__ constexpr JLayout(int S, int H, int U, int ring)
        : fu(FB * U), ldt(NB * S + 4), slot_h(FB * JRB * H * 2),
          slot_min(JRB * FB * U * S * 4),
          slot_bytes(round_up(FB * JRB * H * 2 + JRB * FB * U * S * 5, 128)),
          off_beta(256),
          off_rec(off_beta + round_up(2 * JRB * S * 4, 128)),
          off_tile(off_rec + round_up(2 * JRB * FB * U * jrec(S) * 4, 128)),
          off_ring(off_tile
                   + round_up(2 * FB * U * JRB * (NB * S + 4) * 4, 128)),
          total(off_ring + ring * slot_bytes) {}
};

struct JArgs {
    const bf16* h;             // [Th, N, H]
    const bf16* w;             // [U, nb*S, H], rows in the TCN order
    const float* bias;         // [U, nb*S]
    const float* move_in;      // [N, T, S]
    const uint8_t* choices;    // [N, T, S]
    const float* cs;           // [N, T]
    const float* logz;         // [N]
    const int* end_state;      // [N]
    uint8_t* seq;              // [N, T] each
    uint8_t* qstr;
    uint8_t* mvout;
    int Th, N, U, ring;
    float p_stay, qscale, qbias;
    HeadOps ops;
};

// Kernel J on a ring of chunks (FB encoder frames, fu = FB*U output frames,
// taken in the pass's order: iteration j is chunk nchunk-1-j): a CTA of JRB
// batch rows, S = JS states, H = 16 KT, MT m-tiles of the head's
// U * nb*S rows a head warp. Warps, in order: JCW consumers (a row each,
// JSPT states a thread), JHW head warps, the producer, the epilogue warp:
// 18, so 96 registers a thread (ceil(18 / 4) warps on each of an SM's four
// register files).
template <int KT, int MT>
__global__ void __launch_bounds__(JWARPS * 32, 1)
decode_fused_bwd_ring(const JArgs a)
{
    constexpr int S = JS, R = S / NB, Cm = NB * S, H = 16 * KT;
    constexpr int U = MT * JHW * 16 / Cm;  // the upsample phases
    static_assert(U * Cm == MT * JHW * 16, "the head warps take every row");
    constexpr int NRUN = S / 32;    // runs of 32 states (row_sum_max's)
    constexpr int REC = jrec(S);
    extern __shared__ __align__(128) unsigned char jsm[];
    constexpr JLayout L(S, H, U, 0);  // the ring's depth is a.ring
    uint64_t* full = reinterpret_cast<uint64_t*>(jsm);
    uint64_t* empty = full + a.ring;
    uint64_t* tfull = empty + a.ring;  // [2]: a chunk's exps are written
    uint64_t* tempty = tfull + 2;      // [2]: ... read, and its records
    uint64_t* rfull = tempty + 2;      // [2]: a chunk's records are written
    float* beta = reinterpret_cast<float*>(jsm + L.off_beta);
    float* rec = reinterpret_cast<float*>(jsm + L.off_rec);
    float* tile = reinterpret_cast<float*>(jsm + L.off_tile);
    unsigned char* ring = jsm + L.off_ring;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n0 = blockIdx.x * JRB;
    const int live = min(JRB, a.N - n0);
    constexpr int fu = L.fu;
    const int T = a.Th * U;
    const int nchunk = (a.Th + FB - 1) / FB;
    const unsigned consumers = 32u * live;  // the live rows' warps

    // frame T in parity 1: beta 1 (raw), read through a max of 1
    for (int e = tid; e < JRB * S; e += blockDim.x) beta[JRB * S + e] = 1.f;
    if (tid == 0) {
        for (int s = 0; s < a.ring; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 32 * JHW + consumers);
        }
        for (int b = 0; b < 2; ++b) {
            mbar_init(tfull + b, 32 * JHW);
            mbar_init(tempty + b, consumers + 32);
            mbar_init(rfull + b, consumers);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (w == JCW + JHW) {
        // ------------------------------------------------- producer warp
        // chunk j's h rows and its rows' move-in and choices into slot
        // j % ring once the chunk before in that slot is read
        if (lane == 0 && !jcut(JCUT_WAITS)) {
            Cursor cur = {0, 0, a.ring};
            for (int it = 0; it < nchunk; ++it) {
                const int th0 = (nchunk - 1 - it) * FB;
                const int nf = min(FB, a.Th - th0), t0 = th0 * U, nt = nf * U;
                if (it >= a.ring)
                    mbar_wait(empty + cur.slot, (unsigned)(cur.phase ^ 1));
                unsigned char* slot = ring + cur.slot * L.slot_bytes;
                const unsigned hb = (unsigned)(live * H * 2);
                const unsigned mb = (unsigned)(nt * S * 4);
                const unsigned cb = (unsigned)(nt * S);
                fill(full + cur.slot, slot, nf * hb + live * (mb + cb),
                     it >= a.ring, a.h + ((size_t)th0 * a.N + n0) * H, hb);
                for (int f = 1; f < nf; ++f)
                    bulk_copy(slot + f * JRB * H * 2,
                              a.h + ((size_t)(th0 + f) * a.N + n0) * H, hb,
                              full + cur.slot);
                for (int r = 0; r < live; ++r) {
                    const size_t fr = ((size_t)(n0 + r) * T + t0) * S;
                    bulk_copy(slot + L.slot_h + r * fu * S * 4,
                              a.move_in + fr, mb, full + cur.slot);
                    bulk_copy(slot + L.slot_h + L.slot_min + r * fu * S,
                              a.choices + fr, cb, full + cur.slot);
                }
                cur.next();
            }
        }
        return;
    }
    if (w == JCW + JHW + 1) {
        // ------------------------------------------------ epilogue warp
        // lane r: row r's posterior, qscore and three bytes a frame, from
        // the records its consumers leave, a chunk behind them at most
        const bool on = lane < live;
        const int n = n0 + (on ? lane : 0);
        const float lz = on ? a.logz[n] : 0.f;
        float d = 0.f;
        for (int it = 0; it < nchunk; ++it) {
            const int th0 = (nchunk - 1 - it) * FB, b = it & 1;
            const int nt = min(FB, a.Th - th0) * U, t0 = th0 * U;
            float cv[JFU];
#pragma unroll
            for (int q = 0; q < JFU; ++q)
                cv[q] = on && q < nt ? a.cs[(size_t)n * T + t0 + q] : 0.f;
            mbar_wait(rfull + b, (unsigned)((it >> 1) & 1));
            const float* rr =
                rec + (size_t)(b * JRB + (on ? lane : 0)) * fu * REC;
#pragma unroll
            for (int q = JFU - 1; q >= 0; --q) {
                if (q >= nt) continue;
                const float* r = rr + q * REC;
                // row_sum_max's sum: the runs' butterflies in order from 0
                float bmass = r[0];
                if (NRUN > 1) {
                    bmass = 0.f;
#pragma unroll
                    for (int k = 0; k < NRUN; ++k) bmass += r[k];
                }
                const float mx = r[NRUN];
                const int trace = __float_as_int(r[REC - 1]);
                if (on && !jcut(JCUT_EPILOGUE)) {
                    const bool is_move = (trace & 255) != 0;
                    const int base = trace >> 8;
                    const float prob = bmass * expf(cv[q] + d - lz);
                    const float err = fminf(fmaxf(1.f - prob, 1e-4f), 1.f);
                    const float qv = -10.f * log10f(err) * a.qscale + a.qbias;
                    const int qc = (int)rintf(qv) + 33;
                    const size_t o = (size_t)n * T + t0 + q;
                    a.seq[o] = is_move ? (uint8_t)base : (uint8_t)0;
                    a.qstr[o] = is_move ? (uint8_t)qc : (uint8_t)0;
                    a.mvout[o] = is_move ? 1 : 0;
                }
                d += logf(mx);
            }
            mbar_arrive(tempty + b);
        }
        return;
    }
    if (w >= JCW) {
        // ---------------------------------------------------- head warps
        // m-tiles hw*MT .. hw*MT + MT-1 of the head's U * nb*S rows, their
        // weights in registers: the exps of chunk j's move scores into tile
        // j & 1 while the consumers walk chunk j - 1
        const int hw = w - JCW, g = lane >> 2, tig = lane & 3;
        uint32_t wa[MT][KT][4];
        const uint32_t* wv = reinterpret_cast<const uint32_t*>(a.w);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int M = (hw * MT + mt) * 16 + g;
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                const int k = 16 * kt + 2 * tig;
                wa[mt][kt][0] = wv[((size_t)M * H + k) / 2];
                wa[mt][kt][1] = wv[((size_t)(M + 8) * H + k) / 2];
                wa[mt][kt][2] = wv[((size_t)M * H + k + 8) / 2];
                wa[mt][kt][3] = wv[((size_t)(M + 8) * H + k + 8) / 2];
            }
        }
        for (int it = 0; it < nchunk; ++it) {
            const int b = it & 1, slot = it % a.ring;
            const int nf = min(FB, a.Th - (nchunk - 1 - it) * FB);
            if (!jcut(JCUT_WAITS))
                mbar_wait(full + slot, (unsigned)((it / a.ring) & 1));
            if (it >= 2)
                mbar_wait(tempty + b, (unsigned)(((it - 2) >> 1) & 1));
            const bf16* hs =
                reinterpret_cast<const bf16*>(ring + slot * L.slot_bytes);
            float* tb = tile + (size_t)b * fu * JRB * L.ldt;
#pragma unroll 1
            for (int f = 0; f < nf && !jcut(JCUT_HEAD); ++f) {
                // head_product's sums: the same HMMA, k-tiles in order from 0
                float acc[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
                const bf16* rows = hs + (f * JRB + (lane & 7)) * H
                                   + 8 * ((lane >> 3) & 1);
#pragma unroll
                for (int kt = 0; kt < KT; ++kt) {
                    uint32_t b0, b1;
                    ldmatrix_x2(b0, b1, rows + 16 * kt);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        mma_bf16(acc[mt], wa[mt][kt], b0, b1);
                }
                // element (row g (+8) of the tile, batch row 2 tig (+1))
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int M = (hw * MT + mt) * 16 + g;
                    const int p = U == 1 ? 0 : M / Cm;
                    const int m = U == 1 ? M : M % Cm;
                    const float z0 = __ldg(a.bias + M);
                    const float z8 = __ldg(a.bias + M + 8);
                    float* o = tb + (size_t)((f * U + p) * JRB + 2 * tig)
                                        * L.ldt + m;
                    o[0] = expf(head_act(acc[mt][0] + z0, a.ops));
                    o[L.ldt] = expf(head_act(acc[mt][1] + z0, a.ops));
                    o[8] = expf(head_act(acc[mt][2] + z8, a.ops));
                    o[L.ldt + 8] = expf(head_act(acc[mt][3] + z8, a.ops));
                }
            }
            mbar_arrive(empty + slot);
            mbar_arrive(tfull + b);
        }
        return;
    }

    // -------------------------------------------------------- consumers
    // warp `row`: predecessors p = 32 i + lane, the earlier kernel's f32
    // steps; the warp meets at __syncwarp once a frame
    const int row = w;
    if (row >= live) return;
    int state = a.end_state[n0 + row];
    float inv = 1.f;  // 1 / the row's max of the frame before
    Cursor cur = {0, 0, a.ring};
    int par = 0;  // the parity the next frame writes
    for (int it = 0; it < nchunk; ++it) {
        const int b = it & 1;
        const int nt = min(FB, a.Th - (nchunk - 1 - it) * FB) * U;
        if (!jcut(JCUT_WAITS)) mbar_wait(full + cur.slot, (unsigned)cur.phase);
        mbar_wait(tfull + b, (unsigned)((it >> 1) & 1));
        const unsigned char* slot = ring + cur.slot * L.slot_bytes;
        const float* mins = reinterpret_cast<const float*>(slot + L.slot_h)
                            + (size_t)row * fu * S;
        const uint8_t* chs = slot + L.slot_h + L.slot_min
                             + (size_t)row * fu * S;
        const float* tb = tile + (size_t)b * fu * JRB * L.ldt;
        float* rr = rec + (size_t)(b * JRB + row) * fu * REC;
        for (int q = nt - 1; q >= 0; --q) {
            const float* Bp = beta + ((par ^ 1) * JRB + row) * S;
            float* Bn = beta + (par * JRB + row) * S;
            // traceback, the same in every thread of the row
            const int choice = jcut(JCUT_WAITS) ? 0 : chs[q * S + state];
            const int base = state % NB + 1;
            const float* er = tb + (size_t)(q * JRB + row) * L.ldt;
            float braw[JSPT], v[JSPT], lmax = 0.f;
#pragma unroll
            for (int i = 0; i < JSPT; ++i) {
                const int ps = 32 * i + lane, rs = ps % R;
                // beta of frame t+1 normalised as the earlier kernel stored it
                const float4 sr =
                    *reinterpret_cast<const float4*>(Bp + NB * rs);
                const float Bs[4] = {__fmul_rn(sr.x, inv), __fmul_rn(sr.y, inv),
                                     __fmul_rn(sr.z, inv),
                                     __fmul_rn(sr.w, inv)};
                const float Bc = __fmul_rn(Bp[ps], inv);
                float vv = 0.f;
                if (ps % NB == base - 1) vv = mins[q * S + ps] * Bc;
                float acc = 0.f;
#pragma unroll
                for (int bb = 0; bb < NB; ++bb) acc += er[bb * S + ps] * Bs[bb];
                braw[i] = a.p_stay * Bc + acc;
                v[i] = vv;
                lmax = fmaxf(lmax, braw[i]);
            }
            // raw values are never negative: a warp's max on the bits
            const float wmax = __uint_as_float(
                __reduce_max_sync(0xffffffffu, __float_as_uint(lmax)));
#pragma unroll
            for (int i = 0; i < JSPT; ++i) Bn[32 * i + lane] = braw[i];
            // the mass: row_sum_max's butterfly over each run of 32 states
            float run[JSPT];
#pragma unroll
            for (int i = 0; i < JSPT; ++i) {
                float x = v[i];
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    x += __shfl_xor_sync(0xffffffffu, x, o);
                run[i] = x;
            }
            if (lane == 0) {
                float* r = rr + q * REC;
#pragma unroll
                for (int i = 0; i < JSPT; ++i) r[i] = run[i];
                r[NRUN] = wmax;
                r[REC - 1] = __int_as_float(choice | base << 8);
            }
            inv = 1.f / wmax;
            if (choice != 0) state = state / NB + (choice - 1) * R;
            if (jcut(JCUT_WAITS)) state %= S;
            par ^= 1;
            __syncwarp();
        }
        mbar_arrive(empty + cur.slot);
        mbar_arrive(tempty + b);
        mbar_arrive(rfull + b);
        cur.next();
    }
}

template <int KT, int MT>
int launch_j_ring(const JArgs& a, int H, int S, void* stream) {
    const JLayout L(S, H, a.U, a.ring);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const auto kernel = decode_fused_bwd_ring<KT, MT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(a.N + JRB - 1) / JRB, JWARPS * 32, L.total,
             static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// the instances built: S 64, H 32 or 96, U 1 or 2 (MT = U*S / 32 m-tiles a
// head warp); H 96 at U 2 would keep 96 registers of weights a thread and
// is not built
int launch_j_ring(const JArgs& a, int H, int S, void* stream) {
    if (S != JS) return (int)cudaErrorInvalidValue;
    switch ((H / 16) * 10 + a.U) {
    case 21: return launch_j_ring<2, 2>(a, H, S, stream);
    case 22: return launch_j_ring<2, 4>(a, H, S, stream);
    case 61: return launch_j_ring<6, 2>(a, H, S, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

// ------------------------------------------------- kernel G on the ring
// the parts scripts/decode_split.py g leaves out (G_CUT bits)
constexpr int GCUT_HEAD = 1;     // the head warps' products, scores, exps
constexpr int GCUT_WAITS = 2;    // the ring's copies and the waits for them
constexpr int GCUT_STORES = 4;   // the consumers' stores of move-in,
                                 // choices and c

__device__ __forceinline__ constexpr bool gcut(int part) {
    return (G_CUT & part) != 0;
}

constexpr int GFU = 4;  // output frames a chunk: 4 / U encoder frames
constexpr int GCW = JRB;       // consumer warps: one a row
constexpr int GSPT = JS / 32;  // states a consumer thread
constexpr int GWARPS = GCW + JHW + 1;  // and the producer

// Shared memory, in bytes from its start: the mbarriers; alpha (raw) and
// the max semiring's scores of two parities ([2][JRB][S] float2); two
// chunks' tiles of each move's score and its exp ([2][GFU][JRB][ldt]
// float2, rows of the head's (j, s) order); the ring of chunks, each slot
// the chunk's h rows ([GFU / U][JRB][H] bf16).
struct GLayout {
    int ldt, slot_bytes, off_state, off_tile, off_ring, total;
    __host__ __device__ constexpr GLayout(int S, int H, int U, int ring)
        : ldt(NB * S + 2),
          slot_bytes(round_up(GFU / U * JRB * H * 2, 128)),
          off_state(256),
          off_tile(off_state + round_up(2 * JRB * S * 8, 128)),
          off_ring(off_tile + round_up(2 * GFU * JRB * (NB * S + 2) * 8, 128)),
          total(off_ring + ring * round_up(GFU / U * JRB * H * 2, 128)) {}
};

struct GArgs {
    const bf16* h;             // [Th, N, H]
    const bf16* w;             // [U, (j, s), H]
    const float* bias;         // [U, (j, s)]
    float* move_in;            // [N, T, S]
    uint8_t* choices;          // [N, T, S]
    float* cs;                 // [N, T]
    float* logz;               // [N]
    int* end_state;            // [N]
    int Th, N, U, ring;
    float p_stay, blank;
    HeadOps ops;
};

// Kernel G on a ring of chunks (GFU / U encoder frames, GFU output frames,
// in the pass's order): a CTA of JRB batch rows, S = JS states, H = 16 KT,
// MT m-tiles of the head's U * nb*S rows a head warp. Warps, in order: GCW
// consumers (a row each, GSPT states a thread), JHW head warps, the
// producer: 17, so 96 registers a thread.
template <int KT, int MT>
__global__ void __launch_bounds__(GWARPS * 32, 1)
decode_fused_fwd_ring(const GArgs a)
{
    constexpr int S = JS, R = S / NB, Cm = NB * S, H = 16 * KT;
    constexpr int U = MT * JHW * 16 / Cm;  // the upsample phases
    static_assert(U * Cm == MT * JHW * 16, "the head warps take every row");
    constexpr int FB = GFU / U;            // encoder frames a chunk
    extern __shared__ __align__(128) unsigned char gsm[];
    constexpr GLayout L(S, H, U, 0);  // the ring's depth is a.ring
    uint64_t* full = reinterpret_cast<uint64_t*>(gsm);
    uint64_t* empty = full + a.ring;
    uint64_t* tfull = empty + a.ring;  // [2]: a chunk's tile is written
    uint64_t* tempty = tfull + 2;      // [2]: ... and read
    float2* st = reinterpret_cast<float2*>(gsm + L.off_state);
    float2* tile = reinterpret_cast<float2*>(gsm + L.off_tile);
    unsigned char* ring = gsm + L.off_ring;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n0 = blockIdx.x * JRB;
    const int live = min(JRB, a.N - n0);
    const int T = a.Th * U;
    const int nchunk = (a.Th + FB - 1) / FB;

    // frame -1 in parity 1: alpha 1 (raw, read through a max of 1), the
    // max semiring's scores 0
    for (int e = tid; e < JRB * S; e += blockDim.x)
        st[JRB * S + e] = make_float2(1.f, 0.f);
    if (tid == 0) {
        for (int s = 0; s < a.ring; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 32 * JHW);
        }
        for (int b = 0; b < 2; ++b) {
            mbar_init(tfull + b, 32 * JHW);
            mbar_init(tempty + b, 32u * live);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (w == GCW + JHW) {
        // ------------------------------------------------- producer warp
        // chunk j's h rows into slot j % ring once the head warps have
        // read the chunk before in that slot
        if (lane == 0 && !gcut(GCUT_WAITS)) {
            Cursor cur = {0, 0, a.ring};
            for (int it = 0; it < nchunk; ++it) {
                const int th0 = it * FB, nf = min(FB, a.Th - th0);
                if (it >= a.ring)
                    mbar_wait(empty + cur.slot, (unsigned)(cur.phase ^ 1));
                unsigned char* slot = ring + cur.slot * L.slot_bytes;
                const unsigned hb = (unsigned)(live * H * 2);
                fill(full + cur.slot, slot, nf * hb, it >= a.ring,
                     a.h + ((size_t)th0 * a.N + n0) * H, hb);
                for (int f = 1; f < nf; ++f)
                    bulk_copy(slot + f * JRB * H * 2,
                              a.h + ((size_t)(th0 + f) * a.N + n0) * H, hb,
                              full + cur.slot);
                cur.next();
            }
        }
        return;
    }
    if (w >= GCW) {
        // ---------------------------------------------------- head warps
        // m-tiles hw*MT .. hw*MT + MT-1 of the head's U * nb*S rows, their
        // weights and biases in registers: chunk j's move scores and their
        // exps into tile j & 1 while the consumers walk chunk j - 1
        const int hw = w - GCW, g = lane >> 2, tig = lane & 3;
        uint32_t wa[MT][KT][4];
        float z[MT][2];
        const uint32_t* wv = reinterpret_cast<const uint32_t*>(a.w);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
            const int M = (hw * MT + mt) * 16 + g;
            z[mt][0] = __ldg(a.bias + M);
            z[mt][1] = __ldg(a.bias + M + 8);
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                const int k = 16 * kt + 2 * tig;
                wa[mt][kt][0] = wv[((size_t)M * H + k) / 2];
                wa[mt][kt][1] = wv[((size_t)(M + 8) * H + k) / 2];
                wa[mt][kt][2] = wv[((size_t)M * H + k + 8) / 2];
                wa[mt][kt][3] = wv[((size_t)(M + 8) * H + k + 8) / 2];
            }
        }
        for (int it = 0; it < nchunk; ++it) {
            const int b = it & 1, slot = it % a.ring;
            const int nf = min(FB, a.Th - it * FB);
            if (!gcut(GCUT_WAITS))
                mbar_wait(full + slot, (unsigned)((it / a.ring) & 1));
            if (it >= 2)
                mbar_wait(tempty + b, (unsigned)(((it - 2) >> 1) & 1));
            const bf16* hs =
                reinterpret_cast<const bf16*>(ring + slot * L.slot_bytes);
            float2* tb = tile + (size_t)b * GFU * JRB * L.ldt;
#pragma unroll 1
            for (int f = 0; f < nf && !gcut(GCUT_HEAD); ++f) {
                // head_product's sums: the same HMMA, k-tiles in order from 0
                float acc[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
                const bf16* rows = hs + (f * JRB + (lane & 7)) * H
                                   + 8 * ((lane >> 3) & 1);
#pragma unroll
                for (int kt = 0; kt < KT; ++kt) {
                    uint32_t b0, b1;
                    ldmatrix_x2(b0, b1, rows + 16 * kt);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt)
                        mma_bf16(acc[mt], wa[mt][kt], b0, b1);
                }
                // element (row g (+8) of the tile, batch row 2 tig (+1)):
                // the earlier G's score head_act(sum + bias) and its exp
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int M = (hw * MT + mt) * 16 + g;
                    const int p = U == 1 ? 0 : M / Cm;
                    const int m = U == 1 ? M : M % Cm;
                    float2* o = tb + (size_t)((f * U + p) * JRB + 2 * tig)
                                         * L.ldt + m;
                    const float v[4] = {
                        head_act(acc[mt][0] + z[mt][0], a.ops),
                        head_act(acc[mt][1] + z[mt][0], a.ops),
                        head_act(acc[mt][2] + z[mt][1], a.ops),
                        head_act(acc[mt][3] + z[mt][1], a.ops)};
                    o[0] = make_float2(v[0], expf(v[0]));
                    o[L.ldt] = make_float2(v[1], expf(v[1]));
                    o[8] = make_float2(v[2], expf(v[2]));
                    o[L.ldt + 8] = make_float2(v[3], expf(v[3]));
                }
            }
            mbar_arrive(empty + slot);
            mbar_arrive(tfull + b);
        }
        return;
    }

    // -------------------------------------------------------- consumers
    // warp w: row w, states s = 32 i + lane, the earlier G's f32 steps; the
    // warp meets at __syncwarp once a frame
    if (w >= live) return;
    const int n = n0 + w;
    float rmax = 1.f;  // 1 / the row's max of the frame before
    float c = 0.f;
    int par = 0;  // the parity the next frame writes
    for (int it = 0; it < nchunk; ++it) {
        const int b = it & 1;
        const int nt = min(FB, a.Th - it * FB) * U, t0 = it * GFU;
        mbar_wait(tfull + b, (unsigned)((it >> 1) & 1));
        const float2* tb = tile + (size_t)b * GFU * JRB * L.ldt;
        for (int q = 0; q < nt; ++q) {
            const float2* Ap = st + ((par ^ 1) * JRB + w) * S;
            float2* An = st + (par * JRB + w) * S;
            const float2* er = tb + (size_t)(q * JRB + w) * L.ldt;
            float araw[GSPT], accs[GSPT], amx[GSPT], lmax = 0.f;
            int ch[GSPT];
#pragma unroll
            for (int i = 0; i < GSPT; ++i) {
                const int s = 32 * i + lane, r = s / NB;
                float acc = 0.f, best = 0.f;
                int jbest = 0;
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    const float2 me = er[j * S + s];     // score, exp
                    const float2 ax = Ap[j * R + r];     // alpha raw, amax
                    // alpha of the frame before normalised as the earlier
                    // kernel stored it
                    const float Aq = __fmul_rn(ax.x, rmax);
                    acc += me.y * Aq;
                    const float cand = me.x + ax.y;
                    if (j == 0 || cand > best) { best = cand; jbest = j; }
                }
                const float2 as = Ap[s];
                araw[i] = a.p_stay * __fmul_rn(as.x, rmax) + acc;
                const float stay_m = a.blank + as.y;
                const bool is_move = best > stay_m;
                amx[i] = is_move ? best : stay_m;
                ch[i] = is_move ? jbest + 1 : 0;
                accs[i] = acc;
                lmax = fmaxf(lmax, araw[i]);
            }
            // raw values are never negative: a warp's max on the bits
            const float wmax = __uint_as_float(
                __reduce_max_sync(0xffffffffu, __float_as_uint(lmax)));
#pragma unroll
            for (int i = 0; i < GSPT; ++i)
                An[32 * i + lane] = make_float2(araw[i], amx[i]);
            rmax = 1.f / wmax;
            c += logf(wmax);
            if (!gcut(GCUT_STORES)) {
                const size_t o = ((size_t)n * T + t0 + q) * S + lane;
#pragma unroll
                for (int i = 0; i < GSPT; ++i) {
                    a.move_in[o + 32 * i] = accs[i] * rmax;
                    a.choices[o + 32 * i] = (uint8_t)ch[i];
                }
                if (lane == 0) a.cs[(size_t)n * T + t0 + q] = c;
            }
            __syncwarp();
            par ^= 1;
        }
        mbar_arrive(tempty + b);
    }
    // logZ from the last alpha as the earlier kernel stored it (row_sum_max's
    // sum: each run of 32 states' butterfly, the runs in order from 0) and
    // the first argmax of the max semiring's scores
    const float2* Ap = st + ((par ^ 1) * JRB + w) * S;
    float sum = 0.f, v = -INFINITY;
    int idx = INT_MAX;
#pragma unroll
    for (int i = 0; i < GSPT; ++i) {
        const float2 x = Ap[32 * i + lane];
        float run = __fmul_rn(x.x, rmax);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            run += __shfl_xor_sync(0xffffffffu, run, o);
        sum += run;
        if (i == 0 || x.y > v) { v = x.y; idx = 32 * i + lane; }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, v, o);
        const int i2 = __shfl_xor_sync(0xffffffffu, idx, o);
        if (v2 > v || (v2 == v && i2 < idx)) { v = v2; idx = i2; }
    }
    if (lane == 0) {
        a.logz[n] = logf(sum) + c;
        a.end_state[n] = idx;
    }
}

template <int KT, int MT>
int launch_g_ring(const GArgs& a, int H, int S, void* stream) {
    const GLayout L(S, H, a.U, a.ring);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const auto kernel = decode_fused_fwd_ring<KT, MT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(a.N + JRB - 1) / JRB, GWARPS * 32, L.total,
             static_cast<cudaStream_t>(stream)>>>(a);
    return (int)cudaGetLastError();
}

// J's instances: S 64, H 32 or 96, U 1 or 2 (MT = U*S / 32)
int launch_g_ring(const GArgs& a, int H, int S, void* stream) {
    if (S != JS) return (int)cudaErrorInvalidValue;
    switch ((H / 16) * 10 + a.U) {
    case 21: return launch_g_ring<2, 2>(a, H, S, stream);
    case 22: return launch_g_ring<2, 4>(a, H, S, stream);
    case 61: return launch_g_ring<6, 2>(a, H, S, stream);
    default: return (int)cudaErrorInvalidValue;
    }
}

bool bad_shape(int Th, int N, int H, int S, int U) {
    return Th < 1 || N < 1 || U < 1 || S < NB || S % NB != 0 || S > 256
        || (S < 32 && (S & (S - 1)) != 0) || (S >= 32 && S % 32 != 0)
        || H < 16 || H % 16 != 0 || H > 256;
}

// The layout with the weights in shared memory if that fits, else without;
// total > SMEM_LIMIT if neither does.
Layout pick_layout(int H, int S, int U, bool backward, bool& resident) {
    resident = true;
    Layout L(H, S, U, resident, backward);
    if (L.total > SMEM_LIMIT) {
        resident = false;
        L = Layout(H, S, U, resident, backward);
    }
    return L;
}

}  // namespace

extern "C" {

// Kernel G. h [Th, N, H] bf16; w [U, nb*S, H] bf16 with each phase's rows
// regrouped as (j, s) (row j*S + s is the move into s from j*R + s/nb), at a
// 32-byte address; bias [U, nb*S] f32 in the same order -> move_in
// [N, T, S] f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32,
// end_state [N] int32, T = Th*U.
int decode_fused_fwd_bf16(const void* h, const void* w, const void* bias,
                          void* move_in, void* choices, void* c, void* logz,
                          void* end_state, int Th, int N, int H, int S, int U,
                          float p_stay, float blank, int act_tanh,
                          float scale, int clamp, float cmin, float cmax,
                          void* stream) {
    if (bad_shape(Th, N, H, S, U)) return (int)cudaErrorInvalidValue;
    bool resident;
    const Layout L = pick_layout(H, S, U, false, resident);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const auto kernel = resident ? decode_fused_fwd<true>
                                 : decode_fused_fwd<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    kernel<<<(N + RB - 1) / RB, threads_for(S), L.total,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<float*>(move_in),
        static_cast<uint8_t*>(choices), static_cast<float*>(c),
        static_cast<float*>(logz), static_cast<int*>(end_state), Th, N, H, S,
        U, p_stay, blank, ops);
    return (int)cudaGetLastError();
}

// Kernel G on the ring (ops/decode_fused_cuda.py:fused_decode_plan's
// "fwd"): the arguments of decode_fused_fwd_bf16 with the ring's depth (2
// to JRING_MAX chunks) after U; h at a 16-byte address, w at a 4-byte one.
// Refuses (cudaErrorInvalidValue) what no instance takes.
int decode_fused_fwd_ring_bf16(const void* h, const void* w, const void* bias,
                               void* move_in, void* choices, void* c,
                               void* logz, void* end_state, int Th, int N,
                               int H, int S, int U, int ring, float p_stay,
                               float blank, int act_tanh, float scale,
                               int clamp, float cmin, float cmax,
                               void* stream) {
    if (Th < 1 || N < 1 || U < 1 || U > JUMAX || ring < 2
        || ring > JRING_MAX || !aligned16(h)
        || (reinterpret_cast<uintptr_t>(w) & 3))
        return (int)cudaErrorInvalidValue;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    const GArgs a = {static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     static_cast<const float*>(bias),
                     static_cast<float*>(move_in),
                     static_cast<uint8_t*>(choices), static_cast<float*>(c),
                     static_cast<float*>(logz), static_cast<int*>(end_state),
                     Th, N, U, ring, p_stay, blank, ops};
    return launch_g_ring(a, H, S, stream);
}

// Kernel J. h as for G; w and bias in the TCN (b, j, r) row order; G's
// outputs -> sequence, qstring, moves_out, each [N, T] uint8.
int decode_fused_bwd_bf16(const void* h, const void* w, const void* bias,
                          const void* move_in, const void* choices,
                          const void* c, const void* logz,
                          const void* end_state, void* seq, void* qstr,
                          void* mvout, int Th, int N, int H, int S, int U,
                          float p_stay, float qscale, float qbias,
                          int act_tanh, float scale, int clamp, float cmin,
                          float cmax, void* stream) {
    if (bad_shape(Th, N, H, S, U)) return (int)cudaErrorInvalidValue;
    bool resident;
    const Layout L = pick_layout(H, S, U, true, resident);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const auto kernel = resident ? decode_fused_bwd<true>
                                 : decode_fused_bwd<false>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    kernel<<<(N + RB - 1) / RB, threads_for(S), L.total,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(w),
        static_cast<const float*>(bias), static_cast<const float*>(move_in),
        static_cast<const uint8_t*>(choices), static_cast<const float*>(c),
        static_cast<const float*>(logz), static_cast<const int*>(end_state),
        static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
        static_cast<uint8_t*>(mvout), Th, N, H, S, U, p_stay, qscale, qbias,
        ops);
    return (int)cudaGetLastError();
}

// Kernel J on the ring (ops/decode_fused_cuda.py:fused_decode_plan): the
// arguments of decode_fused_bwd_bf16 with the ring's depth (2 to JRING_MAX
// chunks) after U; h, move_in and choices at
// 16-byte addresses, w at a 4-byte one. Refuses (cudaErrorInvalidValue)
// what no instance takes.
int decode_fused_bwd_ring_bf16(const void* h, const void* w, const void* bias,
                               const void* move_in, const void* choices,
                               const void* c, const void* logz,
                               const void* end_state, void* seq, void* qstr,
                               void* mvout, int Th, int N, int H, int S,
                               int U, int ring, float p_stay,
                               float qscale, float qbias, int act_tanh,
                               float scale, int clamp, float cmin,
                               float cmax, void* stream) {
    if (Th < 1 || N < 1 || U < 1 || U > JUMAX || ring < 2
        || ring > JRING_MAX || !aligned16(h) || !aligned16(move_in)
        || !aligned16(choices) || (reinterpret_cast<uintptr_t>(w) & 3))
        return (int)cudaErrorInvalidValue;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    const JArgs a = {static_cast<const bf16*>(h), static_cast<const bf16*>(w),
                     static_cast<const float*>(bias),
                     static_cast<const float*>(move_in),
                     static_cast<const uint8_t*>(choices),
                     static_cast<const float*>(c),
                     static_cast<const float*>(logz),
                     static_cast<const int*>(end_state),
                     static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
                     static_cast<uint8_t*>(mvout), Th, N, U, ring, p_stay,
                     qscale, qbias, ops};
    return launch_j_ring(a, H, S, stream);
}

}  // extern "C"
