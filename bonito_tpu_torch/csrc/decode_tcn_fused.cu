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
// Design: a block owns RB = 4 batch rows (256 blocks at N = 1024, two to an
// SM) with one thread per (row, state). The head product does not depend on
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
// Later work: the next chunk's head product overlapped with this chunk's
// recursion (two warp groups), and S > 256 (a row per block or per cluster).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <climits>
#include <cmath>
#include <cstdint>

using namespace nvcuda;

namespace {

constexpr int NB = 4;
constexpr int RB = 4;               // batch rows per block
constexpr int FB = 4;               // encoder frames per chunk
constexpr int NCOL = RB * FB;       // the n of a 16x16x16 tile
constexpr int PAD = 8;              // bf16 values: 16 bytes per padded row
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may ask for

typedef __nv_bfloat16 bf16;

struct HeadOps {
    int act_tanh;
    float scale;
    int clamp;
    float cmin, cmax;
};

__host__ __device__ inline int round_up(int v, int m) {
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

}  // extern "C"
