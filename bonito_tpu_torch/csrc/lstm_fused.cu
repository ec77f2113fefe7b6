// Kernel F: an LSTM layer with its input projection inside.
//
// Replaces bonito_tpu/ops/lstm_pallas.py:lstm_pallas_fused
// (`_lstm_kernel_fused`), the layer of every small-H model (fast: C = H = 96,
// N = 1024, T = 1200). From x [T, N, C] bf16, W_ih [C, 4H] and W_hh [H, 4H]
// bf16 and b [4H] f32, each step computes
//
//     xw    = x[t] @ W_ih            (f32 accumulation, kept in f32)
//     gates = xw + bf16(h) @ W_hh + b             (f32)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//     c = f*c + i*g;  h = o*tanh(c);  out[t] = bf16(h)
//
// with c in f32. The bf16 rounding of h is all that the next step's product
// and the output read, so h is carried as bf16. xw never leaves the block:
// neither the [T, N, 4H] gate-input tensor nor its rounding to bf16 (what
// projection + kernel A would give) exists. `reverse` walks t = T-1 .. 0 and
// writes each step at its own index.
//
// What bounds it on an H100: at fast widths a layer is 2*N*T*(C+H)*4H =
// 1.8e11 tensor-core operations (0.18 ms at 989 TFLOP/s) against 0.47 GB of
// x in and h out (0.14 ms at 3.35 TB/s) -- but the recurrence is serial in T,
// so what bounds the design is the time of one step.
//
// Two kernels, one launch per layer each and no grid-wide barrier: batch
// rows do not depend on each other, so a block owns 8 rows for all T steps
// (128 blocks at N = 1024, one wave of the 132 SMs) and loops over time.
//
// lstm_fused_mma_kernel<KX, KH> (C = 16 KX, H = 16 KH; the shapes
// ops/lstm_fused_cuda.py:fused_plan takes, fast's among them): H / 8 warps,
// each owning 8 hidden units of all 8 rows, with the gate math in the
// product's registers. It takes W_ih and W_hh as the earlier kernel does
// and loads its A fragments once, with the gate columns permuted (row
// 32w + 8k + r of its A operand is gate k of unit 8w + r: column k H + 8w +
// r of W, ops/lstm_fused_cuda.py:gate_columns), so that in mma.sync
// m16n8k16 (gate columns on m, the 8 rows on n) the two m-tiles of warp w
// leave i, f (tile 0, rows g and g + 8) and g, o (tile 1) of unit 8w + g
// for rows 2 tig and 2 tig + 1 in one thread's accumulators.
// That thread adds them, does the gate math with c in registers and writes
// bf16 h into one of two buffers in shared memory, which the next step's
// h product reads with ldmatrix; one block barrier a step. The weights stay
// in registers for the whole layer ((C + H) / 2 a thread: 96 at fast). The
// x product does not depend on h, so step t + 1's is issued into a second
// set of accumulators right after step t's h product and overlaps the gate
// math; the x rows arrive PF steps ahead by cp.async into a ring. The x and
// h sums stay apart, each in k order from zero, and the gate math takes the
// earlier kernel's f32 steps, so h equals its output bit for bit (the
// 32x8x16 WMMA tiles and m16n8k16 run the same HMMA, HMMA.16816.F32.BF16,
// over the same k; nvcc contracts the earlier kernel's c update into one
// fma, written out in gate_step). On an H100 at fast widths it takes about
// 1.44 ms a layer (1.2 us a step) against the earlier kernel's 1.95: the
// gate math (10 accurate expf/tanhf-based values a thread a step) sets the
// pace, then the products on the tensor cores (PERF.md).
//
// lstm_fused_bf16_kernel<KX, KH> (the earlier kernel, every other shape and
// the in-run comparison): per step a warp owns 32 gate columns: 32x8x16 bf16
// WMMA products with the gate columns on the m side and the 8 batch rows on
// the n side, one accumulator for the x product and one for the h product,
// summed and stored to a f32 gate tile in shared memory; after a barrier
// every thread does the gate math of its (row, unit) pairs, keeps c in
// shared memory and writes bf16 h; two block barriers a step. At C = H = 96
// its weight fragments stay in registers; any other shape reads them
// through L2 every step (the <0, 0> instance). Its first version held both
// weights in the block's shared memory and reloaded the fragments every
// step: 4.4 ms a layer on an H100 at fast widths against 2.0 ms with them in
// registers (PERF.md).
//
// lstm_fused_f32_kernel<KH>: F's earlier f32 kernel, the same function in
// f32 on the f32 cores, described where it is defined below. An f32 model
// (evaluate, a --no-amp validation) runs F's f32 kernel in csrc/lstm_f32.cu
// on ops/lstm_fused_cuda.py:f32_plan's plan; this one runs for comparisons
// and where that plan is None.
//
// scripts/lstm_step_split.py f times the mma kernel with each part of a
// step left out (LSTM_CUT, 0 in the library) and with tanh.approx.f32.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>

#include "lstm_persistent.cuh"

#ifndef LSTM_CUT
#define LSTM_CUT 0
#endif

using namespace nvcuda;

namespace {

constexpr int RB = 8;               // batch rows per block (n of a tile)
constexpr int MT = 32;              // gate columns per tile (m of a tile)
constexpr int NWARP = 12;           // 4*96 / 32: a tile per warp at H = 96
constexpr int NTHREAD = NWARP * 32;
constexpr int PF = 4;               // steps of x in flight ahead
constexpr int NSLOT = PF + 1;
constexpr int KFAST = 6;            // k-tiles of x and of h at C = H = 96

typedef __nv_bfloat16 bf16;

__host__ __device__ inline int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// Shared memory of a block, in bytes from its start.
struct Layout {
    int ldx, ldh, ldg;
    int off_x, off_h, off_g, off_c, off_b, total;
    __host__ __device__ Layout(int C, int H) {
        ldx = C + PAD;
        ldh = H + PAD;
        ldg = 4 * H + 4;
        int off = 0;
        off_x = off;  off += round_up(NSLOT * RB * ldx * 2, 128);
        off_h = off;  off += round_up(RB * ldh * 2, 128);
        off_g = off;  off += round_up(RB * ldg * 4, 128);
        off_c = off;  off += round_up(RB * H * 4, 128);
        off_b = off;  off += round_up(4 * H * 4, 128);
        total = off;
    }
};

typedef wmma::fragment<wmma::matrix_a, 32, 8, 16, bf16, wmma::col_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 32, 8, 16, bf16, wmma::col_major> FragB;
typedef wmma::fragment<wmma::accumulator, 32, 8, 16, float> Acc;

// KX, KH > 0: the shape is C = 16 KX, H = 16 KH with a tile per warp, and
// the weight fragments stay in registers. 0, 0: any shape, fragments read
// from device memory (L2) every step.
template <int KX, int KH>
__global__ void __launch_bounds__(NTHREAD)
lstm_fused_bf16_kernel(const bf16* __restrict__ x,     // [T, N, C]
                       const bf16* __restrict__ wih,   // [C, 4H]
                       const bf16* __restrict__ whh,   // [H, 4H]
                       const float* __restrict__ bias, // [4H]
                       bf16* __restrict__ out,         // [T, N, H]
                       int T, int N, int C_, int H_, int reverse)
{
    constexpr bool REGS = KX > 0;
    const int C = REGS ? 16 * KX : C_;
    const int H = REGS ? 16 * KH : H_;
    const int G = 4 * H;
    extern __shared__ __align__(128) unsigned char smem[];
    const Layout L(C, H);
    bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x);
    bf16* hs = reinterpret_cast<bf16*>(smem + L.off_h);
    float* gs = reinterpret_cast<float*>(smem + L.off_g);
    float* cs = reinterpret_cast<float*>(smem + L.off_c);
    float* bs = reinterpret_cast<float*>(smem + L.off_b);

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int n0 = blockIdx.x * RB;

    // element (m, k) of a weight tile is W[k][tile * MT + m]: col-major
    FragA ax[REGS ? KX : 1], ah[REGS ? KH : 1];
    if (REGS) {
#pragma unroll
        for (int kt = 0; kt < KX; ++kt)
            wmma::load_matrix_sync(
                ax[kt], wih + (size_t)(16 * kt) * G + warp * MT, G);
#pragma unroll
        for (int kt = 0; kt < KH; ++kt)
            wmma::load_matrix_sync(
                ah[kt], whh + (size_t)(16 * kt) * G + warp * MT, G);
    }
    for (int e = tid; e < G; e += NTHREAD) bs[e] = bias[e];
    for (int e = tid; e < RB * H; e += NTHREAD) cs[e] = 0.f;
    for (int e = tid; e < RB * L.ldh; e += NTHREAD)
        hs[e] = __float2bfloat16(0.f);

    // start the copy of step j's x rows into its slot of the ring; one
    // commit per call, with or without a copy
    auto stage_x = [&](int j) {
        if (j < T) {
            const int t = reverse ? T - 1 - j : j;
            const bf16* src = x + ((size_t)t * N + n0) * C;
            bf16* dst = xs + (size_t)(j % NSLOT) * RB * L.ldx;
            const int units = C / 8;  // 16-byte pieces of a row
            for (int e = tid; e < RB * units; e += NTHREAD) {
                const int row = e / units, u = e % units;
                bf16* d = dst + row * L.ldx + 8 * u;
                if (n0 + row < N)
                    __pipeline_memcpy_async(d, src + (size_t)row * C + 8 * u,
                                            16);
                else
                    *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
            }
        }
        __pipeline_commit();
    };

    for (int j = 0; j < PF; ++j) stage_x(j);
    for (int step = 0; step < T; ++step) {
        const int t = reverse ? T - 1 - step : step;
        // the slot of step + PF is the one step - 1 has left
        stage_x(step + PF);
        __pipeline_wait_prior(PF);
        __syncthreads();  // x of this step, h and c of the last one visible
        const bf16* xcur = xs + (size_t)(step % NSLOT) * RB * L.ldx;
        for (int tile = warp; tile < G / MT; tile += NWARP) {
            Acc acc_x, acc_h;
            wmma::fill_fragment(acc_x, 0.f);
            wmma::fill_fragment(acc_h, 0.f);
            FragB b;
            if (REGS) {
#pragma unroll
                for (int kt = 0; kt < KX; ++kt) {
                    wmma::load_matrix_sync(b, xcur + 16 * kt, L.ldx);
                    wmma::mma_sync(acc_x, ax[kt], b, acc_x);
                }
#pragma unroll
                for (int kt = 0; kt < KH; ++kt) {
                    wmma::load_matrix_sync(b, hs + 16 * kt, L.ldh);
                    wmma::mma_sync(acc_h, ah[kt], b, acc_h);
                }
            } else {
                for (int kt = 0; kt < C / 16; ++kt) {
                    wmma::load_matrix_sync(
                        ax[0], wih + (size_t)(16 * kt) * G + tile * MT, G);
                    wmma::load_matrix_sync(b, xcur + 16 * kt, L.ldx);
                    wmma::mma_sync(acc_x, ax[0], b, acc_x);
                }
                for (int kt = 0; kt < H / 16; ++kt) {
                    wmma::load_matrix_sync(
                        ah[0], whh + (size_t)(16 * kt) * G + tile * MT, G);
                    wmma::load_matrix_sync(b, hs + 16 * kt, L.ldh);
                    wmma::mma_sync(acc_h, ah[0], b, acc_h);
                }
            }
#pragma unroll
            for (int i = 0; i < acc_x.num_elements; ++i)
                acc_x.x[i] += acc_h.x[i];
            // element (m, n) lands at gs[n][tile * MT + m]
            wmma::store_matrix_sync(gs + tile * MT, acc_x, L.ldg,
                                    wmma::mem_col_major);
        }
        __syncthreads();
        for (int e = tid; e < RB * H; e += NTHREAD) {
            const int n = e / H, u = e % H;
            const float* g = gs + n * L.ldg + u;
            const float ig = sigmoid_f(g[0] + bs[u]);
            const float fg = sigmoid_f(g[H] + bs[H + u]);
            const float gg = tanhf(g[2 * H] + bs[2 * H + u]);
            const float og = sigmoid_f(g[3 * H] + bs[3 * H + u]);
            const float cn = fg * cs[e] + ig * gg;
            cs[e] = cn;
            const bf16 h = __float2bfloat16(og * tanhf(cn));
            hs[n * L.ldh + u] = h;
            if (n0 + n < N) out[((size_t)t * N + n0 + n) * H + u] = h;
        }
    }
}

// ---------------------------------------------- the mma kernel (fused_plan)
// the parts scripts/lstm_step_split.py f leaves out (LSTM_CUT bits)
constexpr int CUT_H = 1;         // the h product (its sums are zeros)
constexpr int CUT_X = 2;         // the x product (its sums are zeros)
constexpr int CUT_GATES = 4;     // the gate math: the gates' sum is h
constexpr int CUT_BARRIER = 8;   // the step's block barrier
constexpr int CUT_STORE = 16;    // the stores of h to out
constexpr int TANH_APPROX = 32;  // tanh.approx.f32 in place of tanhf

__device__ __forceinline__ constexpr bool cut(int part) {
    return (LSTM_CUT & part) != 0;
}

constexpr int MRB = 8;  // batch rows per block: the n of m16n8k16
constexpr int MPF = 4;  // steps of x in flight ahead
constexpr int MSLOT = MPF + 1;  // the ring's slots

__device__ __forceinline__ float tanh_f(float x) {
    if (!cut(TANH_APPROX)) return tanhf(x);
    float y;
    asm("tanh.approx.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// shared memory: the ring of x rows [MSLOT][MRB][C + PAD], then h in two
// buffers [2][MRB][H + PAD] (bf16; rows padded by 16 bytes, so that the
// eight rows an ldmatrix reads lie in distinct banks)
__host__ __device__ inline int mma_smem(int C, int H) {
    return (MSLOT * MRB * (C + PAD) + 2 * MRB * (H + PAD)) * 2;
}

// acc[mt] = sum over the KT k-tiles, in order from zero, of the A fragments
// a[mt][kt] times the B fragments of `rows` (MRB rows of bf16, k contiguous,
// row stride ld): two k-tiles an ldmatrix.x4
template <int KT>
__device__ __forceinline__ void product(float (&acc)[2][4],
                                        const uint32_t (&a)[2][KT][4],
                                        const bf16* rows, int ld, int lane) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    const bf16* at = rows + (lane & 7) * ld + 8 * (lane >> 3);
#pragma unroll
    for (int kt = 0; kt + 1 < KT; kt += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, at + 16 * kt);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt], a[mt][kt], b[0], b[1]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
            mma_bf16(acc[mt], a[mt][kt + 1], b[2], b[3]);
    }
    if (KT % 2) {
        uint32_t b0, b1;
        ldmatrix_x2(b0, b1, rows + (lane & 7) * ld + 16 * (KT - 1)
                                + 8 * ((lane >> 3) & 1));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
            mma_bf16(acc[mt], a[mt][KT - 1], b0, b1);
    }
}

// the bf16 pair W[k][col], W[k + 1][col] of W [K, G], the lower k in the
// low half (an A fragment's register)
__device__ __forceinline__ uint32_t k_pair(const bf16* __restrict__ W,
                                          int G, int k, int col) {
    const unsigned short* v = reinterpret_cast<const unsigned short*>(W);
    return (uint32_t)v[(size_t)k * G + col]
           | (uint32_t)v[(size_t)(k + 1) * G + col] << 16;
}

// the A fragments of warp w's two m-tiles from W [16 KT, 4H] (W_ih or
// W_hh): the A operand's rows 32w + 16mt + g and g + 8 are gates 2mt and
// 2mt + 1 of unit 8w + g, columns 2mt H + 8w + g and H more of W
template <int KT>
__device__ __forceinline__ void load_weights(uint32_t (&a)[2][KT][4],
                                             const bf16* __restrict__ W,
                                             int H, int w, int lane) {
    const int g = lane >> 2, tig = lane & 3;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            const int c0 = 2 * mt * H + 8 * w + g, c1 = c0 + H;
            const int k = 16 * kt + 2 * tig;
            a[mt][kt][0] = k_pair(W, 4 * H, k, c0);
            a[mt][kt][1] = k_pair(W, 4 * H, k, c1);
            a[mt][kt][2] = k_pair(W, 4 * H, k + 8, c0);
            a[mt][kt][3] = k_pair(W, 4 * H, k + 8, c1);
        }
}

// one (row, unit)'s step: the earlier kernel's f32 steps (the x and h sums
// added, then the bias; expf and tanhf), c carried in registers. nvcc
// compiles the earlier kernel's `fg * c + ig * gg` to fma(ig, gg, fg * c),
// written out here so that this kernel keeps those bits.
__device__ __forceinline__ bf16 gate_step(float xi, float xf, float xg,
                                          float xo, float hi, float hf,
                                          float hg, float ho, float bi,
                                          float bf, float bg, float bo,
                                          float& c) {
    const float si = xi + hi, sf = xf + hf, sg = xg + hg, so = xo + ho;
    if (cut(CUT_GATES)) return __float2bfloat16(si + sf + sg + so);
    const float ig = sigmoid_f(si + bi);
    const float fg = sigmoid_f(sf + bf);
    const float gg = tanh_f(sg + bg);
    const float og = sigmoid_f(so + bo);
    const float cn = __fmaf_rn(ig, gg, __fmul_rn(fg, c));
    c = cn;
    return __float2bfloat16(og * tanh_f(cn));
}

template <int KX, int KH>
__global__ void __launch_bounds__(64 * KH, 1)
lstm_fused_mma_kernel(const bf16* __restrict__ x,     // [T, N, C]
                      const bf16* __restrict__ wih,   // [C, 4H]
                      const bf16* __restrict__ whh,   // [H, 4H]
                      const float* __restrict__ bias, // [4H]
                      bf16* __restrict__ out,         // [T, N, H]
                      int T, int N, int reverse)
{
    constexpr int C = 16 * KX, H = 16 * KH;
    constexpr int LDX = C + PAD, LDH = H + PAD;
    extern __shared__ __align__(128) unsigned char smem[];
    bf16* xs = reinterpret_cast<bf16*>(smem);    // [MSLOT][MRB][LDX]
    bf16* hs = xs + MSLOT * MRB * LDX;           // [2][MRB][LDH]

    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int g = lane >> 2, tig = lane & 3;
    const int n0 = blockIdx.x * MRB;
    const int u = 8 * w + g;     // this thread's unit
    const int ra = 2 * tig;      // and its rows ra, ra + 1 of the block

    uint32_t wx[2][KX][4], wh[2][KH][4];
    load_weights<KX>(wx, wih, H, w, lane);
    load_weights<KH>(wh, whh, H, w, lane);
    const float bi = bias[u], bf = bias[H + u], bg = bias[2 * H + u],
                bo = bias[3 * H + u];
    // h of step -1: zeros, in the buffer step 0 reads
    for (int e = tid; e < MRB * LDH; e += 64 * KH)
        hs[MRB * LDH + e] = __float2bfloat16(0.f);

    // start the copy of step j's x rows into slot j % MSLOT (the slot of
    // step j - MSLOT, whose x product ran before the last barrier: at step
    // s = j - MPF that of step s - 1, read during step s - 2); one commit
    // per call, with or without a copy
    auto stage_x = [&](int j) {
        if (j < T) {
            const int t = reverse ? T - 1 - j : j;
            const bf16* src = x + ((size_t)t * N + n0) * C;
            bf16* dst = xs + (j % MSLOT) * MRB * LDX;
            constexpr int units = C / 8;  // 16-byte pieces of a row
            for (int e = tid; e < MRB * units; e += 64 * KH) {
                const int row = e / units, p = e % units;
                bf16* d = dst + row * LDX + 8 * p;
                if (n0 + row < N)
                    __pipeline_memcpy_async(d, src + (size_t)row * C + 8 * p,
                                            16);
                else
                    *reinterpret_cast<int4*>(d) = make_int4(0, 0, 0, 0);
            }
        }
        __pipeline_commit();
    };

    // the h product from the h buffer `hb` (with CUT_H: one value of it in
    // every sum), and step j's x product (zeros past the last step)
    auto h_product = [&](float (&acc)[2][4], const bf16* hb) {
        if (!cut(CUT_H)) {
            product<KH>(acc, wh, hb, LDH, lane);
        } else {
            for (int mt = 0; mt < 2; ++mt)
                for (int e = 0; e < 4; ++e)
                    acc[mt][e] = __bfloat162float(hb[ra * LDH + u]);
        }
    };
    auto x_product = [&](float (&acc)[2][4], int j) {
        if (j < T && !cut(CUT_X))
            product<KX>(acc, wx, xs + (j % MSLOT) * MRB * LDX, LDX, lane);
        else
            for (int mt = 0; mt < 2; ++mt)
                for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;
    };

    for (int j = 0; j < MPF; ++j) stage_x(j);
    __pipeline_wait_prior(MPF - 2);  // x of steps 0 and 1
    __syncthreads();
    float ax[2][4];
    x_product(ax, 0);
    float ca = 0.f, cb = 0.f;
    for (int step = 0; step < T; ++step) {
        const int t = reverse ? T - 1 - step : step;
        float ah[2][4], an[2][4];
        h_product(ah, hs + ((step + 1) & 1) * MRB * LDH);
        x_product(an, step + 1);  // off the chain of h
        // accumulators: tile 0 holds i (e 0, 1) and f (e 2, 3), tile 1 g and
        // o; e 0 and 2 are row ra, e 1 and 3 row ra + 1
        const bf16 ha = gate_step(ax[0][0], ax[0][2], ax[1][0], ax[1][2],
                                  ah[0][0], ah[0][2], ah[1][0], ah[1][2],
                                  bi, bf, bg, bo, ca);
        const bf16 hb = gate_step(ax[0][1], ax[0][3], ax[1][1], ax[1][3],
                                  ah[0][1], ah[0][3], ah[1][1], ah[1][3],
                                  bi, bf, bg, bo, cb);
        bf16* hn = hs + (step & 1) * MRB * LDH;
        hn[ra * LDH + u] = ha;
        hn[(ra + 1) * LDH + u] = hb;
        if (!cut(CUT_STORE)) {
            bf16* o = out + ((size_t)t * N + n0 + ra) * H + u;
            if (n0 + ra < N) o[0] = ha;
            if (n0 + ra + 1 < N) o[H] = hb;
        }
        stage_x(step + MPF);
        __pipeline_wait_prior(MPF - 2);  // x of step + 2
        if (!cut(CUT_BARRIER)) __syncthreads();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) ax[mt][e] = an[mt][e];
    }
}

// the mma kernel of C = H = 16 K (fused_plan's MMA_WIDTHS), or null
typedef void (*MmaKernel)(const bf16*, const bf16*, const bf16*, const float*,
                          bf16*, int, int, int);
MmaKernel mma_kernel(int C, int H) {
    if (C != H) return nullptr;
    switch (H / 16) {
    case 1: return lstm_fused_mma_kernel<1, 1>;
    case 2: return lstm_fused_mma_kernel<2, 2>;
    case 3: return lstm_fused_mma_kernel<3, 3>;
    case 4: return lstm_fused_mma_kernel<4, 4>;
    case 5: return lstm_fused_mma_kernel<5, 5>;
    case 6: return lstm_fused_mma_kernel<6, 6>;
    default: return nullptr;
    }
}

// ---------------------------------------------------------------------------
// the earlier f32 instance (csrc/lstm_f32.cu has F's f32 kernel)
// ---------------------------------------------------------------------------
//
// xw = x[t] @ W_ih + b and gates = xw + h @ W_hh, all in f32 on the f32
// cores (FFMA); h and c carried in f32, h stored in f32. A block owns FR
// batch rows for all T steps, a thread each of the 4H gate columns (its
// sums over k in order, 4 k at a time from float4 rows of x and h in shared
// memory). At fast's H 96 a thread keeps its column of W_hh in registers
// (KH 6; KH 0, every other H, reads it through L2 every step); W_ih sits in
// shared memory where it fits (C x 4H f32, 144 KB at fast's C = H = 96),
// else it too is read through L2. The layout (ops/lstm_fused_cuda.py:
// f32_old_layout) decides both and the C entry takes it as given.
// After a barrier each thread does the gate math of two (row, unit) pairs
// with c in registers: two barriers a step.

constexpr int FR = 8;  // batch rows per block of the f32 kernel

// Shared memory of the f32 kernel, in floats: W_ih (where it is kept
// there), the step's rows of x, of h and of the gates.
__host__ __device__ inline int f32_smem_floats(int C, int H, bool wih_in_smem)
{
    return (wih_in_smem ? C * 4 * H : 0) + FR * (C + H + 4 * H);
}

template <int KH>
__global__ void __launch_bounds__(KH > 0 ? 64 * KH : 1024)
lstm_fused_f32_kernel(const float* __restrict__ x,     // [T, N, C]
                      const float* __restrict__ wih,   // [C, 4H]
                      const float* __restrict__ whh,   // [H, 4H]
                      const float* __restrict__ bias,  // [4H]
                      float* __restrict__ out,         // [T, N, H]
                      int T, int N, int C, int H, int reverse,
                      int wih_in_smem)
{
    extern __shared__ __align__(16) float fsm[];
    const int G = 4 * H;
    const int col = threadIdx.x;  // this thread's gate column
    const int n0 = blockIdx.x * FR;
    float* wis = fsm;
    float* xs = fsm + (wih_in_smem ? C * G : 0);
    float* hs = xs + FR * C;
    float* gs = hs + FR * H;
    if (wih_in_smem)
        for (int e = col; e < C * G / 4; e += G)
            reinterpret_cast<float4*>(wis)[e] =
                reinterpret_cast<const float4*>(wih)[e];
    const float* wi = wih_in_smem ? wis : wih;
    float wh[KH > 0 ? 16 * KH : 1];
    if constexpr (KH > 0) {
#pragma unroll
        for (int k = 0; k < 16 * KH; ++k) wh[k] = whh[(size_t)k * G + col];
    }
    for (int e = col; e < FR * H; e += G) hs[e] = 0.f;
    const float b = bias[col];
    float cr[2] = {0.f, 0.f};  // c of the pairs col and col + 4H

    for (int step = 0; step < T; ++step) {
        const int t = reverse ? T - 1 - step : step;
        const float4* xt =
            reinterpret_cast<const float4*>(x + ((size_t)t * N + n0) * C);
        for (int e = col; e < FR * C / 4; e += G)
            reinterpret_cast<float4*>(xs)[e] =
                n0 + e / (C / 4) < N ? xt[e] : make_float4(0.f, 0.f, 0.f, 0.f);
        __syncthreads();  // x staged; h of the last step written

        float ax[FR] = {}, ah[FR] = {};
        for (int k = 0; k < C; k += 4) {
            const float w0 = wi[(size_t)k * G + col];
            const float w1 = wi[(size_t)(k + 1) * G + col];
            const float w2 = wi[(size_t)(k + 2) * G + col];
            const float w3 = wi[(size_t)(k + 3) * G + col];
#pragma unroll
            for (int r = 0; r < FR; ++r) {
                const float4 v = *reinterpret_cast<const float4*>(xs + r * C + k);
                ax[r] = fmaf(v.x, w0, ax[r]);
                ax[r] = fmaf(v.y, w1, ax[r]);
                ax[r] = fmaf(v.z, w2, ax[r]);
                ax[r] = fmaf(v.w, w3, ax[r]);
            }
        }
        if constexpr (KH > 0) {
#pragma unroll
            for (int k = 0; k < 16 * KH; k += 4) {
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(hs + r * H + k);
                    ah[r] = fmaf(v.x, wh[k], ah[r]);
                    ah[r] = fmaf(v.y, wh[k + 1], ah[r]);
                    ah[r] = fmaf(v.z, wh[k + 2], ah[r]);
                    ah[r] = fmaf(v.w, wh[k + 3], ah[r]);
                }
            }
        } else {
            for (int k = 0; k < H; k += 4) {
                const float w0 = whh[(size_t)k * G + col];
                const float w1 = whh[(size_t)(k + 1) * G + col];
                const float w2 = whh[(size_t)(k + 2) * G + col];
                const float w3 = whh[(size_t)(k + 3) * G + col];
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    const float4 v =
                        *reinterpret_cast<const float4*>(hs + r * H + k);
                    ah[r] = fmaf(v.x, w0, ah[r]);
                    ah[r] = fmaf(v.y, w1, ah[r]);
                    ah[r] = fmaf(v.z, w2, ah[r]);
                    ah[r] = fmaf(v.w, w3, ah[r]);
                }
            }
        }
#pragma unroll
        for (int r = 0; r < FR; ++r) gs[r * G + col] = (ax[r] + b) + ah[r];
        __syncthreads();  // the gates written; x and h read

#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const int e = col + j * G;
            const int r = e / H, u = e % H;
            const float* g = gs + r * G + u;
            const float ig = sigmoid_f(g[0]);
            const float fg = sigmoid_f(g[H]);
            const float gg = tanhf(g[2 * H]);
            const float og = sigmoid_f(g[3 * H]);
            cr[j] = fg * cr[j] + ig * gg;
            const float h = og * tanhf(cr[j]);
            hs[r * H + u] = h;
            if (n0 + r < N) out[((size_t)t * N + n0 + r) * H + u] = h;
        }
    }
}

}  // namespace

// Kernel F's earlier f32 kernel: x [T, N, C], wih [C, 4H], whh [H, 4H],
// bias [4H], out [T, N, H], all f32 (x and wih at 16-byte addresses); C
// and H multiples of 16, C at most 1024 and H at most 256. The layout is
// the caller's (ops/lstm_fused_cuda.py:f32_old_layout): W_hh's column in registers
// (whh_in_registers, built for H 96 only) or read through L2, W_ih in
// shared memory (wih_in_smem) or not, and smem, the bytes the block asks
// for, which must be what that layout needs.
extern "C" int lstm_fused_f32(const void* x, const void* wih, const void* whh,
                              const void* bias, void* out, int T, int N,
                              int C, int H, int reverse, int whh_in_registers,
                              int wih_in_smem, int smem, void* stream)
{
    if (T < 1 || N < 1 || C < 16 || H < 16 || C % 16 != 0 || H % 16 != 0
        || C > 1024 || H > 256 || (whh_in_registers && H != 96)
        || smem != f32_smem_floats(C, H, wih_in_smem) * (int)sizeof(float)
        || smem > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    const auto kernel = whh_in_registers ? lstm_fused_f32_kernel<6>
                                         : lstm_fused_f32_kernel<0>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + FR - 1) / FR, 4 * H, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(wih),
        static_cast<const float*>(whh), static_cast<const float*>(bias),
        static_cast<float*>(out), T, N, C, H, reverse, wih_in_smem);
    return (int)cudaGetLastError();
}

// Kernel F. x [T, N, C], wih [C, 4H], whh [H, 4H] bf16 (the weights at
// 32-byte addresses), bias [4H] f32, out [T, N, H] bf16. C and H multiples
// of 16, C at most 1024 and H at most 256.
extern "C" int lstm_fused_bf16(const void* x, const void* wih,
                               const void* whh, const void* bias, void* out,
                               int T, int N, int C, int H, int reverse,
                               void* stream)
{
    if (T < 1 || N < 1 || C < 16 || H < 16 || C % 16 != 0 || H % 16 != 0
        || C > 1024 || H > 256)
        return (int)cudaErrorInvalidValue;
    const Layout L(C, H);
    if (L.total > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const bool fast = C == 16 * KFAST && H == 16 * KFAST;
    static_assert(4 * 16 * KFAST / MT == NWARP, "a tile per warp");
    const auto kernel = fast ? lstm_fused_bf16_kernel<KFAST, KFAST>
                             : lstm_fused_bf16_kernel<0, 0>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + RB - 1) / RB, NTHREAD, L.total,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wih),
        static_cast<const bf16*>(whh), static_cast<const float*>(bias),
        static_cast<bf16*>(out), T, N, C, H, reverse);
    return (int)cudaGetLastError();
}

// Kernel F on the mma kernel: the arguments of lstm_fused_bf16 (wih and
// whh contiguous, at any address), C = H a multiple of 16 up to 96 (the
// instances built).
extern "C" int lstm_fused_mma(const void* x, const void* wih, const void* whh,
                              const void* bias, void* out, int T, int N,
                              int C, int H, int reverse, void* stream)
{
    const MmaKernel kernel = mma_kernel(C, H);
    if (T < 1 || N < 1 || H % 16 != 0 || kernel == nullptr)
        return (int)cudaErrorInvalidValue;
    const int smem = mma_smem(C, H);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + MRB - 1) / MRB, 4 * H, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(wih),
        static_cast<const bf16*>(whh), static_cast<const float*>(bias),
        static_cast<bf16*>(out), T, N, reverse);
    return (int)cudaGetLastError();
}
