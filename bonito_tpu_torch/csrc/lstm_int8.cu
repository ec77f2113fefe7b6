// Kernels D and E: the int8 LSTM layers of the quantised (hac default) route.
//
// D, `lstm_int8_fused`, replaces bonito_tpu/ops/lstm_pallas.py:
// lstm_pallas_int8_fused (`_lstm_kernel_int8_fused`): the input projection
// and the recurrence both as int8 products with int32 accumulation, from an
// int8 input stream. Per step
//
//     xw    = f32(x_q[t] @ W_ih_q) * ihsc + b
//     gates = xw + f32(h_q @ W_hh_q) * scale
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//     c = f*c + i*g;  h = o*tanh(c);  h_q = int8(rint(h * 127))
//     out[t] = h_q (int8, chained into the next quantised layer) or bf16(h)
//
// with c in f32 and h carried only as h_q: that is what the next step's
// product, the next layer's projection and the int8 CRF head all read. The
// [T, N, 4H] gate-input tensor never exists in device memory.
//
// E, `lstm_int8_recurrence`, replaces lstm_pallas_int8 (`_lstm_kernel_int8`):
// the int8 recurrence over a precomputed bf16 xw [T, N, 4H] (the two-stage
// route; its projection is a plain product outside, as in bonito_tpu),
//
//     gates = f32(xw[t]) + f32(h_q @ W_hh_q) * scale,   out[t] = bf16(h).
//
// The TPU kernel carries h in f32 and rounds it at the start of the next
// step; rounding at the end of this one gives the same h_q, so E carries
// h_q like D and is the same step kernel without the x product.
//
// Rounding is half-to-even (`__float2int_rn`), as jnp.round and torch.round.
// The f32 multiplies and adds are written with __fmul_rn/__fadd_rn so that
// nvcc contracts none of them into an fma: the plain PyTorch versions and
// the TPU kernels round after each operation. expf/tanhf still differ from
// other libraries' in the last bit, so an h within that of a half step can
// land one int8 step apart.
//
// What bounds them on an H100: D does 2*N*(C+H)*4H*T int8 operations per
// layer (hac: 2.68e12, 1.36 ms at 1,979 TOP/s) against ~0.34 GB of x/out
// traffic; E half the operations against 1.65 GB of bf16 xw + h (0.49 ms at
// 3.35 TB/s). Both are serial in T, so what bounds this design is the time
// of one step: a launch, then every block pulling its operands from L2 (at
// hac 29 MB a step in all for D: the 8 MB of weights once per row block,
// the 0.2 MB of inputs once per column block).
//
// Design: kernel A's grid (one step kernel per timestep, launched in a loop
// inside the C entry point; a block owns UH hidden units x RB batch rows
// with all four gate columns, so the gate math stays in its epilogue) with
// both products in the step, and the operands staged through shared memory.
// The k-range (C of x, then H of h) is cut into chunks of KC values. The
// block's threads copy a chunk of its RB input rows and of its 64 weight
// rows with 16-byte cp.async copies, neighbouring threads on neighbouring
// addresses, NSTAGE - 1 chunks ahead of the chunk being multiplied; a warp
// per 16x16 output tile (RB/16 row tiles x 4 gates) runs the 16x16x16
// `signed char` WMMA products with int32 accumulators from shared memory.
// Rows there are padded by 16 bytes so that a fragment load hits every bank
// once. The weights come transposed ([4H, K], k contiguous: the wrapper
// transposes them, 8 MB of copies per layer call at hac), so both operands
// of a tile are k-contiguous. In D the x product and the h product keep
// separate accumulators, because the two sums take different scales; they
// meet the epilogue through shared memory as exact int32 sums. h_q
// ping-pongs between two int8 buffers whose padding rows (N..Np) stay zero;
// x is read with Np rows per step.
//
// Earlier versions, and the constants' other values, are timed in PERF.md
// (scripts/sweep_lstm_int8.py varies the constants). A cluster that shares
// one copy of the input rows (every column block reads the same ones at the
// same moment), a block of steps' projection ahead of the recurrence, and a
// persistent kernel with the weights resident in shared memory are the
// redesigns left for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int UH = 16;              // hidden units per block
constexpr int GC = 4 * UH;          // gate columns per block
// k-values staged per chunk and chunks in flight or in use, for the 48-row
// and the 32-row tile (the latter must leave room for two blocks on an SM)
constexpr int KC48 = 512;
constexpr int NSTAGE48 = 3;
constexpr int KC32 = 256;
constexpr int NSTAGE32 = 3;

// A block owns RB batch rows: 48 where the padded batch divides by it (hac's
// 96 rows then make 2 x 64 = 128 blocks, one wave of the 132 SMs, and the
// weights are read twice a step instead of three times), else 32.
template <int RB> struct Tile {
    static constexpr int NTHREAD = (RB / 16) * 4 * 32;  // a warp per 16x16 tile
    static constexpr int KC = RB == 48 ? KC48 : KC32;
    static constexpr int NSTAGE = RB == 48 ? NSTAGE48 : NSTAGE32;
    static constexpr int LDS = KC + 16;            // padded row of a chunk, bytes
    static constexpr int STAGE = (RB + GC) * LDS;  // one staged chunk, bytes
    // the stages, then the int32 sums of the x and the h product
    static constexpr int SMEM = NSTAGE * STAGE + 2 * RB * GC * (int)sizeof(int);
};

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> Acc;

__device__ __forceinline__ float sigmoid_f(float x) {
    return 1.f / (1.f + expf(-x));
}

// Start the copy of k-values k0 .. k0 + 16 units of the block's rows a
// [RB, K] and of its weight rows wT (row c is hidden unit c % UH of gate
// c / UH; gate blocks are H rows apart) into one stage: RB rows of a, then
// GC rows of wT, LDS bytes apart.
template <int RB>
__device__ __forceinline__ void stage_chunk(
    signed char* stage, const signed char* __restrict__ a,
    const signed char* __restrict__ wT, int H, int K, int k0, int units)
{
    for (int e = threadIdx.x; e < (RB + GC) * units; e += Tile<RB>::NTHREAD) {
        const int row = e / units, u = e % units;
        const signed char* src = row < RB
            ? a + (size_t)row * K
            : wT + ((size_t)((row - RB) / UH) * H + (row - RB) % UH) * K;
        __pipeline_memcpy_async(stage + row * Tile<RB>::LDS + 16 * u,
                                src + k0 + 16 * u, 16);
    }
}

// acc += the warp's 16 rows of a staged chunk (sA) @ its 16 weight rows
// (sB), transposed
template <int LDS>
__device__ __forceinline__ void multiply_chunk(
    Acc& acc, const signed char* sA, const signed char* sB, int units)
{
    for (int kk = 0; kk < units; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char,
                       wmma::row_major> afrag;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char,
                       wmma::col_major> bfrag;
        wmma::load_matrix_sync(afrag, sA + 16 * kk, LDS);
        wmma::load_matrix_sync(bfrag, sB + 16 * kk, LDS);
        wmma::mma_sync(acc, afrag, bfrag, acc);
    }
}

template <int RB, bool FUSED, bool OUT_INT8>
__global__ void __launch_bounds__(Tile<RB>::NTHREAD)
lstm_int8_step(const signed char* __restrict__ x,     // D: [Np, C] at t
               const __nv_bfloat16* __restrict__ xw,  // E: [N, 4H] at t
               const signed char* __restrict__ wihT,  // D: [4H, C]
               const signed char* __restrict__ whhT,  // [4H, H]
               const float* __restrict__ ihsc,        // D: [4H]
               const float* __restrict__ scale,       // [4H]
               const float* __restrict__ bias,        // D: [4H]
               const signed char* __restrict__ h_in,  // [Np, H] h_q of t-1
               signed char* __restrict__ h_next,      // [Np, H]
               void* __restrict__ out,                // [N, H] at t
               float* __restrict__ c,                 // [N, H]
               int N, int C, int H)
{
    constexpr int NTHREAD = Tile<RB>::NTHREAD;
    constexpr int KC = Tile<RB>::KC;
    constexpr int LDS = Tile<RB>::LDS;
    constexpr int NSTAGE = Tile<RB>::NSTAGE;
    constexpr int STAGE = Tile<RB>::STAGE;
    extern __shared__ __align__(128) signed char smem[];
    int (*sum_x)[GC] = reinterpret_cast<int (*)[GC]>(smem + NSTAGE * STAGE);
    int (*sum_h)[GC] = sum_x + RB;

    const int warp = threadIdx.x / 32;
    const int gate = warp % 4;
    const int rt = warp / 4;
    const int u0 = blockIdx.x * UH;
    const int r0 = blockIdx.y * RB;
    const int ldw = 4 * H;

    // the chunks of the x product (D only), then those of the h product
    const int nx = FUSED ? (C + KC - 1) / KC : 0;
    const int n = nx + (H + KC - 1) / KC;
    auto units_of = [&](int j) {
        return j < nx ? min(KC, C - j * KC) / 16
                      : min(KC, H - (j - nx) * KC) / 16;
    };
    auto start = [&](int j) {  // one commit per call, with or without a copy
        if (j < nx)
            stage_chunk<RB>(smem + (j % NSTAGE) * STAGE, x + (size_t)r0 * C,
                            wihT + (size_t)u0 * C, H, C, j * KC, units_of(j));
        else if (j < n)
            stage_chunk<RB>(smem + (j % NSTAGE) * STAGE,
                            h_in + (size_t)r0 * H, whhT + (size_t)u0 * H, H,
                            H, (j - nx) * KC, units_of(j));
        __pipeline_commit();
    };

    Acc acc_x, acc_h;
    wmma::fill_fragment(acc_x, 0);
    wmma::fill_fragment(acc_h, 0);
    for (int j = 0; j < NSTAGE - 1; ++j) start(j);
    for (int j = 0; j < n; ++j) {
        // later chunks are copied while chunk j is multiplied; the stage of
        // chunk j + NSTAGE - 1 is the one chunk j - 1 has just left
        start(j + NSTAGE - 1);
        __pipeline_wait_prior(NSTAGE - 1);
        __syncthreads();
        const signed char* sA = smem + (j % NSTAGE) * STAGE + 16 * rt * LDS;
        const signed char* sB = smem + (j % NSTAGE) * STAGE
                              + (RB + 16 * gate) * LDS;
        if (j < nx)
            multiply_chunk<LDS>(acc_x, sA, sB, units_of(j));
        else
            multiply_chunk<LDS>(acc_h, sA, sB, units_of(j));
        __syncthreads();  // before a later chunk lands in this stage
    }
    if (FUSED)
        wmma::store_matrix_sync(&sum_x[16 * rt][gate * UH], acc_x, GC,
                                wmma::mem_row_major);
    wmma::store_matrix_sync(&sum_h[16 * rt][gate * UH], acc_h, GC,
                            wmma::mem_row_major);
    __syncthreads();

    for (int e = threadIdx.x; e < RB * UH; e += NTHREAD) {
        const int rr = e / UH, u = e % UH;
        const int row = r0 + rr;
        if (row >= N) continue;
        const int unit = u0 + u;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int col = q * H + unit;
            const float rec = __fmul_rn((float)sum_h[rr][q * UH + u],
                                        scale[col]);
            float xwv;
            if (FUSED)
                xwv = __fadd_rn(__fmul_rn((float)sum_x[rr][q * UH + u],
                                          ihsc[col]), bias[col]);
            else
                xwv = __bfloat162float(xw[(size_t)row * ldw + col]);
            g[q] = __fadd_rn(xwv, rec);
        }
        const float ig = sigmoid_f(g[0]);
        const float fg = sigmoid_f(g[1]);
        const float gg = tanhf(g[2]);
        const float og = sigmoid_f(g[3]);
        const size_t idx = (size_t)row * H + unit;
        const float cn = __fadd_rn(__fmul_rn(fg, c[idx]), __fmul_rn(ig, gg));
        c[idx] = cn;
        const float h = __fmul_rn(og, tanhf(cn));
        const signed char hq = (signed char)__float2int_rn(__fmul_rn(h, 127.f));
        h_next[idx] = hq;
        if (OUT_INT8)
            static_cast<signed char*>(out)[idx] = hq;
        else
            static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16(h);
    }
}

struct Layer {
    const signed char* x;       // D: [T, Np, C]
    const __nv_bfloat16* xw;    // E: [T, N, 4H]
    const signed char* wihT;    // D: [4H, C]
    const signed char* whhT;    // [4H, H]
    const float* ihsc;          // D: [4H]
    const float* scale;         // [4H]
    const float* bias;          // D: [4H]
    void* out;                  // [T, N, H]
    signed char* hbuf;          // [2, Np, H], zeroed
    float* cbuf;                // [N, H], zeroed
    int T, N, Np, C, H, reverse;
    cudaStream_t stream;
};

template <int RB, bool FUSED, bool OUT_INT8>
int run_layer(const Layer& l)
{
    const auto step_kernel = lstm_int8_step<RB, FUSED, OUT_INT8>;
    cudaError_t err = cudaFuncSetAttribute(
        step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Tile<RB>::SMEM);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(l.H / UH, l.Np / RB);
    const size_t plane = (size_t)l.Np * l.H;
    const size_t out_step = (size_t)l.N * l.H * (OUT_INT8 ? 1 : 2);
    for (int step = 0; step < l.T; ++step) {
        const int t = l.reverse ? l.T - 1 - step : step;
        step_kernel<<<grid, Tile<RB>::NTHREAD, Tile<RB>::SMEM, l.stream>>>(
            FUSED ? l.x + (size_t)t * l.Np * l.C : nullptr,
            FUSED ? nullptr : l.xw + (size_t)t * l.N * 4 * l.H,
            l.wihT, l.whhT, l.ihsc, l.scale, l.bias,
            l.hbuf + (step & 1) * plane, l.hbuf + ((step + 1) & 1) * plane,
            static_cast<char*>(l.out) + (size_t)t * out_step, l.cbuf,
            l.N, l.C, l.H);
        if (step == 0) {
            err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    return (int)cudaGetLastError();
}

// Np is N padded to whole row blocks by the caller: a multiple of 48 takes
// the 48-row tile, any other multiple of 32 the 32-row one.
template <bool FUSED, bool OUT_INT8>
int run_tiled(const Layer& l)
{
    if (l.H % UH != 0 || (FUSED && l.C % 16 != 0) || l.Np < l.N || l.T < 1)
        return (int)cudaErrorInvalidValue;
    if (l.Np % 48 == 0) return run_layer<48, FUSED, OUT_INT8>(l);
    if (l.Np % 32 == 0) return run_layer<32, FUSED, OUT_INT8>(l);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Kernel D. x [T, Np, C] int8 (rows N..Np zero), wihT [4H, C] and whhT
// [4H, H] int8 (the weights transposed), ihsc/scale/bias [4H] f32, out
// [T, N, H] int8 (out_int8) or bf16; hbuf [2, Np, H] int8 zeroed, cbuf
// [N, H] f32 zeroed (scratch from the caller). Np is N rounded up to a
// multiple of 48 or 32; C and H multiples of 16.
extern "C" int lstm_int8_fused(const void* x, const void* wihT,
                               const void* whhT, const void* ihsc,
                               const void* scale, const void* bias,
                               void* out, int out_int8, void* hbuf,
                               void* cbuf, int T, int N, int Np, int C,
                               int H, int reverse, void* stream)
{
    const Layer l = {
        static_cast<const signed char*>(x), nullptr,
        static_cast<const signed char*>(wihT),
        static_cast<const signed char*>(whhT),
        static_cast<const float*>(ihsc), static_cast<const float*>(scale),
        static_cast<const float*>(bias), out,
        static_cast<signed char*>(hbuf), static_cast<float*>(cbuf),
        T, N, Np, C, H, reverse, static_cast<cudaStream_t>(stream)};
    return out_int8 ? run_tiled<true, true>(l) : run_tiled<true, false>(l);
}

// Kernel E. xw [T, N, 4H] bf16, whhT [4H, H] int8, scale [4H] f32, out
// [T, N, H] bf16; hbuf and cbuf as for D.
extern "C" int lstm_int8_recurrence(const void* xw, const void* whhT,
                                    const void* scale, void* out, void* hbuf,
                                    void* cbuf, int T, int N, int Np, int H,
                                    int reverse, void* stream)
{
    const Layer l = {
        nullptr, static_cast<const __nv_bfloat16*>(xw), nullptr,
        static_cast<const signed char*>(whhT), nullptr,
        static_cast<const float*>(scale), nullptr, out,
        static_cast<signed char*>(hbuf), static_cast<float*>(cbuf),
        T, N, Np, 0, H, reverse, static_cast<cudaStream_t>(stream)};
    return run_tiled<false, false>(l);
}
