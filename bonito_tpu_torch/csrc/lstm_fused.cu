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
// Design: one launch per layer and no grid-wide barrier. Batch rows do not
// depend on each other, so a block owns RB = 8 rows for all T steps (128
// blocks at N = 1024, one wave of the 132 SMs) and loops over time itself.
// Per step a warp owns 32 gate columns: 32x8x16 bf16 WMMA products with the
// gate columns on the m side and the 8 batch rows on the n side, one
// accumulator for the x product and one for the h product (two independent
// chains), summed and stored to a f32 gate tile in shared memory; after a
// barrier every thread does the gate math of its (row, unit) pairs with
// expf/tanhf, keeps c in shared memory, and writes bf16 h to the h tile and
// to out. The x rows of the next PF steps are in flight as 16-byte cp.async
// copies into a ring of PF + 1 slots, so no step waits for device memory.
// Two block barriers per step.
//
// The weights never change, so at the fast shape (C = H = 96: 12 warps, a
// tile each) every warp keeps its 12 weight fragments in registers for the
// whole layer (160 registers a thread, no spills). The first version held
// both weights in the block's shared memory (144 KB, rows padded by 16
// bytes) and reloaded the fragments every step: 4.4 ms a layer on an H100
// at fast widths against 2.0 ms with them in registers (PERF.md). Any
// other shape reads its fragments through L2 every step with the same code:
// right, and no shipped model runs it.
//
// Later work: mma.sync with the gates of a (row, unit) pair laid out in one
// thread's accumulators, which would drop the gate tile's trip through
// shared memory and one of the two barriers; the x product of the next step
// during this one's gate math.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int RB = 8;               // batch rows per block (n of a tile)
constexpr int MT = 32;              // gate columns per tile (m of a tile)
constexpr int NWARP = 12;           // 4*96 / 32: a tile per warp at H = 96
constexpr int NTHREAD = NWARP * 32;
constexpr int PF = 4;               // steps of x in flight ahead
constexpr int NSLOT = PF + 1;
constexpr int PAD = 8;              // bf16 values: 16 bytes per padded row
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may ask for
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

__device__ __forceinline__ float sigmoid_f(float x) {
    return 1.f / (1.f + expf(-x));
}

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

}  // namespace

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
