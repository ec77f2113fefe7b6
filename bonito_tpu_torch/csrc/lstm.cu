// Kernel A: the LSTM recurrence over a precomputed input projection.
//
// Replaces bonito_tpu/ops/lstm_pallas.py:lstm_pallas (`_lstm_kernel`), the
// bf16 recurrence that the hac model runs with quantize=false. Given
// xw = x @ W_ih + b ([T, N, 4H], bf16, computed outside by torch.matmul as
// the TPU package left it to XLA) and W_hh [H, 4H] bf16, each step computes
//
//     gates = f32(xw[t]) + bf16(h) @ W_hh        (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the four gate blocks
//     c = f*c + i*g;  h = o*tanh(c);  out[t] = bf16(h)
//
// with c carried in f32. The bf16 rounding of h is exactly what the next
// step's product and the output need, so h is carried as bf16 only.
// `reverse` walks t = T-1 .. 0 and writes each step at its own index.
//
// What bounds it on an H100: per layer 2*N*H*4H*T operations on the tensor
// cores (hac: 1.34e12, 1.36 ms at 989 TFLOP/s) against about 1.6 GB of
// xw/h traffic (0.49 ms at 3.35 TB/s). The recurrence is serial in T, so
// what a design pays per step decides: at hac (N 96, H 1024) one step's
// product is 0.81 us of the tensor cores' peak, and the step-per-launch
// design below took 33 us a step (a launch, and W_hh and h re-read from L2
// by every block).
//
// The persistent design (lstm_persistent_bf16 in lstm_persistent.cuh, which
// kernel R, csrc/lstm_train.cu, runs with its stores). One cooperative launch
// runs the whole layer: every CTA is resident (one an SM, checked with the
// occupancy API before the launch) and walks all T steps.
//   - A CTA owns 16 hidden units (all four gate columns of each: 64 columns
//     of W_hh) and one slice of R batch rows (R = 16..64). Its slice of
//     W_hh, 64 x H bf16 (132 KB at H 1024), is loaded into shared memory
//     once and stays there for the layer.
//   - Each step it brings its rows of h_{t-1} (R x H bf16, 96 KB at hac)
//     from L2 into a ring of k-chunks, and runs the product on the tensor
//     cores (mma.sync m16n8k16, bf16 in, f32 out): 8 warps, 2 unit groups
//     (8 units x 4 gates: four n-tiles) x 4 k-slices, each over all R rows.
//     Where the ring holds all of a step's chunks, the two CTAs of a
//     cluster (neighbouring unit blocks of one row slice) share the loads:
//     each copies half of the rows with bulk copies multicast to both, and
//     an mbarrier a chunk counts the bytes; otherwise each CTA loads its own
//     chunks by cp.async.cg, a barrier of the CTA a chunk. The k-slices meet
//     in shared memory (reusing the ring), and the 256 threads run the gate
//     math on R x 16 (row, unit)s, a fixed few each: c stays in registers
//     for the whole layer, and xw of the next step is fetched into
//     registers while this one runs.
//   - h_t goes to a ping-pong buffer in global memory. The CTAs of one row
//     slice meet once a step at a counter in global memory: the CTA's
//     barrier, then one thread's release add; one thread's acquire load,
//     then the CTA's barrier. Slices do not wait for each other. A CTA
//     copies into its peer only after that meeting, when the peer is done
//     with the ring. A wait that cannot end traps (the launch fails) rather
//     than holding the card.
// At hac the grid is 64 clusters of 2 unit blocks x 2 row slices of 48 =
// 128 CTAs, with W_hh's slice and both of a step's 512-wide chunks of h in
// 232 KB of shared memory. A step takes about 7.3 us on an H100 (12.09 ms a
// layer; the step kernel below 33 us). Leaving each part out in turn
// (scripts/lstm_step_split.py) shows what it adds: the products 2.1 us,
// the h loads 1.6 (each pair of CTAs reads 96 KB from L2; without the
// sharing 2.5, 8.1 us a step), the gate math 0.8, the two proxy fences
// that order the bulk copies (async proxy) against the generic loads and
// stores 0.18; the rest is the wait at the counter and the CTA's own
// barriers and stores. Each chunk costs a
// barrier (or an mbarrier), so the chunks are as wide as shared memory
// allows (128-wide chunks: 11.4 us a step).
//
// The plan (ops/lstm_cuda.py:persistent_plan, the shape rule) picks R, the
// row slices, the chunks, the ring, the cluster and the number of
// launches: batch rows beyond sms / (H / 16) slices of 64 rows go to
// further launches of the same kernel, one per row group. Where the slice
// of W_hh does not fit beside a ring of two stages (H above about 1500) or
// H / 16 CTAs exceed the SMs, the wrapper takes the step kernel instead
// (lstm_step_bf16, the first design): one launch per step from a loop in
// the C entry point; a block owns all four gate columns of UH units for RB
// rows and runs 16x16x16 WMMA products straight from L2.
//
// An f32 model (evaluate loads with half=False, a --no-amp validation)
// runs A's f32 persistent kernel (csrc/lstm_f32.cu, on ops/lstm_cuda.py's
// f32_plan: 8 units of f32 W_hh a CTA, h streamed through a ring of bulk
// copies). Where that plan is None, and for comparisons, its earlier
// kernel runs: kernel R's f32 step kernel without its train stores
// (csrc/lstm_train.cu:lstm_recurrence_f32).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "lstm_persistent.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// the step kernel (wide H)
// ---------------------------------------------------------------------------

constexpr int UH = 16;              // hidden units per block
constexpr int RB = 32;              // batch rows per block (two 16-row tiles)
constexpr int KS = 4;               // k-slices (warps per gate)
constexpr int NTHREAD = 4 * KS * 32;
constexpr int GC = 4 * UH;          // gate columns per block

__global__ void __launch_bounds__(NTHREAD)
lstm_step_bf16(const __nv_bfloat16* __restrict__ xw,    // [N, 4H] at t
               const __nv_bfloat16* __restrict__ whh,   // [H, 4H]
               const __nv_bfloat16* __restrict__ h_in,  // [Np, H] bf16(h_{t-1})
               __nv_bfloat16* __restrict__ h_next,      // [Np, H]
               __nv_bfloat16* __restrict__ out,         // [N, H] at t
               float* __restrict__ c,                   // [N, H]
               int N, int H)
{
    __shared__ __align__(32) float part[KS][RB][GC];

    const int warp = threadIdx.x / 32;
    const int gate = warp % 4;
    const int ks = warp / 4;
    const int u0 = blockIdx.x * UH;
    const int r0 = blockIdx.y * RB;
    const int ldw = 4 * H;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB / 16];
#pragma unroll
    for (int i = 0; i < RB / 16; ++i) wmma::fill_fragment(acc[i], 0.f);

    const __nv_bfloat16* wcol = whh + gate * H + u0;
    for (int kt = ks; kt < H / 16; kt += KS) {
        const int k0 = kt * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bfrag;
        wmma::load_matrix_sync(bfrag, wcol + (size_t)k0 * ldw, ldw);
#pragma unroll
        for (int i = 0; i < RB / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> afrag;
            wmma::load_matrix_sync(
                afrag, h_in + (size_t)(r0 + 16 * i) * H + k0, H);
            wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RB / 16; ++i)
        wmma::store_matrix_sync(&part[ks][16 * i][gate * UH], acc[i], GC,
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
            float s = __bfloat162float(xw[(size_t)row * ldw + q * H + unit]);
#pragma unroll
            for (int k = 0; k < KS; ++k) s += part[k][rr][q * UH + u];
            g[q] = s;
        }
        const float ig = sigmoid_f(g[0]);
        const float fg = sigmoid_f(g[1]);
        const float gg = tanhf(g[2]);
        const float og = sigmoid_f(g[3]);
        const size_t idx = (size_t)row * H + unit;
        const float cn = fg * c[idx] + ig * gg;
        c[idx] = cn;
        const __nv_bfloat16 h = __float2bfloat16(og * tanhf(cn));
        out[idx] = h;
        h_next[idx] = h;
    }
}

}  // namespace

// The step kernel. xw [T, N, 4H] bf16, whh [H, 4H] bf16, out [T, N, H]
// bf16; hbuf [2, Np, H] bf16 zeroed, cbuf [N, H] f32 zeroed (both scratch
// from the caller). Np is N rounded up to a multiple of RB; H a multiple of
// 16.
extern "C" int lstm_recurrence_bf16(const void* xw, const void* whh,
                                    void* out, void* hbuf, void* cbuf,
                                    int T, int N, int Np, int H, int reverse,
                                    void* stream)
{
    if (H % UH != 0 || Np % RB != 0 || Np < N || T < 1)
        return (int)cudaErrorInvalidValue;
    const auto* x = static_cast<const __nv_bfloat16*>(xw);
    const auto* w = static_cast<const __nv_bfloat16*>(whh);
    auto* o = static_cast<__nv_bfloat16*>(out);
    auto* hb = static_cast<__nv_bfloat16*>(hbuf);
    auto* c = static_cast<float*>(cbuf);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const dim3 grid(H / UH, Np / RB);
    const size_t plane = (size_t)Np * H;
    for (int step = 0; step < T; ++step) {
        const int t = reverse ? T - 1 - step : step;
        lstm_step_bf16<<<grid, NTHREAD, 0, s>>>(
            x + (size_t)t * N * 4 * H, w, hb + (step & 1) * plane,
            hb + ((step + 1) & 1) * plane, o + (size_t)t * N * H, c, N, H);
        if (step == 0) {
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    return (int)cudaGetLastError();
}

// The persistent kernel, one launch for the batch rows n0 .. n0 + rows - 1:
// lstm_persistent.cuh, persistent_recurrence, says what it takes.
extern "C" int lstm_recurrence_persistent(const void* xw, const void* wt,
                                          void* out, void* hbuf, void* flags,
                                          int T, int N, int n0, int rows,
                                          int H, int mt, int slices, int kc,
                                          int stages, int cluster,
                                          int reverse, void* stream)
{
    return persistent_recurrence<false>(xw, wt, out, nullptr, nullptr, hbuf,
                                        flags, T, N, n0, rows, H, mt, slices,
                                        kc, stages, cluster, reverse, stream);
}
