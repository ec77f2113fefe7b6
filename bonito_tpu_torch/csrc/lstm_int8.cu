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
// 3.35 TB/s). Both are serial in T, so what a design pays per step decides:
// at hac one step's h product is 0.4 us of the tensor cores' peak.
//
// The persistent design (lstm_int8_persistent: kernel A's, csrc/lstm.cu,
// carried over to int8, from the primitives of lstm_persistent.cuh). One
// cooperative launch runs the whole layer; every CTA is resident (one an SM,
// checked with the occupancy API before the launch) and walks all T steps.
//   - A CTA owns 16 hidden units (64 gate columns) and one slice of R batch
//     rows (R = 16..64). Its 64 columns of W_hh_q, k contiguous, are loaded
//     into shared memory once (64 x (H + 16) bytes: 66,560 at hac). In D its
//     64 columns of W_ih_q (64 KB at C 1024) sit in registers for the layer:
//     each warp holds the B fragments of its own k-steps (C / 128 a warp, at
//     most 8: 64 registers a thread), as kernel S holds W_hh.
//   - The products are mma.sync m16n8k32 (s8 in, s32 out): 8 warps, 2 unit
//     groups (8 units x 4 gates) x 4 k-slices, each over all R rows; the
//     k-slices' int32 partial sums meet in shared memory. Integer sums are
//     exact in any order, so they equal the step kernel's.
//   - h_q of step t-1 comes in through a ring: where the ring holds a whole
//     step (at hac one 1024-byte chunk a row), the two CTAs of a cluster
//     (neighbouring unit blocks of one row slice) share its load, each
//     copying half of the rows into both with multicast bulk copies (48 KB a
//     pair a step, half of A's bf16 h); else each CTA loads its own by
//     cp.async through 2 to 8 stages.
//   - D's x product needs no h: it runs between the issue of the step's h
//     copies and their wait, and its partial sums stay in shared memory
//     until the gate math. x[t]'s rows (R x (C + 16) bytes) are staged a
//     step ahead, issued once the h product has read the previous ones; in
//     a cluster each CTA copies half of them into both, after the cluster's
//     barrier (split: arrive after the x product, wait after the h product)
//     shows that the peer has read its own.
//   - Bulk copies cost by count, not bytes, and a warp whose lanes issue
//     many reaches the next barrier last: so rows are copied whole, lane 0
//     of every warp issues a share, and the pairs share x's copies too.
//   - The gate math is the step kernel's, instruction for instruction
//     (__fmul_rn/__fadd_rn, c in f32 registers, expf/tanhf, h_q =
//     __float2int_rn(h * 127)), so at the same inputs the persistent kernel's
//     output equals the step kernel's bit for bit, int8 or bf16.
//   - h_q goes to a ping-pong buffer in global memory; the CTAs of a row
//     slice meet once a step at a counter (a release add, an acquire load),
//     and a wait that cannot end traps rather than holding the card. Rows
//     beyond the batch in the last slice are computed and never written.
// At hac the grid is 64 clusters of 2 unit blocks x 2 row slices of 48 =
// 128 CTAs. D's shared memory: W_hh's slice 66,560 B, the h ring (48 x 1040,
// 49,920 B) under its partial sums (4 x 48 x 72 int32, 55,296 B), x's rows
// (49,920 B) and their partial sums (55,296 B), two mbarriers: 227,088 of
// 232,448 B. W_ih_q's slice in shared memory as well would need 66,560 B
// more; in registers it leaves room for the x region. E keeps W_hh's slice
// and the ring (121,864 B) and prefetches xw (48 x 64 bf16 a CTA) into
// registers a step ahead, as A does. A step is a chain of barriers, and
// every part of it is on the chain (scripts/lstm_step_split.py d leaves
// each out in turn, PERF.md section 5): at hac the two products take about
// half of D's 7.2 us step, the gate math and the partial sums most of the
// rest; the x product hides only in the h loads' 0.6 us.
//
// The shape rule (ops/lstm_int8_cuda.py:persistent_plan, pure Python) picks
// R, the row slices, the chunks, the ring, the cluster and the launches:
// batch rows beyond one grid go to further launches, one per row group. The
// kernel launches exactly that plan or fails. Where the plan is None (C or H
// not a multiple of 32, the k of one int8 product; D's C above 1024, where
// W_ih's slice leaves the registers; H / 16 CTAs beyond the SMs), the
// wrapper takes the step kernel below, the first design.
//
// The step kernel (lstm_int8_step): one launch per timestep from a loop in
// the C entry point (1666 a hac layer, 17 us a step); each block pulls its
// operands from L2 every step (at hac 29 MB a step in all for D: the 8 MB of
// weights once per row block, the 0.2 MB of inputs once per column block).
// A block owns UH hidden units x RB batch rows with all four gate columns, so
// the gate math stays in its epilogue; both products run in the step, with
// the operands staged through shared memory.
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
// x is read with Np rows per step. Its constants' other values are timed in
// PERF.md (scripts/sweep_lstm_int8.py varies them).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <mma.h>
#include <stdint.h>

#include "lstm_persistent.cuh"

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


// ---------------------------------------------------------------------------
// the persistent kernel
// ---------------------------------------------------------------------------

constexpr int IPAD = 16;            // bytes of padding per shared int8 row
constexpr int IKS = 32;             // k (bytes) of one int8 product
constexpr int XKS = 8;              // D: W_ih's k-steps a warp holds
                                    // (C <= 1024)

// The shared memory of one CTA: W_hh's slice; the ring of h chunks, which
// the h product's int32 partial sums reuse; in D x's rows of one step and
// the x product's partial sums beside them; then an mbarrier per ring stage
// and D's one for x.
__host__ __device__ inline size_t i8_part_bytes(int R) {
    return (size_t)PKS * R * LDP * 4;
}
__host__ __device__ inline size_t i8_ring_bytes(int R, int kc, int stages) {
    const size_t ring = (size_t)stages * R * (kc + IPAD);
    return ring > i8_part_bytes(R) ? ring : i8_part_bytes(R);
}
__host__ __device__ inline size_t i8_x_bytes(int R, int C) {
    return (size_t)R * (C + IPAD) + i8_part_bytes(R);
}
__host__ __device__ inline size_t i8_smem_bytes(int R, int C, int H, int kc,
                                                int stages, bool fused) {
    return (size_t)PC * (H + IPAD) + i8_ring_bytes(R, kc, stages)
        + (fused ? i8_x_bytes(R, C) : 0)
        + 8 * (size_t)(stages + (fused ? 1 : 0));
}

// c += a @ b for one 16x8 tile and 32 values of k, int8 in, int32 out
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct PersistI8 {
    const signed char* x;       // D: [T, n_stride, C], this launch's first row
    const __nv_bfloat16* xw;    // E: [T, n_stride, 4H], its first row
    const signed char* wihT;    // D: [4H, C]
    const signed char* whhT;    // [4H, H]
    const float* ihsc;          // D: [4H]
    const float* scale;         // [4H]
    const float* bias;          // D: [4H]
    void* out;                  // [T, n_stride, H], this launch's first row
    signed char* hbuf;          // [2, slices * R, H], zeroed
    unsigned* flags;            // [slices], zeroed
    int T, n_stride, rows, C, H, kc, stages, reverse, g_u;
    int cluster;                // CTAs that share each h load: 1 or 2
};

// MT: m-tiles of 16 rows per CTA (R = 16 MT); FUSED: D (the x product
// inside), else E (xw read); OUT_INT8: D's out is h_q, else bf16(h)
template <int MT, bool FUSED, bool OUT_INT8>
__global__ void __launch_bounds__(PTHREADS, 1)
lstm_int8_persistent(PersistI8 p)
{
    constexpr int R = 16 * MT;
    // (row, unit)s a thread
    constexpr int EU = (R * PU + PTHREADS - 1) / PTHREADS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int H = p.H, C = p.C, kc = p.kc, stages = p.stages;
    const int ldw = H + IPAD, ldr = kc + IPAD, ldx = C + IPAD;
    signed char* Ws = reinterpret_cast<signed char*>(smem_raw);
    unsigned char* ring_raw = smem_raw + (size_t)PC * ldw;
    signed char* ring = reinterpret_cast<signed char*>(ring_raw);
    int* part = reinterpret_cast<int*>(ring_raw);
    unsigned char* x_raw = ring_raw + i8_ring_bytes(R, kc, stages);
    signed char* xs = reinterpret_cast<signed char*>(x_raw);
    int* xpart = reinterpret_cast<int*>(x_raw + (size_t)R * ldx);
    uint64_t* mbar = reinterpret_cast<uint64_t*>(
        x_raw + (FUSED ? i8_x_bytes(R, C) : 0));
    uint64_t* xbar = mbar + stages;
    const bool shared_h = p.cluster > 1;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int slice = blockIdx.x / p.g_u;
    const int u0 = (blockIdx.x % p.g_u) * PU;
    const int row0 = slice * R;
    const int live_rows = min(R, p.rows - row0);

    // W_hh's slice, once, as A's: shared row 8 nt + uu (n-tile nt = 4 j + q)
    // is gate q of unit u0 + 8 j + uu, its H values of k contiguous
    for (int e = tid; e < PC * (H / 16); e += PTHREADS) {
        const int col = e / (H / 16), k16 = (e % (H / 16)) * 16;
        const int q = (col >> 3) & 3, unit = u0 + (col >> 5) * 8 + (col & 7);
        cp_async16(Ws + (size_t)col * ldw + k16,
                   p.whhT + (size_t)(q * H + unit) * H + k16);
    }
    cp_async_commit();
    if (shared_h || FUSED) {
        // with a cluster the ring's waits are on mbarriers, so W_hh's slice
        // is waited for here; the barrier then shows the mbarriers and the
        // slice to every thread of the cluster
        if (shared_h) cp_async_wait(0);
        if (tid == 0) {
            if (shared_h)
                for (int c = 0; c < stages; ++c) mbar_init(mbar + c, 1);
            if (FUSED) mbar_init(xbar, 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        if (shared_h) cluster_sync(); else __syncthreads();
    }

    const int j = warp / PKS, ks = warp % PKS;      // unit group, k-slice
    const int g = lane >> 2, c4 = lane & 3;
    // ldmatrix lane addressing in bytes: A (rows of h or x), B (W_hh rows,
    // two n-tiles)
    const int a_row = lane & 15, a_col = (lane >> 4) * 16;
    const int b_row = j * 32 + (lane >> 4) * 8 + (lane & 7);
    const int b_col = ((lane >> 3) & 1) * 16;

    // D: the B fragments of W_ih_q for this warp's k-steps kt = ks + 4 i and
    // its four n-tiles (column g of n-tile q: gate q of unit u0 + 8 j + g),
    // in registers for the layer
    const int nkx = FUSED ? C / IKS : 0;
    uint32_t wih[XKS][4][2];
    if constexpr (FUSED) {
#pragma unroll
        for (int i = 0; i < XKS; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int kt = ks + PKS * i;
                uint32_t b0 = 0, b1 = 0;
                if (kt < nkx) {
                    const signed char* w = p.wihT
                        + (size_t)(q * H + u0 + j * 8 + g) * C + kt * IKS
                        + 4 * c4;
                    b0 = *reinterpret_cast<const uint32_t*>(w);
                    b1 = *reinterpret_cast<const uint32_t*>(w + 16);
                }
                wih[i][q][0] = b0;
                wih[i][q][1] = b1;
            }
    }

    // the (row, unit)s this thread updates, fixed for the layer: c stays in
    // registers; every one of them is unit tid % 16, so its scales are too
    int er[EU];
    bool live[EU];
    float c[EU];
    __nv_bfloat16 xb[EU][4];    // E: xw of the coming step
    const int uu = tid % PU;
    const int col_u = (uu >> 3) * 32 + (uu & 7);    // its partials' column
    float sc[4], ihs[4], bi[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        sc[q] = p.scale[q * H + u0 + uu];
        ihs[q] = FUSED ? p.ihsc[q * H + u0 + uu] : 0.f;
        bi[q] = FUSED ? p.bias[q * H + u0 + uu] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < EU; ++i) {
        const int e = tid + i * PTHREADS;
        er[i] = e / PU;
        live[i] = e < R * PU && row0 + er[i] < p.rows;
        c[i] = 0.f;
    }
    const size_t xw_t = (size_t)p.n_stride * 4 * H;
    const size_t out_t = (size_t)p.n_stride * H;

    // each k-slice's partial sums of one product: part[ks][row][8 nt + unit]
    auto store_partials = [&](int* dst, const int (&acc)[MT][4][4]) {
        int* mine = dst + (size_t)ks * R * LDP;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = j * 32 + q * 8 + 2 * c4;
                const int r = m * 16 + g;
                *reinterpret_cast<int2*>(mine + r * LDP + col) =
                    make_int2(acc[m][q][0], acc[m][q][1]);
                *reinterpret_cast<int2*>(mine + (r + 8) * LDP + col) =
                    make_int2(acc[m][q][2], acc[m][q][3]);
            }
    };
    auto sum_partials = [&](const int* src, int r, int q) {
        int s = 0;
#pragma unroll
        for (int k = 0; k < PKS; ++k)
            s += src[((size_t)k * R + r) * LDP + col_u + q * 8];
        return s;
    };

    // D: x's rows of step t, one bulk copy a row, counted by xbar. Lane 0
    // of every warp issues a share (no warp falls behind the others), and
    // with a cluster each CTA copies half of the rows into both (the rows
    // are the same: the pair shares its row slice).
    auto load_x = [&](int t) {
        if (tid == 0) mbar_expect_tx(xbar, (unsigned)(live_rows * C));
        if (lane != 0) return;
        const unsigned rank = shared_h ? cluster_rank() : 0;
        for (int r = warp * p.cluster + (int)rank; r < live_rows;
             r += PWARPS * p.cluster) {
            signed char* dst = xs + (size_t)r * ldx;
            const signed char* src =
                p.x + ((size_t)t * p.n_stride + row0 + r) * C;
            if (shared_h)
                bulk_multicast(dst, src, (unsigned)C, xbar,
                               (uint16_t)((1u << p.cluster) - 1));
            else
                bulk_copy(dst, src, (unsigned)C, xbar);
        }
    };
    // D: the x product of the step whose rows xbar counts (phase `parity`):
    // each k-slice's partial sums into xpart, read at the step's gate math
    auto x_product = [&](unsigned parity) {
        mbar_wait(xbar, parity);
        int acc[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][q][e] = 0;
#pragma unroll
        for (int i = 0; i < XKS; ++i) {
            const int kt = ks + PKS * i;
            if (kt < nkx) {
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    uint32_t a[4];
                    ldmatrix_x4(a, xs + (size_t)(m * 16 + a_row) * ldx
                                   + kt * IKS + a_col);
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        mma_s8(acc[m][q], a, wih[i][q][0], wih[i][q][1]);
                }
            }
        }
        store_partials(xpart, acc);
        // the next step's rows of x land (async proxy) where these were
        // read (generic proxy); with a cluster the peer copies them, once
        // both CTAs have arrived here (the cluster's barrier, split: its
        // wait follows the h product)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        if (shared_h)
            asm volatile("barrier.cluster.arrive.release.aligned;\n" :::
                         "memory");
    };
    // E: xw of step t for this thread's (row, unit)s
    auto fetch_xw = [&](int t) {
#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            const __nv_bfloat16* xr = p.xw + t * xw_t
                + (size_t)(row0 + er[i]) * 4 * H + u0 + uu;
#pragma unroll
            for (int q = 0; q < 4; ++q) xb[i][q] = xr[q * H];
        }
    };

    if constexpr (FUSED) load_x(p.reverse ? p.T - 1 : 0);
    else fetch_xw(p.reverse ? p.T - 1 : 0);

    const int n_chunks = H / kc;
    const size_t plane = (size_t)gridDim.x / p.g_u * R * H;
    const unsigned rank = shared_h ? cluster_rank() : 0;
    const int share = R / p.cluster;

    for (int step = 0; step < p.T; ++step) {
        const int t = p.reverse ? p.T - 1 - step : step;
        const signed char* h_in = p.hbuf + (size_t)(step & 1) * plane
                                  + (size_t)row0 * H;
        signed char* h_out = p.hbuf + (size_t)((step + 1) & 1) * plane;

        // h_{t-1} of this slice is complete once its g_u CTAs have counted
        // step - 1 (an acquire load, then the CTA's barrier)
        if (step > 0) {
            if (tid == 0) wait_count(p.flags + slice, (unsigned)step * p.g_u);
            __syncthreads();
        }

        auto load_chunk = [&](int ch) {
            signed char* dst = ring + (size_t)(ch % stages) * R * ldr;
            const signed char* src = h_in + ch * kc;
            for (int e = tid; e < R * (kc / 16); e += PTHREADS) {
                const int r = e / (kc / 16), k16 = (e % (kc / 16)) * 16;
                cp_async16(dst + r * ldr + k16, src + (size_t)r * H + k16);
            }
        };
        if (shared_h) {
            // every chunk of the step at once: each CTA of the cluster
            // copies its share of the rows into the shared memory of both,
            // one bulk copy a row and chunk, chunk 0's first, lane 0 of
            // every warp issuing a share (as x's)
            if (tid == 0)
                for (int ch = 0; ch < n_chunks; ++ch)
                    mbar_expect_tx(mbar + ch, (unsigned)(R * kc));
            if (lane == 0) {
                // h_in was written through the generic proxy and acquired
                // above; the bulk copies read it through the async proxy
                asm volatile("fence.proxy.async.global;\n" ::: "memory");
                for (int e = warp; e < share * n_chunks; e += PWARPS) {
                    const int ch = e / share;
                    const int r = (int)rank * share + e % share;
                    bulk_multicast(ring + ((size_t)ch * R + r) * ldr,
                                   h_in + (size_t)r * H + ch * kc,
                                   (unsigned)kc, mbar + ch,
                                   (uint16_t)((1u << p.cluster) - 1));
                }
            }
        } else {
            for (int ch = 0; ch < stages - 1; ++ch) {
                if (ch < n_chunks) load_chunk(ch);
                cp_async_commit();
            }
        }

        // D: the x product, off the chain: it needs no h, and runs while
        // the h loads are in flight
        if constexpr (FUSED) x_product((unsigned)(step & 1));

        int acc[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][q][e] = 0;

        for (int ch = 0; ch < n_chunks; ++ch) {
            if (shared_h) {             // chunk ch is in, from every copier
                mbar_wait(mbar + ch, (unsigned)(step & 1));
            } else {
                cp_async_wait(stages - 2);
                __syncthreads();        // chunk ch is in; ch - 1 is read
                if (ch + stages - 1 < n_chunks) load_chunk(ch + stages - 1);
                cp_async_commit();
            }
            const signed char* hs = ring + (size_t)(ch % stages) * R * ldr;
            const signed char* ws = Ws + (size_t)b_row * ldw + ch * kc + b_col;
#pragma unroll 4
            for (int kt = ks; kt < kc / IKS; kt += PKS) {
                uint32_t b01[4], b23[4];
                ldmatrix_x4(b01, ws + kt * IKS);
                ldmatrix_x4(b23, ws + (size_t)16 * ldw + kt * IKS);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    uint32_t a[4];
                    ldmatrix_x4(a, hs + (m * 16 + a_row) * ldr + kt * IKS
                                   + a_col);
                    mma_s8(acc[m][0], a, b01[0], b01[1]);
                    mma_s8(acc[m][1], a, b01[2], b01[3]);
                    mma_s8(acc[m][2], a, b23[0], b23[1]);
                    mma_s8(acc[m][3], a, b23[2], b23[3]);
                }
            }
        }
        __syncthreads();    // every warp is done with the ring and x's rows
        if constexpr (FUSED) {
            if (shared_h)   // and the peer's warps with theirs
                asm volatile("barrier.cluster.wait.acquire.aligned;\n" :::
                             "memory");
            if (step + 1 < p.T) load_x(p.reverse ? t - 1 : t + 1);
        }
        store_partials(part, acc);
        __syncthreads();

        // the step kernel's gate math, operation for operation
#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            float gt[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const float rec = __fmul_rn(
                    (float)sum_partials(part, er[i], q), sc[q]);
                const float xwv = FUSED
                    ? __fadd_rn(__fmul_rn((float)sum_partials(xpart, er[i], q),
                                          ihs[q]), bi[q])
                    : __bfloat162float(xb[i][q]);
                gt[q] = __fadd_rn(xwv, rec);
            }
            const float ig = sigmoid_f(gt[0]);
            const float fg = sigmoid_f(gt[1]);
            const float gg = tanhf(gt[2]);
            const float og = sigmoid_f(gt[3]);
            c[i] = __fadd_rn(__fmul_rn(fg, c[i]), __fmul_rn(ig, gg));
            const float h = __fmul_rn(og, tanhf(c[i]));
            const signed char hq =
                (signed char)__float2int_rn(__fmul_rn(h, 127.f));
            const size_t idx = (size_t)(row0 + er[i]) * H + u0 + uu;
            h_out[idx] = hq;
            if (OUT_INT8)
                static_cast<signed char*>(p.out)[t * out_t + idx] = hq;
            else
                static_cast<__nv_bfloat16*>(p.out)[t * out_t + idx] =
                    __float2bfloat16(h);
        }
        // count this CTA's step: its h writes (the CTA's barrier), then the
        // release. With a cluster, the peer's multicast of the next step
        // (async proxy) lands in the ring that the partial sums just used
        // (generic proxy): a proxy fence orders the two.
        if (shared_h)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) red_release(p.flags + slice, 1u);
        // E: the next step's xw, after the release so that no fence waits
        // for these loads
        if constexpr (!FUSED)
            if (step + 1 < p.T) fetch_xw(p.reverse ? t - 1 : t + 1);
    }
    if (shared_h) cluster_sync();   // no CTA leaves while copies are due
}

template <bool FUSED, bool OUT_INT8>
cudaError_t launch_int8(const PersistI8& p, int mt, int slices, size_t smem,
                        cudaStream_t s)
{
    const long long grid = (long long)p.g_u * slices;
    switch (mt) {
    case 1: return launch_resident(lstm_int8_persistent<1, FUSED, OUT_INT8>,
                                   grid, smem, p.cluster, s, p);
    case 2: return launch_resident(lstm_int8_persistent<2, FUSED, OUT_INT8>,
                                   grid, smem, p.cluster, s, p);
    case 3: return launch_resident(lstm_int8_persistent<3, FUSED, OUT_INT8>,
                                   grid, smem, p.cluster, s, p);
    default: return launch_resident(lstm_int8_persistent<4, FUSED, OUT_INT8>,
                                    grid, smem, p.cluster, s, p);
    }
}

// One launch of the persistent kernel for the batch rows n0 .. n0 + rows - 1
// (p's pointers at row 0, p.rows unset): what ops/lstm_int8_cuda.py's
// persistent_plan gives, or cudaErrorInvalidValue.
int run_persistent(PersistI8 p, bool fused, bool out_int8, int N, int n0,
                   int rows, int mt, int slices, cudaStream_t stream)
{
    const int H = p.H, C = p.C, kc = p.kc, stages = p.stages;
    if (p.T < 1 || rows < 1 || n0 < 0 || n0 + rows > N || H < IKS
        || H % IKS || (fused && (C < IKS || C % IKS || C > IKS * PKS * XKS))
        || mt < 1 || mt > 4 || slices < 1 || slices * 16 * mt < rows
        || (slices - 1) * 16 * mt >= rows || kc < IKS || kc % IKS
        || H % kc || stages < 3 - p.cluster || stages > 8
        || (p.cluster != 1 && p.cluster != 2)
        || (p.cluster == 2 && ((H / PU) % 2 || stages != H / kc)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = i8_smem_bytes(16 * mt, C, H, kc, stages, fused);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    p.rows = rows;
    p.n_stride = N;
    p.g_u = H / PU;
    if (fused) p.x += (size_t)n0 * C;
    else p.xw += (size_t)n0 * 4 * H;
    p.out = static_cast<char*>(p.out) + (size_t)n0 * H * (out_int8 ? 1 : 2);
    cudaError_t err;
    if (fused && out_int8)
        err = launch_int8<true, true>(p, mt, slices, smem, stream);
    else if (fused)
        err = launch_int8<true, false>(p, mt, slices, smem, stream);
    else
        err = launch_int8<false, false>(p, mt, slices, smem, stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
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

// Kernel D, persistent: one launch for the batch rows n0 .. n0 + rows - 1 of
// x [T, N, C] int8 and out [T, N, H] (int8 with out_int8, else bf16); wihT,
// whhT, ihsc, scale, bias as for lstm_int8_fused. hbuf [2, slices * 16 mt,
// H] int8 and flags [slices] int32 are zeroed scratch. C and H multiples of
// 32, C <= 1024; kc a multiple of 32 that divides H; 2 <= stages <= 8;
// cluster 2 where H / 16 is even and the ring holds all H / kc chunks. The
// grid is (H / 16) x slices CTAs of 256 threads; it returns
// cudaErrorCooperativeLaunchTooLarge where they cannot all be resident.
extern "C" int lstm_int8_fused_persistent(
    const void* x, const void* wihT, const void* whhT, const void* ihsc,
    const void* scale, const void* bias, void* out, int out_int8, void* hbuf,
    void* flags, int T, int N, int n0, int rows, int C, int H, int mt,
    int slices, int kc, int stages, int cluster, int reverse, void* stream)
{
    PersistI8 p = {};
    p.x = static_cast<const signed char*>(x);
    p.wihT = static_cast<const signed char*>(wihT);
    p.whhT = static_cast<const signed char*>(whhT);
    p.ihsc = static_cast<const float*>(ihsc);
    p.scale = static_cast<const float*>(scale);
    p.bias = static_cast<const float*>(bias);
    p.out = out;
    p.hbuf = static_cast<signed char*>(hbuf);
    p.flags = static_cast<unsigned*>(flags);
    p.T = T;
    p.C = C;
    p.H = H;
    p.kc = kc;
    p.stages = stages;
    p.reverse = reverse;
    p.cluster = cluster;
    return run_persistent(p, true, out_int8 != 0, N, n0, rows, mt, slices,
                          static_cast<cudaStream_t>(stream));
}

// Kernel E, persistent: as D's, over xw [T, N, 4H] bf16, out [T, N, H] bf16.
extern "C" int lstm_int8_recurrence_persistent(
    const void* xw, const void* whhT, const void* scale, void* out,
    void* hbuf, void* flags, int T, int N, int n0, int rows, int H, int mt,
    int slices, int kc, int stages, int cluster, int reverse, void* stream)
{
    PersistI8 p = {};
    p.xw = static_cast<const __nv_bfloat16*>(xw);
    p.whhT = static_cast<const signed char*>(whhT);
    p.scale = static_cast<const float*>(scale);
    p.out = out;
    p.hbuf = static_cast<signed char*>(hbuf);
    p.flags = static_cast<unsigned*>(flags);
    p.T = T;
    p.H = H;
    p.kc = kc;
    p.stages = stages;
    p.reverse = reverse;
    p.cluster = cluster;
    return run_persistent(p, false, false, N, n0, rows, mt, slices,
                          static_cast<cudaStream_t>(stream));
}
