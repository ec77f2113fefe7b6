// Kernels R and S: the LSTM recurrence of a training step, forward and
// backward through time (BPTT).
//
// Replace bonito_tpu/ops/lstm_pallas.py:lstm_pallas_train (`_lstm_rec`):
// R is `_lstm_train_fwd_kernel`, S is `_lstm_train_bwd_kernel`. Given the
// input projection xw = x @ W_ih + b ([T, N, 4H] in the model's type Io,
// bf16 or f32, computed outside by torch.matmul under autograd, as the TPU
// package left it to XLA) and W_hh [H, 4H] in Io, torch gate order
// (i, f, g, o):
//
// R, each step (t = 0 .. T-1, or T-1 .. 0 with `reverse`, written at t):
//     gates = f32(xw[t]) + Io(h) @ W_hh          (f32 accumulation)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the gate blocks
//     c = f*c + i*g;  h = o*tanh(c)             (h and c carried in f32)
//     h_out[t] = Io(h); c_out[t] = St(c); acts[t] = St([i, f, g, o])
// S, walking the recurrence's steps last to first, with dh and dc carried
// in f32 (both 0 before the last step), c_prev the recurrence's previous
// step (t-1, or t+1 with `reverse`; 0 at its first step):
//     dh += f32(g_h[t]);  tc = tanh(c)         (g_h in Io)
//     do = dh*tc;  dc += dh*o*(1 - tc*tc)
//     dgates = [dc*g*i*(1-i), dc*c_prev*f*(1-f), dc*i*(1-g*g), do*o*(1-o)]
//     dgates_out[t] = St(dgates)
//     dh = Io(dgates) @ W_hh^T (f32 accumulation);  dc = dc*f
// St, the type c, acts and dgates are stored in, is bf16 where bonito_tpu's
// kernel route runs (its `supported_train` gate) and f32 where its scan
// runs: one template flag. dW_hh = sum_t h_prev^T dgates and the
// projection's gradients are torch.matmul outside (ops/lstm.py).
//
// What bounds them on an H100: per layer each does 2*N*H*4H*T operations
// on the tensor cores (hac training, N 128, T 1000, H 1024: 1.07e12, 1.09
// ms at 989 TFLOP/s) against about 2.6 GB of traffic (xw in, h, c and acts
// out; acts, c, c_prev and g_h in, dgates out: 0.78 ms at 3.35 TB/s). Both
// are serial in T, so what a step costs decides. Two designs:
//
// The persistent kernels (bf16 model, bf16 storage; the plans in
// ops/lstm_train_cuda.py, forward_plan and backward_plan): one cooperative
// launch per row group walks the whole layer, every CTA resident, the CTAs
// of a row slice meeting at a counter in global memory once a step.
//   - R is kernel A's kernel (lstm_persistent.cuh) with the train stores:
//     c_t and the four activations. At one plan its h is A's bit for bit.
//     At hac training A's plan is 64 unit blocks x 2 slices of 64 rows =
//     128 CTAs, 256-wide chunks of h in 2 stages, no cluster (64 rows of
//     a whole step's h do not fit beside W_hh's slice).
//   - S: dh of a unit needs the whole step's dgates over all 4H columns.
//     A cluster of C CTAs (neighbouring unit blocks of one row slice)
//     splits those columns: rank r holds W_hh's rows of the cluster's 16 C
//     units over the KC = 4H / C columns from r KC, and computes the
//     partial dh of all 16 C units over them; each owner of 16 units gets
//     its part through distributed shared memory, a slot per rank, sums
//     the slots in rank order (one sum order: the result is deterministic)
//     after the cluster's barrier, and runs the elementwise step for its
//     units, carrying dc in registers and fetching the next step's inputs
//     while this one runs. Where the storage is the model's type (bf16
//     under amp) the next step reads dgates itself: no second copy.
//     The block of W_hh is held in registers, not shared memory: warp w of
//     the 8 holds the A fragments of the cluster's units over its k-slice
//     of KC / 8 columns (H / 8 registers a thread, 128 at hac), and the
//     rows of dgates are the B operand (mma.sync m16n8k16, n = rows). So
//     the shared memory holds a ring of 16-row chunks (8 where a CTA has 16
//     rows) of whole rows (one bulk copy of a row's KC columns each, 4 KB
//     at hac), the warps' f32 partial sums and the received slots.
//   What sized it, all on an H100 (80GB HBM3, 700 W; scripts/
//   lstm_step_split.py s, hac training, N 128, T 1000, H 1024):
//   - the card holds 120 CTAs in clusters of 4 or of 8, and 132 in
//     clusters of 2 (the occupancy API); hac training needs 128 (2 slices
//     of 64 rows x 64 unit blocks), so C is 2 there, and each CTA reads
//     64 rows x 2048 columns = 256 KB of dgates a step (C = 8 would read 64
//     KB). C = 1, A's layout transposed (a CTA reads all 4H columns of its
//     rows, 512 KB a step), took 18.15 us a step against C = 2's 13.65 in
//     8-row chunks. Clusters that multicast dgates to the CTAs of one
//     k-range would need clusters of 4 or more beside the k-split: not
//     resident either.
//   - smaller batches fit wider clusters, but their grids are half as
//     wide: at N 64 (the train CLI's default batch) C = 4 (one slice of 64
//     rows, 64 CTAs) took 10.86 us a step against C = 2's 7.823 (two
//     slices of 32, 128 CTAs); at N 32 C = 8 6.815 and C = 4 6.108 against
//     C = 2's 5.038, C = 1 6.967 (lstm_step_split.py s 64, s 32). So S is
//     built in clusters of 1 and 2 only.
//   - an earlier form held W_hh's block in shared memory and read dgates
//     in column chunks (a bulk copy per row and chunk, 512 to 1024 copies
//     a step): 27.52 us a step at 256-wide chunks, 45.92 at 128, 86.09 at
//     64; leaving the loads out saved 35.1 of 45.94 us. The copies' count,
//     not their bytes, set the pace; whole rows, 64 copies a step, freed it.
//   - 8-row chunks (one n-tile, two accumulators a warp): 13.65 us a step,
//     the products 3.51 of it; 16-row chunks: 11.87 us. Its parts (each
//     left out in turn): the dgates loads 4.18 us (256 KB: about 61 KB/us
//     into the SM), the products 2.61, the elementwise part 1.66, the
//     exchange (the warps' partials summed, the stores into the owners'
//     shared memory, the cluster's barrier) 1.30, the wait at the counter
//     0.76.
//
// An f32 model (training without amp) runs R and S on their own persistent
// kernels, csrc/lstm_f32.cu (ops/lstm_train_cuda.py: A's f32_plan and
// f32_backward_plan).
//
// The step kernels (lstm_train_fwd_step, lstm_train_bwd_step: the first
// design; a bf16 model with f32 storage, an H the plans do not take, and
// comparisons): one launch per step from a loop inside the C entry point;
// a block owns all four gate columns of UH hidden units for RB batch rows;
// in bf16 16 warps run 16x16x16 WMMA products with f32 accumulators
// straight from L2. In f32 the same layout has its products on the f32
// cores, since the tensor cores would round the operands to TF32: 8
// warps, tiles of h and of W_hh's 64 columns staged in shared memory, each
// thread 2 rows x 4 columns, its sums over k in order (R), or one thread
// an output of dh over all 4H k (S); slower, its numbers exact f32 (at the
// --no-amp batch, N 16, T 500, H 1024: R 25.8, S 153.4 ms, PERF.md). Kernel
// A's earlier f32 kernel (an f32 model's inference, where A's f32 plan
// gives None, and A's comparisons; A's own is csrc/lstm_f32.cu) is this
// kernel without the stores of c and the activations
// (lstm_recurrence_f32).
// S's launch j first computes its block's dh = Io(dgates_{j-1}) @ W_hh^T
// (read from an Io copy that launch j-1 wrote in full), then, for its own
// units, step j's dgates and dc. The Io copy of dgates and Io(h) are
// ping-ponged between two buffers of Np >= N rows whose padding rows stay
// zero. At hac training these take 33.85 (R) and 31.86 ms (S) a layer
// (chip_smoke.py phase 10, the same card).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <type_traits>

#include "lstm_persistent.cuh"

using namespace nvcuda;

namespace {

constexpr int UH = 16;              // hidden units per block
constexpr int RB = 32;              // batch rows per block (two 16-row tiles)
constexpr int NWARP = 16;
constexpr int NTHREAD = NWARP * 32;
constexpr int GC = 4 * UH;          // gate columns per block (R)
constexpr int KS = NWARP / 4;       // R in bf16: k-slices per gate
constexpr int FTHREAD = 256;        // R in f32: 16 row pairs x 16 column quads

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const bf16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(bf16* p, float v) {
    *p = __float2bfloat16(v);
}

// R's product for one block: part[k][r][q*UH + u] summed over k gives
// (Io(h) @ W_hh)[r0 + r, q*H + u0 + u]. bf16: WMMA over KS k-slices; f32:
// shared-memory tiles, the whole k range into part[0].
__device__ __forceinline__ void fwd_product(
    const bf16* whh, const bf16* h_in, float (*part)[RB][GC], int u0, int r0,
    int H)
{
    const int warp = threadIdx.x / 32;
    const int gate = warp % 4;
    const int ks = warp / 4;
    const int ldw = 4 * H;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB / 16];
#pragma unroll
    for (int i = 0; i < RB / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    const bf16* wcol = whh + gate * H + u0;
    for (int kt = ks; kt < H / 16; kt += KS) {
        const int k0 = kt * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
            bfrag;
        wmma::load_matrix_sync(bfrag, wcol + (size_t)k0 * ldw, ldw);
#pragma unroll
        for (int i = 0; i < RB / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                afrag;
            wmma::load_matrix_sync(
                afrag, h_in + (size_t)(r0 + 16 * i) * H + k0, H);
            wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RB / 16; ++i)
        wmma::store_matrix_sync(&part[ks][16 * i][gate * UH], acc[i], GC,
                                wmma::mem_row_major);
}

// f32: the tiles of h (RB rows) and of W_hh's GC columns (KT k each)
// staged in shared memory, each of FTHREAD threads 2 rows x 4 columns of
// one gate, its sums over k in order; the f32 sum needs part[0] only, so
// the tiles sit in part[1] and part[2].
template <int KT>
__device__ __forceinline__ void fwd_product_tiles(
    const float* whh, const float* h_in, float (*part)[RB][GC], int u0,
    int r0, int H)
{
    static_assert(RB * (KT + 4) <= RB * GC && KT <= RB, "tiles in part");
    float (*hs)[KT + 4] = reinterpret_cast<float (*)[KT + 4]>(part[1]);
    float (*ws)[GC] = part[2];
    const int tid = threadIdx.x;
    const int rp = tid / 16, cq = tid % 16;  // rows 2rp, 2rp+1; columns 4cq..
    const int ldw = 4 * H;
    float acc[2][4] = {};
    for (int k0 = 0; k0 < H; k0 += KT) {
        for (int e = tid; e < RB * KT / 4; e += FTHREAD) {
            const int row = e / (KT / 4), k4 = e % (KT / 4);
            *reinterpret_cast<float4*>(&hs[row][4 * k4]) =
                *reinterpret_cast<const float4*>(
                    h_in + (size_t)(r0 + row) * H + k0 + 4 * k4);
        }
        // local column 4 c4 + i is gate c4 / 4, unit 4 (c4 % 4) + i
        for (int e = tid; e < KT * GC / 4; e += FTHREAD) {
            const int k = e / (GC / 4), c4 = e % (GC / 4);
            *reinterpret_cast<float4*>(&ws[k][4 * c4]) =
                *reinterpret_cast<const float4*>(
                    whh + (size_t)(k0 + k) * ldw + (c4 / 4) * H + u0
                    + 4 * (c4 % 4));
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
            const float a0 = hs[2 * rp][kk], a1 = hs[2 * rp + 1][kk];
            const float4 w = *reinterpret_cast<const float4*>(&ws[kk][4 * cq]);
            acc[0][0] = fmaf(a0, w.x, acc[0][0]);
            acc[0][1] = fmaf(a0, w.y, acc[0][1]);
            acc[0][2] = fmaf(a0, w.z, acc[0][2]);
            acc[0][3] = fmaf(a0, w.w, acc[0][3]);
            acc[1][0] = fmaf(a1, w.x, acc[1][0]);
            acc[1][1] = fmaf(a1, w.y, acc[1][1]);
            acc[1][2] = fmaf(a1, w.z, acc[1][2]);
            acc[1][3] = fmaf(a1, w.w, acc[1][3]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int i = 0; i < 4; ++i) part[0][2 * rp + r][4 * cq + i] = acc[r][i];
}

__device__ __forceinline__ void fwd_product(
    const float* whh, const float* h_in, float (*part)[RB][GC], int u0,
    int r0, int H)
{
    if (H % 32 == 0)
        fwd_product_tiles<32>(whh, h_in, part, u0, r0, H);
    else
        fwd_product_tiles<16>(whh, h_in, part, u0, r0, H);
}

// S's product for one block: the sum over k of part[k][r][u] is
// (Io(dgates) @ W_hh^T)[r0 + r, u0 + u]. bf16: B(k, n) = W[u0 + n, k], a
// column-major tile of W's rows, the 4H/16 k-tiles dealt round-robin to the
// warps; f32: one output per thread over the whole k range (part[0]).
__device__ __forceinline__ void bwd_product(
    const bf16* whh, const bf16* dg_in, float (*part)[RB][UH], int u0,
    int r0, int H)
{
    const int warp = threadIdx.x / 32;
    const int ldw = 4 * H;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[RB / 16];
#pragma unroll
    for (int i = 0; i < RB / 16; ++i) wmma::fill_fragment(acc[i], 0.f);
    const bf16* wrow = whh + (size_t)u0 * ldw;
    for (int kt = warp; kt < ldw / 16; kt += NWARP) {
        const int k0 = kt * 16;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
            bfrag;
        wmma::load_matrix_sync(bfrag, wrow + k0, ldw);
#pragma unroll
        for (int i = 0; i < RB / 16; ++i) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
                afrag;
            wmma::load_matrix_sync(
                afrag, dg_in + (size_t)(r0 + 16 * i) * ldw + k0, ldw);
            wmma::mma_sync(acc[i], afrag, bfrag, acc[i]);
        }
    }
#pragma unroll
    for (int i = 0; i < RB / 16; ++i)
        wmma::store_matrix_sync(&part[warp][16 * i][0], acc[i], UH,
                                wmma::mem_row_major);
}

__device__ __forceinline__ void bwd_product(
    const float* whh, const float* dg_in, float (*part)[RB][UH], int u0,
    int r0, int H)
{
    const int rr = threadIdx.x / UH, u = threadIdx.x % UH;
    const int ldw = 4 * H;
    const float4* d = reinterpret_cast<const float4*>(
        dg_in + (size_t)(r0 + rr) * ldw);
    const float4* w = reinterpret_cast<const float4*>(
        whh + (size_t)(u0 + u) * ldw);
    float acc = 0.f;
    for (int k = 0; k < ldw / 4; ++k) {
        const float4 a = d[k], b = w[k];
        acc += a.x * b.x;
        acc += a.y * b.y;
        acc += a.z * b.z;
        acc += a.w * b.w;
    }
    part[0][rr][u] = acc;
}

// the threads of R's step kernel: NTHREAD in bf16, FTHREAD in f32
template <typename Io>
__host__ __device__ constexpr int fwd_threads() {
    return std::is_same<Io, bf16>::value ? NTHREAD : FTHREAD;
}

// R, one step: as kernel A's, with c and the activations kept for S. With
// a_out null it stores h only: kernel A's f32 instance (lstm_recurrence_f32).
template <typename Io, typename St>
__global__ void __launch_bounds__(NTHREAD)
lstm_train_fwd_step(const Io* __restrict__ xw,    // [N, 4H] at t
                    const Io* __restrict__ whh,   // [H, 4H]
                    const Io* __restrict__ h_in,  // [Np, H] Io(h_{t-1})
                    Io* __restrict__ h_next,      // [Np, H]
                    Io* __restrict__ h_out,       // [N, H] at t
                    St* __restrict__ c_out,       // [N, H] at t
                    St* __restrict__ a_out,       // [N, 4H] at t
                    float* __restrict__ c,        // [N, H] carried
                    int N, int H)
{
    constexpr int nks = std::is_same<Io, bf16>::value ? KS : 1;
    constexpr int nthr = fwd_threads<Io>();
    __shared__ __align__(32) float part[KS][RB][GC];
    const int u0 = blockIdx.x * UH;
    const int r0 = blockIdx.y * RB;
    const int ldw = 4 * H;

    fwd_product(whh, h_in, part, u0, r0, H);
    __syncthreads();

    for (int e = threadIdx.x; e < RB * UH; e += nthr) {
        const int rr = e / UH, u = e % UH;
        const int row = r0 + rr;
        if (row >= N) continue;
        const int unit = u0 + u;
        float g[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float s = load_f(xw + (size_t)row * ldw + q * H + unit);
#pragma unroll
            for (int k = 0; k < nks; ++k) s += part[k][rr][q * UH + u];
            g[q] = s;
        }
        const float ig = sigmoid_f(g[0]);
        const float fg = sigmoid_f(g[1]);
        const float gg = tanhf(g[2]);
        const float og = sigmoid_f(g[3]);
        const size_t idx = (size_t)row * H + unit;
        const float cn = fg * c[idx] + ig * gg;
        c[idx] = cn;
        const float h = og * tanhf(cn);
        store_f(h_out + idx, h);
        store_f(h_next + idx, h);
        if (a_out == nullptr) continue;  // uniform: kernel A in f32
        store_f(c_out + idx, cn);
        St* a = a_out + (size_t)row * ldw + unit;
        store_f(a, ig);
        store_f(a + H, fg);
        store_f(a + 2 * H, gg);
        store_f(a + 3 * H, og);
    }
}

// S, launch j: the product of step j-1 (when `product`), then step j.
template <typename Io, typename St>
__global__ void __launch_bounds__(NTHREAD)
lstm_train_bwd_step(const Io* __restrict__ whh,    // [H, 4H]
                    const Io* __restrict__ dg_in,  // [Np, 4H] Io(dgates_{j-1})
                    Io* __restrict__ dg_next,      // [Np, 4H] Io(dgates_j)
                    const St* __restrict__ acts,   // [N, 4H] at t
                    const St* __restrict__ c_t,    // [N, H] at t
                    const St* __restrict__ c_prev, // [N, H] or null
                    const Io* __restrict__ g_h,    // [N, H] at t
                    St* __restrict__ dg_out,       // [N, 4H] at t
                    float* __restrict__ dc,        // [N, H] carried
                    int N, int H, int product)
{
    constexpr int nks = std::is_same<Io, bf16>::value ? NWARP : 1;
    __shared__ __align__(32) float part[NWARP][RB][UH];
    const int u0 = blockIdx.x * UH;
    const int r0 = blockIdx.y * RB;
    const int ldw = 4 * H;

    if (product) {  // uniform over the block
        bwd_product(whh, dg_in, part, u0, r0, H);
        __syncthreads();
    }

    for (int e = threadIdx.x; e < RB * UH; e += NTHREAD) {
        const int rr = e / UH, u = e % UH;
        const int row = r0 + rr;
        if (row >= N) continue;
        const int unit = u0 + u;
        const size_t idx = (size_t)row * H + unit;
        float dh = 0.f;
        if (product) {
#pragma unroll
            for (int w = 0; w < nks; ++w) dh += part[w][rr][u];
        }
        dh += load_f(g_h + idx);
        const St* a = acts + (size_t)row * ldw + unit;
        const float ig = load_f(a), fg = load_f(a + H);
        const float gg = load_f(a + 2 * H), og = load_f(a + 3 * H);
        const float tc = tanhf(load_f(c_t + idx));
        const float cp = c_prev ? load_f(c_prev + idx) : 0.f;
        const float d_o = dh * tc;
        const float dcv = dc[idx] + dh * og * (1.f - tc * tc);
        const float d[4] = {dcv * gg * ig * (1.f - ig),
                            dcv * cp * fg * (1.f - fg),
                            dcv * ig * (1.f - gg * gg),
                            d_o * og * (1.f - og)};
        const size_t col = (size_t)row * ldw + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            store_f(dg_out + col + q * H, d[q]);
            store_f(dg_next + col + q * H, d[q]);
        }
        dc[idx] = dcv * fg;
    }
}

// ---------------------------------------------------------------------------
// S's persistent kernel
// ---------------------------------------------------------------------------

constexpr int SU = 16;              // hidden units a CTA owns (elementwise)

struct Bptt {
    const bf16* whh;       // [H, 4H]
    const bf16* acts;      // [T, n_stride, 4H], this launch's first row
    const bf16* c;         // [T, n_stride, H], first row
    const bf16* g_h;       // [T, n_stride, H], first row
    bf16* dgates;          // [T, n_stride, 4H], first row
    unsigned* flags;       // [slices], zeroed
    int T, n_stride, rows, H, stages, reverse, g_u;
};

// dgates rows a chunk of S's ring: two n-tiles, or one at 16 rows a CTA
__host__ __device__ constexpr int bptt_chunk_rows(int R) {
    return R >= 32 ? 16 : 8;
}

// the shared memory of one CTA of S: the ring of dgates chunks (rows of
// the CTA's 4H / C columns each), the warps' partial sums (PWARPS
// k-slices x R rows x the cluster's 16 C units, padded), the partial dh
// received (a slot per rank of the cluster), a full and an empty mbarrier
// per ring slot
__host__ __device__ inline size_t bptt_smem(int H, int R, int C, int stages) {
    return (size_t)stages * bptt_chunk_rows(R) * (4 * H / C + PAD) * 2
        + (size_t)PWARPS * R * (16 * C + 4) * 4 + (size_t)C * R * SU * 4
        + (size_t)16 * stages;
}

// MT: m-tiles of 16 rows per CTA (R = 16 MT); C: CTAs a cluster, which
// split the 4H gate columns of the product between them
template <int MT, int C>
__global__ void __launch_bounds__(PTHREADS, 1)
lstm_bptt_persistent(Bptt p)
{
    constexpr int R = 16 * MT;
    constexpr int NC = 16 * C;               // the cluster's units
    constexpr int KTM = 32 / C;              // k-steps a warp, H <= 1024
    constexpr int LDS = NC + 4;              // row stride of the partials
    constexpr int SRC = bptt_chunk_rows(R);  // rows a chunk
    constexpr int NT = SRC / 8;              // n-tiles a chunk
    constexpr int NCH = R / SRC;             // chunks a step
    constexpr int EU = (R * SU + PTHREADS - 1) / PTHREADS;
    constexpr int EV = (R * NC / 4 + PTHREADS - 1) / PTHREADS;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int H = p.H, G = 4 * H, KC = G / C, stages = p.stages;
    const int KW = KC / PWARPS, KT = KW / 16, ldr = KC + PAD;
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);
    float* part = reinterpret_cast<float*>(ring + (size_t)stages * SRC * ldr);
    float* recv = part + (size_t)PWARPS * R * LDS;
    uint64_t* full = reinterpret_cast<uint64_t*>(recv + C * R * SU);
    uint64_t* empty = full + stages;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const unsigned rank = C > 1 ? cluster_rank() : 0u;
    const int slice = blockIdx.x / p.g_u;
    const int block = blockIdx.x % p.g_u;
    const int u0 = block * SU;                    // the units this CTA owns
    const int U0 = (block - (int)rank) * SU;      // the cluster's first unit
    const int K0 = (int)rank * KC;                // this CTA's gate columns
    const int row0 = slice * R;
    const int g = lane >> 2, c4 = lane & 3;

    // W_hh's block, once, in registers: warp w (k-slice w) holds the
    // cluster's NC units (C m-tiles) over its KW columns from K0 + w KW, as
    // the A fragments of its KT k-steps
    uint32_t wf[C][KTM][4];
#pragma unroll
    for (int m = 0; m < C; ++m)
#pragma unroll
        for (int kt = 0; kt < KTM; ++kt) {
            if (kt >= KT) break;
            const bf16* w0 = p.whh + (size_t)(U0 + m * 16 + g) * G + K0
                             + warp * KW + kt * 16 + 2 * c4;
            const bf16* w1 = w0 + (size_t)8 * G;
            wf[m][kt][0] = *reinterpret_cast<const uint32_t*>(w0);
            wf[m][kt][1] = *reinterpret_cast<const uint32_t*>(w1);
            wf[m][kt][2] = *reinterpret_cast<const uint32_t*>(w0 + 8);
            wf[m][kt][3] = *reinterpret_cast<const uint32_t*>(w1 + 8);
        }
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, PWARPS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the mbarriers are in place in every CTA before any copy or peer's
    // store
    cluster_sync();

    // the (row, unit)s this thread updates, fixed for the layer: dc stays in
    // registers, and the next step's inputs are fetched while this one runs
    int er[EU], eu[EU];
    bool live[EU];
    float dc[EU];
    // acts (i, f) and (g, o), (c_t, c_prev), g_h: pairs in one register
    __nv_bfloat162 xa[EU][2], xc[EU];
    bf16 xg[EU];
    const size_t pl_h = (size_t)p.n_stride * H, pl_g = (size_t)p.n_stride * G;
    const bf16 zero = __float2bfloat16(0.f);
    // step j's inputs; c_t of step j > 0 is c_prev of step j - 1
    auto fetch = [&](int j) {
        const int t = p.reverse ? j : p.T - 1 - j;
        const int tp = p.reverse ? t + 1 : t - 1;
        const bool first = j == p.T - 1;   // the recurrence's first step
#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            const size_t row = (size_t)(row0 + er[i]);
            const size_t off = row * H + u0 + eu[i];
            const bf16* a = p.acts + t * pl_g + row * G + u0 + eu[i];
            xa[i][0] = __halves2bfloat162(a[0], a[H]);
            xa[i][1] = __halves2bfloat162(a[2 * H], a[3 * H]);
            xg[i] = p.g_h[t * pl_h + off];
            xc[i] = __halves2bfloat162(
                j == 0 ? p.c[t * pl_h + off] : __high2bfloat16(xc[i]),
                first ? zero : p.c[tp * pl_h + off]);
        }
    };
#pragma unroll
    for (int i = 0; i < EU; ++i) {
        const int e = tid + i * PTHREADS;
        er[i] = e / SU;
        eu[i] = e % SU;
        live[i] = e < R * SU && row0 + er[i] < p.rows;
        dc[i] = 0.f;
    }
    fetch(0);

    const int uses = NCH / stages;   // of each ring slot, a step
    // ldmatrix lane addressing of a chunk's rows (the B operand: n = row;
    // with two n-tiles, lanes 16-31 address rows 8-15)
    const int b_off = ((lane & 7) + (NT == 2 ? (lane >> 4) * 8 : 0)) * ldr
                      + warp * KW + ((lane >> 3) & 1) * 8;
    float* mine = part + (size_t)warp * R * LDS;

    for (int j = 0; j < p.T; ++j) {
        const int t = p.reverse ? j : p.T - 1 - j;
        if (j > 0) {
            // dgates of step j - 1 in this slice is complete once its g_u
            // CTAs have counted step j - 1
            if (tid == 0) wait_count(p.flags + slice, (unsigned)j * p.g_u);
            __syncthreads();
            const int tq = p.reverse ? t - 1 : t + 1;   // step j - 1's index
            const bf16* src = p.dgates + tq * pl_g + K0;
            // warp 0 copies chunk ch (rows SRC ch ..) into its slot, a row's
            // KC columns a copy (a padding row copies a real one: its
            // product is never used)
            auto load = [&](int ch) {
                const int s = ch % stages;
                if (lane == 0)
                    mbar_expect_tx(full + s, (unsigned)(SRC * KC * 2));
                if (lane < SRC)
                    bulk_copy(ring + ((size_t)s * SRC + lane) * ldr,
                              src + (size_t)min(row0 + ch * SRC + lane,
                                                p.rows - 1) * G,
                              (unsigned)(KC * 2), full + s);
            };
            if (warp == 0) {
                // dgates was written through the generic proxy and acquired
                // above; the bulk copies read it through the async proxy
                asm volatile("fence.proxy.async.global;\n" ::: "memory");
                for (int ch = 0; ch < stages; ++ch) load(ch);
            }

            // warp w: the partial dh^T of the cluster's units (C m-tiles)
            // and a chunk's rows (NT n-tiles) over its k-slice
            for (int ch = 0; ch < NCH; ++ch) {
                const int s = ch % stages;
                const unsigned parity =
                    (unsigned)((j - 1) * uses + ch / stages) & 1u;
                mbar_wait(full + s, parity);
                const bf16* ds = ring + (size_t)s * SRC * ldr + b_off;
                float acc[C][NT][4];
#pragma unroll
                for (int m = 0; m < C; ++m)
#pragma unroll
                    for (int n = 0; n < NT; ++n)
#pragma unroll
                        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
                for (int kt = 0; kt < KTM; ++kt) {
                    if (kt >= KT) break;
                    uint32_t b[4];
                    if (NT == 2)
                        ldmatrix_x4(b, ds + kt * 16);
                    else
                        ldmatrix_x2(b[0], b[1], ds + kt * 16);
#pragma unroll
                    for (int m = 0; m < C; ++m)
#pragma unroll
                        for (int n = 0; n < NT; ++n)
                            mma_bf16(acc[m][n], wf[m][kt], b[2 * n],
                                     b[2 * n + 1]);
                }
                // this warp is done with slot s; warp 0 refills it once all
                // are
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
                // part[w][row][unit]: c0, c1 are units m 16 + g, rows
                // 8 n + 2 c4 and the next; c2, c3 the units 8 further
#pragma unroll
                for (int m = 0; m < C; ++m)
#pragma unroll
                    for (int n = 0; n < NT; ++n) {
                        const int r = ch * SRC + n * 8 + 2 * c4;
                        const int u = m * 16 + g;
                        mine[r * LDS + u] = acc[m][n][0];
                        mine[(r + 1) * LDS + u] = acc[m][n][1];
                        mine[r * LDS + u + 8] = acc[m][n][2];
                        mine[(r + 1) * LDS + u + 8] = acc[m][n][3];
                    }
                if (warp == 0 && ch + stages < NCH) {
                    mbar_wait(empty + s, parity);
                    load(ch + stages);
                }
            }
            __syncthreads();            // every warp's partials are in

            // their sum, four units at a time, goes to the CTA that owns the
            // units (rank u / 16), into its slot for this rank
#pragma unroll
            for (int i = 0; i < EV; ++i) {
                const int v = tid + i * PTHREADS;
                if (v >= R * NC / 4) break;
                const int r = v / (NC / 4), u = (v % (NC / 4)) * 4;
                float4 sum = *reinterpret_cast<const float4*>(
                    part + (size_t)r * LDS + u);
#pragma unroll
                for (int k = 1; k < PWARPS; ++k) {
                    const float4 q = *reinterpret_cast<const float4*>(
                        part + ((size_t)k * R + r) * LDS + u);
                    sum.x += q.x;
                    sum.y += q.y;
                    sum.z += q.z;
                    sum.w += q.w;
                }
                st_cluster_f4(recv + ((size_t)rank * R + r) * SU + (u & 15),
                              (unsigned)(u >> 4), sum);
            }
            // every rank's partial is in (the stores before the release,
            // the reads after the acquire)
            cluster_sync();
        }

#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            const int r = er[i], u = eu[i];
            float dh = 0.f;
            if (j > 0) {   // the ranks' partials in rank order: one sum order
                dh = recv[(size_t)r * SU + u];
#pragma unroll
                for (int s = 1; s < C; ++s)
                    dh += recv[((size_t)s * R + r) * SU + u];
            }
            dh += __bfloat162float(xg[i]);
            const float ig = __low2float(xa[i][0]);
            const float fg = __high2float(xa[i][0]);
            const float gg = __low2float(xa[i][1]);
            const float og = __high2float(xa[i][1]);
            const float tc = tanhf(__low2float(xc[i]));
            const float cp = __high2float(xc[i]);
            const float d_o = dh * tc;
            const float dcv = dc[i] + dh * og * (1.f - tc * tc);
            const float d[4] = {dcv * gg * ig * (1.f - ig),
                                dcv * cp * fg * (1.f - fg),
                                dcv * ig * (1.f - gg * gg),
                                d_o * og * (1.f - og)};
            bf16* o = p.dgates + t * pl_g + (size_t)(row0 + r) * G + u0 + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) o[q * H] = __float2bfloat16(d[q]);
            dc[i] = dcv * fg;
        }
        // count this CTA's step: its dgates writes and its reads of recv
        // (the CTA's barrier), then the release; no peer writes into recv
        // again before it has acquired this count
        __syncthreads();
        if (tid == 0) red_release(p.flags + slice, 1u);
        if (j + 1 < p.T) fetch(j + 1);
    }
    cluster_sync();   // no CTA leaves while a peer may still use its memory
}

// How many clusters of C CTAs of S's kernel, `smem` bytes each, the card
// can hold at once, for a grid of `grid` CTAs: into *clusters
template <int MT, int C>
cudaError_t bptt_clusters(long long grid, size_t smem, int* clusters)
{
    const auto kernel = lstm_bptt_persistent<MT, C>;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = C;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(PTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
}

template <int MT, int C>
cudaError_t launch_bptt(const Bptt& p, int slices, size_t smem,
                        cudaStream_t stream)
{
    // every CTA waits on others: the grid must be resident all at once, in
    // clusters of C
    const long long grid = (long long)p.g_u * slices;
    int resident = 0;
    cudaError_t err = bptt_clusters<MT, C>(grid, smem, &resident);
    if (err != cudaSuccess) return err;
    if ((long long)resident * C < grid)
        return cudaErrorCooperativeLaunchTooLarge;
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = C;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(PTHREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attrs;
    cfg.numAttrs = 2;
    return cudaLaunchKernelEx(&cfg, lstm_bptt_persistent<MT, C>, p);
}

template <int MT>
cudaError_t launch_bptt_c(const Bptt& p, int cluster, int slices,
                          size_t smem, cudaStream_t stream)
{
    return cluster == 2 ? launch_bptt<MT, 2>(p, slices, smem, stream)
                        : launch_bptt<MT, 1>(p, slices, smem, stream);
}

cudaError_t launch_bptt_any(const Bptt& p, int mt, int cluster, int slices,
                            size_t smem, cudaStream_t stream)
{
    switch (mt) {
    case 1: return launch_bptt_c<1>(p, cluster, slices, smem, stream);
    case 2: return launch_bptt_c<2>(p, cluster, slices, smem, stream);
    case 3: return launch_bptt_c<3>(p, cluster, slices, smem, stream);
    default: return launch_bptt_c<4>(p, cluster, slices, smem, stream);
    }
}

template <typename Io, typename St>
int train_fwd(const void* xw, const void* whh, void* h, void* c_out,
              void* acts, void* hbuf, void* cbuf, int T, int N, int Np, int H,
              int reverse, cudaStream_t s)
{
    const auto* x = static_cast<const Io*>(xw);
    const auto* w = static_cast<const Io*>(whh);
    auto* hb = static_cast<Io*>(hbuf);
    const dim3 grid(H / UH, Np / RB);
    const size_t plane = (size_t)Np * H;
    for (int step = 0; step < T; ++step) {
        const int t = reverse ? T - 1 - step : step;
        St* c_t = c_out ? static_cast<St*>(c_out) + (size_t)t * N * H
                        : nullptr;
        St* a_t = acts ? static_cast<St*>(acts) + (size_t)t * N * 4 * H
                       : nullptr;
        lstm_train_fwd_step<Io, St><<<grid, fwd_threads<Io>(), 0, s>>>(
            x + (size_t)t * N * 4 * H, w, hb + (step & 1) * plane,
            hb + ((step + 1) & 1) * plane,
            static_cast<Io*>(h) + (size_t)t * N * H, c_t, a_t,
            static_cast<float*>(cbuf), N, H);
        if (step == 0) {
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    return (int)cudaGetLastError();
}

template <typename Io, typename St>
int train_bwd(const void* whh, const void* acts_, const void* c_,
              const void* g_h, void* dgates, void* dgbuf, void* dcbuf, int T,
              int N, int Np, int H, int reverse, cudaStream_t s)
{
    const auto* w = static_cast<const Io*>(whh);
    const auto* acts = static_cast<const St*>(acts_);
    const auto* c = static_cast<const St*>(c_);
    const auto* g = static_cast<const Io*>(g_h);
    auto* dgb = static_cast<Io*>(dgbuf);
    const dim3 grid(H / UH, Np / RB);
    const size_t plane = (size_t)Np * 4 * H;
    for (int j = 0; j < T; ++j) {
        // the recurrence's steps last to first: t = T-1 .. 0, or 0 .. T-1
        // for `reverse`, whose recurrence walked the indices downwards
        const int t = reverse ? j : T - 1 - j;
        const int prev = reverse ? t + 1 : t - 1;
        const St* c_prev = j == T - 1 ? nullptr : c + (size_t)prev * N * H;
        lstm_train_bwd_step<Io, St><<<grid, NTHREAD, 0, s>>>(
            w, dgb + ((j + 1) & 1) * plane, dgb + (j & 1) * plane,
            acts + (size_t)t * N * 4 * H, c + (size_t)t * N * H, c_prev,
            g + (size_t)t * N * H,
            static_cast<St*>(dgates) + (size_t)t * N * 4 * H,
            static_cast<float*>(dcbuf), N, H, j > 0);
        if (j == 0) {
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) return (int)err;
        }
    }
    return (int)cudaGetLastError();
}

bool shapes_ok(int T, int N, int Np, int H) {
    return H % UH == 0 && H > 0 && Np % RB == 0 && Np >= N && N > 0 && T > 0;
}

}  // namespace

// xw [T, N, 4H] and whh [H, 4H] in Io (f32 when is_f32, else bf16) -> h
// [T, N, H] in Io, c [T, N, H] and acts [T, N, 4H] (bf16 when round_bf16,
// else f32); hbuf [2, Np, H] in Io and cbuf [N, H] f32 zeroed scratch from
// the caller; Np is N rounded up to a multiple of RB (32), H a multiple of
// 16.
extern "C" int lstm_train_fwd(const void* xw, const void* whh, void* h,
                              void* c, void* acts, void* hbuf, void* cbuf,
                              int is_f32, int round_bf16, int T, int N,
                              int Np, int H, int reverse, void* stream)
{
    if (!shapes_ok(T, N, Np, H)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto fn = is_f32 ? (round_bf16 ? train_fwd<float, bf16>
                                   : train_fwd<float, float>)
                     : (round_bf16 ? train_fwd<bf16, bf16>
                                   : train_fwd<bf16, float>);
    return fn(xw, whh, h, c, acts, hbuf, cbuf, T, N, Np, H, reverse, s);
}

// Kernel A's earlier f32 kernel (csrc/lstm_f32.cu has A's own): R's f32
// step kernel storing h only. xw [T, N, 4H], whh [H, 4H] (at a 16-byte
// address), out [T, N, H], all f32; hbuf [2, Np, H] f32 and cbuf [N, H] f32
// zeroed scratch; Np a multiple of RB (32), H a multiple of 16.
extern "C" int lstm_recurrence_f32(const void* xw, const void* whh,
                                   void* out, void* hbuf, void* cbuf,
                                   int T, int N, int Np, int H, int reverse,
                                   void* stream)
{
    if (!shapes_ok(T, N, Np, H)) return (int)cudaErrorInvalidValue;
    return train_fwd<float, float>(xw, whh, out, nullptr, nullptr, hbuf,
                                   cbuf, T, N, Np, H, reverse,
                                   static_cast<cudaStream_t>(stream));
}

// whh [H, 4H] in Io, acts [T, N, 4H] and c [T, N, H] as R wrote them, g_h
// [T, N, H] in Io (the gradient of h) -> dgates [T, N, 4H] (bf16 when
// round_bf16, else f32); dgbuf [2, Np, 4H] in Io and dcbuf [N, H] f32
// zeroed scratch from the caller.
extern "C" int lstm_train_bwd(const void* whh, const void* acts,
                              const void* c, const void* g_h, void* dgates,
                              void* dgbuf, void* dcbuf, int is_f32,
                              int round_bf16, int T, int N, int Np, int H,
                              int reverse, void* stream)
{
    if (!shapes_ok(T, N, Np, H)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    auto fn = is_f32 ? (round_bf16 ? train_bwd<float, bf16>
                                   : train_bwd<float, float>)
                     : (round_bf16 ? train_bwd<bf16, bf16>
                                   : train_bwd<bf16, float>);
    return fn(whh, acts, c, g_h, dgates, dgbuf, dcbuf, T, N, Np, H, reverse,
              s);
}

// R's persistent kernel (bf16, c and the activations stored in bf16): A's
// kernel with the train stores, one launch for the batch rows n0 .. n0 +
// rows - 1 of xw [T, N, 4H], h [T, N, H], c [T, N, H], acts [T, N, 4H];
// the rest as lstm_persistent.cuh's persistent_recurrence says.
extern "C" int lstm_train_fwd_persistent(const void* xw, const void* wt,
                                         void* h, void* c, void* acts,
                                         void* hbuf, void* flags, int T,
                                         int N, int n0, int rows, int H,
                                         int mt, int slices, int kc,
                                         int stages, int cluster,
                                         int reverse, void* stream)
{
    return persistent_recurrence<true>(xw, wt, h, c, acts, hbuf, flags, T, N,
                                       n0, rows, H, mt, slices, kc, stages,
                                       cluster, reverse, stream);
}

// S's persistent kernel (bf16 throughout), one launch for the batch rows n0
// .. n0 + rows - 1 of acts [T, N, 4H], c [T, N, H], g_h [T, N, H] and
// dgates [T, N, 4H]; whh [H, 4H]; flags [slices] int32 zeroed scratch. R =
// 16 * mt rows a slice, slices * R >= rows; H a multiple of 16 up to 1024
// with H / 16 a multiple of `cluster` (1 or 2); the CTAs of a cluster
// split the 4H columns in KC = 4H / cluster (a multiple of 128, 16 a warp's
// k-step times its 8 warps), read in chunks of 16 rows (8 where R is 16)
// through a ring of `stages` slots (dividing the step's chunks). The grid
// is (H / 16) x slices CTAs of 256 threads in clusters of `cluster`; it
// returns cudaErrorCooperativeLaunchTooLarge where they cannot all be
// resident.
extern "C" int lstm_train_bwd_persistent(const void* whh, const void* acts,
                                         const void* c, const void* g_h,
                                         void* dgates, void* flags, int T,
                                         int N, int n0, int rows, int H,
                                         int mt, int slices, int cluster,
                                         int stages, int reverse,
                                         void* stream)
{
    if (T < 1 || rows < 1 || n0 < 0 || n0 + rows > N || H < 16 || H % SU
        || H > 1024 || mt < 1 || mt > 4 || slices < 1
        || slices * 16 * mt < rows || (cluster != 1 && cluster != 2)
        || (H / SU) % cluster
        || (4 * H / cluster) % (16 * PWARPS) || stages < 1 || stages > 8
        || (16 * mt / bptt_chunk_rows(16 * mt)) % stages)
        return (int)cudaErrorInvalidValue;
    const size_t smem = bptt_smem(H, 16 * mt, cluster, stages);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    Bptt p;
    p.whh = static_cast<const bf16*>(whh);
    p.acts = static_cast<const bf16*>(acts) + (size_t)n0 * 4 * H;
    p.c = static_cast<const bf16*>(c) + (size_t)n0 * H;
    p.g_h = static_cast<const bf16*>(g_h) + (size_t)n0 * H;
    p.dgates = static_cast<bf16*>(dgates) + (size_t)n0 * 4 * H;
    p.flags = static_cast<unsigned*>(flags);
    p.T = T;
    p.n_stride = N;
    p.rows = rows;
    p.H = H;
    p.stages = stages;
    p.reverse = reverse;
    p.g_u = H / SU;
    const cudaError_t err = launch_bptt_any(
        p, mt, cluster, slices, smem, static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

// How many clusters of `cluster` (1 or 2) CTAs of S's persistent kernel
// can be resident at once, at the most shared memory a CTA may ask for
// (one CTA an SM): into *clusters.
extern "C" int lstm_train_bwd_clusters(int cluster, int* clusters)
{
    if (cluster != 1 && cluster != 2) return (int)cudaErrorInvalidValue;
    return (int)(cluster == 2 ? bptt_clusters<1, 2>(2, SMEM_LIMIT, clusters)
                              : bptt_clusters<1, 1>(1, SMEM_LIMIT, clusters));
}
