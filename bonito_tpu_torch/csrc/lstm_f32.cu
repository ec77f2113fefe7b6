// Kernels A and F in f32: the LSTM recurrence of an f32 model (evaluate
// loads with half=False; a --no-amp validation), redesigned for the H100;
// and kernels R and S in f32, the recurrence of an f32 model's train step
// (train --no-amp) and its backward through time.
//
// A (lstm_a32_kernel) replaces bonito_tpu/ops/lstm_pallas.py:lstm_pallas
// (`_lstm_kernel`) in f32. Given xw = x @ W_ih + b ([T, N, 4H] f32, from
// torch.matmul outside) and W_hh [H, 4H] f32, each step computes
//
//     gates = xw[t] + h @ W_hh          (f32 products, f32 sums)
//     i, f, g, o = sigmoid, sigmoid, tanh, sigmoid of the gate blocks
//     c = f*c + i*g;  h = o*tanh(c);  out[t] = h
//
// F (lstm_f32_rows_kernel) replaces lstm_pallas_fused (`_lstm_kernel_fused`)
// in f32: the same step with xw = x[t] @ W_ih + b computed inside, each sum
// over k in order from zero and kept in f32, gates = xw + h @ W_hh.
//
// What bounds them on an H100: f32 products run on the f32 cores (67
// TFLOP/s; the tensor cores would round the operands to TF32, and an
// error-compensated 3xTF32 product, measured in PERF.md, did not win at
// evaluate's batch), 2*N*H*4H
// operations a step for A (hac, N 96, H 1024: 12.0 us a step; N 256: 32.1
// us) and twice that with C = H for F. Both are serial in T. The first
// f32 kernels were R's f32 step kernel for A (a launch a step, every block
// re-reading its 256 KB of W_hh from L2, its product paced by shared-memory
// loads: 74.81 us a step at hac) and one thread a gate column of 8 rows a
// block for F (32 blocks at N 256, the x product between the step's two
// barriers). PERF.md has their times beside these kernels'.
//
// A: one cooperative launch per row group (ops/lstm_cuda.py:f32_plan, which
// the C entry takes as given).
//   - A CTA owns 8 hidden units (their 32 gate columns) of every row of the
//     launch (R rows, a multiple of 32 up to 256): H / 8 CTAs, 128 at hac,
//     one an SM. Its slice of W_hh, H x 32 f32 (128 KB at H 1024), is
//     loaded into shared memory once, a row of 32 gate columns a k, which
//     the product below reads one float4 a lane with no bank conflicts.
//   - h_{t-1} lives in global memory k-major ([H][R + 8] f32, two planes),
//     so a chunk of kc consecutive k is one contiguous block: a producer
//     warp copies each chunk with one bulk copy into a ring of `stages`
//     slots (a full and an empty mbarrier a slot) and runs ahead of the
//     consumer warps by the ring's depth (8 floats of padding a row).
//   - The consumer warps: R / 32 row tiles x KS k-slices (KS = 8, 4, 2 or 1
//     as R grows: at most 12 warps, so that with the producer no SM
//     sub-partition holds more than 4 warps and a thread may keep 128
//     registers). Warp (tile, slice) sums its 32 rows x 32
//     columns over kc / KS consecutive k of each chunk by FFMA on a
//     register tile of 8 rows x 4 columns a lane (lanes 4 row groups x 8
//     column groups), from two float4 loads of h that a row group's 8
//     lanes share and one float4 of W_hh: 32 FMAs for three 16-byte loads,
//     each sum over k in order.
//     The k-slices' partial sums meet in shared memory (over the ring, once
//     the step's chunks are read) and are summed in slice order; then every
//     consumer thread runs the gate math of 8 / KS (row, unit)s, c kept in
//     registers, xw (the CTA's 32 columns of the step's rows) brought into
//     shared memory by cp.async a step ahead; h goes to the output and to
//     the next plane.
//   - The CTAs meet once a step at a counter in global memory (release add
//     after the CTA's barrier; the producer's acquire load before the next
//     step's copies, then a proxy fence), as kernel A's bf16 design does.
//   A wait that cannot end traps (the launch fails) rather than holding the
//   card. Rows beyond a launch's go to further launches (row groups).
//
// F: one launch; a block owns FR batch rows (1, 2, 4 or 8: the plan,
// ops/lstm_fused_cuda.py:f32_plan, takes the fewest rows that still fit
// the grid on the card's SMs, so that a small batch fills the card too) and
// walks all T steps with 4H threads.
//   - The x product leaves the chain: for a block of TB steps at once, the
//     threads (two gate columns each, W_ih from shared memory where it fits)
//     compute xw + b for every step and row of the block into shared memory,
//     from x rows that cp.async brought in a block ahead. Each sum over k is
//     in order from zero, as the earlier kernel's.
//   - Each step: thread (unit u, gate q) takes its column's h product over
//     its W_hh column (in registers at H 96, fast's width; else through L2)
//     for the FR rows, in order over k (with one or two rows a block, in
//     4 / FR sums of every 4 / FR-th k, added in order at the end, so that
//     four chains of FMAs are in flight); the four gates of a unit sit in four
//     neighbouring lanes, which swap them by shuffles so that lane q runs the
//     gate math of rows q, q + 4, with c in registers; h goes into one of two
//     buffers in shared memory. One barrier a step, and one more a block.
//
// R (lstm_a32_kernel<KS, true, St>) replaces bonito_tpu/ops/lstm_pallas.py:
// _lstm_train_fwd_kernel in f32: A's kernel on A's plan with R's stores,
// c_t and the four activations in St (bf16 where bonito_tpu's kernel route
// runs, f32 where its scan runs), from the values already in registers; its
// h is A's bit for bit. S (lstm_s32_kernel) replaces _lstm_train_bwd_kernel:
// walking the recurrence's steps last to first, dh and dc in f32,
//
//     dh += g_h[t]; the gates' gradient from acts, c_t, c_prev (as
//     csrc/lstm_train.cu says); dgates_out[t] = St(dgates)
//     dh_prev[n, k] = sum_j dgates[n, j] W_hh[k, j] over j in 4H (f32)
//
// f32 FMA operations, 2*N*H*4H a step (the --no-amp batch, N 16, H 1024:
// 2.0 us a step at 67 TFLOP/s); serial in T. S is A's layout turned around
// (ops/lstm_train_cuda.py:f32_backward_plan, which the C entry takes as
// given):
//   - A CTA owns 8 hidden units: H / 8 CTAs. Its 8 rows of W_hh, [8, 4H]
//     (128 KB at H 1024), go into shared memory once, k-major (the 8 units
//     of a k in 32 bytes).
//   - The previous step's f32 dgates of the launch's rows (all 4H columns)
//     live in global memory k-major in two planes ([4H][ldr], ldr = R or R
//     + 16 so that the product's loads miss no bank); a producer warp
//     streams them, after the counter, in chunks of kc k through a ring of
//     bulk copies with full and empty mbarriers, as A's producer does.
//   - The consumer warps: R / 16 row tiles x KS k-slices (KS at most 8,
//     at most 16 warps: 16 k-slices at 16 rows spilled and ran 3.7%
//     slower than 8, PERF.md).
//     Lane (row group rg, k lane kl) of warp (tile, slice) sums 4 rows x
//     the 8 units over every 8th k of the warp's kc / KS k of each chunk,
//     in order, by FFMA (one float4 of dgates, two of W_hh: 32 FMAs); the
//     8 k lanes' sums meet by shuffles in a fixed tree (s_reduce), the
//     k-slices' in shared memory (over the ring), added in slice order: the
//     result is deterministic.
//   - Each consumer thread then runs the gradient's math of its (row,
//     unit)s, dc in registers, the step's acts (the CTA's 32 columns), c_t,
//     c_prev and g_h brought into shared memory by cp.async a step ahead;
//     dgates go to dgates_out in St and in f32 to the next plane, then a
//     release on the counter. A wait that cannot end traps. Rows beyond
//     256 go to further launches (row groups).
//   Each CTA reads R x 4H x 4 bytes of dgates a step (256 KB at N 16): four
//   times A's read of h, for a quarter of the output columns.
//
// scripts/lstm_step_split.py a32, f32 and s32 time each with parts of its
// step left out (A32_CUT, F32_CUT, S32_CUT; 0 in the library); r32 times R
// beside A.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_persistent.cuh"

#ifndef A32_CUT
#define A32_CUT 0
#endif
#ifndef F32_CUT
#define F32_CUT 0
#endif
#ifndef S32_CUT
#define S32_CUT 0
#endif

namespace {

// ---------------------------------------------------------------------------
// A in f32
// ---------------------------------------------------------------------------

constexpr int AU = 8;               // hidden units a CTA
constexpr int AC = 4 * AU;          // gate columns a CTA
constexpr int A_MAX_ROWS = 256;     // rows of a launch
constexpr int A_MAX_WARPS = 12;     // consumer warps
constexpr int A_THREADS = (A_MAX_WARPS + 1) * 32;
constexpr int A_PAD = 8;            // floats of padding a row of h
constexpr int A_LDP = AC + 8;       // row stride of the partial sums

// the parts scripts/lstm_step_split.py a32 leaves out (A32_CUT bits)
constexpr int A_CUT_WAIT = 1;       // the producer's wait at the counter
constexpr int A_CUT_LOAD = 2;       // the copies of h and their waits
constexpr int A_CUT_PRODUCT = 4;    // the products (the partials are zeros)
constexpr int A_CUT_GATES = 8;      // the gate math: the gates' sum is h

__device__ __forceinline__ constexpr bool a_cut(int part) {
    return (A32_CUT & part) != 0;
}

struct A32 {
    const float* xw;   // [T, n_stride, 4H], this launch's first row
    const float* whh;  // [H, 4H]
    float* out;        // [T, n_stride, H], first row
    float* hbuf;       // [2, H, R + A_PAD], zeroed
    unsigned* flag;    // zeroed
    void* c_out;       // R: [T, n_stride, H] in St, first row
    void* acts;        // R: [T, n_stride, 4H] in St, first row
    int T, n_stride, rows, H, R, kc, stages, reverse;
};

__device__ __forceinline__ void store_st(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_st(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
}
__device__ __forceinline__ float load_st(const float* p) { return *p; }
__device__ __forceinline__ float load_st(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

// the shared memory of a CTA, in bytes: W_hh's slice, the ring (which the
// k-slices' partial sums reuse), the step's xw of the CTA's 32 columns
// (rows of A_LDP), a full and an empty mbarrier a slot
__host__ __device__ inline size_t a32_ring_floats(int R, int ks, int kc,
                                                  int stages) {
    const size_t ring = (size_t)stages * kc * (R + A_PAD);
    const size_t part = (size_t)ks * R * A_LDP;
    return ring > part ? ring : part;
}
__host__ __device__ inline size_t a32_smem(int H, int R, int ks, int kc,
                                           int stages) {
    return ((size_t)H * AC + a32_ring_floats(R, ks, kc, stages)
            + (size_t)R * A_LDP) * 4 + (size_t)16 * stages;
}

__device__ __forceinline__ void bar_consumers(int threads) {
    asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// FFMA: lane (rg, cg) sums rows r0 .. r0 + 7 of the chunk's h (k-major,
// row stride ldh) times gate columns c0 .. c0 + 3 of W_hh's slice over n
// consecutive k from the chunk's kl (global k from k), in order
__device__ __forceinline__ void a_product(float (&acc)[8][4],
                                          const float* hs, int ldh,
                                          const float* Ws, int kl, int k,
                                          int n, int r0, int c0) {
    const float* hr = hs + (size_t)kl * ldh + r0;
    const float* wr = Ws + (size_t)k * AC + c0;
#pragma unroll 4
    for (int i = 0; i < n; ++i, hr += ldh, wr += AC) {
        const float4 a = *reinterpret_cast<const float4*>(hr);
        const float4 b = *reinterpret_cast<const float4*>(hr + 4);
        const float4 w = *reinterpret_cast<const float4*>(wr);
        const float h8[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
            acc[r][0] = fmaf(h8[r], w.x, acc[r][0]);
            acc[r][1] = fmaf(h8[r], w.y, acc[r][1]);
            acc[r][2] = fmaf(h8[r], w.z, acc[r][2]);
            acc[r][3] = fmaf(h8[r], w.w, acc[r][3]);
        }
    }
}

// TRAIN: kernel R in f32, A's kernel with R's stores of c_t and the four
// activations in St (bf16 or f32); the product, the sums and h are the same
// instructions in both instances, so at one plan R's h is A's bit for bit
template <int KS, bool TRAIN, typename St>
__global__ void __launch_bounds__(A_THREADS, 1)
lstm_a32_kernel(A32 p)
{
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int H = p.H, R = p.R, kc = p.kc, stages = p.stages;
    const int ldh = R + A_PAD, RT = R / 32, cw = RT * KS, ct = cw * 32;
    const int g_u = gridDim.x;
    float* Ws = reinterpret_cast<float*>(smem_raw);
    float* ring = Ws + (size_t)H * AC;
    float* part = ring;
    float* xs = ring + a32_ring_floats(R, KS, kc, stages);
    uint64_t* full = reinterpret_cast<uint64_t*>(xs + (size_t)R * A_LDP);
    uint64_t* empty = full + stages;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int u0 = blockIdx.x * AU;
    const int n_chunks = H / kc;
    const size_t plane = (size_t)H * ldh;
    const size_t slot = (size_t)kc * ldh;

    // W_hh's slice, once: gate q of unit u0 + u is column 8 q + u
    for (int e = tid; e < H * 8; e += blockDim.x) {
        const int k = e >> 3, q = (e >> 1) & 3, half = e & 1;
        cp_async16(Ws + (size_t)k * AC + q * 8 + half * 4,
                   p.whh + (size_t)k * 4 * H + q * H + u0 + half * 4);
    }
    cp_async_commit();
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, cw);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cp_async_wait(0);
    __syncthreads();

    if (warp == cw) {
        // the producer: each step's chunks of h_{t-1}, once the CTAs have
        // counted step - 1
        if (lane == 0) {
            const unsigned bytes = (unsigned)(slot * 4);
            int gch = 0;
            for (int step = 0; step < p.T && !a_cut(A_CUT_LOAD); ++step) {
                const float* h_in = p.hbuf + (size_t)(step & 1) * plane;
                if (step > 0 && !a_cut(A_CUT_WAIT))
                    wait_count(p.flag, (unsigned)step * g_u);
                // h_in was written through the generic proxy and acquired
                // above; the bulk copies read it through the async proxy
                asm volatile("fence.proxy.async.global;\n" ::: "memory");
                for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
                    const int s = gch % stages, use = gch / stages;
                    if (use > 0)
                        mbar_wait(empty + s, (unsigned)(use - 1) & 1u);
                    mbar_expect_tx(full + s, bytes);
                    bulk_copy(ring + s * slot, h_in + (size_t)ch * slot,
                              bytes, full + s);
                }
            }
        }
        return;
    }

    // the consumers: warp (row tile rt, k-slice ks)
    const int rt = warp % RT, ks = warp / RT;
    const int kn = kc / KS;             // k a warp sums of each chunk
    const int rg = lane >> 3, cg = lane & 7;
    // the (row, unit)s this thread updates: e = tid + i ct, row e / 8, unit
    // e % 8 (8 / KS of them), c in registers; xw of the step's rows and the
    // CTA's 32 columns comes into xs (column 8 q + u) by cp.async, issued a
    // step ahead, in 16-byte pieces (row, gate, half), 8 / KS a thread
    constexpr int EU = 8 / KS;
    float c[EU];
    const size_t xw_t = (size_t)p.n_stride * 4 * H;
    const size_t out_t = (size_t)p.n_stride * H;
    auto fetch_xw = [&](int t) {
#pragma unroll
        for (int i = 0; i < EU; ++i) {
            const int e = tid + i * ct, row = e >> 3, q = (e >> 1) & 3;
            const int half = e & 1;
            if (row >= p.rows) continue;
            cp_async16(xs + row * A_LDP + q * 8 + half * 4,
                       p.xw + t * xw_t + (size_t)row * 4 * H + q * H + u0
                       + half * 4);
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < EU; ++i) c[i] = 0.f;
    fetch_xw(p.reverse ? p.T - 1 : 0);

    int gch = 0;
    for (int step = 0; step < p.T; ++step) {
        const int t = p.reverse ? p.T - 1 - step : step;
        float* h_out = p.hbuf + (size_t)((step + 1) & 1) * plane;
        float acc[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc[i][j] = 0.f;

        for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
            const int s = gch % stages;
            if (!a_cut(A_CUT_LOAD))
                mbar_wait(full + s, (unsigned)(gch / stages) & 1u);
            const float* hs = ring + s * slot;
            const int kl = ks * kn, k = ch * kc + kl;
            if (!a_cut(A_CUT_PRODUCT))
                a_product(acc, hs, ldh, Ws, kl, k, kn, rt * 32 + rg * 8,
                          cg * 4);
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + s);
        }
        bar_consumers(ct);              // every warp is done with the ring

        // the k-slices' partial sums: part[ks][row][gate column]
        float* mine = part + (size_t)ks * R * A_LDP;
#pragma unroll
        for (int r = 0; r < 8; ++r)
            *reinterpret_cast<float4*>(
                mine + (rt * 32 + rg * 8 + r) * A_LDP + cg * 4) =
                make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
        cp_async_wait(0);               // this step's xw
        bar_consumers(ct);

#pragma unroll
        for (int i = 0; i < EU; ++i) {
            const int e = tid + i * ct, row = e >> 3, u = e & 7;
            if (row >= p.rows) continue;
            float gt[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float sum = part[row * A_LDP + q * 8 + u];
#pragma unroll
                for (int j = 1; j < KS; ++j)
                    sum += part[((size_t)j * R + row) * A_LDP + q * 8 + u];
                gt[q] = xs[row * A_LDP + q * 8 + u] + sum;
            }
            float h;
            if (a_cut(A_CUT_GATES)) {
                h = gt[0] + gt[1] + gt[2] + gt[3];
            } else {
                const float ig = sigmoid_f(gt[0]);
                const float fg = sigmoid_f(gt[1]);
                const float gg = tanhf(gt[2]);
                const float og = sigmoid_f(gt[3]);
                c[i] = fg * c[i] + ig * gg;
                h = og * tanhf(c[i]);
            }
            p.out[t * out_t + (size_t)row * H + u0 + u] = h;
            h_out[(size_t)(u0 + u) * ldh + row] = h;
            if constexpr (TRAIN) {
                // R's stores for S (with A32_CUT's gate cut, the gates)
                const size_t idx = t * out_t + (size_t)row * H + u0 + u;
                St* a = static_cast<St*>(p.acts) + t * xw_t
                        + (size_t)row * 4 * H + u0 + u;
                store_st(static_cast<St*>(p.c_out) + idx, c[i]);
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    store_st(a + q * H, a_cut(A_CUT_GATES) ? gt[q]
                             : q == 2 ? tanhf(gt[q]) : sigmoid_f(gt[q]));
            }
        }
        // count this CTA's step: its h writes (the barrier), then the
        // release; the next step's bulk copies (async proxy) land in the
        // ring that the partial sums just used (generic proxy): a proxy
        // fence orders the two
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_consumers(ct);
        if (tid == 0) red_release(p.flag, 1u);
        if (step + 1 < p.T) fetch_xw(p.reverse ? t - 1 : t + 1);
    }
}

// ---------------------------------------------------------------------------
// S in f32
// ---------------------------------------------------------------------------

constexpr int S_MAX_ROWS = 256;     // rows of a launch
constexpr int S_MAX_WARPS = 16;     // consumer warps
constexpr int S_THREADS = (S_MAX_WARPS + 1) * 32;
constexpr int S_LDP = AU + 1;       // row stride of the k-slices' partials

// the parts scripts/lstm_step_split.py s32 leaves out (S32_CUT bits)
constexpr int S_CUT_WAIT = 1;       // the producer's wait at the counter
constexpr int S_CUT_LOAD = 2;       // the copies of dgates and their waits
constexpr int S_CUT_PRODUCT = 4;    // the products (the partials are zeros)
constexpr int S_CUT_ELEMENTWISE = 8;  // the gradient's math: dh is stored

__device__ __forceinline__ constexpr bool s_cut(int part) {
    return (S32_CUT & part) != 0;
}

struct S32 {
    const float* whh;  // [H, 4H]
    const void* acts;  // [T, n_stride, 4H] in St, this launch's first row
    const void* c;     // [T, n_stride, H] in St, first row
    const float* g_h;  // [T, n_stride, H], first row
    void* dgates;      // [T, n_stride, 4H] in St, first row
    float* gbuf;       // [2, 4H, ldr]: the step's f32 dgates, k-major
    unsigned* flag;    // zeroed
    int T, n_stride, rows, H, R, ldr, kc, stages, reverse;
};

// the row stride of a k of dgates (in the planes and the ring): R, or R +
// 16 where R is a multiple of 32, so that a row's 16 B pieces of 8 lanes
// (4 row groups x two k) fall on distinct banks
__host__ __device__ inline int s32_ldr(int R) {
    return R % 32 ? R : R + 16;
}
// bytes of a row of a step's inputs in shared memory: acts (the CTA's 32
// columns), c_t and c_prev (8 units each) in St, g_h (8 f32)
__host__ __device__ inline int s32_in_bytes(int st) { return 48 * st + 32; }
__host__ __device__ inline size_t s32_ring_floats(int R, int ks, int kc,
                                                  int stages) {
    const size_t ring = (size_t)stages * kc * s32_ldr(R);
    const size_t part = (size_t)ks * R * S_LDP;
    return ring > part ? ring : part;
}
// W_hh's 8 rows k-major, the ring (which the k-slices' partial sums
// reuse), the step's inputs, a full and an empty mbarrier a slot
__host__ __device__ inline size_t s32_smem(int H, int R, int ks, int kc,
                                           int stages, int st) {
    return ((size_t)4 * H * AU + s32_ring_floats(R, ks, kc, stages)) * 4
        + (size_t)R * s32_in_bytes(st) + (size_t)16 * stages;
}

// FFMA: lane (row group, k lane kl % 8) sums rows r0 .. r0 + 3 of the
// chunk's dgates (k-major, row stride ldr) times the 8 units' W_hh over n
// k, every 8th from the chunk's kl (global k from k), in order
__device__ __forceinline__ void s_product(float (&acc)[4][AU],
                                          const float* ds, int ldr,
                                          const float* Ws, int kl, int k,
                                          int n, int r0) {
    const float* dr = ds + (size_t)kl * ldr + r0;
    const float* wr = Ws + (size_t)k * AU;
    const size_t dstep = (size_t)8 * ldr;
#pragma unroll 4
    for (int i = 0; i < n; ++i, dr += dstep, wr += 8 * AU) {
        const float4 a = *reinterpret_cast<const float4*>(dr);
        const float4 w0 = *reinterpret_cast<const float4*>(wr);
        const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
        const float d4[4] = {a.x, a.y, a.z, a.w};
        const float w8[AU] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int u = 0; u < AU; ++u)
                acc[r][u] = fmaf(d4[r], w8[u], acc[r][u]);
    }
}

// the 8 k lanes' sums (lane bits 2-4) of a warp, each lane left with
// its unit kl (= lane >> 2) of its 4 rows: a fixed tree (k lanes j and j ^ 4
// first, then j ^ 2, then j ^ 1), whose every sum is the same on both lanes
// of a pair (x + y == y + x): the result is deterministic
__device__ __forceinline__ void s_reduce(const float (&acc)[4][AU],
                                         float (&out)[4], int kl) {
    const bool b2 = (kl >> 2) & 1, b1 = (kl >> 1) & 1, b0 = kl & 1;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        float a1[4], a2[2];
#pragma unroll
        for (int v = 0; v < 4; ++v) {
            const float keep = b2 ? acc[r][4 + v] : acc[r][v];
            const float send = b2 ? acc[r][v] : acc[r][4 + v];
            a1[v] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
        }
#pragma unroll
        for (int v = 0; v < 2; ++v) {
            const float keep = b1 ? a1[2 + v] : a1[v];
            const float send = b1 ? a1[v] : a1[2 + v];
            a2[v] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
        }
        const float keep = b0 ? a2[1] : a2[0];
        const float send = b0 ? a2[0] : a2[1];
        out[r] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
    }
}

template <int KS, typename St>
__global__ void __launch_bounds__(S_THREADS, 1)
lstm_s32_kernel(S32 p)
{
    extern __shared__ __align__(128) unsigned char smem_raw[];
    constexpr int SZ = sizeof(St);
    constexpr int IB = 48 * SZ + 32;    // bytes of a row of the inputs
    const int H = p.H, G = 4 * H, R = p.R, ldr = p.ldr, kc = p.kc;
    const int stages = p.stages;
    const int RT = R / 16, cw = RT * KS, ct = cw * 32;
    const int g_u = gridDim.x;
    float* Ws = reinterpret_cast<float*>(smem_raw);
    float* ring = Ws + (size_t)G * AU;
    float* part = ring;
    unsigned char* xs = reinterpret_cast<unsigned char*>(
        ring + s32_ring_floats(R, KS, kc, stages));
    uint64_t* full = reinterpret_cast<uint64_t*>(xs + (size_t)R * IB);
    uint64_t* empty = full + stages;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int u0 = blockIdx.x * AU;
    const int n_chunks = G / kc;
    const size_t plane = (size_t)G * ldr;
    const size_t slot = (size_t)kc * ldr;

    // W_hh's 8 rows, once, k-major: Ws[k][u] = W_hh[u0 + u][k]
    for (int e = tid; e < G * AU; e += blockDim.x) {
        const int u = e / G, k = e % G;
        Ws[(size_t)k * AU + u] = p.whh[(size_t)(u0 + u) * G + k];
    }
    if (tid == 0) {
        for (int s = 0; s < stages; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, cw);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == cw) {
        // the producer: from step 1 on, each step's chunks of the previous
        // step's dgates, once the CTAs have counted that step
        if (lane == 0) {
            const unsigned bytes = (unsigned)(slot * 4);
            int gch = 0;
            for (int step = 1; step < p.T && !s_cut(S_CUT_LOAD); ++step) {
                const float* src = p.gbuf + (size_t)((step - 1) & 1) * plane;
                if (!s_cut(S_CUT_WAIT))
                    wait_count(p.flag, (unsigned)step * g_u);
                // the planes are written through the generic proxy and
                // acquired above; the bulk copies read through the async
                asm volatile("fence.proxy.async.global;\n" ::: "memory");
                for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
                    const int s = gch % stages, use = gch / stages;
                    if (use > 0)
                        mbar_wait(empty + s, (unsigned)(use - 1) & 1u);
                    mbar_expect_tx(full + s, bytes);
                    bulk_copy(ring + s * slot, src + (size_t)ch * slot,
                              bytes, full + s);
                }
            }
        }
        return;
    }

    // the consumers: warp (row tile rt, k-slice ks); lane (row group rg,
    // k lane kl): rows rt 16 + 4 rg .. + 3, every 8th k of the warp's
    // slice of each chunk from kl on
    const int rt = warp % RT, ks = warp / RT;
    const int kn = kc / KS;             // k a warp sums of each chunk
    const int rg = lane & 3, kl = lane >> 2;
    // the (row, unit)s this thread updates: e = tid + i ct, row e / 8, unit
    // e % 8, dc in registers; the step's inputs come into xs by cp.async,
    // issued a step ahead, in 16-byte pieces
    constexpr int EU = KS >= 4 ? 1 : 4 / KS;
    float dc[EU];
#pragma unroll
    for (int i = 0; i < EU; ++i) dc[i] = 0.f;
    const size_t pl_h = (size_t)p.n_stride * H, pl_g = (size_t)p.n_stride * G;
    const St* acts = static_cast<const St*>(p.acts);
    const St* cs = static_cast<const St*>(p.c);
    constexpr int PA = 2 * SZ;          // pieces of a row's acts
    constexpr int PC = SZ / 2;          // pieces of a row's c (8 units)
    constexpr int PR = PA + 2 * PC + 2; // pieces of a row
    constexpr int EPC = 16 / SZ;        // elements a piece
    // step j's inputs (t its index); c_prev only where the recurrence had
    // a previous step
    auto fetch = [&](int j) {
        const int t = p.reverse ? j : p.T - 1 - j;
        const int tp = p.reverse ? t + 1 : t - 1;
        const bool first = j == p.T - 1;
        for (int e = tid; e < p.rows * PR; e += ct) {
            const int row = e / PR, pc = e % PR;
            unsigned char* d = xs + (size_t)row * IB;
            if (pc < PA) {
                const int q = pc / PC, half = pc % PC;
                cp_async16(d + (q * AU + half * EPC) * SZ,
                           acts + t * pl_g + (size_t)row * G + q * H + u0
                           + half * EPC);
            } else if (pc < PA + PC) {
                const int half = pc - PA;
                cp_async16(d + (32 + half * EPC) * SZ,
                           cs + t * pl_h + (size_t)row * H + u0 + half * EPC);
            } else if (pc < PA + 2 * PC) {
                const int half = pc - PA - PC;
                if (!first)
                    cp_async16(d + (40 + half * EPC) * SZ,
                               cs + tp * pl_h + (size_t)row * H + u0
                               + half * EPC);
            } else {
                const int half = pc - PA - 2 * PC;
                cp_async16(d + 48 * SZ + half * 16,
                           p.g_h + t * pl_h + (size_t)row * H + u0
                           + half * 4);
            }
        }
        cp_async_commit();
    };
    fetch(0);

    int gch = 0;
    for (int step = 0; step < p.T; ++step) {
        const int t = p.reverse ? step : p.T - 1 - step;
        const bool first = step == p.T - 1;
        float* g_out = p.gbuf + (size_t)(step & 1) * plane;
        float dh4[4];
        if (step > 0) {
            float acc[4][AU];
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int u = 0; u < AU; ++u) acc[r][u] = 0.f;
            for (int ch = 0; ch < n_chunks; ++ch, ++gch) {
                const int s = gch % stages;
                if (!s_cut(S_CUT_LOAD))
                    mbar_wait(full + s, (unsigned)(gch / stages) & 1u);
                const int kk = ks * kn + kl;
                if (!s_cut(S_CUT_PRODUCT))
                    s_product(acc, ring + s * slot, ldr, Ws, kk,
                              ch * kc + kk, kn / 8, rt * 16 + rg * 4);
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + s);
            }
            s_reduce(acc, dh4, kl);
        }
        bar_consumers(ct);              // every warp is done with the ring

        // the k-slices' partial sums: part[ks][row][unit]
        if (step > 0) {
            float* mine = part + (size_t)ks * R * S_LDP;
#pragma unroll
            for (int r = 0; r < 4; ++r)
                mine[(rt * 16 + rg * 4 + r) * S_LDP + kl] = dh4[r];
        }
        cp_async_wait(0);               // this step's inputs
        bar_consumers(ct);

#pragma unroll
        for (int i = 0; i < EU; ++i) {
            const int e = tid + i * ct, row = e >> 3, u = e & 7;
            if (e >= R * AU || row >= p.rows) continue;
            float dh = 0.f;
            if (step > 0) {             // the slices' sums in slice order
                dh = part[row * S_LDP + u];
#pragma unroll
                for (int j = 1; j < KS; ++j)
                    dh += part[((size_t)j * R + row) * S_LDP + u];
            }
            const unsigned char* xr = xs + (size_t)row * IB;
            const St* a = reinterpret_cast<const St*>(xr);
            const St* cr = reinterpret_cast<const St*>(xr + 32 * SZ);
            dh += reinterpret_cast<const float*>(xr + 48 * SZ)[u];
            const float ig = load_st(a + u), fg = load_st(a + 8 + u);
            const float gg = load_st(a + 16 + u), og = load_st(a + 24 + u);
            const float tc = tanhf(load_st(cr + u));
            const float cp = first ? 0.f : load_st(cr + 8 + u);
            float d[4];
            if (s_cut(S_CUT_ELEMENTWISE)) {
                d[0] = d[1] = d[2] = d[3] = dh;
            } else {
                const float d_o = dh * tc;
                const float dcv = dc[i] + dh * og * (1.f - tc * tc);
                d[0] = dcv * gg * ig * (1.f - ig);
                d[1] = dcv * cp * fg * (1.f - fg);
                d[2] = dcv * ig * (1.f - gg * gg);
                d[3] = d_o * og * (1.f - og);
                dc[i] = dcv * fg;
            }
            St* o = static_cast<St*>(p.dgates) + t * pl_g + (size_t)row * G
                    + u0 + u;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                store_st(o + q * H, d[q]);
                g_out[(size_t)(q * H + u0 + u) * ldr + row] = d[q];
            }
        }
        // count this CTA's step: its plane writes (the barrier), then the
        // release; the next step's bulk copies (async proxy) land in the
        // ring that the partial sums just used (generic proxy): a proxy
        // fence orders the two
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bar_consumers(ct);
        if (tid == 0) red_release(p.flag, 1u);
        if (step + 1 < p.T) fetch(step + 1);
    }
}

template <typename St>
cudaError_t launch_s32(const S32& p, int ks, size_t smem, cudaStream_t s,
                       unsigned threads) {
    const int grid = p.H / AU;
    switch (ks) {
    case 1: return launch_resident(lstm_s32_kernel<1, St>, grid, smem, 1, s,
                                   p, threads);
    case 2: return launch_resident(lstm_s32_kernel<2, St>, grid, smem, 1, s,
                                   p, threads);
    case 4: return launch_resident(lstm_s32_kernel<4, St>, grid, smem, 1, s,
                                   p, threads);
    default: return launch_resident(lstm_s32_kernel<8, St>, grid, smem, 1,
                                    s, p, threads);
    }
}

// ---------------------------------------------------------------------------
// F in f32
// ---------------------------------------------------------------------------

// the parts scripts/lstm_step_split.py f32 leaves out (F32_CUT bits)
constexpr int F_CUT_H = 1;          // the h product (its sums are zeros)
constexpr int F_CUT_X = 2;          // the x product of each block
constexpr int F_CUT_GATES = 4;      // the gate math: the gates' sum is h
constexpr int F_CUT_BARRIER = 8;    // the step's barrier
constexpr int F_CUT_STORE = 16;     // the stores of h to the output

__device__ __forceinline__ constexpr bool f_cut(int part) {
    return (F32_CUT & part) != 0;
}

constexpr int F_GROUP = 16;         // (step, row)s a thread's x sums hold

// the shared memory of a block, in floats: W_ih (where it is kept there),
// xw + b of a block of tb steps, the x rows of two blocks, h in two buffers
__host__ __device__ inline int f32_rows_smem_floats(int C, int H, int rows,
                                                    int tb, int wih_in_smem) {
    return (wih_in_smem ? C * 4 * H : 0) + tb * rows * 4 * H
        + 2 * tb * rows * C + 2 * rows * H;
}

// g[base + idx] for idx in 0 .. 3 (idx known at run time), by selects
template <int N>
__device__ __forceinline__ float pick(const float (&g)[N], int base,
                                      int idx) {
    float v = g[base];
    v = idx == 1 ? g[base + 1] : v;
    v = idx == 2 ? g[base + 2] : v;
    v = idx == 3 ? g[base + 3] : v;
    return v;
}

// the h product's four k from k of FR rows of h (row stride H) times
// w0 .. w3: k + j into sum j % NC of its row
template <int FR, int NC>
__device__ __forceinline__ void h_four(float (&ah)[FR][NC], const float* hp,
                                       int H, int k, float w0, float w1,
                                       float w2, float w3) {
#pragma unroll
    for (int r = 0; r < FR; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(hp + r * H + k);
        ah[r][0] = fmaf(v.x, w0, ah[r][0]);
        ah[r][1 % NC] = fmaf(v.y, w1, ah[r][1 % NC]);
        ah[r][2 % NC] = fmaf(v.z, w2, ah[r][2 % NC]);
        ah[r][3 % NC] = fmaf(v.w, w3, ah[r][3 % NC]);
    }
}

template <int KH, int FR>
__global__ void __launch_bounds__(KH > 0 ? 64 * KH : 1024, 1)
lstm_f32_rows_kernel(const float* __restrict__ x,     // [T, N, C]
                     const float* __restrict__ wih,   // [C, 4H]
                     const float* __restrict__ whh,   // [H, 4H]
                     const float* __restrict__ bias,  // [4H]
                     float* __restrict__ out,         // [T, N, H]
                     int T, int N, int C, int H, int reverse, int tb,
                     int wih_in_smem)
{
    constexpr int GP = FR < 4 ? 4 : FR;     // gate values a thread holds
    constexpr int M = GP / 4;               // row slots a lane's gate math
    constexpr int NC = FR < 4 ? 4 / FR : 1; // h product sums a row
    extern __shared__ __align__(16) float fsm[];
    const int G = 4 * H, H2 = 2 * H;
    const int tid = threadIdx.x, lane = tid & 31;
    const int n0 = blockIdx.x * FR;
    float* wis = fsm;
    float* xs = fsm + (wih_in_smem ? C * G : 0);     // [tb][FR][4H]
    float* xst = xs + tb * FR * G;                   // [2][tb][FR][C]
    float* hs = xst + 2 * tb * FR * C;               // [2][FR][H]
    const float* wi = wih_in_smem ? wis : wih;

    // the h phase: thread (unit u, gate q), its gate column q H + u
    const int u = tid >> 2, q = tid & 3, col = q * H + u;
    // the x phase: thread (column pair cp, cp + 2H; half), (step, row)
    // combos m with m % 2 == half
    const int cp = tid % H2, half = tid / H2;
    const float b0 = bias[cp], b1 = bias[cp + H2];

    if (wih_in_smem)
        for (int e = tid; e < C * G / 4; e += G)
            cp_async16(wis + 4 * e, wih + 4 * e);
    float wh[KH > 0 ? 16 * KH : 1];
    if constexpr (KH > 0) {
#pragma unroll
        for (int k = 0; k < 16 * KH; ++k) wh[k] = whh[(size_t)k * G + col];
    }
    for (int e = tid; e < 2 * FR * H; e += G) hs[e] = 0.f;

    const int nb = (T + tb - 1) / tb;
    // start the copies of block b's x rows into its buffer; one commit per
    // call, with or without copies
    auto stage_x = [&](int b) {
        if (b < nb) {
            float* dst = xst + (size_t)(b & 1) * tb * FR * C;
            const int pieces = C / 4;
            for (int e = tid; e < tb * FR * pieces; e += G) {
                const int jj = e / (FR * pieces), r = (e / pieces) % FR;
                const int k4 = e % pieces, j = b * tb + jj;
                float* d = dst + (jj * FR + r) * C + 4 * k4;
                if (j >= T) continue;
                const int t = reverse ? T - 1 - j : j;
                if (n0 + r < N)
                    cp_async16(d, x + ((size_t)t * N + n0 + r) * C + 4 * k4);
                else
                    *reinterpret_cast<float4*>(d) =
                        make_float4(0.f, 0.f, 0.f, 0.f);
            }
        }
        cp_async_commit();
    };
    // xw + b of block b from its x rows: each sum over k in order from
    // zero, the bias added last
    auto x_block = [&](int b) {
        if (f_cut(F_CUT_X)) return;
        const float* xb = xst + (size_t)(b & 1) * tb * FR * C;
        const int last = tb * FR - 1;
        for (int m0 = half; m0 <= last; m0 += 2 * F_GROUP) {
            // a group past the block's last (step, row) repeats that one's
            // sums and stores none
            float acc[F_GROUP][2];
#pragma unroll
            for (int i = 0; i < F_GROUP; ++i) acc[i][0] = acc[i][1] = 0.f;
            for (int k = 0; k < C; k += 4) {
                float w0[4], w1[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    w0[j] = wi[(size_t)(k + j) * G + cp];
                    w1[j] = wi[(size_t)(k + j) * G + cp + H2];
                }
#pragma unroll
                for (int i = 0; i < F_GROUP; ++i) {
                    const float4 v = *reinterpret_cast<const float4*>(
                        xb + min(m0 + 2 * i, last) * C + k);
                    acc[i][0] = fmaf(v.x, w0[0], acc[i][0]);
                    acc[i][0] = fmaf(v.y, w0[1], acc[i][0]);
                    acc[i][0] = fmaf(v.z, w0[2], acc[i][0]);
                    acc[i][0] = fmaf(v.w, w0[3], acc[i][0]);
                    acc[i][1] = fmaf(v.x, w1[0], acc[i][1]);
                    acc[i][1] = fmaf(v.y, w1[1], acc[i][1]);
                    acc[i][1] = fmaf(v.z, w1[2], acc[i][1]);
                    acc[i][1] = fmaf(v.w, w1[3], acc[i][1]);
                }
            }
#pragma unroll
            for (int i = 0; i < F_GROUP; ++i) {
                if (m0 + 2 * i > last) break;
                float* xo = xs + (m0 + 2 * i) * G;
                xo[cp] = acc[i][0] + b0;
                xo[cp + H2] = acc[i][1] + b1;
            }
        }
    };

    stage_x(0);
    stage_x(1);
    cp_async_wait(1);       // W_ih and block 0's rows
    __syncthreads();
    x_block(0);
    __syncthreads();
    float cr[M];
#pragma unroll
    for (int m = 0; m < M; ++m) cr[m] = 0.f;

    for (int b = 0; b < nb; ++b) {
        const int steps = min(tb, T - b * tb);
        for (int jj = 0; jj < steps; ++jj) {
            const int step = b * tb + jj;
            const int t = reverse ? T - 1 - step : step;
            const float* hp = hs + (step & 1) * FR * H;
            float* hn = hs + ((step + 1) & 1) * FR * H;
            float g[GP];
#pragma unroll
            for (int r = 0; r < GP; ++r) g[r] = 0.f;
            if (!f_cut(F_CUT_H)) {
                // NC sums a row, k = j (mod NC) each, so that a block of
                // one or two rows still has four chains of FMAs in flight
                float ah[FR][NC];
#pragma unroll
                for (int r = 0; r < FR; ++r)
#pragma unroll
                    for (int j = 0; j < NC; ++j) ah[r][j] = 0.f;
                if constexpr (KH > 0) {
#pragma unroll
                    for (int k = 0; k < 16 * KH; k += 4)
                        h_four(ah, hp, H, k, wh[k], wh[k + 1], wh[k + 2],
                               wh[k + 3]);
                } else {
                    for (int k = 0; k < H; k += 4)
                        h_four(ah, hp, H, k, whh[(size_t)k * G + col],
                               whh[(size_t)(k + 1) * G + col],
                               whh[(size_t)(k + 2) * G + col],
                               whh[(size_t)(k + 3) * G + col]);
                }
#pragma unroll
                for (int r = 0; r < FR; ++r) {
                    float sum = ah[r][0];
#pragma unroll
                    for (int j = 1; j < NC; ++j) sum += ah[r][j];
                    g[r] = sum;
                }
            }
            const float* xg = xs + jj * FR * G + col;
#pragma unroll
            for (int r = 0; r < FR; ++r) g[r] = xg[r * G] + g[r];
            // lanes 4u' .. 4u' + 3 hold unit u''s four gates: in round s
            // lane q takes gate (q + s) & 3 of its rows 4m + q from lane
            // (q + s) & 3, which sends the value of row 4m + ((q' - s) & 3)
#pragma unroll
            for (int m = 0; m < M; ++m) {
                float gate[4];
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                    const float send = pick(g, 4 * m, (q - s) & 3);
                    gate[(q + s) & 3] = __shfl_sync(
                        0xffffffffu, send, (lane & ~3) | ((q + s) & 3));
                }
                const int r = 4 * m + q;
                if (r >= FR) continue;
                float h;
                if (f_cut(F_CUT_GATES)) {
                    h = gate[0] + gate[1] + gate[2] + gate[3];
                } else {
                    const float ig = sigmoid_f(gate[0]);
                    const float fg = sigmoid_f(gate[1]);
                    const float gg = tanhf(gate[2]);
                    const float og = sigmoid_f(gate[3]);
                    cr[m] = fg * cr[m] + ig * gg;
                    h = og * tanhf(cr[m]);
                }
                hn[r * H + u] = h;
                if (!f_cut(F_CUT_STORE) && n0 + r < N)
                    out[((size_t)t * N + n0 + r) * H + u] = h;
            }
            if (jj == steps - 1) cp_async_wait(0);  // block b + 1's rows
            if (!f_cut(F_CUT_BARRIER) || jj == steps - 1) __syncthreads();
        }
        if (b + 1 < nb) {
            x_block(b + 1);     // every thread is past block b's last step
            stage_x(b + 2);     // into the buffer block b's rows left
            __syncthreads();
        }
    }
}

template <bool TRAIN, typename St>
cudaError_t launch_a32(const A32& p, int ks, size_t smem, cudaStream_t s,
                       unsigned threads) {
    const int grid = p.H / AU;
    switch (ks) {
    case 1: return launch_resident(lstm_a32_kernel<1, TRAIN, St>, grid, smem,
                                   1, s, p, threads);
    case 2: return launch_resident(lstm_a32_kernel<2, TRAIN, St>, grid, smem,
                                   1, s, p, threads);
    case 4: return launch_resident(lstm_a32_kernel<4, TRAIN, St>, grid, smem,
                                   1, s, p, threads);
    default: return launch_resident(lstm_a32_kernel<8, TRAIN, St>, grid,
                                    smem, 1, s, p, threads);
    }
}

// A's checks and launch; with c_out and acts R's instance (stores in bf16
// when round_bf16, else f32)
int a32_entry(const void* xw, const void* whh, void* out, void* hbuf,
              void* flag, void* c_out, void* acts, int round_bf16, int T,
              int N, int n0, int rows, int H, int R, int ks, int kc,
              int stages, int reverse, void* stream)
{
    if (T < 1 || rows < 1 || n0 < 0 || n0 + rows > N || H < 16 || H % 16
        || R % 32 || R < rows || R > A_MAX_ROWS
        || (ks != 1 && ks != 2 && ks != 4 && ks != 8)
        || R / 32 * ks > A_MAX_WARPS || kc < 8 * ks || kc % (8 * ks)
        || H % kc || stages < 2 || stages > 8)
        return (int)cudaErrorInvalidValue;
    const size_t smem = a32_smem(H, R, ks, kc, stages);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const size_t st = round_bf16 ? 2 : 4;
    A32 p;
    p.xw = static_cast<const float*>(xw) + (size_t)n0 * 4 * H;
    p.whh = static_cast<const float*>(whh);
    p.out = static_cast<float*>(out) + (size_t)n0 * H;
    p.hbuf = static_cast<float*>(hbuf);
    p.flag = static_cast<unsigned*>(flag);
    p.c_out = c_out ? static_cast<char*>(c_out) + (size_t)n0 * H * st
                    : nullptr;
    p.acts = acts ? static_cast<char*>(acts) + (size_t)n0 * 4 * H * st
                  : nullptr;
    p.T = T;
    p.n_stride = N;
    p.rows = rows;
    p.H = H;
    p.R = R;
    p.kc = kc;
    p.stages = stages;
    p.reverse = reverse;
    const unsigned threads = (unsigned)(R / 32 * ks + 1) * 32;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        acts == nullptr ? launch_a32<false, float>(p, ks, smem, s, threads)
        : round_bf16    ? launch_a32<true, __nv_bfloat16>(p, ks, smem, s,
                                                          threads)
                        : launch_a32<true, float>(p, ks, smem, s, threads);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

typedef void (*RowsKernel)(const float*, const float*, const float*,
                           const float*, float*, int, int, int, int, int, int,
                           int);

template <int KH>
RowsKernel rows_kernel(int rows) {
    switch (rows) {
    case 1: return lstm_f32_rows_kernel<KH, 1>;
    case 2: return lstm_f32_rows_kernel<KH, 2>;
    case 4: return lstm_f32_rows_kernel<KH, 4>;
    case 8: return lstm_f32_rows_kernel<KH, 8>;
    default: return nullptr;
    }
}

}  // namespace

// Kernel A in f32, one launch for the batch rows n0 .. n0 + rows - 1 of xw
// [T, N, 4H] and out [T, N, H]; whh [H, 4H] (16-byte aligned), all f32.
// hbuf [2, H, R + 8] f32 and flag (one int32) are zeroed scratch. The
// layout is the caller's plan (ops/lstm_cuda.py:f32_plan), taken as given:
// R rows a CTA (a multiple of 32 up to 256, at least rows), ks k-slices
// (1, 2, 4 or 8; R / 32 x ks at most 12 warps), chunks of kc k (dividing
// H, a multiple of 8 ks) and `stages` ring slots (2 to 8). H a multiple
// of 16. The grid is H / 8 CTAs of (R / 32 x ks + 1) warps; it returns
// cudaErrorCooperativeLaunchTooLarge where they cannot all be resident and
// cudaErrorInvalidValue for any other layout.
extern "C" int lstm_recurrence_f32_persistent(
    const void* xw, const void* whh, void* out, void* hbuf, void* flag,
    int T, int N, int n0, int rows, int H, int R, int ks, int kc,
    int stages, int reverse, void* stream)
{
    return a32_entry(xw, whh, out, hbuf, flag, nullptr, nullptr, 0, T, N,
                     n0, rows, H, R, ks, kc, stages, reverse, stream);
}

// Kernel R in f32 (an f32 model's train step): A's f32 kernel with R's
// stores, one launch for the batch rows n0 .. n0 + rows - 1 of xw [T, N,
// 4H], h [T, N, H] (f32), c [T, N, H] and acts [T, N, 4H] (bf16 when
// round_bf16, else f32); the rest as lstm_recurrence_f32_persistent says
// (A's plan, ops/lstm_cuda.py:f32_plan). At one plan h is A's bit for bit.
extern "C" int lstm_train_fwd_f32_persistent(
    const void* xw, const void* whh, void* h, void* c, void* acts,
    void* hbuf, void* flag, int T, int N, int n0, int rows, int H, int R,
    int ks, int kc, int stages, int round_bf16, int reverse, void* stream)
{
    if (c == nullptr || acts == nullptr) return (int)cudaErrorInvalidValue;
    return a32_entry(xw, whh, h, hbuf, flag, c, acts, round_bf16, T, N, n0,
                     rows, H, R, ks, kc, stages, reverse, stream);
}

// Kernel F in f32: x [T, N, C], wih [C, 4H], whh [H, 4H], bias [4H], out
// [T, N, H], all f32 (x and wih at 16-byte addresses); C and H multiples
// of 16, C at most 1024 and H at most 256. The layout is the caller's plan
// (ops/lstm_fused_cuda.py:f32_plan), taken as given: `rows` a block (1, 2,
// 4 or 8), the x product `block` steps at a time, W_hh's column in
// registers (whh_in_registers, built for H 96) or read through L2, W_ih in
// shared memory (wih_in_smem) or not, and smem, the bytes the block asks
// for, which must be what that layout needs.
extern "C" int lstm_fused_f32_rows(const void* x, const void* wih,
                                   const void* whh, const void* bias,
                                   void* out, int T, int N, int C, int H,
                                   int reverse, int rows, int block,
                                   int whh_in_registers, int wih_in_smem,
                                   int smem, void* stream)
{
    const RowsKernel kernel = whh_in_registers ? rows_kernel<6>(rows)
                                               : rows_kernel<0>(rows);
    if (T < 1 || N < 1 || C < 16 || H < 16 || C % 16 != 0 || H % 16 != 0
        || C > 1024 || H > 256 || kernel == nullptr
        || (whh_in_registers && H != 96) || block < 1
        || smem != f32_rows_smem_floats(C, H, rows, block, wih_in_smem)
                       * (int)sizeof(float)
        || smem > SMEM_LIMIT)
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(N + rows - 1) / rows, 4 * H, smem,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(wih),
        static_cast<const float*>(whh), static_cast<const float*>(bias),
        static_cast<float*>(out), T, N, C, H, reverse, block, wih_in_smem);
    return (int)cudaGetLastError();
}

// Kernel S in f32 (an f32 model's train step), one launch for the batch
// rows n0 .. n0 + rows - 1 of acts [T, N, 4H], c [T, N, H] (bf16 when
// round_bf16, else f32, as R stored them), g_h [T, N, H] f32 (the gradient
// of h) and dgates [T, N, 4H] (in the type of acts); whh [H, 4H] f32. gbuf
// [2, 4H, ldr] f32 (ldr = R, or R + 16 where R is a multiple of 32) and
// flag (one int32) are zeroed scratch; acts, c and g_h at 16-byte
// addresses. The layout is the caller's plan (ops/lstm_train_cuda.py:
// f32_backward_plan), taken as given: R rows a CTA (a multiple of 16 up to
// 256, at least rows), ks k-slices (1, 2, 4 or 8; R / 16 x ks at most 16
// warps), chunks of kc k (dividing 4H, a multiple of 8 ks) and
// `stages` ring slots (2 to 8). H a multiple of 16. The grid is H / 8 CTAs
// of (R / 16 x ks + 1) warps; it returns cudaErrorCooperativeLaunchTooLarge
// where they cannot all be resident and cudaErrorInvalidValue for any other
// layout.
extern "C" int lstm_train_bwd_f32_persistent(
    const void* whh, const void* acts, const void* c, const void* g_h,
    void* dgates, void* gbuf, void* flag, int T, int N, int n0, int rows,
    int H, int R, int ks, int kc, int stages, int round_bf16, int reverse,
    void* stream)
{
    if (T < 1 || rows < 1 || n0 < 0 || n0 + rows > N || H < 16 || H % 16
        || R % 16 || R < rows || R > S_MAX_ROWS
        || (ks != 1 && ks != 2 && ks != 4 && ks != 8)
        || R / 16 * ks > S_MAX_WARPS || kc < 8 * ks || kc % (8 * ks)
        || (4 * H) % kc || stages < 2 || stages > 8)
        return (int)cudaErrorInvalidValue;
    const int st = round_bf16 ? 2 : 4;
    const size_t smem = s32_smem(H, R, ks, kc, stages, st);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    S32 p;
    p.whh = static_cast<const float*>(whh);
    p.acts = static_cast<const char*>(acts) + (size_t)n0 * 4 * H * st;
    p.c = static_cast<const char*>(c) + (size_t)n0 * H * st;
    p.g_h = static_cast<const float*>(g_h) + (size_t)n0 * H;
    p.dgates = static_cast<char*>(dgates) + (size_t)n0 * 4 * H * st;
    p.gbuf = static_cast<float*>(gbuf);
    p.flag = static_cast<unsigned*>(flag);
    p.T = T;
    p.n_stride = N;
    p.rows = rows;
    p.H = H;
    p.R = R;
    p.ldr = s32_ldr(R);
    p.kc = kc;
    p.stages = stages;
    p.reverse = reverse;
    const unsigned threads = (unsigned)(R / 16 * ks + 1) * 32;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        round_bf16 ? launch_s32<__nv_bfloat16>(p, ks, smem, s, threads)
                   : launch_s32<float>(p, ks, smem, s, threads);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}
