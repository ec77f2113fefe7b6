// The persistent LSTM recurrence that kernels A (csrc/lstm.cu) and R
// (csrc/lstm_train.cu) share, and the primitives it, kernel S's persistent
// BPTT and the persistent int8 layers D and E (csrc/lstm_int8.cu) are built
// from: cp.async, ldmatrix, mma.sync, mbarriers, bulk copies (multicast or
// not), the cluster's barrier and its shared memory, the release/acquire
// counter in global memory, and the cooperative launch in clusters
// (launch_resident).
//
// lstm_persistent_bf16<MT, TRAIN> is A's kernel (its design: csrc/lstm.cu).
// TRAIN adds R's stores to the gate math and nothing else: c_t and the
// four activations in bf16, for S. The products, the sums and the rounding
// of h are the same instructions in both instances, so at one plan R's h
// is A's bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float sigmoid_f(float x) {
    return 1.f / (1.f + expf(-x));
}

constexpr int PU = 16;              // hidden units per CTA
constexpr int PC = 4 * PU;          // gate columns per CTA
constexpr int PUG = PU / 8;         // unit groups: 8 units x 4 gates each
constexpr int PKS = 4;              // k-slices
constexpr int PWARPS = PUG * PKS;
constexpr int PTHREADS = PWARPS * 32;
constexpr int PAD = 8;              // bf16 (or f32) padding per shared row
constexpr int LDP = PC + PAD;       // row stride of the k-slices' partials
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may ask for

// the shared memory of one CTA: W_hh's slice, then the ring of h chunks,
// which the k-slices' partial sums reuse at the end of each step
__host__ __device__ inline size_t w_bytes(int H) {
    return (size_t)PC * (H + PAD) * 2;
}
__host__ __device__ inline size_t ring_bytes(int R, int kc, int stages) {
    const size_t ring = (size_t)stages * R * (kc + PAD) * 2;
    const size_t part = (size_t)PKS * R * LDP * 4;
    return ring > part ? ring : part;
}

// a wait that cannot end (a peer that never arrives) traps, so that the
// launch fails instead of holding the card
constexpr long long SPIN_LIMIT = 1ll << 26;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_u32(s)), "l"(__cvta_generic_to_global(g))
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n (0 .. 6) of the groups committed so far are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
    switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1,
                                            const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
        : "=r"(r0), "=r"(r1) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
    unsigned v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void red_release(unsigned* p, unsigned v) {
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;\n"
                 :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
    unsigned ok;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    return ok != 0;
}

// bytes from global memory into the same offset of the shared memory of
// every CTA of the cluster in mask; each one's mbarrier at bar's offset
// counts them
__device__ __forceinline__ void bulk_multicast(void* dst, const void* src,
                                               unsigned bytes, uint64_t* bar,
                                               uint16_t mask) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
        :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)),
           "r"(bytes), "r"(smem_u32(bar)), "h"(mask) : "memory");
}

// bytes from global memory into this CTA's shared memory; its mbarrier bar
// counts them
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_u32(dst)), "l"(__cvta_generic_to_global(src)),
           "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// four floats into the shared memory of CTA `rank` of the cluster, at the
// offset of `local` in this CTA's
__device__ __forceinline__ void st_cluster_f4(float* local, unsigned rank,
                                              float4 v) {
    uint32_t remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(remote) : "r"(smem_u32(local)), "r"(rank));
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
                 : "memory");
}

// wait for the phase of parity `parity` of an mbarrier to complete
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    long long spins = 0;
    while (!mbar_try_wait(bar, parity))
        if (++spins > SPIN_LIMIT) __trap();
}

__device__ __forceinline__ unsigned cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wait_count(const unsigned* flag,
                                           unsigned target) {
    long long spins = 0;
    while (ld_acquire(flag) < target)
        if (++spins > SPIN_LIMIT) __trap();
}

struct Persist {
    const __nv_bfloat16* xw;   // [T, n_stride, 4H], this launch's first row
    const __nv_bfloat16* wt;   // [4H, H]: W_hh transposed
    __nv_bfloat16* out;        // [T, n_stride, H], this launch's first row
    __nv_bfloat16* c_out;      // TRAIN: [T, n_stride, H], first row
    __nv_bfloat16* acts;       // TRAIN: [T, n_stride, 4H], first row
    __nv_bfloat16* hbuf;       // [2, slices * R, H], zeroed
    unsigned* flags;           // [slices], zeroed
    int T, n_stride, rows, H, kc, stages, reverse, g_u;
    int cluster;               // CTAs that share each h load: 1 or 2
};

// MT: m-tiles of 16 rows per CTA (R = 16 MT); TRAIN: R's stores of c_t and
// the activations
template <int MT, bool TRAIN>
__global__ void __launch_bounds__(PTHREADS, 1)
lstm_persistent_bf16(Persist p)
{
    constexpr int R = 16 * MT;
    constexpr int EU = (R * PU + PTHREADS - 1) / PTHREADS;  // units a thread
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int H = p.H, kc = p.kc, stages = p.stages;
    const int ldw = H + PAD, ldr = kc + PAD;
    __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(smem_raw);
    __nv_bfloat16* ring = Ws + (size_t)PC * ldw;
    float* part = reinterpret_cast<float*>(ring);
    // with a cluster, one mbarrier a chunk, after the ring
    uint64_t* mbar = reinterpret_cast<uint64_t*>(
        smem_raw + w_bytes(H) + ring_bytes(R, kc, stages));
    const bool shared_h = p.cluster > 1;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int slice = blockIdx.x / p.g_u;
    const int u0 = (blockIdx.x % p.g_u) * PU;
    const int row0 = slice * R;

    // W_hh's slice, once: shared row 8 nt + uu (n-tile nt = 4 j + q) is
    // gate q of unit u0 + 8 j + uu, its H values of k contiguous
    for (int e = tid; e < PC * (H / 8); e += PTHREADS) {
        const int col = e / (H / 8), k8 = (e % (H / 8)) * 8;
        const int q = (col >> 3) & 3, unit = u0 + (col >> 5) * 8 + (col & 7);
        cp_async16(Ws + (size_t)col * ldw + k8,
                   p.wt + (size_t)(q * H + unit) * H + k8);
    }
    cp_async_commit();
    if (shared_h) {
        // the ring's waits are on mbarriers, so W_hh's slice is waited for
        // here; the cluster's barrier then shows it to every thread, and no
        // copy reaches a CTA before its mbarriers are initialised
        cp_async_wait(0);
        if (tid == 0) {
            for (int c = 0; c < stages; ++c) mbar_init(mbar + c, 1);
            asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        }
        cluster_sync();
    }

    // the (row, unit)s this thread updates, fixed for the layer: c stays in
    // registers, and xw of the next step is fetched while this one runs
    int er[EU], eu[EU];
    bool live[EU];
    float c[EU];
    __nv_bfloat16 x[EU][4];
    const size_t xw_t = (size_t)p.n_stride * 4 * H;
    const size_t out_t = (size_t)p.n_stride * H;
    auto fetch_xw = [&](int t) {
#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            const __nv_bfloat16* xr = p.xw + t * xw_t
                + (size_t)(row0 + er[i]) * 4 * H + u0 + eu[i];
#pragma unroll
            for (int q = 0; q < 4; ++q) x[i][q] = xr[q * H];
        }
    };
#pragma unroll
    for (int i = 0; i < EU; ++i) {
        const int e = tid + i * PTHREADS;
        er[i] = e / PU;
        eu[i] = e % PU;
        live[i] = e < R * PU && row0 + er[i] < p.rows;
        c[i] = 0.f;
    }
    fetch_xw(p.reverse ? p.T - 1 : 0);

    const int j = warp / PKS, ks = warp % PKS;      // unit group, k-slice
    const int g = lane >> 2, c4 = lane & 3;
    const int n_chunks = H / kc;
    const size_t plane = (size_t)gridDim.x / p.g_u * R * H;
    // ldmatrix lane addressing: A (h rows) and B (W_hh rows, two n-tiles)
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int b_row = j * 32 + (lane >> 4) * 8 + (lane & 7);
    const int b_col = ((lane >> 3) & 1) * 8;

    for (int step = 0; step < p.T; ++step) {
        const int t = p.reverse ? p.T - 1 - step : step;
        const __nv_bfloat16* h_in = p.hbuf + (size_t)(step & 1) * plane
                                    + (size_t)row0 * H;
        __nv_bfloat16* h_out = p.hbuf + (size_t)((step + 1) & 1) * plane;

        // h_{t-1} of this slice is complete once its g_u CTAs have counted
        // step - 1 (an acquire load, then the CTA's barrier)
        if (step > 0) {
            if (tid == 0) wait_count(p.flags + slice, (unsigned)step * p.g_u);
            __syncthreads();
        }

        auto load_chunk = [&](int ch) {
            __nv_bfloat16* dst = ring + (size_t)(ch % stages) * R * ldr;
            const __nv_bfloat16* src = h_in + ch * kc;
            for (int e = tid; e < R * (kc / 8); e += PTHREADS) {
                const int r = e / (kc / 8), k8 = (e % (kc / 8)) * 8;
                cp_async16(dst + r * ldr + k8, src + (size_t)r * H + k8);
            }
        };
        if (shared_h) {
            // every chunk of the step at once (the ring holds them all):
            // each CTA of the cluster copies its share of the rows into the
            // shared memory of all of them, one bulk copy a row and chunk
            const int share = R / p.cluster;
            const unsigned rank = cluster_rank();
            if (tid == 0)
                for (int c = 0; c < n_chunks; ++c)
                    mbar_expect_tx(mbar + c, (unsigned)(R * kc * 2));
            if (tid < share) {
                // h_in was written through the generic proxy and acquired
                // above; the bulk copies read it through the async proxy
                asm volatile("fence.proxy.async.global;\n" ::: "memory");
                const int r = (int)rank * share + tid;
                for (int c = 0; c < n_chunks; ++c)
                    bulk_multicast(ring + ((size_t)c * R + r) * ldr,
                                   h_in + (size_t)r * H + c * kc,
                                   (unsigned)(kc * 2), mbar + c,
                                   (uint16_t)((1u << p.cluster) - 1));
            }
        } else {
            for (int ch = 0; ch < stages - 1; ++ch) {
                if (ch < n_chunks) load_chunk(ch);
                cp_async_commit();
            }
        }

        // warp (j, ks) sums unit group j's four n-tiles (its 8 units' four
        // gates) over all R rows and the k-steps kt = ks (mod 4) of each
        // chunk
        float acc[MT][4][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;

        for (int ch = 0; ch < n_chunks; ++ch) {
            if (shared_h) {             // chunk ch is in, from every copier
                mbar_wait(mbar + ch, (unsigned)(step & 1));
            } else {
                cp_async_wait(stages - 2);
                __syncthreads();        // chunk ch is in; ch - 1 is read
                if (ch + stages - 1 < n_chunks) load_chunk(ch + stages - 1);
                cp_async_commit();
            }
            const __nv_bfloat16* hs = ring + (size_t)(ch % stages) * R * ldr;
            const __nv_bfloat16* ws = Ws + (size_t)b_row * ldw + ch * kc + b_col;
#pragma unroll 4
            for (int kt = ks; kt < kc / 16; kt += PKS) {
                uint32_t b01[4], b23[4];
                ldmatrix_x4(b01, ws + kt * 16);
                ldmatrix_x4(b23, ws + (size_t)16 * ldw + kt * 16);
#pragma unroll
                for (int m = 0; m < MT; ++m) {
                    uint32_t a[4];
                    ldmatrix_x4(a, hs + (m * 16 + a_row) * ldr + kt * 16 + a_col);
                    mma_bf16(acc[m][0], a, b01[0], b01[1]);
                    mma_bf16(acc[m][1], a, b01[2], b01[3]);
                    mma_bf16(acc[m][2], a, b23[0], b23[1]);
                    mma_bf16(acc[m][3], a, b23[2], b23[3]);
                }
            }
        }
        __syncthreads();                // every warp is done with the ring

        // the k-slices' partial sums: part[ks][row][8 nt + unit], n-tile
        // nt = 4 j + q
        float* mine = part + (size_t)ks * R * LDP;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int col = j * 32 + q * 8 + 2 * c4;
                const int r = m * 16 + g;
                *reinterpret_cast<float2*>(mine + r * LDP + col) =
                    make_float2(acc[m][q][0], acc[m][q][1]);
                *reinterpret_cast<float2*>(mine + (r + 8) * LDP + col) =
                    make_float2(acc[m][q][2], acc[m][q][3]);
            }
        __syncthreads();

#pragma unroll
        for (int i = 0; i < EU; ++i) {
            if (!live[i]) continue;
            const int r = er[i], u = eu[i];
            const int col = (u >> 3) * 32 + (u & 7);
            float gt[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                float sum = __bfloat162float(x[i][q]);
#pragma unroll
                for (int k = 0; k < PKS; ++k)
                    sum += part[((size_t)k * R + r) * LDP + col + q * 8];
                gt[q] = sum;
            }
            const float ig = sigmoid_f(gt[0]);
            const float fg = sigmoid_f(gt[1]);
            const float gg = tanhf(gt[2]);
            const float og = sigmoid_f(gt[3]);
            c[i] = fg * c[i] + ig * gg;
            const __nv_bfloat16 hv = __float2bfloat16(og * tanhf(c[i]));
            const size_t row = (size_t)(row0 + r);
            p.out[t * out_t + row * H + u0 + u] = hv;
            h_out[row * H + u0 + u] = hv;
            if constexpr (TRAIN) {
                p.c_out[t * out_t + row * H + u0 + u] = __float2bfloat16(c[i]);
                __nv_bfloat16* a = p.acts + t * xw_t + row * 4 * H + u0 + u;
                a[0] = __float2bfloat16(ig);
                a[H] = __float2bfloat16(fg);
                a[2 * H] = __float2bfloat16(gg);
                a[3 * H] = __float2bfloat16(og);
            }
        }
        // count this CTA's step: its h writes (the CTA's barrier), then the
        // release; xw of the next step is fetched after it, so that no fence
        // waits for those loads. With a cluster, the peer's multicast of the
        // next step (async proxy) lands in the ring that the partial sums
        // just used (generic proxy): a proxy fence orders the two.
        if (shared_h)
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncthreads();
        if (tid == 0) red_release(p.flags + slice, 1u);
        if (step + 1 < p.T) fetch_xw(p.reverse ? t - 1 : t + 1);
    }
    if (shared_h) cluster_sync();   // no CTA leaves while copies are due
}

// One cooperative launch of `grid` CTAs of `threads` threads (PTHREADS
// unless given) in clusters of `cluster`. Every CTA waits on others, so the
// grid must be resident all at once, in the clusters the plan asked for:
// the occupancy API says so before the launch, or this returns
// cudaErrorCooperativeLaunchTooLarge.
template <typename Params>
cudaError_t launch_resident(void (*kernel)(Params), long long grid,
                            size_t smem, int cluster, cudaStream_t stream,
                            const Params& p, unsigned threads = PTHREADS)
{
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attrs[2];
    attrs[0].id = cudaLaunchAttributeClusterDimension;
    attrs[0].val.clusterDim.x = cluster;
    attrs[0].val.clusterDim.y = 1;
    attrs[0].val.clusterDim.z = 1;
    attrs[1].id = cudaLaunchAttributeCooperative;
    attrs[1].val.cooperative = 1;
    cfg.attrs = attrs;
    cfg.numAttrs = 1;
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if ((long long)clusters * cluster < grid)
        return cudaErrorCooperativeLaunchTooLarge;
    cfg.numAttrs = 2;
    return cudaLaunchKernelEx(&cfg, kernel, p);
}

template <int MT, bool TRAIN>
cudaError_t launch_persistent(const Persist& p, int slices, size_t smem,
                              cudaStream_t stream)
{
    return launch_resident(lstm_persistent_bf16<MT, TRAIN>,
                           (long long)p.g_u * slices, smem, p.cluster, stream,
                           p);
}

// One launch of the persistent recurrence for the batch rows n0 .. n0 +
// rows - 1 of xw [T, N, 4H] bf16 and out [T, N, H] bf16 (with TRAIN, also c
// [T, N, H] and acts [T, N, 4H] bf16); wt [4H, H] bf16 is W_hh transposed,
// contiguous. hbuf [2, slices * R, H] bf16 and flags [slices] int32 are
// zeroed scratch; R = 16 * mt rows a slice, slices * R >= rows. H a
// multiple of 16 and of kc (a multiple of 16 up to 512); 2 <= stages <= 8.
// cluster 2 shares each h load between the two CTAs of a cluster (H / 16
// even, and a ring of all H / kc chunks). The grid is (H / 16) x slices CTAs
// of 256 threads in clusters of `cluster`; it returns
// cudaErrorCooperativeLaunchTooLarge where they cannot all be resident.
template <bool TRAIN>
int persistent_recurrence(const void* xw, const void* wt, void* out,
                          void* c_out, void* acts, void* hbuf, void* flags,
                          int T, int N, int n0, int rows, int H, int mt,
                          int slices, int kc, int stages, int cluster,
                          int reverse, void* stream)
{
    if (T < 1 || rows < 1 || n0 < 0 || n0 + rows > N || H < 16 || H % PU
        || mt < 1 || mt > 4 || slices < 1 || slices * 16 * mt < rows
        || kc < 16 || kc > 512 || kc % 16 || H % kc || stages < 2
        || stages > 8 || (cluster != 1 && cluster != 2)
        || (cluster == 2 && ((H / PU) % 2 || stages != H / kc)))
        return (int)cudaErrorInvalidValue;
    const size_t smem = w_bytes(H) + ring_bytes(16 * mt, kc, stages)
        + (cluster > 1 ? (size_t)8 * stages : 0);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    Persist p;
    p.xw = static_cast<const __nv_bfloat16*>(xw) + (size_t)n0 * 4 * H;
    p.wt = static_cast<const __nv_bfloat16*>(wt);
    p.out = static_cast<__nv_bfloat16*>(out) + (size_t)n0 * H;
    p.c_out = TRAIN ? static_cast<__nv_bfloat16*>(c_out) + (size_t)n0 * H
                    : nullptr;
    p.acts = TRAIN ? static_cast<__nv_bfloat16*>(acts) + (size_t)n0 * 4 * H
                   : nullptr;
    p.hbuf = static_cast<__nv_bfloat16*>(hbuf);
    p.flags = static_cast<unsigned*>(flags);
    p.T = T;
    p.n_stride = N;
    p.rows = rows;
    p.H = H;
    p.kc = kc;
    p.stages = stages;
    p.reverse = reverse;
    p.g_u = H / PU;
    p.cluster = cluster;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (mt) {
    case 1: err = launch_persistent<1, TRAIN>(p, slices, smem, s); break;
    case 2: err = launch_persistent<2, TRAIN>(p, slices, smem, s); break;
    case 3: err = launch_persistent<3, TRAIN>(p, slices, smem, s); break;
    default: err = launch_persistent<4, TRAIN>(p, slices, smem, s); break;
    }
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

}  // namespace
