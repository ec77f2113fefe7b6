// The head product of kernel GW (the fused-head decode at 512 and 1024
// states: hac and sup through head_route="fused"), taken once for the
// whole batch and written to device memory as the f32 move scores that
// both passes of the decode then read on the ring of csrc/decode_ring.cuh
// (GW's forward, JW's backward: TcnRows<float>).
//
// Replaces the head product of bonito_tpu/ops/decode_pallas.py `_head_mv`
// (:324), which `_fwd_kernel_tcn_fused` and `_bwd_kernel_tcn_fused` each
// take inside the kernel to keep the move tensor out of HBM. On an H100
// the f32 move tensor costs far less to write once and read twice (hac:
// [96, 1666, 4096] f32, 2.62 GB, 0.78 ms each way at 3.35 TB/s) than a
// second product.
//
// The product, a GEMM of M = N*Th rows, U*4S columns and K = H:
//
//     out[m, p*4S + c] = act(sum_k h[th, n, k] * wT[p, c, k] + bias[p, c])
//
// with m = n*Th + th, so that out, row-major, is the [N, T, 4S] f32 move
// tensor of frame t = th*U + p (ops/decode_fused_cuda.py:head_moves_plain),
// rows in the TCN (b, j, r) order of wT as it is. Each output is one chain
// of fmaf over k = 0 .. H-1 in order: a product of two bf16 values is exact
// in f32, so each step rounds once, as head_moves_plain's addcmul_ does,
// and as the earlier GW and JW (csrc/decode_tcn_fused_wide.cu) did; then
// bias, tanh, scale and clamp in that order (`_head_mv`'s). No split of K,
// no atomics, no tree: the plain version's bits.
//
// What bounds it on an H100: operations. 2*M*U*4S*H = 1.342e12 at hac (N
// 96, Th 1666, H 1024, S 1024) and 1.074e12 at sup (N 128, Th 1000, U 2, H
// 512): 1.36 and 1.09 ms on the bf16 tensor cores, 20.0 and 16.0 ms on the
// f32 cores at 67 TFLOP/s, against 2.62 and 4.19 GB of output (0.78, 1.25
// ms). The tensor cores are not used: mma.sync sums its k-tiles in an order
// no plain PyTorch version repeats, and on a random hac batch that order
// moved 0.18% of the decoded frames (near-ties of the max semiring) where
// 0.1% is allowed (chip_smoke.py DECODE_MIN_EQUAL). So the f32 cores set
// the pace, and the design keeps them issuing FFMA:
//   the tile   a CTA of 256 threads computes a 128 x 128 tile of outputs,
//              8 x 8 a thread (rows ty*4 + i and 64 + ty*4 + i, columns
//              likewise with tx), the warps' threads 4 rows by 8 columns,
//              so that each k step is four 16-byte shared loads (A in one
//              wavefront of 4 distinct addresses, B in one of 8) for 64
//              FFMA; launch bounds of two CTAs an SM (128 registers).
//   staging    bf16 tiles of h (rows) and wT (columns), BK = 16 k at a
//              time, go through a ring of STAGES slots in shared memory by
//              cp.async (16 bytes, 8 k of one row, a thread; a warp's copy
//              is 16 whole rows, one 32-byte sector each); each thread
//              waits for its own copies (cp.async.wait_group), converts
//              the 8 values it copied to f32 and stores them k-major into
//              one of two f32 tiles ([BK][128] for A and for B, the rows
//              swizzled by k so that the stores are conflict-free), which
//              the FFMA loop reads. Converting on staging takes one
//              conversion per staged value and CTA; converting on the
//              register load would take one per value and thread that
//              reads it (16 times as many: 16 integer ops for every 64
//              FFMA). The next tile's conversion follows this tile's FFMA
//              loop, behind one barrier a k tile. (Copies of 32 rows of
//              16 bytes a warp, each sector fetched by two warps, made
//              the copies 2.6 times as costly on an H100:
//              scripts/decode_split.py gw.)
//   schedule   a persistent grid of two CTAs an SM walks the tiles column
//              tile fastest, so that the CTAs in flight share a few row
//              panels of h (256 KB each at hac) and the whole weight (8
//              MB): both stay in L2, HBM sees h once and the output once
//              (stored streaming, __stcs, so that it does not evict them).
// scripts/decode_split.py gw times it with parts left out (HP_CUT) and at
// other tiles (HP_BM, HP_BN, HP_BK, HP_STAGES).

#include "lstm_persistent.cuh"

#ifndef HP_CUT
#define HP_CUT 0
#endif
#ifndef HP_BM
#define HP_BM 128
#endif
#ifndef HP_BN
#define HP_BN 128
#endif
#ifndef HP_BK
#define HP_BK 16
#endif
#ifndef HP_STAGES
#define HP_STAGES 4
#endif

namespace {

// the parts scripts/decode_split.py gw leaves out
constexpr int HP_CUT_EPILOGUE = 1;  // bias, tanh, scale, clamp: the sum stored
constexpr int HP_CUT_STORES = 2;    // the output's stores
constexpr int HP_CUT_CONVERT = 4;   // the conversion to the f32 tiles
constexpr int HP_CUT_COPIES = 8;    // the copies into the ring and their waits
constexpr int HP_CUT_COPIES_H = 16;   // the copies of h alone
constexpr int HP_CUT_COPIES_W = 32;   // the copies of wT alone

__device__ __forceinline__ constexpr bool hp_cut(int part) {
    return (HP_CUT & part) != 0;
}

typedef __nv_bfloat16 bf16;

struct HeadAct {
    int act_tanh;
    float scale;
    int clamp;
    float cmin, cmax;
};

// A CTA's tile of BM rows by BN columns, BK k a step, on a ring of STAGES
// slots; threads of 8 x 8 outputs, warps of 4 x 8 threads.
template <int BM, int BN, int BK, int STAGES>
struct ProductTile {
    static constexpr int TY = BM / 8, TX = BN / 8;  // threads by row, column
    static constexpr int THREADS = TY * TX;
    static constexpr int WX = TX / 8;               // warps along a row
    static constexpr int CA = BM * BK / 8 / THREADS;  // 16-byte copies of h
    static constexpr int CB = BN * BK / 8 / THREADS;  // and of wT, a thread
    static_assert(TY % 4 == 0 && TX % 8 == 0, "warps of 4 x 8 threads");
    static_assert(BK % 8 == 0 && CA >= 1 && CB >= 1
                  && CA * THREADS * 8 == BM * BK
                  && CB * THREADS * 8 == BN * BK, "whole copies a thread");
    // shared memory: the f32 tiles [2][BK][BM] and [2][BK][BN], then the
    // ring's slots of BM + BN rows of BK bf16 (16 bytes a copy)
    static constexpr int F32_BYTES = 2 * BK * (BM + BN) * 4;
    static constexpr int SLOT_BYTES = (BM + BN) * BK * 2;
    static constexpr int SMEM = F32_BYTES + STAGES * SLOT_BYTES;
};

__device__ __forceinline__ float bf_lo(uint32_t v) {
    return __uint_as_float(v << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t v) {
    return __uint_as_float(v & 0xffff0000u);
}

// The staging of a step's BK k of ROWS rows: copy id (tid + e*THREADS for
// a thread's copy e of h, or of wT) takes 16 bytes, 8 k, of row id / PPR
// at piece id % PPR (PPR = BK / 8 pieces a row), so that a warp's copy
// covers 32 / PPR whole rows of BK k: one 32-byte sector a row at BK 16.
// Its 8 values go to the f32 tile [BK][ROWS] at k = piece*8 + j, row
// `row ^ swizzle(k)`: the pieces of one row land in other banks, so that
// the warp's stores are conflict-free, and the FFMA loop's reads of a k
// (four adjacent floats a thread) stay in one wavefront.
template <int BK>
__device__ __forceinline__ constexpr int swizzle(int k) {
    return (k / 8) % (BK / 8) * (32 / (BK / 8));
}

template <int BK>
__device__ __forceinline__ void copy_piece(unsigned char* slot, int id,
                                           const bf16* src_row, int k0) {
    cp_async16(slot + (size_t)id * 16, src_row + k0 + id % (BK / 8) * 8);
}

template <int ROWS, int BK>
__device__ __forceinline__ void convert_piece(float* f,
                                              const unsigned char* slot,
                                              int id) {
    const uint4 v = *reinterpret_cast<const uint4*>(slot + (size_t)id * 16);
    const int piece = id % (BK / 8), row = id / (BK / 8);
    float* d = f + piece * 8 * ROWS + (row ^ swizzle<BK>(piece * 8));
    d[0 * ROWS] = bf_lo(v.x);
    d[1 * ROWS] = bf_hi(v.x);
    d[2 * ROWS] = bf_lo(v.y);
    d[3 * ROWS] = bf_hi(v.y);
    d[4 * ROWS] = bf_lo(v.z);
    d[5 * ROWS] = bf_hi(v.z);
    d[6 * ROWS] = bf_lo(v.w);
    d[7 * ROWS] = bf_hi(v.w);
}

__device__ __forceinline__ float head_act(float z, const HeadAct& o) {
    if (o.act_tanh) z = tanhf(z);
    z = __fmul_rn(z, o.scale);
    if (o.clamp) z = fminf(fmaxf(z, o.cmin), o.cmax);
    return z;
}

template <int BM, int BN, int BK, int STAGES>
__global__ void __launch_bounds__(ProductTile<BM, BN, BK, STAGES>::THREADS, 2)
head_product_kernel(const bf16* __restrict__ h,      // [Th, N, H]
                    const bf16* __restrict__ wT,     // [cols, H]
                    const float* __restrict__ bias,  // [cols]
                    float* __restrict__ out,         // [N*Th, cols]
                    int Th, int N, int H, int cols, HeadAct act)
{
    using P = ProductTile<BM, BN, BK, STAGES>;
    extern __shared__ __align__(16) unsigned char hp_smem[];
    float* fa = reinterpret_cast<float*>(hp_smem);  // [2][BK][BM]
    float* fb = fa + 2 * BK * BM;                    // [2][BK][BN]
    unsigned char* ring = hp_smem + P::F32_BYTES;
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int ty = (w / P::WX) * 4 + lane / 8;
    const int tx = (w % P::WX) * 8 + lane % 8;
    const int M = N * Th, KT = H / BK;
    const int tiles_n = cols / BN;
    const int tiles = (M + BM - 1) / BM * tiles_n;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, c0 = tile % tiles_n * BN;
        // the rows this thread copies (past M: row M-1, never stored)
        const bf16* a_src[P::CA];
        const bf16* b_src[P::CB];
#pragma unroll
        for (int e = 0; e < P::CA; ++e) {
            const int m = min(m0 + (tid + e * P::THREADS) / (BK / 8),
                              M - 1);
            const int n = m / Th, th = m - n * Th;
            a_src[e] = h + ((size_t)th * N + n) * H;
        }
#pragma unroll
        for (int e = 0; e < P::CB; ++e)
            b_src[e] = wT + (size_t)(c0 + (tid + e * P::THREADS)
                                     / (BK / 8)) * H;

        auto issue = [&](int kt) {
            if (hp_cut(HP_CUT_COPIES)) return;
            unsigned char* slot = ring + (kt % STAGES) * P::SLOT_BYTES;
#pragma unroll
            for (int e = 0; e < P::CA && !hp_cut(HP_CUT_COPIES_H); ++e)
                copy_piece<BK>(slot, tid + e * P::THREADS, a_src[e],
                               kt * BK);
#pragma unroll
            for (int e = 0; e < P::CB && !hp_cut(HP_CUT_COPIES_W); ++e)
                copy_piece<BK>(slot + BM * BK * 2, tid + e * P::THREADS,
                               b_src[e], kt * BK);
        };
        auto convert = [&](int kt) {
            if (!hp_cut(HP_CUT_COPIES))
                cp_async_wait(STAGES - 2);  // this thread's copies of kt
            if (hp_cut(HP_CUT_CONVERT)) return;
            const unsigned char* slot = ring + (kt % STAGES) * P::SLOT_BYTES;
            float* ta = fa + (kt & 1) * BK * BM;
            float* tb = fb + (kt & 1) * BK * BN;
#pragma unroll
            for (int e = 0; e < P::CA; ++e)
                convert_piece<BM, BK>(ta, slot, tid + e * P::THREADS);
#pragma unroll
            for (int e = 0; e < P::CB; ++e)
                convert_piece<BN, BK>(tb, slot + BM * BK * 2,
                                  tid + e * P::THREADS);
        };

#pragma unroll
        for (int s = 0; s < STAGES - 1; ++s) {
            if (s < KT) issue(s);
            cp_async_commit();
        }
        convert(0);
        __syncthreads();

        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll 1
        for (int kt = 0; kt < KT; ++kt) {
            if (kt + STAGES - 1 < KT) issue(kt + STAGES - 1);
            cp_async_commit();
            const float* ta = fa + (kt & 1) * BK * BM;
            const float* tb = fb + (kt & 1) * BK * BN;
#pragma unroll
            for (int k = 0; k < BK; ++k) {
                const int sw = swizzle<BK>(k);
                const float4 a0 = *reinterpret_cast<const float4*>(
                    ta + k * BM + ((ty * 4) ^ sw));
                const float4 a1 = *reinterpret_cast<const float4*>(
                    ta + k * BM + ((BM / 2 + ty * 4) ^ sw));
                const float4 b0 = *reinterpret_cast<const float4*>(
                    tb + k * BN + ((tx * 4) ^ sw));
                const float4 b1 = *reinterpret_cast<const float4*>(
                    tb + k * BN + ((BN / 2 + tx * 4) ^ sw));
                const float a[8] = {a0.x, a0.y, a0.z, a0.w,
                                    a1.x, a1.y, a1.z, a1.w};
                const float b[8] = {b0.x, b0.y, b0.z, b0.w,
                                    b1.x, b1.y, b1.z, b1.w};
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j)
                        acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
            }
            if (kt + 1 < KT) convert(kt + 1);
            __syncthreads();
        }

        // the epilogue: rows m0 + ty*4 + i (+ BM/2), columns c0 + tx*4 + j
        // (+ BN/2), four adjacent columns a store
#pragma unroll
        for (int jh = 0; jh < 2; ++jh) {
            const int c = c0 + jh * (BN / 2) + tx * 4;
            const float4 bv = *reinterpret_cast<const float4*>(bias + c);
            const float bb[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const int m = m0 + (i / 4) * (BM / 2) + ty * 4 + i % 4;
                float z[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    z[j] = acc[i][jh * 4 + j];
                    if (!hp_cut(HP_CUT_EPILOGUE))
                        z[j] = head_act(__fadd_rn(z[j], bb[j]), act);
                }
                float4* dst = reinterpret_cast<float4*>(
                    out + (size_t)m * cols + c);
                const float4 v = make_float4(z[0], z[1], z[2], z[3]);
                if (hp_cut(HP_CUT_STORES)) {
                    // kept live: a store that no finite sum takes
                    if (m < M && __float_as_uint(z[0]) == 0x7fc00001u)
                        __stcs(dst, v);
                } else if (m < M) {
                    __stcs(dst, v);
                }
            }
        }
    }
}

using Tile = ProductTile<HP_BM, HP_BN, HP_BK, HP_STAGES>;

}  // namespace

extern "C" {

// The head product: h [Th, N, H] bf16 (16-byte aligned rows), wT [cols, H]
// bf16 (wT [U, 4S, H] as it is, cols = U*4S), bias [cols] f32 (zeros for
// none) -> out [N*Th, cols] f32 = [N, Th*U, 4S], head_moves_plain's tensor.
// `ctas` CTAs walk the tiles (ops/decode_fused_cuda.py:product_plan: two an
// SM). H a multiple of HP_BK, cols of HP_BN.
int head_product_wide(const void* h, const void* wT, const void* bias,
                      void* out, int Th, int N, int H, int cols, int ctas,
                      int act_tanh, float scale, int clamp, float cmin,
                      float cmax, void* stream) {
    if (Th < 1 || N < 1 || H < HP_BK || H % HP_BK != 0 || cols < HP_BN
        || cols % HP_BN != 0 || ctas < 1 || Tile::SMEM > SMEM_LIMIT
        || (reinterpret_cast<uintptr_t>(h) & 15) != 0
        || (reinterpret_cast<uintptr_t>(wT) & 15) != 0
        || (reinterpret_cast<uintptr_t>(bias) & 15) != 0
        || (reinterpret_cast<uintptr_t>(out) & 15) != 0)
        return (int)cudaErrorInvalidValue;
    auto kernel = head_product_kernel<HP_BM, HP_BN, HP_BK, HP_STAGES>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::SMEM);
    if (e != cudaSuccess) return (int)e;
    const HeadAct act = {act_tanh, scale, clamp, cmin, cmax};
    kernel<<<ctas, Tile::THREADS, Tile::SMEM,
             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(h), static_cast<const bf16*>(wT),
        static_cast<const float*>(bias), static_cast<float*>(out), Th, N, H,
        cols, act);
    return (int)cudaGetLastError();
}

}  // extern "C"
