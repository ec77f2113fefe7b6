// Kernels K, H, O and L: sliding-window (banded) self-attention of the
// transformer family. Query i sees key j iff -left <= j - i <= right and
// j < t_real.
//
// K, fused_rotary_window_attention, replaces
// bonito_tpu/ops/attention_pallas.py:fused_rotary_window_attention
// (`_fused_kernel_dt`, `_rot_dt`): from qkv [N, T, 3, H, D] in its natural
// memory (the wqkv matmul's output) and cos/sin [T, r/2] f32 it writes
// [N, T, H, D], ready for the out projection. It rounds where the TPU kernel
// rounds, for bf16 and for f32 input alike:
//
//     q, k  = bf16(rotary(f32(q)), rotary(f32(k)))   non-interleaved: element
//             d < r/2 pairs with d + r/2; the tail beyond r passes through
//     s     = (q . k) / sqrt(D)       bf16 products, f32 accumulation
//     s     = -1e30 where masked      (not -inf: no NaN in a masked row)
//     p     = bf16(exp(s - max) / sum)                f32 softmax, then bf16
//     o     = p . bf16(v)             f32 accumulation, cast to the output
//
// A row that sees no key at all (a query at or beyond t_real + left) gives 0.
//
// L, local_attention, replaces attention_pallas.py:local_attention_pallas
// (`_kernel`): q, k, v [N, H, T, D] (rotary already applied, any strides
// with a contiguous D) -> [N, H, T, D]: s = q . k / sqrt(D) in f32 from the
// inputs' values (bf16 input is widened exactly), p = exp(s - max) in f32,
// out = (p . v) / sum with f32 p and f32 sums.
//
// What bounds them on an H100: at sup shapes (N 128, T 1000, H 8, D 64,
// window (127, 128), bf16) K reads 393 MB and writes 131 MB, 0.16 ms at 3.35
// TB/s, against 67 GFLOP inside the band, 0.07 ms on the tensor cores:
// bytes. L in bf16 the same (at the shallow transformer's call, N 32, 8
// heads of 40: 82 MB, 0.025 ms); L in f32 does the work in f32 FMAs (67
// TFLOP/s): operations.
//
// Design of K. On the card, K and H (bf16 and f32) run the stretch kernel
// of csrc/attention_window.cu wherever ops/attention_cuda.py:window_plan
// gives a plan: one CTA walks consecutive 64-query tiles of one (n, h) with
// a ring of rotated key blocks in shared memory, each key row staged once
// per stretch, producer warps copying and rotating the next tile's rows
// while consumer warps compute (that file says how). The kernel below is
// the earlier design, kept for shapes the plan does not take and as the
// yardstick of the stretch kernel; both compute the same function, rounded
// at the same points.
// One block of 4 warps per (row n, head h, tile of 64 queries):
// 16,384 blocks at sup shapes. The band of 64 queries spans at most
// 127 + 64 + 128 = 319 keys, so the block stages its whole key window once --
// q and k rotated in f32 as they are loaded, rounded to bf16, v as it is (by
// cp.async) -- into shared memory (101 KB at D = 64: two blocks an SM) and
// no score or probability ever leaves the SM. With 8 warps an SM the
// staging is bound by latency, so its loops keep several chunks' loads in
// flight (the first version took one chunk at a time, with half of each
// warp idle in the rotary: 2.4 ms at sup shapes; PERF.md has both times).
// A warp owns 16 query rows and uses mma.sync m16n8k16 (bf16 in, f32 out),
// whose accumulator layout is known: a thread holds two rows' entries, so
// the softmax needs no shared memory.
// The TPU kernel normalises p before the second product, so the softmax is
// not the online one: pass 1 walks the warp's key tiles for each row's max
// and sum, pass 2 recomputes the scores (the tensor cores have time to spare:
// bytes bound the kernel), rounds exp(s - max) / sum to bf16 in the A-operand
// layout that the accumulators already have, and multiplies with v, read
// through ldmatrix.trans. A ragged T needs no padding: loads and the key mask
// are predicated on t_real and T. It is not the TPU kernel carried over: that
// one runs one program per batch row with the query blocks unrolled and a
// [N, 3, H, D, T] layout, which answer the TPU's pipeline overhead and lanes.
//
// Design of L. The dtype picks one of two instances; both keep an online
// softmax in f32 and normalise at the end, as the TPU kernel does.
//   bf16: one block of 4 warps per (n, h, tile of 64 queries), a warp per
//   16 query rows. Key and value tiles of 64 go through shared memory by
//   cp.async, double-buffered, the head dim zero-padded to a multiple of 16
//   (heads of 40 become 48); only the tiles of the block's key window are
//   staged, and a warp skips the sub-tiles of 16 keys its rows do not see.
//   S = Q K^T runs on mma.sync m16n8k16 (bf16 operands, which are the
//   inputs' exact values; f32 sums). The band mask, the running max, sum
//   and rescale stay in f32 registers. P V runs on the tensor cores too,
//   with f32 p split into three bf16 terms p = hi + mid + lo (all 24 of its
//   bits) and three products per 16 keys, summed from zero and added to o
//   on the f32 cores. A bf16 p moves p by up to 2^-9; two terms (2^-17),
//   with the products accumulated in the tensor cores, which truncate,
//   flipped the outputs' bf16 roundings against the plain version often
//   enough to triple the shallow transformer's drift from its plain path
//   (on an H100; PERF.md). Loads take 16-byte copies where q, k, v and out
//   lie at 16-byte addresses with strides of multiples of 8 elements,
//   element loads otherwise (a branch inside the kernel).
//   f32: one block of 8 warps per (n, h, tile of 64 queries), key tiles of
//   32 through shared memory in f32, a lane per key for the scores and a
//   lane per head-dim element for the output. FMA only: TF32 tensor-core
//   products would round its operands.
//
// H and O, the training twin: they replace attention_pallas.py:
// fused_rotary_window_attention_train (`_fused_fwd_kernel_dt`,
// `_fused_bwd_kernel_dt`). H is K's code with one more output, each query's
// lse = max + log(sum) in f32, under a template flag, on either kernel of K
// (the stretch kernel where window_plan gives a plan, bf16 or f32): its o
// is the same kernel's K's bit for bit. O computes dqkv [N, T, 3, H, D]
// from qkv, cos/sin, lse, o and the cotangent do, rounding where the TPU
// kernel rounds:
//
//     p     = exp(s - lse), 0 where masked         s as in K, in f32
//     dp    = bf16(do) . bf16(v)                   f32 accumulation
//     Di    = sum_d do o                           f32, o as stored
//     ds    = bf16(p (dp - Di) / sqrt(D))
//     dq    = rotary^-1(bf16(k) . ds)              f32, rotated by -theta
//     dk    = rotary^-1(sum over queries of ds^T . bf16(q))
//     dv    = bf16(p)^T . bf16(do)                 f32 accumulation
//
// What bounds them at sup training shapes (N 32, T 1024, 8 heads of 64,
// bf16): H moves 135 MB (0.04 ms) against 17 GFLOP in the band (0.02 ms);
// O moves 270 MB (0.08 ms) against five band products, 43 GFLOP (0.04 ms):
// bytes, both.
//
// Design of O. On the card, bf16 O runs the stretch kernel of
// csrc/attention_window_bwd.cu wherever ops/attention_cuda.py:
// window_bwd_plan gives a plan: the same split as below, with each CTA
// walking a stretch of tiles and staging each row of its window once into
// a ring (that file says how). The kernel below is the earlier design, kept
// for f32 input and as the stretch kernel's yardstick.
// The TPU kernel runs one program per row and carries dk and dv
// in scratch across its query blocks, in order; CUDA blocks run in no order,
// so O splits the work by what each block writes, with no atomics and a
// fixed order of every sum: one launch, two kinds of block of 4 warps per
// (n, h, tile of 64 tokens). A dq block stages its 64 queries (q rotated, do)
// and their key window (k rotated, v; at most 319 keys); a dk block stages
// its 64 keys (k rotated, v) and the queries that see them (q rotated, do;
// at most 64 + 127 + 128 = 319), with their lse and Di. Both recompute s and
// dp for their pairs (bytes, not the tensor cores, bound the kernel), and Di
// is computed in each block by the same code, so both kinds see the same
// bits of it. A warp owns 16 rows of the tile and uses mma.sync m16n8k16 as
// K does: ds leaves the score products in the A-operand layout of the next
// product, whose B operand (k, q or do) comes through ldmatrix.trans. The
// rotation back by -theta runs on the accumulators: element d < r/2 and its
// partner d + r/2 sit in the same thread. About 113 KB of shared memory at
// D = 64: two blocks an SM.
//
// Later work: the stretch kernels' products (K's, H's and O's) on wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float NEG = -1e30f;
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may ask for

__host__ __device__ inline int round_up(int v, int m) {
    return (v + m - 1) / m * m;
}

// ---------------------------------------------------------------------------
// element access
// ---------------------------------------------------------------------------

__device__ inline void load8(const bf16* p, float (&v)[8]) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x;
        v[2 * i + 1] = f.y;
    }
}

__device__ inline void load8(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// 8 floats, rounded to bf16, to a 16-byte aligned shared-memory address
__device__ inline void store8(bf16* s, const float (&v)[8]) {
    uint4 raw;
    raw.x = pack_bf16(v[0], v[1]);
    raw.y = pack_bf16(v[2], v[3]);
    raw.z = pack_bf16(v[4], v[5]);
    raw.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(s) = raw;
}

__device__ inline void store_pair(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ inline void store_pair(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// ---------------------------------------------------------------------------
// kernel K
// ---------------------------------------------------------------------------

constexpr int BQ = 64;           // query rows per block
constexpr int KNW = BQ / 16;     // warps: 16 query rows each
constexpr int KNT = KNW * 32;
constexpr int PADB = 8;          // bf16 values of padding per shared row

// Staging, device memory -> the rows of a shared tile, in chunks of 8
// head-dim elements (16 bytes of bf16). Three kinds of chunk:
//   rotary   the chunk at d0 < r2 with its partner at d0 + r2: rotated in
//            f32, every product and sum rounded on its own (no fused
//            multiply-add) as the plain version's are, both written;
//   plain    v, and the tail of q and k beyond the rotary dim: copied (bf16
//            input goes by cp.async, without a trip through registers);
//   zero     a dead token (beyond T or the key window) and the padding
//            beyond D.
// The loops over chunks are unrolled so that a thread has several chunks'
// loads in flight: what the staging costs is latency, not bytes.
__device__ inline void zero_chunk(bf16* s) {
    *reinterpret_cast<uint4*>(s) = make_uint4(0u, 0u, 0u, 0u);
}

__device__ inline void plain_chunk(const bf16* g, bf16* s) {
    __pipeline_memcpy_async(s, g, 16);
}

__device__ inline void plain_chunk(const float* g, bf16* s) {
    float a[8];
    load8(g, a);
    store8(s, a);
}

template <typename T>
__device__ inline void rotary_chunk(const T* g, const float* cs,
                                    const float* sn, bf16* s, int r2)
{
    float a[8], b[8], c[8], sv[8], o1[8], o2[8];
    load8(g, a);
    load8(g + r2, b);
    load8(cs, c);
    load8(sn, sv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        o1[i] = __fsub_rn(__fmul_rn(a[i], c[i]), __fmul_rn(b[i], sv[i]));
        o2[i] = __fadd_rn(__fmul_rn(b[i], c[i]), __fmul_rn(a[i], sv[i]));
    }
    store8(s, o1);
    store8(s + r2, o2);
}

__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 tiles, transposed: lanes 8i .. 8i+7 give the row addresses
// of tile i; register i holds, of tile i, rows 2c and 2c + 1 of column g
// (g = lane / 4, c = lane % 4) -- the B operand of m16n8k16.
__device__ inline void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// DP: the head dim padded to 32, 64 or 128 (zeros beyond D).
// LSE: also write each query's log-sum-exp (kernel H); K's instance is the
// same code without that store, so both give the same o bit for bit.
template <typename T, int DP, bool LSE>
__global__ void __launch_bounds__(KNT)
fused_rotary_window_attention_kernel(
    const T* __restrict__ qkv, const float* __restrict__ cosp,
    const float* __restrict__ sinp, T* __restrict__ out,
    float* __restrict__ lse, int Tn, int H, int D, int r2, int left,
    int right, int t_real, int kw_max, int n_qt, float scale)
{
    constexpr int LD = DP + PADB;
    constexpr int CH = DP / 8;
    constexpr int KT = DP / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD]
    bf16* Ks = Qs + BQ * LD;                        // [kw_max][LD]
    bf16* Vs = Ks + (size_t)kw_max * LD;            // [kw_max][LD]

    const int tid = threadIdx.x;
    const int qt = blockIdx.x % n_qt;
    const int h = (blockIdx.x / n_qt) % H;
    const int n = blockIdx.x / (n_qt * H);
    const int q0 = qt * BQ;
    const int q_end = min(q0 + BQ, Tn);
    const int k_beg = max(0, q0 - left);
    const int k_end = min(t_real, q_end + right);   // exclusive
    const int kw = max(k_end - k_beg, 0);
    const int kwp = round_up(kw, 16);               // <= kw_max

    const size_t tok_stride = (size_t)3 * H * D;
    const T* base = qkv + (size_t)n * Tn * tok_stride + (size_t)h * D;

    // rows 0 .. BQ-1 of the staging are the queries, the rest the key window
    const int rows = BQ + kwp;
    auto token = [&](int row, bool& live) {
        const int tok = row < BQ ? q0 + row : k_beg + row - BQ;
        live = row < BQ ? tok < Tn : row - BQ < kw;
        return (size_t)(live ? tok : 0);
    };
    // v: plain chunks up to D
#pragma unroll 4
    for (int e = tid; e < kwp * CH; e += KNT) {
        const int j = e / CH, d0 = (e % CH) * 8;
        bf16* s = Vs + (size_t)j * LD + d0;
        if (j < kw && d0 < D)
            plain_chunk(base + (size_t)(k_beg + j) * tok_stride
                        + (size_t)2 * H * D + d0, s);
        else
            zero_chunk(s);
    }
    // q and k: rotary pairs
    const int rch = r2 / 8;
#pragma unroll 4
    for (int e = tid; e < rows * rch; e += KNT) {
        const int row = e / rch, d0 = (e % rch) * 8;
        bool live;
        const size_t t_ = token(row, live);
        bf16* s = (row < BQ ? Qs + row * LD : Ks + (size_t)(row - BQ) * LD) + d0;
        if (live) {
            rotary_chunk(base + t_ * tok_stride
                         + (row < BQ ? 0 : (size_t)H * D) + d0,
                         cosp + t_ * r2 + d0, sinp + t_ * r2 + d0, s, r2);
        } else {
            zero_chunk(s);
            zero_chunk(s + r2);
        }
    }
    // q and k: the tail beyond the rotary dim, and the padding beyond D
    const int tch = CH - 2 * rch;
    for (int e = tid; e < rows * tch; e += KNT) {
        const int row = e / tch, d0 = (2 * rch + e % tch) * 8;
        bool live;
        const size_t t_ = token(row, live);
        bf16* s = (row < BQ ? Qs + row * LD : Ks + (size_t)(row - BQ) * LD) + d0;
        if (live && d0 < D)
            plain_chunk(base + t_ * tok_stride
                        + (row < BQ ? 0 : (size_t)H * D) + d0, s);
        else
            zero_chunk(s);
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c4 = lane & 3;
    const int r0 = w * 16;
    if (q0 + r0 >= Tn) return;                      // no live row in the warp
    const int ia = q0 + r0 + g, ib = ia + 8;

    uint32_t qf[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
        const bf16* p = Qs + (r0 + g) * LD + kt * 16 + 2 * c4;
        qf[kt][0] = *reinterpret_cast<const uint32_t*>(p);
        qf[kt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
        qf[kt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        qf[kt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
    }

    // the warp's own stretch of the window, in tiles of 16 keys
    const int row_last = min(q0 + r0 + 15, Tn - 1);
    const int j_lo = max(k_beg, q0 + r0 - left) - k_beg;
    const int j_hi = min(k_end, row_last + right + 1) - k_beg;
    const int t_lo = j_lo / 16;
    const int t_hi = j_hi > j_lo ? (j_hi + 15) / 16 : t_lo;

    // scores of one tile of 16 keys: s[nt] holds, of keys 8 nt + 2 c4 and
    // + 1, rows ia (entries 0, 1) and ib (2, 3); vis the same, as bits
    auto scores = [&](int t, float (&s)[2][4], unsigned& vis) {
        vis = 0;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float acc[4] = {0.f, 0.f, 0.f, 0.f};
            const bf16* kp = Ks + (size_t)(t * 16 + nt * 8 + g) * LD + 2 * c4;
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                const uint32_t b0 =
                    *reinterpret_cast<const uint32_t*>(kp + kt * 16);
                const uint32_t b1 =
                    *reinterpret_cast<const uint32_t*>(kp + kt * 16 + 8);
                mma_bf16(acc, qf[kt], b0, b1);
            }
            const int j0 = k_beg + t * 16 + nt * 8 + 2 * c4;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int j = j0 + (e & 1);
                const int i = e < 2 ? ia : ib;
                const bool ok = j - i >= -left && j - i <= right && j < k_end;
                s[nt][e] = ok ? acc[e] * scale : NEG;
                vis |= (unsigned)ok << (nt * 4 + e);
            }
        }
    };

    // pass 1: each row's max and sum, first over the thread's own columns
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
#pragma unroll 2
    for (int t = t_lo; t < t_hi; ++t) {
        float s[2][4];
        unsigned vis;
        scores(t, s, vis);
        const float ta = fmaxf(fmaxf(s[0][0], s[0][1]), fmaxf(s[1][0], s[1][1]));
        const float tb = fmaxf(fmaxf(s[0][2], s[0][3]), fmaxf(s[1][2], s[1][3]));
        const float na = fmaxf(m_a, ta), nb = fmaxf(m_b, tb);
        float sa = 0.f, sb = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            if (vis >> (nt * 4 + 0) & 1) sa += __expf(s[nt][0] - na);
            if (vis >> (nt * 4 + 1) & 1) sa += __expf(s[nt][1] - na);
            if (vis >> (nt * 4 + 2) & 1) sb += __expf(s[nt][2] - nb);
            if (vis >> (nt * 4 + 3) & 1) sb += __expf(s[nt][3] - nb);
        }
        l_a = l_a * __expf(m_a - na) + sa;
        l_b = l_b * __expf(m_b - nb) + sb;
        m_a = na;
        m_b = nb;
    }
    // ... then over the four threads that share a row
    float M_a = m_a, M_b = m_b;
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
        M_a = fmaxf(M_a, __shfl_xor_sync(0xffffffffu, M_a, d));
        M_b = fmaxf(M_b, __shfl_xor_sync(0xffffffffu, M_b, d));
    }
    l_a *= __expf(m_a - M_a);
    l_b *= __expf(m_b - M_b);
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
    }
    const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
    const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
    if (LSE && c4 == 0) {
        // lse = max + log(sum); a row that sees no key gets -1e30, which
        // leaves every p of the backward at 0 as the TPU kernel's m does
        float* lrow = lse + ((size_t)n * H + h) * Tn;
        if (ia < Tn) lrow[ia] = l_a > 0.f ? M_a + logf(l_a) : NEG;
        if (ib < Tn) lrow[ib] = l_b > 0.f ? M_b + logf(l_b) : NEG;
    }

    // pass 2: p = bf16(exp(s - max) / sum), o += p . v
    float o[2 * KT][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

#pragma unroll 2
    for (int t = t_lo; t < t_hi; ++t) {
        float s[2][4];
        unsigned vis;
        scores(t, s, vis);
        float p[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float mx = e < 2 ? M_a : M_b;
                const float iv = e < 2 ? inv_a : inv_b;
                p[nt][e] = (vis >> (nt * 4 + e) & 1)
                    ? __expf(s[nt][e] - mx) * iv : 0.f;
            }
        uint32_t pa[4];
        pa[0] = pack_bf16(p[0][0], p[0][1]);   // row ia, keys 2c, 2c + 1
        pa[1] = pack_bf16(p[0][2], p[0][3]);   // row ib
        pa[2] = pack_bf16(p[1][0], p[1][1]);   // row ia, keys 8 + 2c, ...
        pa[3] = pack_bf16(p[1][2], p[1][3]);   // row ib
        const bf16* vp = Vs
            + (size_t)(t * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD
            + (lane >> 4) * 8;
#pragma unroll
        for (int dk = 0; dk < KT; ++dk) {
            uint32_t vb[4];
            ldmatrix_x4_trans(vb, vp + dk * 16);
            mma_bf16(o[2 * dk], pa, vb[0], vb[1]);
            mma_bf16(o[2 * dk + 1], pa, vb[2], vb[3]);
        }
    }

    T* orow_a = out + (((size_t)n * Tn + ia) * H + h) * D;
    T* orow_b = out + (((size_t)n * Tn + ib) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt) {
        const int d = dt * 8 + 2 * c4;
        if (d < D) {
            if (ia < Tn) store_pair(orow_a + d, o[dt][0], o[dt][1]);
            if (ib < Tn) store_pair(orow_b + d, o[dt][2], o[dt][3]);
        }
    }
}

template <typename T, int DP, bool LSE>
int launch_fused(const void* qkv, const void* cosp, const void* sinp,
                 void* out, float* lse, int N, int Tn, int H, int D, int r2,
                 int left, int right, int t_real, cudaStream_t stream)
{
    const int kw_max = round_up(min(left + BQ + right, t_real), 16);
    const int n_qt = (Tn + BQ - 1) / BQ;
    const size_t smem = (size_t)(BQ + 2 * kw_max) * (DP + PADB) * sizeof(bf16);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)N * H * n_qt;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const auto kernel = fused_rotary_window_attention_kernel<T, DP, LSE>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)D));
    kernel<<<(unsigned)blocks, KNT, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(cosp),
        static_cast<const float*>(sinp), static_cast<T*>(out), lse, Tn, H, D,
        r2, left, right, t_real, kw_max, n_qt, scale);
    return (int)cudaGetLastError();
}

template <typename T, bool LSE>
int dispatch_fused(int D, const void* qkv, const void* cosp, const void* sinp,
                   void* out, float* lse, int N, int Tn, int H, int r2,
                   int left, int right, int t_real, cudaStream_t stream)
{
    if (D <= 32)
        return launch_fused<T, 32, LSE>(qkv, cosp, sinp, out, lse, N, Tn, H,
                                        D, r2, left, right, t_real, stream);
    if (D <= 64)
        return launch_fused<T, 64, LSE>(qkv, cosp, sinp, out, lse, N, Tn, H,
                                        D, r2, left, right, t_real, stream);
    return launch_fused<T, 128, LSE>(qkv, cosp, sinp, out, lse, N, Tn, H, D,
                                     r2, left, right, t_real, stream);
}

// ---------------------------------------------------------------------------
// kernel O: the backward of H
// ---------------------------------------------------------------------------

// Stage `rows` rows of tokens tok0, tok0 + 1, ... (live while row < live)
// into two shared tiles: Rs from a source that is rotated (q or k, whose
// tokens lie `rs` elements apart), Ps from one that is copied (v or do, `ps`
// apart). Dead rows and the padding beyond D are zeros.
template <typename T, int DP>
__device__ inline void stage_rows(const T* rsrc, size_t rs, const T* psrc,
                                  size_t ps, const float* cosp,
                                  const float* sinp, int tok0, int rows,
                                  int live, bf16* Rs, bf16* Ps, int D, int r2,
                                  int tid)
{
    constexpr int LD = DP + PADB;
    constexpr int CH = DP / 8;
#pragma unroll 4
    for (int e = tid; e < rows * CH; e += KNT) {
        const int j = e / CH, d0 = (e % CH) * 8;
        bf16* s = Ps + (size_t)j * LD + d0;
        if (j < live && d0 < D)
            plain_chunk(psrc + (size_t)(tok0 + j) * ps + d0, s);
        else
            zero_chunk(s);
    }
    const int rch = r2 / 8;
#pragma unroll 4
    for (int e = tid; e < rows * rch; e += KNT) {
        const int j = e / rch, d0 = (e % rch) * 8;
        bf16* s = Rs + (size_t)j * LD + d0;
        if (j < live) {
            const size_t t_ = (size_t)(tok0 + j);
            rotary_chunk(rsrc + t_ * rs + d0, cosp + t_ * r2 + d0,
                         sinp + t_ * r2 + d0, s, r2);
        } else {
            zero_chunk(s);
            zero_chunk(s + r2);
        }
    }
    const int tch = CH - 2 * rch;
    for (int e = tid; e < rows * tch; e += KNT) {
        const int j = e / tch, d0 = (2 * rch + e % tch) * 8;
        bf16* s = Rs + (size_t)j * LD + d0;
        if (j < live && d0 < D)
            plain_chunk(rsrc + (size_t)(tok0 + j) * rs + d0, s);
        else
            zero_chunk(s);
    }
}

// One block of 4 warps per (n, h, tile of 64 tokens, kind). Kind 0 (dq):
// the tile's tokens are queries, the window their keys. Kind 1 (dk, dv):
// the tile's tokens are keys, the window the queries that see them. In both
// a warp owns 16 rows of the tile and walks its stretch of the window in
// tiles of 16 columns:
//   s  = A1 . W1^T   (dq: q . k; dk: k . q)     bf16 products, f32 sums
//   dp = A2 . W2^T   (dq: do . v; dk: v . do)
//   p  = exp(s / sqrt(D) - lse[query]), 0 where masked
//   ds = bf16(p (dp - Di[query]) / sqrt(D))
//   acc1 += ds . W1                    (dq += ds . k; dk += ds^T . q)
//   acc2 += bf16(p) . W2               (dk kind only: dv += p^T . do)
// then acc1 is rotated back by -theta at its own tokens and both are stored.
template <typename T, int DP>
__global__ void __launch_bounds__(KNT)
fused_attention_bwd_kernel(
    const T* __restrict__ qkv, const float* __restrict__ cosp,
    const float* __restrict__ sinp, const float* __restrict__ lse,
    const T* __restrict__ o, const T* __restrict__ dout,
    T* __restrict__ dqkv, int Tn, int H, int D, int r2, int left, int right,
    int t_real, int rows_max, int n_tiles, float scale)
{
    constexpr int LD = DP + PADB;
    constexpr int KT = DP / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* A1s = reinterpret_cast<bf16*>(smem_raw);   // [BQ][LD] q or k
    bf16* A2s = A1s + BQ * LD;                       // [BQ][LD] do or v
    bf16* W1s = A2s + BQ * LD;                       // [rows_max][LD] k or q
    bf16* W2s = W1s + (size_t)rows_max * LD;         // [rows_max][LD] v or do
    float* LSEs = reinterpret_cast<float*>(W2s + (size_t)rows_max * LD);
    float* DIs = LSEs + max(BQ, rows_max);           // the query rows' Di

    const int tid = threadIdx.x;
    const int tile = blockIdx.x % n_tiles;
    const bool dk_kind = (blockIdx.x / n_tiles) & 1;
    const int h = (blockIdx.x / (2 * n_tiles)) % H;
    const int n = blockIdx.x / (2 * n_tiles * H);
    const int t0 = tile * BQ;
    const int t_end = min(t0 + BQ, Tn);             // exclusive
    int w_beg, w_end;                               // the window, exclusive
    if (!dk_kind) {
        w_beg = max(0, t0 - left);
        w_end = min(t_real, t_end + right);
    } else {
        const int kl_end = min(t_end, t_real);      // keys that anyone sees
        w_beg = max(0, t0 - right);
        w_end = kl_end > t0 ? min(Tn, kl_end + left) : w_beg;
    }
    const int wn = max(w_end - w_beg, 0);
    const int wnp = round_up(wn, 16);               // <= rows_max

    const size_t tok = (size_t)3 * H * D;           // qkv's token stride
    const size_t otok = (size_t)H * D;              // o's and do's
    const T* qb = qkv + (size_t)n * Tn * tok + (size_t)h * D;
    const T* kb = qb + (size_t)H * D;
    const T* vb = qb + (size_t)2 * H * D;
    const T* ob = o + (size_t)n * Tn * otok + (size_t)h * D;
    const T* dob = dout + (size_t)n * Tn * otok + (size_t)h * D;
    const float* lb = lse + ((size_t)n * H + h) * Tn;

    stage_rows<T, DP>(dk_kind ? kb : qb, tok, dk_kind ? vb : dob,
                      dk_kind ? tok : otok, cosp, sinp, t0, BQ, t_end - t0,
                      A1s, A2s, D, r2, tid);
    stage_rows<T, DP>(dk_kind ? qb : kb, tok, dk_kind ? dob : vb,
                      dk_kind ? otok : tok, cosp, sinp, w_beg, wnp, wn, W1s,
                      W2s, D, r2, tid);
    // the query rows' lse and Di = sum_d do o in f32, in one fixed order: 8
    // lanes a row, lane l8 over the chunks l8, l8 + 8, ... of 8 elements,
    // then a tree over the 8 lanes (both kinds of block run this same code,
    // so a query's Di has the same bits in each)
    {
        const int qn = dk_kind ? wnp : BQ;          // a multiple of 16
        const int l8 = tid & 7;
        for (int row = tid >> 3; row < qn; row += KNT / 8) {
            const int tq = dk_kind ? w_beg + row : t0 + row;
            const bool live = dk_kind ? row < wn : tq < Tn;
            float acc = 0.f;
            if (live) {
                const T* dr = dob + (size_t)tq * otok;
                const T* orow = ob + (size_t)tq * otok;
                for (int d0 = l8 * 8; d0 < D; d0 += 64) {
                    float x[8], y[8];
                    load8(dr + d0, x);
                    load8(orow + d0, y);
#pragma unroll
                    for (int i = 0; i < 8; ++i) acc = fmaf(x[i], y[i], acc);
                }
            }
#pragma unroll
            for (int d = 1; d <= 4; d <<= 1)
                acc += __shfl_xor_sync(0xffffffffu, acc, d);
            if (l8 == 0) {
                DIs[row] = acc;
                LSEs[row] = live ? lb[tq] : 0.f;
            }
        }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();

    const int w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c4 = lane & 3;
    const int r0 = w * 16;
    if (t0 + r0 >= Tn) return;                      // no live row in the warp
    const int ia = t0 + r0 + g, ib = ia + 8;        // the thread's two rows

    uint32_t a1[KT][4], a2[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) {
        const bf16* p1 = A1s + (r0 + g) * LD + kt * 16 + 2 * c4;
        const bf16* p2 = A2s + (r0 + g) * LD + kt * 16 + 2 * c4;
        a1[kt][0] = *reinterpret_cast<const uint32_t*>(p1);
        a1[kt][1] = *reinterpret_cast<const uint32_t*>(p1 + 8 * LD);
        a1[kt][2] = *reinterpret_cast<const uint32_t*>(p1 + 8);
        a1[kt][3] = *reinterpret_cast<const uint32_t*>(p1 + 8 * LD + 8);
        a2[kt][0] = *reinterpret_cast<const uint32_t*>(p2);
        a2[kt][1] = *reinterpret_cast<const uint32_t*>(p2 + 8 * LD);
        a2[kt][2] = *reinterpret_cast<const uint32_t*>(p2 + 8);
        a2[kt][3] = *reinterpret_cast<const uint32_t*>(p2 + 8 * LD + 8);
    }

    // the warp's stretch of the window, in tiles of 16 columns
    const int row_last = min(t0 + r0 + 15, Tn - 1);
    int lo, hi;                                     // tokens, inclusive
    if (!dk_kind) {
        lo = t0 + r0 - left;
        hi = row_last + right;
    } else {
        lo = t0 + r0 - right;
        hi = t0 + r0 < t_real ? min(row_last, t_real - 1) + left : lo - 1;
    }
    const int j_lo = max(w_beg, lo) - w_beg;
    const int j_hi = min(w_end, hi + 1) - w_beg;
    const int c_lo = j_lo / 16;
    const int c_hi = j_hi > j_lo ? (j_hi + 15) / 16 : c_lo;

    // the dq kind's rows are queries: their lse and Di once
    const float lse_a = dk_kind ? 0.f : LSEs[r0 + g];
    const float lse_b = dk_kind ? 0.f : LSEs[r0 + g + 8];
    const float di_a = dk_kind ? 0.f : DIs[r0 + g];
    const float di_b = dk_kind ? 0.f : DIs[r0 + g + 8];

    float acc1[2 * KT][4], acc2[2 * KT][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[dt][e] = acc2[dt][e] = 0.f;

    const int lrow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix rows
    const int lcol = (lane >> 4) * 8;
#pragma unroll 1
    for (int c = c_lo; c < c_hi; ++c) {
        float ds[2][4], pp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            float s[4] = {0.f, 0.f, 0.f, 0.f};
            float dp[4] = {0.f, 0.f, 0.f, 0.f};
            const int cw = c * 16 + nt * 8;         // the n-tile's window row
            const bf16* w1 = W1s + (size_t)(cw + g) * LD + 2 * c4;
            const bf16* w2 = W2s + (size_t)(cw + g) * LD + 2 * c4;
#pragma unroll
            for (int kt = 0; kt < KT; ++kt) {
                mma_bf16(s, a1[kt],
                         *reinterpret_cast<const uint32_t*>(w1 + kt * 16),
                         *reinterpret_cast<const uint32_t*>(w1 + kt * 16 + 8));
                mma_bf16(dp, a2[kt],
                         *reinterpret_cast<const uint32_t*>(w2 + kt * 16),
                         *reinterpret_cast<const uint32_t*>(w2 + kt * 16 + 8));
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int wc = cw + 2 * c4 + (e & 1);  // window row of entry e
                const int col = w_beg + wc;
                const int row = e < 2 ? ia : ib;
                const int i = dk_kind ? col : row;     // the query
                const int j = dk_kind ? row : col;     // the key
                const bool ok = j - i >= -left && j - i <= right
                    && j < t_real && col < w_end && row < Tn;
                const float L = dk_kind ? LSEs[wc] : (e < 2 ? lse_a : lse_b);
                const float Di = dk_kind ? DIs[wc] : (e < 2 ? di_a : di_b);
                const float p = ok ? __expf(s[e] * scale - L) : 0.f;
                pp[nt][e] = p;
                ds[nt][e] = __fmul_rn(__fmul_rn(p, __fsub_rn(dp[e], Di)),
                                      scale);
            }
        }
        uint32_t da[4];
        da[0] = pack_bf16(ds[0][0], ds[0][1]);
        da[1] = pack_bf16(ds[0][2], ds[0][3]);
        da[2] = pack_bf16(ds[1][0], ds[1][1]);
        da[3] = pack_bf16(ds[1][2], ds[1][3]);
        const bf16* w1p = W1s + (size_t)(c * 16 + lrow) * LD + lcol;
#pragma unroll
        for (int dk = 0; dk < KT; ++dk) {
            uint32_t wb[4];
            ldmatrix_x4_trans(wb, w1p + dk * 16);
            mma_bf16(acc1[2 * dk], da, wb[0], wb[1]);
            mma_bf16(acc1[2 * dk + 1], da, wb[2], wb[3]);
        }
        if (dk_kind) {
            uint32_t pa[4];
            pa[0] = pack_bf16(pp[0][0], pp[0][1]);
            pa[1] = pack_bf16(pp[0][2], pp[0][3]);
            pa[2] = pack_bf16(pp[1][0], pp[1][1]);
            pa[3] = pack_bf16(pp[1][2], pp[1][3]);
            const bf16* w2p = W2s + (size_t)(c * 16 + lrow) * LD + lcol;
#pragma unroll
            for (int dk = 0; dk < KT; ++dk) {
                uint32_t wb[4];
                ldmatrix_x4_trans(wb, w2p + dk * 16);
                mma_bf16(acc2[2 * dk], pa, wb[0], wb[1]);
                mma_bf16(acc2[2 * dk + 1], pa, wb[2], wb[3]);
            }
        }
    }

    // rotate acc1 back by -theta at the rows' own tokens, in f32 with every
    // product and sum rounded on its own: element d < r2 pairs with d + r2,
    // which the same thread holds r2 / 8 column tiles further on (the loops
    // unroll, so the pair is picked without indexing registers at run time)
    const int r8 = r2 / 8;
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt) {
        if (dt >= r8) continue;
#pragma unroll
        for (int pt = 0; pt < 2 * KT; ++pt) {
            if (pt != dt + r8) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int tk = half ? ib : ia;
                if (tk >= Tn) continue;
                const size_t at = (size_t)tk * r2 + dt * 8 + 2 * c4;
                const float2 cc = *reinterpret_cast<const float2*>(cosp + at);
                const float2 ss = *reinterpret_cast<const float2*>(sinp + at);
#pragma unroll
                for (int m = 0; m < 2; ++m) {
                    const int e = 2 * half + m;
                    const float cv = m ? cc.y : cc.x, sv = m ? ss.y : ss.x;
                    const float x1 = acc1[dt][e], x2 = acc1[pt][e];
                    acc1[dt][e] = __fadd_rn(__fmul_rn(x1, cv),
                                            __fmul_rn(x2, sv));
                    acc1[pt][e] = __fsub_rn(__fmul_rn(x2, cv),
                                            __fmul_rn(x1, sv));
                }
            }
        }
    }

    T* base = dqkv + (size_t)n * Tn * tok + (size_t)h * D;
    T* d1 = base + (dk_kind ? (size_t)H * D : 0);   // dq or dk
    T* d2 = base + (size_t)2 * H * D;               // dv
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt) {
        const int d = dt * 8 + 2 * c4;
        if (d >= D) continue;
        if (ia < Tn)
            store_pair(d1 + (size_t)ia * tok + d, acc1[dt][0], acc1[dt][1]);
        if (ib < Tn)
            store_pair(d1 + (size_t)ib * tok + d, acc1[dt][2], acc1[dt][3]);
        if (dk_kind) {
            if (ia < Tn)
                store_pair(d2 + (size_t)ia * tok + d, acc2[dt][0],
                           acc2[dt][1]);
            if (ib < Tn)
                store_pair(d2 + (size_t)ib * tok + d, acc2[dt][2],
                           acc2[dt][3]);
        }
    }
}

template <typename T, int DP>
int launch_bwd(const void* qkv, const void* cosp, const void* sinp,
               const float* lse, const void* o, const void* dout, void* dqkv,
               int N, int Tn, int H, int D, int r2, int left, int right,
               int t_real, cudaStream_t stream)
{
    const int rows_max = round_up(min(left + BQ + right, Tn), 16);
    const int n_tiles = (Tn + BQ - 1) / BQ;
    const size_t smem = (size_t)(2 * BQ + 2 * rows_max) * (DP + PADB)
        * sizeof(bf16) + (size_t)2 * max(BQ, rows_max) * sizeof(float);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)N * H * 2 * n_tiles;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const auto kernel = fused_attention_bwd_kernel<T, DP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)D));
    kernel<<<(unsigned)blocks, KNT, smem, stream>>>(
        static_cast<const T*>(qkv), static_cast<const float*>(cosp),
        static_cast<const float*>(sinp), lse, static_cast<const T*>(o),
        static_cast<const T*>(dout), static_cast<T*>(dqkv), Tn, H, D, r2,
        left, right, t_real, rows_max, n_tiles, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_bwd(int D, const void* qkv, const void* cosp, const void* sinp,
                 const float* lse, const void* o, const void* dout,
                 void* dqkv, int N, int Tn, int H, int r2, int left,
                 int right, int t_real, cudaStream_t stream)
{
    if (D <= 32)
        return launch_bwd<T, 32>(qkv, cosp, sinp, lse, o, dout, dqkv, N, Tn,
                                 H, D, r2, left, right, t_real, stream);
    if (D <= 64)
        return launch_bwd<T, 64>(qkv, cosp, sinp, lse, o, dout, dqkv, N, Tn,
                                 H, D, r2, left, right, t_real, stream);
    return launch_bwd<T, 128>(qkv, cosp, sinp, lse, o, dout, dqkv, N, Tn, H,
                              D, r2, left, right, t_real, stream);
}

// ---------------------------------------------------------------------------
// kernel L
// ---------------------------------------------------------------------------

constexpr int LQ = 64;           // query rows per block
constexpr int LK = 32;           // keys per tile: a lane each
constexpr int LR = 8;            // query rows per warp
constexpr int LNW = LQ / LR;
constexpr int LNT = LNW * 32;
constexpr int LDD = 4;           // head-dim elements per lane: D <= 128

struct Strides { long long n, h, t; };

__global__ void __launch_bounds__(LNT)
local_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, Strides sq, Strides sk,
                           Strides sv, Strides so, int H, int Tn, int D,
                           int left, int right, int n_qt, float scale)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int LDK = D + 1;
    float* Qs = reinterpret_cast<float*>(smem_raw);  // [LQ][LDK]
    float* Ks = Qs + LQ * LDK;                       // [LK][LDK]
    float* Vs = Ks + LK * LDK;                       // [LK][D]
    float* Ps = Vs + LK * D;                         // [LNW][LR][LK]

    const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31;
    const int qt = blockIdx.x % n_qt;
    const int h = (blockIdx.x / n_qt) % H;
    const int n = blockIdx.x / (n_qt * H);
    const int q0 = qt * LQ;
    const int q_end = min(q0 + LQ, Tn);
    const int k_beg = max(0, q0 - left);
    const int k_end = min(Tn, q_end + right);        // exclusive

    const float* qb = q + n * sq.n + h * sq.h;
    const float* kb = k + n * sk.n + h * sk.h;
    const float* vb = v + n * sv.n + h * sv.h;
    for (int e = tid; e < LQ * D; e += LNT) {
        const int i = e / D, d = e % D;
        const int tok = q0 + i;
        Qs[i * LDK + d] = tok < Tn ? qb[tok * sq.t + d] : 0.f;
    }

    // the warp's rows and the keys they see
    const int row0 = q0 + w * LR;
    const bool warp_live = row0 < Tn;
    const int w_lo = row0 - left;
    const int w_hi = min(row0 + LR - 1, Tn - 1) + right;  // inclusive
    float m[LR], l[LR], acc[LR][LDD];
#pragma unroll
    for (int r = 0; r < LR; ++r) {
        m[r] = NEG;
        l[r] = 0.f;
#pragma unroll
        for (int dd = 0; dd < LDD; ++dd) acc[r][dd] = 0.f;
    }
    float* Pw = Ps + w * LR * LK;

    for (int kt = k_beg; kt < k_end; kt += LK) {
        __syncthreads();                             // the last tile is read
        for (int e = tid; e < LK * D; e += LNT) {
            const int j = e / D, d = e % D;
            const int tok = kt + j;
            const bool live = tok < k_end;
            Ks[j * LDK + d] = live ? kb[tok * sk.t + d] : 0.f;
            Vs[j * D + d] = live ? vb[tok * sv.t + d] : 0.f;
        }
        __syncthreads();
        if (!warp_live || kt > w_hi || kt + LK <= w_lo) continue;

        float s[LR];
#pragma unroll
        for (int r = 0; r < LR; ++r) s[r] = 0.f;
        const float* krow = Ks + lane * LDK;
        const float* qrow = Qs + w * LR * LDK;
        for (int d = 0; d < D; ++d) {
            const float kv = krow[d];
#pragma unroll
            for (int r = 0; r < LR; ++r) s[r] += qrow[r * LDK + d] * kv;
        }
        const int j = kt + lane;
#pragma unroll
        for (int r = 0; r < LR; ++r) {
            const int i = row0 + r;
            const bool ok = j - i >= -left && j - i <= right && j < k_end;
            float sc = ok ? s[r] * scale : NEG;
            float tmax = sc;
#pragma unroll
            for (int d = 16; d >= 1; d >>= 1)
                tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, d));
            const float m_new = fmaxf(m[r], tmax);
            const float p = ok ? expf(sc - m_new) : 0.f;
            float psum = p;
#pragma unroll
            for (int d = 16; d >= 1; d >>= 1)
                psum += __shfl_xor_sync(0xffffffffu, psum, d);
            const float alpha = expf(m[r] - m_new);
            l[r] = l[r] * alpha + psum;
            m[r] = m_new;
#pragma unroll
            for (int dd = 0; dd < LDD; ++dd) acc[r][dd] *= alpha;
            Pw[r * LK + lane] = p;
        }
        __syncwarp();
        for (int jj = 0; jj < LK; ++jj) {
            float vv[LDD];
#pragma unroll
            for (int dd = 0; dd < LDD; ++dd) {
                const int d = lane + 32 * dd;
                vv[dd] = d < D ? Vs[jj * D + d] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < LR; ++r) {
                const float pj = Pw[r * LK + jj];
#pragma unroll
                for (int dd = 0; dd < LDD; ++dd) acc[r][dd] += pj * vv[dd];
            }
        }
        __syncwarp();
    }

    if (!warp_live) return;
    float* ob = out + n * so.n + h * so.h;
#pragma unroll
    for (int r = 0; r < LR; ++r) {
        const int i = row0 + r;
        if (i >= Tn) continue;
#pragma unroll
        for (int dd = 0; dd < LDD; ++dd) {
            const int d = lane + 32 * dd;
            if (d < D)
                ob[i * so.t + d] = l[r] > 0.f ? acc[r][dd] / l[r] : 0.f;
        }
    }
}

int launch_local_f32(const void* q, const void* k, const void* v, void* out,
                     const long long* st, int N, int H, int Tn, int D,
                     int left, int right, cudaStream_t stream)
{
    const int n_qt = (Tn + LQ - 1) / LQ;
    const size_t smem = sizeof(float)
        * ((size_t)(LQ + LK) * (D + 1) + (size_t)LK * D + LNW * LR * LK);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long blocks = (long long)N * H * n_qt;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const auto kernel = local_attention_f32_kernel;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const Strides sq = {st[0], st[1], st[2]}, sk = {st[3], st[4], st[5]},
                  sv = {st[6], st[7], st[8]}, so = {st[9], st[10], st[11]};
    const float scale = (float)(1.0 / sqrt((double)D));
    kernel<<<(unsigned)blocks, LNT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), sq, sk, sv,
        so, H, Tn, D, left, right, n_qt, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// kernel L, bf16: both products on the tensor cores
// ---------------------------------------------------------------------------

constexpr int TQ = 64;           // query rows per block: 4 warps x 16
constexpr int TK = 64;           // keys per staged tile
constexpr int TNT = (TQ / 16) * 32;

__device__ inline void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// p = hi + mid + lo in three bf16 terms (24 bits, all of an f32 p's): the
// pair (a, b) as the A operand's halves
__device__ inline void split_pair(float a, float b, uint32_t& hi,
                                  uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const float ra = a - hf.x, rb = b - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
    const float2 mf = __bfloat1622float2(m);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = *reinterpret_cast<const uint32_t*>(&m);
    lo = pack_bf16(ra - mf.x, rb - mf.y);
}

// DP: the head dim rounded up to 16 (zeros beyond D in shared memory).
// vec: q, k, v and out at 16-byte addresses with (n, h, t) strides that
// are multiples of 8 elements: 16-byte cp.async copies and paired stores;
// else element by element.
template <int DP>
__global__ void __launch_bounds__(TNT)
local_attention_tc_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ out,
                          Strides sq, Strides sk, Strides sv, Strides so,
                          int H, int Tn, int D, int left, int right, int n_qt,
                          float scale, int vec)
{
    constexpr int LD = DP + PADB;
    constexpr int KT = DP / 16;
    constexpr int CH = DP / 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [TQ][LD]
    bf16* Ks = Qs + TQ * LD;                        // [2][TK][LD]
    bf16* Vs = Ks + 2 * TK * LD;                    // [2][TK][LD]

    const int tid = threadIdx.x;
    const int qt = blockIdx.x % n_qt;
    const int h = (blockIdx.x / n_qt) % H;
    const int n = blockIdx.x / (n_qt * H);
    const int q0 = qt * TQ;
    const int q_end = min(q0 + TQ, Tn);
    const int k_beg = max(0, q0 - left);
    const int k_end = min(Tn, q_end + right);        // exclusive
    const int n_kt = (k_end - k_beg + TK - 1) / TK;

    const bf16* qb = q + n * sq.n + h * sq.h;
    const bf16* kb = k + n * sk.n + h * sk.h;
    const bf16* vb = v + n * sv.n + h * sv.h;
    // rows tok0 .. tok0 + 63 of a [T, D] view into a shared tile, zeros
    // beyond tok_end and D
    auto stage = [&](bf16* dst, const bf16* src, long long st, int tok0,
                     int tok_end) {
        for (int e = tid; e < TK * CH; e += TNT) {
            const int r = e / CH, d0 = (e % CH) * 8;
            const int tok = tok0 + r;
            bf16* s = dst + r * LD + d0;
            if (tok < tok_end && d0 < D) {
                const bf16* g = src + tok * st + d0;
                if (vec) {
                    __pipeline_memcpy_async(s, g, 16);
                } else {
#pragma unroll
                    for (int i = 0; i < 8; ++i) s[i] = g[i];
                }
            } else {
                zero_chunk(s);
            }
        }
    };
    stage(Qs, qb, sq.t, q0, Tn);
    stage(Ks, kb, sk.t, k_beg, k_end);
    stage(Vs, vb, sv.t, k_beg, k_end);
    __pipeline_commit();

    const int w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c4 = lane & 3;
    const int r0 = w * 16;
    const bool warp_live = q0 + r0 < Tn;
    const int ia = q0 + r0 + g, ib = ia + 8;
    // the keys the warp's rows see: w_lo .. w_hi
    const int w_lo = q0 + r0 - left;
    const int w_hi = min(q0 + r0 + 15, Tn - 1) + right;
    // ldmatrix lanes: A rows and columns; B (k, non-transposed) rows and
    // columns of two n-tiles; V (transposed) rows and columns
    const int a_row = lane & 15, a_col = (lane >> 4) * 8;
    const int b_row = (lane >> 4) * 8 + (lane & 7);
    const int b_col = ((lane >> 3) & 1) * 8;
    const int v_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int v_col = (lane >> 4) * 8;

    uint32_t qf[KT][4];
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;
    float o[2 * KT][4];
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;

    for (int kt = 0; kt < n_kt; ++kt) {
        if (kt + 1 < n_kt) {
            const int nxt = ((kt + 1) & 1) * TK * LD;
            stage(Ks + nxt, kb, sk.t, k_beg + (kt + 1) * TK, k_end);
            stage(Vs + nxt, vb, sv.t, k_beg + (kt + 1) * TK, k_end);
        }
        __pipeline_commit();
        __pipeline_wait_prior(1);                   // tile kt is in
        __syncthreads();
        if (kt == 0 && warp_live) {
#pragma unroll
            for (int kk = 0; kk < KT; ++kk)
                ldmatrix_x4(qf[kk], Qs + (r0 + a_row) * LD + kk * 16 + a_col);
        }
        const int key0 = k_beg + kt * TK;
        if (warp_live && key0 <= w_hi && key0 + TK > w_lo) {
            const bf16* Kt = Ks + (kt & 1) * TK * LD;
            const bf16* Vt = Vs + (kt & 1) * TK * LD;
            // scores of the tile's four sub-tiles of 16 keys: s[st][nt]
            // holds, of keys 16 st + 8 nt + 2 c4 and + 1, rows ia (entries
            // 0, 1) and ib (2, 3); vis the same, as bits
            // (live: the sub-tiles that hold a key the warp's rows see, the
            // same in every lane: mma.sync and ldmatrix run warp-wide)
            float s[4][2][4];
            unsigned vis = 0, live = 0;
#pragma unroll
            for (int st = 0; st < 4; ++st) {
                const int j0 = key0 + st * 16;
                if (j0 > w_hi || j0 + 16 <= w_lo || j0 >= k_end) {
#pragma unroll
                    for (int e = 0; e < 8; ++e) s[st][e >> 2][e & 3] = NEG;
                    continue;
                }
                live |= 1u << st;
                float a0[4] = {0.f, 0.f, 0.f, 0.f};
                float a1[4] = {0.f, 0.f, 0.f, 0.f};
                const bf16* kp = Kt + (st * 16 + b_row) * LD + b_col;
#pragma unroll
                for (int kk = 0; kk < KT; ++kk) {
                    uint32_t b[4];
                    ldmatrix_x4(b, kp + kk * 16);
                    mma_bf16(a0, qf[kk], b[0], b[1]);
                    mma_bf16(a1, qf[kk], b[2], b[3]);
                }
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int nt = e >> 2, ee = e & 3;
                    const int j = j0 + nt * 8 + 2 * c4 + (ee & 1);
                    const int i = ee < 2 ? ia : ib;
                    const bool ok = j - i >= -left && j - i <= right
                        && j < k_end;
                    s[st][nt][ee] = ok ? (nt ? a1[ee] : a0[ee]) * scale : NEG;
                    vis |= (unsigned)ok << (st * 8 + e);
                }
            }
            // online softmax over the tile: each row's max over the four
            // threads that share it, then p and the rescale of o
            float ta = NEG, tb = NEG;
#pragma unroll
            for (int st = 0; st < 4; ++st)
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    ta = fmaxf(ta, fmaxf(s[st][nt][0], s[st][nt][1]));
                    tb = fmaxf(tb, fmaxf(s[st][nt][2], s[st][nt][3]));
                }
#pragma unroll
            for (int d = 1; d <= 2; d <<= 1) {
                ta = fmaxf(ta, __shfl_xor_sync(0xffffffffu, ta, d));
                tb = fmaxf(tb, __shfl_xor_sync(0xffffffffu, tb, d));
            }
            const float na = fmaxf(m_a, ta), nb = fmaxf(m_b, tb);
            const float alpha_a = expf(m_a - na), alpha_b = expf(m_b - nb);
            m_a = na;
            m_b = nb;
            float sa = 0.f, sb = 0.f;
#pragma unroll
            for (int st = 0; st < 4; ++st)
#pragma unroll
                for (int e = 0; e < 8; ++e) {
                    const int nt = e >> 2, ee = e & 3;
                    const float p = (vis >> (st * 8 + e) & 1)
                        ? expf(s[st][nt][ee] - (ee < 2 ? na : nb)) : 0.f;
                    s[st][nt][ee] = p;
                    if (ee < 2) sa += p; else sb += p;
                }
            l_a = l_a * alpha_a + sa;
            l_b = l_b * alpha_b + sb;
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt) {
                o[dt][0] *= alpha_a;
                o[dt][1] *= alpha_a;
                o[dt][2] *= alpha_b;
                o[dt][3] *= alpha_b;
            }
            // o += p . v with p = hi + mid + lo: three bf16 products of
            // the sub-tile's 16 keys, smallest first, summed from zero on
            // the tensor cores, then added to o on the f32 cores (the
            // tensor cores truncate where they add to an accumulator)
#pragma unroll
            for (int st = 0; st < 4; ++st) {
                if (!(live >> st & 1u)) continue;
                uint32_t hi[4], mid[4], lo[4];
                split_pair(s[st][0][0], s[st][0][1], hi[0], mid[0], lo[0]);
                split_pair(s[st][0][2], s[st][0][3], hi[1], mid[1], lo[1]);
                split_pair(s[st][1][0], s[st][1][1], hi[2], mid[2], lo[2]);
                split_pair(s[st][1][2], s[st][1][3], hi[3], mid[3], lo[3]);
                const bf16* vp = Vt + (st * 16 + v_row) * LD + v_col;
#pragma unroll
                for (int dk = 0; dk < KT; ++dk) {
                    uint32_t vb4[4];
                    ldmatrix_x4_trans(vb4, vp + dk * 16);
                    float t0[4] = {0.f, 0.f, 0.f, 0.f};
                    float t1[4] = {0.f, 0.f, 0.f, 0.f};
                    mma_bf16(t0, lo, vb4[0], vb4[1]);
                    mma_bf16(t1, lo, vb4[2], vb4[3]);
                    mma_bf16(t0, mid, vb4[0], vb4[1]);
                    mma_bf16(t1, mid, vb4[2], vb4[3]);
                    mma_bf16(t0, hi, vb4[0], vb4[1]);
                    mma_bf16(t1, hi, vb4[2], vb4[3]);
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        o[2 * dk][e] += t0[e];
                        o[2 * dk + 1][e] += t1[e];
                    }
                }
            }
        }
        __syncthreads();                            // tile kt is read
    }

    if (!warp_live) return;
#pragma unroll
    for (int d = 1; d <= 2; d <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
    }
    bf16* ob = out + n * so.n + h * so.h;
#pragma unroll
    for (int dt = 0; dt < 2 * KT; ++dt) {
        const int d = dt * 8 + 2 * c4;
        if (d >= D) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int i = half ? ib : ia;
            const float l = half ? l_b : l_a;
            if (i >= Tn) continue;
            const float x0 = l > 0.f ? o[dt][2 * half] / l : 0.f;
            const float x1 = l > 0.f ? o[dt][2 * half + 1] / l : 0.f;
            bf16* dst = ob + i * so.t + d;
            if (vec) {
                store_pair(dst, x0, x1);
            } else {
                dst[0] = __float2bfloat16(x0);
                dst[1] = __float2bfloat16(x1);
            }
        }
    }
}

template <int DP>
int launch_local_tc(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                    const Strides (&st)[4], int N, int H, int Tn, int D,
                    int left, int right, cudaStream_t stream)
{
    const int n_qt = (Tn + TQ - 1) / TQ;
    const size_t smem = sizeof(bf16) * (size_t)(TQ + 4 * TK) * (DP + PADB);
    const long long blocks = (long long)N * H * n_qt;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const auto at16 = [](const void* p) {
        return reinterpret_cast<uintptr_t>(p) % 16 == 0;
    };
    bool vec = at16(q) && at16(k) && at16(v) && at16(out);
    for (int i = 0; i < 4; ++i)
        vec = vec && st[i].n % 8 == 0 && st[i].h % 8 == 0 && st[i].t % 8 == 0;
    const auto kernel = local_attention_tc_kernel<DP>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const float scale = (float)(1.0 / sqrt((double)D));
    kernel<<<(unsigned)blocks, TNT, smem, stream>>>(
        q, k, v, out, st[0], st[1], st[2], st[3], H, Tn, D, left, right,
        n_qt, scale, (int)vec);
    return (int)cudaGetLastError();
}

int launch_local_bf16(const void* q, const void* k, const void* v, void* out,
                      const long long* s, int N, int H, int Tn, int D, int dp,
                      int left, int right, cudaStream_t stream)
{
    const Strides st[4] = {{s[0], s[1], s[2]}, {s[3], s[4], s[5]},
                           {s[6], s[7], s[8]}, {s[9], s[10], s[11]}};
    const auto* qq = static_cast<const bf16*>(q);
    const auto* kk = static_cast<const bf16*>(k);
    const auto* vv = static_cast<const bf16*>(v);
    auto* oo = static_cast<bf16*>(out);
    switch (dp) {
    case 16: return launch_local_tc<16>(qq, kk, vv, oo, st, N, H, Tn, D,
                                        left, right, stream);
    case 32: return launch_local_tc<32>(qq, kk, vv, oo, st, N, H, Tn, D,
                                        left, right, stream);
    case 48: return launch_local_tc<48>(qq, kk, vv, oo, st, N, H, Tn, D,
                                        left, right, stream);
    case 64: return launch_local_tc<64>(qq, kk, vv, oo, st, N, H, Tn, D,
                                        left, right, stream);
    case 96: return launch_local_tc<96>(qq, kk, vv, oo, st, N, H, Tn, D,
                                        left, right, stream);
    default: return launch_local_tc<128>(qq, kk, vv, oo, st, N, H, Tn, D,
                                         left, right, stream);
    }
}

bool fused_args_ok(int N, int T, int H, int D, int r2, int left, int right,
                   int t_real)
{
    return N >= 1 && T >= 1 && H >= 1 && D >= 8 && D <= 128 && D % 8 == 0
        && r2 >= 8 && r2 % 8 == 0 && 2 * r2 <= D && left >= 0 && left < 128
        && right >= 0 && right <= 128 && t_real >= 1 && t_real <= T;
}

}  // namespace

// Kernel K. qkv [N, T, 3, H, D] and out [N, T, H, D] contiguous, bf16 or
// (is_f32) f32, at 16-byte addresses; cos, sin [T, r2] f32 with r2 half the
// rotary dim. D a multiple of 8 up to 128, r2 a multiple of 8 with
// 2 r2 <= D, 0 <= left < 128, 0 <= right <= 128, 1 <= t_real <= T.
extern "C" int fused_rotary_window_attention(
    const void* qkv, const void* cosp, const void* sinp, void* out, int N,
    int T, int H, int D, int r2, int left, int right, int t_real, int is_f32,
    void* stream)
{
    if (!fused_args_ok(N, T, H, D, r2, left, right, t_real))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_f32
        ? dispatch_fused<float, false>(D, qkv, cosp, sinp, out, nullptr, N, T,
                                       H, r2, left, right, t_real, s)
        : dispatch_fused<bf16, false>(D, qkv, cosp, sinp, out, nullptr, N, T,
                                      H, r2, left, right, t_real, s);
}

// Kernel H: kernel K that also writes lse [N, H, T] f32, each query's
// log-sum-exp max + log(sum) of its scaled, masked scores (-1e30 where the
// query sees no key). Its out equals kernel K's bit for bit.
extern "C" int fused_rotary_window_attention_lse(
    const void* qkv, const void* cosp, const void* sinp, void* out,
    void* lse, int N, int T, int H, int D, int r2, int left, int right,
    int t_real, int is_f32, void* stream)
{
    if (!fused_args_ok(N, T, H, D, r2, left, right, t_real))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* l = static_cast<float*>(lse);
    return is_f32
        ? dispatch_fused<float, true>(D, qkv, cosp, sinp, out, l, N, T, H, r2,
                                      left, right, t_real, s)
        : dispatch_fused<bf16, true>(D, qkv, cosp, sinp, out, l, N, T, H, r2,
                                     left, right, t_real, s);
}

// Kernel O: the backward of H. qkv, cos, sin, t_real as H took them; lse
// [N, H, T] f32 as H wrote it; o (H's out) and dout, its cotangent, [N, T, H,
// D] -> dqkv [N, T, 3, H, D]. qkv, o, dout and dqkv contiguous, of one type
// (bf16 or, is_f32, f32), at 16-byte addresses.
extern "C" int fused_rotary_window_attention_bwd(
    const void* qkv, const void* cosp, const void* sinp, const void* lse,
    const void* o, const void* dout, void* dqkv, int N, int T, int H, int D,
    int r2, int left, int right, int t_real, int is_f32, void* stream)
{
    if (!fused_args_ok(N, T, H, D, r2, left, right, t_real))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* l = static_cast<const float*>(lse);
    return is_f32
        ? dispatch_bwd<float>(D, qkv, cosp, sinp, l, o, dout, dqkv, N, T, H,
                              r2, left, right, t_real, s)
        : dispatch_bwd<bf16>(D, qkv, cosp, sinp, l, o, dout, dqkv, N, T, H,
                             r2, left, right, t_real, s);
}

// Kernel L. q, k, v, out [N, H, T, D] with element strides
// strides[12] = (n, h, t) of q, k, v, out (a host array) and a contiguous
// D, bf16 or (is_f32) f32. D a multiple of 8 up to 128, left and right >= 0.
// dp, the bf16 instance's padded head dim (ops/attention_cuda.py:
// padded_head_dim), is 16, 32, 48, 64, 96 or 128 and at least D.
extern "C" int local_attention(const void* q, const void* k, const void* v,
                               void* out, const long long* strides, int N,
                               int H, int T, int D, int dp, int left,
                               int right, int is_f32, void* stream)
{
    if (N < 1 || T < 1 || H < 1 || D < 8 || D > 32 * LDD || D % 8 != 0
        || left < 0 || right < 0 || dp < D
        || !(dp == 16 || dp == 32 || dp == 48 || dp == 64 || dp == 96
             || dp == 128))
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_f32
        ? launch_local_f32(q, k, v, out, strides, N, H, T, D, left, right, s)
        : launch_local_bf16(q, k, v, out, strides, N, H, T, D, dp, left,
                            right, s);
}
