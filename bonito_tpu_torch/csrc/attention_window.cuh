// What the stretch kernels of the banded attention share: kernels K and H
// (csrc/attention_window.cu) and kernel O (csrc/attention_window_bwd.cu).
// Each CTA walks consecutive tiles of 64 tokens of one (n, h) and keeps a
// ring of 64-row blocks in shared memory; rows are 16-byte chunks
// XOR-swizzled by the row, the rotary runs once a row, in place, and the
// products run on mma.sync m16n8k16 with ldmatrix.

#pragma once

#include "lstm_persistent.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float WNEG = -1e30f;      // a masked score
constexpr int WQ = 64;              // tokens a tile, rows a ring block
constexpr int WCW = 4;              // consumer warps: 16 tile rows each
constexpr int WPW = 2;              // producer warps
constexpr int WNT = (WCW + WPW) * 32;
constexpr float WLOG2E = 1.4426950408889634f;

// element offset of chunk c (8 values) of `row` in a tile of rows of DP
// values: the chunks of a row are XOR-swizzled by the row, so that the 8 rows
// of an ldmatrix at one chunk lie in distinct banks
template <int DP>
__device__ __forceinline__ int swz(int row, int c) {
    constexpr int CH = DP / 8;
    const int x = CH >= 8 ? (row & 7) : ((row >> 1) & 3);
    return row * DP + ((c ^ x) << 3);
}

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}

// a register-only product: not volatile, so the compiler may interleave it
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1)
{
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// rotate 8 elements of a row (ra, at lo) and their partners r2 further on
// (rb, at hi) by the tables' cs and sn, in f32 with every product and sum
// rounded on its own (as the plain version and the earlier kernel's
// rotary_chunk), and store both
__device__ __forceinline__ void rotate8(bf16* lo, bf16* hi, const uint4& ra,
                                        const uint4& rb, const float4 (&cs)[2],
                                        const float4 (&sn)[2]) {
    const float c[8] = {cs[0].x, cs[0].y, cs[0].z, cs[0].w,
                        cs[1].x, cs[1].y, cs[1].z, cs[1].w};
    const float s[8] = {sn[0].x, sn[0].y, sn[0].z, sn[0].w,
                        sn[1].x, sn[1].y, sn[1].z, sn[1].w};
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&ra);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&rb);
    uint32_t o1[4], o2[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 a = __bfloat1622float2(ha[i]);
        const float2 b = __bfloat1622float2(hb[i]);
        const float ca = c[2 * i], cb = c[2 * i + 1];
        const float sa = s[2 * i], sb = s[2 * i + 1];
        o1[i] = pack2(__fsub_rn(__fmul_rn(a.x, ca), __fmul_rn(b.x, sa)),
                      __fsub_rn(__fmul_rn(a.y, cb), __fmul_rn(b.y, sb)));
        o2[i] = pack2(__fadd_rn(__fmul_rn(b.x, ca), __fmul_rn(a.x, sa)),
                      __fadd_rn(__fmul_rn(b.y, cb), __fmul_rn(a.y, sb)));
    }
    *reinterpret_cast<uint4*>(lo) = make_uint4(o1[0], o1[1], o1[2], o1[3]);
    *reinterpret_cast<uint4*>(hi) = make_uint4(o2[0], o2[1], o2[2], o2[3]);
}

__device__ __forceinline__ void zero16(bf16* p) {
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
}

// what the rotary of a step reads: the tables, the ring's size, and the
// tokens below which the tile's rows (live_a) and the ring's (live_r) hold
// data
struct RotView {
    const float* cosp;
    const float* sinp;
    int r2, ring, live_a, live_r;
};

// the rotary of a step's rows, in place: the tile's rotated rows (tokens a0
// .. a0 + 63, those below live_a) and the new ring blocks b_lo, b_lo + 1,
// ... (those below live_r), by thread i of NT, RB chunk pairs a thread a
// batch: load() issues a batch's table loads, apply() rotates it, so that a
// batch's loads can be in flight while the copies land (a batch holds about
// 28 RB registers)
template <int DP, int NT, int RB = 4>
struct Rotary {
    static constexpr int CH2 = DP / 16;          // the most pairs a row
    static constexpr int TILE = WQ * CH2;        // items a tile of rows
    float4 cs[RB][2], sn[RB][2];
    bf16* lo[RB];
    bf16* hi[RB];
    bool on[RB];

    static __device__ __forceinline__ int batches(int items) {
        return (items + NT * RB - 1) / (NT * RB);
    }

    __device__ __forceinline__ void load(const RotView& v, bf16* A, bf16* Rr,
                                         int a0, int b_lo, int items, int i,
                                         int j) {
        const int rch = v.r2 / 8;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
            const int e = i + (j * RB + k) * NT;
            on[k] = false;
            if (e < items) {
                const int part = e / TILE, rem = e % TILE;
                const int r = rem / CH2, c = rem % CH2;
                bf16* tile = A;
                int tok = a0 + r, live = v.live_a;
                if (part > 0) {
                    const int b = b_lo + part - 1;
                    tile = Rr + (b % v.ring) * WQ * DP;
                    tok = b * WQ + r;
                    live = v.live_r;
                }
                on[k] = c < rch && tok < live;
                if (on[k]) {
                    lo[k] = tile + swz<DP>(r, c);
                    hi[k] = tile + swz<DP>(r, c + rch);
                    const size_t t = (size_t)tok * v.r2 + c * 8;
                    const float4* cp = reinterpret_cast<const float4*>(v.cosp + t);
                    const float4* sp = reinterpret_cast<const float4*>(v.sinp + t);
                    cs[k][0] = __ldg(cp);
                    cs[k][1] = __ldg(cp + 1);
                    sn[k][0] = __ldg(sp);
                    sn[k][1] = __ldg(sp + 1);
                }
            }
        }
    }

    __device__ __forceinline__ void apply() {
        uint4 ra[RB], rb[RB];
#pragma unroll
        for (int k = 0; k < RB; ++k)
            if (on[k]) {
                ra[k] = *reinterpret_cast<const uint4*>(lo[k]);
                rb[k] = *reinterpret_cast<const uint4*>(hi[k]);
            }
#pragma unroll
        for (int k = 0; k < RB; ++k)
            if (on[k]) rotate8(lo[k], hi[k], ra[k], rb[k], cs[k], sn[k]);
    }

    // load and apply every batch of a step: the first batch's tables load
    // before `landed` waits for the copies
    template <typename Landed>
    __device__ __forceinline__ void run(const RotView& v, bf16* A, bf16* Rr,
                                        int a0, int b_lo, int items, int i,
                                        Landed landed) {
        load(v, A, Rr, a0, b_lo, items, i, 0);
        landed();
        apply();
        for (int j = 1; j < batches(items); ++j) {
            load(v, A, Rr, a0, b_lo, items, i, j);
            apply();
        }
    }
};

}  // namespace
