// Kernels K and H for the H100: the rotary + banded attention of
// csrc/attention.cu's fused kernel -- the same function, rounded at the same
// points -- with the key window staged once per stretch of query tiles.
//
// K, fused_rotary_window_attention, replaces
// bonito_tpu/ops/attention_pallas.py:fused_rotary_window_attention
// (`_fused_kernel_dt`, `_rot_dt`); H, its instance that also writes each
// query's lse, the forward of fused_rotary_window_attention_train
// (`_fused_fwd_kernel_dt`). From qkv [N, T, 3, H, D] bf16 or f32 and
// cos/sin [T, r2] f32 to o [N, T, H, D] of qkv's type (and lse [N, H, T]
// f32):
//
//     q, k  = bf16(rotary(f32(q)), rotary(f32(k)))   every product and sum
//             rounded on its own (no fused multiply-add)
//     s     = (q . k) / sqrt(D)       bf16 products, f32 sums; -1e30 masked
//     p     = bf16(exp(s - max) / sum)                two passes, as the TPU
//     o     = p . bf16(v)             f32 sums, cast to the output last
//     lse   = max + log(sum)          -1e30 where a query sees no key
//
// Query i sees key j iff -left <= j - i <= right and j < t_real; a query
// that sees no key gives 0.
//
// What bounds it on an H100: at sup shapes (N 128, T 1000, 8 heads of 64,
// window (127, 128)) the bytes, 0.16 ms (qkv in, o out), against 67 GFLOP
// in the band on the tensor cores (0.07 ms) and two exps a visible pair on
// the special-function units (about 0.13 ms at 16 a clock an SM). What sets
// its pace is the consumers' work (scripts/attention_split.py leaves each
// part out): three products a pair on mma.sync (pass 1, pass 2's scores
// again and p . v), at about two thirds of the rate wgmma reaches, beside
// the exps.
//
// Design. The earlier kernel (csrc/attention.cu, kept for shapes that
// window_plan does not take) gave each tile of 64 queries its own block,
// which staged the tile's whole key window (up to 319 rows, rotated) before
// any work: every key row was loaded, rotated and rounded about five times,
// and nothing overlapped the staging. Here one CTA walks a stretch of
// consecutive 64-query tiles of one (n, h) in order (ops/attention_cuda.py:
// window_plan fixes the stretch from the shape and the SMs) and keeps a ring
// of key blocks in shared memory: block b holds keys 64b .. 64b + 63, k
// rotated and v as it is, in slot b % ring. Tile t sees blocks t - back ..
// t + ahead (back = ceil(left / 64), ahead = floor((63 + right) / 64)), so a
// stretch stages its leading window once and then one new block a tile;
// ring = back + ahead + 2 slots leave the producers a tile ahead of the
// consumers. All six warps stage the stretch's first tile (q's rows and the
// leading window) together; then the CTA is warp-specialised:
//   producers (2 warps)  copy tile t's 64 q rows and the new block's k and v
//       rows by cp.async (16 bytes a lane), rotate q and k in place once a
//       row (cos and sin from L2, the first batch's loads in flight while
//       the copies land), zero the rows beyond T or t_real, then arrive at
//       the mbarrier `full` of the tile; before refilling a slot they wait at
//       `empty` for the consumers of the tile two back;
//   consumers (4 warps)  own 16 query rows each and walk the keys their rows
//       see in tiles of 16: pass 1 the scores on mma.sync m16n8k16 (ldmatrix
//       from the ring, K as the B operand) for each row's max and sum, pass 2
//       the scores again, p = bf16(exp(s - max) / sum) in the A-operand layout
//       the accumulators already have, and o += p . v (ldmatrix.trans); then
//       they arrive at `empty` and store o (and lse).
// The masks are evaluated only on the key tiles at the band's edges (two of
// about seventeen a warp at sup shapes), in loops of their own, so that the
// tiles between them run without a branch; exp(s - max) is ex2 of one fused
// multiply-add of the raw score. Rows are 16-byte chunks XOR-swizzled by the
// row so that ldmatrix and the copies hit distinct banks without padding:
// 112 KB at D 64 and the sup window, two CTAs an SM.
//
// f32 (evaluate and train --no-amp). For f32 qkv the kernel rounds q, k, v
// and p to bf16 as for bf16 input and multiplies on mma.sync all the same,
// so it moves f32 qkv in and f32 o out (524 MB at evaluate's batch, N 256, T
// 250: 0.156 ms) and its operations are the bf16 instance's: bytes bound it.
// The ring keeps bf16 rows (114,720 B at sup, two CTAs an SM); only the
// producers' staging differs (StageF32): the 16-byte copies cannot land in
// a bf16 ring, so each thread loads a batch of f32 chunks (a rotary pair's
// two chunks together, with their cos and sin) into registers, rotates
// them in f32, rounds and stores them, and hands its own rows over by its
// arrival at `full`. The consumers, the masks, the two passes
// and the lse are the bf16 instance's; o is stored in f32. An f32 staging
// area in shared memory (cp.async, then rotate) would take about 48 KB
// more at D 64 and one CTA an SM.

#include <type_traits>

#include "attention_window.cuh"

namespace {

__device__ __forceinline__ void store2(bf16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

struct Window {
    const void* qkv;                // bf16 or f32, as the kernel's T
    const float* cosp;
    const float* sinp;
    void* out;                      // qkv's type
    float* lse;
    int T, H, D, r2, left, right, t_real;
    int n_qt, stretch, n_str, ring, back, ahead;
    float scale;
};

__host__ __device__ inline size_t window_smem(int ring, int dp) {
    return (size_t)(2 * ring + 2) * WQ * dp * sizeof(bf16) + 4 * sizeof(uint64_t);
}

// a step's copies, by thread i of n: q's tile of rows q0 .. q0 + 63 and the
// k and v rows of key blocks b_lo .. b_hi, 16 bytes each by cp.async; zeros
// for a row at or beyond T (q) or t_real (k, v); the padding beyond D stays
// as it is (zero)
template <int DP>
__device__ __forceinline__ void stage(const Window& a, const bf16* base,
                                      bf16* Q, bf16* Ks, bf16* Vs, int q0,
                                      int b_lo, int b_hi, int i, int n) {
    constexpr int CH = DP / 8;
    const int chd = a.D / 8;
    const size_t ts = (size_t)3 * a.H * a.D, hd = (size_t)a.H * a.D;
    for (int e = i; e < WQ * CH; e += n) {
        const int r = e / CH, c = e % CH;
        if (c >= chd) continue;
        bf16* d = Q + swz<DP>(r, c);
        if (q0 + r < a.T)
            cp_async16(d, base + (size_t)(q0 + r) * ts + c * 8);
        else
            zero16(d);
    }
    for (int b = b_lo; b <= b_hi; ++b) {
        const int off = (b % a.ring) * WQ * DP;
        for (int e = i; e < WQ * CH; e += n) {
            const int r = e / CH, c = e % CH;
            if (c >= chd) continue;
            const int tok = b * WQ + r;
            bf16* dk = Ks + off + swz<DP>(r, c);
            bf16* dv = Vs + off + swz<DP>(r, c);
            if (tok < a.t_real) {
                const bf16* src = base + (size_t)tok * ts + c * 8;
                cp_async16(dk, src + hd);
                cp_async16(dv, src + 2 * hd);
            } else {
                zero16(dk);
                zero16(dv);
            }
        }
    }
}

// A step's staging from f32 qkv (kernels K and H in f32), by thread i of NT:
// the same rows as `stage` and the rotary, but the 16-byte copies cannot
// land in the bf16 ring, so each unit goes through registers: a rotary pair
// (8 elements of q or k at chunk c < r2 / 8 and their partners r2 further
// on) is loaded as four float4, rotated in f32 with every product and sum
// rounded on its own (as rotate8 and the earlier kernel's rotary_chunk),
// rounded to bf16 and stored into the swizzled rows; a plain chunk (v, and
// q and k beyond the rotary dim) is loaded, rounded and stored. Rows at or
// beyond T (q) or t_real (k, v) get zeros; the padding beyond D stays as it
// is (zero). RB units a thread a batch: every load of a batch, its cos and
// sin among them, is issued before any of its units is stored. A second
// batch in flight, or 4 units a batch, spills beyond the 168 registers of
// two CTAs an SM and runs slower (scripts/attention_split.py f32 times
// both).
template <int DP, int NT, int RB = 2>
struct StageF32 {
    static constexpr int CH = DP / 8;       // chunk slots a row
    static constexpr int CH2 = DP / 16;     // rotary pair slots a row
    struct Batch {
        float4 x[RB][4];    // the lo chunk in x[0..1], its partner in x[2..3]
        float4 t[RB][4];    // a pair's cos in t[0..1], its sin in t[2..3]
        bf16* lo[RB];
        bf16* hi[RB];       // a pair's partner; null for a plain chunk
        int st[RB];         // 0 nothing, 1 zeros, 2 data
    };
    const Window& a;
    const float* base;
    bf16 *Q, *Ks, *Vs;
    int q0, b_lo, nblk, rch, chd, tail, n_pair, n_v, total;

    __device__ __forceinline__ StageF32(const Window& a_, const float* base_,
                                        bf16* Q_, bf16* Ks_, bf16* Vs_,
                                        int q0_, int b_lo_, int b_hi)
        : a(a_), base(base_), Q(Q_), Ks(Ks_), Vs(Vs_), q0(q0_), b_lo(b_lo_) {
        nblk = max(b_hi - b_lo + 1, 0);
        rch = a.r2 / 8;
        chd = a.D / 8;
        tail = chd - 2 * rch;
        n_pair = (1 + nblk) * WQ * CH2;
        n_v = nblk * WQ * CH;
        total = n_pair + n_v + (tail > 0 ? (1 + nblk) * WQ * CH : 0);
    }

    // the rows of `part` of q's tile (0) and the key blocks (1 ..): where
    // they go, their first token and the token below which they hold data
    __device__ __forceinline__ bf16* rows(int part, bf16* ring, int& tok0,
                                          int& live) const {
        if (part == 0) {
            tok0 = q0;
            live = a.T;
            return Q;
        }
        const int b = b_lo + part - 1;
        tok0 = b * WQ;
        live = a.t_real;
        return ring + (b % a.ring) * WQ * DP;
    }

    // batch j of thread i: its units' places, and every load issued
    __device__ __forceinline__ void load(Batch& bt, int i, int j) const {
        const size_t ts = (size_t)3 * a.H * a.D, hd = (size_t)a.H * a.D;
#pragma unroll
        for (int k = 0; k < RB; ++k) {
            int e = i + (j * RB + k) * NT;
            bt.st[k] = 0;
            if (e >= total) continue;
            int r, c, part, tok0, live;
            size_t plane;
            bf16* tile;
            bool pair = e < n_pair;
            if (pair) {
                part = e / (WQ * CH2);
                r = e % (WQ * CH2) / CH2;
                c = e % CH2;
                if (c >= rch) continue;
                tile = rows(part, Ks, tok0, live);
                plane = part == 0 ? 0 : hd;
            } else {
                e -= n_pair;
                const bool v = e < n_v;
                e -= v ? 0 : n_v;
                part = e / (WQ * CH) + (v ? 1 : 0);
                r = e % (WQ * CH) / CH;
                c = e % CH;
                if (c >= chd || (!v && c < 2 * rch)) continue;
                tile = rows(part, v ? Vs : Ks, tok0, live);
                plane = v ? 2 * hd : part == 0 ? 0 : hd;
            }
            const int tok = tok0 + r;
            bt.lo[k] = tile + swz<DP>(r, c);
            bt.hi[k] = pair ? tile + swz<DP>(r, c + rch) : nullptr;
            bt.st[k] = tok < live ? 2 : 1;
            if (tok < live) {
                const float4* src = reinterpret_cast<const float4*>(
                    base + (size_t)tok * ts + plane + c * 8);
                bt.x[k][0] = __ldg(src);
                bt.x[k][1] = __ldg(src + 1);
                if (pair) {
                    bt.x[k][2] = __ldg(src + a.r2 / 4);
                    bt.x[k][3] = __ldg(src + a.r2 / 4 + 1);
                    const size_t tab = (size_t)tok * a.r2 + c * 8;
                    const float4* cp = reinterpret_cast<const float4*>(a.cosp + tab);
                    const float4* sp = reinterpret_cast<const float4*>(a.sinp + tab);
                    bt.t[k][0] = __ldg(cp);
                    bt.t[k][1] = __ldg(cp + 1);
                    bt.t[k][2] = __ldg(sp);
                    bt.t[k][3] = __ldg(sp + 1);
                }
            }
        }
    }

    // batch `bt` rotated (pairs), rounded and stored
    __device__ __forceinline__ void apply(const Batch& bt) const {
#pragma unroll
        for (int k = 0; k < RB; ++k) {
            if (bt.st[k] == 0) continue;
            if (bt.st[k] == 1) {
                zero16(bt.lo[k]);
                if (bt.hi[k]) zero16(bt.hi[k]);
                continue;
            }
            const float a8[8] = {bt.x[k][0].x, bt.x[k][0].y, bt.x[k][0].z,
                                 bt.x[k][0].w, bt.x[k][1].x, bt.x[k][1].y,
                                 bt.x[k][1].z, bt.x[k][1].w};
            if (!bt.hi[k]) {
                *reinterpret_cast<uint4*>(bt.lo[k]) = make_uint4(
                    pack2(a8[0], a8[1]), pack2(a8[2], a8[3]),
                    pack2(a8[4], a8[5]), pack2(a8[6], a8[7]));
                continue;
            }
            const float b8[8] = {bt.x[k][2].x, bt.x[k][2].y, bt.x[k][2].z,
                                 bt.x[k][2].w, bt.x[k][3].x, bt.x[k][3].y,
                                 bt.x[k][3].z, bt.x[k][3].w};
            const float4 *c4 = bt.t[k], *s4 = bt.t[k] + 2;
            const float c8[8] = {c4[0].x, c4[0].y, c4[0].z, c4[0].w,
                                 c4[1].x, c4[1].y, c4[1].z, c4[1].w};
            const float s8[8] = {s4[0].x, s4[0].y, s4[0].z, s4[0].w,
                                 s4[1].x, s4[1].y, s4[1].z, s4[1].w};
            float o1[8], o2[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
                o1[u] = __fsub_rn(__fmul_rn(a8[u], c8[u]), __fmul_rn(b8[u], s8[u]));
                o2[u] = __fadd_rn(__fmul_rn(b8[u], c8[u]), __fmul_rn(a8[u], s8[u]));
            }
            *reinterpret_cast<uint4*>(bt.lo[k]) = make_uint4(
                pack2(o1[0], o1[1]), pack2(o1[2], o1[3]), pack2(o1[4], o1[5]),
                pack2(o1[6], o1[7]));
            *reinterpret_cast<uint4*>(bt.hi[k]) = make_uint4(
                pack2(o2[0], o2[1]), pack2(o2[2], o2[3]), pack2(o2[4], o2[5]),
                pack2(o2[6], o2[7]));
        }
    }

    // every batch of the step by thread i
    __device__ __forceinline__ void run(int i) const {
        const int nb = (total + NT * RB - 1) / (NT * RB);
        for (int j = 0; j < nb; ++j) {
            Batch bt;
            load(bt, i, j);
            apply(bt);
        }
    }
};

// T: qkv's and out's type, bf16 or float (the ring holds bf16 either way).
// DP: the head dim padded to 32, 64 or 128 (zeros beyond D). LSE: also
// write each query's log-sum-exp (kernel H); K's instance is the same code
// without that store, so both give the same o bit for bit.
template <typename T, int DP, bool LSE>
__global__ void __launch_bounds__(WNT, DP <= 64 ? 2 : 1)
window_attention_kernel(const Window a)
{
    constexpr int KT = DP / 16;
    constexpr bool F32 = std::is_same<T, float>::value;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // [ring][WQ][DP] k, rotated
    bf16* Vs = Ks + (size_t)a.ring * WQ * DP;       // [ring][WQ][DP] v
    bf16* Qs = Vs + (size_t)a.ring * WQ * DP;       // [2][WQ][DP] q, rotated
    uint64_t* full = reinterpret_cast<uint64_t*>(Qs + 2 * WQ * DP);
    uint64_t* empty = full + 2;

    const int tid = threadIdx.x;
    const int pair = blockIdx.x / a.n_str;
    const int t_a = (blockIdx.x % a.n_str) * a.stretch;   // the first tile
    const int n = pair / a.H, h = pair % a.H;
    const int steps = min(a.stretch, a.n_qt - t_a);
    const size_t ts = (size_t)3 * a.H * a.D;             // qkv's token stride
    const T* base = static_cast<const T*>(a.qkv) + (size_t)n * a.T * ts
        + (size_t)h * a.D;

    // zeros everywhere first: the padding beyond D stays zero, and a slot
    // that is never filled is never read
    {
        uint4* p = reinterpret_cast<uint4*>(smem_raw);
        const int n16 = (2 * a.ring + 2) * WQ * DP / 8;
        for (int i = tid; i < n16; i += WNT) p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
        mbar_init(full, WPW * 32);
        mbar_init(full + 1, WPW * 32);
        mbar_init(empty, WCW * 32);
        mbar_init(empty + 1, WCW * 32);
    }
    __syncthreads();

    const int nb = (a.t_real + WQ - 1) / WQ;   // blocks with a visible key
    const RotView rv = {a.cosp, a.sinp, a.r2, a.ring, a.T, a.t_real};
    // the stretch's first tile, by all the warps: q's rows and the leading
    // window (blocks t_a - back .. t_a + ahead), copied and rotated before
    // the warps take their roles; the producers' arrival completes its phase
    {
        const int b_lo = max(t_a - a.back, 0), b_hi = min(t_a + a.ahead, nb - 1);
        if constexpr (F32) {
            StageF32<DP, WNT>(a, base, Qs, Ks, Vs, t_a * WQ, b_lo, b_hi).run(tid);
        } else {
            const int items = Rotary<DP, WNT>::TILE * (1 + max(b_hi - b_lo + 1, 0));
            stage<DP>(a, base, Qs, Ks, Vs, t_a * WQ, b_lo, b_hi, tid, WNT);
            cp_async_commit();
            Rotary<DP, WNT>().run(rv, Qs, Ks, t_a * WQ, b_lo, items, tid, [] {
                cp_async_wait(0);
                __syncthreads();
            });
        }
        __syncthreads();
    }

    if (tid >= WCW * 32) {
        // ------------------------------------------------------------ producers
        constexpr int PT = WPW * 32;
        const int pt = tid - WCW * 32;
        mbar_arrive(full);                          // the first tile: staged
        for (int s = 1; s < steps; ++s) {
            const int t = t_a + s, q0 = t * WQ;
            // the slots of this tile were last read two tiles back
            if (s >= 2) mbar_wait(empty + (s & 1), (unsigned)(((s >> 1) + 1) & 1));
            bf16* Q = Qs + (s & 1) * WQ * DP;
            // the one block that enters the band
            const int b = t + a.ahead < nb ? t + a.ahead : nb;
            if constexpr (F32) {
                // each thread stores only what it loaded: its arrival (a
                // release) hands its rows over
                StageF32<DP, PT>(a, base, Q, Ks, Vs, q0, b, b < nb ? b : b - 1)
                    .run(pt);
            } else {
                const int items = Rotary<DP, PT>::TILE * (b < nb ? 2 : 1);
                stage<DP>(a, base, Q, Ks, Vs, q0, b, b < nb ? b : b - 1, pt, PT);
                cp_async_commit();
                // the rotary, once a row, in place; the first batch's tables
                // load while the copies land
                Rotary<DP, PT>().run(rv, Q, Ks, q0, b, items, pt, [] {
                    cp_async_wait(0);
                    asm volatile("bar.sync 1, %0;\n" :: "n"(PT) : "memory");
                });
            }
            mbar_arrive(full + (s & 1));
        }
        return;
    }

    // ---------------------------------------------------------------- consumers
    const int w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c4 = lane & 3;
    const int r0 = w * 16;
    const float c2 = a.scale * WLOG2E;
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix of Q, V
    const int acol = lane >> 4;
    const int brow = (lane & 7) + (lane >> 4) * 8;        // ldmatrix of K
    const int bcol = (lane >> 3) & 1;

    for (int s = 0; s < steps; ++s) {
        const int q0 = (t_a + s) * WQ;
        const int row0 = q0 + r0;                         // the warp's first
        mbar_wait(full + (s & 1), (unsigned)((s >> 1) & 1));
        if (row0 < a.T) {
            const bf16* Q = Qs + (s & 1) * WQ * DP;
            uint32_t qf[KT][4];
#pragma unroll
            for (int kt = 0; kt < KT; ++kt)
                ldmatrix_x4(qf[kt], Q + swz<DP>(r0 + arow, 2 * kt + acol));

            const int ia = row0 + g, ib = ia + 8;
            const int row_last = min(row0 + 15, a.T - 1);
            const int j_lo = max(0, row0 - a.left);
            const int j_hi = min(a.t_real, row_last + a.right + 1);
            const int kt_lo = j_lo >> 4;
            const int kt_hi = j_hi > j_lo ? (j_hi + 15) >> 4 : kt_lo;
            const int blk0 = kt_lo >> 2, slot0 = blk0 % a.ring;
            // the tiles of keys j0 .. j0 + 15 that all 16 rows see (j0 >=
            // row0 + 15 - left, j0 + 16 <= row0 + right + 1 and t_real):
            // kt_in_lo .. kt_in_hi - 1, walked without masks and without a
            // branch between tiles; the edge tiles before and after them
            const int kt_in_lo = min(max(kt_lo, (row0 + 15 - a.left + 15) >> 4),
                                     kt_hi);
            const int kt_in_hi = max(kt_in_lo, min(
                kt_hi, min(row0 + a.right + 1, a.t_real) >> 4));

            // the ring row of the tile of 16 keys at 16 kt
            auto krow = [&](int kt) {
                int sl = slot0 + (kt >> 2) - blk0;
                sl -= sl >= a.ring ? a.ring : 0;
                return sl * WQ + (kt & 3) * 16;
            };
            // sc[nt][e]: of keys 16 kt + 8 nt + 2 c4 (+ 1 for odd e), rows ia
            // (e 0, 1) and ib (e 2, 3); raw q . k
            auto scores = [&](int kr, float (&sc)[2][4]) {
                uint32_t kb[KT][4];
#pragma unroll
                for (int kk = 0; kk < KT; ++kk)
                    ldmatrix_x4(kb[kk], Ks + swz<DP>(kr + brow, 2 * kk + bcol));
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) sc[nt][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < KT; ++kk) {
                    mma16816(sc[0], qf[kk], kb[kk][0], kb[kk][1]);
                    mma16816(sc[1], qf[kk], kb[kk][2], kb[kk][3]);
                }
            };
            // the band at the edges: WNEG where masked; bit 4 nt + e set
            // where visible
            auto mask = [&](int kt, float (&sc)[2][4]) {
                unsigned vis = 0;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = kt * 16 + nt * 8 + 2 * c4 + (e & 1);
                        const int d = j - (e < 2 ? ia : ib);
                        const bool ok = d >= -a.left && d <= a.right
                            && j < a.t_real;
                        if (!ok) sc[nt][e] = WNEG;
                        vis |= (unsigned)ok << (nt * 4 + e);
                    }
                return vis;
            };

            // pass 1: each row's max (of the raw scores) and sum
            float m_a = WNEG, m_b = WNEG, l_a = 0.f, l_b = 0.f;
            auto pass1 = [&](float (&sc)[2][4], unsigned vis) {
                const float na = fmaxf(m_a, fmaxf(fmaxf(sc[0][0], sc[0][1]),
                                                  fmaxf(sc[1][0], sc[1][1])));
                const float nb = fmaxf(m_b, fmaxf(fmaxf(sc[0][2], sc[0][3]),
                                                  fmaxf(sc[1][2], sc[1][3])));
                const float ca = -c2 * na, cb = -c2 * nb;
                float sa = 0.f, sb = 0.f;
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const float x = ex2(fmaf(sc[nt][e], c2, e < 2 ? ca : cb));
                        const float v = (vis >> (nt * 4 + e) & 1) ? x : 0.f;
                        if (e < 2) sa += v; else sb += v;
                    }
                l_a = l_a * ex2((m_a - na) * c2) + sa;
                l_b = l_b * ex2((m_b - nb) * c2) + sb;
                m_a = na;
                m_b = nb;
            };
#pragma unroll 1
            for (int kt = kt_lo; kt < kt_in_lo; ++kt) {
                float sc[2][4];
                scores(krow(kt), sc);
                pass1(sc, mask(kt, sc));
            }
#pragma unroll 2
            for (int kt = kt_in_lo; kt < kt_in_hi; ++kt) {
                float sc[2][4];
                scores(krow(kt), sc);
                pass1(sc, 0xffu);
            }
#pragma unroll 1
            for (int kt = kt_in_hi; kt < kt_hi; ++kt) {
                float sc[2][4];
                scores(krow(kt), sc);
                pass1(sc, mask(kt, sc));
            }
            // ... then over the four threads that share a row
            float M_a = m_a, M_b = m_b;
#pragma unroll
            for (int d = 1; d <= 2; d <<= 1) {
                M_a = fmaxf(M_a, __shfl_xor_sync(0xffffffffu, M_a, d));
                M_b = fmaxf(M_b, __shfl_xor_sync(0xffffffffu, M_b, d));
            }
            l_a *= ex2((m_a - M_a) * c2);
            l_b *= ex2((m_b - M_b) * c2);
#pragma unroll
            for (int d = 1; d <= 2; d <<= 1) {
                l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
                l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
            }
            const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
            const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
            // pass 2: p = bf16(exp(s - max) / sum), o += p . v
            float o[2 * KT][4];
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
                for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
            const float cma = -c2 * M_a, cmb = -c2 * M_b;
            auto pass2 = [&](int kr, float (&sc)[2][4], unsigned vis) {
                float p[2][4];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e)
                        p[nt][e] = (vis >> (nt * 4 + e) & 1)
                            ? ex2(fmaf(sc[nt][e], c2, e < 2 ? cma : cmb))
                                * (e < 2 ? inv_a : inv_b)
                            : 0.f;
                uint32_t pa[4];
                pa[0] = pack2(p[0][0], p[0][1]);   // row ia, keys 2c, 2c + 1
                pa[1] = pack2(p[0][2], p[0][3]);   // row ib
                pa[2] = pack2(p[1][0], p[1][1]);   // row ia, keys 8 + 2c, ...
                pa[3] = pack2(p[1][2], p[1][3]);   // row ib
                uint32_t vb[KT][4];
#pragma unroll
                for (int dk = 0; dk < KT; ++dk)
                    ldmatrix_x4_trans(vb[dk], Vs + swz<DP>(kr + arow, 2 * dk + acol));
#pragma unroll
                for (int dk = 0; dk < KT; ++dk) {
                    mma16816(o[2 * dk], pa, vb[dk][0], vb[dk][1]);
                    mma16816(o[2 * dk + 1], pa, vb[dk][2], vb[dk][3]);
                }
            };
#pragma unroll 1
            for (int kt = kt_lo; kt < kt_in_lo; ++kt) {
                float sc[2][4];
                const int kr = krow(kt);
                scores(kr, sc);
                pass2(kr, sc, mask(kt, sc));
            }
#pragma unroll 2
            for (int kt = kt_in_lo; kt < kt_in_hi; ++kt) {
                float sc[2][4];
                const int kr = krow(kt);
                scores(kr, sc);
                pass2(kr, sc, 0xffu);
            }
#pragma unroll 1
            for (int kt = kt_in_hi; kt < kt_hi; ++kt) {
                float sc[2][4];
                const int kr = krow(kt);
                scores(kr, sc);
                pass2(kr, sc, mask(kt, sc));
            }

            // the ring and q's tile are read: free them before the stores,
            // whose completion the arrival (a release) would wait for
            mbar_arrive(empty + (s & 1));
            if (LSE && c4 == 0) {
                float* lrow = a.lse + ((size_t)n * a.H + h) * a.T;
                if (ia < a.T) lrow[ia] = l_a > 0.f ? M_a * a.scale + logf(l_a) : WNEG;
                if (ib < a.T) lrow[ib] = l_b > 0.f ? M_b * a.scale + logf(l_b) : WNEG;
            }
            T* oa = static_cast<T*>(a.out) + (((size_t)n * a.T + ia) * a.H + h) * a.D;
            T* ob = oa + (size_t)8 * a.H * a.D;
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt) {
                const int d = dt * 8 + 2 * c4;
                if (d < a.D) {
                    if (ia < a.T) store2(oa + d, o[dt][0], o[dt][1]);
                    if (ib < a.T) store2(ob + d, o[dt][2], o[dt][3]);
                }
            }
        } else {
            mbar_arrive(empty + (s & 1));
        }
    }
}

template <typename T, int DP, bool LSE>
int launch_window(const Window& a, int N, cudaStream_t stream)
{
    const size_t smem = window_smem(a.ring, DP);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long grid = (long long)N * a.H * a.n_str;
    if (grid > 2147483647LL) return (int)cudaErrorInvalidValue;
    const auto kernel = window_attention_kernel<T, DP, LSE>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, WNT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, bool LSE>
int dispatch_window(const Window& a, int N, cudaStream_t stream)
{
    if (a.D <= 32) return launch_window<T, 32, LSE>(a, N, stream);
    if (a.D <= 64) return launch_window<T, 64, LSE>(a, N, stream);
    return launch_window<T, 128, LSE>(a, N, stream);
}

}  // namespace

// Kernels K and H on a stretch plan (ops/attention_cuda.py: window_plan).
// qkv [N, T, 3, H, D] and out [N, T, H, D] bf16, contiguous, at 16-byte
// addresses; cos, sin [T, r2] f32 with r2 half the rotary dim; lse [N, H,
// T] f32, or null for K. D a multiple of 8 up to 128, r2 a multiple of 8
// with 2 r2 <= D, 0 <= left < 128, 0 <= right <= 128, 1 <= t_real <= T.
// One CTA per `stretch` consecutive tiles of 64 queries of one (n, h), a
// ring of `ring` blocks of 64 keys: at least ceil(left / 64) +
// floor((63 + right) / 64) + 2.
extern "C" int fused_rotary_window_attention_stretch(
    const void* qkv, const void* cosp, const void* sinp, void* out, void* lse,
    int N, int T, int H, int D, int r2, int left, int right, int t_real,
    int stretch, int ring, int is_f32, void* stream)
{
    if (N < 1 || T < 1 || H < 1 || D < 8 || D > 128 || D % 8 || r2 < 8
        || r2 % 8 || 2 * r2 > D || left < 0 || left >= 128 || right < 0
        || right > 128 || t_real < 1 || t_real > T || stretch < 1)
        return (int)cudaErrorInvalidValue;
    Window a;
    a.qkv = qkv;
    a.cosp = static_cast<const float*>(cosp);
    a.sinp = static_cast<const float*>(sinp);
    a.out = out;
    a.lse = static_cast<float*>(lse);
    a.T = T;
    a.H = H;
    a.D = D;
    a.r2 = r2;
    a.left = left;
    a.right = right;
    a.t_real = t_real;
    a.n_qt = (T + WQ - 1) / WQ;
    a.stretch = stretch;
    a.n_str = (a.n_qt + stretch - 1) / stretch;
    a.back = (left + WQ - 1) / WQ;
    a.ahead = (WQ - 1 + right) / WQ;
    a.ring = ring;
    if (ring < a.back + a.ahead + 2) return (int)cudaErrorInvalidValue;
    a.scale = (float)(1.0 / sqrt((double)D));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_f32)
        return lse ? dispatch_window<float, true>(a, N, s)
                   : dispatch_window<float, false>(a, N, s);
    return lse ? dispatch_window<bf16, true>(a, N, s)
               : dispatch_window<bf16, false>(a, N, s);
}
