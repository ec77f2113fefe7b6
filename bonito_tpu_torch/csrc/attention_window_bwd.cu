// Kernel O for the H100: the backward of kernel H, the rotary + banded
// attention of a sup train step, with both windows staged once per stretch.
//
// O, fused_rotary_window_attention_bwd, replaces
// bonito_tpu/ops/attention_pallas.py:fused_rotary_window_attention_train's
// backward (`_fused_bwd_kernel_dt`). From qkv [N, T, 3, H, D] bf16, cos/sin
// [T, r2] f32, H's lse [N, H, T] f32 and o [N, T, H, D] bf16, and o's
// cotangent do [N, T, H, D] bf16, to dqkv [N, T, 3, H, D] bf16, rounding where
// the TPU kernel and csrc/attention.cu's earlier kernel round:
//
//     q, k  = bf16(rotary(f32(q)), rotary(f32(k)))   as in K
//     p     = exp(s / sqrt(D) - lse), 0 where masked  s = q . k, f32 sums
//     dp    = bf16(do) . bf16(v)                      f32 sums
//     Di    = sum_d do o                              f32, o as stored
//     ds    = bf16(p (dp - Di) / sqrt(D))             each step rounded
//     dq    = rotary^-1(ds . k)                       f32, by -theta
//     dk    = rotary^-1(ds^T . q)
//     dv    = bf16(p)^T . do
//
// Query i sees key j iff -left <= j - i <= right and j < t_real; a key at or
// beyond t_real is seen by no query, and its dk and dv are 0.
//
// What bounds it on an H100: at sup training shapes (N 32, T 1024, 8 heads of
// 64, window (127, 128)) the bytes, 0.08 ms (qkv, o, do and lse in, dqkv
// out), against five band products, 43 GFLOP (0.04 ms on the tensor cores),
// and an exp a visible pair. What sets its pace is the consumers' work: this
// design computes s and dp in each of its two kinds of CTA and s once more
// (below), so a visible pair costs eight products on mma.sync and three
// exps (scripts/attention_split.py o leaves each part out).
//
// Design. CUDA blocks run in no order, so O splits the work by what each CTA
// writes -- no atomics, and every sum in a fixed order -- into two kinds of
// stretch CTA in one launch, the dk kind first (its tiles are the heavier):
//   dq kind   walks `stretch` consecutive 64-query tiles of one (n, h) and
//             keeps K's ring of key blocks (k rotated, v as it is): tile t
//             sees blocks t - back .. t + ahead, back = ceil(left / 64),
//             ahead = ceil(right / 64). Per tile: s, dp, ds and dq += ds . k.
//   dk kind   walks consecutive 64-key tiles and keeps a ring of query blocks
//             (q rotated, do) over the mirrored band: key j is seen by
//             queries j - right .. j + left, so back = ceil(right / 64),
//             ahead = ceil(left / 64). Per tile two walks over the band:
//             s^T = k . q, dp^T = v . do, ds^T and dk += ds^T . q, rotated
//             back and stored; then s^T and p again and dv += bf16(p)^T . do.
//             One walk holds k's and v's fragments and both sums at once,
//             96 registers at D 64 beside the rest, and spilled (as the
//             earlier kernel has a stack frame); two walks hold 64, for one
//             more product and exp a pair.
// Both kinds read each query's lse and Di from one [N, H, Tp] buffer of f32
// pairs that a row pass (window_bwd_rows_kernel, launched first) fills: Di
// summed once in the earlier kernel's order, so both kinds see its same
// bits, and (0, 0) beyond T, so that no read needs a bound. The ring is
// ring = back + ahead + 2 blocks, so the producers stage a tile ahead; the
// tile's own rows (q and do, or k and v) sit in one buffer that the
// consumers copy into registers as mma.sync A fragments when the tile starts
// and free at once (mbarrier `afree`), so the producers refill it while the
// consumers compute: 112 KB at D 64 and the sup window, two CTAs an SM.
// All six warps stage a stretch's first tile and its leading window; then
// two producer warps copy (cp.async), rotate in place once a row (two chunk
// pairs a batch: K's four spilled here) and zero the dead rows of the next
// tile and its one new block, handing over through the mbarriers `full` and
// `empty`, while four consumer warps own 16 tile rows each and walk the
// band in tiles of 16 columns: s and dp with the ring
// rows as B (ldmatrix), ds and p left in the accumulators' A-operand layout,
// the dq, dk and dv products with the ring rows through ldmatrix.trans. The
// masks are evaluated only on the band's edge tiles; the dk kind loads its
// columns' (lse, Di) a tile ahead; the rotation back by -theta runs on the
// accumulators at a compile-time pair distance.

#include "attention_window.cuh"

namespace {

struct WindowBwd {
    const bf16* qkv;
    const float* cosp;
    const float* sinp;
    const float* lse;
    const bf16* o;
    const bf16* dout;
    float2* rows;       // [N, H, Tp]: each query's (lse, Di)
    bf16* dqkv;
    int N, T, H, D, r2, left, right, t_real;
    int n_tiles, Tp, stretch, n_str, ring;
    float scale;
};

__host__ __device__ inline size_t window_bwd_smem(int ring, int dp) {
    return (size_t)(2 * ring + 2) * WQ * dp * sizeof(bf16) + 6 * sizeof(uint64_t);
}

constexpr int RP_THREADS = 256;     // the row pass: 8 lanes a query
constexpr int RB = 2;               // chunk pairs a producer rotates a batch

// The row pass: rows[n, h, i] = (lse[n, h, i], Di) with Di = sum_d do o in
// f32, 8 lanes a row, lane l8 over the chunks l8, l8 + 8, ... of 8 elements,
// then a tree over the 8 lanes: the order of csrc/attention.cu's earlier
// kernel. (0, 0) for T <= i < Tp.
__global__ void __launch_bounds__(RP_THREADS)
window_bwd_rows_kernel(const WindowBwd a)
{
    const long long row = ((long long)blockIdx.x * RP_THREADS + threadIdx.x) >> 3;
    const int l8 = threadIdx.x & 7;
    // N H Tp is a multiple of 64, so each warp is in or out as a whole
    if (row >= (long long)a.N * a.H * a.Tp) return;
    const int i = (int)(row % a.Tp);
    const int nh = (int)(row / a.Tp);
    const int n = nh / a.H, h = nh % a.H;
    const bool live = i < a.T;
    float acc = 0.f;
    if (live) {
        const size_t off = (((size_t)n * a.T + i) * a.H + h) * a.D;
        for (int d0 = l8 * 8; d0 < a.D; d0 += 64) {
            const uint4 x = *reinterpret_cast<const uint4*>(a.dout + off + d0);
            const uint4 y = *reinterpret_cast<const uint4*>(a.o + off + d0);
            const __nv_bfloat162* hx = reinterpret_cast<const __nv_bfloat162*>(&x);
            const __nv_bfloat162* hy = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const float2 fx = __bfloat1622float2(hx[k]);
                const float2 fy = __bfloat1622float2(hy[k]);
                acc = fmaf(fx.x, fy.x, acc);
                acc = fmaf(fx.y, fy.y, acc);
            }
        }
    }
#pragma unroll
    for (int d = 1; d <= 4; d <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, d);
    if (l8 == 0)
        a.rows[row] = live ? make_float2(a.lse[(size_t)nh * a.T + i], acc)
                           : make_float2(0.f, 0.f);
}

// where a kind's rows come from: the tile's rotated rows (q or k) and plain
// rows (do or v), the ring's rotated rows (k or q) and plain rows (v or do),
// each with its token stride; the tokens below which the tile's rows
// (live_a) and the ring's (live_r) hold data
struct Sources {
    const bf16* ar;
    const bf16* ap;
    const bf16* rr;
    const bf16* rp;
    size_t sar, sap, srr, srp;
    int live_a, live_r;
};

// a step's copies, by thread i of n: the tile's rows a0 .. a0 + 63 and the
// ring blocks b_lo .. b_hi, 16 bytes each by cp.async;
// zeros for a dead row; the padding beyond D stays as it is (zero)
template <int DP>
__device__ __forceinline__ void stage_bwd(const Sources& src, int D, int ring,
                                          bf16* AR, bf16* AP, bf16* Rs,
                                          bf16* Ps, int a0, int b_lo,
                                          int b_hi, int i, int n) {
    constexpr int CH = DP / 8;
    const int chd = D / 8;
    for (int e = i; e < WQ * CH; e += n) {
        const int r = e / CH, c = e % CH;
        if (c >= chd) continue;
        const int tok = a0 + r;
        bf16* dr = AR + swz<DP>(r, c);
        bf16* dp = AP + swz<DP>(r, c);
        if (tok < src.live_a) {
            cp_async16(dr, src.ar + (size_t)tok * src.sar + c * 8);
            cp_async16(dp, src.ap + (size_t)tok * src.sap + c * 8);
        } else {
            zero16(dr);
            zero16(dp);
        }
    }
    for (int b = b_lo; b <= b_hi; ++b) {
        const int off = (b % ring) * WQ * DP;
        for (int e = i; e < WQ * CH; e += n) {
            const int r = e / CH, c = e % CH;
            if (c >= chd) continue;
            const int tok = b * WQ + r;
            bf16* dr = Rs + off + swz<DP>(r, c);
            bf16* dp = Ps + off + swz<DP>(r, c);
            if (tok < src.live_r) {
                cp_async16(dr, src.rr + (size_t)tok * src.srr + c * 8);
                cp_async16(dp, src.rp + (size_t)tok * src.srp + c * 8);
            } else {
                zero16(dr);
                zero16(dp);
            }
        }
    }
}

// acc [2 KT][4] (the columns of two rows, ia for entries 0, 1 and ib for 2,
// 3) rotated back by -theta at the rows' tokens, in f32 with every product
// and sum rounded on its own: element d < r2 pairs with d + r2, which the
// same thread holds R8 = r2 / 8 column tiles further on
template <int NT8, int R8>
__device__ __forceinline__ void rotate_back_at(float (&acc)[NT8][4],
                                               const float* cosp,
                                               const float* sinp, int r2,
                                               int ia, int ib, int T, int c4) {
#pragma unroll
    for (int dt = 0; dt < R8; ++dt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int tk = half ? ib : ia;
            if (tk >= T) continue;
            const size_t at = (size_t)tk * r2 + dt * 8 + 2 * c4;
            const float2 cc = __ldg(reinterpret_cast<const float2*>(cosp + at));
            const float2 ss = __ldg(reinterpret_cast<const float2*>(sinp + at));
#pragma unroll
            for (int m = 0; m < 2; ++m) {
                const int e = 2 * half + m;
                const float cv = m ? cc.y : cc.x, sv = m ? ss.y : ss.x;
                const float x1 = acc[dt][e], x2 = acc[dt + R8][e];
                acc[dt][e] = __fadd_rn(__fmul_rn(x1, cv), __fmul_rn(x2, sv));
                acc[dt + R8][e] = __fsub_rn(__fmul_rn(x2, cv),
                                            __fmul_rn(x1, sv));
            }
        }
    }
}

template <int NT8>
__device__ __forceinline__ void rotate_back(float (&acc)[NT8][4],
                                            const float* cosp,
                                            const float* sinp, int r2, int ia,
                                            int ib, int T, int c4) {
    // 2 r2 <= D <= DP, so r2 / 8 is 1 .. NT8 / 2
    switch (r2 / 8) {
    case 1: rotate_back_at<NT8, 1>(acc, cosp, sinp, r2, ia, ib, T, c4); break;
    case 2: rotate_back_at<NT8, 2>(acc, cosp, sinp, r2, ia, ib, T, c4); break;
    case 3:
        if constexpr (NT8 >= 6)
            rotate_back_at<NT8, 3>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    case 4:
        if constexpr (NT8 >= 8)
            rotate_back_at<NT8, 4>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    case 5:
        if constexpr (NT8 >= 10)
            rotate_back_at<NT8, 5>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    case 6:
        if constexpr (NT8 >= 12)
            rotate_back_at<NT8, 6>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    case 7:
        if constexpr (NT8 >= 14)
            rotate_back_at<NT8, 7>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    default:
        if constexpr (NT8 >= 16)
            rotate_back_at<NT8, 8>(acc, cosp, sinp, r2, ia, ib, T, c4);
        break;
    }
}

// the rows ia and ib (those below T) of one output of dqkv from acc, or zeros
// for a row at or beyond `zero_from`
template <int NT8>
__device__ __forceinline__ void store_rows(bf16* base, size_t ts,
                                           const float (&acc)[NT8][4], int ia,
                                           int ib, int T, int D, int zero_from,
                                           int c4) {
#pragma unroll
    for (int dt = 0; dt < NT8; ++dt) {
        const int d = dt * 8 + 2 * c4;
        if (d >= D) continue;
        if (ia < T)
            *reinterpret_cast<__nv_bfloat162*>(base + (size_t)ia * ts + d) =
                ia < zero_from ? __floats2bfloat162_rn(acc[dt][0], acc[dt][1])
                               : __floats2bfloat162_rn(0.f, 0.f);
        if (ib < T)
            *reinterpret_cast<__nv_bfloat162*>(base + (size_t)ib * ts + d) =
                ib < zero_from ? __floats2bfloat162_rn(acc[dt][2], acc[dt][3])
                               : __floats2bfloat162_rn(0.f, 0.f);
    }
}

// A product issued where it stands (volatile, unlike mma16816): O's
// products keep program order, each one's operand loads first, so that the
// compiler does not hoist later loads above them (its own order spilled at
// D 128)
__device__ __forceinline__ void mma16816_seq(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1)
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[nt][e] += the products of a warp's A fragments (16 rows, all of DP) with
// the 16 ring rows from rr on: columns 8 nt + 2 c4 (+ 1 for odd e) of rows g
// (e 0, 1) and g + 8 (e 2, 3)
template <int DP>
__device__ __forceinline__ void row_products(float (&c)[2][4],
                                             const uint32_t (&af)[DP / 16][4],
                                             const bf16* R, int rr, int brow,
                                             int bcol) {
    constexpr int KT = DP / 16;
    uint32_t b[KT][4];
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
        ldmatrix_x4(b[kk], R + swz<DP>(rr + brow, 2 * kk + bcol));
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
        mma16816_seq(c[0], af[kk], b[kk][0], b[kk][1]);
        mma16816_seq(c[1], af[kk], b[kk][2], b[kk][3]);
    }
}

// acc += x . (the 16 ring rows from rr on), x a 16 x 16 A fragment (rows of
// the tile, columns the ring rows): B through ldmatrix.trans
template <int DP>
__device__ __forceinline__ void col_products(float (&acc)[DP / 8][4],
                                             const uint32_t (&x)[4],
                                             const bf16* R, int rr, int arow,
                                             int acol) {
    constexpr int KT = DP / 16;
    uint32_t b[KT][4];
#pragma unroll
    for (int dk = 0; dk < KT; ++dk)
        ldmatrix_x4_trans(b[dk], R + swz<DP>(rr + arow, 2 * dk + acol));
#pragma unroll
    for (int dk = 0; dk < KT; ++dk) {
        mma16816_seq(acc[2 * dk], x, b[dk][0], b[dk][1]);
        mma16816_seq(acc[2 * dk + 1], x, b[dk][2], b[dk][3]);
    }
}

// ds = bf16(p (dp - Di) / sqrt(D)), rounded step by step as the plain
// version, and p, both packed into the A-operand layout of the next product
// (row g: keys / queries 2 c4, 2 c4 + 1 and 8 + 2 c4, ...; row g + 8 the same)
__device__ __forceinline__ void pack_ds(const float (&p)[2][4],
                                        const float (&dp)[2][4],
                                        const float (&di)[2][4], float scale,
                                        uint32_t (&da)[4]) {
    float ds[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            ds[nt][e] = __fmul_rn(__fmul_rn(p[nt][e], __fsub_rn(dp[nt][e],
                                                                di[nt][e])),
                                  scale);
    da[0] = pack2(ds[0][0], ds[0][1]);
    da[1] = pack2(ds[0][2], ds[0][3]);
    da[2] = pack2(ds[1][0], ds[1][1]);
    da[3] = pack2(ds[1][2], ds[1][3]);
}

__device__ __forceinline__ void pack_p(const float (&p)[2][4],
                                       uint32_t (&pa)[4]) {
    pa[0] = pack2(p[0][0], p[0][1]);
    pa[1] = pack2(p[0][2], p[0][3]);
    pa[2] = pack2(p[1][0], p[1][1]);
    pa[3] = pack2(p[1][2], p[1][3]);
}

// DP: the head dim padded to 32, 64 or 128 (zeros beyond D).
template <int DP>
__global__ void __launch_bounds__(WNT, DP <= 64 ? 2 : 1)
window_attention_bwd_kernel(const WindowBwd a)
{
    constexpr int KT = DP / 16;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Rs = reinterpret_cast<bf16*>(smem_raw);   // [ring][WQ][DP] k or q, rotated
    bf16* Ps = Rs + (size_t)a.ring * WQ * DP;       // [ring][WQ][DP] v or do
    bf16* AR = Ps + (size_t)a.ring * WQ * DP;       // [WQ][DP] q or k, rotated
    bf16* AP = AR + WQ * DP;                        // [WQ][DP] do or v
    uint64_t* full = reinterpret_cast<uint64_t*>(AP + WQ * DP);
    uint64_t* empty = full + 2;
    uint64_t* afree = full + 4;

    const int tid = threadIdx.x;
    const int per_kind = gridDim.x / 2;
    const bool dk_kind = (int)blockIdx.x < per_kind;  // the dk kind first
    const int cta = dk_kind ? blockIdx.x : blockIdx.x - per_kind;
    // each kind's CTAs by stretch: every (n, h)'s first, then every second,
    // ..., so that the shorter last stretches start last
    const int pairs = a.N * a.H;
    const int pair = cta % pairs;
    const int t_a = (cta / pairs) * a.stretch;      // the first tile
    const int n = pair / a.H, h = pair % a.H;
    const int steps = min(a.stretch, a.n_tiles - t_a);
    const size_t ts = (size_t)3 * a.H * a.D, hd = (size_t)a.H * a.D;
    const bf16* qkv = a.qkv + (size_t)n * a.T * ts + (size_t)h * a.D;
    const bf16* dout = a.dout + (size_t)n * a.T * hd + (size_t)h * a.D;
    // blocks of 64 a band reaches to the left and to the right
    const int wl = (a.left + WQ - 1) / WQ, wr = (a.right + WQ - 1) / WQ;
    const int back = dk_kind ? wr : wl, ahead = dk_kind ? wl : wr;
    Sources src;
    src.ar = dk_kind ? qkv + hd : qkv;
    src.ap = dk_kind ? qkv + 2 * hd : dout;
    src.rr = dk_kind ? qkv : qkv + hd;
    src.rp = dk_kind ? dout : qkv + 2 * hd;
    src.sar = ts;
    src.sap = dk_kind ? ts : hd;
    src.srr = ts;
    src.srp = dk_kind ? hd : ts;
    src.live_a = a.T;
    src.live_r = dk_kind ? a.T : a.t_real;
    const RotView rv = {a.cosp, a.sinp, a.r2, a.ring, src.live_a, src.live_r};
    const int nb = (src.live_r + WQ - 1) / WQ;      // ring blocks with data

    // zeros everywhere first: the padding beyond D stays zero, and a slot
    // that is never filled is never read
    {
        uint4* p = reinterpret_cast<uint4*>(smem_raw);
        const int n16 = (2 * a.ring + 2) * WQ * DP / 8;
        for (int i = tid; i < n16; i += WNT) p[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    if (tid == 0) {
        for (int k = 0; k < 2; ++k) {
            mbar_init(full + k, WPW * 32);
            mbar_init(empty + k, WCW * 32);
            mbar_init(afree + k, WCW * 32);
        }
    }
    __syncthreads();

    // the stretch's first tile, by all the warps: its rows and the leading
    // window (blocks t_a - back .. t_a + ahead), copied and rotated before
    // the warps take their roles; the producers' arrival completes its phase
    {
        const int b_lo = max(t_a - back, 0), b_hi = min(t_a + ahead, nb - 1);
        const int items = Rotary<DP, WNT, RB>::TILE * (1 + max(b_hi - b_lo + 1, 0));
        stage_bwd<DP>(src, a.D, a.ring, AR, AP, Rs, Ps, t_a * WQ, b_lo, b_hi,
                      tid, WNT);
        cp_async_commit();
        Rotary<DP, WNT, RB>().run(rv, AR, Rs, t_a * WQ, b_lo, items, tid, [] {
            cp_async_wait(0);
            __syncthreads();
        });
        __syncthreads();
    }

    if (tid >= WCW * 32) {
        // ------------------------------------------------------------ producers
        constexpr int PT = WPW * 32;
        const int pt = tid - WCW * 32;
        mbar_arrive(full);                          // the first tile: staged
        for (int s = 1; s < steps; ++s) {
            const int t = t_a + s;
            // the consumers hold the tile before in registers ...
            mbar_wait(afree + ((s - 1) & 1), (unsigned)(((s - 1) >> 1) & 1));
            // ... and the slot of the new block was last read two tiles back
            if (s >= 2) mbar_wait(empty + (s & 1), (unsigned)(((s >> 1) + 1) & 1));
            // the one block that enters the band
            const int b = t + ahead < nb ? t + ahead : nb;
            const int items = Rotary<DP, PT, RB>::TILE * (b < nb ? 2 : 1);
            stage_bwd<DP>(src, a.D, a.ring, AR, AP, Rs, Ps, t * WQ, b,
                          b < nb ? b : b - 1, pt, PT);
            cp_async_commit();
            Rotary<DP, PT, RB>().run(rv, AR, Rs, t * WQ, b, items, pt, [] {
                cp_async_wait(0);
                asm volatile("bar.sync 1, %0;\n" :: "n"(PT) : "memory");
            });
            mbar_arrive(full + (s & 1));
        }
        return;
    }

    // ---------------------------------------------------------------- consumers
    const int w = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, c4 = lane & 3;
    const int r0 = w * 16;
    const float c2 = a.scale * WLOG2E;
    const int arow = (lane & 7) + ((lane >> 3) & 1) * 8;  // ldmatrix of A, trans
    const int acol = lane >> 4;
    const int brow = (lane & 7) + (lane >> 4) * 8;        // ldmatrix of B rows
    const int bcol = (lane >> 3) & 1;
    const float2* rows = a.rows + (size_t)pair * a.Tp;
    bf16* dbase = a.dqkv + (size_t)n * a.T * ts + (size_t)h * a.D;

    for (int s = 0; s < steps; ++s) {
        const int t0 = (t_a + s) * WQ;
        const int row0 = t0 + r0;                         // the warp's first
        const int ia = row0 + g, ib = ia + 8;             // the thread's rows
        mbar_wait(full + (s & 1), (unsigned)((s >> 1) & 1));
        // the tile's rows as A fragments: q and do, or k and v
        uint32_t f1[KT][4], f2[KT][4];
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
            ldmatrix_x4(f1[kt], AR + swz<DP>(r0 + arow, 2 * kt + acol));
            ldmatrix_x4(f2[kt], AP + swz<DP>(r0 + arow, 2 * kt + acol));
        }
        mbar_arrive(afree + (s & 1));
        // the tiles of 16 columns the warp's rows see: c_lo .. c_hi - 1,
        // the ones that all 16 rows see whole c_in_lo .. c_in_hi - 1 (no
        // mask, no branch between them), the edge tiles before and after
        int c_lo = 0, c_hi = 0, c_in_lo = 0, c_in_hi = 0;
        if (!dk_kind && row0 < a.T) {
            const int row_last = min(row0 + 15, a.T - 1);
            const int j_lo = max(0, row0 - a.left);
            const int j_hi = min(a.t_real, row_last + a.right + 1);
            c_lo = j_lo >> 4;
            c_hi = j_hi > j_lo ? (j_hi + 15) >> 4 : c_lo;
            c_in_lo = min(max(c_lo, (row0 + 15 - a.left + 15) >> 4), c_hi);
            c_in_hi = max(c_in_lo, min(c_hi, min(row0 + a.right + 1,
                                                 a.t_real) >> 4));
        } else if (dk_kind && row0 < a.t_real) {
            // keys at or beyond t_real are seen by no query
            const int key_last = min(row0 + 15, a.t_real - 1);
            const int i_lo = max(0, row0 - a.right);
            const int i_hi = min(a.T, key_last + a.left + 1);
            c_lo = i_lo >> 4;
            c_hi = i_hi > i_lo ? (i_hi + 15) >> 4 : c_lo;
            c_in_lo = min(max(c_lo, (row0 + 15 - a.right + 15) >> 4), c_hi);
            c_in_hi = max(c_in_lo, min(c_hi, min(row0 + a.left + 1,
                                                 a.T) >> 4));
        }
        const int blk0 = c_lo >> 2, slot0 = blk0 % a.ring;
        // the ring row of the tile of 16 columns at 16 c
        auto crow = [&](int c) {
            int sl = slot0 + (c >> 2) - blk0;
            sl -= sl >= a.ring ? a.ring : 0;
            return sl * WQ + (c & 3) * 16;
        };

        if (!dk_kind) {
            // ------------------------------------------------------ dq kind
            float acc[2 * KT][4];
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
            // the rows' lse (as -lse log2 e) and Di: (0, 0) beyond T
            const float2 qa = rows[ia], qb = rows[ib];
            const float nla = -qa.x * WLOG2E, nlb = -qb.x * WLOG2E;
            float di[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) di[nt][e] = e < 2 ? qa.y : qb.y;
            auto tile = [&](int c, bool edge) {
                const int cr = crow(c);
                float sc[2][4] = {}, dp[2][4] = {};
                row_products<DP>(sc, f1, Rs, cr, brow, bcol);  // q . k
                row_products<DP>(dp, f2, Ps, cr, brow, bcol);  // do . v
                float p[2][4];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int j = c * 16 + nt * 8 + 2 * c4 + (e & 1);
                        const int d = j - (e < 2 ? ia : ib);
                        const bool ok = !edge || (d >= -a.left && d <= a.right
                                                  && j < a.t_real);
                        p[nt][e] = ok ? ex2(fmaf(sc[nt][e], c2,
                                                 e < 2 ? nla : nlb))
                                      : 0.f;
                    }
                uint32_t da[4];
                pack_ds(p, dp, di, a.scale, da);
                col_products<DP>(acc, da, Rs, cr, arow, acol);  // ds . k
            };
#pragma unroll 1
            for (int c = c_lo; c < c_in_lo; ++c) tile(c, true);
#pragma unroll 1
            for (int c = c_in_lo; c < c_in_hi; ++c) tile(c, false);
#pragma unroll 1
            for (int c = c_in_hi; c < c_hi; ++c) tile(c, true);
            // the ring is read: free it before the stores
            mbar_arrive(empty + (s & 1));
            if (row0 < a.T) {
                rotate_back<2 * KT>(acc, a.cosp, a.sinp, a.r2, ia, ib, a.T, c4);
                store_rows<2 * KT>(dbase, ts, acc, ia, ib, a.T, a.D, a.T, c4);
            }
        } else {
            // ------------------------------------------------------ dk kind
            // two walks over the band: dk (s^T, dp^T, ds^T . q), rotated and
            // stored, then dv (s^T again, bf16(p)^T . do) in the same sums,
            // so that at most 64 registers of fragments and sums are live
            // (96 in one walk spilled: k's and v's fragments, dk and dv)
            float acc[2 * KT][4];
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
            // the (lse, Di) pairs of a tile's 16 queries (the thread's
            // columns), loaded a tile ahead so that their latency hides
            // behind a tile's products: (0, 0) beyond T
            float4 next[2];
            auto fetch = [&](int c) {
                const int cc = max(min(c, c_hi - 1), 0);
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
                    next[nt] = __ldg(reinterpret_cast<const float4*>(
                        rows + cc * 16 + nt * 8 + 2 * c4));
            };
            // s^T = k . q and p = exp(s / sqrt(D) - lse) of the tile of 16
            // queries at 16 c, and the queries' Di
            auto probs = [&](int c, bool edge, int cr, float (&p)[2][4],
                             float (&di)[2][4]) {
                const float4 cur[2] = {next[0], next[1]};
                fetch(c + 1);
                float sc[2][4] = {};
                row_products<DP>(sc, f1, Rs, cr, brow, bcol);
                float nl[2][2];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                    const float4 q2 = cur[nt];
                    nl[nt][0] = -q2.x * WLOG2E;
                    nl[nt][1] = -q2.z * WLOG2E;
                    di[nt][0] = di[nt][2] = q2.y;
                    di[nt][1] = di[nt][3] = q2.w;
                }
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        const int i = c * 16 + nt * 8 + 2 * c4 + (e & 1);
                        const int j = e < 2 ? ia : ib;
                        const int d = j - i;
                        const bool ok = !edge || (d >= -a.left && d <= a.right
                                                  && i < a.T && j < a.t_real);
                        p[nt][e] = ok ? ex2(fmaf(sc[nt][e], c2, nl[nt][e & 1]))
                                      : 0.f;
                    }
            };
            auto tile_dk = [&](int c, bool edge) {
                const int cr = crow(c);
                float p[2][4], di[2][4], dp[2][4] = {};
                probs(c, edge, cr, p, di);
                row_products<DP>(dp, f2, Ps, cr, brow, bcol);  // v . do
                uint32_t da[4];
                pack_ds(p, dp, di, a.scale, da);
                col_products<DP>(acc, da, Rs, cr, arow, acol); // ds^T . q
            };
            auto tile_dv = [&](int c, bool edge) {
                const int cr = crow(c);
                float p[2][4], di[2][4];
                probs(c, edge, cr, p, di);
                uint32_t pa[4];
                pack_p(p, pa);
                col_products<DP>(acc, pa, Ps, cr, arow, acol); // p^T . do
            };
            fetch(c_lo);
#pragma unroll 1
            for (int c = c_lo; c < c_in_lo; ++c) tile_dk(c, true);
#pragma unroll 1
            for (int c = c_in_lo; c < c_in_hi; ++c) tile_dk(c, false);
#pragma unroll 1
            for (int c = c_in_hi; c < c_hi; ++c) tile_dk(c, true);
            if (row0 < a.T) {
                rotate_back<2 * KT>(acc, a.cosp, a.sinp, a.r2, ia, ib, a.T, c4);
                store_rows<2 * KT>(dbase + hd, ts, acc, ia, ib, a.T, a.D,
                                   a.t_real, c4);
            }
#pragma unroll
            for (int dt = 0; dt < 2 * KT; ++dt)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;
            fetch(c_lo);
#pragma unroll 1
            for (int c = c_lo; c < c_in_lo; ++c) tile_dv(c, true);
#pragma unroll 1
            for (int c = c_in_lo; c < c_in_hi; ++c) tile_dv(c, false);
#pragma unroll 1
            for (int c = c_in_hi; c < c_hi; ++c) tile_dv(c, true);
            mbar_arrive(empty + (s & 1));
            if (row0 < a.T)
                store_rows<2 * KT>(dbase + 2 * hd, ts, acc, ia, ib, a.T, a.D,
                                   a.t_real, c4);
        }
    }
}

template <int DP>
int launch_window_bwd(const WindowBwd& a, cudaStream_t stream)
{
    const size_t smem = window_bwd_smem(a.ring, DP);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const long long grid = 2LL * a.N * a.H * a.n_str;
    const long long row_blocks = ((long long)a.N * a.H * a.Tp * 8 + RP_THREADS - 1)
        / RP_THREADS;
    if (grid > 2147483647LL || row_blocks > 2147483647LL)
        return (int)cudaErrorInvalidValue;
    window_bwd_rows_kernel<<<(unsigned)row_blocks, RP_THREADS, 0, stream>>>(a);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const auto kernel = window_attention_bwd_kernel<DP>;
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)grid, WNT, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// Kernel O on a stretch plan (ops/attention_cuda.py: window_bwd_plan). qkv
// [N, T, 3, H, D], o and dout [N, T, H, D] and dqkv [N, T, 3, H, D] bf16,
// contiguous, at 16-byte addresses; cos, sin [T, r2] f32 with r2 half the
// rotary dim; lse [N, H, T] f32 as H wrote it; rows, scratch of [N, H, Tp]
// f32 pairs with Tp = 64 ceil(T / 64), at a 16-byte address. D a multiple of
// 8 up to 128, r2 a multiple of 8 with 2 r2 <= D, 0 <= left < 128,
// 0 <= right <= 128, 1 <= t_real <= T. Two launches: the row pass, then one
// CTA per `stretch` consecutive tiles of 64 tokens of one (n, h) and kind,
// with a ring of `ring` blocks of 64 rows: at least ceil(left / 64) +
// ceil(right / 64) + 2.
extern "C" int fused_rotary_window_attention_bwd_stretch(
    const void* qkv, const void* cosp, const void* sinp, const void* lse,
    const void* o, const void* dout, void* rows, void* dqkv, int N, int T,
    int H, int D, int r2, int left, int right, int t_real, int stretch,
    int ring, void* stream)
{
    if (N < 1 || T < 1 || H < 1 || D < 8 || D > 128 || D % 8 || r2 < 8
        || r2 % 8 || 2 * r2 > D || left < 0 || left >= 128 || right < 0
        || right > 128 || t_real < 1 || t_real > T || stretch < 1)
        return (int)cudaErrorInvalidValue;
    WindowBwd a;
    a.qkv = static_cast<const bf16*>(qkv);
    a.cosp = static_cast<const float*>(cosp);
    a.sinp = static_cast<const float*>(sinp);
    a.lse = static_cast<const float*>(lse);
    a.o = static_cast<const bf16*>(o);
    a.dout = static_cast<const bf16*>(dout);
    a.rows = static_cast<float2*>(rows);
    a.dqkv = static_cast<bf16*>(dqkv);
    a.N = N;
    a.T = T;
    a.H = H;
    a.D = D;
    a.r2 = r2;
    a.left = left;
    a.right = right;
    a.t_real = t_real;
    a.n_tiles = (T + WQ - 1) / WQ;
    a.Tp = a.n_tiles * WQ;
    a.stretch = stretch;
    a.n_str = (a.n_tiles + stretch - 1) / stretch;
    a.ring = ring;
    if (ring < (left + WQ - 1) / WQ + (right + WQ - 1) / WQ + 2)
        return (int)cudaErrorInvalidValue;
    a.scale = (float)(1.0 / sqrt((double)D));
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (D <= 32) return launch_window_bwd<32>(a, s);
    if (D <= 64) return launch_window_bwd<64>(a, s);
    return launch_window_bwd<128>(a, s);
}
