// Kernel P: the layout pin -- a row-major contiguous copy of a tensor of any
// strides, identical in every value.
//
// Replaces bonito_tpu/ops/relayout.py:pin_layout (`_copy`, `_copy_kernel`).
// On the TPU the copy is a barrier against XLA's choice of layout; here it
// does real work: a Convolution returns a [N, T, C] view of cuDNN's
// [N, C, T] output, so at the input of the transformer stack the pin is the
// [N, C, T] -> [N, T, C] transpose that every one of the stack's layers would
// otherwise pay for in its first matmul. An already contiguous input is
// copied all the same, as the TPU entry does.
//
// What bounds it on an H100: bytes, each read once and written once (the sup
// activation [128, 1000, 512] bf16: 2 x 131 MB, 0.08 ms at 3.35 TB/s; the
// f32 one of evaluate's batch, [256, 250, 512], the same).
//
// Design: the wrapper (ops/relayout.py) drops dimensions of size 1, merges
// neighbours that are contiguous with each other, and picks one of
//
//   transpose   [B, R, C] whose memory is [B, C, R] (R contiguous) where R,
//               C and the strides are whole 16-byte rows at a 16-byte
//               start: tiles of 64 x 64 elements through shared memory,
//               16-byte loads along R and 16-byte stores along C;
//   tiles       the same view at any R, C, strides and start, 2- or 4-byte
//               elements: tiles of 32 R x 256 bytes of C through padded
//               shared memory. A warp loads 32 consecutive R elements of one
//               C column (coalesced whatever the alignment), each thread 8
//               or 16 of them in flight, bf16 pairs of neighbouring columns
//               packed into one 32-bit word; 16-byte stores along C where C
//               is a multiple of 16 bytes (the output comes from
//               torch.empty), element stores otherwise; the edges
//               predicated.
//   rows        the last dimension contiguous and everything a multiple of 16
//               bytes: the gather below with 16-byte units;
//   gather      anything else, up to 8 dimensions: a thread per element (1,
//               2, 4 or 8 bytes) computes its source offset from the sizes
//               and strides; writes are coalesced, reads go as the strides
//               let them.
//
// Before the tiles, T 250 in f32 (evaluate's batch) or any T not a
// multiple of 8 in bf16 left the sup stack's input to the gather, a thread
// per element with a division a dimension, read strided by T: slower than
// Tensor.contiguous(). Where both transposes take a view, the 16-byte one
// is the faster, so it keeps those views (chip_smoke.py times all three;
// PERF.md's kernel table, row 15).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_DIMS = 8;
struct Dims {
    int nd;
    long long size[MAX_DIMS];
    long long stride[MAX_DIMS];    // in units of the element type
};

template <typename E>
__global__ void __launch_bounds__(256)
relayout_gather(const E* __restrict__ in, E* __restrict__ out, Dims d,
                long long total)
{
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         idx < total; idx += step) {
        long long rem = idx, off = 0;
        for (int k = d.nd - 1; k >= 0; --k) {
            const long long i = rem % d.size[k];
            rem /= d.size[k];
            off += i * d.stride[k];
        }
        out[idx] = in[off];
    }
}

constexpr int TS = 64;             // tile edge, in elements

// out [B, R, C] contiguous from in with element strides (sb, 1, sc). R, C,
// sb and sc are multiples of 16 / sizeof(E) and both bases 16-byte aligned,
// so every 16-byte access is whole and aligned. tile[c][r], rows padded by
// one 4-byte word.
template <typename E>
__global__ void __launch_bounds__(256)
relayout_transpose(const E* __restrict__ in, E* __restrict__ out, int R,
                   int C, long long sb, long long sc, int n_rt, int n_ct)
{
    constexpr int EPV = 16 / sizeof(E);        // elements per 16 bytes
    constexpr int CPL = TS / EPV;              // 16-byte chunks per tile line
    constexpr int PITCH = TS + 4 / sizeof(E);
    __shared__ E tile[TS][PITCH];

    const int rt = blockIdx.x % n_rt;
    const int ct = (blockIdx.x / n_rt) % n_ct;
    const long long b = blockIdx.x / (n_rt * n_ct);
    const int r0 = rt * TS, c0 = ct * TS;
    const E* src = in + b * sb;
    E* dst = out + b * (long long)R * C;

    for (int e = threadIdx.x; e < TS * CPL; e += 256) {
        const int cl = e / CPL, ch = e % CPL;
        const int c = c0 + cl, r = r0 + ch * EPV;
        if (c < C && r < R) {
            const uint4 raw = *reinterpret_cast<const uint4*>(src + c * sc + r);
            const E* pe = reinterpret_cast<const E*>(&raw);
#pragma unroll
            for (int i = 0; i < EPV; ++i) tile[cl][ch * EPV + i] = pe[i];
        }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < TS * CPL; e += 256) {
        const int rl = e / CPL, ch = e % CPL;
        const int r = r0 + rl, c = c0 + ch * EPV;
        if (r < R && c < C) {
            uint4 raw;
            E* pe = reinterpret_cast<E*>(&raw);
#pragma unroll
            for (int i = 0; i < EPV; ++i) pe[i] = tile[ch * EPV + i][rl];
            *reinterpret_cast<uint4*>(dst + (long long)r * C + c) = raw;
        }
    }
}

// The any-shape transpose: out [B, R, C] contiguous from in with element
// strides (sb, 1, sc). A tile is 32 R (a warp's lanes) by 64 words of C (64
// f32 or 128 bf16 columns: a 256-byte output row); tile[w][r] holds word w
// of row r (bf16: columns 2w and 2w + 1), rows padded to 33 words so that a
// warp's 32 lanes write 32 banks. VEC: C a multiple of 16 bytes, so every
// output row starts at a 16-byte address and each thread stores whole
// 16-byte chunks.
constexpr int TT_R = 32;           // R a tile
constexpr int TT_W = 64;           // 32-bit words of C a tile
constexpr int TT_NT = 256;

template <typename E, bool VEC>
__global__ void __launch_bounds__(TT_NT)
relayout_transpose_tiles(const E* __restrict__ in, E* __restrict__ out,
                         int R, int C, long long sb, long long sc, int n_rt,
                         int n_ct)
{
    constexpr int EPW = 4 / sizeof(E);         // elements a word
    constexpr int TC = TT_W * EPW;             // C a tile
    constexpr int WPT = TT_W / (TT_NT / 32);   // words a warp loads
    __shared__ uint32_t tile[TT_W][TT_R + 1];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int rt = blockIdx.x % n_rt;
    const int ct = (blockIdx.x / n_rt) % n_ct;
    const long long b = blockIdx.x / (n_rt * n_ct);
    const int r0 = rt * TT_R, c0 = ct * TC;
    const E* src = in + b * sb;
    E* dst = out + b * (long long)R * C;

    // every load of the thread first, then the shared stores
    const int r = r0 + lane;
    E v[WPT][EPW];
#pragma unroll
    for (int i = 0; i < WPT; ++i)
#pragma unroll
        for (int k = 0; k < EPW; ++k) {
            const int c = c0 + (warp + i * (TT_NT / 32)) * EPW + k;
            v[i][k] = r < R && c < C ? src[(long long)c * sc + r] : E(0);
        }
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
        uint32_t word;
        if constexpr (EPW == 1) {
            word = v[i][0];
        } else {
            word = (uint32_t)v[i][0] | ((uint32_t)v[i][1] << 16);
        }
        tile[warp + i * (TT_NT / 32)][lane] = word;
    }
    __syncthreads();

    if constexpr (VEC) {
        // a row's 64 words are 16 chunks of 16 bytes: 512 a tile
        for (int e = threadIdx.x; e < TT_R * (TT_W / 4); e += TT_NT) {
            const int rl = e / (TT_W / 4), ch = e % (TT_W / 4);
            const int rr = r0 + rl, c = c0 + ch * 4 * EPW;
            if (rr < R && c < C) {
                const uint4 raw = make_uint4(
                    tile[4 * ch][rl], tile[4 * ch + 1][rl],
                    tile[4 * ch + 2][rl], tile[4 * ch + 3][rl]);
                *reinterpret_cast<uint4*>(dst + (long long)rr * C + c) = raw;
            }
        }
    } else {
        for (int e = threadIdx.x; e < TT_R * TC; e += TT_NT) {
            const int rl = e / TC, cl = e % TC;
            const int rr = r0 + rl, c = c0 + cl;
            if (rr < R && c < C) {
                const uint32_t word = tile[cl / EPW][rl];
                dst[(long long)rr * C + c] =
                    (E)(EPW == 1 ? word : word >> (16 * (cl % EPW)));
            }
        }
    }
}

template <typename E>
int launch_tiles(const void* in, void* out, long long B, int R, int C,
                 long long sb, long long sc, cudaStream_t stream)
{
    constexpr int TC = TT_W * 4 / (int)sizeof(E);
    const int n_rt = (R + TT_R - 1) / TT_R, n_ct = (C + TC - 1) / TC;
    const long long blocks = B * n_rt * n_ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    const bool vec = C % (16 / (int)sizeof(E)) == 0
        && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    const auto kernel = vec ? relayout_transpose_tiles<E, true>
                            : relayout_transpose_tiles<E, false>;
    kernel<<<(unsigned)blocks, TT_NT, 0, stream>>>(
        static_cast<const E*>(in), static_cast<E*>(out), R, C, sb, sc, n_rt,
        n_ct);
    return (int)cudaGetLastError();
}

template <typename E>
int launch_gather(const void* in, void* out, const Dims& d, long long total,
                  cudaStream_t stream)
{
    const long long blocks = (total + 255) / 256;
    const unsigned grid = (unsigned)(blocks < 1048576 ? blocks : 1048576);
    relayout_gather<E><<<grid, 256, 0, stream>>>(
        static_cast<const E*>(in), static_cast<E*>(out), d, total);
    return (int)cudaGetLastError();
}

template <typename E>
int launch_transpose(const void* in, void* out, long long B, int R, int C,
                     long long sb, long long sc, cudaStream_t stream)
{
    const int n_rt = (R + TS - 1) / TS, n_ct = (C + TS - 1) / TS;
    const long long blocks = B * n_rt * n_ct;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    relayout_transpose<E><<<(unsigned)blocks, 256, 0, stream>>>(
        static_cast<const E*>(in), static_cast<E*>(out), R, C, sb, sc, n_rt,
        n_ct);
    return (int)cudaGetLastError();
}

}  // namespace

// The gather: out, contiguous, of `nd` <= 8 dimensions `sizes` from `in`
// with `strides`, both host arrays in units of `unit` bytes (1, 2, 4, 8 or
// 16; for 16 both bases are 16-byte aligned).
extern "C" int relayout_gather_any(const void* in, void* out, int nd,
                                   const long long* sizes,
                                   const long long* strides, int unit,
                                   void* stream)
{
    if (nd < 1 || nd > MAX_DIMS) return (int)cudaErrorInvalidValue;
    Dims d;
    d.nd = nd;
    long long total = 1;
    for (int k = 0; k < MAX_DIMS; ++k) {
        d.size[k] = k < nd ? sizes[k] : 1;
        d.stride[k] = k < nd ? strides[k] : 0;
        if (d.size[k] < 1) return (int)cudaErrorInvalidValue;
        total *= d.size[k];
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (unit) {
    case 1: return launch_gather<uint8_t>(in, out, d, total, s);
    case 2: return launch_gather<uint16_t>(in, out, d, total, s);
    case 4: return launch_gather<uint32_t>(in, out, d, total, s);
    case 8: return launch_gather<uint64_t>(in, out, d, total, s);
    case 16: return launch_gather<uint4>(in, out, d, total, s);
    default: return (int)cudaErrorInvalidValue;
    }
}

// The tile transpose: out [B, R, C] contiguous from in with element strides
// (sb, 1, sc), elements of `unit` = 2 or 4 bytes; R, C, sb, sc multiples of
// 16 / unit and both bases 16-byte aligned.
extern "C" int relayout_transpose_any(const void* in, void* out, long long B,
                                      int R, int C, long long sb,
                                      long long sc, int unit, void* stream)
{
    if (B < 1 || R < 1 || C < 1 || (unit != 2 && unit != 4))
        return (int)cudaErrorInvalidValue;
    const int epv = 16 / unit;
    if (R % epv || C % epv || sb % epv || sc % epv
        || reinterpret_cast<uintptr_t>(in) % 16
        || reinterpret_cast<uintptr_t>(out) % 16)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return unit == 2
        ? launch_transpose<uint16_t>(in, out, B, R, C, sb, sc, s)
        : launch_transpose<uint32_t>(in, out, B, R, C, sb, sc, s);
}

// The any-shape transpose: out [B, R, C] contiguous from in with element
// strides (sb, 1, sc), elements of `unit` = 2 or 4 bytes, any R, C, sb, sc
// and start (the elements' own alignment).
extern "C" int relayout_transpose_tiles_any(const void* in, void* out,
                                            long long B, int R, int C,
                                            long long sb, long long sc,
                                            int unit, void* stream)
{
    if (B < 1 || R < 1 || C < 1 || sb < 0 || sc < 0
        || (unit != 2 && unit != 4)
        || reinterpret_cast<uintptr_t>(in) % unit)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    return unit == 2
        ? launch_tiles<uint16_t>(in, out, B, R, C, sb, sc, s)
        : launch_tiles<uint32_t>(in, out, B, R, C, sb, sc, s);
}
