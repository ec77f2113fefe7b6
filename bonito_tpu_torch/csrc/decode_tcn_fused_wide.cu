// The earlier kernels GW and JW: the two-pass Viterbi + posterior CRF
// decode with the CRF head inside, for the wide state spaces (512 and 1024
// states: hac and sup through head_route="fused"). GW and JW now take the
// head product once for the batch (csrc/head_product.cu) and run both
// passes over its f32 moves on the ring of kernels B and C
// (csrc/decode_tcn_ring.cu); these stay for the shapes
// ops/decode_fused_cuda.py:wide_decode_plan gives no plan, and as what
// chip_smoke.py and the card tests hold the new pair against bit for bit.
//
// Replace bonito_tpu/ops/decode_pallas.py:viterbi_decode_tcn_fused above
// 256 states -- GW is `_fwd_kernel_tcn_fused` (forward pass), JW is
// `_bwd_kernel_tcn_fused` (backward pass) with that function's qscore
// epilogue, and both hold `_head_mv`. Kernels G and J
// (decode_tcn_fused.cu) take S <= 256; their block of 4 rows x S states
// stops there.
//
// Input and output are G's and J's: h [T/U, N, H] bf16, the head's folded
// weights [U, nb*S, H] bf16 with a bias [U, nb*S] f32, and output frame
// t = th*U + p takes phase p of encoder frame th:
//
//     mv = clip(scale * tanh?(w[p] @ h[th] + bias[p]))        (f32)
//
// in `_head_mv`'s order (bias, tanh, scale, clamp). Both passes compute mv
// themselves, so the [T, nb*S, N] move tensor is never written to device
// memory and never rounded to bf16. From mv on each frame is one step of
// decode_passes.cuh (fwd_frame, bwd_frame): kernels B's and C's f32 steps,
// in their order.
//
// What bounds them on an H100: at hac (N 96, T 1666, H 1024, S 1024) each
// pass does 2*N*T*H*nb*S = 1.34e12 operations of head product (1.36 ms on
// the bf16 tensor cores, 20 ms on the f32 cores at 67 TFLOP/s), and moves
// about 1.15 GB (0.34 ms): operations. The design below is bound by the f32
// cores and by L2.
//
// Design: a block owns one batch row, with one thread per state (1024
// threads, at most 64 registers each). The head product does not depend on
// the decode's state, so it is taken for COLS = 8 output frames at a time
// (FB = 8/U encoder frames: 8 at hac, 4 at sup): thread t computes the
// four move rows j*S + t of each phase for the chunk's frames in
// registers, with f32 FMAs over k = 0 .. H-1 in order (a product of two
// bf16 values is exact in f32, so each step rounds once: the plain
// version's sum, step for step, and the same bits). Its rows are the ones
// its own state reads -- the forward takes each phase's rows regrouped as
// (j, s), the moves into s; the backward the TCN order, whose rows b*S + p
// are the moves out of predecessor p -- so the scores, bias, tanh, scale
// and clamp applied, go to shared memory only as the frame steps of
// decode_passes.cuh read them (8 x 16 KB at S 1024). The chunk's h columns
// are staged in shared memory as f32 (every thread reads the same one: a
// broadcast). The weights (8 MB at hac and at sup) cannot stay in shared
// memory: the wrapper lays them out k-major in runs of four
// ([U][H/4][nb*S][4] bf16), so that a warp's 32 rows of 8 bytes are one
// coalesced 256-byte read through L2. Each block streams the whole weight
// once per chunk: about N*T/8 x 8 MB = 170 GB a pass at hac and 270 GB at
// sup.
//
// Tensor cores (mma.sync m16n8k16) did the same products in 25.5 ms a pass
// at hac on an H100, but in an order of sums no plain PyTorch version repeats: on a
// random hac model's batch the near-ties of the max semiring (candidates
// around |amax| ~ 5000, where an f32 step is 5e-4) then moved 0.18% of the
// frames against the plain version. With the order fixed, kernel and plain
// version agree bit for bit, as B, C, M and Q do.
//
// What replaced them: one head product for the whole batch, shared by all
// rows and both passes (csrc/head_product.cu).

#include "decode_passes.cuh"

namespace {

constexpr int COLS = 8;             // output frames per chunk
constexpr int SMEM_LIMIT = 232448;  // 227 KB, the most a block may ask for

typedef __nv_bfloat16 bf16;

struct HeadOps {
    int act_tanh;
    float scale;
    int clamp;
    float cmin, cmax;
};

// Dynamic shared memory of a block, in bytes from its start: the chunk's
// scores [COLS][ldm] f32 (output frame f*U + p in column f*U + p), its h
// columns [COLS][H] f32, and alpha + amax (GW) or beta (JW), [S] f32 each.
struct WideLayout {
    int ldm, off_h, off_ab, total;
    __host__ __device__ WideLayout(int H, int S) {
        ldm = NB * S;
        off_h = COLS * ldm * 4;
        off_ab = off_h + COLS * H * 4;
        total = off_ab + 2 * S * 4;
    }
};

__device__ __forceinline__ float head_act(float z, const HeadOps& o) {
    if (o.act_tanh) z = tanhf(z);
    z *= o.scale;
    if (o.clamp) z = fminf(fmaxf(z, o.cmin), o.cmax);
    return z;
}

// The forward's rows regrouped as (j, s): row j*S + s is the move into s
// from j*R + s/nb. The stay is the constant blank, as in TcnFrame.
struct RegroupedFrame {
    float blank, p_stay;
    __device__ float move(const float* row, int S, int s, int j) const {
        return row[j * S + s];
    }
    __device__ float stay(const float*, int) const { return blank; }
    __device__ float stay_prob(const float*, int) const { return p_stay; }
};

// the bf16 in the low and in the high half of v, as f32
__device__ __forceinline__ float lo(uint32_t v) {
    return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
    return __uint_as_float(v & 0xffff0000u);
}

// Copy encoder frames th0 .. th0 + FB of row n into hs [COLS][H] as f32:
// column f holds frame th0 + f; columns past FB and frames past Th are
// zeros.
template <int FB>
__device__ __forceinline__ void stage_h(float* hs, const bf16* __restrict__ h,
                                        int th0, int Th, int N, int n,
                                        int H) {
    const int units = H / 8;
    for (int e = threadIdx.x; e < COLS * units; e += blockDim.x) {
        const int col = e / units, u = e % units;
        const int th = th0 + col;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (col < FB && th < Th)
            v = __ldg(reinterpret_cast<const uint4*>(
                h + ((size_t)th * N + n) * H) + u);
        float4* d = reinterpret_cast<float4*>(hs + col * H + 8 * u);
        d[0] = make_float4(lo(v.x), hi(v.x), lo(v.y), hi(v.y));
        d[1] = make_float4(lo(v.z), hi(v.z), lo(v.w), hi(v.w));
    }
}

// mv[(f*U + p)*ldm + j*S + t] = head_act(sum_k w[p][j*S + t][k] *
// hs[f][k] + bias[p][j*S + t]) for thread t, the FB encoder frames f of the
// chunk (U = COLS/FB phases) and j < nb; the sum in order of k, one f32
// rounding per step. w4 holds the weights k-major in runs of four:
// w4[(p*H/4 + k/4)*Cm + m] is w[p][m][k .. k+3].
template <int FB>
__device__ __forceinline__ void head_product(float* mv, int ldm,
                                             const uint2* __restrict__ w4,
                                             const float* __restrict__ bias,
                                             const float* hs, int Cm, int H,
                                             const HeadOps& ops) {
    constexpr int U = COLS / FB;
    const int t = threadIdx.x, S = blockDim.x;
    const float4* h4 = reinterpret_cast<const float4*>(hs);
    for (int p = 0; p < U; ++p) {
        float acc[NB][FB];
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int f = 0; f < FB; ++f) acc[j][f] = 0.f;
        const uint2* wp = w4 + (size_t)p * (H / 4) * Cm + t;
#pragma unroll 1
        for (int k4 = 0; k4 < H / 4; ++k4) {
            uint2 w[NB];
#pragma unroll
            for (int j = 0; j < NB; ++j)
                w[j] = __ldg(wp + (size_t)k4 * Cm + j * S);
#pragma unroll
            for (int f = 0; f < FB; ++f) {
                const float4 x = h4[f * (H / 4) + k4];
#pragma unroll
                for (int j = 0; j < NB; ++j) {
                    float a = acc[j][f];
                    a = fmaf(lo(w[j].x), x.x, a);
                    a = fmaf(hi(w[j].x), x.y, a);
                    a = fmaf(lo(w[j].y), x.z, a);
                    a = fmaf(hi(w[j].y), x.w, a);
                    acc[j][f] = a;
                }
            }
        }
#pragma unroll
        for (int j = 0; j < NB; ++j) {
            const float b = __ldg(bias + p * Cm + j * S + t);
#pragma unroll
            for (int f = 0; f < FB; ++f)
                mv[(f * U + p) * ldm + j * S + t] = head_act(acc[j][f] + b, ops);
        }
    }
}

template <int FB>
__global__ void __launch_bounds__(1024, 1)
decode_fused_wide_fwd(const bf16* __restrict__ h,      // [Th, N, H]
                      const uint2* __restrict__ w4,    // k-major, rows (j, s)
                      const float* __restrict__ bias,  // [U, (j, s)]
                      float* __restrict__ move_in,     // [N, T, S]
                      uint8_t* __restrict__ choices,   // [N, T, S]
                      float* __restrict__ cs,          // [N, T]
                      float* __restrict__ logz,        // [N]
                      int* __restrict__ end_state,     // [N]
                      int Th, int N, int H, int S, float p_stay, float blank,
                      HeadOps ops)
{
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ float red[64];
    __shared__ int redi[32];
    constexpr int U = COLS / FB;
    const WideLayout L(H, S);
    float* mv = reinterpret_cast<float*>(dyn);
    float* hs = reinterpret_cast<float*>(dyn + L.off_h);
    float* A = reinterpret_cast<float*>(dyn + L.off_ab);  // [S] alpha
    float* amax = A + S;                                  // [S]
    const int n = blockIdx.x, Cm = NB * S, T = Th * U;
    const RegroupedFrame f{blank, p_stay};

    A[threadIdx.x] = 1.f;  // a thread per state
    amax[threadIdx.x] = 0.f;
    float c = 0.f;
    for (int k = 0; k * FB < Th; ++k) {
        // the last chunk's product read hs, and its frames read mv, before
        // the frames' barriers
        stage_h<FB>(hs, h, k * FB, Th, N, n, H);
        __syncthreads();
        head_product<FB>(mv, L.ldm, w4, bias, hs, Cm, H, ops);
        const int t0 = k * COLS, nt = min(COLS, T - t0);
        for (int lf = 0; lf < nt; ++lf) {
            __syncthreads();  // mv, and the last frame's A/amax, visible
            const size_t frame = (size_t)n * T + t0 + lf;
            fwd_frame(f, mv + lf * L.ldm, S, A, amax, c, red,
                      move_in + frame * S, choices + frame * S, cs + frame);
        }
    }
    fwd_end(A, amax, S, c, red, redi, logz + n, end_state + n);
}

template <int FB>
__global__ void __launch_bounds__(1024, 1)
decode_fused_wide_bwd(const bf16* __restrict__ h,        // [Th, N, H]
                      const uint2* __restrict__ w4,      // k-major, TCN rows
                      const float* __restrict__ bias,    // [U, nb*S]
                      const float* __restrict__ move_in, // [N, T, S]
                      const uint8_t* __restrict__ choices,
                      const float* __restrict__ cs,       // [N, T]
                      const float* __restrict__ logz,     // [N]
                      const int* __restrict__ end_state,  // [N]
                      uint8_t* __restrict__ seq,          // [N, T]
                      uint8_t* __restrict__ qstr,         // [N, T]
                      uint8_t* __restrict__ mvout,        // [N, T]
                      int Th, int N, int H, int S, float p_stay, float qscale,
                      float qbias, HeadOps ops)
{
    extern __shared__ __align__(16) unsigned char dyn[];
    __shared__ float red[64];
    constexpr int U = COLS / FB;
    const WideLayout L(H, S);
    float* mv = reinterpret_cast<float*>(dyn);
    float* hs = reinterpret_cast<float*>(dyn + L.off_h);
    float* B = reinterpret_cast<float*>(dyn + L.off_ab);  // [S] beta
    const int n = blockIdx.x, Cm = NB * S, T = Th * U;
    const TcnFrame f{0.f, p_stay};

    B[threadIdx.x] = 1.f;
    float d = 0.f;
    int state = end_state[n];
    const float lz = logz[n];
    for (int k = (Th - 1) / FB; k >= 0; --k) {
        stage_h<FB>(hs, h, k * FB, Th, N, n, H);  // as in the forward
        __syncthreads();
        head_product<FB>(mv, L.ldm, w4, bias, hs, Cm, H, ops);
        const int t0 = k * COLS, nt = min(COLS, T - t0);
        for (int lf = nt - 1; lf >= 0; --lf) {
            __syncthreads();  // mv, and the last frame's B, visible
            const size_t frame = (size_t)n * T + t0 + lf;
            bwd_frame(f, mv + lf * L.ldm, S, B, d, state, lz, red,
                      move_in + frame * S, choices + frame * S, cs + frame,
                      qscale, qbias, seq + frame, qstr + frame,
                      mvout + frame);
        }
    }
}

// S 512 or 1024 (a thread per state); U 1 (hac) or 2 (sup): FB = COLS/U
// encoder frames per chunk; H a multiple of 16 up to hac's 1024, as the
// wrapper's gate says
bool bad_shape(int Th, int N, int H, int S, int U) {
    return Th < 1 || N < 1 || (S != 512 && S != 1024) || H < 16
        || H % 16 != 0 || H > 1024 || (U != 1 && U != 2);
}

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const WideLayout& L) {
    if (L.total > SMEM_LIMIT) return cudaErrorInvalidValue;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
}

template <int FB>
int launch_fwd(const void* h, const void* w4, const void* bias,
               void* move_in, void* choices, void* c, void* logz,
               void* end_state, int Th, int N, int H, int S, float p_stay,
               float blank, HeadOps ops, void* stream) {
    const WideLayout L(H, S);
    cudaError_t err = prepare(decode_fused_wide_fwd<FB>, L);
    if (err != cudaSuccess) return (int)err;
    decode_fused_wide_fwd<FB><<<N, S, L.total,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(h), static_cast<const uint2*>(w4),
        static_cast<const float*>(bias), static_cast<float*>(move_in),
        static_cast<uint8_t*>(choices), static_cast<float*>(c),
        static_cast<float*>(logz), static_cast<int*>(end_state), Th, N, H, S,
        p_stay, blank, ops);
    return (int)cudaGetLastError();
}

template <int FB>
int launch_bwd(const void* h, const void* w4, const void* bias,
               const void* move_in, const void* choices, const void* c,
               const void* logz, const void* end_state, void* seq,
               void* qstr, void* mvout, int Th, int N, int H, int S,
               float p_stay, float qscale, float qbias, HeadOps ops,
               void* stream) {
    const WideLayout L(H, S);
    cudaError_t err = prepare(decode_fused_wide_bwd<FB>, L);
    if (err != cudaSuccess) return (int)err;
    decode_fused_wide_bwd<FB><<<N, S, L.total,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(h), static_cast<const uint2*>(w4),
        static_cast<const float*>(bias), static_cast<const float*>(move_in),
        static_cast<const uint8_t*>(choices), static_cast<const float*>(c),
        static_cast<const float*>(logz), static_cast<const int*>(end_state),
        static_cast<uint8_t*>(seq), static_cast<uint8_t*>(qstr),
        static_cast<uint8_t*>(mvout), Th, N, H, S, p_stay, qscale, qbias,
        ops);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel GW. h [Th, N, H] bf16; w4 the weights [U, nb*S, H] bf16 with each
// phase's rows regrouped as (j, s) (row j*S + s is the move into s from
// j*R + s/nb), laid out k-major in runs of four ([U][H/4][nb*S][4]), at an
// 8-byte address; bias [U, nb*S] f32 in the (j, s) order -> move_in
// [N, T, S] f32, choices [N, T, S] uint8, c [N, T] f32, logz [N] f32,
// end_state [N] int32, T = Th*U.
int decode_fused_wide_fwd_bf16(const void* h, const void* w4,
                               const void* bias, void* move_in,
                               void* choices, void* c, void* logz,
                               void* end_state, int Th, int N, int H, int S,
                               int U, float p_stay, float blank,
                               int act_tanh, float scale, int clamp,
                               float cmin, float cmax, void* stream) {
    if (bad_shape(Th, N, H, S, U)) return (int)cudaErrorInvalidValue;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    auto launch = U == 1 ? launch_fwd<8> : launch_fwd<4>;
    return launch(h, w4, bias, move_in, choices, c, logz, end_state, Th, N,
                  H, S, p_stay, blank, ops, stream);
}

// Kernel JW. h as for GW; w4 and bias in the TCN (b, j, r) row order, w4
// laid out as for GW; GW's outputs -> sequence, qstring, moves_out, each
// [N, T] uint8.
int decode_fused_wide_bwd_bf16(const void* h, const void* w4,
                               const void* bias, const void* move_in,
                               const void* choices, const void* c,
                               const void* logz, const void* end_state,
                               void* seq, void* qstr, void* mvout, int Th,
                               int N, int H, int S, int U, float p_stay,
                               float qscale, float qbias, int act_tanh,
                               float scale, int clamp, float cmin, float cmax,
                               void* stream) {
    if (bad_shape(Th, N, H, S, U)) return (int)cudaErrorInvalidValue;
    const HeadOps ops = {act_tanh, scale, clamp, cmin, cmax};
    auto launch = U == 1 ? launch_bwd<8> : launch_bwd<4>;
    return launch(h, w4, bias, move_in, choices, c, logz, end_state, seq,
                  qstr, mvout, Th, N, H, S, p_stay, qscale, qbias, ops,
                  stream);
}

}  // extern "C"
