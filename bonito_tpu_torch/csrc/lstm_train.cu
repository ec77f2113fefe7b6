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
// are serial in T, so what bounds this first design is the per-step
// latency, as for kernel A (csrc/lstm.cu), whose layout R keeps: one
// launch per step from a loop inside the C entry point; a block owns all
// four gate columns of UH hidden units for RB batch rows; in bf16 16 warps
// run 16x16x16 WMMA products with f32 accumulators straight from L2. An f32
// model (training without amp) takes the same layout with the products on
// the f32 cores (each thread a few sums of float4 rows), since the tensor
// cores would round its operands to TF32: slower, its numbers exact f32.
//
// S's step is the awkward one: dh_{t-1} of a hidden unit needs dgates over
// all 4H columns of its rows, and those need dh of every unit from the
// whole previous product. So a launch does the product of the step before
// and the elementwise part of its own step: launch j first computes its
// block's dh = Io(dgates_{j-1}) @ W_hh^T (read from an Io copy that
// launch j-1 wrote in full), then, for its own units, step j's dgates and
// dc. Each dgates element is computed once, by the block that owns its
// hidden unit; one launch per step, T in all. The Io copy of dgates and
// Io(h) are ping-ponged between two buffers of Np >= N rows whose padding
// rows stay zero. The redesign (a persistent kernel holding W_hh in the
// SMs' shared memory, a grid barrier per step, wgmma) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int UH = 16;              // hidden units per block
constexpr int RB = 32;              // batch rows per block (two 16-row tiles)
constexpr int NWARP = 16;
constexpr int NTHREAD = NWARP * 32;
constexpr int GC = 4 * UH;          // gate columns per block (R)
constexpr int KS = NWARP / 4;       // R in bf16: k-slices per gate

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float sigmoid_f(float x) {
    return 1.f / (1.f + expf(-x));
}

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
// each thread four columns of one row over the whole k range (part[0]).
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

__device__ __forceinline__ void fwd_product(
    const float* whh, const float* h_in, float (*part)[RB][GC], int u0,
    int r0, int H)
{
    const int rr = threadIdx.x / 16, cb = (threadIdx.x % 16) * 4;
    const int ldw = 4 * H;
    const float* hr = h_in + (size_t)(r0 + rr) * H;
    const float* wc = whh + (cb / UH) * H + u0 + cb % UH;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    for (int k = 0; k < H; ++k) {
        const float a = hr[k];
        const float4 w = *reinterpret_cast<const float4*>(wc + (size_t)k * ldw);
        a0 += a * w.x;
        a1 += a * w.y;
        a2 += a * w.z;
        a3 += a * w.w;
    }
    part[0][rr][cb] = a0;
    part[0][rr][cb + 1] = a1;
    part[0][rr][cb + 2] = a2;
    part[0][rr][cb + 3] = a3;
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

// R, one step: as kernel A's, with c and the activations kept for S.
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
    __shared__ __align__(32) float part[KS][RB][GC];
    const int u0 = blockIdx.x * UH;
    const int r0 = blockIdx.y * RB;
    const int ldw = 4 * H;

    fwd_product(whh, h_in, part, u0, r0, H);
    __syncthreads();

    for (int e = threadIdx.x; e < RB * UH; e += NTHREAD) {
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
        lstm_train_fwd_step<Io, St><<<grid, NTHREAD, 0, s>>>(
            x + (size_t)t * N * 4 * H, w, hb + (step & 1) * plane,
            hb + ((step + 1) & 1) * plane,
            static_cast<Io*>(h) + (size_t)t * N * H,
            static_cast<St*>(c_out) + (size_t)t * N * H,
            static_cast<St*>(acts) + (size_t)t * N * 4 * H,
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
