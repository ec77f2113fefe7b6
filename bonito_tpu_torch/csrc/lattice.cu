// Kernels Y and Z: the CTC alignment-lattice logZ of each target, and its
// gradient with respect to the lattice's move scores.
//
// Replace bonito_tpu/ops/lattice_pallas.py — Y is `_fwd_kernel`
// (lattice_logZ's forward) and Z is `_bwd_kernel` (its VJP). The lattice
// of a target has P positions; position p advances by at most one per
// frame. The stay is the constant `blank`, the move out of p at frame t is
// move[n, t, p] ([N, T, P-1] f32, from CTC_CRF.prepare_ctc_moves_tcn), and
// lengths[n] positions are valid.
//
// Forward, NEG = -1e30 (not -inf: the backward's sums would make
// inf - inf), alpha_0 = 0 at position 0 and NEG elsewhere:
//     alpha'[p] = logaddexp(alpha[p] + blank, alpha[p-1] + move[t, p-1])
// (NEG in place of the move term at p = 0), logaddexp(x, y) = max +
// log1p(exp(-|x - y|)) as in JAX and torch; the stack keeps alpha before
// each frame ([N, T, P] f32) when a gradient is wanted; logz = alpha_T at
// lengths - 1, read with a mask: 0 for a row with no valid position.
// Backward, beta_T = 0 at lengths - 1 and NEG elsewhere, the cotangent
// passed as log|g| - logz and sign(g) (a masked row has g = 0 and gets 0):
//     dmove[t, p] = exp(alpha_t[p] + move + beta_{t+1}[p+1] + log|g| - logz)
//                   * sign(g)
//     beta_t[p] = logaddexp(beta[p] + blank, beta[p+1] + move[t, p])
// (NEG for beta[P] and move[t, P-1]). f32 throughout, as on the TPU. The
// plain versions (ops/lattice.py) take the same f32 steps.
//
// What bounds them on an H100: bytes. At hac training shapes (N 128,
// T 1000, P 496) Y reads 0.25 GB of moves and writes the 0.25 GB stack, Z
// reads both and writes 0.25 GB. The earlier design (Y where
// ops/lattice_cuda.py:lattice_fwd_plan gives no plan, Z where lattice_plan
// gives none): one block per batch row,
// positions strided over up to 1024 threads, so any P runs (alpha or beta
// double buffered in shared memory, 8 bytes a position); one barrier per
// frame, each frame's reads of move and stack waited for in the frame.
//
// Z split over warps (lattice_bwd_split, the plan's): one CTA a batch row,
// warp w owning positions 32 K w .. 32 K (w+1) - 1, lane l of it positions
// 32 K w + 32 j + l (j < K: coalesced reads and stores). beta of a warp's
// positions stays in registers; the neighbour's beta[p+1] comes by shuffle
// from lane l+1 (lane 0 hands on its next position's, or the warp above's
// first position's, which each warp leaves in shared memory by the parity
// of its frame). One block barrier a frame orders those edge values, and
// nothing else: each thread's move and stack values arrive D frames ahead
// into registers (plain loads: the rows of [N, T, P-1] are not 16-byte
// aligned), so no frame waits for device memory. The f32 operations are the
// earlier kernel's, in its order: dmove equals its output bit for bit.
// Measured and not kept (PERF.md): the warps handing their edge values on
// through a ring of tagged slots in shared memory with no block barrier
// (slower at every shape: the lane that polls and publishes lengthens
// every warp's frame).
//
// Y split over warps (lattice_fwd_split, ops/lattice_cuda.py:
// lattice_fwd_plan's): Z's layout with the edge the other way. Lane l of
// warp w holds alpha of positions 32 K w + 32 j + l in registers; alpha[p-1]
// comes by shuffle from lane l-1 (lane 0 takes lane 31's position of j-1,
// or for j = 0 the warp below's last position, which each warp leaves in
// shared memory by the parity of its frame); one block barrier a frame
// orders those edge values. Each thread's move values arrive D frames ahead
// into registers (no stack to read: deeper than Z's), its alpha goes to the
// stack before the frame's update (coalesced), and the thread holding
// position lengths - 1 writes logZ. The f32 steps are the earlier Y's:
// stack and logZ equal its outputs bit for bit. Measured and not kept
// (PERF.md): 16 frames ahead at one position a thread (slower at every
// training shape) and at two (slower than 8).

#include <cuda_runtime.h>
#include <cmath>

#ifndef LATTICE_CUT
#define LATTICE_CUT 0
#endif

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float logaddexp(float x, float y) {
    const float m = fmaxf(x, y);
    return m + log1pf(expf(-fabsf(x - y)));
}

template <bool STACK>
__global__ void lattice_fwd_kernel(const float* __restrict__ move,  // [N,T,P-1]
                                   const int* __restrict__ lengths,  // [N]
                                   float* __restrict__ stack,  // [N, T, P]
                                   float* __restrict__ logz,   // [N]
                                   int T, int P, float blank)
{
    extern __shared__ float smem[];
    float* cur = smem;
    float* nxt = smem + P;
    const int n = blockIdx.x;
    const float* m = move + (size_t)n * T * (P - 1);
    for (int p = threadIdx.x; p < P; p += blockDim.x)
        cur[p] = p == 0 ? 0.f : NEG;
    for (int t = 0; t < T; ++t) {
        __syncthreads();  // cur complete; every read of nxt done
        for (int p = threadIdx.x; p < P; p += blockDim.x) {
            const float a = cur[p];
            if (STACK) stack[((size_t)n * T + t) * P + p] = a;
            const float moved =
                p == 0 ? NEG : cur[p - 1] + m[(size_t)t * (P - 1) + p - 1];
            nxt[p] = logaddexp(a + blank, moved);
        }
        float* tmp = cur; cur = nxt; nxt = tmp;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        const int end = lengths[n] - 1;
        logz[n] = (end >= 0 && end < P) ? cur[end] : 0.f;
    }
}

__global__ void lattice_bwd_kernel(const float* __restrict__ move,  // [N,T,P-1]
                                   const float* __restrict__ stack,  // [N,T,P]
                                   const int* __restrict__ lengths,  // [N]
                                   const float* __restrict__ gz,  // [N] log|g| - logz
                                   const float* __restrict__ sg,  // [N] sign(g)
                                   float* __restrict__ dmove,     // [N,T,P-1]
                                   int T, int P, float blank)
{
    extern __shared__ float smem[];
    float* cur = smem;
    float* nxt = smem + P;
    const int n = blockIdx.x;
    const size_t base = (size_t)n * T * (P - 1);
    const int end = lengths[n] - 1;
    const float g0 = gz[n], s = sg[n];
    for (int p = threadIdx.x; p < P; p += blockDim.x)
        cur[p] = p == end ? 0.f : NEG;
    for (int t = T - 1; t >= 0; --t) {
        __syncthreads();
        for (int p = threadIdx.x; p < P; p += blockDim.x) {
            const float bn = p + 1 < P ? cur[p + 1] : NEG;
            const float mv =
                p < P - 1 ? move[base + (size_t)t * (P - 1) + p] : NEG;
            if (p < P - 1) {
                const float a = stack[((size_t)n * T + t) * P + p];
                dmove[base + (size_t)t * (P - 1) + p] =
                    expf(((a + mv) + bn) + g0) * s;
            }
            nxt[p] = logaddexp(cur[p] + blank, bn + mv);
        }
        float* tmp = cur; cur = nxt; nxt = tmp;
    }
}

// ------------------------------------------- Y and Z split over warps
// the parts scripts/lattice_split.py leaves out (LATTICE_CUT bits)
constexpr int ZCUT_BARRIER = 1;  // the frame's block barrier (the
                                 // neighbouring warp's edge value read
                                 // unordered)
constexpr int ZCUT_EXPS = 2;     // expf and log1pf (each its argument)
constexpr int ZCUT_STORES = 4;   // the stores of dmove (Z) or of the stack
                                 // (Y), their values summed
constexpr int ZCUT_LOADS = 8;    // the reads of move (and Z's stack) after
                                 // the first D frames' (whose values repeat)

__device__ __forceinline__ constexpr bool zcut(int part) {
    return (LATTICE_CUT & part) != 0;
}

constexpr int ZWARPS = 32;  // warps a CTA, at most

__device__ __forceinline__ float zexp(float x) {
    return zcut(ZCUT_EXPS) ? x : expf(x);
}

__device__ __forceinline__ float zlogaddexp(float x, float y) {
    if (!zcut(ZCUT_EXPS)) return logaddexp(x, y);
    const float m = fmaxf(x, y);
    return m + (-fabsf(x - y));
}

// kernel Z with K positions a thread, move and stack D frames ahead; a CTA
// of up to 32 warps, so at most 64 registers a thread (ptxas gives every
// instance built no more; launch bounds that forced it changed the schedule
// and slowed the 8-frame instances twofold when tried)
template <int K, int D>
__global__ void lattice_bwd_split_kernel(const float* __restrict__ move,
                                         const float* __restrict__ stack,
                                         const int* __restrict__ lengths,
                                         const float* __restrict__ gz,
                                         const float* __restrict__ sg,
                                         float* __restrict__ dmove,
                                         int T, int P, float blank)
{
    // each warp's first position's beta, by the parity of its frame
    __shared__ float edge[2][ZWARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int n = blockIdx.x;
    const int p0 = 32 * K * w + lane;   // position of j = 0
    const bool above = 32 * K * (w + 1) < P;  // a warp above holds one
    const float* mrow = move + (size_t)n * T * (P - 1);
    const float* srow = stack + (size_t)n * T * P;
    float* drow = dmove + (size_t)n * T * (P - 1);
    const int end = lengths[n] - 1;
    const float g0 = gz[n], s = sg[n];
    float b[K];  // beta of the frame after, positions p0 + 32 j
#pragma unroll
    for (int j = 0; j < K; ++j) b[j] = p0 + 32 * j == end ? 0.f : NEG;
    if (lane == 0) edge[T & 1][w] = b[0];
    __syncthreads();

    // positions past P - 1 have no move: NEG, and no stack value
    auto load = [&](int t, float (&m)[K], float (&a)[K]) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int p = p0 + 32 * j;
            const bool in = p < P - 1;
            m[j] = in ? __ldg(mrow + (size_t)t * (P - 1) + p) : NEG;
            a[j] = in ? __ldg(srow + (size_t)t * P + p) : 0.f;
        }
    };
    float pm[D][K], pa[D][K];
#pragma unroll
    for (int d = 0; d < D; ++d)
        if (T - 1 - d >= 0) load(T - 1 - d, pm[d], pa[d]);
    float sink = 0.f;
    for (int t0 = T - 1; t0 >= 0; t0 -= D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const int t = t0 - d;
            if (t < 0) break;
            // beta of frame t+1 at the warp above's first position
            const float up = lane == 0 && above ? edge[(t + 1) & 1][w + 1]
                                                : NEG;
            float nb[K];  // beta of frame t+1 at p + 1
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const float src =
                    lane == 0 ? (j + 1 < K ? b[j + 1] : up) : b[j];
                nb[j] = __shfl_sync(0xffffffffu, src, (lane + 1) & 31);
            }
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int p = p0 + 32 * j;
                const float mv = pm[d][j], a = pa[d][j];
                if (p < P - 1) {
                    const float v = zexp(((a + mv) + nb[j]) + g0) * s;
                    if (zcut(ZCUT_STORES))
                        sink += v;
                    else
                        drow[(size_t)t * (P - 1) + p] = v;
                }
                if (p < P) b[j] = zlogaddexp(b[j] + blank, nb[j] + mv);
            }
            // the parity this frame writes was last read a frame ago,
            // before the last barrier
            if (lane == 0) edge[t & 1][w] = b[0];
            if (!zcut(ZCUT_BARRIER)) __syncthreads();
            if (t - D >= 0 && !zcut(ZCUT_LOADS)) load(t - D, pm[d], pa[d]);
        }
    }
    if (zcut(ZCUT_STORES) && sink == 1.2345f) drow[0] = sink;
}

// kernel Y with K positions a thread, move D frames ahead; STACK: alpha
// before each frame stored. At most 64 registers a thread, so that a CTA
// of 32 warps launches (unbounded, ptxas gave the 2-position, 8-frame
// instance with its stack 91); the 1-position instances take 40-56
// without the bound.
template <int K, int D, bool STACK>
__global__ void __launch_bounds__(32 * ZWARPS)
lattice_fwd_split_kernel(const float* __restrict__ move,
                                         const int* __restrict__ lengths,
                                         float* __restrict__ stack,
                                         float* __restrict__ logz,
                                         int T, int P, float blank)
{
    // each warp's last position's alpha, by the parity of its frame
    __shared__ float edge[2][ZWARPS];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int n = blockIdx.x;
    const int p0 = 32 * K * w + lane;   // position of j = 0
    const float* mrow = move + (size_t)n * T * (P - 1);
    float* srow = STACK ? stack + (size_t)n * T * P : nullptr;
    float a[K];  // alpha of this frame, positions p0 + 32 j
#pragma unroll
    for (int j = 0; j < K; ++j) a[j] = p0 + 32 * j == 0 ? 0.f : NEG;
    if (lane == 31) edge[0][w] = a[K - 1];
    __syncthreads();

    // the move into p from p - 1: none at p = 0 and past P - 1
    auto load = [&](int t, float (&m)[K]) {
#pragma unroll
        for (int j = 0; j < K; ++j) {
            const int p = p0 + 32 * j;
            m[j] = p >= 1 && p < P
                ? __ldg(mrow + (size_t)t * (P - 1) + p - 1) : NEG;
        }
    };
    float pm[D][K];
#pragma unroll
    for (int d = 0; d < D; ++d)
        if (d < T) load(d, pm[d]);
    float sink = 0.f;
    for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
            const int t = t0 + d;
            if (t >= T) break;
            // alpha of frame t at the warp below's last position
            const float down = lane == 0 && w > 0 ? edge[t & 1][w - 1] : NEG;
            float nb[K];  // alpha of frame t at p - 1
#pragma unroll
            for (int j = 0; j < K; ++j) {
                // lane 31's value goes to lane 0 only: its position of j-1
                const float src =
                    lane == 31 ? (j > 0 ? a[j - 1] : NEG) : a[j];
                nb[j] = __shfl_sync(0xffffffffu, src, (lane + 31) & 31);
            }
            if (lane == 0) nb[0] = down;
#pragma unroll
            for (int j = 0; j < K; ++j) {
                const int p = p0 + 32 * j;
                if (p < P) {
                    if (STACK) {
                        if (zcut(ZCUT_STORES))
                            sink += a[j];
                        else
                            srow[(size_t)t * P + p] = a[j];
                    }
                    const float moved = p == 0 ? NEG : nb[j] + pm[d][j];
                    a[j] = zlogaddexp(a[j] + blank, moved);
                }
            }
            // the parity this frame writes was last read a frame ago,
            // before the last barrier
            if (lane == 31) edge[(t + 1) & 1][w] = a[K - 1];
            if (!zcut(ZCUT_BARRIER)) __syncthreads();
            if (t + D < T && !zcut(ZCUT_LOADS)) load(t + D, pm[d]);
        }
    }
    const int end = lengths[n] - 1;
#pragma unroll
    for (int j = 0; j < K; ++j)
        if (p0 + 32 * j == end && end < P) logz[n] = a[j];
    if (threadIdx.x == 0 && !(end >= 0 && end < P)) logz[n] = 0.f;
    if (STACK && zcut(ZCUT_STORES) && sink == 1.2345f) srow[0] = sink;
}

template <int K, int D, bool STACK>
int launch_y(const float* move, const int* lengths, float* stack,
             float* logz, int N, int T, int P, float blank, cudaStream_t st) {
    const int warps = (P + 32 * K - 1) / (32 * K);
    if (warps > ZWARPS) return (int)cudaErrorInvalidValue;
    lattice_fwd_split_kernel<K, D, STACK><<<N, 32 * warps, 0, st>>>(
        move, lengths, stack, logz, T, P, blank);
    return (int)cudaGetLastError();
}

template <int K, int D>
int launch_z(const float* move, const float* stack, const int* lengths,
             const float* gz, const float* sg, float* dmove, int N, int T,
             int P, float blank, cudaStream_t st) {
    const int warps = (P + 32 * K - 1) / (32 * K);
    if (warps > ZWARPS) return (int)cudaErrorInvalidValue;
    lattice_bwd_split_kernel<K, D><<<N, 32 * warps, 0, st>>>(
        move, stack, lengths, gz, sg, dmove, T, P, blank);
    return (int)cudaGetLastError();
}

int threads_for(int P) { return P >= 1024 ? 1024 : ((P + 31) / 32) * 32; }

int smem_for(const void* kernel, int P, size_t* bytes) {
    *bytes = (size_t)2 * P * sizeof(float);
    if (*bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

}  // namespace

extern "C" {

// Y: move [N, T, P-1] f32, lengths [N] int32 -> stack [N, T, P] f32
// (alpha before each frame; null for the forward-only variant), logz [N]
int lattice_fwd(const void* move, const void* lengths, void* stack,
                void* logz, int N, int T, int P, float blank, void* stream) {
    if (N < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
    const void* kernel = stack ? (const void*)lattice_fwd_kernel<true>
                               : (const void*)lattice_fwd_kernel<false>;
    size_t smem;
    if (int rc = smem_for(kernel, P, &smem)) return rc;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (stack)
        lattice_fwd_kernel<true><<<N, threads_for(P), smem, st>>>(
            static_cast<const float*>(move), static_cast<const int*>(lengths),
            static_cast<float*>(stack), static_cast<float*>(logz), T, P,
            blank);
    else
        lattice_fwd_kernel<false><<<N, threads_for(P), smem, st>>>(
            static_cast<const float*>(move), static_cast<const int*>(lengths),
            nullptr, static_cast<float*>(logz), T, P, blank);
    return (int)cudaGetLastError();
}

// Z: move, Y's stack, lengths, log|g| - logz [N] and sign(g) [N] f32 ->
// dmove [N, T, P-1] f32
int lattice_bwd(const void* move, const void* stack, const void* lengths,
                const void* gz, const void* sg, void* dmove, int N, int T,
                int P, float blank, void* stream) {
    if (N < 1 || T < 1 || P < 1) return (int)cudaErrorInvalidValue;
    size_t smem;
    if (int rc = smem_for((const void*)lattice_bwd_kernel, P, &smem))
        return rc;
    lattice_bwd_kernel<<<N, threads_for(P), smem,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(move), static_cast<const float*>(stack),
        static_cast<const int*>(lengths), static_cast<const float*>(gz),
        static_cast<const float*>(sg), static_cast<float*>(dmove), T, P,
        blank);
    return (int)cudaGetLastError();
}

// Y split over warps (ops/lattice_cuda.py:lattice_fwd_plan): the arguments
// of lattice_fwd with the plan's positions a thread (1 or 2) and prefetch
// depth after P (the instances built: 1 position with 32 frames, 2 with
// 8; each with the stack and without it; scripts/lattice_split.py y builds
// 16 frames at both beside them). Refuses
// (cudaErrorInvalidValue) P below 2, more than 32 warps' positions and
// what no instance takes.
int lattice_fwd_split(const void* move, const void* lengths, void* stack,
                      void* logz, int N, int T, int P, int k, int depth,
                      float blank, void* stream) {
    if (N < 1 || T < 1 || P < 2) return (int)cudaErrorInvalidValue;
    const float* m = static_cast<const float*>(move);
    const int* l = static_cast<const int*>(lengths);
    float* a = static_cast<float*>(stack);
    float* z = static_cast<float*>(logz);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define Y_CASE(K, D)                                                      \
    if (k == K && depth == D)                                             \
        return a ? launch_y<K, D, true>(m, l, a, z, N, T, P, blank, st)   \
                 : launch_y<K, D, false>(m, l, a, z, N, T, P, blank, st);
    Y_CASE(1, 32) Y_CASE(2, 8)
#undef Y_CASE
    return (int)cudaErrorInvalidValue;
}

// Z split over warps (ops/lattice_cuda.py:lattice_plan): the arguments of
// lattice_bwd with the plan's positions a thread (1 or 2) and
// prefetch depth after P (the instances built: 1 position with 8 or 16
// frames, 2 with 4 or 8). Refuses
// (cudaErrorInvalidValue) P below 2, more than 32 warps' positions and
// what no instance takes.
int lattice_bwd_split(const void* move, const void* stack,
                      const void* lengths, const void* gz, const void* sg,
                      void* dmove, int N, int T, int P, int k, int depth,
                      float blank, void* stream) {
    if (N < 1 || T < 1 || P < 2) return (int)cudaErrorInvalidValue;
    const float* m = static_cast<const float*>(move);
    const float* a = static_cast<const float*>(stack);
    const int* l = static_cast<const int*>(lengths);
    const float* g = static_cast<const float*>(gz);
    const float* s = static_cast<const float*>(sg);
    float* d = static_cast<float*>(dmove);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
#define Z_CASE(K, D)                                                      \
    if (k == K && depth == D)                                             \
        return launch_z<K, D>(m, a, l, g, s, d, N, T, P, blank, st);
    Z_CASE(1, 8) Z_CASE(1, 16)
    Z_CASE(2, 4) Z_CASE(2, 8)
#undef Z_CASE
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
