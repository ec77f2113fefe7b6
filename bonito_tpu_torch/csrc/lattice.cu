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
// reads both and writes 0.25 GB. One block per batch row; positions are
// strided over up to 1024 threads, so any P runs (alpha or beta double
// buffered in shared memory, 8 bytes a position); one barrier per frame.

#include <cuda_runtime.h>
#include <cmath>

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

}  // extern "C"
