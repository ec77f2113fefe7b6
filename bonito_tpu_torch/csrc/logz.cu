// Kernels U, V, W and X: the CRF partition function logZ over the frames
// of a chunk, and its gradient, for the training loss.
//
// Replace bonito_tpu/ops/logz_pallas.py — U is `_fwd_kernel_tcn` and
// `_fwd_kernel_tcn_nockpt` (logZ_tcn's forward, with and without the alpha
// stack), V is `_bwd_kernel_tcn` (its VJP), W is `_fwd_kernel` and
// `_fwd_kernel_nockpt` (logZ_pallas's forward over full scores), X is
// `_bwd_kernel`. U and V read the decode layout (TcnFrame: the head's
// [N, T, nb*S] memory, the stay a constant blank), W and X full scores
// (FullFrame: [N, T, (nb+1)*S] with a stay plane); crf_frames.cuh has both.
//
// Forward, per batch row n, in log space (loss scores have no bound, so
// no renormalised probabilities as in the decode), alpha_0 = 0:
//     cand_j = move(s, j) + alpha[j*R + s/nb],  m = max_j cand_j
//     move_in = m + log(sum_j exp(cand_j - m))
//     alpha'[s] = lse(stay(s) + alpha[s], move_in)
// with lse(a, b) = max + log(exp(a - max) + exp(b - max)); the stack keeps
// alpha before each frame ([N, T, S] f32) when a gradient is wanted, and
// logZ = logsumexp_s alpha_T (max, then a block sum of exp).
// Backward, t = T-1 .. 0, beta_T = 0, g the cotangent of logZ:
//     d move(s, j) = exp(move + alpha_t[j*R + s/nb] + beta_{t+1}[s] - logZ) * g
//     d stay(s)    = exp(alpha_t[s] + stay + beta_{t+1}[s] - logZ) * g
//     beta_t[p = j*R + r] = lse(stay(p) + beta[p],
//                               LSE_b(move(r*nb + b, j) + beta[r*nb + b]))
// written in the scores' own layout and type.
//
// Rounding, as the TPU kernels: with `round` the scores are rounded to bf16
// on load (round to nearest even, as XLA's convert) and the gradient to
// bf16 before it is stored in the output type; without it (bonito_tpu's
// scan route, f32 throughout) neither. The plain versions
// (ops/logz.py) take the same f32 steps in the same order: the sums over j
// and b in order 0..nb-1, the sum over states in the block butterfly's
// order, no product contracted into an add (csrc/logz_steps.cuh has the
// steps all their instances share).
//
// What bounds them on an H100: bytes. At hac training shapes (N 128,
// T 1000, S 1024) U reads the 1.05 GB bf16 moves and writes the 0.52 GB
// alpha stack; V reads both and writes 1.05 GB of gradient. About 8 exp
// and log per state and frame is 1.3e9 of each, far under the card's
// rate. The recursion over T is serial, so this first design is
// latency-bound: one block per batch row, one thread per state, alpha or
// beta, alpha_t and the frame's row in shared memory, two barriers per
// frame. On the card U, V, W and X run on the ring of csrc/logz_ring.cu
// where ops/logz_cuda.py's logz_plan gives a plan (the same bits); these
// kernels stay for what the plan does not take (pointers not 16-byte
// aligned, W's and X's bf16 rows at S 4) and as the ring's oracle.

#include "crf_frames.cuh"
#include "logz_steps.cuh"

namespace {

template <class Frame, typename In, bool ROUND, bool STACK>
__global__ void logz_fwd_kernel(const In* __restrict__ scores,  // [N, T, W]
                                float* __restrict__ stack,  // [N, T, S] or null
                                float* __restrict__ logz,   // [N]
                                int T, int S, Frame f)
{
    extern __shared__ float smem[];
    __shared__ float red[64];
    const int W = f.width(S), R = S / NB;
    float* row = smem;         // [W] this frame's scores
    float* A = row + W;        // [S] alpha
    const int n = blockIdx.x;
    const int s = threadIdx.x;
    const bool active = s < S;
    const int r = s / NB;

    if (active) A[s] = 0.f;
    const In* src = scores + (size_t)n * T * W;
    for (int t = 0; t < T; ++t) {
        __syncthreads();  // last frame's A visible; row free
        for (int i = threadIdx.x; i < W; i += blockDim.x)
            row[i] = load_score<In, ROUND>(src + (size_t)t * W + i);
        __syncthreads();
        float next = 0.f;
        if (active) {
            float cand[NB], m = -INFINITY;
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                cand[j] = f.move(row, S, s, j) + A[j * R + r];
                m = fmaxf(m, cand[j]);
            }
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NB; ++j) sum += expf(cand[j] - m);
            next = lse2(f.stay(row, s) + A[s], m + logf(sum));
            if (STACK) stack[((size_t)n * T + t) * S + s] = A[s];
        }
        __syncthreads();  // every read of A precedes its update
        if (active) A[s] = next;
    }
    __syncthreads();
    const float a = active ? A[s] : -INFINITY;
    const float mx = block_max(a, red);
    float sum = active ? expf(a - mx) : 0.f, unused = -INFINITY;
    block_sum_max(sum, unused, red);
    if (threadIdx.x == 0) logz[n] = mx + logf(sum);
}

template <class Frame, typename In, typename Out, bool ROUND>
__global__ void logz_bwd_kernel(const In* __restrict__ scores,    // [N, T, W]
                                const float* __restrict__ stack,  // [N, T, S]
                                const float* __restrict__ logz,   // [N]
                                const float* __restrict__ g,      // [N]
                                Out* __restrict__ grad,           // [N, T, W]
                                int T, int S, Frame f)
{
    extern __shared__ float smem[];
    const int W = f.width(S), R = S / NB;
    float* row = smem;         // [W]
    float* Al = row + W;       // [S] alpha_t
    float* Bt = Al + S;        // [S] beta_{t+1}
    const int n = blockIdx.x;
    const int p = threadIdx.x;            // this thread as predecessor
    const bool active = p < S;
    const int j = p / R, r = p % R;       // p = j*R + r

    if (active) Bt[p] = 0.f;
    const float lz = logz[n], gg = g[n];
    const In* src = scores + (size_t)n * T * W;
    Out* dst = grad + (size_t)n * T * W;
    for (int t = T - 1; t >= 0; --t) {
        __syncthreads();  // last frame's Bt visible; row, Al free
        for (int i = threadIdx.x; i < W; i += blockDim.x)
            row[i] = load_score<In, ROUND>(src + (size_t)t * W + i);
        for (int i = threadIdx.x; i < S; i += blockDim.x)
            Al[i] = stack[((size_t)n * T + t) * S + i];
        __syncthreads();
        // the edge posteriors x g, in the scores' own order
        for (int i = threadIdx.x; i < W; i += blockDim.x) {
            int s, jj;
            f.slot(i, S, s, jj);
            const float e = jj < 0 ? (Al[s] + row[i]) + Bt[s]
                                   : (row[i] + Al[jj * R + s / NB]) + Bt[s];
            store_grad<Out, ROUND>(dst + (size_t)t * W + i,
                                   expf(e - lz) * gg);
        }
        float next = 0.f;
        if (active) {
            float mo[NB], mm = -INFINITY;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                mo[b] = f.move(row, S, r * NB + b, j) + Bt[r * NB + b];
                mm = fmaxf(mm, mo[b]);
            }
            float sum = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) sum += expf(mo[b] - mm);
            next = lse2(f.stay(row, p) + Bt[p], mm + logf(sum));
        }
        __syncthreads();  // every read of Bt precedes its update
        if (active) Bt[p] = next;
    }
}

inline int threads_for(int S) { return ((S + 31) / 32) * 32; }

// S = 4**k states, 4 to 1024 (a thread each)
bool bad_shape(int N, int T, int S) {
    return N < 1 || T < 1 || S < NB || S > 1024 || (S & (S - 1)) != 0
        || (S & 0x55555555) == 0;
}

template <class Frame, typename In, bool ROUND, bool STACK>
int launch_fwd(const void* scores, void* stack, void* logz, int N, int T,
               int S, Frame f, cudaStream_t stream) {
    const size_t smem = (size_t)(f.width(S) + S) * sizeof(float);
    logz_fwd_kernel<Frame, In, ROUND, STACK>
        <<<N, threads_for(S), smem, stream>>>(
        static_cast<const In*>(scores), static_cast<float*>(stack),
        static_cast<float*>(logz), T, S, f);
    return (int)cudaGetLastError();
}

template <class Frame, typename In, typename Out, bool ROUND>
int launch_bwd(const void* scores, const void* stack, const void* logz,
               const void* g, void* grad, int N, int T, int S, Frame f,
               cudaStream_t stream) {
    const size_t smem = (size_t)(f.width(S) + 2 * S) * sizeof(float);
    logz_bwd_kernel<Frame, In, Out, ROUND>
        <<<N, threads_for(S), smem, stream>>>(
        static_cast<const In*>(scores), static_cast<const float*>(stack),
        static_cast<const float*>(logz), static_cast<const float*>(g),
        static_cast<Out*>(grad), T, S, f);
    return (int)cudaGetLastError();
}

template <class Frame, typename In>
int fwd_for(const void* scores, int round, void* stack, void* logz, int N,
            int T, int S, Frame f, cudaStream_t st) {
    if (round)
        return stack ? launch_fwd<Frame, In, true, true>(scores, stack, logz,
                                                         N, T, S, f, st)
                     : launch_fwd<Frame, In, true, false>(scores, stack, logz,
                                                          N, T, S, f, st);
    return stack ? launch_fwd<Frame, In, false, true>(scores, stack, logz, N,
                                                      T, S, f, st)
                 : launch_fwd<Frame, In, false, false>(scores, stack, logz, N,
                                                       T, S, f, st);
}

template <class Frame, typename In>
int bwd_for(const void* scores, int round, const void* stack,
            const void* logz, const void* g, void* grad, int out_f32, int N,
            int T, int S, Frame f, cudaStream_t st) {
    if (out_f32)
        return round
            ? launch_bwd<Frame, In, float, true>(scores, stack, logz, g, grad,
                                                 N, T, S, f, st)
            : launch_bwd<Frame, In, float, false>(scores, stack, logz, g,
                                                  grad, N, T, S, f, st);
    return round
        ? launch_bwd<Frame, In, __nv_bfloat16, true>(scores, stack, logz, g,
                                                     grad, N, T, S, f, st)
        : launch_bwd<Frame, In, __nv_bfloat16, false>(scores, stack, logz, g,
                                                      grad, N, T, S, f, st);
}

}  // namespace

extern "C" {

// U (is_full 0: moves [N, T, NB*S] in TCN order, stay = blank) and W
// (is_full 1: scores [N, T, (NB+1)*S]); bf16, or f32 when is_f32; `round`
// rounds them to bf16 on load. -> stack [N, T, S] f32 (alpha before each
// frame; null for the forward-only variant), logz [N] f32
int logz_fwd(const void* scores, int is_f32, int is_full, int round,
             void* stack, void* logz, int N, int T, int S, float blank,
             void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_full)
        return is_f32
            ? fwd_for<FullFrame, float>(scores, round, stack, logz, N, T, S,
                                        FullFrame{}, st)
            : fwd_for<FullFrame, __nv_bfloat16>(scores, round, stack, logz,
                                                N, T, S, FullFrame{}, st);
    const TcnFrame f{blank, 0.f};
    return is_f32 ? fwd_for<TcnFrame, float>(scores, round, stack, logz, N,
                                             T, S, f, st)
                  : fwd_for<TcnFrame, __nv_bfloat16>(scores, round, stack,
                                                     logz, N, T, S, f, st);
}

// V (is_full 0) and X (is_full 1): the scores as for the forward, its
// stack and logz, the cotangent g [N] f32 -> grad in the scores' layout,
// f32 when out_f32 else bf16
int logz_bwd(const void* scores, int is_f32, int is_full, int round,
             const void* stack, const void* logz, const void* g, void* grad,
             int out_f32, int N, int T, int S, float blank, void* stream) {
    if (bad_shape(N, T, S)) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_full)
        return is_f32
            ? bwd_for<FullFrame, float>(scores, round, stack, logz, g, grad,
                                        out_f32, N, T, S, FullFrame{}, st)
            : bwd_for<FullFrame, __nv_bfloat16>(scores, round, stack, logz,
                                                g, grad, out_f32, N, T, S,
                                                FullFrame{}, st);
    const TcnFrame f{blank, 0.f};
    return is_f32
        ? bwd_for<TcnFrame, float>(scores, round, stack, logz, g, grad,
                                   out_f32, N, T, S, f, st)
        : bwd_for<TcnFrame, __nv_bfloat16>(scores, round, stack, logz, g,
                                           grad, out_f32, N, T, S, f, st);
}

}  // extern "C"
