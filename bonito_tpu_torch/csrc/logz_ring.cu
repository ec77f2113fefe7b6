// Kernels U, V, W and X for the H100: logZ of the TCN moves (with the
// alpha stack or without it), its gradient, logZ of the full scores (with
// or without the stack) and its gradient -- the function of the earlier
// kernels in csrc/logz.cu, with the same f32 steps, so the same bits on
// every output -- on the ring of csrc/ring.cuh: each frame's row staged
// ahead in shared memory by a producer warp, one block-wide barrier a
// frame.
//
// U replaces bonito_tpu/ops/logz_pallas.py `_fwd_kernel_tcn` (and
// `_fwd_kernel_tcn_nockpt`: U without its stack), V `_bwd_kernel_tcn`, W
// `_fwd_kernel` (and `_fwd_kernel_nockpt`), X `_bwd_kernel` (W and X: full
// scores [N, T, 5S] with a stay plane, FullFrame of csrc/crf_frames.cuh,
// state s's stay at column 5s, its move from predecessor j*R + s/4 at
// 5s + 1 + j). The
// recurrences and the layout of the moves are in csrc/logz.cu (TcnFrame of
// csrc/crf_frames.cuh: column (b*nb + j)*R + r is the move into state
// s = r*nb + b from predecessor j*R + r; the stay is the constant blank).
// Those earlier kernels stay: ops/logz_cuda.py launches them where
// logz_plan gives no plan, chip_smoke.py holds these against them.
//
// What bounds them on an H100: the serial recursion over T. Per frame and
// state U takes about 6 expf and 2 logf on alpha's chain, V 10 and 2 (4 of
// its exps, the gradient's, off beta's chain); they run in log space with
// no cross-state reduction, so the pace is one frame's chain and the SM's
// issue rate for a row's S states where few rows share the card (sup
// training: 32 rows), the bytes where every SM holds a row (at hac training
// shapes U moves 1.6 GB, 0.47 ms at the card's rate). scripts/
// logz_split.py times the kernels with each part left out.
//
// Per batch row one CTA of consumer threads and a producer warp:
//   the ring   the producer's lane 0 copies each frame's row ahead into a
//              ring of slots (U: the frame's 4S moves; W: its 5S scores; V:
//              its moves and the alpha stack's row, frames T-1 .. 0), one
//              mbarrier `full` a slot; the frame barrier is the slot's
//              `empty`. The consumers read the next frame's values from its
//              slot into registers during a frame (so a ring holds at least
//              2), where they fill the chain's stalls.
//   the states consumer i holds K states (K = 1 or 4, the plan's
//              states_per_thread) of the block q = i % R, those of
//              b = c*K .. c*K + K-1 with c = i / R: in U its states
//              s = 4q + b, whose four predecessors j*R + q the block
//              shares; in V its predecessors p = j*R + q (j = c*K ..) with
//              their successors 4q + b (b = 0..3); in W the states K*i ..
//              K*i + K-1 (FullSlot). Threads past the states compute thread
//              0's and store nothing.
//   one barrier a frame  alpha (beta) lives in two parity buffers in shared
//              memory; a thread reads its inputs from the frame's parity,
//              writes its K new values to the other, then the one
//              __syncthreads.
//   the stores U's and W's stack (alpha before each frame) goes out as one
//              K-wide store of the thread's own alpha a frame; V's gradient
//              as 4K warp-wide stores a thread a frame, in the moves'
//              layout, two values rounded to bf16 by one conversion (one
//              bulk store a frame, of the parity buffer or of a staged
//              gradient row, was slower or no faster: PERF.md).
//   the end    consumer warp 0 takes logZ from alpha_T: the max over the
//              states, then the sum of exp(a - max) in block_sum's tree
//              (the xor butterfly of each run of 32 states, then of the
//              runs), as the earlier kernel's block_max and block_sum_max.
// Each state's f32 steps are the earlier kernel's whatever thread takes
// them (the sums over j or b in order 0..3, then lse2), so every assignment
// of states to threads gives the same bits.
//
// W is U's kernel for the full scores' layout: the forward ring is written
// once (fwd_ring) over a slot-reading functor, TcnSlot for U and FullSlot
// for W, which says which states a consumer takes and reads its scores of
// a frame into registers; U's steps, and so its bits, are as before. A
// slot holds a frame's 5S scores (20,480 B at S 1024 in f32: 8 of them,
// alpha and the mbarriers 172,096 B; 90,176 B in bf16). A consumer takes
// K consecutive states, whose 5K scores are consecutive in the slot (five
// 16-byte loads at K 4 in f32), and each state's stay is read with its
// moves in place of U's constant blank: the same f32 steps, so the earlier
// W's bits. At hac training shapes W moves 2.62 GB of f32 scores and 0.52
// GB of stack, 0.94 ms at the card's rate.
//
// X is V's kernel for the full scores' layout. A slot holds a frame's 5S
// scores and its alpha row (24,576 B at S 1024 in f32, 8 of them 204,864 B
// with beta and the mbarriers); it is read again by the frame's own
// gradient pass, so it is refilled one frame later than V's. The chain's
// consumers hold V's predecessors and read the next frame's chain values
// (16 moves and 4 stays a thread at K 4) during a frame, the lanes of a
// warp on four predecessors j at once (lane q's k-th read takes j = (k +
// q/8) mod 4): the moves into 4q + b lie 20 words apart between blocks q,
// so one j for the whole warp is a 4-way bank conflict. The gradient is
// one pass over the frame's 5S columns in the scores' order by every
// consumer thread, more of them than the chain has (one column a thread,
// up to 384: ops/logz_cuda.py's X_CONSUMERS), consecutive threads on
// consecutive columns (coalesced stores, the stay's gradient in the same
// row), from the slot and beta_{t+1}'s parity buffer, which the frame's
// barrier has completed: no barrier more. What bounds X at hac training
// shapes: the bytes (2.6 GB of f32 scores in, as many out, 0.52 GB of
// stack), 1.72 ms at the card's rate; what paces it there and at sup (32
// rows, one SM each): the per-frame issue of the pass and the chain, their
// exps and logs (a third of the time: scripts/logz_split.py x). Measured
// and not kept (PERF.md): V's lane layout; the chain's warps out of the
// gradient's pass (at S 1024 slower at every count of consumers: the pass
// sets the pace; at S 64 none faster than the plan); the alpha row in four pieces with 4 words of padding each
// against the pass's 4-way conflicts in its reads of alpha[j*R + s/4]
// (four bulk copies more a frame: slower).

#include "crf_frames.cuh"
#include "logz_steps.cuh"
#include "ring.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// the parts scripts/logz_split.py leaves out (LOGZ_CUT, 0 in the library;
// bit 2, the exps and logs, in csrc/logz_steps.cuh)
constexpr int LCUT_WAITS = 1;   // the ring's copies and waits
constexpr int LCUT_STORES = 4;  // the stack's or the gradient's stores

__device__ __forceinline__ constexpr bool lcut(int part) {
    return (LOGZ_CUT & part) != 0;
}

// the most threads a CTA has: 8 consumer warps (K 4 up to S 1024, K 1 up
// to S 256) and the producer warp
constexpr int LOGZ_THREADS = 256 + 32;

__host__ __device__ inline int logz_consumers(int S, int K) {
    return (S / K + 31) / 32 * 32;
}

// shared memory: the mbarriers, alpha or beta of two parities ([2][S] f32)
// and the ring of slots (U: the frame's moves; W: its `cols` = 5 scores a
// state; V: its moves and alpha_t)
__host__ __device__ inline size_t logz_head(int ring) {
    return (size_t)(ring * 8 + 15) / 16 * 16;
}
__host__ __device__ inline size_t logz_fwd_smem(int S, int ring,
                                                size_t in_bytes,
                                                int cols = NB) {
    return logz_head(ring) + (size_t)8 * S + ring * (cols * S * in_bytes);
}
__host__ __device__ inline size_t logz_bwd_smem(int S, int ring,
                                                size_t in_bytes) {
    return logz_head(ring) + (size_t)8 * S
        + ring * (NB * S * in_bytes + (size_t)4 * S);
}

template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
    if constexpr (K == 4) {
        const float4 a = *reinterpret_cast<const float4*>(p);
        v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    } else {
        v[0] = *p;
    }
}

template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
    if constexpr (K == 4)
        *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    else
        *p = v[0];
}

// the mbarriers' init by one thread, before the block's first barrier
__device__ __forceinline__ void init_full(uint64_t* full, int ring) {
    for (int s = 0; s < ring; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// two gradient values into their columns, rounded as store_grad rounds
// them, with one conversion of the pair to bf16 where there is one
template <typename Out, bool ROUND>
__device__ __forceinline__ void store_grad2(Out* pa, Out* pb, float a,
                                            float b) {
    if constexpr (std::is_same<Out, bf16>::value) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        *pa = h.x;
        *pb = h.y;
    } else if constexpr (ROUND) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
        *pa = __low2float(h);
        *pb = __high2float(h);
    } else {
        *pa = a;
        *pb = b;
    }
}

// ---------------------------------------------------------- kernels U, W
// What a consumer of the forward ring holds of a frame: the moves into its
// K states from slots j = 0..3 and their stays (the frame's, and the next
// frame's read from its slot a frame early)
template <int K>
struct FwdVals {
    float mv[K][NB];
    float st[K];
};

// U's slot: the frame's 4S moves in TCN order (TcnFrame), the stay the
// constant blank. Consumer i takes block q = i % R and its states 4q + c0
// .. 4q + c0 + K-1, c0 = (i / R) * K: consecutive threads read consecutive
// columns ((c0 + k)*4 + j)*R + q.
template <typename In, bool ROUND, int K>
struct TcnSlot {
    static constexpr int COLS = NB;  // a frame's scores a state
    float blank;
    __device__ __forceinline__ void place(int i, int R, int& q,
                                          int& c0) const {
        q = i % R;
        c0 = i / R * K;
    }
    __device__ __forceinline__ void read(const unsigned char* slot, int R,
                                         int q, int c0,
                                         FwdVals<K>& v) const {
        const In* row = reinterpret_cast<const In*>(slot);
#pragma unroll
        for (int k = 0; k < K; ++k)
#pragma unroll
            for (int j = 0; j < NB; ++j)
                v.mv[k][j] = load_score<In, ROUND>(
                    row + ((c0 + k) * NB + j) * R + q);
    }
    __device__ __forceinline__ float stay(const FwdVals<K>&, int) const {
        return blank;
    }
};

// n scores from p into f32, rounded as load_score rounds them: f32 at n a
// multiple of 4 in 16-byte loads
template <typename In, bool ROUND, int N>
__device__ __forceinline__ void load_scores(const In* p, float (&x)[N]) {
    if constexpr (N % 4 == 0 && std::is_same<In, float>::value) {
#pragma unroll
        for (int m = 0; m < N / 4; ++m) {
            const float4 a = reinterpret_cast<const float4*>(p)[m];
            x[4 * m] = a.x; x[4 * m + 1] = a.y;
            x[4 * m + 2] = a.z; x[4 * m + 3] = a.w;
        }
#pragma unroll
        for (int m = 0; m < N; ++m)
            if (ROUND) x[m] = __bfloat162float(__float2bfloat16_rn(x[m]));
    } else {
#pragma unroll
        for (int m = 0; m < N; ++m) x[m] = load_score<In, ROUND>(p + m);
    }
}

// W's slot: the frame's 5S scores (FullFrame: state s's stay at column 5s,
// its move from slot j at 5s + 1 + j). Consumer i takes the K consecutive
// states s0 = K*i .. (block q = s0 / 4, c0 = s0 % 4), whose 5K scores are
// consecutive: in f32 at K 4 five 16-byte loads at word 20i (8 consecutive
// threads on 8 distinct groups of 4 banks), at K 1 five words at 5i (5 is
// odd: 32 distinct banks); in bf16 (no default path: `loss` casts to f32)
// one score a load.
template <typename In, bool ROUND, int K>
struct FullSlot {
    static constexpr int COLS = NB + 1;
    __device__ __forceinline__ void place(int i, int, int& q,
                                          int& c0) const {
        q = i * K / NB;
        c0 = i * K % NB;
    }
    __device__ __forceinline__ void read(const unsigned char* slot, int,
                                         int q, int c0,
                                         FwdVals<K>& v) const {
        float x[COLS * K];
        load_scores<In, ROUND>(
            reinterpret_cast<const In*>(slot) + (NB * q + c0) * COLS, x);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            v.st[k] = x[k * COLS];
#pragma unroll
            for (int j = 0; j < NB; ++j) v.mv[k][j] = x[k * COLS + 1 + j];
        }
    }
    __device__ __forceinline__ float stay(const FwdVals<K>& v, int k) const {
        return v.st[k];
    }
};

// the forward ring over a slot's layout (U: TcnSlot, W: FullSlot): scores
// [N, T, COLS*S], the stack [N, T, S] or null, logz [N]
template <class Slot, typename In, bool STACK, int K>
__device__ __forceinline__ void fwd_ring(const Slot& f,
                                         const In* __restrict__ scores,
                                         float* __restrict__ stack,
                                         float* __restrict__ logz, int T,
                                         int S, int ring)
{
    extern __shared__ __align__(16) unsigned char logz_smem[];
    const int R = S / NB, NC = logz_consumers(S, K);
    const unsigned row_bytes = (unsigned)(Slot::COLS * S * sizeof(In));
    uint64_t* full = reinterpret_cast<uint64_t*>(logz_smem);
    float* alpha = reinterpret_cast<float*>(logz_smem + logz_head(ring));
    unsigned char* rows = reinterpret_cast<unsigned char*>(alpha + 2 * S);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const size_t row0 = (size_t)blockIdx.x * T;

    // alpha_0 = 0 in parity 0
    for (int i = tid; i < S; i += blockDim.x) alpha[i] = 0.f;
    if (tid == NC) init_full(full, ring);
    __syncthreads();

    if (w == NC / 32) {
        // --------------------------------------------------- producer warp
        int issued = 0;
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                if (!lcut(LCUT_WAITS))
                    fill(full + s, rows + (size_t)s * row_bytes, row_bytes,
                         issued >= ring,
                         scores + (row0 + issued) * Slot::COLS * S,
                         row_bytes);
            }
        };
        if (lane == 0) issue(min(ring, T));
        for (int t = 0; t < T; ++t) {
            __syncthreads();  // the rows of frames up to t + 1 are read
            if (lane == 0) issue(min(T, t + 2 + ring));
        }
        return;
    }

    // ------------------------------------------------------------ consumers
    const bool active = tid < S / K;
    int q, c0;
    f.place(active ? tid : 0, R, q, c0);
    const int s0 = NB * q + c0;  // the first of its states
    // the next frame's slot: frame min(t + 1, T - 1)
    Cursor cur = {0, 0, ring};
    // frame t: its scores in v, the next frame's read into vn on the way
    auto frame = [&](int t, const float* ap, float* an, const FwdVals<K>& v,
                     FwdVals<K>& vn) {
        if (!lcut(LCUT_WAITS))
            mbar_wait(full + cur.slot, (unsigned)cur.phase);
        float pred[NB], own[K], nxt[K];
#pragma unroll
        for (int j = 0; j < NB; ++j) pred[j] = ap[j * R + q];
        load_k<K>(ap + s0, own);
        if (STACK && active && !lcut(LCUT_STORES))
            store_k<K>(stack + (row0 + t) * S + s0, own);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float cand[NB], m = -INFINITY;
#pragma unroll
            for (int j = 0; j < NB; ++j) {
                cand[j] = v.mv[k][j] + pred[j];
                m = fmaxf(m, cand[j]);
            }
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < NB; ++j) sum += exp_f(cand[j] - m);
            nxt[k] = lse2(f.stay(v, k) + own[k], m + log_f(sum));
        }
        f.read(rows + (size_t)cur.slot * row_bytes, R, q, c0, vn);
        if (active) store_k<K>(an + s0, nxt);
        if (t + 2 < T) cur.next();
        __syncthreads();
    };
    FwdVals<K> v0, v1;
    if (!lcut(LCUT_WAITS)) mbar_wait(full, 0u);
    f.read(rows, R, q, c0, v0);
    if (T > 1) cur.next();
    float* const a0 = alpha;
    float* const a1 = alpha + S;
    int t = 0;
    for (; t + 1 < T; t += 2) {
        frame(t, a0, a1, v0, v1);
        frame(t + 1, a1, a0, v1, v0);
    }
    if (t < T) frame(t, a0, a1, v0, v1);

    // logZ from alpha_T: the max, then the sum in block_sum's tree
    if (w == 0) {
        const float* end = alpha + (T & 1) * S;
        float mx = -INFINITY;
        for (int s = lane; s < S; s += 32) mx = fmaxf(mx, end[s]);
        for (int o = 16; o > 0; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        float sum = 0.f;
        for (int k = 0; 32 * k < S; ++k) {
            float x = 32 * k + lane < S ? exp_f(end[32 * k + lane] - mx) : 0.f;
            for (int o = 16; o > 0; o >>= 1)
                x += __shfl_xor_sync(0xffffffffu, x, o);
            if (lane == k) sum = x;
        }
        for (int o = 16; o > 0; o >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, o);
        if (lane == 0) logz[blockIdx.x] = mx + log_f(sum);
    }
}

// --------------------------------------------------------------- kernel U
template <typename In, bool ROUND, bool STACK, int K>
__global__ void __launch_bounds__(LOGZ_THREADS, 1)
logz_fwd_ring_kernel(const In* __restrict__ moves,  // [N, T, 4S]
                     float* __restrict__ stack,     // [N, T, S] or null
                     float* __restrict__ logz,      // [N]
                     int T, int S, int ring, float blank)
{
    fwd_ring<TcnSlot<In, ROUND, K>, In, STACK, K>(
        TcnSlot<In, ROUND, K>{blank}, moves, stack, logz, T, S, ring);
}

// --------------------------------------------------------------- kernel W
template <typename In, bool ROUND, bool STACK, int K>
__global__ void __launch_bounds__(LOGZ_THREADS, 1)
logz_full_fwd_ring_kernel(const In* __restrict__ scores,  // [N, T, 5S]
                          float* __restrict__ stack,  // [N, T, S] or null
                          float* __restrict__ logz,   // [N]
                          int T, int S, int ring)
{
    fwd_ring<FullSlot<In, ROUND, K>, In, STACK, K>(
        FullSlot<In, ROUND, K>{}, scores, stack, logz, T, S, ring);
}

// --------------------------------------------------------------- kernel V
template <typename In, typename Out, bool ROUND, int K>
__global__ void __launch_bounds__(LOGZ_THREADS, 1)
logz_bwd_ring_kernel(const In* __restrict__ moves,    // [N, T, 4S]
                     const float* __restrict__ stack, // [N, T, S]
                     const float* __restrict__ logz,  // [N]
                     const float* __restrict__ g,     // [N]
                     Out* __restrict__ grad,          // [N, T, 4S]
                     int T, int S, int ring, float blank)
{
    extern __shared__ __align__(16) unsigned char logz_smem[];
    const int R = S / NB, NC = logz_consumers(S, K);
    const unsigned row_bytes = (unsigned)(NB * S * sizeof(In));
    const unsigned slot_bytes = row_bytes + 4u * S;
    uint64_t* full = reinterpret_cast<uint64_t*>(logz_smem);
    float* beta = reinterpret_cast<float*>(logz_smem + logz_head(ring));
    unsigned char* rows = reinterpret_cast<unsigned char*>(beta + 2 * S);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n = blockIdx.x;
    const size_t row0 = (size_t)n * T;

    // beta_T = 0 in parity 0
    for (int i = tid; i < S; i += blockDim.x) beta[i] = 0.f;
    if (tid == NC) init_full(full, ring);
    __syncthreads();

    if (w == NC / 32) {
        // --------------------------------------------------- producer warp
        int issued = 0;  // frames i = 0, 1, ... (t = T-1-i) in the ring
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                const size_t f = row0 + T - 1 - issued;
                if (!lcut(LCUT_WAITS))
                    fill(full + s, rows + (size_t)s * slot_bytes, slot_bytes,
                         issued >= ring, moves + f * NB * S, row_bytes,
                         stack + f * S, 4u * S);
            }
        };
        if (lane == 0) issue(min(ring, T));
        for (int i = 0; i < T; ++i) {
            __syncthreads();  // the slots of frames up to i + 1 are read
            if (lane == 0) issue(min(T, i + 2 + ring));
        }
        return;
    }

    // ------------------------------------------------------------ consumers
    const bool active = tid < S / K;
    const int i0 = active ? tid : 0;
    const int q = i0 % R, c = i0 / R;  // predecessors j*R + q, j = c*K ..
    const float lz = logz[n], gg = g[n];
    float sink = 0.f;  // what the gradient's stores take (their cut)
    // a frame's slot: the moves out of its predecessors into 4q + b, and
    // their alpha_t
    auto read_slot = [&](const unsigned char* slot, float (&mv)[NB][K],
                         float (&al)[K]) {
        const In* row = reinterpret_cast<const In*>(slot);
        const float* a = reinterpret_cast<const float*>(slot + row_bytes);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = c * K + k;
            al[k] = a[j * R + q];
#pragma unroll
            for (int b = 0; b < NB; ++b)
                mv[b][k] = load_score<In, ROUND>(row + (b * NB + j) * R + q);
        }
    };
    // the next frame's slot: frame min(i + 1, T - 1)
    Cursor cur = {0, 0, ring};
    // frame i (t = T-1-i): its values in mv and al, the next frame's read
    // into mvn and aln on the way
    auto frame = [&](int i, const float* bp, float* bn,
                     const float (&mv)[NB][K], const float (&al)[K],
                     float (&mvn)[NB][K], float (&aln)[K]) {
        const int t = T - 1 - i;
        if (!lcut(LCUT_WAITS))
            mbar_wait(full + cur.slot, (unsigned)cur.phase);
        Out* dst = grad + (row0 + t) * NB * S;
        float Bs[NB], Bp[K], nxt[K];
        load_k<NB>(bp + NB * q, Bs);
#pragma unroll
        for (int k = 0; k < K; ++k) Bp[k] = bp[(c * K + k) * R + q];
        // the edge posteriors x g, in the moves' layout, two at a time
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = c * K + k;
            float v[NB];
#pragma unroll
            for (int b = 0; b < NB; ++b)
                v[b] = exp_f(((mv[b][k] + al[k]) + Bs[b]) - lz) * gg;
            if (lcut(LCUT_STORES)) {
                sink += (v[0] + v[1]) + (v[2] + v[3]);
            } else if (active) {
#pragma unroll
                for (int b = 0; b < NB; b += 2)
                    store_grad2<Out, ROUND>(dst + (b * NB + j) * R + q,
                                            dst + ((b + 1) * NB + j) * R + q,
                                            v[b], v[b + 1]);
            }
        }
        // beta_t of its predecessors
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float mo[NB], mm = -INFINITY;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                mo[b] = mv[b][k] + Bs[b];
                mm = fmaxf(mm, mo[b]);
            }
            float sum = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) sum += exp_f(mo[b] - mm);
            nxt[k] = lse2(blank + Bp[k], mm + log_f(sum));
        }
        read_slot(rows + (size_t)cur.slot * slot_bytes, mvn, aln);
        if (active) {
#pragma unroll
            for (int k = 0; k < K; ++k) bn[(c * K + k) * R + q] = nxt[k];
        }
        if (i + 2 < T) cur.next();
        __syncthreads();
    };
    float mv0[NB][K], mv1[NB][K], al0[K], al1[K];
    if (!lcut(LCUT_WAITS)) mbar_wait(full, 0u);
    read_slot(rows, mv0, al0);
    if (T > 1) cur.next();
    float* const b0 = beta;
    float* const b1 = beta + S;
    int i = 0;
    for (; i + 1 < T; i += 2) {
        frame(i, b0, b1, mv0, al0, mv1, al1);
        frame(i + 1, b1, b0, mv1, al1, mv0, al0);
    }
    if (i < T) frame(i, b0, b1, mv0, al0, mv1, al1);
    if (lcut(LCUT_STORES) && sink == 0.125f) grad[row0 * NB * S] = Out(sink);
}

// --------------------------------------------------------------- kernel X
// the most threads a CTA of X has: 20 consumer warps and the producer
// (at most 97 registers a thread; the instances take 51 and 90)
constexpr int X_THREADS = 640 + 32;

// shared memory of X: the mbarriers, beta of two parities and the ring of
// slots, each a frame's 5S scores and its row of the alpha stack
__host__ __device__ inline size_t logz_full_bwd_smem(int S, int ring,
                                                     size_t in_bytes) {
    return logz_head(ring) + (size_t)8 * S
        + ring * ((NB + 1) * S * in_bytes + (size_t)4 * S);
}

// kernel X: `nc` consumer threads (whole warps), K predecessors a thread
// for the chain's first S / K of them, every one of them in the gradient's
// pass
template <typename In, typename Out, bool ROUND, int K>
__global__ void __launch_bounds__(X_THREADS, 1)
logz_full_bwd_ring_kernel(const In* __restrict__ scores,   // [N, T, 5S]
                          const float* __restrict__ stack, // [N, T, S]
                          const float* __restrict__ logz,  // [N]
                          const float* __restrict__ g,     // [N]
                          Out* __restrict__ grad,          // [N, T, 5S]
                          int T, int S, int nc, int ring)
{
    extern __shared__ __align__(16) unsigned char logz_smem[];
    const int R = S / NB, W = (NB + 1) * S;
    const unsigned row_bytes = (unsigned)(W * sizeof(In));
    const unsigned slot_bytes = row_bytes + 4u * S;
    uint64_t* full = reinterpret_cast<uint64_t*>(logz_smem);
    float* beta = reinterpret_cast<float*>(logz_smem + logz_head(ring));
    unsigned char* rows = reinterpret_cast<unsigned char*>(beta + 2 * S);
    const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
    const int n = blockIdx.x;
    const size_t row0 = (size_t)n * T;

    // beta_T = 0 in parity 0
    for (int i = tid; i < S; i += blockDim.x) beta[i] = 0.f;
    if (tid == nc) init_full(full, ring);
    __syncthreads();

    if (w == nc / 32) {
        // --------------------------------------------------- producer warp
        int issued = 0;  // frames i = 0, 1, ... (t = T-1-i) in the ring
        auto issue = [&](int upto) {
            for (; issued < upto; ++issued) {
                const int s = issued % ring;
                const size_t f = row0 + T - 1 - issued;
                if (!lcut(LCUT_WAITS))
                    fill(full + s, rows + (size_t)s * slot_bytes, slot_bytes,
                         issued >= ring, scores + f * W, row_bytes,
                         stack + f * S, 4u * S);
            }
        };
        if (lane == 0) issue(min(ring, T));
        for (int i = 0; i < T; ++i) {
            // frame i's slot, read by its own gradient pass, is free
            __syncthreads();
            if (lane == 0) issue(min(T, i + 1 + ring));
        }
        return;
    }

    // ------------------------------------------------------------ consumers
    const bool active = tid < S / K;
    const int i0 = active ? tid : 0;
    // V's predecessors, j*R + q for j = j0 .. j0 + K-1, taken in the order
    // j0 + (k + q/8) % K: at K 4 the lanes of a warp read four j at once,
    // so that a read of the moves into 4q + b (word 5(4q + b) + 1 + j: 8
    // blocks q cover 8 banks, 4 apart) covers the 32 banks
    const int q = i0 % R, j0 = (i0 / R) * K;
    auto pj = [&](int k) { return j0 + ((k + (q >> 3)) & (K - 1)); };
    const float lz = logz[n], gg = g[n];
    float sink = 0.f;  // what the gradient's stores take (their cut)
    // the chain's values of a frame: the moves out of its predecessors
    // into 4q + b, and their stays
    auto read_chain = [&](const unsigned char* slot, float (&mv)[NB][K],
                          float (&st)[K]) {
        const In* row = reinterpret_cast<const In*>(slot);
#pragma unroll
        for (int k = 0; k < K; ++k) {
            const int j = pj(k);
            st[k] = load_score<In, ROUND>(row + (j * R + q) * (NB + 1));
#pragma unroll
            for (int b = 0; b < NB; ++b)
                mv[b][k] = load_score<In, ROUND>(
                    row + (NB * q + b) * (NB + 1) + 1 + j);
        }
    };
    // the next frame's slot: frame min(i + 1, T - 1)
    Cursor cur = {0, 0, ring};
    // frame i (t = T-1-i) in slot `here`: the chain from its values in mv
    // and st, the gradient from its slot, the next frame's chain values
    // read into mvn and stn on the way
    auto frame = [&](int i, int here, const float* bp, float* bn,
                     const float (&mv)[NB][K], const float (&st)[K],
                     float (&mvn)[NB][K], float (&stn)[K]) {
        const int t = T - 1 - i;
        if (!lcut(LCUT_WAITS))
            mbar_wait(full + cur.slot, (unsigned)cur.phase);
        // beta_t of its predecessors
        float Bs[NB], Bp[K], nxt[K];
        load_k<NB>(bp + NB * q, Bs);
#pragma unroll
        for (int k = 0; k < K; ++k) Bp[k] = bp[pj(k) * R + q];
#pragma unroll
        for (int k = 0; k < K; ++k) {
            float mo[NB], mm = -INFINITY;
#pragma unroll
            for (int b = 0; b < NB; ++b) {
                mo[b] = mv[b][k] + Bs[b];
                mm = fmaxf(mm, mo[b]);
            }
            float sum = 0.f;
#pragma unroll
            for (int b = 0; b < NB; ++b) sum += exp_f(mo[b] - mm);
            nxt[k] = lse2(st[k] + Bp[k], mm + log_f(sum));
        }
        // the edge posteriors x g over the frame's columns, in the scores'
        // order: the stay (alpha_t[s] + stay) + beta[s], a move
        // (move + alpha_t[j*R + s/4]) + beta[s], as the earlier kernel
        const unsigned char* slot = rows + (size_t)here * slot_bytes;
        const In* row = reinterpret_cast<const In*>(slot);
        const float* al = reinterpret_cast<const float*>(slot + row_bytes);
        Out* dst = grad + (row0 + t) * W;
#pragma unroll 4
        for (int col = tid; col < W; col += nc) {
            const int s = col / (NB + 1), jj = col - s * (NB + 1) - 1;
            const float x = load_score<In, ROUND>(row + col);
            const float e = jj < 0 ? (al[s] + x) + bp[s]
                                   : (x + al[jj * R + s / NB]) + bp[s];
            const float v = exp_f(e - lz) * gg;
            if (lcut(LCUT_STORES))
                sink += v;
            else
                store_grad<Out, ROUND>(dst + col, v);
        }
        read_chain(rows + (size_t)cur.slot * slot_bytes, mvn, stn);
        if (active) {
#pragma unroll
            for (int k = 0; k < K; ++k) bn[pj(k) * R + q] = nxt[k];
        }
        if (i + 2 < T) cur.next();
        __syncthreads();
    };
    float mv0[NB][K], mv1[NB][K], st0[K], st1[K];
    if (!lcut(LCUT_WAITS)) mbar_wait(full, 0u);
    read_chain(rows, mv0, st0);
    if (T > 1) cur.next();
    float* const b0 = beta;
    float* const b1 = beta + S;
    int i = 0, here = 0;
    for (; i + 1 < T; i += 2) {
        frame(i, here, b0, b1, mv0, st0, mv1, st1);
        here = here + 1 == ring ? 0 : here + 1;
        frame(i + 1, here, b1, b0, mv1, st1, mv0, st0);
        here = here + 1 == ring ? 0 : here + 1;
    }
    if (i < T) frame(i, here, b0, b1, mv0, st0, mv1, st1);
    if (lcut(LCUT_STORES) && sink == 0.125f) grad[row0 * W] = Out(sink);
}

// S = 4**k, 4 to 1024; K 1 or 4 states a thread within LOGZ_THREADS; a
// ring of 2 (a frame's row and the next one's) to RING_MAX
bool bad_logz_ring(int N, int T, int S, int K, int ring) {
    return N < 1 || T < 1 || S < NB || S > 1024 || (S & (S - 1)) != 0
        || (S & 0x55555555) == 0 || (K != 1 && K != 4)
        || logz_consumers(S, K) + 32 > LOGZ_THREADS || ring < 2
        || ring > RING_MAX;
}

template <typename In, bool ROUND, bool STACK, int K>
int launch_fwd(const void* moves, void* stack, void* logz, int N, int T,
               int S, int ring, float blank, cudaStream_t stream) {
    const size_t smem = logz_fwd_smem(S, ring, sizeof(In));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = logz_fwd_ring_kernel<In, ROUND, STACK, K>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N, logz_consumers(S, K) + 32, smem, stream>>>(
        static_cast<const In*>(moves), static_cast<float*>(stack),
        static_cast<float*>(logz), T, S, ring, blank);
    return (int)cudaGetLastError();
}

template <typename In, bool ROUND, bool STACK, int K>
int launch_full_fwd(const void* scores, void* stack, void* logz, int N,
                    int T, int S, int ring, cudaStream_t stream) {
    const size_t smem = logz_fwd_smem(S, ring, sizeof(In), NB + 1);
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = logz_full_fwd_ring_kernel<In, ROUND, STACK, K>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N, logz_consumers(S, K) + 32, smem, stream>>>(
        static_cast<const In*>(scores), static_cast<float*>(stack),
        static_cast<float*>(logz), T, S, ring);
    return (int)cudaGetLastError();
}

template <typename In, typename Out, bool ROUND, int K>
int launch_bwd(const void* moves, const void* stack, const void* logz,
               const void* g, void* grad, int N, int T, int S, int ring,
               float blank, cudaStream_t stream) {
    const size_t smem = logz_bwd_smem(S, ring, sizeof(In));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = logz_bwd_ring_kernel<In, Out, ROUND, K>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N, logz_consumers(S, K) + 32, smem, stream>>>(
        static_cast<const In*>(moves), static_cast<const float*>(stack),
        static_cast<const float*>(logz), static_cast<const float*>(g),
        static_cast<Out*>(grad), T, S, ring, blank);
    return (int)cudaGetLastError();
}

template <typename In, typename Out, bool ROUND, int K>
int launch_full_bwd(const void* scores, const void* stack, const void* logz,
                    const void* g, void* grad, int N, int T, int S, int nc,
                    int ring, cudaStream_t stream) {
    const size_t smem = logz_full_bwd_smem(S, ring, sizeof(In));
    if (smem > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = logz_full_bwd_ring_kernel<In, Out, ROUND, K>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<N, nc + 32, smem, stream>>>(
        static_cast<const In*>(scores), static_cast<const float*>(stack),
        static_cast<const float*>(logz), static_cast<const float*>(g),
        static_cast<Out*>(grad), T, S, nc, ring);
    return (int)cudaGetLastError();
}

template <typename In, typename Out>
int full_bwd_for(int round, int K, const void* scores, const void* stack,
                 const void* logz, const void* g, void* grad, int N, int T,
                 int S, int nc, int ring, cudaStream_t st) {
    if (round)
        return K == 4 ? launch_full_bwd<In, Out, true, 4>(
                            scores, stack, logz, g, grad, N, T, S, nc, ring,
                            st)
                      : launch_full_bwd<In, Out, true, 1>(
                            scores, stack, logz, g, grad, N, T, S, nc, ring,
                            st);
    return K == 4 ? launch_full_bwd<In, Out, false, 4>(
                        scores, stack, logz, g, grad, N, T, S, nc, ring, st)
                  : launch_full_bwd<In, Out, false, 1>(
                        scores, stack, logz, g, grad, N, T, S, nc, ring, st);
}

template <typename In, bool ROUND, bool STACK>
int fwd_k(int K, const void* moves, void* stack, void* logz, int N, int T,
          int S, int ring, float blank, cudaStream_t st) {
    if (K == 4)
        return launch_fwd<In, ROUND, STACK, 4>(moves, stack, logz, N, T, S,
                                               ring, blank, st);
    return launch_fwd<In, ROUND, STACK, 1>(moves, stack, logz, N, T, S, ring,
                                           blank, st);
}

template <typename In, bool ROUND>
int fwd_stack(int K, const void* moves, void* stack, void* logz, int N,
              int T, int S, int ring, float blank, cudaStream_t st) {
    return stack ? fwd_k<In, ROUND, true>(K, moves, stack, logz, N, T, S,
                                          ring, blank, st)
                 : fwd_k<In, ROUND, false>(K, moves, stack, logz, N, T, S,
                                           ring, blank, st);
}

template <typename In, bool ROUND, bool STACK>
int full_fwd_k(int K, const void* scores, void* stack, void* logz, int N,
               int T, int S, int ring, cudaStream_t st) {
    return K == 4 ? launch_full_fwd<In, ROUND, STACK, 4>(scores, stack, logz,
                                                         N, T, S, ring, st)
                  : launch_full_fwd<In, ROUND, STACK, 1>(scores, stack, logz,
                                                         N, T, S, ring, st);
}

template <typename In>
int full_fwd_for(int round, int K, const void* scores, void* stack,
                 void* logz, int N, int T, int S, int ring, cudaStream_t st) {
    if (round)
        return stack ? full_fwd_k<In, true, true>(K, scores, stack, logz, N,
                                                  T, S, ring, st)
                     : full_fwd_k<In, true, false>(K, scores, stack, logz, N,
                                                   T, S, ring, st);
    return stack ? full_fwd_k<In, false, true>(K, scores, stack, logz, N, T,
                                               S, ring, st)
                 : full_fwd_k<In, false, false>(K, scores, stack, logz, N, T,
                                                S, ring, st);
}

template <typename In, typename Out, bool ROUND>
int bwd_k(int K, const void* moves, const void* stack, const void* logz,
          const void* g, void* grad, int N, int T, int S, int ring,
          float blank, cudaStream_t st) {
    if (K == 4)
        return launch_bwd<In, Out, ROUND, 4>(moves, stack, logz, g, grad, N,
                                             T, S, ring, blank, st);
    return launch_bwd<In, Out, ROUND, 1>(moves, stack, logz, g, grad, N, T,
                                         S, ring, blank, st);
}

template <typename In, typename Out>
int bwd_round(int round, int K, const void* moves, const void* stack,
              const void* logz, const void* g, void* grad, int N, int T,
              int S, int ring, float blank, cudaStream_t st) {
    return round ? bwd_k<In, Out, true>(K, moves, stack, logz, g, grad, N, T,
                                        S, ring, blank, st)
                 : bwd_k<In, Out, false>(K, moves, stack, logz, g, grad, N,
                                         T, S, ring, blank, st);
}

}  // namespace

extern "C" {

// kernel U on a ring of `ring` frames, `k` states a consumer thread: as
// logz_fwd with is_full 0 (moves bf16, or f32 when is_f32; the stack null
// for the forward-only variant)
int logz_tcn_fwd_ring(const void* moves, int is_f32, int round, void* stack,
                      void* logz, int N, int T, int S, int k, int ring,
                      float blank, void* stream) {
    if (bad_logz_ring(N, T, S, k, ring) || !aligned16(moves)
        || (stack && !aligned16(stack)))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f32)
        return round ? fwd_stack<float, true>(k, moves, stack, logz, N, T, S,
                                              ring, blank, st)
                     : fwd_stack<float, false>(k, moves, stack, logz, N, T, S,
                                               ring, blank, st);
    return round ? fwd_stack<bf16, true>(k, moves, stack, logz, N, T, S,
                                           ring, blank, st)
                 : fwd_stack<bf16, false>(k, moves, stack, logz, N, T, S,
                                            ring, blank, st);
}

// kernel W on a ring of `ring` frames, `k` states a consumer thread: as
// logz_fwd with is_full 1 (scores bf16, or f32 when is_f32; each frame's
// row of 5S scores a whole number of 16-byte pieces)
int logz_full_fwd_ring(const void* scores, int is_f32, int round,
                       void* stack, void* logz, int N, int T, int S, int k,
                       int ring, void* stream) {
    if (bad_logz_ring(N, T, S, k, ring) || !aligned16(scores)
        || (stack && !aligned16(stack))
        || ((NB + 1) * S * (is_f32 ? 4 : 2)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return is_f32 ? full_fwd_for<float>(round, k, scores, stack, logz, N, T,
                                        S, ring, st)
                  : full_fwd_for<bf16>(round, k, scores, stack, logz, N, T, S,
                                       ring, st);
}

// kernel V on a ring of `ring` frames, `k` states a consumer thread: as
// logz_bwd with is_full 0
int logz_tcn_bwd_ring(const void* moves, int is_f32, int round,
                      const void* stack, const void* logz, const void* g,
                      void* grad, int out_f32, int N, int T, int S, int k,
                      int ring, float blank, void* stream) {
    if (bad_logz_ring(N, T, S, k, ring) || !aligned16(moves)
        || !aligned16(stack) || !aligned16(grad))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f32)
        return out_f32
            ? bwd_round<float, float>(round, k, moves, stack, logz, g, grad,
                                      N, T, S, ring, blank, st)
            : bwd_round<float, bf16>(round, k, moves, stack, logz, g, grad,
                                       N, T, S, ring, blank, st);
    return out_f32
        ? bwd_round<bf16, float>(round, k, moves, stack, logz, g, grad, N,
                                   T, S, ring, blank, st)
        : bwd_round<bf16, bf16>(round, k, moves, stack, logz, g, grad, N,
                                    T, S, ring, blank, st);
}

// kernel X on a ring of `ring` frames, `k` predecessors a thread for the
// chain's first S / k of `consumers` consumer threads (whole warps, at
// most 640), the gradient's pass by all of them: as logz_bwd with is_full
// 1 (scores bf16, or f32 when is_f32; each frame's row of 5S scores a
// whole number of 16-byte pieces)
int logz_full_bwd_ring(const void* scores, int is_f32, int round,
                       const void* stack, const void* logz, const void* g,
                       void* grad, int out_f32, int N, int T, int S, int k,
                       int consumers, int ring, void* stream) {
    if (bad_logz_ring(N, T, S, k, ring) || !aligned16(scores)
        || !aligned16(stack)
        || ((NB + 1) * S * (is_f32 ? 4 : 2)) % 16 != 0
        || consumers % 32 != 0 || consumers < logz_consumers(S, k)
        || consumers + 32 > X_THREADS)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (is_f32)
        return out_f32
            ? full_bwd_for<float, float>(round, k, scores, stack, logz, g,
                                         grad, N, T, S, consumers, ring, st)
            : full_bwd_for<float, bf16>(round, k, scores, stack, logz, g,
                                        grad, N, T, S, consumers, ring, st);
    return out_f32
        ? full_bwd_for<bf16, float>(round, k, scores, stack, logz, g, grad,
                                    N, T, S, consumers, ring, st)
        : full_bwd_for<bf16, bf16>(round, k, scores, stack, logz, g, grad,
                                   N, T, S, consumers, ring, st);
}

}  // extern "C"
