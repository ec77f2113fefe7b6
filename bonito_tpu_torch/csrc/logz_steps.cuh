// The f32 steps of the CRF loss's kernels that every instance takes alike:
// the earlier kernels of csrc/logz.cu (U, V, W, X) and the ring kernels of
// csrc/logz_ring.cu (U, V, W, X). The scores are rounded to bf16 on load
// with `round` (round to nearest even, as XLA's convert), the gradient to
// bf16 before it is stored in the output type; lse2 is the log of a sum of
// two exps, from their max. The same code in both sources is what makes
// their outputs equal bit for bit.
//
// LOGZ_CUT (0 in the library) is for scripts/logz_split.py, which builds
// csrc/logz_ring.cu with parts left out; its bit 2 takes every exp and log
// as its argument.

#pragma once

#include <type_traits>

#include "crf_frames.cuh"

#ifndef LOGZ_CUT
#define LOGZ_CUT 0
#endif

namespace {

__device__ __forceinline__ float exp_f(float x) {
    return (LOGZ_CUT & 2) ? x : expf(x);
}
__device__ __forceinline__ float log_f(float x) {
    return (LOGZ_CUT & 2) ? x : logf(x);
}

// a bf16 score is its own rounding: only f32 scores are rounded
template <typename In, bool ROUND>
__device__ __forceinline__ float load_score(const In* p) {
    float v = to_f32(*p);
    if (ROUND && !std::is_same<In, __nv_bfloat16>::value)
        v = __bfloat162float(__float2bfloat16_rn(v));
    return v;
}

template <typename Out, bool ROUND>
__device__ __forceinline__ void store_grad(Out* p, float v);

template <>
__device__ __forceinline__ void store_grad<float, true>(float* p, float v) {
    *p = __bfloat162float(__float2bfloat16_rn(v));
}
template <>
__device__ __forceinline__ void store_grad<float, false>(float* p, float v) {
    *p = v;
}
template <>
__device__ __forceinline__ void store_grad<__nv_bfloat16, true>(
    __nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ void store_grad<__nv_bfloat16, false>(
    __nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float lse2(float a, float b) {
    const float big = fmaxf(a, b);
    return big + log_f(exp_f(a - big) + exp_f(b - big));
}

}  // namespace
