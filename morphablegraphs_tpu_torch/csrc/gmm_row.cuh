// One warp's Gaussian-mixture log-likelihood of one row and the gradient of
// -log p, a component at a time: the device code of kernel B5
// (gmm_scores.cu), shared with the request path's exact LM
// (request_lm.cu), which takes its naturalness term from the same
// arithmetic.
//
// For component k with precision Cholesky factor P (row-major [d, d] at row
// stride s in shared memory), mean mu and weight w:
//   y_e = sum_i diff_i P[i, e],  diff = x - mu
//   lp  = log max(w, 1e-30) + sum_e log|P[e, e]| - (d log 2pi + |y|^2) / 2
// and the online logsumexp over the components keeps a running maximum mx,
// the sum se of exp(lp - mx) and the gradient accumulator
//   gacc_i = sum_k exp(lp_k - mx) (P_k y_k)_i,
// so that log p = mx + log se and d(-log p)/dx = gacc / se.  A lane holds
// NE columns (lane, lane + 32): NE = 1 for d <= 32, 2 for d <= 64.

#pragma once

#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace mg {

constexpr float GMM_LOG_2PI = 1.8378770664093453f;

// Entry i of a vector spread over the lanes' registers (NE a lane), from
// its lane; a select, so that no register array is indexed at run time.
template <int NE>
__device__ __forceinline__ float lane_entry(const float (&v)[NE], int i) {
  return __shfl_sync(0xffffffffu, (NE == 1 || i < 32) ? v[0] : v[NE - 1],
                     i % 32);
}

// y = diff P for the lane's columns (0 where off); returns the lane's part
// of sum_e (log|P[e, e]| - y_e^2 / 2), which the caller sums over the warp.
template <int NE>
__device__ __forceinline__ float gmm_y_pass(const float (&diff)[NE],
                                            const float* P, int d, int s,
                                            const bool (&on)[NE], int lane,
                                            float (&y)[NE]) {
  float part = 0.f;
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int e = on[q] ? lane + 32 * q : 0;
    float a0 = 0.f, a1 = 0.f;
    int i = 0;
#pragma unroll
    for (; i + 1 < d; i += 2) {
      a0 = fmaf(lane_entry(diff, i), P[i * s + e], a0);
      a1 = fmaf(lane_entry(diff, i + 1), P[(i + 1) * s + e], a1);
    }
    if (i < d) a0 = fmaf(lane_entry(diff, i), P[i * s + e], a0);
    y[q] = on[q] ? a0 + a1 : 0.f;
    part += on[q] ? logf(fabsf(P[e * s + e])) - 0.5f * y[q] * y[q] : 0.f;
  }
  return part;
}

// The component's log-likelihood from the warp's sum of the parts.
__device__ __forceinline__ float gmm_component_lp(float part_sum, int d,
                                                  float log_w) {
  return part_sum - 0.5f * (float)d * GMM_LOG_2PI + log_w;
}

// One step of the online logsumexp: folds lp into (mx, se) and gives the
// factor `keep` that rescales what was summed so far and the weight `w` of
// this component.
__device__ __forceinline__ void gmm_lse_step(float lp, float& mx, float& se,
                                             float& keep, float& w) {
  const float ninf = -__int_as_float(0x7f800000);
  const float mx_new = fmaxf(mx, lp);
  const bool none = mx_new == ninf;  // every component so far at -inf
  keep = none ? 1.f : expf(mx - mx_new);
  w = none ? 0.f : expf(lp - mx_new);
  mx = mx_new;
  se = fmaf(se, keep, w);
}

// (P y)_i for the lane's rows i, folded into gacc: any d, any stride.
template <int NE>
__device__ __forceinline__ void gmm_grad_pass(const float* P, int d, int s,
                                              const bool (&on)[NE],
                                              const float (&y)[NE], int lane,
                                              float keep, float w,
                                              float (&gacc)[NE]) {
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int i = on[q] ? lane + 32 * q : 0;
    float a0 = 0.f, a1 = 0.f;
    int e = 0;
#pragma unroll
    for (; e + 1 < d; e += 2) {
      a0 = fmaf(P[i * s + e], lane_entry(y, e), a0);
      a1 = fmaf(P[i * s + e + 1], lane_entry(y, e + 1), a1);
    }
    if (e < d) a0 = fmaf(P[i * s + e], lane_entry(y, e), a0);
    gacc[q] = fmaf(gacc[q], keep, w * (a0 + a1));
  }
}

}  // namespace mg
