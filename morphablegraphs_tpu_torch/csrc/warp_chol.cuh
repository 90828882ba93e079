// One warp's Cholesky solve of a k x k SPD system held in shared memory,
// shared by kernels B2 (chol_solve.cu) and B4 (lm_delta.cu); kernel B5
// (gmm_scores.cu) uses its warp_sum.
//
// L holds the full matrix on entry (row-major, only its lower triangle is
// read) and its Cholesky factor on exit.  Left-looking: lanes split the
// rows of each column update (row i's dot product with row j over the
// finished columns); forward and back substitution reduce each row's dot
// product across the warp with shuffles.  The 1e-12 floor under the square
// root matches the TPU kernels, so an all-zero system solves to x = 0.
// y and x are k-float scratch and result vectors in shared memory; x is
// valid in every lane after the call.

#pragma once

#include <cuda_runtime.h>

namespace mg {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void warp_chol_solve(float* L, const float* g,
                                                float* y, float* x, int k,
                                                int lane) {
  for (int j = 0; j < k; ++j) {
    float s = L[j * k + j];
    for (int p = 0; p < j; ++p) s -= L[j * k + p] * L[j * k + p];
    const float d = sqrtf(fmaxf(s, 1e-12f));
    for (int i = j + 1 + lane; i < k; i += 32) {
      float v = L[i * k + j];
      for (int p = 0; p < j; ++p) v -= L[i * k + p] * L[j * k + p];
      L[i * k + j] = v / d;
    }
    __syncwarp();
    if (lane == 0) L[j * k + j] = d;
    __syncwarp();
  }
  for (int i = 0; i < k; ++i) {
    float part = 0.f;
    for (int p = lane; p < i; p += 32) part += L[i * k + p] * y[p];
    part = warp_sum(part);
    if (lane == 0) y[i] = (g[i] - part) / L[i * k + i];
    __syncwarp();
  }
  for (int i = k - 1; i >= 0; --i) {
    float part = 0.f;
    for (int p = i + 1 + lane; p < k; p += 32) part += L[p * k + i] * x[p];
    part = warp_sum(part);
    if (lane == 0) x[i] = (y[i] - part) / L[i * k + i];
    __syncwarp();
  }
}

}  // namespace mg
