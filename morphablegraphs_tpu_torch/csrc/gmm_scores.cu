// Gaussian-mixture log-likelihood and its gradient for a crowd (kernel B5).
//
// Replaces the TPU kernel morphablegraphs_tpu/ops/pallas_kernels.py
// `gmm_scores` (`_gmm_scores_kernel`), the naturalness term -log p(s) of the
// Levenberg-Marquardt residuals (morphablegraphs_tpu/synthesis/
// constrained_walk.py).  Per row c with mixture row m = mix_id[c]:
//   y_k = (x[c] - mu[m, k]) P[m, k]
//   lp_k = log max(w[m, k], 1e-30) + log|diag P[m, k]| - (D log 2pi + |y_k|^2)/2
//   logp[c] = logsumexp_k lp_k
//   grad[c] = d(-log p)/dx = sum_k r_k P[m, k] y_k,  r = softmax_k(lp)
// weights [M, K], means [M, K, D], prec_chol [M, K, D, D] (row-major, so
// y_e = sum_i diff_i P[i, e]).  grad may be null: then only logp is written.
// A mix_id outside [0, M) writes NaN instead of reading outside the tables.
//
// What bounds it on the H100: latency.  At the crowd shape [1024, K 5, D 28]
// the mixtures of the 4 nodes are 63 KB and stay in L2, and the crowd is
// ~16 MFLOP; the per-row work is K small dependent mat-vec products and a
// logsumexp.  The design gives each row one warp: lanes take columns e of
// P_k for y_k (neighbouring lanes on neighbouring addresses) and a shuffle
// reduction gives |y_k|^2; the row's diff, its K whitened vectors and the
// K log-densities stay in the warp's shared memory for the logsumexp and
// the gradient, where lanes take rows i of P_k.  D <= 64 (a loop over
// lanes); the wrapper refuses more.

#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int WARPS = 4;
constexpr float LOG_2PI = 1.8378770664093453f;

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__global__ void gmm_scores_kernel(const float* __restrict__ x,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ means,
                                  const float* __restrict__ prec,
                                  const long long* __restrict__ mix_id,
                                  float* __restrict__ logp,
                                  float* __restrict__ grad, int c, int n_mix,
                                  int n_comp, int d) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= c) return;  // whole warp leaves together; no block barriers below
  const long long m = mix_id[row];
  if (m < 0 || m >= n_mix) {
    const float nan = __int_as_float(0x7fc00000);
    if (lane == 0) logp[row] = nan;
    if (grad != nullptr)
      for (int i = lane; i < d; i += 32) grad[(size_t)row * d + i] = nan;
    return;
  }
  float* diff = smem + (size_t)warp * (d + n_comp * d + n_comp);
  float* y = diff + d;         // [n_comp, d]
  float* lp = y + n_comp * d;  // [n_comp]
  const float* xr = x + (size_t)row * d;

  for (int k = 0; k < n_comp; ++k) {
    const size_t mk = (size_t)m * n_comp + k;
    const float* mu = means + mk * d;
    const float* P = prec + mk * d * d;
    for (int i = lane; i < d; i += 32) diff[i] = xr[i] - mu[i];
    __syncwarp();
    float sq = 0.f, ldet = 0.f;
    for (int e = lane; e < d; e += 32) {
      float s = 0.f;
      for (int i = 0; i < d; ++i) s = fmaf(diff[i], P[(size_t)i * d + e], s);
      y[k * d + e] = s;
      sq += s * s;
      ldet += logf(fabsf(P[(size_t)e * d + e]));
    }
    const float maha = mg::warp_sum(sq);
    const float log_det = mg::warp_sum(ldet);
    if (lane == 0)
      lp[k] = (-0.5f * ((float)d * LOG_2PI + maha) + log_det) +
              logf(fmaxf(weights[mk], 1e-30f));
    __syncwarp();
  }

  float mx = -__int_as_float(0x7f800000);
  for (int k = lane; k < n_comp; k += 32) mx = fmaxf(mx, lp[k]);
  mx = warp_max(mx);
  float se = 0.f;
  for (int k = lane; k < n_comp; k += 32) se += expf(lp[k] - mx);
  const float lse = mx + logf(mg::warp_sum(se));
  if (lane == 0) logp[row] = lse;
  if (grad == nullptr) return;

  for (int i = lane; i < d; i += 32) {
    float g = 0.f;
    for (int k = 0; k < n_comp; ++k) {
      const float* Prow = prec + (((size_t)m * n_comp + k) * d + i) * d;
      float s = 0.f;
      for (int e = 0; e < d; ++e) s = fmaf(Prow[e], y[k * d + e], s);
      g = fmaf(expf(lp[k] - lse), s, g);
    }
    grad[(size_t)row * d + i] = g;
  }
}

}  // namespace

extern "C" int mg_gmm_scores(const float* x, const float* weights,
                             const float* means, const float* prec,
                             const long long* mix_id, float* logp,
                             float* grad, int c, int n_mix, int n_comp, int d,
                             void* stream) {
  size_t smem = sizeof(float) * (size_t)WARPS *
                ((size_t)d + (size_t)n_comp * d + n_comp);
  cudaError_t err = cudaFuncSetAttribute(
      gmm_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (c + WARPS - 1) / WARPS;
  gmm_scores_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      x, weights, means, prec, mix_id, logp, grad, c, n_mix, n_comp, d);
  return (int)cudaGetLastError();
}
