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
// y_e = sum_i diff_i P[i, e]).  grad may be null: then only logp is written
// and the gradient pass is skipped.  A mix_id outside [0, M) writes NaN
// instead of reading outside the tables.
//
// What bounds it on the H100: latency.  At the crowd shape [1024, K 5, D 28]
// the mixtures of the 4 nodes are 63 KB and stay in L2, and the crowd is
// ~16 MFLOP; a row's work is K pairs of small dependent mat-vec products.
// What the design does about it:
// * Each row has one warp, which copies its mixture's components into a
//   ring of shared-memory buffers with cp.async (neighbouring lanes on
//   neighbouring addresses) and works on component k while the next ones
//   are in flight.  The ring holds the
//   whole mixture where it fits (K 5, D 28: 16 KB a warp), so that the
//   warp pays one round trip to L2 for all of it instead of one per matrix
//   row; a larger mixture streams through a ring of at least two buffers,
//   for any K and M.
// * Both passes read the staged component without bank conflicts.  The
//   D = 28 instance keeps the rows dense (stride 28, so the copies are
//   16 bytes each, 6 a lane and component): lanes over columns e (the y_k
//   pass) read neighbouring words, and lanes over rows i (the gradient
//   pass) read 16 bytes at a stride of 112, which spreads each quarter warp
//   over all 32 banks.  The generic instance (any D <= 64, two columns a
//   lane, 4-byte copies) pads the stride to an odd number instead.
// * diff and y_k live in registers and are broadcast by shuffles; D = 28
//   at compile time unrolls both passes.
// * The logsumexp is online: a running maximum, sum and gradient per row,
//   rescaled when the maximum moves, so nothing of size K is kept and
//   exp(lp_k - max) is taken once per row and component; log|diag P_k| and
//   |y_k|^2 share one warp reduction.
// * Warps per block follow the grid (warp_chol.cuh): 256 blocks of 4 rows at
//   1024 rows, one row a block for a serving batch of 8.
// The per-component arithmetic (the y pass, the online logsumexp, the
// gradient pass of the generic layout) is gmm_row.cuh's, which the request
// path's exact LM (request_lm.cu) shares.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "gmm_row.cuh"
#include "warp_chol.cuh"

namespace {

// Copy one component's P [d, d] into buf with row stride s (asynchronous;
// the caller commits and waits): 16 bytes a copy where the rows stay dense
// (DC > 0; P and buf are 16-byte aligned), else 4.
template <int DC>
__device__ __forceinline__ void stage(float* buf, const float* P, int d,
                                      int s, int lane) {
  if constexpr (DC > 0) {
#pragma unroll
    for (int idx = 4 * lane; idx < DC * DC; idx += 128)
      __pipeline_memcpy_async(buf + idx, P + idx, 16);
  } else {
    for (int idx = lane; idx < d * d; idx += 32)
      __pipeline_memcpy_async(buf + idx + (idx / d) * (s - d), P + idx, 4);
  }
}

// DC > 0: d == DC at compile time, 16 <= DC <= 32 and a multiple of 4 (a
// column a lane, dense rows); DC == 0: any d <= 64 (two columns a lane,
// rows padded to an odd stride).
template <int DC>
__global__ void gmm_scores_kernel(const float* __restrict__ x,
                                  const float* __restrict__ weights,
                                  const float* __restrict__ means,
                                  const float* __restrict__ prec,
                                  const long long* __restrict__ mix_id,
                                  float* __restrict__ logp,
                                  float* __restrict__ grad, int c, int n_mix,
                                  int n_comp, int d_rt, int n_buf) {
  static_assert(DC == 0 || (DC % 4 == 0 && DC >= 16 && DC <= 32),
                "dense rows need whole 16-byte copies and one column a lane");
  extern __shared__ __align__(16) float smem[];
  constexpr int NE = DC > 0 ? 1 : 2;
  const int d = DC > 0 ? DC : d_rt;
  const int s = DC > 0 ? DC : (d | 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + warp;
  if (row >= c) return;  // whole warp leaves together; no block barriers below
  const long long m = mix_id[row];
  if (m < 0 || m >= n_mix) {
    const float nan = __int_as_float(0x7fc00000);
    if (lane == 0) logp[row] = nan;
    if (grad != nullptr)
      for (int i = lane; i < d; i += 32) grad[(size_t)row * d + i] = nan;
    return;
  }
  // a ring of n_buf buffers: components k .. k + n_buf - 2 are in flight
  // while k is worked on; one commit a round, so group k is component k
  float* bufs = smem + (size_t)warp * n_buf * d * s;
  const size_t mk0 = (size_t)m * n_comp;
  for (int t = 0; t < n_buf - 1; ++t) {
    if (t < n_comp)
      stage<DC>(bufs + (size_t)t * d * s, prec + (mk0 + t) * d * d, d, s, lane);
    __pipeline_commit();
  }

  float xv[NE];
  bool on[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    on[q] = lane + 32 * q < d;
    xv[q] = on[q] ? x[(size_t)row * d + lane + 32 * q] : 0.f;
  }
  const float ninf = -__int_as_float(0x7f800000);
  float mx = ninf, se = 0.f;  // running maximum and sum of exp(lp - mx)
  float gacc[NE];             // running sum of exp(lp - mx) P_k y_k
#pragma unroll
  for (int q = 0; q < NE; ++q) gacc[q] = 0.f;

  for (int k = 0; k < n_comp; ++k) {
    const size_t mk = mk0 + k;
    const float* P = bufs + (size_t)(k % n_buf) * d * s;
    float diff[NE];
#pragma unroll
    for (int q = 0; q < NE; ++q)
      diff[q] = on[q] ? xv[q] - means[mk * d + lane + 32 * q] : 0.f;
    const float log_w = logf(fmaxf(weights[mk], 1e-30f));
    const int ahead = k + n_buf - 1;
    if (ahead < n_comp)
      stage<DC>(bufs + (size_t)(ahead % n_buf) * d * s,
                prec + (mk0 + ahead) * d * d, d, s, lane);
    __pipeline_commit();
    __pipeline_wait_prior(n_buf - 1);
    __syncwarp();

    // y_e = sum_i diff_i P[i, e]: lane e walks down column e
    float y[NE];
    const float part = mg::gmm_y_pass<NE>(diff, P, d, s, on, lane, y);
    const float lp = mg::gmm_component_lp(mg::warp_sum(part), d, log_w);

    // online logsumexp: rescale what is kept when the maximum moves
    float keep, w;
    mg::gmm_lse_step(lp, mx, se, keep, w);

    if (grad == nullptr) {
      // value only: no gradient pass
    } else if constexpr (DC > 0) {
      // (P y)_i = sum_e P[i, e] y_e: lane i walks along row i, 16 bytes a
      // load; an idle lane reads the row of a lane of its quarter warp
      const float4* Pi = reinterpret_cast<const float4*>(
          P + (on[0] ? lane : lane - (32 - DC)) * DC);
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int e = 0; e < DC; e += 4) {
        const float4 v = Pi[e / 4];
        a0 = fmaf(v.x, mg::lane_entry(y, e), a0);
        a1 = fmaf(v.y, mg::lane_entry(y, e + 1), a1);
        a0 = fmaf(v.z, mg::lane_entry(y, e + 2), a0);
        a1 = fmaf(v.w, mg::lane_entry(y, e + 3), a1);
      }
      gacc[0] = fmaf(gacc[0], keep, w * (a0 + a1));
    } else {
      mg::gmm_grad_pass<NE>(P, d, s, on, y, lane, keep, w, gacc);
    }
    __syncwarp();  // the next round's copies overwrite this buffer
  }

  if (lane == 0) logp[row] = mx + logf(se);
  if (grad != nullptr) {
#pragma unroll
    for (int q = 0; q < NE; ++q)
      if (on[q]) grad[(size_t)row * d + lane + 32 * q] = gacc[q] / se;
  }
}

template <int DC>
int launch(const float* x, const float* weights, const float* means,
           const float* prec, const long long* mix_id, float* logp,
           float* grad, int c, int n_mix, int n_comp, int d,
           cudaStream_t stream) {
  // the ring: the whole mixture where 24 KB a warp hold it, at least two
  // buffers, at most 8 (cp.async groups in flight); fewer warps a block
  // where the rings of all would pass 96 KB
  const size_t buf = sizeof(float) * (size_t)d * (DC > 0 ? d : (d | 1));
  int n_buf = (int)(24 * 1024 / buf);
  n_buf = n_buf > n_comp ? n_comp : n_buf;
  n_buf = n_buf > 8 ? 8 : (n_buf < 2 ? 2 : n_buf);
  int warps = mg::warps_per_block(c);
  while (warps > 1 && warps * n_buf * buf > 96 * 1024) warps /= 2;
  const size_t smem = warps * n_buf * buf;
  static bool raised = false;  // once a process: the opt-in above 48 KB
  if (smem > 48 * 1024 && !raised) {
    cudaError_t err = cudaFuncSetAttribute(
        gmm_scores_kernel<DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        96 * 1024);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  gmm_scores_kernel<DC><<<(c + warps - 1) / warps, warps * 32, smem, stream>>>(
      x, weights, means, prec, mix_id, logp, grad, c, n_mix, n_comp, d, n_buf);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mg_gmm_scores(const float* x, const float* weights,
                             const float* means, const float* prec,
                             const long long* mix_id, float* logp,
                             float* grad, int c, int n_mix, int n_comp, int d,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 28 && reinterpret_cast<uintptr_t>(prec) % 16 == 0)
    return launch<28>(x, weights, means, prec, mix_id, logp, grad, c, n_mix,
                      n_comp, d, st);
  return launch<0>(x, weights, means, prec, mix_id, logp, grad, c, n_mix,
                   n_comp, d, st);
}
