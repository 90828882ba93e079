// Fused Levenberg-Marquardt step of a crowd (kernel B4).
//
// Replaces the TPU kernel morphablegraphs_tpu/ops/pallas_kernels.py
// `lm_delta_crowd` (`_lm_delta_kernel`), which the JAX package reaches
// through the batching rule of ops/lm.lm_delta with MG_LM_PALLAS_DELTA=1.
// Per character c, from its jacobian J [R, k] and residuals r [R]:
//   A = JtJ + lam * diag(max(dg, max(rel * max(dg), 1e-6))),  dg = diag JtJ
//   solve A delta = Jt r by Cholesky (1e-12 floor, warp_chol.cuh)
//   delta *= min(1, radius / max(||delta||, 1e-10))
// A zero character (J = 0, r = 0) gives delta = 0.
//
// What bounds it on the H100: latency again.  At [1024, 49, 28] the crowd
// reads 5.8 MB and does ~40 MFLOP for JtJ, then the same k-step Cholesky
// recurrence as kernel B2.  The design gives each character one warp, stages
// its J and r once in shared memory (coalesced; 5.7 KB at R = 49, k = 28)
// and lets the lanes share the k(k+1)/2 upper-triangle (i, j) pairs of JtJ
// (13 pairs a lane at k = 28) and the k entries of Jt r, each a dot product
// over the R staged rows.  Nothing of the [C, k, k] normal matrix touches
// device memory.  For k <= 32 the solve is kernel B2's register routine
// (one matrix row a lane, read once from the staged JtJ); a wider system
// keeps the shared-memory routine.

#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int WARPS = 4;

__global__ void lm_delta_kernel(const float* __restrict__ jac,
                                const float* __restrict__ res,
                                const float* __restrict__ lam,
                                const float* __restrict__ radius,
                                float* __restrict__ out, int c, int n_res,
                                int k, float damp_floor_rel) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * WARPS + warp;
  if (ch >= c) return;  // whole warp leaves together; no block barriers below
  float* J = smem + (size_t)warp * (n_res * k + n_res + k * k + 3 * k);
  float* r = J + n_res * k;
  float* A = r + n_res;
  float* g = A + k * k;
  float* y = g + k;
  float* x = y + k;
  const float* Jc = jac + (size_t)ch * n_res * k;
  const float* rc = res + (size_t)ch * n_res;
  for (int i = lane; i < n_res * k; i += 32) J[i] = Jc[i];
  for (int i = lane; i < n_res; i += 32) r[i] = rc[i];
  __syncwarp();

  // JtJ: lanes share the upper-triangle pairs, mirrored into the lower
  // triangle the Cholesky reads
  const int n_pairs = k * (k + 1) / 2;
  for (int p = lane; p < n_pairs; p += 32) {
    int i = 0, rem = p;
    while (rem >= k - i) {
      rem -= k - i;
      ++i;
    }
    const int j = i + rem;
    float s = 0.f;
    for (int rr = 0; rr < n_res; ++rr) s += J[rr * k + i] * J[rr * k + j];
    A[i * k + j] = s;
    A[j * k + i] = s;
  }
  for (int i = lane; i < k; i += 32) {
    float s = 0.f;
    for (int rr = 0; rr < n_res; ++rr) s += J[rr * k + i] * r[rr];
    g[i] = s;
  }
  __syncwarp();

  // Marquardt damping with the relative floor
  float dmax = -__int_as_float(0x7f800000);
  for (int i = lane; i < k; i += 32) dmax = fmaxf(dmax, A[i * k + i]);
  const float floor_v = fmaxf(damp_floor_rel * mg::warp_max(dmax), 1e-6f);
  const float lam_c = lam[ch];
  for (int i = lane; i < k; i += 32) {
    const float dg = A[i * k + i];
    A[i * k + i] = dg + lam_c * fmaxf(dg, floor_v);
  }
  __syncwarp();

  // the solve, then the trust-region clip
  if (k <= 32) {
    const float xi =
        k <= 28 ? mg::warp_chol_solve_rows<28>(A, g, k, lane, false)
                : mg::warp_chol_solve_rows<32>(A, g, k, lane, false);
    const float nrm = sqrtf(fmaxf(mg::warp_sum(xi * xi), 1e-20f));
    const float scale = fminf(1.f, radius[ch] / fmaxf(nrm, 1e-10f));
    if (lane < k) out[(size_t)ch * k + lane] = xi * scale;
    return;
  }
  mg::warp_chol_solve(A, g, y, x, k, lane);
  float part = 0.f;
  for (int i = lane; i < k; i += 32) part += x[i] * x[i];
  const float nrm = sqrtf(fmaxf(mg::warp_sum(part), 1e-20f));
  const float scale = fminf(1.f, radius[ch] / fmaxf(nrm, 1e-10f));
  for (int i = lane; i < k; i += 32) out[(size_t)ch * k + i] = x[i] * scale;
}

}  // namespace

extern "C" int mg_lm_delta(const float* jac, const float* res,
                           const float* lam, const float* radius, float* out,
                           int c, int n_res, int k, float damp_floor_rel,
                           void* stream) {
  size_t smem = sizeof(float) * (size_t)WARPS *
                ((size_t)n_res * k + n_res + (size_t)k * k + 3 * k);
  cudaError_t err = cudaFuncSetAttribute(
      lm_delta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (c + WARPS - 1) / WARPS;
  lm_delta_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      jac, res, lam, radius, out, c, n_res, k, damp_floor_rel);
  return (int)cudaGetLastError();
}
