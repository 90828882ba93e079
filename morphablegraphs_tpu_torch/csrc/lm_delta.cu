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
// What bounds it on the H100: latency.  At [1024, 49, 28] the crowd reads
// 5.8 MB and does ~80 MFLOP for JtJ, then the k-step Cholesky recurrence of
// kernel B2.  The design gives each character one warp and, for k <= 32,
// lane i row i of JtJ from the start, which is the layout the register
// solve wants: the warp stages J once in shared memory (16-byte copies,
// rows padded to the solve's width with zeros), then for each residual row
// a lane holds J[r][i] in a register and reads J[r][0..k) as 16-byte loads
// that every lane makes at the same address (a broadcast, no bank conflict):
// k FMAs a row into the lane's own k accumulators, and Jt r falls out of the
// same loop.  The diagonal, its maximum, the damping and the solve stay in
// registers: the normal matrix touches neither shared nor device memory.
// The full row costs twice the triangle's FMAs and removes the search for
// (i, j), two thirds of the shared loads and the round trip through shared
// memory.  A system wider than 32 keeps the shared-memory route: lanes split
// the upper-triangle pairs, the factor lives in shared memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_chol.cuh"

namespace {

constexpr int SMEM_WARPS = 4;                // the k > 32 route
constexpr int SMEM_OPT_IN = 200 * 1024;      // raised once a process

// Floats a warp stages for the register route: J [n_res, kw] and r [n_res],
// rounded up so that the next warp's rows start on a 16-byte boundary.
__host__ __device__ inline size_t staged_floats(int n_res, int kw) {
  return (size_t)n_res * kw + (size_t)((n_res + 3) & ~3);
}

// k <= KW <= 32: J staged as [n_res, KW], JtJ and the solve in registers.
template <int KW>
__global__ void lm_delta_kernel(const float* __restrict__ jac,
                                const float* __restrict__ res,
                                const float* __restrict__ lam,
                                const float* __restrict__ radius,
                                float* __restrict__ out, int c, int n_res,
                                int k, float damp_floor_rel) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * (blockDim.x / 32) + warp;
  if (ch >= c) return;  // whole warp leaves together; no block barriers below
  float* J = smem + (size_t)warp * staged_floats(n_res, KW);  // [n_res, KW]
  float* r = J + (size_t)n_res * KW;                          // [n_res]
  const float* Jc = jac + (size_t)ch * n_res * k;
  const float* rc = res + (size_t)ch * n_res;
  if (k == KW && reinterpret_cast<uintptr_t>(Jc) % 16 == 0) {
    const float4* src = reinterpret_cast<const float4*>(Jc);
    float4* dst = reinterpret_cast<float4*>(J);
    for (int i = lane; i < n_res * (KW / 4); i += 32) dst[i] = src[i];
  } else {
    for (int i = lane; i < n_res * KW; i += 32) {
      const int rr = i / KW, p = i - rr * KW;
      J[i] = p < k ? Jc[rr * k + p] : 0.f;
    }
  }
  for (int i = lane; i < n_res; i += 32) r[i] = rc[i];
  __syncwarp();

  // row `lane` of JtJ and entry `lane` of Jt r, one residual row at a time
  float a[KW];
#pragma unroll
  for (int p = 0; p < KW; ++p) a[p] = 0.f;
  float g = 0.f;
  const int col = lane < KW ? lane : 0;
#pragma unroll 2
  for (int rr = 0; rr < n_res; ++rr) {
    const float* row = J + rr * KW;
    const float ji = lane < KW ? row[col] : 0.f;
    const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int q = 0; q < KW / 4; ++q) {
      const float4 v = row4[q];
      a[4 * q] = fmaf(ji, v.x, a[4 * q]);
      a[4 * q + 1] = fmaf(ji, v.y, a[4 * q + 1]);
      a[4 * q + 2] = fmaf(ji, v.z, a[4 * q + 2]);
      a[4 * q + 3] = fmaf(ji, v.w, a[4 * q + 3]);
    }
    g = fmaf(ji, r[rr], g);
  }

  // Marquardt damping with the relative floor, on the lane's own diagonal
  float dg = 0.f;
#pragma unroll
  for (int p = 0; p < KW; ++p)
    if (p == lane) dg = a[p];
  const float ninf = -__int_as_float(0x7f800000);
  const float floor_v =
      fmaxf(damp_floor_rel * mg::warp_max(lane < k ? dg : ninf), 1e-6f);
  const float damped = dg + lam[ch] * fmaxf(dg, floor_v);
#pragma unroll
  for (int p = 0; p < KW; ++p)
    if (p == lane) a[p] = lane < k ? damped : 1.f;  // unit diagonal past k

  // the solve, then the trust-region clip
  const float xi = mg::warp_chol_solve_regs<KW>(a, lane < k ? g : 0.f, lane);
  const float nrm = sqrtf(fmaxf(mg::warp_sum(xi * xi), 1e-20f));
  const float scale = fminf(1.f, radius[ch] / fmaxf(nrm, 1e-10f));
  if (lane < k) out[(size_t)ch * k + lane] = xi * scale;
}

// any k: lanes share the k(k+1)/2 upper-triangle pairs of JtJ, each a dot
// product over the staged rows; the factor in shared memory.
__global__ void lm_delta_smem_kernel(const float* __restrict__ jac,
                                     const float* __restrict__ res,
                                     const float* __restrict__ lam,
                                     const float* __restrict__ radius,
                                     float* __restrict__ out, int c,
                                     int n_res, int k,
                                     float damp_floor_rel) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * SMEM_WARPS + warp;
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

  float dmax = -__int_as_float(0x7f800000);
  for (int i = lane; i < k; i += 32) dmax = fmaxf(dmax, A[i * k + i]);
  const float floor_v = fmaxf(damp_floor_rel * mg::warp_max(dmax), 1e-6f);
  const float lam_c = lam[ch];
  for (int i = lane; i < k; i += 32) {
    const float dg = A[i * k + i];
    A[i * k + i] = dg + lam_c * fmaxf(dg, floor_v);
  }
  __syncwarp();

  mg::warp_chol_solve(A, g, y, x, k, lane);
  float part = 0.f;
  for (int i = lane; i < k; i += 32) part += x[i] * x[i];
  const float nrm = sqrtf(fmaxf(mg::warp_sum(part), 1e-20f));
  const float scale = fminf(1.f, radius[ch] / fmaxf(nrm, 1e-10f));
  for (int i = lane; i < k; i += 32) out[(size_t)ch * k + i] = x[i] * scale;
}

// The opt-in above 48 KB of dynamic shared memory, once a process and kernel.
template <typename Kernel>
int raise_smem(Kernel kernel, bool* raised, size_t smem) {
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && !*raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return (int)err;
    *raised = true;
  }
  return 0;
}

template <int KW>
int launch_rows(const float* jac, const float* res, const float* lam,
                const float* radius, float* out, int c, int n_res, int k,
                float damp_floor_rel, cudaStream_t stream) {
  const size_t per_warp = sizeof(float) * staged_floats(n_res, KW);
  int warps = mg::warps_per_block(c);
  while (warps > 1 && warps * per_warp > 48 * 1024) warps /= 2;
  static bool raised = false;
  const int err = raise_smem(lm_delta_kernel<KW>, &raised, warps * per_warp);
  if (err != 0) return err;
  lm_delta_kernel<KW><<<(c + warps - 1) / warps, warps * 32, warps * per_warp,
                        stream>>>(jac, res, lam, radius, out, c, n_res, k,
                                  damp_floor_rel);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mg_lm_delta(const float* jac, const float* res,
                           const float* lam, const float* radius, float* out,
                           int c, int n_res, int k, float damp_floor_rel,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 28)
    return launch_rows<28>(jac, res, lam, radius, out, c, n_res, k,
                           damp_floor_rel, st);
  if (k <= 32)
    return launch_rows<32>(jac, res, lam, radius, out, c, n_res, k,
                           damp_floor_rel, st);
  const size_t smem = sizeof(float) * (size_t)SMEM_WARPS *
                      ((size_t)n_res * k + n_res + (size_t)k * k + 3 * k);
  static bool raised = false;
  const int err = raise_smem(lm_delta_smem_kernel, &raised, smem);
  if (err != 0) return err;
  lm_delta_smem_kernel<<<(c + SMEM_WARPS - 1) / SMEM_WARPS, SMEM_WARPS * 32,
                         smem, st>>>(jac, res, lam, radius, out, c, n_res, k,
                                     damp_floor_rel);
  return (int)cudaGetLastError();
}
