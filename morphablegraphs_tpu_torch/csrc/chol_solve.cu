// Crowd Cholesky solve (kernel B2): a[c] x[c] = g[c] for C small SPD systems.
//
// Replaces the TPU kernel morphablegraphs_tpu/ops/pallas_kernels.py
// `chol_solve_crowd` (`_chol_solve_kernel`), which the JAX package reaches
// through the batching rule of ops/lm.chol_solve: the damped normal
// equations of every character's Levenberg-Marquardt step, k = 28.
//
// What bounds it on the H100: latency, not bytes or flops.  A [1024, 28, 28]
// batch is 3.2 MB in and ~11 MFLOP; the recurrence is k sequential column
// steps per system.  The design gives each character one warp and keeps its
// k x k factor in shared memory (3.1 KB per warp, 8 warps per block) instead
// of registers, where a per-thread factor would spill.  The factorization
// and both substitutions are the warp routine of warp_chol.cuh, which the
// fused LM step (kernel B4) shares.

#include <cuda_runtime.h>

#include "warp_chol.cuh"

namespace {

constexpr int WARPS = 8;

__global__ void chol_solve_kernel(const float* __restrict__ a,
                                  const float* __restrict__ g,
                                  float* __restrict__ x, int c, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * WARPS + warp;
  if (ch >= c) return;  // whole warp leaves together; no block barriers below
  float* L = smem + (size_t)warp * (k * k + 2 * k);
  float* y = L + k * k;
  float* xs = y + k;
  const float* A = a + (size_t)ch * k * k;
  for (int i = lane; i < k * k; i += 32) L[i] = A[i];
  __syncwarp();
  mg::warp_chol_solve(L, g + (size_t)ch * k, y, xs, k, lane);
  for (int i = lane; i < k; i += 32) x[(size_t)ch * k + i] = xs[i];
}

}  // namespace

extern "C" int mg_chol_solve(const float* a, const float* g, float* x, int c,
                             int k, void* stream) {
  size_t smem = sizeof(float) * (size_t)WARPS * (k * k + 2 * k);
  cudaError_t err = cudaFuncSetAttribute(
      chol_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int blocks = (c + WARPS - 1) / WARPS;
  chol_solve_kernel<<<blocks, WARPS * 32, smem, (cudaStream_t)stream>>>(
      a, g, x, c, k);
  return (int)cudaGetLastError();
}
