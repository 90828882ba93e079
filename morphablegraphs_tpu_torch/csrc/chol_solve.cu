// Crowd Cholesky solve (kernel B2): a[c] x[c] = g[c] for C small SPD systems.
//
// Replaces the TPU kernel morphablegraphs_tpu/ops/pallas_kernels.py
// `chol_solve_crowd` (`_chol_solve_kernel`), which the JAX package reaches
// through the batching rule of ops/lm.chol_solve: the damped normal
// equations of every character's Levenberg-Marquardt step, k = 28.
//
// What bounds it on the H100: latency, not bytes or flops.  A [1024, 28, 28]
// batch is 3.2 MB in and ~11 MFLOP; the recurrence is k dependent column
// steps per system, each a shuffle, a reciprocal square root and an fmaf
// deep.  The design gives each system one warp and each lane one matrix row
// in registers (warp_chol.cuh, `warp_chol_solve_rows`, instances of width 28
// and 32; a narrower system is padded): the factorization and both
// substitutions touch no shared memory and need no barrier, a lane loads its
// row with 16-byte loads, and the warps per block follow the grid so that
// 1024 systems run as 256 blocks of 4 warps and 8 systems take 8 SMs.  k > 32
// keeps the shared-memory routine of the same header.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_chol.cuh"

namespace {

template <int KW>
__global__ void chol_solve_kernel(const float* __restrict__ a,
                                  const float* __restrict__ g,
                                  float* __restrict__ x, int c, int k,
                                  bool vec) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * (blockDim.x / 32) + warp;
  if (ch >= c) return;  // whole warp leaves together; no block barriers below
  const float xi = mg::warp_chol_solve_rows<KW>(
      a + (size_t)ch * k * k, g + (size_t)ch * k, k, lane, vec);
  if (lane < k) x[(size_t)ch * k + lane] = xi;
}

constexpr int SMEM_WARPS = 8;

__global__ void chol_solve_smem_kernel(const float* __restrict__ a,
                                       const float* __restrict__ g,
                                       float* __restrict__ x, int c, int k) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ch = blockIdx.x * SMEM_WARPS + warp;
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

template <int KW>
void launch_rows(const float* a, const float* g, float* x, int c, int k,
                 cudaStream_t stream) {
  const int warps = mg::warps_per_block(c);
  const bool vec = k == KW && reinterpret_cast<uintptr_t>(a) % 16 == 0;
  chol_solve_kernel<KW><<<(c + warps - 1) / warps, warps * 32, 0, stream>>>(
      a, g, x, c, k, vec);
}

}  // namespace

extern "C" int mg_chol_solve(const float* a, const float* g, float* x, int c,
                             int k, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 28) {
    launch_rows<28>(a, g, x, c, k, st);
  } else if (k <= 32) {
    launch_rows<32>(a, g, x, c, k, st);
  } else {
    size_t smem = sizeof(float) * (size_t)SMEM_WARPS * (k * k + 2 * k);
    cudaError_t err = cudaFuncSetAttribute(
        chol_solve_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    chol_solve_smem_kernel<<<(c + SMEM_WARPS - 1) / SMEM_WARPS,
                             SMEM_WARPS * 32, smem, st>>>(a, g, x, c, k);
  }
  return (int)cudaGetLastError();
}
