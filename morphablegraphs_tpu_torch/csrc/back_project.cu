// Fused fPCA back-projection and B-spline evaluation of a crowd (kernel B6).
//
// Replaces the TPU kernel morphablegraphs_tpu/ops/pallas_kernels.py
// `crowd_back_project` (`_back_project_kernel`), the computation of every
// walk step's back-projection (morphablegraphs_tpu/synthesis/walk.py
// `back_project_node`).  Per character c with mixture row m = mix_id[c]:
//   coeffs = reshape(eigen[m] alpha[c] + mean[m], (n_basis, n_dim))
//   out[c] = basis[c] coeffs                     [T, n_dim]
// eigen [M, n_basis * n_dim, K], mean [M, n_basis * n_dim], alpha [C, K],
// basis [C, T, n_basis] (or one [T, n_basis] basis shared by the crowd).
// A mix_id outside [0, M) fills the character's frames with NaN instead of
// reading outside the tables.
//
// What bounds it on the H100: at the crowd shape [1024, T 160, n_dim 79]
// the output is 51.8 MB (~15 us at the HBM rate); the eigen tables of the 4
// nodes are 0.5 MB and stay in L2, and both products together are ~0.5
// GFLOP.  The design gives each character one block: the block computes its
// n_basis x n_dim coefficients (1264 floats at n_basis 16, n_dim 79) into
// shared memory beside its basis rows (10 KB at T 160), then its threads
// write the T x n_dim outputs in one pass, neighbouring threads on
// neighbouring addresses.  Neither product leaves the block.  Measured on
// an H100 (700 W) at 0.105 ms, 495 GB/s of output, it is not yet
// write-bound: each output's 16 FMAs take two shared-memory loads each, and
// every block reads its node's 126 KB eigen table again from L2.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void back_project_kernel(const float* __restrict__ eigen,
                                    const float* __restrict__ mean,
                                    const long long* __restrict__ mix_id,
                                    const float* __restrict__ alpha,
                                    const float* __restrict__ basis,
                                    float* __restrict__ out, int n_mix, int k,
                                    int n_basis, int n_dim, int t,
                                    int shared_basis) {
  extern __shared__ float smem[];
  const int c = blockIdx.x;
  const int d = n_basis * n_dim;
  const int n_out = t * n_dim;
  float* out_c = out + (size_t)c * n_out;
  const long long m = mix_id[c];
  if (m < 0 || m >= n_mix) {  // uniform over the block: no barrier is skipped
    for (int i = threadIdx.x; i < n_out; i += blockDim.x)
      out_c[i] = __int_as_float(0x7fc00000);
    return;
  }
  float* a_s = smem;        // [k]
  float* coeff = a_s + k;   // [n_basis, n_dim]
  float* b_s = coeff + d;   // [t, n_basis]
  const float* bc = basis + (shared_basis ? 0 : (size_t)c * t * n_basis);
  for (int i = threadIdx.x; i < k; i += blockDim.x)
    a_s[i] = alpha[(size_t)c * k + i];
  for (int i = threadIdx.x; i < t * n_basis; i += blockDim.x) b_s[i] = bc[i];
  __syncthreads();

  const float* em = eigen + (size_t)m * d * k;
  const float* mm = mean + (size_t)m * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float* row = em + (size_t)i * k;
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = fmaf(row[j], a_s[j], s);
    coeff[i] = s + mm[i];
  }
  __syncthreads();

  for (int i = threadIdx.x; i < n_out; i += blockDim.x) {
    const int tt = i / n_dim;
    const int h = i - tt * n_dim;
    const float* brow = b_s + tt * n_basis;
    float s = 0.f;
    for (int b = 0; b < n_basis; ++b) s = fmaf(brow[b], coeff[b * n_dim + h], s);
    out_c[i] = s;
  }
}

}  // namespace

extern "C" int mg_back_project(const float* eigen, const float* mean,
                               const long long* mix_id, const float* alpha,
                               const float* basis, float* out, int c,
                               int n_mix, int k, int n_basis, int n_dim, int t,
                               int shared_basis, void* stream) {
  size_t smem = sizeof(float) *
                ((size_t)k + (size_t)n_basis * n_dim + (size_t)t * n_basis);
  cudaError_t err = cudaFuncSetAttribute(
      back_project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  back_project_kernel<<<c, THREADS, smem, (cudaStream_t)stream>>>(
      eigen, mean, mix_id, alpha, basis, out, n_mix, k, n_basis, n_dim, t,
      shared_basis);
  return (int)cudaGetLastError();
}
