// One warp's Cholesky solve of a k x k SPD system, shared by kernels B2
// (chol_solve.cu) and B4 (lm_delta.cu); kernel B5 (gmm_scores.cu) uses the
// warp reductions and the grid rule, kernel B6 (back_project.cu) the SM
// count.
//
// What bounds the solve on the H100 is the latency of its k dependent
// column steps, so the design keeps every step inside the register file:
//
// * `warp_chol_solve_regs<KW>` (k <= KW <= 32; `warp_chol_solve_rows<KW>`
//   loads the rows for it, kernel B4 builds them in place): lane i owns row
//   i of the matrix in KW registers (every loop is unrolled, so each index is a
//   compile-time register).  Right-looking: at column j lane j broadcasts
//   the pivot with one shuffle, every lane scales its entry by one
//   reciprocal square root computed once a column (no division), and
//   updates its row with l_pj fetched by shuffle.  Lane j keeps the l_pj it
//   receives, so after the factorization lane i holds row i of L below the
//   diagonal and column i of L above it, and both substitutions are column
//   sweeps: when y_j (or x_p) is final, one shuffle broadcasts it and every
//   lane does one fmaf into its own partial sum.  No shared memory, no bank
//   conflicts, no __syncwarp, no reductions.  A system narrower than KW is
//   padded with a unit diagonal and a zero right-hand side.  Only the lower
//   triangle of the input takes part in the result.
// * `warp_chol_solve` (any k): the factor in shared memory, left-looking,
//   substitutions by shuffle reductions; kept for k > 32.
//
// Both put the 1e-12 floor under the square root as the TPU kernels do, so
// an all-zero system solves to exactly 0.

#pragma once

#include <cuda_runtime.h>

namespace mg {

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// SMs of the current device (asked once a process).
inline int sm_count() {
  static int n_sm = 0;
  if (n_sm == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (n_sm <= 0) n_sm = 1;
  }
  return n_sm;
}

// Warps per block (8, 4, 2 or 1) for kernels that give each of `rows` items
// one warp: the most whose grid still has a block for every SM, so that a
// crowd of 1024 runs 4 warps a block on 256 blocks (132 SMs) and a serving
// batch of 8 spreads over 8 SMs.
inline int warps_per_block(int rows) {
  const int n_sm = sm_count();
  int warps = 8;
  while (warps > 1 && (rows + warps - 1) / warps < n_sm) warps /= 2;
  return warps;
}

// The register solve itself: lane i holds row i of the k x k SPD matrix in
// a[0..KW) (a system narrower than KW padded with a unit diagonal) and its
// right-hand side entry in acc (0 past k); returns x[lane] (0 for lane >= k).
// Only the lower triangle of the matrix takes part in the result.
template <int KW>
__device__ __forceinline__ float warp_chol_solve_regs(float (&a)[KW],
                                                      float acc, int lane) {
  static_assert(KW % 4 == 0 && KW <= 32, "one matrix row a lane");
  constexpr unsigned FULL = 0xffffffffu;
  float dinv = 1.f;  // 1 / L_ii of this lane's row

  // factorization, with the forward substitution L y = g riding along
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    const float piv = fmaxf(__shfl_sync(FULL, a[j], j), 1e-12f);
    const float rinv = rsqrtf(piv);
    if (lane == j) dinv = rinv;
    const float lij = a[j] * rinv;               // L_ij for lanes i > j
    const float nl = lane > j ? -lij : 0.f;      // finished rows stay put
    const float yj = __shfl_sync(FULL, acc * dinv, j);
    acc = lane == j ? yj : fmaf(nl, yj, acc);    // lane j keeps y_j
    if (lane > j) a[j] = lij;
#pragma unroll
    for (int p = j + 1; p < KW; ++p) {
      const float lpj = __shfl_sync(FULL, lij, p);
      a[p] = lane == j ? lpj : fmaf(nl, lpj, a[p]);  // lane j: column j of L
    }
  }

  // back substitution L^T x = y: lane i reads L_pi from its mirrored entries
  float x = 0.f;
#pragma unroll
  for (int p = KW - 1; p >= 0; --p) {
    const float xp = __shfl_sync(FULL, acc * dinv, p);
    if (lane == p) x = xp;
    acc = lane < p ? fmaf(-a[p], xp, acc) : acc;
  }
  return x;
}

// Solve A x = g for one k x k system (k <= KW <= 32) with the whole warp;
// returns x[lane] (0 for lane >= k).  A is row-major with row stride k, in
// global or shared memory; vec says that k == KW and A is 16-byte aligned,
// so that a lane loads its row with 16-byte loads.
template <int KW>
__device__ __forceinline__ float warp_chol_solve_rows(const float* A,
                                                      const float* g, int k,
                                                      int lane, bool vec) {
  float a[KW];
  if (vec) {
    if (lane < KW) {
      const float4* row = reinterpret_cast<const float4*>(A + lane * KW);
#pragma unroll
      for (int q = 0; q < KW / 4; ++q) {
        const float4 v = row[q];
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int p = 0; p < KW; ++p) a[p] = 0.f;
    }
  } else {
#pragma unroll
    for (int p = 0; p < KW; ++p)
      a[p] = (lane < k && p < k) ? A[lane * k + p] : (p == lane ? 1.f : 0.f);
  }
  // g_i minus the finished columns
  return warp_chol_solve_regs<KW>(a, lane < k ? g[lane] : 0.f, lane);
}

// The same solve with the factor in shared memory, for any k.  L holds the
// full matrix on entry (row-major, only its lower triangle is read) and its
// Cholesky factor on exit.  Left-looking: lanes split the rows of each
// column update; forward and back substitution reduce each row's dot
// product across the warp with shuffles.  y and x are k-float scratch and
// result vectors in shared memory; x is valid in every lane after the call.
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
