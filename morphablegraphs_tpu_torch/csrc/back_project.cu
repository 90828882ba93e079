// Back-projection of a crowd (kernel B6) and the fused frame-emit stage.
//
// `mg_back_project` replaces the TPU kernel
// morphablegraphs_tpu/ops/pallas_kernels.py `crowd_back_project`
// (`_back_project_kernel`), the computation of every walk step's
// back-projection (morphablegraphs_tpu/synthesis/walk.py
// `back_project_node`).  Per character c with mixture row m = mix_id[c]:
//   coeffs = reshape(eigen[m] alpha[c] + mean[m], (n_basis, n_dim))
//   out[c] = basis[c] coeffs                     [T, n_dim]
// eigen [M, n_basis * n_dim, K], mean [M, n_basis * n_dim], alpha [C, K],
// basis [C, T, n_basis] (or one [T, n_basis] basis shared by the crowd).
//
// `mg_emit_frames` is the whole stage a constrained walk step ends with, in
// one launch: the same coefficients; the cubic B-spline's 4 non-zero
// Cox-de Boor weights of each frame straight from the time function t_fn
// [C, T] and the node's knots [M, n_basis + 4] (clamped queries, closed last
// span), so no basis tensor exists; frame 0's root channels; the 2D aligning
// transform onto the previous step's last frame prev_last [C, n_dim] (heading
// by atan2, rotation about Y, XZ offset; identity without has_prev); that
// transform on the root channels of every frame; the seam smoothing (per-joint
// hemisphere sign against prev_last, linear offset blend over `window`
// frames); the aligned frames [C, T, n_dim] written once and new_last
// [C, n_dim] = row n_frames[c] - 1.  It replaces, after `crowd_back_project`,
// the tensor passes of ops/bspline.basis_matrix, ops/align.transform_frames
// and ops/align.smooth_transition.  n_dim must be 3 + 4 J.
//
// A mix_id outside [0, M) fills the character's rows with NaN instead of
// reading outside the tables.
//
// What bounds them on the H100: at the crowd shape [1024, T 160, n_dim 79]
// the output is 51.8 MB (~15 us at the HBM rate); everything else is small
// (tables 0.5 MB, basis 10.5 MB, t_fn 0.7 MB), and both products are ~0.5
// GFLOP.  So the design is about not wasting the other units:
// * a block takes up to 4 characters spread over the crowd (b, b + blocks,
//   ...) and reads the eigen table of each distinct node among them once: a
//   warp copies a chunk of 32 rows to shared memory with 16-byte loads,
//   then a lane a row (the row stride is odd: no bank conflicts), every
//   character of the node in the one pass, the alphas as 16-byte loads all
//   lanes make at one address.  No block barrier in there.  (A thread a
//   row straight from device memory touches 25 cache lines with every
//   load of a warp: ~0.1 ms for the crowd by itself.);
// * coefficients and frames live in a quad layout: slot 0 is padding, slot
//   1 + ch holds channel ch, so the root translation and every joint's
//   quaternion are one aligned 16-byte quad, and a thread owns one quad
//   column.  The back-projection holds its n_basis coefficients in
//   registers (n_basis = 16: 64 registers) and reads a frame's 16 basis
//   values from shared memory at one address for the lanes that share the
//   frame (the rows arrive by cp.async one character ahead).  The emit
//   stage needs 4 coefficients a frame at a span that varies, and takes
//   them from shared memory (conflict-free 16-byte loads);
// * everything that needs no coefficients is done for all the block's
//   characters at once before the tables are read: the frames' weights
//   and spans (bit for bit ops/bspline.basis_matrix's: the same divisions,
//   no fused multiply-add), the blend factors, prev_last;
// * the aligning transform is affine and a frame's weights sum to 1, so
//   it is applied to the root quads of the 16 coefficients once instead of
//   to every frame; the hemisphere sign and the blend touch only a thread's
//   own quad, so the epilogue needs no exchange between threads;
// * finished quads go to one of two shared-memory tiles and leave it in
//   flat order, neighbouring lanes on neighbouring addresses, one barrier a
//   tile (rows are 316 bytes at n_dim 79, so a flat copy is the way to full
//   sectors; 4-byte stores of a warp fill whole sectors, and 16-byte ones
//   would cost 4-way bank conflicts on the tile for no fewer bytes).
// Other n_basis than 16 take the same path with coefficients read from
// shared memory.  Measured on an H100 (700 W) both kernels are bound by
// their blocks' serial chain of phases at 16 warps an SM, not by HBM.

#include <cuda_runtime.h>

#include <cstdint>

#include "warp_chol.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GROUP = 4;          // characters a block takes
constexpr int TILE_PASSES = 4;        // frames a thread emits into one tile
constexpr int SMEM_OPT_IN = 200 * 1024;  // raised once a process

struct Args {
  const float* eigen;
  const float* mean;
  const long long* mix_id;
  const float* alpha;
  const float* basis;      // back-projection: [C or 1, T, n_basis]
  const float* knots;      // emit: [M, n_basis + 4]
  const float* t_fn;       // emit: [C, T]
  const int* n_frames;     // emit: [C]
  const float* prev_last;  // emit: [C, n_dim]
  float* out;              // [C, T, n_dim]
  float* new_last;         // emit: [C, n_dim]
  int c, n_mix, k, n_basis, n_dim, t, shared_basis, has_prev, window;
  int group;         // characters a block takes
  int nq;            // quads a frame: ceil((n_dim + 1) / 4)
  int kp;            // row stride of the eigen tile (odd)
  int fg;            // frames the block emits at once: THREADS / nq
  int union_floats;  // the larger of the eigen chunks and the two tiles
};

__device__ __forceinline__ float4 fma4(float s, float4 c, float4 a) {
  return make_float4(fmaf(s, c.x, a.x), fmaf(s, c.y, a.y), fmaf(s, c.z, a.z),
                     fmaf(s, c.w, a.w));
}

// The 4 non-zero cubic B-spline weights at t, as ops/bspline.basis_matrix
// computes them (the query clamped into the knots, the last non-empty span
// closed, 0/0 := 0), each product and sum rounded on its own as there:
// w.x .. w.w belong to basis functions sp - 3 .. sp; sp = -1 and w = 0 when
// no span holds the query.
__device__ void bspline_weights(const float* kn, int n_knots, float t,
                                float4& w, int& sp) {
  const float tmax = kn[n_knots - 1];
  const float tc = fminf(fmaxf(t, kn[0]), tmax);
  sp = -1;
  for (int s = 0; s + 1 < n_knots; ++s) {
    const float left = kn[s], right = kn[s + 1];
    const bool hit = right >= tmax
                         ? (tc >= left && tc <= right && left < right)
                         : (tc >= left && tc < right);
    if (hit) sp = s;
  }
  w = make_float4(0.f, 0.f, 0.f, 0.f);
  if (sp < 0) return;
  float a[5] = {0.f, 0.f, 0.f, 1.f, 0.f};  // degree-0 functions sp-3 .. sp+1
#pragma unroll
  for (int deg = 1; deg <= 3; ++deg) {
    float nw[4] = {0.f, 0.f, 0.f, 0.f};
    // at this level functions sp-deg .. sp are non-zero; the lowest takes
    // only its right neighbour, the highest only itself (the skipped
    // products are exact zeros there)
#pragma unroll
    for (int idx = 3 - deg; idx < 4; ++idx) {
      const int i = sp - 3 + idx;
      if (i >= 0 && i + deg + 1 < n_knots) {
        float t1 = 0.f, t2 = 0.f;
        if (idx > 3 - deg) {
          const float d1 = __fsub_rn(kn[i + deg], kn[i]);
          if (d1 > 0.f)
            t1 = __fmul_rn(__fdiv_rn(__fsub_rn(tc, kn[i]), d1), a[idx]);
        }
        if (idx < 3) {
          const float d2 = __fsub_rn(kn[i + deg + 1], kn[i + 1]);
          if (d2 > 0.f)
            t2 = __fmul_rn(__fdiv_rn(__fsub_rn(kn[i + deg + 1], tc), d2),
                           a[idx + 1]);
        }
        nw[idx] = __fadd_rn(t1, t2);
      }
    }
#pragma unroll
    for (int idx = 0; idx < 4; ++idx) a[idx] = nw[idx];
  }
  w = make_float4(a[0], a[1], a[2], a[3]);
}

// sum_i w_i cq[(sp - 3 + i) * nq + q] with the coefficients in shared
// memory; basis functions outside [0, nb) do not exist.
__device__ __forceinline__ float4 taps_shared(const float4* cq, int nb,
                                              int nq, int q, float4 w,
                                              int sp) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  const float ws[4] = {w.x, w.y, w.z, w.w};
  if (sp < 0) return acc;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int b = sp - 3 + i;
    if (b >= 0 && b < nb) acc = fma4(ws[i], cq[b * nq + q], acc);
  }
  return acc;
}

struct Vec3 {
  float x, y, z;
};

__device__ __forceinline__ Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// ops/quat.rotate_vec: v + 2 (w (u x v) + u x (u x v)).
__device__ __forceinline__ Vec3 rotate_vec(float w, Vec3 u, Vec3 v) {
  const Vec3 uv = cross(u, v);
  const Vec3 uuv = cross(u, uv);
  return {v.x + 2.f * (w * uv.x + uuv.x), v.y + 2.f * (w * uv.y + uuv.y),
          v.z + 2.f * (w * uv.z + uuv.z)};
}

// ops/align.heading_angle of a quaternion quad (w, x, y, z).
__device__ __forceinline__ float heading_angle(float4 q) {
  const float n =
      fmaxf(sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w), 1e-12f);
  const Vec3 v = rotate_vec(q.x / n, {q.y / n, q.z / n, q.w / n},
                            {0.f, 0.f, 1.f});
  return atan2f(v.x, v.z);
}

// The root transform (rotation about Y by (qw, qy), then the XZ offset) on a
// thread's own quad: quad 0 is (pad, x, y, z), quad 1 the root quaternion.
__device__ __forceinline__ float4 transform_quad(float4 v, int q, float qw,
                                                 float qy, float dx,
                                                 float dz) {
  if (q == 0) {
    const Vec3 r = rotate_vec(qw, {0.f, qy, 0.f}, {v.y, v.z, v.w});
    return make_float4(v.x, r.x + dx, r.y, r.z + dz);
  }
  if (q == 1)  // ops/quat.multiply((qw, 0, qy, 0), v)
    return make_float4(qw * v.x - qy * v.z, qw * v.y + qy * v.w,
                       qw * v.z + qy * v.x, qw * v.w - qy * v.y);
  return v;
}

// -1 where the quad lies in the other hemisphere than ref (a zero ref, as the
// translation quad's, gives +1).
__device__ __forceinline__ float hemisphere_sign(float4 v, float4 ref) {
  const float dot = v.x * ref.x + v.y * ref.y + v.z * ref.z + v.w * ref.w;
  return dot < 0.f ? -1.f : 1.f;
}

// 16-byte asynchronous copies (cp.async) of n floats into shared memory where
// the source allows, plain loads else; the caller commits and waits.
__device__ __forceinline__ void block_copy_async(float* dst, const float* src,
                                                 int n) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0) {
    const int n4 = n / 4;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      const unsigned d =
          (unsigned)__cvta_generic_to_shared(dst + 4 * (size_t)i);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                   "l"(src + 4 * (size_t)i));
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) dst[i] = src[i];
  }
}

__device__ __forceinline__ void async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int NB, bool EMIT>
__device__ __forceinline__ void frames_body(const Args& p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int ch_s[MAX_GROUP];
  __shared__ int mix_s[MAX_GROUP];  // -1: outside the tables
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nb = NB > 0 ? NB : p.n_basis;
  const int nq = p.nq, n_dim = p.n_dim, k = p.k, kp = p.kp, t_len = p.t;
  const int d = nb * n_dim, n_knots = nb + 4;
  const int ka = (k + 3) & ~3;  // a character's alphas, zero-padded to 4
  const int tile_t = TILE_PASSES * p.fg;
  const bool aligned = EMIT && p.has_prev != 0;
  const bool smooth = aligned && p.window > 0;
  // shared memory: the coefficients, then a region that holds the eigen
  // chunks first and the two output tiles later, then the small tables
  float4* cq = reinterpret_cast<float4*>(smem);        // [group][nb][nq]
  float* cqf = smem;
  float* un = smem + (size_t)p.group * nb * nq * 4;
  float4* stage = reinterpret_cast<float4*>(un);       // [2][tile_t][nq]
  float* alpha_s = un + p.union_floats;                // [group][ka]
  float* extra = alpha_s + p.group * ka;
  float4* w_s = reinterpret_cast<float4*>(extra);      // emit: [group][T]
  float4* prev_s = w_s + (size_t)p.group * t_len;      // emit: [group][nq]
  float4* xf_s = prev_s + (size_t)p.group * nq;        // emit: [group]
  int* sp_s = reinterpret_cast<int*>(xf_s + p.group);  // emit: [group][T]
  float* fac_s = reinterpret_cast<float*>(sp_s + (size_t)p.group * t_len);
  float* bs_s = extra;                                 // else: [2][T][nb]

  if (tid < p.group) {
    const int c = blockIdx.x + tid * gridDim.x;
    int m = -1;
    if (c < p.c) {
      const long long mm = p.mix_id[c];
      if (mm >= 0 && mm < p.n_mix) m = (int)mm;
    }
    ch_s[tid] = c < p.c ? c : -1;
    mix_s[tid] = m;
  }
  for (int i = tid; i < p.group * nb * nq * 4; i += THREADS) cqf[i] = 0.f;
  __syncthreads();

  // ---- everything that needs no coefficients, for all the block's
  // characters at once: their loads run beside the eigen tables'
  for (int i = tid; i < p.group * ka; i += THREADS) {
    const int g = i / ka, j = i - g * ka;
    alpha_s[i] =
        mix_s[g] >= 0 && j < k ? p.alpha[(size_t)ch_s[g] * k + j] : 0.f;
  }
  if (EMIT) {
    for (int i = tid; i < p.group * t_len; i += THREADS) {
      const int g = i / t_len, tt = i - g * t_len;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      int sp = -1;
      if (mix_s[g] >= 0)
        bspline_weights(p.knots + (size_t)mix_s[g] * n_knots, n_knots,
                        p.t_fn[(size_t)ch_s[g] * t_len + tt], w, sp);
      w_s[i] = w;
      sp_s[i] = sp;
    }
    if (smooth)  // ops/align.smoothing_factors
      for (int tt = tid; tt < t_len; tt += THREADS)
        fac_s[tt] =
            tt <= p.window ? 1.f - (float)tt / (float)p.window : 0.f;
    if (aligned)
      for (int i = tid; i < p.group * nq * 4; i += THREADS) {
        const int g = i / (nq * 4), ch = i - g * nq * 4 - 1;
        reinterpret_cast<float*>(prev_s)[i] =
            mix_s[g] >= 0 && ch >= 0 && ch < n_dim
                ? p.prev_last[(size_t)ch_s[g] * n_dim + ch] : 0.f;
      }
  }

  __syncthreads();  // the alphas are in place

  // ---- coefficients: each distinct node's table read once a block, a
  // warp a chunk of 32 rows at its own pace (no block barrier in here)
  float* chunk = un + (size_t)warp * 32 * kp;
  for (int g = 0; g < p.group; ++g) {
    const int m = mix_s[g];
    bool first = m >= 0;
    for (int g0 = 0; g0 < g; ++g0) first = first && mix_s[g0] != m;
    if (!first) continue;
    const float* em = p.eigen + (size_t)m * d * k;
    const float* mm = p.mean + (size_t)m * d;
    for (int r0 = warp * 32; r0 < d; r0 += THREADS) {
      const int rows = min(32, d - r0);
      const float* src = em + (size_t)r0 * k;
      __syncwarp();  // the chunk's last readers are done
      if (kp == k && reinterpret_cast<uintptr_t>(src) % 16 == 0) {
        const int n4 = rows * k / 4;
        for (int i = lane; i < n4; i += 32)
          reinterpret_cast<float4*>(chunk)[i] =
              reinterpret_cast<const float4*>(src)[i];
        for (int i = 4 * n4 + lane; i < rows * k; i += 32) chunk[i] = src[i];
      } else {
        for (int i = lane; i < rows * k; i += 32) {
          const int rr = i / k;
          chunk[rr * kp + (i - rr * k)] = src[i];
        }
      }
      __syncwarp();
      if (lane < rows) {
        const int row = r0 + lane;
        const int b = row / n_dim, h = row - b * n_dim;
        const float* e = chunk + lane * kp;
        const float mu = mm[row];
        // one pass over the row for every character of this node: the
        // alphas come as 16-byte loads all lanes make at one address
        float acc[MAX_GROUP];
#pragma unroll
        for (int g2 = 0; g2 < MAX_GROUP; ++g2) acc[g2] = 0.f;
        for (int j = 0; j < ka; j += 4) {
          const float e0 = e[j], e1 = j + 1 < k ? e[j + 1] : 0.f;
          const float e2 = j + 2 < k ? e[j + 2] : 0.f;
          const float e3 = j + 3 < k ? e[j + 3] : 0.f;
#pragma unroll
          for (int g2 = 0; g2 < MAX_GROUP; ++g2) {
            if (g2 < g || g2 >= p.group || mix_s[g2] != m) continue;
            const float4 a =
                *reinterpret_cast<const float4*>(alpha_s + g2 * ka + j);
            acc[g2] = fmaf(e3, a.w, fmaf(e2, a.z, fmaf(e1, a.y,
                                                      fmaf(e0, a.x, acc[g2]))));
          }
        }
#pragma unroll
        for (int g2 = 0; g2 < MAX_GROUP; ++g2) {
          if (g2 < g || g2 >= p.group || mix_s[g2] != m) continue;
          cqf[((size_t)(g2 * nb + b) * nq) * 4 + 1 + h] = acc[g2] + mu;
        }
      }
    }
  }
  __syncthreads();

  // ---- the aligning transforms, applied to the root coefficients: the
  // transform is affine and a frame's weights sum to 1, so it commutes with
  // the spline (constraints take their aligned coefficients the same way)
  if (aligned) {
    if (tid < p.group && mix_s[tid] >= 0) {
      // ops/align.node_aligning_2d_transform(prev_last, frame 0)
      const float4* cqg = cq + (size_t)tid * nb * nq;
      const float4 w = w_s[(size_t)tid * t_len];
      const int sp = sp_s[(size_t)tid * t_len];
      const float4 p0 = taps_shared(cqg, nb, nq, 0, w, sp);
      const float4 q0 = taps_shared(cqg, nb, nq, 1, w, sp);
      const float4 pp = prev_s[tid * nq], pq = prev_s[tid * nq + 1];
      const float theta = heading_angle(pq) - heading_angle(q0);
      const float qw = cosf(theta * 0.5f), qy = sinf(theta * 0.5f);
      const Vec3 r = rotate_vec(qw, {0.f, qy, 0.f}, {p0.y, p0.z, p0.w});
      xf_s[tid] = make_float4(qw, qy, pp.y - r.x, pp.w - r.z);
    }
    __syncthreads();
    for (int i = tid; i < p.group * nb * 2; i += THREADS) {
      const int g = i / (nb * 2), rest = i - g * nb * 2;
      const int b = rest >> 1, qq = rest & 1;
      if (mix_s[g] < 0) continue;
      const float4 xf = xf_s[g];
      float4* cell = cq + ((size_t)g * nb + b) * nq + qq;
      *cell = transform_quad(*cell, qq, xf.x, xf.y, xf.z, xf.w);
    }
    __syncthreads();
  }

  // ---- frames, one character after the other
  const int q = tid % nq, fgi = tid / nq;
  const bool worker = fgi < p.fg;
  // the flat copy's walk over (row, channel), THREADS elements a stride
  const int row0 = tid / n_dim, ch0 = tid - row0 * n_dim;
  const int drow = THREADS / n_dim, dch = THREADS - drow * n_dim;
  constexpr bool REGS = NB > 0 && !EMIT;  // a quad column's coefficients
  int next_basis = 0;  // the next character whose basis rows are wanted
  int buf = 0;         // the output tile the next pass fills

  for (int g = 0; g < p.group; ++g) {
    const int c = ch_s[g];
    if (c < 0) continue;  // uniform over the block
    float* out_c = p.out + (size_t)c * t_len * n_dim;
    if (mix_s[g] < 0) {
      const float nan = __int_as_float(0x7fc00000);
      for (int i = tid; i < t_len * n_dim; i += THREADS) out_c[i] = nan;
      if (EMIT)
        for (int i = tid; i < n_dim; i += THREADS)
          p.new_last[(size_t)c * n_dim + i] = nan;
      continue;
    }
    const float4* cqg = cq + (size_t)g * nb * nq;
    float4 creg[REGS ? NB : 1];
    if (REGS && worker) {
#pragma unroll
      for (int b = 0; b < NB; ++b) creg[b] = cqg[b * nq + q];
    }

    // per-character state of the thread's quad
    float4 ref = make_float4(0.f, 0.f, 0.f, 0.f), mag = ref, xf = ref;
    int last = 0;
    const float4* wg = w_s + (size_t)g * t_len;
    const int* spg = sp_s + (size_t)g * t_len;
    const float* bsg = bs_s;
    if (EMIT) {
      last = max(p.n_frames[c] - 1, 0);
      if (aligned) xf = xf_s[g];
      if (smooth && worker) {
        // the hemisphere reference (none for the translation quad) and the
        // blend's offset: prev_last minus the signed aligned frame 0
        const float4 prev = prev_s[g * nq + q];
        if (q > 0) ref = prev;
        float4 f0 = taps_shared(cqg, nb, nq, q, wg[0], spg[0]);
        if (spg[0] < 0 && q == 0) f0 = make_float4(0.f, xf.z, 0.f, xf.w);
        const float s0 = hemisphere_sign(f0, ref);
        mag = make_float4(prev.x - f0.x * s0, prev.y - f0.y * s0,
                          prev.z - f0.z * s0, prev.w - f0.w * s0);
      }
    } else {
      // the character's basis rows: asked for one character ahead, so the
      // copy runs beside the frames before it
      const int n = t_len * nb;
      const int stride = (n + 3) & ~3;  // buffers start on 16 bytes
      for (; next_basis <= g + 1 && next_basis < p.group; ++next_basis) {
        if (ch_s[next_basis] >= 0 && mix_s[next_basis] >= 0 &&
            (!p.shared_basis || next_basis == 0 || next_basis == g))
          block_copy_async(
              bs_s + (size_t)(p.shared_basis ? 0 : (next_basis & 1)) * stride,
              p.basis + (p.shared_basis
                             ? 0 : (size_t)ch_s[next_basis] * t_len * nb), n);
        async_commit();
      }
      if (next_basis > g + 1) async_wait<1>(); else async_wait<0>();
      __syncthreads();
      bsg = bs_s + (size_t)(p.shared_basis ? 0 : (g & 1)) * stride;
    }

    for (int tile0 = 0; tile0 < t_len; tile0 += tile_t, buf ^= 1) {
      const int tile_end = min(t_len, tile0 + tile_t);
      float4* st = stage + (size_t)buf * tile_t * nq;
      if (worker) {
#pragma unroll
        for (int pass = 0; pass < TILE_PASSES; ++pass) {
          const int tt = tile0 + fgi + pass * p.fg;
          if (tt >= tile_end) break;
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (EMIT) {
            const int sp = spg[tt];
            v = taps_shared(cqg, nb, nq, q, wg[tt], sp);
            if (aligned && sp < 0 && q == 0)  // the transform of a 0 frame
              v = make_float4(0.f, xf.z, 0.f, xf.w);
            if (smooth) {
              const float sg = hemisphere_sign(v, ref);
              const float f = fac_s[tt];
              v = make_float4(__fadd_rn(v.x * sg, __fmul_rn(f, mag.x)),
                              __fadd_rn(v.y * sg, __fmul_rn(f, mag.y)),
                              __fadd_rn(v.z * sg, __fmul_rn(f, mag.z)),
                              __fadd_rn(v.w * sg, __fmul_rn(f, mag.w)));
            }
          } else if (REGS) {
            const float4* b4 =
                reinterpret_cast<const float4*>(bsg + (size_t)tt * NB);
#pragma unroll
            for (int b = 0; b < NB / 4; ++b) {
              const float4 bv = b4[b];
              v = fma4(bv.x, creg[4 * b], v);
              v = fma4(bv.y, creg[4 * b + 1], v);
              v = fma4(bv.z, creg[4 * b + 2], v);
              v = fma4(bv.w, creg[4 * b + 3], v);
            }
          } else {
            for (int b = 0; b < nb; ++b)
              v = fma4(bsg[(size_t)tt * nb + b], cqg[b * nq + q], v);
          }
          st[(tt - tile0) * nq + q] = v;
        }
      }
      // one barrier a tile: the next tile goes to the other buffer, and the
      // barrier after it keeps this copy ahead of the buffer's next filling
      __syncthreads();
      const int n = (tile_end - tile0) * n_dim;
      const float* src = reinterpret_cast<const float*>(st);
      float* dst = out_c + (size_t)tile0 * n_dim;
      int row = row0, ch = ch0;
#pragma unroll 4
      for (int i = tid; i < n; i += THREADS) {
        const float val = src[row * nq * 4 + 1 + ch];
        dst[i] = val;
        if (EMIT && tile0 + row == last)
          p.new_last[(size_t)c * n_dim + ch] = val;
        row += drow;
        ch += dch;
        if (ch >= n_dim) {
          ch -= n_dim;
          ++row;
        }
      }
    }
  }
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 2) back_project_kernel(Args p) {
  frames_body<NB, false>(p);
}

template <int NB>
__global__ void __launch_bounds__(THREADS, 2) emit_frames_kernel(Args p) {
  frames_body<NB, true>(p);
}

// The opt-in above 48 KB of dynamic shared memory, once a process and kernel.
template <typename Kernel>
int launch_one(Kernel kernel, bool* raised, const Args& p, size_t smem,
               cudaStream_t stream) {
  if (smem > (size_t)SMEM_OPT_IN) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024 && !*raised) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_OPT_IN);
    if (err != cudaSuccess) return (int)err;
    *raised = true;
  }
  const int blocks = (p.c + p.group - 1) / p.group;
  kernel<<<blocks, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int launch(Args p, bool emit, cudaStream_t stream) {
  p.nq = (p.n_dim + 4) / 4;
  if (p.nq > THREADS || p.n_basis + 4 > THREADS || p.k < 1 || p.n_basis < 1)
    return (int)cudaErrorInvalidValue;
  if (emit && (p.n_dim < 7 || (p.n_dim - 3) % 4 != 0))
    return (int)cudaErrorInvalidValue;
  // enough blocks for every SM first, then up to MAX_GROUP characters a block
  p.group = p.c / mg::sm_count();
  p.group = p.group < 1 ? 1 : (p.group > MAX_GROUP ? MAX_GROUP : p.group);
  p.fg = THREADS / p.nq;
  p.kp = p.k | 1;
  // one region holds a chunk of 32 eigen rows a warp first, then the two
  // output tiles
  p.union_floats = THREADS * p.kp;
  const int tiles = 2 * TILE_PASSES * p.fg * p.nq * 4;
  if (tiles > p.union_floats) p.union_floats = tiles;
  p.union_floats = (p.union_floats + 3) & ~3;
  // emit: weights (16 B) and spans (4 B) of every frame, prev_last and the
  // transform (16 B a quad), the blend factors; else two basis buffers
  const size_t extra =
      emit ? (size_t)p.group * (p.t * 5 + p.nq * 4 + 4) + p.t
           : 2 * (((size_t)p.t * p.n_basis + 3) & ~(size_t)3);
  const size_t smem =
      sizeof(float) * ((size_t)p.group * p.n_basis * p.nq * 4 +
                       p.union_floats + (size_t)p.group * ((p.k + 3) & ~3) +
                       extra);
  static bool raised[4] = {false, false, false, false};
  if (emit) {
    if (p.n_basis == 16)
      return launch_one(emit_frames_kernel<16>, &raised[0], p, smem, stream);
    return launch_one(emit_frames_kernel<0>, &raised[1], p, smem, stream);
  }
  if (p.n_basis == 16)
    return launch_one(back_project_kernel<16>, &raised[2], p, smem, stream);
  return launch_one(back_project_kernel<0>, &raised[3], p, smem, stream);
}

}  // namespace

extern "C" int mg_back_project(const float* eigen, const float* mean,
                               const long long* mix_id, const float* alpha,
                               const float* basis, float* out, int c,
                               int n_mix, int k, int n_basis, int n_dim, int t,
                               int shared_basis, void* stream) {
  Args p = {};
  p.eigen = eigen;
  p.mean = mean;
  p.mix_id = mix_id;
  p.alpha = alpha;
  p.basis = basis;
  p.out = out;
  p.c = c;
  p.n_mix = n_mix;
  p.k = k;
  p.n_basis = n_basis;
  p.n_dim = n_dim;
  p.t = t;
  p.shared_basis = shared_basis;
  return launch(p, false, (cudaStream_t)stream);
}

extern "C" int mg_emit_frames(const float* eigen, const float* mean,
                              const float* knots, const long long* mix_id,
                              const float* alpha, const float* t_fn,
                              const int* n_frames, const float* prev_last,
                              float* out, float* new_last, int c, int n_mix,
                              int k, int n_basis, int n_dim, int t,
                              int has_prev, int window, void* stream) {
  Args p = {};
  p.eigen = eigen;
  p.mean = mean;
  p.knots = knots;
  p.mix_id = mix_id;
  p.alpha = alpha;
  p.t_fn = t_fn;
  p.n_frames = n_frames;
  p.prev_last = prev_last;
  p.out = out;
  p.new_last = new_last;
  p.c = c;
  p.n_mix = n_mix;
  p.k = k;
  p.n_basis = n_basis;
  p.n_dim = n_dim;
  p.t = t;
  p.has_prev = has_prev;
  p.window = window;
  return launch(p, true, (cudaStream_t)stream);
}
