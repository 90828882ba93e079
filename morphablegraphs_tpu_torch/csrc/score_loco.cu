// Locomotion candidate scoring (kernel B1) and its end-effector variant
// (kernel B3).
//
// Replaces the TPU kernels morphablegraphs_tpu/ops/pallas_kernels.py
// `score_locomotion_candidates` (`_score_loco_kernel` + `_loco_score_body`,
// and with a chain `_score_loco_ee_kernel`).  For every candidate latent of
// every character it evaluates the 19 root frames M'·[alpha; 1], aligns them
// to the previous step from the candidate's own frame 0, and sums the
// goal-keyframe XZ distance, the 2D direction error in degrees (the same
// polynomial atan2 as the TPU kernel) and 16 advancing closest-point
// distances against the character's arc table.  B3 (EE = true) adds one
// position-only end-effector keyframe: the operator's extra rows give the
// raw root translation and each chain joint's local quaternion at the
// keyframe, and each candidate walks the ancestor chain (the chain table
// [L, 8] staged in shared memory), in fk_global's composition order with
// unnormalized quaternions, exactly as the TPU kernel: the aligning rotation
// enters as the half-angle quaternion (c2, s2) of (ct, st), a fixed joint
// takes its rest rotation, and the distance is sqrt(max(., 1e-12)).
//
// What bounds it on the H100: not memory (a character's operator is 16 KB,
// its arc table at most 24 KB, a candidate's latent 100 B) but the 16
// advancing closest-point searches per candidate, each a pass over the
// table rows at or above its floor and a short second pass.  The first
// design (one thread a candidate, both passes over the whole table, six
// scalar shared loads per row and pass) was bound by shared-load issue.
// This one is bound by instruction issue: ~7 instructions a table row in
// pass 1 (a 16-byte load, 4 operations of |t|^2 - 2 t.p, a minimum, the
// loop) at about half the card's issue rate; rows of 12 bytes, four
// running minima or more warps per SM did not run faster.  What the design
// does:
// * One 16-byte load per table row: each row is staged as
//   {-2x, -2y, -2z, |t|^2}, with |t|^2 = NaN on a row that is not valid, so
//   such a row fails every compare without a second load.  -2 t.p built from
//   the pre-scaled row is exactly -(2 t.p) (scaling by 2 commutes with
//   round-to-nearest), so |t|^2 + (-2 t.p) + |p|^2 keeps the bits of the
//   TPU kernel's |t|^2 - 2 t.p + |p|^2; the _rn intrinsics keep both passes
//   on the same bits.
// * A search that starts at its floor.  Beside the rows, the block stages
//   the running maximum of the valid rows' arcs (NaN before the first valid
//   row).  PRECONDITION: the arcs never decrease over the valid rows, as
//   pack_path_table builds them (a cumsum of segment lengths).  A binary
//   search over that column finds the first valid row at or above the floor
//   min_arc - 1e-6; every valid row after it is above the floor too, so
//   pass 1 reads rows from there on, and the first row of pass 2 within
//   1e-6 of the minimum has the smallest arc of all such rows: pass 2 stops
//   there.  dmin2, the arc and the sum equal two full masked passes bit for
//   bit (tests/test_torch_score_search.py emulates this order on the CPU).
// * The lanes of a warp scan the same rows in step, from the warp's
//   smallest start (each lane masks the rows below its own), so a row load
//   is one broadcast for the whole warp.  Pass 1 takes the minimum of
//   |t|^2 - 2 t.p and adds |p|^2 once: rounding that sum is monotone, so
//   the result has the bits of the least distance.
// * LPC lanes per candidate (a template width 1, 2, ..., 32): a candidate's
//   rows are strided over its lanes, its minimum reduced with shuffles and
//   its first hit found with ballots.  The wrapper picks LPC so that the
//   grid holds at least eight warps per SM: 1 at the crowd (1024 x 128
//   candidates), 4 at 128 x 128, 32 at the serving batch (8 x 128).
// * The first 32 latent coefficients of a candidate live in registers and
//   the operator rows are read as float4; every frame row keeps the k order
//   of its fmaf chain, so every score keeps its bits.

#include <cuda_runtime.h>

namespace {

constexpr int N_EVAL = 19;    // goal kf | dir | 16 traj samples | frame 0
constexpr int CH = 8;         // channels per eval frame (x y z qw qx qy qz pad)
constexpr int N_THREADS = 128;  // threads per block
constexpr int KR = 32;        // latent coefficients held in registers
constexpr int CFG_W = 48;
constexpr unsigned FULL = 0xffffffffu;
constexpr float PI_F = 3.14159265358979323846f;

__device__ __forceinline__ float poly_atan2(float y, float x) {
  // range-reduced 3-term minimax atan on [0, 1], as the TPU kernel
  float ax = fabsf(x), ay = fabsf(y);
  float hi = fmaxf(ax, ay), lo = fminf(ax, ay);
  float a = lo / fmaxf(hi, 1e-30f);
  float s = a * a;
  float r = ((-0.0464964749f * s + 0.15931422f) * s - 0.327622764f) * s * a + a;
  if (ay > ax) r = 0.5f * PI_F - r;
  if (x < 0.f) r = PI_F - r;
  return (y < 0.f) ? -r : r;
}

// |t|^2 - 2 t.p from a staged row {-2x, -2y, -2z, |t|^2}; the distance
// adds |p|^2 to it
__device__ __forceinline__ float table_x(float4 t, float px, float py,
                                         float pz) {
  float cross2 = __fmaf_rn(t.z, pz, __fmaf_rn(t.y, py, __fmul_rn(t.x, px)));
  return __fadd_rn(t.w, cross2);
}

template <bool EE, int LPC>
__global__ void __launch_bounds__(N_THREADS, 4)
score_loco_kernel(const float* __restrict__ mop,
                  const float* __restrict__ alphas,
                  const float* __restrict__ table,
                  const float* __restrict__ cfg,
                  const float* __restrict__ chain, float* __restrict__ out,
                  int n, int k, int g8, int rows, int depth) {
  constexpr int CPB = N_THREADS / LPC;  // candidates per block
  extern __shared__ float4 smem4[];
  __shared__ float s_wmax[N_THREADS / 32];
  const int k1 = k + 1, k1p = (k1 + 3) & ~3;
  float4* s_tab = smem4;                                // [g8]
  float* s_key = reinterpret_cast<float*>(s_tab + g8);  // [g8]
  float* s_mop = s_key + ((g8 + 3) & ~3);               // [rows, k1p]
  float* s_alpha = s_mop + rows * k1p;                  // [k1, CPB]
  float* s_chain = s_alpha + k1 * CPB;                  // [depth, 8] (EE)
  const int c = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31;
  const int cl = tid / LPC;   // this thread's candidate within the block
  const int sub = tid % LPC;  // and its lane within the candidate
  const size_t cand0 = (size_t)c * n + (size_t)blockIdx.x * CPB;
  const float qnan = __int_as_float(0x7fffffff);
  const float inf = __int_as_float(0x7f800000);

  // table rows, one contiguous chunk a thread, and the running maximum of
  // the valid arcs: chunk maxima, then a block scan, then the chunk again
  const float* tab_c = table + (size_t)c * g8 * 5;
  const int chunk = (g8 + N_THREADS - 1) / N_THREADS;
  const int r0 = min(tid * chunk, g8), r1 = min(r0 + chunk, g8);
  float run = qnan;
  for (int r = r0; r < r1; ++r) {
    const float* t = tab_c + r * 5;
    const float x = t[0], y = t[1], z = t[2], arc = t[3];
    const bool ok = t[4] > 0.f && arc == arc;
    const float w = x * x + y * y + z * z;
    s_tab[r] = make_float4(-2.f * x, -2.f * y, -2.f * z, ok ? w : qnan);
    s_key[r] = ok ? arc : qnan;
    run = fmaxf(run, s_key[r]);
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(FULL, run, off);
    if (lane >= off) run = fmaxf(run, v);
  }
  if (lane == 31) s_wmax[tid >> 5] = run;
  const float* mop_c = mop + (size_t)c * rows * k1;
  for (int i = tid; i < rows * k1p; i += N_THREADS) {
    const int r = i / k1p, kk = i - r * k1p;
    s_mop[i] = kk < k1 ? mop_c[r * k1 + kk] : 0.f;
  }
  const float* al = alphas + cand0 * k;
  for (int i = tid; i < CPB * k; i += N_THREADS)
    s_alpha[(i % k) * CPB + i / k] = al[i];
  for (int i = tid; i < CPB; i += N_THREADS) s_alpha[k * CPB + i] = 1.f;
  if (EE)
    for (int i = tid; i < depth * 8; i += N_THREADS) s_chain[i] = chain[i];
  __syncthreads();
  float prev = __shfl_up_sync(FULL, run, 1);
  if (lane == 0) prev = qnan;
  for (int w = 0; w < (tid >> 5); ++w) prev = fmaxf(prev, s_wmax[w]);
  for (int r = r0; r < r1; ++r) {
    prev = fmaxf(prev, s_key[r]);
    s_key[r] = prev;
  }
  __syncthreads();

  float a[KR];
#pragma unroll
  for (int kk = 0; kk < KR; ++kk)
    a[kk] = kk < k1 ? s_alpha[kk * CPB + cl] : 0.f;

  auto row = [&](int r) {
    const float4* m = reinterpret_cast<const float4*>(s_mop + r * k1p);
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < KR / 4; ++q) {
      if (4 * q < k1) {
        const float4 v = m[q];
        s = fmaf(v.x, a[4 * q], s);
        if (4 * q + 1 < k1) s = fmaf(v.y, a[4 * q + 1], s);
        if (4 * q + 2 < k1) s = fmaf(v.z, a[4 * q + 2], s);
        if (4 * q + 3 < k1) s = fmaf(v.w, a[4 * q + 3], s);
      }
    }
    for (int kk = KR; kk < k1; ++kk)
      s = fmaf(s_mop[r * k1p + kk], s_alpha[kk * CPB + cl], s);
    return s;
  };

  const float* cf = cfg + (size_t)c * CFG_W;
  const float cos_a_prev = cf[0], sin_a_prev = cf[29];
  const float prev_x = cf[1], prev_z = cf[3];
  const float cos_start = cf[4], sin_start = cf[30];
  const float sdx = cf[5], sdy = cf[6], sdz = cf[7];
  const bool has_prev = cf[8] > 0.f;
  const float goal_x = cf[9], goal_z = cf[11];
  const float kf_active = cf[12], kf_w = cf[13];
  const float dir_active = cf[14], dir_w = cf[15];
  const float traj_active = cf[16], traj_w = cf[17];
  float min_arc = cf[18];
  const float a_dir = cf[19];
  const float rng_lo = cf[20], rng_hi = cf[21];
  const float mx = cf[22], my = cf[23], mz = cf[24];
  const float ex = cf[25], ey = cf[26], ez = cf[27];
  const float full_arc = cf[28];

  // per-candidate aligning transform from frame 0 (block N_EVAL - 1)
  const int f0 = (N_EVAL - 1) * CH;
  float qw = row(f0 + 3), qx = row(f0 + 4), qy = row(f0 + 5), qz = row(f0 + 6);
  float n2 = qw * qw + qx * qx + qy * qy + qz * qz;
  float hx0 = 2.f * (qw * qy + qx * qz);
  float hz0 = n2 - 2.f * (qx * qx + qy * qy);
  float inv_n = rsqrtf(hx0 * hx0 + hz0 * hz0 + 1e-30f);
  float c_new = hz0 * inv_n, s_new = hx0 * inv_n;
  float ct = has_prev ? cos_a_prev * c_new + sin_a_prev * s_new : cos_start;
  float st = has_prev ? sin_a_prev * c_new - cos_a_prev * s_new : sin_start;
  float r0x = ct * row(f0) + st * row(f0 + 2);
  float r0z = -st * row(f0) + ct * row(f0 + 2);
  float dx = has_prev ? prev_x - r0x : sdx;
  float dz = has_prev ? prev_z - r0z : sdz;
  float dy = has_prev ? 0.f : sdy;

  // goal keyframe error (XZ)
  float g0 = row(0), g2 = row(2);
  float gx = ct * g0 + st * g2 + dx;
  float gz = -st * g0 + ct * g2 + dz;
  float kf_err = sqrtf((gx - goal_x) * (gx - goal_x) +
                       (gz - goal_z) * (gz - goal_z) + 1e-12f);

  // 2D direction error in degrees at the dir frame (block 1)
  qw = row(CH + 3); qx = row(CH + 4); qy = row(CH + 5); qz = row(CH + 6);
  n2 = qw * qw + qx * qx + qy * qy + qz * qz;
  float hxf = 2.f * (qw * qy + qx * qz);
  float hzf = n2 - 2.f * (qx * qx + qy * qy);
  float hxw = ct * hxf + st * hzf;
  float hzw = -st * hxf + ct * hzf;
  float diff = a_dir - poly_atan2(hxw, hzw);
  float wrapped = diff - 2.f * PI_F * floorf(diff / (2.f * PI_F) + 0.5f);
  float dir_err = fabsf(wrapped) * (180.f / PI_F);

  // trajectory: 16 advancing masked closest-point searches on the table
  const unsigned grp = (unsigned)(lane & ~(LPC - 1));  // candidate's lane 0
  const unsigned grp_bits = LPC == 32 ? FULL : (1u << LPC) - 1u;
  float traj_sum = 0.f;
  for (int f = 2; f < 2 + 16; ++f) {
    float p0 = row(f * CH), p2 = row(f * CH + 2);
    float px = (ct * p0 + st * p2 + dx) * mx;
    float pz = (-st * p0 + ct * p2 + dz) * mz;
    float py = (row(f * CH + 1) + dy) * my;
    float pn2 = px * px + py * py + pz * pz;
    float lo_arc = min_arc - 1e-6f;
    // the first row whose running valid-arc maximum reaches the floor;
    // start == g8: no valid row at or above it
    int lo = 0, hi = g8;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (s_key[mid] >= lo_arc) hi = mid; else lo = mid + 1;
    }
    const int start = lo;
    // the warp's rows: from its first start; from wend on, no searching
    // lane masks a row (a lane past the end reads rows it never uses)
    const int wstart = (int)__reduce_min_sync(FULL, (unsigned)start);
    const int wend =
        (int)__reduce_max_sync(FULL, start < g8 ? (unsigned)start : 0u);
    // pass 1: the least |t|^2 - 2 t.p over the valid rows from start on;
    // adding |p|^2 rounds monotonically, so the least distance is that
    // minimum plus |p|^2, the same bits as the least of the distances
    float xmin = inf;
    int r = wstart + sub;
    for (; r < wend; r += LPC) {
      const float x = table_x(s_tab[r], px, py, pz);
      if (r >= start) xmin = fminf(xmin, x);
    }
#pragma unroll 4
    for (; r < g8; r += LPC) xmin = fminf(xmin, table_x(s_tab[r], px, py, pz));
#pragma unroll
    for (int off = LPC / 2; off > 0; off >>= 1)
      xmin = fminf(xmin, __shfl_xor_sync(FULL, xmin, off));
    float dmin2 = __fadd_rn(xmin, pn2);
    if (!(dmin2 == dmin2)) dmin2 = inf;  // |p|^2 NaN: no distance counts
    // pass 2: the first row within 1e-6 of it has the smallest arc
    const float thr = dmin2 + 1e-6f;
    int hit = start < g8 ? -1 : g8;
    for (int base = wstart; base < g8 && !__all_sync(FULL, hit >= 0);
         base += LPC) {
      r = base + sub;
      const bool h = hit < 0 && r < g8 && r >= start &&
                     __fadd_rn(table_x(s_tab[r], px, py, pz), pn2) <= thr;
      if (LPC == 1) {
        if (h) hit = r;
      } else {
        const unsigned b = (__ballot_sync(FULL, h) >> grp) & grp_bits;
        if (hit < 0 && b) hit = base + __ffs(b) - 1;
      }
    }
    float arc_sel;
    if (start < g8) {
      arc_sel = hit >= 0 ? s_key[hit] : inf;
    } else {  // past the end: distance to the last real point, full arc
      dmin2 = (ex - px) * (ex - px) + (ey - py) * (ey - py) +
              (ez - pz) * (ez - pz);
      arc_sel = full_arc;
    }
    float d = sqrtf(fmaxf(dmin2, 1e-12f));
    if (arc_sel >= rng_lo && arc_sel <= rng_hi) traj_sum += d;
    min_arc = arc_sel;
  }

  float err = kf_active * kf_w * kf_err + dir_active * dir_w * dir_err +
              traj_active * traj_w * traj_sum / 16.f;

  if (EE) {
    // aligned raw root position at the ee keyframe (root offset shifted
    // out, as the table and the cfg target are)
    const int eb = N_EVAL * CH;
    float e0 = row(eb), e2 = row(eb + 2);
    float px = ct * e0 + st * e2 + dx;
    float pz = -st * e0 + ct * e2 + dz;
    float py = row(eb + 1) + dy;
    // q_acc = q_y(theta) * q_root, q_y from the half angle of (ct, st)
    float c2 = sqrtf(fmaxf((1.f + ct) * 0.5f, 0.f));
    float s2 = sqrtf(fmaxf((1.f - ct) * 0.5f, 0.f));
    if (!(st >= 0.f)) s2 = -s2;
    float lq[4];
    auto local_q = [&](int d) {
      const float* cd = s_chain + d * 8;
      for (int i = 0; i < 4; ++i)
        lq[i] = cd[7] > 0.f ? row(eb + 3 + 4 * d + i) : cd[3 + i];
    };
    local_q(0);
    float aw = c2 * lq[0] - s2 * lq[2];
    float ax = c2 * lq[1] + s2 * lq[3];
    float ay = c2 * lq[2] + s2 * lq[0];
    float az = c2 * lq[3] - s2 * lq[1];
    for (int d = 1; d < depth; ++d) {
      const float* cd = s_chain + d * 8;
      const float ox = cd[0], oy = cd[1], oz = cd[2];
      // rotate_vec(q_acc, off) = v + 2 (w u x v + u x (u x v))
      float uvx = ay * oz - az * oy;
      float uvy = az * ox - ax * oz;
      float uvz = ax * oy - ay * ox;
      float uuvx = ay * uvz - az * uvy;
      float uuvy = az * uvx - ax * uvz;
      float uuvz = ax * uvy - ay * uvx;
      px = px + ox + 2.f * (aw * uvx + uuvx);
      py = py + oy + 2.f * (aw * uvy + uuvy);
      pz = pz + oz + 2.f * (aw * uvz + uuvz);
      local_q(d);
      float nw = aw * lq[0] - ax * lq[1] - ay * lq[2] - az * lq[3];
      float nx = aw * lq[1] + ax * lq[0] + ay * lq[3] - az * lq[2];
      float ny = aw * lq[2] - ax * lq[3] + ay * lq[0] + az * lq[1];
      float nz = aw * lq[3] + ax * lq[2] - ay * lq[1] + az * lq[0];
      aw = nw; ax = nx; ay = ny; az = nz;
    }
    float ddx = (px - cf[33]) * cf[36];
    float ddy = (py - cf[34]) * cf[37];
    float ddz = (pz - cf[35]) * cf[38];
    err += cf[31] * cf[32] *
           sqrtf(fmaxf(ddx * ddx + ddy * ddy + ddz * ddz, 1e-12f));
  }
  if (sub == 0) out[cand0 + cl] = err;
}

template <bool EE, int LPC>
int launch(const float* mop, const float* alphas, const float* table,
           const float* cfg, const float* chain, float* out, int c, int n,
           int k, int g8, int depth, void* stream) {
  constexpr int CPB = N_THREADS / LPC;
  const int rows = N_EVAL * CH + (EE ? ((3 + 4 * depth + 7) / 8) * 8 : 0);
  const size_t k1p = (size_t)((k + 4) & ~3);
  const size_t smem = sizeof(float4) * (size_t)g8 +
                      sizeof(float) * ((size_t)((g8 + 3) & ~3) + rows * k1p +
                                       (size_t)(k + 1) * CPB +
                                       (EE ? (size_t)depth * 8 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      score_loco_kernel<EE, LPC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / CPB, c);
  score_loco_kernel<EE, LPC><<<grid, N_THREADS, smem, (cudaStream_t)stream>>>(
      mop, alphas, table, cfg, chain, out, n, k, g8, rows, depth);
  return (int)cudaGetLastError();
}

template <bool EE>
int launch_lanes(int lanes, const float* mop, const float* alphas,
                 const float* table, const float* cfg, const float* chain,
                 float* out, int c, int n, int k, int g8, int depth,
                 void* stream) {
#define MG_LAUNCH(L)                                                       \
  launch<EE, L>(mop, alphas, table, cfg, chain, out, c, n, k, g8, depth, \
                stream)
  switch (lanes) {
    case 1: return MG_LAUNCH(1);
    case 2: return MG_LAUNCH(2);
    case 4: return MG_LAUNCH(4);
    case 8: return MG_LAUNCH(8);
    case 16: return MG_LAUNCH(16);
    case 32: return MG_LAUNCH(32);
    default: return (int)cudaErrorInvalidValue;
  }
#undef MG_LAUNCH
}

}  // namespace

extern "C" int mg_score_loco(const float* mop, const float* alphas,
                             const float* table, const float* cfg, float* out,
                             int c, int n, int k, int g8, int lanes,
                             void* stream) {
  return launch_lanes<false>(lanes, mop, alphas, table, cfg, nullptr, out, c,
                             n, k, g8, 0, stream);
}

extern "C" int mg_score_loco_ee(const float* mop, const float* alphas,
                                const float* table, const float* cfg,
                                const float* chain, float* out, int c, int n,
                                int k, int g8, int depth, int lanes,
                                void* stream) {
  return launch_lanes<true>(lanes, mop, alphas, table, cfg, chain, out, c, n,
                            k, g8, depth, stream);
}
