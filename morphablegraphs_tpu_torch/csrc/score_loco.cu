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
// keyframe, and each thread walks the ancestor chain for its own candidate
// (the chain table [L, 8] staged in shared memory), in fk_global's
// composition order with unnormalized quaternions, exactly as the TPU
// kernel: the aligning rotation enters as the half-angle quaternion (c2, s2)
// of (ct, st), a fixed joint takes its rest rotation, and the distance is
// sqrt(max(., 1e-12)).  B3's extra rows cost 32 x 26 floats (3.3 KB) of
// shared memory and ~L rotate-multiply pairs per candidate, next to the
// searches below.
//
// What bounds it on the H100: not memory (a character's operator is 16 KB,
// its arc table at most 24 KB, a candidate's latent 100 B) but the
// sequential closest-point searches, 16 x 2 passes over up to 1008 table
// rows per candidate, about 10 flops per row.  The design keeps everything
// the searches read in shared memory: one block per (character, 128-candidate
// tile), one thread per candidate, the operator, the tile's latents
// (transposed, candidate-minor, so a warp reads 32 consecutive words) and the
// table with its precomputed |t|^2 all staged once per block.  Only the frame
// rows the body reads are evaluated, each a (K+1)-long dot product, so no
// thread holds 152 frame rows in registers.  The distance uses the expanded
// |t|^2 - 2 t.p + |p|^2 form of the TPU kernel, with round-to-nearest
// intrinsics so both passes of a search compute bit-identical values.

#include <cuda_runtime.h>

namespace {

constexpr int N_EVAL = 19;  // goal kf | dir | 16 traj samples | frame 0
constexpr int CH = 8;       // channels per eval frame (x y z qw qx qy qz pad)
constexpr int N_BLK = 128;  // candidates per block
constexpr int CFG_W = 48;
constexpr int TAB_W = 6;    // shared table row: x y z arc valid |t|^2
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

__device__ __forceinline__ float table_d2(const float* t, float px, float py,
                                          float pz, float pn2) {
  float cross = __fmaf_rn(t[2], pz, __fmaf_rn(t[1], py, __fmul_rn(t[0], px)));
  return __fadd_rn(__fsub_rn(t[5], __fmul_rn(2.f, cross)), pn2);
}

template <bool EE>
__global__ void score_loco_kernel(const float* __restrict__ mop,
                                  const float* __restrict__ alphas,
                                  const float* __restrict__ table,
                                  const float* __restrict__ cfg,
                                  const float* __restrict__ chain,
                                  float* __restrict__ out, int n, int k,
                                  int g8, int rows, int depth) {
  extern __shared__ float smem[];
  const int k1 = k + 1;
  float* s_mop = smem;                  // [rows, k1]
  float* s_alpha = s_mop + rows * k1;   // [k1, N_BLK]
  float* s_tab = s_alpha + k1 * N_BLK;  // [g8, TAB_W]
  float* s_chain = s_tab + g8 * TAB_W;  // [depth, 8] (EE)
  const int c = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t cand0 = (size_t)c * n + (size_t)blockIdx.x * N_BLK;

  const float* mop_c = mop + (size_t)c * rows * k1;
  for (int i = tid; i < rows * k1; i += N_BLK) s_mop[i] = mop_c[i];
  const float* al = alphas + cand0 * k;
  for (int i = tid; i < N_BLK * k; i += N_BLK)
    s_alpha[(i % k) * N_BLK + i / k] = al[i];
  s_alpha[k * N_BLK + tid] = 1.f;
  const float* tab_c = table + (size_t)c * g8 * 5;
  for (int r = tid; r < g8; r += N_BLK) {
    float x = tab_c[r * 5], y = tab_c[r * 5 + 1], z = tab_c[r * 5 + 2];
    float* t = s_tab + r * TAB_W;
    t[0] = x; t[1] = y; t[2] = z;
    t[3] = tab_c[r * 5 + 3];
    t[4] = tab_c[r * 5 + 4];
    t[5] = x * x + y * y + z * z;
  }
  if (EE)
    for (int i = tid; i < depth * 8; i += N_BLK) s_chain[i] = chain[i];
  __syncthreads();

  auto row = [&](int r) {
    const float* m = s_mop + r * k1;
    float s = 0.f;
    for (int kk = 0; kk < k1; ++kk) s = fmaf(m[kk], s_alpha[kk * N_BLK + tid], s);
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
  float r0 = row(f0), r2 = row(f0 + 2);
  float r0x = ct * r0 + st * r2;
  float r0z = -st * r0 + ct * r2;
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
  float traj_sum = 0.f;
  for (int f = 2; f < 2 + 16; ++f) {
    float p0 = row(f * CH), p2 = row(f * CH + 2);
    float px = (ct * p0 + st * p2 + dx) * mx;
    float pz = (-st * p0 + ct * p2 + dz) * mz;
    float py = (row(f * CH + 1) + dy) * my;
    float pn2 = px * px + py * py + pz * pz;
    float lo_arc = min_arc - 1e-6f;
    float dmin2 = __int_as_float(0x7f800000);
    bool any_valid = false;
    for (int r = 0; r < g8; ++r) {
      const float* t = s_tab + r * TAB_W;
      if (t[3] >= lo_arc && t[4] > 0.f) {
        dmin2 = fminf(dmin2, table_d2(t, px, py, pz, pn2));
        any_valid = true;
      }
    }
    float arc_sel;
    if (any_valid) {
      float thr = dmin2 + 1e-6f;
      arc_sel = __int_as_float(0x7f800000);
      for (int r = 0; r < g8; ++r) {
        const float* t = s_tab + r * TAB_W;
        if (t[3] >= lo_arc && t[4] > 0.f &&
            table_d2(t, px, py, pz, pn2) <= thr)
          arc_sel = fminf(arc_sel, t[3]);
      }
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
  out[cand0 + tid] = err;
}

template <bool EE>
int launch(const float* mop, const float* alphas, const float* table,
           const float* cfg, const float* chain, float* out, int c, int n,
           int k, int g8, int depth, void* stream) {
  const int rows = N_EVAL * CH + (EE ? ((3 + 4 * depth + 7) / 8) * 8 : 0);
  size_t smem = sizeof(float) *
                ((size_t)rows * (k + 1) + (size_t)(k + 1) * N_BLK +
                 (size_t)g8 * TAB_W + (EE ? (size_t)depth * 8 : 0));
  cudaError_t err = cudaFuncSetAttribute(
      score_loco_kernel<EE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n / N_BLK, c);
  score_loco_kernel<EE><<<grid, N_BLK, smem, (cudaStream_t)stream>>>(
      mop, alphas, table, cfg, chain, out, n, k, g8, rows, depth);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mg_score_loco(const float* mop, const float* alphas,
                             const float* table, const float* cfg, float* out,
                             int c, int n, int k, int g8, void* stream) {
  return launch<false>(mop, alphas, table, cfg, nullptr, out, c, n, k, g8, 0,
                       stream);
}

extern "C" int mg_score_loco_ee(const float* mop, const float* alphas,
                                const float* table, const float* cfg,
                                const float* chain, float* out, int c, int n,
                                int k, int g8, int depth, void* stream) {
  return launch<true>(mop, alphas, table, cfg, chain, out, c, n, k, g8, depth,
                      stream);
}
