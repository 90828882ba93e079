// The request path's exact Levenberg-Marquardt refinement of one step, all
// of its iterations, in one kernel (`request_lm`).
//
// Replaces no TPU kernel: the JAX package's sequential request path
// (morphablegraphs_tpu/synthesis/generator.py, `refine_lm`) hands the same
// LM to XLA, which fuses it.  On the card the port's eager stage
// (synthesis/generator.py `_lm_stage`: ops/lm.lm_minimize over
// constraints/compiled.evaluate_residuals, the jacobian by torch.func.jvp
// under vmap) replays as a CUDA graph of ~19,000 small kernels a step.
//
// Per start row c (one block each), n_iters iterations of lm_minimize on
//   r(s) = active * (error_scale * res(s) + quality_scale * nll(s)),
// then the exact constraint error of s_opt (error_from_residuals).  res is
// evaluate_residuals for a set whose single-slot families are at most the
// direction, without collision avoidance or a trajectory set: the
// keyframes (any joint, through its ancestor chain; the root alone when
// root_only), the direction and, with a path, the 16 trajectory samples
// (the advancing closest-point search with its parabola refinement, the
// arc clamp and u_at_arc_length).  nll is the mixture's -log p (kernel B5's
// arithmetic, gmm_row.cuh).  The jacobian is forward mode over every
// latent, one tangent a lane (dual numbers), with linearize's derivative
// conventions: a clamp passes the tangent where lo <= x <= hi, a maximum
// half of it at a tie, |x| none at 0, a norm none at 0; the search's
// argmin index passes none, the distance flows through the three gathered
// table values and the spline evaluation.  The step block is
// lm_delta_block's (Marquardt diagonal, the relative floor, the trust
// clip) solved by B2's register Cholesky (warp_chol.cuh); an improving
// step multiplies lambda by 0.1 (floor 1e-6) and doubles the radius (cap
// 16), a rejected one multiplies lambda by 10.  Float32 throughout.
//
// What bounds it on the H100: the chain of dependent steps on one SM.  The
// work is small (a few MFLOP an iteration at the service's widths) and
// cannot spread: every iteration needs the previous one's accept/reject,
// the trajectory search's sample j needs sample j-1's arc, the solve's
// column steps follow each other.  What the design does about it:
// * Nothing leaves the SM between iterations.  At launch the block folds
//   the B-spline basis at the step's query rows into the eigenvectors of
//   the channels the residuals read (a few hundred rows of k_s + 1), and
//   stages the path's arc table and the mixture in shared memory; the
//   iterations then read shared memory and registers only.
// * The frames are affine in the latent, so a tangent's derivative of a
//   channel is one entry of that folded operator: lane l reads column l.
//   Every lane carries the primal and its own tangent through the
//   alignment, the FK chain and the residual heads, so no jacobian column
//   waits on another.  The value-only evaluations (the probe, the final
//   error) run the same code on plain floats (`Real`), at about half the
//   instructions of the dual numbers.
// * Lane i keeps row i of JtJ in registers, accumulated from the jacobian
//   rows in shared memory, which is the layout B2's register solve takes.
// * The block's warps are replicas of one start's LM (the same primal,
//   bit for bit): they split only the table search of each trajectory
//   sample, a masked argmin over the 1,001-entry table, across the block's
//   threads, so that the sequential part of the chain is a quarter as long.

#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

#include "gmm_row.cuh"
#include "warp_chol.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_KF = 8;
constexpr int TRAJ = 16;
constexpr int N_RES = 49;  // compiled.py's residual layout
constexpr int R_DIR = 8, R_LA = 9, R_RT = 10, R_JR = 11, R_POSE = 12;
constexpr int R_TRAJ = 17;
constexpr int NW = 4;  // warps a block: replicas of one start's LM
constexpr int NT = 32 * NW;
constexpr int MAX_SLOTS = 32;  // active slots: at most 8 + 5 + 16 here
constexpr int MAX_DEPTH = 16;  // ancestor chain, root to node
constexpr int MAX_NODES = 128;
// query rows: the first coefficient row, the direction's, the keyframes'
// and the trajectory samples'
constexpr int ROW_FIRST = 0, ROW_DIR = 1, ROW_KF = 2, ROW_LIN = 2 + MAX_KF;
constexpr int MAX_ROWS = ROW_LIN + TRAJ;
constexpr float RAD2DEG = 57.29577951308232f;
constexpr float ONE_M = (float)(1.0 - 1e-6);

// The pointer arguments, in the wrapper's order (kernels.REQUEST_LM_POINTERS).
enum Ptr {
  P_EIGEN, P_MEAN, P_KNOTS, P_GMM_W, P_GMM_MU, P_GMM_PREC,
  P_PARENTS, P_ANIM, P_OFFSETS, P_REST,
  P_KF_ACTIVE, P_KF_NODE, P_KF_POS, P_KF_POS_MASK, P_KF_QUAT, P_KF_HAS_QUAT,
  P_KF_FRAME, P_KF_WEIGHT,
  P_DIR_ACTIVE, P_DIR_TARGET, P_DIR_FRAME, P_DIR_WEIGHT,
  P_LA_ACTIVE, P_RT_ACTIVE, P_JR_ACTIVE, P_POSE_ACTIVE,
  P_TRAJ_ACTIVE, P_TRAJ_NODE, P_TRAJ_MIN_ARC, P_TRAJ_WEIGHT,
  P_TRAJ_RANGE_START, P_TRAJ_RANGE_END,
  P_TR_POINTS, P_TR_N_POINTS, P_TR_TABLE_U, P_TR_TABLE_ARC,
  P_TR_TABLE_POINTS, P_TR_UNCONSTRAINED,
  P_HAS_PREV, P_PREV_LAST, P_START_Q, P_START_DELTA, P_N_CANONICAL,
  P_S0, P_S_OUT, P_ERR_OUT, N_PTRS
};
// The int and float arguments, in the wrapper's order.
enum Int {
  I_C, I_L, I_KS, I_NB, I_ND, I_NKNOTS, I_NNODES, I_NCOMP, I_G1, I_ITERS,
  I_USE_DIR, I_USE_TRAJ, I_HAS_TRAJ, I_ROOT_ONLY, I_EMAX, I_PREC_S0,
  I_PREC_S1, I_PREC_S2, N_INTS
};
enum Flt { F_ES, F_QS, F_LAM0, F_DAMP, N_FLTS };

struct Params {
  const void* ptr[N_PTRS];
  int c, L, ks, nb, nd, nknots, nnodes, ncomp, g1, iters, use_dir,
      use_traj, has_traj, root_only, e_max;
  int prec_s[3];  // element strides of the precision factors [K, L, L]
  float es, qs, lam0, damp;
};

template <typename T>
__device__ __forceinline__ const T* arg(const Params& p, int i) {
  return static_cast<const T*>(p.ptr[i]);
}
__device__ __forceinline__ float* out(const Params& p, int i) {
  return static_cast<float*>(const_cast<void*>(p.ptr[i]));
}

// Dynamic shared memory, in floats: the path table as float4 rows first
// (16-byte aligned), then the folded operator, its entries' rows and
// channels, the basis rows, the mixture and one region per warp.
struct Layout {
  int table, mop, ent_row, ent_ch, basis, bsum, prec, mu, logw, warps,
      warp_floats;
  size_t bytes;
};

__host__ __device__ inline Layout make_layout(int e_max, int ks, int nb,
                                              int g1, int ncomp, int L) {
  Layout l;
  int o = 0;
  l.table = o;
  o += 4 * g1;
  l.mop = o;
  o += e_max * (ks + 1);
  l.ent_row = o;
  o += e_max;
  l.ent_ch = o;
  o += e_max;
  l.basis = o;
  o += MAX_ROWS * nb;
  l.bsum = o;
  o += MAX_ROWS;
  l.prec = o;
  o += ncomp * L * (L | 1);
  l.mu = o;
  o += ncomp * L;
  l.logw = o;
  o += ncomp;
  // raw[e_max] | s[32] | s_new[32] | family values | residuals | J [32][32]
  l.warp_floats = e_max + 64 + 2 * MAX_SLOTS + MAX_SLOTS * 32;
  l.warps = o;
  o += NW * l.warp_floats;
  l.bytes = (size_t)o * sizeof(float);
  return l;
}

// What the block keeps besides the dynamic arrays: the skeleton, the query
// rows, the active residual slots and the set's constants.
struct Block {
  int parents[MAX_NODES], anim[MAX_NODES];
  float off[MAX_NODES][3], rest[MAX_NODES][4];
  int row_on[MAX_ROWS], row_base[MAX_ROWS], row_n[MAX_ROWS],
      row_ori[MAX_ROWS];
  int row_chain[MAX_ROWS][MAX_DEPTH];
  float row_t[MAX_ROWS];
  int n_ent, n_slots;
  int slot_of[N_RES], slot_res[MAX_SLOTS];
  float slot_act[MAX_SLOTS];
  float kf_pos[MAX_KF][3], kf_mask[MAX_KF][3], kf_quat[MAX_KF][4],
      kf_hq[MAX_KF], kf_aw[MAX_KF];
  float dir_t[2], dir_aw;
  float tr_aw, tr_min_arc, tr_lo, tr_hi, tr_mask[3];
  int tr_np;
  int has_prev;
  float prev_pos[3], prev_heading, start_q[4], start_delta[3];
  float red_v[2][NW];
  int red_i[2][NW];
  int cand[TRAJ];
};

// ---------------------------------------------------------------------------
// Numbers: Dual carries the primal and one tangent, with torch's
// forward-mode rules; Real the primal alone (the value-only evaluations)
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
};
struct Real {
  float v;
};

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.d + b.d};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.d - b.d};
}
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
__device__ __forceinline__ Dual operator*(float a, Dual b) {
  return {a * b.v, a * b.d};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float r = a.v / b.v;
  return {r, (a.d - b.d * r) / b.v};
}
__device__ __forceinline__ Real operator+(Real a, Real b) {
  return {a.v + b.v};
}
__device__ __forceinline__ Real operator-(Real a, Real b) {
  return {a.v - b.v};
}
__device__ __forceinline__ Real operator*(Real a, Real b) {
  return {a.v * b.v};
}
__device__ __forceinline__ Real operator*(float a, Real b) {
  return {a * b.v};
}
__device__ __forceinline__ Real operator/(Real a, Real b) {
  return {a.v / b.v};
}

// a constant, and a value with the tangent t (dropped by Real)
template <class N>
__device__ __forceinline__ N num(float v, float t = 0.f);
template <>
__device__ __forceinline__ Dual num<Dual>(float v, float t) {
  return {v, t};
}
template <>
__device__ __forceinline__ Real num<Real>(float v, float) {
  return {v};
}
__device__ __forceinline__ float tan_of(Dual a) { return a.d; }
__device__ __forceinline__ float tan_of(Real) { return 0.f; }
// a function of a with the value fv and the derivative df
__device__ __forceinline__ Dual chain(Dual a, float fv, float df) {
  return {fv, df * a.d};
}
__device__ __forceinline__ Real chain(Real, float fv, float) { return {fv}; }

template <class N>
__device__ __forceinline__ N dsqrt(N a) {
  const float r = sqrtf(a.v);
  return chain(a, r, 1.f / (2.f * r));
}
template <class N>
__device__ __forceinline__ N dacos(N a) {
  return chain(a, acosf(a.v), -rsqrtf(1.f - a.v * a.v));
}
__device__ __forceinline__ Dual datan2(Dual y, Dual x) {
  return {atan2f(y.v, x.v), (x.v * y.d - y.v * x.d) / (x.v * x.v + y.v * y.v)};
}
__device__ __forceinline__ Real datan2(Real y, Real x) {
  return {atan2f(y.v, x.v)};
}
template <class N>
__device__ __forceinline__ N dcos(N a) {
  return chain(a, cosf(a.v), -sinf(a.v));
}
template <class N>
__device__ __forceinline__ N dsin(N a) {
  return chain(a, sinf(a.v), cosf(a.v));
}
template <class N>
__device__ __forceinline__ N dabs(N a) {
  return chain(a, fabsf(a.v), a.v > 0.f ? 1.f : (a.v < 0.f ? -1.f : 0.f));
}
template <class N>
__device__ __forceinline__ N dclamp(N a, float lo, float hi) {
  return chain(a, fminf(fmaxf(a.v, lo), hi),
               (a.v >= lo && a.v <= hi) ? 1.f : 0.f);
}
template <class N>
__device__ __forceinline__ N dclamp_min(N a, float lo) {
  return chain(a, fmaxf(a.v, lo), a.v >= lo ? 1.f : 0.f);
}
// torch.maximum(a, b) for a constant b
template <class N>
__device__ __forceinline__ N dmax_const(N a, float b) {
  return chain(a, fmaxf(a.v, b), a.v > b ? 1.f : (a.v == b ? 0.5f : 0.f));
}
// sqrt(x) of a squared norm x, no tangent at 0 (linalg.vector_norm)
template <class N>
__device__ __forceinline__ N dnorm(N x) {
  const float n = sqrtf(x.v);
  return chain(x, n, n == 0.f ? 0.f : 0.5f / n);
}

template <class N>
struct V3 {
  N x, y, z;
};
template <class N>
struct V4 {
  N w, x, y, z;
};

// the values of a vector, tangents dropped
template <class N>
__device__ __forceinline__ V3<Real> c3q(V3<N> v) {
  return {Real{v.x.v}, Real{v.y.v}, Real{v.z.v}};
}
template <class N>
__device__ __forceinline__ V4<Real> c4q(V4<N> q) {
  return {Real{q.w.v}, Real{q.x.v}, Real{q.y.v}, Real{q.z.v}};
}

template <class N>
__device__ __forceinline__ V3<N> c3(float x, float y, float z) {
  return {num<N>(x), num<N>(y), num<N>(z)};
}
template <class N>
__device__ __forceinline__ V4<N> c4(const float* q) {
  return {num<N>(q[0]), num<N>(q[1]), num<N>(q[2]), num<N>(q[3])};
}
template <class N>
__device__ __forceinline__ V3<N> add3(V3<N> a, V3<N> b) {
  return {a.x + b.x, a.y + b.y, a.z + b.z};
}
template <class N>
__device__ __forceinline__ V3<N> cross(V3<N> a, V3<N> b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
// quat.rotate_vec: v + 2 (w (u x v) + u x (u x v))
template <class N>
__device__ __forceinline__ V3<N> rotate(V4<N> q, V3<N> v) {
  const V3<N> u = {q.x, q.y, q.z};
  const V3<N> uv = cross(u, v);
  const V3<N> uuv = cross(u, uv);
  return {v.x + 2.f * (q.w * uv.x + uuv.x), v.y + 2.f * (q.w * uv.y + uuv.y),
          v.z + 2.f * (q.w * uv.z + uuv.z)};
}
// quat.multiply (Hamilton, w first)
template <class N>
__device__ __forceinline__ V4<N> qmul(V4<N> a, V4<N> b) {
  return {a.w * b.w - a.x * b.x - a.y * b.y - a.z * b.z,
          a.w * b.x + a.x * b.w + a.y * b.z - a.z * b.y,
          a.w * b.y - a.x * b.z + a.y * b.w + a.z * b.x,
          a.w * b.z + a.x * b.y - a.y * b.x + a.z * b.w};
}
// quat.normalize: q / max(|q|, 1e-12)
template <class N>
__device__ __forceinline__ V4<N> normalize4(V4<N> q) {
  const N n = dclamp_min(dnorm(q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z),
                         1e-12f);
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}
// align.heading_angle: atan2 of the +z axis' ground-plane heading
template <class N>
__device__ __forceinline__ N heading(V4<N> q) {
  const V3<N> v = rotate(normalize4(q), c3<N>(0.f, 0.f, 1.f));
  return datan2(v.x, v.z);
}

// ---------------------------------------------------------------------------
// Block-wide reductions over the path table (every thread calls them with
// the same arguments; two buffers alternate, one barrier a call)
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool better(float ov, int oi, float bv, int bi,
                                       int none) {
  return oi != none && (bi == none || ov < bv || (ov == bv && oi < bi));
}

// The first minimum of the squared distances to p (masked) over the table
// entries g = first, first + stride, ... whose arc is at least lo - 1e-6,
// reduced over the warp into lane 0: (value, index), index g1 for none.
__device__ void warp_argmin(const float4* tbl, int g1, int first, int stride,
                            float px, float py, float pz, float lo, float& bv,
                            int& bi) {
  const float thr = lo - 1e-6f;
  bv = 0.f;
  bi = g1;  // none yet
  for (int g = first; g < g1; g += stride) {
    const float4 t = tbl[g];
    if (t.w >= thr) {
      const float dx = t.x - px, dy = t.y - py, dz = t.z - pz;
      const float v = dx * dx + dy * dy + dz * dz;
      if (bi == g1 || v < bv) {
        bv = v;
        bi = g;
      }
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_down_sync(FULL, bv, o);
    const int oi = __shfl_down_sync(FULL, bi, o);
    if (better(ov, oi, bv, bi, g1)) {
      bv = ov;
      bi = oi;
    }
  }
}

// torch.argmin over the table of the squared distances to p (masked), the
// entries whose arc is below lo - 1e-6 left out: the first minimum, or
// g1 - 1 when no entry is left.
__device__ int block_argmin(const float4* tbl, int g1, float px, float py,
                            float pz, float lo, Block& b, int& par) {
  float bv;
  int bi;
  warp_argmin(tbl, g1, threadIdx.x, NT, px, py, pz, lo, bv, bi);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    b.red_v[par][warp] = bv;
    b.red_i[par][warp] = bi;
  }
  __syncthreads();
  float rv = b.red_v[par][0];
  int ri = b.red_i[par][0];
  for (int w = 1; w < NW; ++w)
    if (better(b.red_v[par][w], b.red_i[par][w], rv, ri, g1)) {
      rv = b.red_v[par][w];
      ri = b.red_i[par][w];
    }
  par ^= 1;
  return ri == g1 ? g1 - 1 : ri;
}

// The number of table arcs <= x.
__device__ int block_count_le(const float4* tbl, int g1, float x, Block& b,
                              int& par) {
  int n = 0;
  for (int g = threadIdx.x; g < g1; g += NT) n += tbl[g].w <= x ? 1 : 0;
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
  if (threadIdx.x % 32 == 0) b.red_i[par][threadIdx.x / 32] = n;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < NW; ++w) total += b.red_i[par][w];
  par ^= 1;
  return total;
}

// ---------------------------------------------------------------------------
// One evaluation of the residuals at a latent, every lane its own tangent
// ---------------------------------------------------------------------------

enum Mode { JAC, PROBE, FINAL };

// the jacobian pass carries a tangent a lane, the others the values alone
template <int MODE>
struct NumOf {
  using T = Real;
};
template <>
struct NumOf<JAC> {
  using T = Dual;
};

struct Warp {
  float *raw, *s, *s_new, *fv, *rv, *jac;
};

struct Eval {
  const Params& p;
  Block& b;
  const float* mop;
  const float* bsum;
  const float4* tbl;
  const float *prec, *mu, *logw;
  Warp w;
  int lane;
  int& par;

  // channel entry e of the step's query rows: the primal and lane's tangent
  template <class N>
  __device__ N ent(int e) const {
    return num<N>(w.raw[e], lane < p.ks ? mop[e * (p.ks + 1) + lane] : 0.f);
  }
  template <class N>
  __device__ V4<N> ent4(int e) const {
    return {ent<N>(e), ent<N>(e + 1), ent<N>(e + 2), ent<N>(e + 3)};
  }

  // the local rotation of chain node nd at the row whose next quaternion
  // entry is e: animated joint 0's block is the aligned one
  template <class N>
  __device__ V4<N> local(int nd, int& e, V4<N> qy) const {
    const int a = b.anim[nd];
    if (a < 0) return c4<N>(b.rest[nd]);
    const V4<N> r = ent4<N>(e);
    e += 4;
    return a == 0 ? qmul(qy, r) : r;
  }

  // FK through row q's chain: the last node's position and, where the row
  // reads it, its orientation (fk_global's per-node arithmetic)
  template <class N>
  __device__ void fk(int q, V4<N> qy, V3<N> dl, V3<N>& pos, V4<N>& ori) const {
    int e = b.row_base[q];
    const float bs = bsum[q];
    const V3<N> ap = add3(
        rotate(qy, V3<N>{ent<N>(e), ent<N>(e + 1), ent<N>(e + 2)}),
        V3<N>{bs * dl.x, bs * dl.y, bs * dl.z});
    e += 3;
    const int n = b.row_n[q];
    const bool need_ori = b.row_ori[q];
    const int* chain = b.row_chain[q];
    int nd = chain[0];
    pos = add3(c3<N>(b.off[nd][0], b.off[nd][1], b.off[nd][2]), ap);
    V4<N> o = c4<N>(b.rest[nd]);
    if (n > 1 || need_ori) o = local(nd, e, qy);
    for (int d = 1; d < n; ++d) {
      nd = chain[d];
      pos = add3(pos, rotate(o, c3<N>(b.off[nd][0], b.off[nd][1],
                                      b.off[nd][2])));
      if (d < n - 1 || need_ori) o = qmul(o, local(nd, e, qy));
    }
    ori = o;
  }

  template <class N>
  __device__ void put(int n, N v) const {
    if (lane == 0) w.fv[n] = v.v;
    w.jac[n * 32 + lane] = tan_of(v);
  }

  // -log p and lane's gradient component (B5's arithmetic)
  __device__ void mixture(const float* x_sm, float& nll, float& gl) const {
    const int L = p.L, sL = L | 1;
    const bool on[1] = {lane < L};
    const float x = on[0] ? x_sm[lane] : 0.f;
    float mx = -__int_as_float(0x7f800000), se = 0.f, gacc[1] = {0.f};
    for (int k = 0; k < p.ncomp; ++k) {
      const float* P = prec + (size_t)k * L * sL;
      const float diff[1] = {on[0] ? x - mu[k * L + lane] : 0.f};
      float y[1];
      const float part = mg::gmm_y_pass<1>(diff, P, L, sL, on, lane, y);
      const float lp = mg::gmm_component_lp(mg::warp_sum(part), L, logw[k]);
      float keep, wk;
      mg::gmm_lse_step(lp, mx, se, keep, wk);
      mg::gmm_grad_pass<1>(P, L, sL, on, y, lane, keep, wk, gacc);
    }
    nll = -(mx + logf(se));
    gl = on[0] ? gacc[0] / se : 0.f;
  }

  // spline_path._arc_at_u
  template <class N>
  __device__ N arc_at_u(N u) const {
    const int g = p.g1 - 1;
    const N pos = (float)g * dclamp(u, 0.f, 1.f);
    const int i = min(max((int)floorf(pos.v), 0), g - 1);
    const N frac = pos - num<N>((float)i);
    return tbl[i].w * (num<N>(1.f) - frac) + tbl[i + 1].w * frac;
  }

  // spline_path.u_at_arc_length (_interp_monotone over the table)
  template <class N>
  __device__ N u_at_arc(N x) const {
    const int n = p.g1;
    const float* tu = arg<float>(p, P_TR_TABLE_U);
    const int cnt = block_count_le(tbl, n, x.v, b, par);
    const int i = min(max(cnt - 1, 0), n - 2);
    const float x0 = tbl[i].w, x1 = tbl[i + 1].w, y0 = tu[i], y1 = tu[i + 1];
    const N t = dclamp((x - num<N>(x0)) / num<N>(fmaxf(x1 - x0, 1e-8f)), 0.f,
                       1.f);
    N out = num<N>(y0) + (y1 - y0) * t;
    if (x.v <= tbl[0].w) out = num<N>(tu[0]);
    if (x.v >= tbl[n - 1].w) out = num<N>(tu[n - 1]);
    return out;
  }

  // spline_path._eval_u: the Catmull-Rom point at u
  template <class N>
  __device__ V3<N> eval_u(N u) const {
    const float* pts = arg<float>(p, P_TR_POINTS);
    const int np = b.tr_np;
    const float nseg = (float)max(np - 1, 1);
    const N sc = nseg * dclamp(u, 0.f, 1.f);
    const int idx = min(max((int)floorf(sc.v), 0), np - 2);
    const N l1 = sc - num<N>((float)idx);
    const N l2 = chain(l1, l1.v * l1.v, 2.f * l1.v);
    const N l3 = chain(l1, l1.v * l1.v * l1.v, 3.f * l1.v * l1.v);
    const float CR[4][4] = {{-1.f, 3.f, -3.f, 1.f},
                            {2.f, -5.f, 4.f, -1.f},
                            {-1.f, 0.f, 1.f, 0.f},
                            {0.f, 2.f, 0.f, 0.f}};
    const N wv[4] = {l3, l2, l1, num<N>(1.f)};
    N out[3] = {num<N>(0.f), num<N>(0.f), num<N>(0.f)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      N cj = CR[0][j] * wv[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) cj = cj + CR[i][j] * wv[i];
      const float* pj = pts + 3 * (idx + j);
#pragma unroll
      for (int k = 0; k < 3; ++k) out[k] = out[k] + pj[k] * cj;
    }
    return {0.5f * out[0], 0.5f * out[1], 0.5f * out[2]};
  }

  template <int MODE>
  __device__ float run(const float* s_sm) {
    using N = typename NumOf<MODE>::T;
    const int ks = p.ks, ks1 = ks + 1, E = b.n_ent;
    for (int e = lane; e < E; e += 32) {
      const float* m = mop + e * ks1;
      float acc = 0.f;
      for (int k = 0; k < ks; ++k) acc = fmaf(m[k], s_sm[k], acc);
      w.raw[e] = acc + m[ks];
    }
    if (MODE == JAC)
      for (int n = 0; n < b.n_slots; ++n) w.jac[n * 32 + lane] = 0.f;
    if (lane == 0)
      for (int n = 0; n < b.n_slots; ++n) w.fv[n] = 0.f;
    __syncwarp();

    float nll = 0.f, gl = 0.f;
    if (MODE != FINAL) mixture(s_sm, nll, gl);

    // the step's aligning transform from the candidate's first frame
    V4<N> qy;
    V3<N> dl;
    if (b.has_prev) {
      const N half = 0.5f * (num<N>(b.prev_heading) - heading(ent4<N>(3)));
      qy = {dcos(half), num<N>(0.f), dsin(half), num<N>(0.f)};
      const V3<N> r = rotate(qy, V3<N>{ent<N>(0), ent<N>(1), ent<N>(2)});
      dl = {num<N>(b.prev_pos[0]) - r.x, num<N>(0.f),
            num<N>(b.prev_pos[2]) - r.z};
    } else {
      qy = c4<N>(b.start_q);
      dl = c3<N>(b.start_delta[0], b.start_delta[1], b.start_delta[2]);
    }

    // keyframes
    for (int i = 0; i < MAX_KF; ++i) {
      const int n = b.slot_of[i];
      if (n < 0) continue;
      V3<N> jp;
      V4<N> jo;
      fk(ROW_KF + i, qy, dl, jp, jo);
      const N dx = b.kf_mask[i][0] * (jp.x - num<N>(b.kf_pos[i][0]));
      const N dy = b.kf_mask[i][1] * (jp.y - num<N>(b.kf_pos[i][1]));
      const N dz = b.kf_mask[i][2] * (jp.z - num<N>(b.kf_pos[i][2]));
      const N pos_err = dsqrt(dclamp_min(dx * dx + dy * dy + dz * dz, 1e-12f));
      const V4<N> qn = normalize4(jo);
      const N dot = dabs(b.kf_quat[i][0] * qn.w + b.kf_quat[i][1] * qn.x +
                         b.kf_quat[i][2] * qn.y + b.kf_quat[i][3] * qn.z);
      const N ang = 2.f * dacos(dclamp(dot, -ONE_M, ONE_M));
      put(n, b.kf_aw[i] * (pos_err + b.kf_hq[i] * ang));
    }

    // the direction: joint 0's aligned quaternion channels at its row
    if (p.use_dir && b.slot_of[R_DIR] >= 0) {
      const V4<N> q = qmul(qy, ent4<N>(b.row_base[ROW_DIR]));
      const V3<N> h = rotate(normalize4(q), c3<N>(0.f, 0.f, 1.f));
      const N c = dclamp_min(dnorm(h.x * h.x + h.z * h.z), 1e-10f);
      const N cos_a = dclamp(b.dir_t[0] * (h.x / c) + b.dir_t[1] * (h.z / c),
                             -1.f, 1.f);
      put(b.slot_of[R_DIR], b.dir_aw * (RAD2DEG * dacos(cos_a)));
    }

    // the trajectory: the advancing closest points of the 16 samples.
    // Sample j searches the entries at or past floor_j, the arc sample
    // j - 1 chose, and floor_j only grows: so each sample's first minimum
    // over the entries past the step's first floor (warp w searches the
    // samples j = w mod NW, all at once) is its answer wherever it lies
    // past floor_j, and only a sample whose minimum fell behind its floor
    // searches again, over the block
    if (p.has_traj && b.slot_of[R_TRAJ] >= 0) {
      const int g = p.g1 - 1;
      const int warp = threadIdx.x / 32;
      __syncthreads();  // every warp has read the last evaluation's cand
      for (int j = warp; j < TRAJ; j += NW) {
        V3<Real> pp;
        V4<Real> unused;
        fk(ROW_LIN + j, c4q(qy), c3q(dl), pp, unused);
        float bv;
        int bi;
        warp_argmin(tbl, p.g1, lane, 32, b.tr_mask[0] * pp.x.v,
                    b.tr_mask[1] * pp.y.v, b.tr_mask[2] * pp.z.v,
                    b.tr_min_arc, bv, bi);
        if (lane == 0) b.cand[j] = bi;
      }
      __syncthreads();
      float floor_arc = b.tr_min_arc;
      for (int j = 0; j < TRAJ; ++j) {
        V3<N> pp;
        V4<N> unused;
        fk(ROW_LIN + j, qy, dl, pp, unused);
        const V3<N> pm = {b.tr_mask[0] * pp.x, b.tr_mask[1] * pp.y,
                          b.tr_mask[2] * pp.z};
        int i = b.cand[j];
        if (i == p.g1)
          i = g;  // no entry past the first floor, none past floor_j
        else if (tbl[i].w < floor_arc - 1e-6f)
          i = block_argmin(tbl, p.g1, pm.x.v, pm.y.v, pm.z.v, floor_arc, b,
                           par);
        const float fl = floor_arc;
        floor_arc = fmaxf(floor_arc, tbl[i].w);
        auto d2 = [&](int k) {
          const float4 t = tbl[k];
          const N ex = num<N>(t.x) - pm.x, ey = num<N>(t.y) - pm.y,
                  ez = num<N>(t.z) - pm.z;
          return ex * ex + ey * ey + ez * ez;
        };
        const N dm1 = d2(max(i - 1, 0)), d0 = d2(i), dp1 = d2(min(i + 1, g));
        const N denom = dm1 - 2.f * d0 + dp1;
        N off = num<N>(0.f);
        if (denom.v > 1e-12f)
          off = dclamp(0.5f * (dm1 - dp1) / dclamp_min(denom, 1e-12f), -1.f,
                       1.f);
        N ub = dclamp((num<N>((float)i) + off) / num<N>((float)g), 0.f, 1.f);
        const N arc = arc_at_u(ub);
        const bool clamped = arc.v < fl;
        const N arcm = dmax_const(arc, fl);
        if (clamped) ub = u_at_arc(arcm);
        const V3<N> pos = eval_u(ub);
        const N ex = b.tr_mask[0] * (pos.x - pp.x),
                ey = b.tr_mask[1] * (pos.y - pp.y),
                ez = b.tr_mask[2] * (pos.z - pp.z);
        const N dist = dsqrt(ex * ex + ey * ey + ez * ez);
        const bool in_range = arcm.v >= b.tr_lo && arcm.v <= b.tr_hi;
        put(b.slot_of[R_TRAJ + j],
            b.tr_aw * (in_range ? dist : num<N>(0.f)));
      }
    }
    __syncwarp();

    if (MODE == FINAL) {  // error_from_residuals of the raw residuals
      float base = 0.f, traj = 0.f;
      bool traj_on = false;
      for (int n = 0; n < b.n_slots; ++n) {
        const float v = w.fv[n];
        if (b.slot_res[n] < R_TRAJ) {
          base += v;
        } else {
          traj += v;
          traj_on |= v > 0.f;
        }
      }
      return traj_on ? base + traj / (float)TRAJ : base;
    }
    float err = 0.f;
    for (int n = 0; n < b.n_slots; ++n) {
      const float act = b.slot_act[n];
      const float r = act * (p.es * w.fv[n] + p.qs * nll);
      err = fmaf(r, r, err);
      if (MODE == JAC) {
        float* jn = w.jac + n * 32 + lane;
        *jn = act * (p.es * *jn + p.qs * gl);
      }
    }
    __syncwarp();
    if (MODE == JAC && lane == 0)
      for (int n = 0; n < b.n_slots; ++n)
        w.rv[n] = b.slot_act[n] * (p.es * w.fv[n] + p.qs * nll);
    __syncwarp();
    return err;
  }
};

// ---------------------------------------------------------------------------
// Set-up: what the iterations read, once a launch
// ---------------------------------------------------------------------------

// bspline.basis_matrix at one time (Cox-de Boor over the clamped knots)
__device__ void basis_row(const float* kn, int nknots, float t, float* out,
                          int nb) {
  float n[64];
  const float tmax = kn[nknots - 1];
  const float tc = fminf(fmaxf(t, kn[0]), tmax);
  for (int j = 0; j + 1 < nknots; ++j) {
    const float left = kn[j], right = kn[j + 1];
    const bool on = right >= tmax ? (tc >= left && tc <= right && left < right)
                                  : (tc >= left && tc < right);
    n[j] = on ? 1.f : 0.f;
  }
  for (int k = 1; k <= 3; ++k)
    for (int j = 0; j + k + 1 < nknots; ++j) {
      const float d1 = kn[j + k] - kn[j], d2 = kn[j + k + 1] - kn[j + 1];
      const float w1 = d1 > 0.f ? (tc - kn[j]) / d1 : 0.f;
      const float w2 = d2 > 0.f ? (kn[j + k + 1] - tc) / d2 : 0.f;
      n[j] = w1 * n[j] + w2 * n[j + 1];
    }
  for (int j = 0; j < nb; ++j) out[j] = n[j];
}


// A set the kernel cannot evaluate stops the launch with a device fault,
// as PyTorch's own index checks on the card do: the next synchronising call
// raises it.  The wrapper sizes e_max from the skeleton's widest chain and
// its dispatch refuses a chain deeper than MAX_DEPTH (mg_request_lm_check),
// so of a set it launches, only a node index out of range can reach it.
__device__ void fault(const char* what) {
  printf("request_lm: %s\n", what);
  __trap();
}

// thread 0: the query rows with their chains and channel entries, the
// active residual slots and the set's constants
__device__ void plan(const Params& p, Block& b, int* ent_row, int* ent_ch) {
  const float* kf_active = arg<float>(p, P_KF_ACTIVE);
  const long long* kf_node = arg<long long>(p, P_KF_NODE);
  const float* kf_frame = arg<float>(p, P_KF_FRAME);
  for (int q = 0; q < MAX_ROWS; ++q) b.row_on[q] = 0;
  // rows: (node, need_ori, time)
  auto row = [&](int q, int node, int need_ori, float t) {
    b.row_on[q] = 1;
    b.row_ori[q] = need_ori;
    b.row_t[q] = t;
    if (node < 0 || node >= p.nnodes) fault("a node index out of range");
    int tmp[MAX_DEPTH], n = 0, x = node;
    for (; x >= 0 && n < MAX_DEPTH; x = b.parents[x]) tmp[n++] = x;
    if (x >= 0) fault("an ancestor chain deeper than MAX_DEPTH");
    b.row_n[q] = n;
    for (int d = 0; d < n; ++d) b.row_chain[q][d] = tmp[n - 1 - d];
  };
  row(ROW_FIRST, 0, 1, 0.f);
  if (p.use_dir) row(ROW_DIR, 0, 1, *arg<float>(p, P_DIR_FRAME));
  for (int i = 0; i < MAX_KF; ++i)
    if (kf_active[i] != 0.f)
      row(ROW_KF + i, p.root_only ? 0 : (int)kf_node[i], 1, kf_frame[i]);
  if (p.has_traj) {
    const float span = fmaxf(*arg<float>(p, P_N_CANONICAL) - 1.f, 1.f);
    const int tn = p.root_only ? 0 : (int)*arg<long long>(p, P_TRAJ_NODE);
    for (int j = 0; j < TRAJ; ++j) {
      // torch.linspace(0, 1, 16): from the start below the middle, from
      // the end above it
      const float step = 1.f / (float)(TRAJ - 1);
      const float lin = j < TRAJ / 2 ? step * (float)j
                                     : 1.f - step * (float)(TRAJ - 1 - j);
      row(ROW_LIN + j, tn, 0, lin * span);
    }
  }
  // channel entries, in the order fk reads them
  int e = 0;
  auto entry = [&](int q, int ch) {
    if (e >= p.e_max) fault("more channel entries than e_max");
    ent_row[e] = q;
    ent_ch[e] = ch;
    ++e;
  };
  for (int q = 0; q < MAX_ROWS; ++q) {
    if (!b.row_on[q]) continue;
    b.row_base[q] = e;
    if (q == ROW_FIRST) {
      for (int ch = 0; ch < 7; ++ch) entry(q, ch);
    } else if (q == ROW_DIR) {
      for (int ch = 3; ch < 7; ++ch) entry(q, ch);
    } else {
      for (int ch = 0; ch < 3; ++ch) entry(q, ch);
      const int n = b.row_n[q];
      for (int d = 0; d < n; ++d) {
        const int a = b.anim[b.row_chain[q][d]];
        if (a >= 0 && (d < n - 1 || b.row_ori[q]))
          for (int k = 0; k < 4; ++k) entry(q, 3 + 4 * a + k);
      }
    }
  }
  b.n_ent = e;

  // active slots: compiled.active_mask times the family gate (collision
  // avoidance and the trajectory set are gated off on this path)
  const float tr_act = *arg<float>(p, P_TRAJ_ACTIVE);
  int n = 0;
  for (int r = 0; r < N_RES; ++r) {
    float act = 0.f;
    if (r < MAX_KF) act = kf_active[r];
    else if (r == R_DIR) act = *arg<float>(p, P_DIR_ACTIVE);
    else if (r == R_LA) act = *arg<float>(p, P_LA_ACTIVE);
    else if (r == R_RT) act = *arg<float>(p, P_RT_ACTIVE);
    else if (r == R_JR) act = *arg<float>(p, P_JR_ACTIVE);
    else if (r == R_POSE) act = *arg<float>(p, P_POSE_ACTIVE);
    else if (r >= R_TRAJ && r < R_TRAJ + TRAJ)
      act = p.use_traj ? tr_act : 0.f;
    b.slot_of[r] = -1;
    if (act != 0.f && n < MAX_SLOTS) {
      b.slot_of[r] = n;
      b.slot_res[n] = r;
      b.slot_act[n] = act;
      ++n;
    }
  }
  b.n_slots = n;

  const float* kf_pos = arg<float>(p, P_KF_POS);
  const float* kf_mask = arg<float>(p, P_KF_POS_MASK);
  const float* kf_quat = arg<float>(p, P_KF_QUAT);
  const float* kf_hq = arg<float>(p, P_KF_HAS_QUAT);
  const float* kf_w = arg<float>(p, P_KF_WEIGHT);
  for (int i = 0; i < MAX_KF; ++i) {
    for (int k = 0; k < 3; ++k) {
      b.kf_pos[i][k] = kf_pos[3 * i + k];
      b.kf_mask[i][k] = kf_mask[3 * i + k];
    }
    for (int k = 0; k < 4; ++k) b.kf_quat[i][k] = kf_quat[4 * i + k];
    b.kf_hq[i] = kf_hq[i];
    b.kf_aw[i] = kf_active[i] * kf_w[i];
  }
  const float* dt = arg<float>(p, P_DIR_TARGET);
  b.dir_t[0] = dt[0];
  b.dir_t[1] = dt[1];
  b.dir_aw = *arg<float>(p, P_DIR_ACTIVE) * *arg<float>(p, P_DIR_WEIGHT);
  b.tr_aw = tr_act * *arg<float>(p, P_TRAJ_WEIGHT);
  b.tr_min_arc = *arg<float>(p, P_TRAJ_MIN_ARC);
  b.tr_lo = *arg<float>(p, P_TRAJ_RANGE_START);
  b.tr_hi = *arg<float>(p, P_TRAJ_RANGE_END);
  if (p.has_traj) {
    const bool* unc = arg<bool>(p, P_TR_UNCONSTRAINED);
    for (int k = 0; k < 3; ++k) b.tr_mask[k] = unc[k] ? 0.f : 1.f;
    b.tr_np = *arg<int>(p, P_TR_N_POINTS);
  } else {
    for (int k = 0; k < 3; ++k) b.tr_mask[k] = 1.f;
    b.tr_np = 2;
  }
  b.has_prev = *arg<float>(p, P_HAS_PREV) > 0.f;
  const float* prev = arg<float>(p, P_PREV_LAST);
  for (int k = 0; k < 3; ++k) b.prev_pos[k] = prev[k];
  b.prev_heading = heading(c4<Real>(prev + 3)).v;
  const float* sq = arg<float>(p, P_START_Q);
  const float* sd = arg<float>(p, P_START_DELTA);
  for (int k = 0; k < 4; ++k) b.start_q[k] = sq[k];
  for (int k = 0; k < 3; ++k) b.start_delta[k] = sd[k];
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <int KW>
__global__ void __launch_bounds__(NT) request_lm_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ Block b;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x;
  const Layout lay = make_layout(p.e_max, p.ks, p.nb, p.g1, p.ncomp, p.L);
  int* ent_row = reinterpret_cast<int*>(smem + lay.ent_row);
  int* ent_ch = reinterpret_cast<int*>(smem + lay.ent_ch);
  float* basis = smem + lay.basis;
  float* bsum = smem + lay.bsum;
  float* mop = smem + lay.mop;
  float4* tbl = reinterpret_cast<float4*>(smem + lay.table);
  float* prec = smem + lay.prec;
  float* mu = smem + lay.mu;
  float* logw = smem + lay.logw;

  // the skeleton, then the plan
  for (int i = tid; i < p.nnodes; i += NT) {
    b.parents[i] = arg<int>(p, P_PARENTS)[i];
    b.anim[i] = arg<int>(p, P_ANIM)[i];
    for (int k = 0; k < 3; ++k)
      b.off[i][k] = arg<float>(p, P_OFFSETS)[3 * i + k];
    for (int k = 0; k < 4; ++k)
      b.rest[i][k] = arg<float>(p, P_REST)[4 * i + k];
  }
  __syncthreads();
  if (tid == 0) plan(p, b, ent_row, ent_ch);
  // the path table (points masked as the distances mask them), the mixture
  if (p.has_traj) {
    const float* tp = arg<float>(p, P_TR_TABLE_POINTS);
    const float* ta = arg<float>(p, P_TR_TABLE_ARC);
    const bool* unc = arg<bool>(p, P_TR_UNCONSTRAINED);
    const float m0 = unc[0] ? 0.f : 1.f, m1 = unc[1] ? 0.f : 1.f,
                m2 = unc[2] ? 0.f : 1.f;
    for (int g = tid; g < p.g1; g += NT)
      tbl[g] = make_float4(tp[3 * g] * m0, tp[3 * g + 1] * m1,
                           tp[3 * g + 2] * m2, ta[g]);
  }
  const int L = p.L, sL = L | 1;
  for (int i = tid; i < p.ncomp * L * L; i += NT) {
    const int k = i / (L * L), r = (i / L) % L, col = i % L;
    prec[(size_t)k * L * sL + r * sL + col] = arg<float>(p, P_GMM_PREC)[
        (size_t)k * p.prec_s[0] + (size_t)r * p.prec_s[1] +
        (size_t)col * p.prec_s[2]];
  }
  for (int i = tid; i < p.ncomp * L; i += NT)
    mu[i] = arg<float>(p, P_GMM_MU)[i];
  for (int k = tid; k < p.ncomp; k += NT)
    logw[k] = logf(fmaxf(arg<float>(p, P_GMM_W)[k], 1e-30f));
  __syncthreads();

  // the basis rows (the first coefficient row is coefficient 0 itself)
  if (tid < MAX_ROWS && b.row_on[tid]) {
    float* out = basis + tid * p.nb;
    if (tid == ROW_FIRST) {
      for (int j = 0; j < p.nb; ++j) out[j] = j == 0 ? 1.f : 0.f;
    } else {
      basis_row(arg<float>(p, P_KNOTS), p.nknots, b.row_t[tid], out, p.nb);
    }
    float s = 0.f;
    for (int j = 0; j < p.nb; ++j) s += out[j];
    bsum[tid] = tid == ROW_FIRST ? 1.f : s;
  }
  __syncthreads();

  // the folded operator: each entry's channel at its row's time, over the
  // spatial latents, the mean in the last column
  const int ks = p.ks, ks1 = ks + 1;
  const float* eig = arg<float>(p, P_EIGEN);
  const float* mean = arg<float>(p, P_MEAN);
  for (int i = tid; i < b.n_ent * ks1; i += NT) {
    const int e = i / ks1, k = i % ks1;
    const float* bq = basis + ent_row[e] * p.nb;
    const int ch = ent_ch[e];
    float acc = 0.f;
    for (int j = 0; j < p.nb; ++j) {
      if (bq[j] == 0.f) continue;
      const int row = j * p.nd + ch;
      acc = fmaf(bq[j], k < ks ? eig[(size_t)row * ks + k] : mean[row], acc);
    }
    mop[i] = acc;
  }
  __syncthreads();

  float* wr = smem + lay.warps + (size_t)warp * lay.warp_floats;
  Warp w;
  w.raw = wr;
  w.s = wr + p.e_max;
  w.s_new = w.s + 32;
  w.fv = w.s_new + 32;
  w.rv = w.fv + MAX_SLOTS;
  w.jac = w.rv + MAX_SLOTS;
  int par = 0;
  Eval ev{p, b, mop, bsum, tbl, prec, mu, logw, w, lane, par};

  float s_l = lane < L ? arg<float>(p, P_S0)[c * L + lane] : 0.f;
  w.s[lane] = s_l;
  __syncwarp();
  float lam = p.lam0, radius = 1.f;
  for (int it = 0; it < p.iters; ++it) {
    const float err = ev.run<JAC>(w.s);
    // the normal equations, lane i row i
    float a[KW];
#pragma unroll
    for (int q = 0; q < KW; ++q) a[q] = 0.f;
    float g = 0.f;
    for (int n = 0; n < b.n_slots; ++n) {
      const float* jr = w.jac + n * 32;
      const float jl = jr[lane];
      g = fmaf(jl, w.rv[n], g);
#pragma unroll
      for (int q = 0; q < KW; ++q) a[q] = fmaf(jl, jr[q], a[q]);
    }
    float dg = 0.f;
#pragma unroll
    for (int q = 0; q < KW; ++q) dg = q == lane ? a[q] : dg;
    const float flo = fmaxf(p.damp * mg::warp_max(lane < L ? dg : 0.f), 1e-6f);
#pragma unroll
    for (int q = 0; q < KW; ++q)
      if (q == lane) a[q] = lane < L ? a[q] + lam * fmaxf(dg, flo) : 1.f;
    const float delta = mg::warp_chol_solve_regs<KW>(a, lane < L ? g : 0.f,
                                                     lane);
    const float dl = lane < L ? delta : 0.f;
    const float nrm = sqrtf(mg::warp_sum(dl * dl));
    const float scale = fminf(radius / fmaxf(nrm, 1e-10f), 1.f);
    const float sn = s_l - dl * scale;
    w.s_new[lane] = sn;
    __syncwarp();
    const float err_new = ev.run<PROBE>(w.s_new);
    const bool improved = err_new < err;
    s_l = improved ? sn : s_l;
    lam = improved ? fmaxf(lam * 0.1f, 1e-6f) : lam * 10.f;
    radius = improved ? fminf(radius * 2.f, 16.f) : radius;
    w.s[lane] = s_l;
    __syncwarp();
  }
  const float err = ev.run<FINAL>(w.s);
  if (warp == 0) {
    if (lane < L) out(p, P_S_OUT)[c * L + lane] = s_l;
    if (lane == 0) out(p, P_ERR_OUT)[c] = err;
  }
}

template <int KW>
int launch(const Params& p, cudaStream_t stream) {
  const Layout l = make_layout(p.e_max, p.ks, p.nb, p.g1, p.ncomp, p.L);
  // the default allows 48 KB less the block's static tables: opt in to what
  // this launch takes, whenever it takes more than any launch before
  static size_t opted = 0;
  if (l.bytes > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        request_lm_kernel<KW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)l.bytes);
    if (err != cudaSuccess) return (int)err;
    opted = l.bytes;
  }
  request_lm_kernel<KW><<<p.c, NT, l.bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

Params params(const int* ints, const float* flts) {
  Params p;
  p.c = ints[I_C];
  p.L = ints[I_L];
  p.ks = ints[I_KS];
  p.nb = ints[I_NB];
  p.nd = ints[I_ND];
  p.nknots = ints[I_NKNOTS];
  p.nnodes = ints[I_NNODES];
  p.ncomp = ints[I_NCOMP];
  p.g1 = ints[I_G1];
  p.iters = ints[I_ITERS];
  p.use_dir = ints[I_USE_DIR];
  p.use_traj = ints[I_USE_TRAJ];
  p.has_traj = ints[I_HAS_TRAJ];
  p.root_only = ints[I_ROOT_ONLY];
  p.e_max = ints[I_EMAX];
  for (int k = 0; k < 3; ++k) p.prec_s[k] = ints[I_PREC_S0 + k];
  p.es = flts[F_ES];
  p.qs = flts[F_QS];
  p.lam0 = flts[F_LAM0];
  p.damp = flts[F_DAMP];
  return p;
}

// Whether the kernel takes these sizes on the current device: one tangent a
// lane, the tables within the block's arrays, the deepest ancestor chain
// (depth nodes, root to node) within MAX_DEPTH, and the dynamic arrays with
// the block's own within the shared memory a block may opt in to.
int check(const Params& p, int depth) {
  if (p.L < 1 || p.L > 32 || p.ks > p.L || p.nnodes > MAX_NODES ||
      p.nknots > 64 || (p.has_traj && p.g1 < 2) || depth > MAX_DEPTH)
    return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t bytes =
      make_layout(p.e_max, p.ks, p.nb, p.g1, p.ncomp, p.L).bytes +
      sizeof(Block);
  return bytes <= (size_t)optin ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace

// 0 if the kernel takes the sizes of these ints (the launch's, `enum Int`)
// with the deepest chain of depth nodes, else a CUDA error code.
extern "C" int mg_request_lm_check(const int* ints, int depth) {
  const float flts[N_FLTS] = {};
  return check(params(ints, flts), depth);
}

extern "C" int mg_request_lm(const void* const* ptrs, const int* ints,
                             const float* flts, void* stream) {
  Params p = params(ints, flts);
  for (int i = 0; i < N_PTRS; ++i) p.ptr[i] = ptrs[i];
  if (p.c == 0) return 0;
  // the chains are checked where the kernel walks them (plan)
  const int err = check(p, 0);
  if (err != 0) return err;
  cudaStream_t st = (cudaStream_t)stream;
  return p.L <= 28 ? launch<28>(p, st) : launch<32>(p, st);
}
