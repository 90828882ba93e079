"""The walk's hand-written CUDA kernels, each beside its plain PyTorch twin
(port of the runtime kernels of morphablegraphs_tpu.ops.pallas_kernels).

* B1 `score_locomotion_candidates` (csrc/score_loco.cu): locomotion-family
  error of every candidate latent of every character.
* B3 `score_locomotion_candidates(..., chain=...)` (the same source's
  end-effector variant): B1 plus one position-only end-effector keyframe,
  with the ancestor-chain FK run per candidate.
* B2 `chol_solve` (csrc/chol_solve.cu): the crowd's batched SPD solve.
* B4 `lm_delta` (csrc/lm_delta.cu): the whole LM step block (JtJ, Jtr,
  Marquardt damping, Cholesky, trust clip) in one kernel.
* B5 `gmm_scores` / `gmm_nll_and_grad` / `gmm_nll` (csrc/gmm_scores.cu): the
  mixture log-likelihood of each row under its own mixture, with the
  gradient of -log p in the same pass (the LM's naturalness term);
  `gmm_nll` is the form the exact LM differentiates.
* B6 `crowd_back_project` (csrc/back_project.cu): fPCA back-projection and
  B-spline evaluation of every character's latent on a given basis, and
  `emit_frames` (the same source): the whole frame-emit stage of a walk
  step in one launch, the basis weights from the time function inside the
  kernel, then the aligning transform and the seam smoothing.

A wrapper given CPU tensors runs the twin; given CUDA tensors it launches
the kernel, or raises `KernelError` (a failed build, a CUDA error, a
device with no kernel).  Each wrapper counts its kernel's launches where
it launches it, and nowhere else, and each `KernelError` it raises, in the
tracer (`utils.profiling`: `kernel.launches.<kernel>`,
`kernel.errors.<wrapper>`); `launch_counts()` reads the launches.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils import profiling
from . import align, bspline, cuda_build, gmm as gmm_ops
from .cuda_build import KernelError

N_EVAL = 19  # goal kf + dir + 16 traj samples + frame 0 (alignment)
CH = 8  # root channels per eval frame, padded (x y z qw qx qy qz _)
N_BLK = 128  # candidate tile of the selection kernel
CFG_W = 48  # per-character scalar row (slots 31..38: the ee block)
TRAJ_SAMPLES = 16
DAMP_FLOOR_REL = 1e-2  # LM damping floor, relative to max(diag JtJ)
_PI = math.pi

# the kernels whose launches are counted (B1, B3, B2, B4, B5, B6, emit)
KERNELS = ("score_locomotion_candidates", "score_locomotion_candidates_ee",
           "chol_solve", "lm_delta", "gmm_scores", "crowd_back_project",
           "emit_frames")
LAUNCHES = "kernel.launches."
ERRORS = "kernel.errors."


def _launched(kernel: str):
    profiling.count(LAUNCHES + kernel)


def _counts_errors(wrapper):
    """The wrapper, counting each KernelError it raises."""
    name = ERRORS + wrapper.__name__

    @functools.wraps(wrapper)
    def counted(*args, **kwargs):
        try:
            return wrapper(*args, **kwargs)
        except KernelError:
            profiling.count(name)
            raise
    return counted


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Selection operator and packed inputs of B1
# ---------------------------------------------------------------------------

def pack_ee_chain(skeleton, joint: str):
    """Static ancestor-chain tables of the end-effector kernel B3: (chain_idx
    [L] int32, the animated-joint index of each chain node root first, -1
    for a fixed joint, and chain_const [L, 8] float32 rows
    [off_x off_y off_z rest_w rest_x rest_y rest_z is_animated]).  Numpy,
    host side; equal to the JAX package's tables for the same skeleton."""
    from ..models import skeleton as sk_mod
    chain, j = [], skeleton.index_of(joint)
    while j >= 0:
        chain.append(j)
        j = skeleton.parents[j]
    chain = chain[::-1]
    anim_idx = sk_mod._fk_tables(skeleton)
    rest = sk_mod._rest_table(skeleton)
    idx = np.asarray([anim_idx[c] for c in chain], np.int32)
    const = np.zeros((len(chain), 8), np.float32)
    for d, c in enumerate(chain):
        const[d, 0:3] = skeleton.offsets[c]
        const[d, 3:7] = rest[c]
        const[d, 7] = 1.0 if anim_idx[c] >= 0 else 0.0
    return idx, const


def ee_rows(depth: int) -> int:
    """Operator rows of the end-effector block of a depth-L chain."""
    return _round_up(3 + 4 * depth, 8)


def selection_operator(eigen_s: torch.Tensor, mean_s: torch.Tensor,
                       knots_s: torch.Tensor, n_basis_max: int, n_dim: int,
                       goal_frame: torch.Tensor, dir_frame: torch.Tensor,
                       n_canonical: torch.Tensor, ee_frame=None,
                       ee_chain_idx=None) -> torch.Tensor:
    """Fold the B-spline basis into the root rows of each character's fPCA
    operator.  eigen_s [C, nb*n_dim, K], mean_s [C, nb*n_dim], knots_s
    [C, n_knots], frames [C] -> M' [C, N_EVAL*CH, K+1] with the mean in the
    last column; eval frame order [goal kf | dir | traj 0..15 | frame 0].

    With ee_frame [C] and ee_chain_idx (from `pack_ee_chain`) an
    end-effector block of `ee_rows(L)` rows follows: the raw root
    translation and each chain joint's local quaternion channels at
    ee_frame, zero rows for fixed joints (the kernel substitutes their rest
    rotations)."""
    c, _, k = eigen_s.shape
    eigen_full = eigen_s.reshape(c, n_basis_max, n_dim, k)
    mean_full = mean_s.reshape(c, n_basis_max, n_dim)
    lin = torch.linspace(0.0, 1.0, TRAJ_SAMPLES, device=eigen_s.device)
    t_lin = lin * torch.clamp(n_canonical - 1.0, min=1.0)[:, None]
    parts = [goal_frame[:, None], dir_frame[:, None], t_lin,
             torch.zeros_like(goal_frame)[:, None]]
    if ee_chain_idx is not None:
        parts.append(torch.as_tensor(ee_frame, dtype=torch.float32,
                                     device=eigen_s.device).expand(c)[:, None])
    b = bspline.basis_matrix(knots_s, torch.cat(parts, dim=1))
    m = torch.einsum("cfb,cbhk->cfhk", b[:, :N_EVAL], eigen_full[:, :, :7])
    mu = torch.einsum("cfb,cbh->cfh", b[:, :N_EVAL], mean_full[:, :, :7])
    m = torch.cat([m, mu[..., None]], dim=-1)  # [C, F, 7, K+1]
    m = torch.nn.functional.pad(m, (0, 0, 0, CH - 7))
    mop = m.reshape(c, N_EVAL * CH, k + 1)
    if ee_chain_idx is None:
        return mop
    depth = len(ee_chain_idx)
    ch_idx, ch_mask = [0, 1, 2], [1.0, 1.0, 1.0]
    for a in np.asarray(ee_chain_idx):
        if a >= 0:
            ch_idx += [3 + 4 * int(a) + i for i in range(4)]
            ch_mask += [1.0] * 4
        else:  # fixed joint: zero rows
            ch_idx += [0, 0, 0, 0]
            ch_mask += [0.0] * 4
    mask = torch.as_tensor(ch_mask, dtype=eigen_s.dtype,
                           device=eigen_s.device)
    b_ee = b[:, N_EVAL]  # [C, nb]
    m_ee = torch.einsum("cb,cbhk->chk", b_ee,
                        eigen_full[:, :, ch_idx] * mask[:, None])
    mu_ee = torch.einsum("cb,cbh->ch", b_ee, mean_full[:, :, ch_idx] * mask)
    rows = torch.cat([m_ee, mu_ee[..., None]], dim=-1)  # [C, 3+4L, K+1]
    rows = torch.nn.functional.pad(
        rows, (0, 0, 0, ee_rows(depth) - rows.shape[1]))
    return torch.cat([mop, rows], dim=1)


def pack_path_table(sp, root_offset: torch.Tensor) -> torch.Tensor:
    """Per-character arc tables [C, G8, 5]: cols 0..2 the dim-masked path
    points shifted by -root_offset (the kernel works on raw frame
    translations; fk_root adds the offset), 3 the arc length, 4 validity.
    Rows past the table (G8 = G+1 rounded up to 8) are zero."""
    pts = sp.table_points - root_offset
    g1 = pts.shape[-2]
    g8 = _round_up(g1, 8)
    c = pts.shape[0]
    table = torch.zeros((c, g8, 5), dtype=torch.float32, device=pts.device)
    table[:, :g1, 0:3] = pts * sp.dim_mask()[:, None, :]
    table[:, :g1, 3] = sp.table_arc
    table[:, :g1, 4] = 1.0
    return table


def pack_selection_cfg(sp, a_prev, prev_pos, start_theta, start_delta,
                       has_prev, goal_pos, dir_target, min_arc, kf_weight,
                       dir_weight, traj_active, traj_weight, range_lo,
                       range_hi, root_offset, kf_active=1.0, dir_active=1.0,
                       ee_active=0.0, ee_weight=1.0, ee_target=None,
                       ee_mask=None) -> torch.Tensor:
    """Per-character scalars [C, CFG_W] in the TPU kernel's layout.  Every
    argument is [C] or [C, n] (or a Python float broadcast over the crowd);
    goal_pos, the end-snap point and the end-effector target are shifted by
    -root_offset.  ee_* fill slots 31..38, read by kernel B3 only: the
    end-effector keyframe's activity, weight, world target [C, 3] and
    component mask [C, 3]."""
    c = sp.table_arc.shape[0]
    dev = sp.table_arc.device

    def col(v):
        return torch.as_tensor(v, dtype=torch.float32,
                               device=dev).expand(c)

    a_dir = torch.atan2(dir_target[:, 0], dir_target[:, 1])
    mask = sp.dim_mask()
    end_pt = (sp.table_points[:, -1] - root_offset) * mask
    goal = goal_pos - root_offset
    zero3 = torch.zeros((c, 3), device=dev)
    ee_t = (zero3 if ee_target is None else ee_target) - root_offset
    ee_m = zero3 if ee_mask is None else ee_mask
    vals = [torch.cos(a_prev), prev_pos[:, 0], prev_pos[:, 1],
            prev_pos[:, 2], torch.cos(start_theta), start_delta[:, 0],
            start_delta[:, 1], start_delta[:, 2], has_prev, goal[:, 0],
            goal[:, 1], goal[:, 2], kf_active, kf_weight, dir_active,
            dir_weight, traj_active, traj_weight, min_arc, a_dir, range_lo,
            range_hi, mask[:, 0], mask[:, 1], mask[:, 2], end_pt[:, 0],
            end_pt[:, 1], end_pt[:, 2], sp.table_arc[:, -1],
            torch.sin(a_prev), torch.sin(start_theta), ee_active,
            ee_weight, ee_t[:, 0], ee_t[:, 1], ee_t[:, 2], ee_m[:, 0],
            ee_m[:, 1], ee_m[:, 2]]
    cfg = torch.stack([col(v) for v in vals], dim=1)
    return torch.nn.functional.pad(cfg, (0, CFG_W - cfg.shape[1]))


# ---------------------------------------------------------------------------
# B1: locomotion candidate scoring
# ---------------------------------------------------------------------------

def _heading_vec(qw, qx, qy, qz):
    """Unnormalized XZ heading of rotate(normalize(q), [0, 0, 1]); both
    components carry the same |q|^2 scale."""
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    return 2.0 * (qw * qy + qx * qz), n2 - 2.0 * (qx * qx + qy * qy)


def _atan2(y, x):
    """The TPU kernel's polynomial atan2 (range-reduced 3-term minimax,
    ~1e-4 rad), kept so kernel, twin and the JAX kernel rank alike."""
    ax, ay = torch.abs(x), torch.abs(y)
    a = torch.minimum(ax, ay) / torch.clamp(torch.maximum(ax, ay), min=1e-30)
    s = a * a
    r = ((-0.0464964749 * s + 0.15931422) * s - 0.327622764) * s * a + a
    r = torch.where(ay > ax, 0.5 * _PI - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def _table_search(d2: torch.Tensor, t_arc: torch.Tensor,
                  t_valid: torch.Tensor, min_arc: torch.Tensor):
    """One trajectory sample's masked closest-point search, in the TPU
    kernel's two full passes: table distances d2 [C, G8, N], arcs and
    validity [C, G8, 1], floors min_arc [C, N] -> (the least distance over
    the valid rows at or above the floor [C, N], the smallest arc among
    those rows within 1e-6 of it [C, N], and the rows searched [C, G8, N],
    1 where a row is valid and at or above the floor)."""
    inf = torch.tensor(float("inf"), device=d2.device)
    valid = (t_arc >= min_arc[:, None, :] - 1e-6) * t_valid
    d2m = torch.where(valid > 0, d2, inf)
    dmin2 = d2m.amin(dim=1)  # [C, N]
    arc_sel = torch.where(d2m <= dmin2[:, None, :] + 1e-6, t_arc,
                          inf).amin(dim=1)
    return dmin2, arc_sel, valid


def _loco_score_body(frames: torch.Tensor, table: torch.Tensor,
                     cfg: torch.Tensor):
    """The TPU kernel body on evaluated rows frames [C, N_EVAL*CH(+ee), N]
    -> (errors [C, N], and the per-candidate aligning transform ct, st, dx,
    dy, dz [C, N] the end-effector block reuses)."""
    n = frames.shape[-1]

    def p(i):
        return cfg[:, i: i + 1]  # [C, 1]

    def row(i):
        return frames[:, i, :]  # [C, N]

    has_prev = p(8) > 0
    f0 = (N_EVAL - 1) * CH
    hx0, hz0 = _heading_vec(row(f0 + 3), row(f0 + 4), row(f0 + 5),
                            row(f0 + 6))
    inv_n = torch.rsqrt(hx0 * hx0 + hz0 * hz0 + 1e-30)
    c_new, s_new = hz0 * inv_n, hx0 * inv_n
    ct = torch.where(has_prev, p(0) * c_new + p(29) * s_new,
                     p(4).expand(-1, n))
    st = torch.where(has_prev, p(29) * c_new - p(0) * s_new,
                     p(30).expand(-1, n))
    r0x = ct * row(f0) + st * row(f0 + 2)
    r0z = -st * row(f0) + ct * row(f0 + 2)
    dx = torch.where(has_prev, p(1) - r0x, p(5).expand(-1, n))
    dz = torch.where(has_prev, p(3) - r0z, p(7).expand(-1, n))
    dy = torch.where(has_prev, torch.zeros_like(r0x), p(6).expand(-1, n))

    def world_xz(i):
        return (ct * row(i) + st * row(i + 2) + dx,
                -st * row(i) + ct * row(i + 2) + dz)

    gx, gz = world_xz(0)
    kf_err = torch.sqrt((gx - p(9)) ** 2 + (gz - p(11)) ** 2 + 1e-12)

    hxf, hzf = _heading_vec(row(CH + 3), row(CH + 4), row(CH + 5),
                            row(CH + 6))
    a_f = _atan2(ct * hxf + st * hzf, -st * hxf + ct * hzf)
    diff = p(19) - a_f
    wrapped = diff - 2.0 * _PI * torch.floor(diff / (2.0 * _PI) + 0.5)
    dir_err = torch.abs(wrapped) * (180.0 / _PI)

    t_pts = table[:, :, 0:3]  # [C, G8, 3]
    t_arc = table[:, :, 3:4]  # [C, G8, 1]
    t_valid = table[:, :, 4:5]
    t_norm2 = torch.sum(t_pts * t_pts, dim=2, keepdim=True)
    min_arc = p(18).expand(-1, n)
    traj_sum = torch.zeros_like(kf_err)
    for f in range(2, 2 + TRAJ_SAMPLES):
        px, pz = world_xz(f * CH)
        py = row(f * CH + 1) + dy
        pxm, pym, pzm = px * p(22), py * p(23), pz * p(24)
        cross = torch.bmm(t_pts, torch.stack([pxm, pym, pzm], dim=1))
        d2 = t_norm2 - 2.0 * cross + (pxm * pxm + pym * pym
                                      + pzm * pzm)[:, None, :]
        dmin2, arc_sel, valid = _table_search(d2, t_arc, t_valid, min_arc)
        end_d2 = (p(25) - pxm) ** 2 + (p(26) - pym) ** 2 + (p(27) - pzm) ** 2
        any_valid = valid.amax(dim=1) > 0
        dmin2 = torch.where(any_valid, dmin2, end_d2)
        arc_sel = torch.where(any_valid, arc_sel, p(28).expand(-1, n))
        d = torch.sqrt(torch.clamp(dmin2, min=1e-12))
        in_range = ((arc_sel >= p(20)) & (arc_sel <= p(21))).to(d.dtype)
        traj_sum = traj_sum + d * in_range
        min_arc = arc_sel
    err = (p(12) * p(13) * kf_err + p(14) * p(15) * dir_err
           + p(16) * p(17) * traj_sum / 16.0)
    return err, ct, st, dx, dy, dz


def _ee_score(frames, cfg, chain, ct, st, dx, dy, dz):
    """B3's end-effector term: ancestor-chain FK of the ee block's rows per
    candidate, in fk_global's composition order with unnormalized
    quaternions; the aligning rotation enters as its half-angle quaternion
    from (ct, st).  chain [L, 8] from `pack_ee_chain` -> [C, N]."""
    def p(i):
        return cfg[:, i: i + 1]

    def row(i):
        return frames[:, i, :]

    eb = N_EVAL * CH
    px = ct * row(eb) + st * row(eb + 2) + dx
    pz = -st * row(eb) + ct * row(eb + 2) + dz
    py = row(eb + 1) + dy

    def local_q(d):
        return [torch.where(chain[d, 7] > 0, row(eb + 3 + 4 * d + i),
                            chain[d, 3 + i]) for i in range(4)]

    c2 = torch.sqrt(torch.clamp((1.0 + ct) * 0.5, min=0.0))
    s2m = torch.sqrt(torch.clamp((1.0 - ct) * 0.5, min=0.0))
    s2 = torch.where(st >= 0, s2m, -s2m)
    qw, qx, qy, qz = local_q(0)
    aw, ax = c2 * qw - s2 * qy, c2 * qx + s2 * qz
    ay, az = c2 * qy + s2 * qw, c2 * qz - s2 * qx
    for d in range(1, chain.shape[0]):
        ox, oy, oz = chain[d, 0], chain[d, 1], chain[d, 2]
        uvx, uvy, uvz = ay * oz - az * oy, az * ox - ax * oz, ax * oy - ay * ox
        uuvx = ay * uvz - az * uvy
        uuvy = az * uvx - ax * uvz
        uuvz = ax * uvy - ay * uvx
        px = px + ox + 2.0 * (aw * uvx + uuvx)
        py = py + oy + 2.0 * (aw * uvy + uuvy)
        pz = pz + oz + 2.0 * (aw * uvz + uuvz)
        lw, lx, ly, lz = local_q(d)
        aw, ax, ay, az = (aw * lw - ax * lx - ay * ly - az * lz,
                          aw * lx + ax * lw + ay * lz - az * ly,
                          aw * ly - ax * lz + ay * lw + az * lx,
                          aw * lz + ax * ly - ay * lx + az * lw)
    ddx, ddy, ddz = (px - p(33)) * p(36), (py - p(34)) * p(37), \
        (pz - p(35)) * p(38)
    ee_err = torch.sqrt(torch.clamp(ddx * ddx + ddy * ddy + ddz * ddz,
                                    min=1e-12))
    return p(31) * p(32) * ee_err


def score_locomotion_candidates_ref(mop: torch.Tensor, alphas: torch.Tensor,
                                    table: torch.Tensor, cfg: torch.Tensor,
                                    chain=None) -> torch.Tensor:
    """Plain PyTorch twin of kernels B1 and, with chain, B3 (same arguments
    and result)."""
    c, n, _ = alphas.shape
    a1 = torch.cat([alphas, torch.ones((c, n, 1), dtype=alphas.dtype,
                                       device=alphas.device)], dim=2)
    frames = torch.bmm(mop, a1.transpose(1, 2))  # [C, rows, N]
    err, *xform = _loco_score_body(frames, table, cfg)
    if chain is None:
        return err
    return err + _ee_score(frames, cfg, torch.as_tensor(
        chain, dtype=frames.dtype, device=frames.device), *xform)


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name}: every input must be a contiguous "
                             f"float32 tensor on {dev}")


# the selection kernel's grid fills the card from here: on an H100 the width
# this picks was the fastest of the six at every batch of 8 to 256
# characters x 128 candidates over an arc table of 1008 rows, and 1 lane at
# 1024
MIN_WARPS_PER_SM = 8


def selection_lanes(c: int, n: int, n_sm: int) -> int:
    """Lanes per candidate of the selection kernel (1, 2, ..., 32): the
    fewest whose grid of c*n candidates holds MIN_WARPS_PER_SM warps on each
    of n_sm SMs (1 for a 1024 x 128 crowd, 4 for 128 x 128, 32 for 16 x 128
    and fewer on an H100)."""
    lanes = 1
    while lanes < 32 and c * n * lanes < 32 * MIN_WARPS_PER_SM * n_sm:
        lanes *= 2
    return lanes


def _launch_selection(mop, alphas, table, cfg, chain, lanes: int):
    """Launch B1 (chain None) or B3 with `lanes` lanes per candidate on
    checked CUDA inputs -> errors [C, N]."""
    c, n, k = alphas.shape
    out = torch.empty((c, n), dtype=torch.float32, device=mop.device)
    if c == 0 or n == 0:
        return out
    lib = cuda_build.load_library()
    with torch.cuda.device(mop.device):
        stream = torch.cuda.current_stream().cuda_stream
        if chain is None:
            cuda_build.check(lib.mg_score_loco(
                mop.data_ptr(), alphas.data_ptr(), table.data_ptr(),
                cfg.data_ptr(), out.data_ptr(), c, n, k, table.shape[1],
                lanes, stream), "score_locomotion_candidates launch")
            _launched("score_locomotion_candidates")
        else:
            cuda_build.check(lib.mg_score_loco_ee(
                mop.data_ptr(), alphas.data_ptr(), table.data_ptr(),
                cfg.data_ptr(), chain.data_ptr(), out.data_ptr(), c, n, k,
                table.shape[1], chain.shape[0], lanes, stream),
                "score_locomotion_candidates (ee) launch")
            _launched("score_locomotion_candidates_ee")
    return out


@_counts_errors
def score_locomotion_candidates(mop: torch.Tensor, alphas: torch.Tensor,
                                table: torch.Tensor, cfg: torch.Tensor,
                                chain=None) -> torch.Tensor:
    """Locomotion-family error of every candidate (kernel B1), plus with
    chain the end-effector keyframe of cfg slots 31..38 (kernel B3).

    mop [C, N_EVAL*CH (+ ee_rows(L)), K+1] from `selection_operator`;
    alphas [C, N, K] with N a multiple of 128; table [C, G8, 5] from
    `pack_path_table`; cfg [C, CFG_W] from `pack_selection_cfg`; chain
    [L, 8] from `pack_ee_chain` -> errors [C, N].

    Precondition of the kernel: a table's arcs never decrease over its
    valid rows, as `pack_path_table` builds them; its searches start at
    their floor and stop at their first hit on that account."""
    c, n, k = alphas.shape
    if n % N_BLK != 0:
        raise ValueError(f"pad candidates to a multiple of {N_BLK}")
    rows = N_EVAL * CH
    if chain is not None:
        chain = torch.as_tensor(chain, dtype=torch.float32,
                                device=mop.device).contiguous()
        if chain.dim() != 2 or chain.shape[1] != 8 or chain.shape[0] < 1:
            raise ValueError("chain must be [L, 8] from pack_ee_chain")
        rows += ee_rows(chain.shape[0])
    if mop.shape != (c, rows, k + 1) or table.shape[0] != c \
            or table.shape[2] != 5 or cfg.shape != (c, CFG_W):
        raise ValueError("score_locomotion_candidates: shape mismatch")
    if mop.device.type == "cpu":
        return score_locomotion_candidates_ref(mop, alphas, table, cfg,
                                               chain)
    if mop.device.type != "cuda":
        raise KernelError(f"no kernel for device {mop.device}")
    _check_cuda("score_locomotion_candidates", mop, alphas, table, cfg)
    n_sm = torch.cuda.get_device_properties(mop.device).multi_processor_count
    return _launch_selection(mop, alphas, table, cfg, chain,
                             selection_lanes(c, n, n_sm))


# ---------------------------------------------------------------------------
# B2: batched SPD solve
# ---------------------------------------------------------------------------

def chol_solve_unrolled(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve a[..., :, :] x = g[...] by an unrolled Cholesky factorization
    (1e-12 floor under the square root) and two substitutions; the plain
    twin of kernel B2."""
    n = a.shape[-1]
    c = torch.zeros_like(a)
    for j in range(n):
        s = a[..., j, j] - torch.sum(c[..., j, :j] ** 2, dim=-1)
        d = torch.sqrt(torch.clamp(s, min=1e-12))
        col = (a[..., j + 1:, j] - torch.einsum(
            "...ik,...k->...i", c[..., j + 1:, :j], c[..., j, :j])) \
            / d[..., None]
        c[..., j, j] = d
        c[..., j + 1:, j] = col
    y = torch.zeros_like(g)
    for i in range(n):
        y[..., i] = (g[..., i] - torch.sum(c[..., i, :i] * y[..., :i], -1)) \
            / c[..., i, i]
    x = torch.zeros_like(g)
    for i in reversed(range(n)):
        x[..., i] = (y[..., i] - torch.sum(c[..., i + 1:, i]
                                           * x[..., i + 1:], -1)) \
            / c[..., i, i]
    return x


@_counts_errors
def chol_solve(a: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Crowd SPD solve: a [C, k, k], g [C, k] -> x [C, k].  Zero systems
    solve to 0."""
    if a.dim() != 3 or g.shape != a.shape[:2] or a.shape[1] != a.shape[2]:
        raise ValueError("chol_solve expects a [C, k, k] and g [C, k]")
    if a.device.type == "cpu":
        return chol_solve_unrolled(a, g)
    if a.device.type != "cuda":
        raise KernelError(f"no kernel for device {a.device}")
    a = a.contiguous()
    g = g.contiguous()
    _check_cuda("chol_solve", a, g)
    c, k = g.shape
    x = torch.empty_like(g)
    if c == 0:
        return x
    lib = cuda_build.load_library()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.mg_chol_solve(a.data_ptr(), g.data_ptr(),
                                           x.data_ptr(), c, k, stream),
                         "chol_solve launch")
    _launched("chol_solve")
    return x


# ---------------------------------------------------------------------------
# B4: the fused LM step block
# ---------------------------------------------------------------------------

def lm_delta_block(j: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                   radius: torch.Tensor, solve) -> torch.Tensor:
    """The LM step block with `solve` for the damped normal equations:
    solve (JtJ + lam diag(max(dg, max(1e-2 max dg, 1e-6)))) delta = Jt r,
    then scale delta so that ||delta|| <= radius.  j [C, R, k], r [C, R],
    lam/radius [C] -> delta [C, k]."""
    jt = j.transpose(1, 2)
    jtj = torch.bmm(jt, j)
    dg = torch.diagonal(jtj, dim1=-2, dim2=-1)
    floor = torch.clamp(DAMP_FLOOR_REL * dg.amax(-1), min=1e-6)
    damp = torch.diag_embed(torch.maximum(dg, floor[:, None]))
    g = torch.bmm(jt, r[..., None])[..., 0]
    delta = solve(jtj + lam[:, None, None] * damp, g)
    nrm = torch.linalg.vector_norm(delta, dim=-1)
    scale = torch.clamp(radius / torch.clamp(nrm, min=1e-10), max=1.0)
    return delta * scale[:, None]


def lm_delta_ref(j: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
                 radius: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of kernel B4: the step block solved by
    `chol_solve_unrolled` on any device."""
    return lm_delta_block(j, r, lam, radius, chol_solve_unrolled)


@_counts_errors
def lm_delta(j: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
             radius: torch.Tensor) -> torch.Tensor:
    """Clipped LM step of the whole crowd in one kernel (B4): j [C, R, k],
    r [C, R], lam/radius [C] -> delta [C, k].  Zero characters give 0."""
    if j.dim() != 3 or r.shape != j.shape[:2] \
            or lam.shape != j.shape[:1] or radius.shape != j.shape[:1]:
        raise ValueError("lm_delta expects j [C, R, k], r [C, R], "
                         "lam [C] and radius [C]")
    if j.device.type == "cpu":
        return lm_delta_ref(j, r, lam, radius)
    if j.device.type != "cuda":
        raise KernelError(f"no kernel for device {j.device}")
    j, r, lam, radius = (t.contiguous() for t in (j, r, lam, radius))
    _check_cuda("lm_delta", j, r, lam, radius)
    c, n_res, k = j.shape
    out = torch.empty((c, k), dtype=torch.float32, device=j.device)
    if c == 0:
        return out
    lib = cuda_build.load_library()
    with torch.cuda.device(j.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.mg_lm_delta(
            j.data_ptr(), r.data_ptr(), lam.data_ptr(), radius.data_ptr(),
            out.data_ptr(), c, n_res, k, DAMP_FLOOR_REL, stream),
            "lm_delta launch")
    _launched("lm_delta")
    return out


# ---------------------------------------------------------------------------
# B5: mixture log-likelihood (and its gradient) per row
# ---------------------------------------------------------------------------

GMM_MAX_DIM = 64  # kernel B5: a lane holds at most two columns


def _mixture_rows(x, weights, means, prec_chol, mix_id):
    """Both signatures of B5 as the stacked one: with mix_id None a single
    mixture (weights [K], means [K, D], prec_chol [K, D, D]) shared by
    every row; else stacked [M, ...] mixtures and mix_id [C]."""
    if mix_id is None:
        weights, means, prec_chol = weights[None], means[None], prec_chol[None]
        mix_id = torch.zeros(x.shape[0], dtype=torch.long, device=x.device)
    m, k, d = means.shape
    if x.dim() != 2 or x.shape[1] != d or weights.shape != (m, k) \
            or prec_chol.shape != (m, k, d, d) \
            or mix_id.shape != x.shape[:1]:
        raise ValueError("gmm_scores expects x [C, D], weights [M, K], "
                         "means [M, K, D], prec_chol [M, K, D, D] and "
                         "mix_id [C] (or one unstacked mixture)")
    return weights, means, prec_chol, mix_id


def _row_gmm(weights, means, prec_chol, mix_id) -> gmm_ops.GMM:
    return gmm_ops.GMM(weights[mix_id], means[mix_id], prec_chol[mix_id],
                       prec_chol[mix_id])


def gmm_scores_ref(x, weights, means, prec_chol, mix_id=None):
    """Plain PyTorch twin of kernel B5's value: `gmm.log_prob` of each row
    under its gathered mixture -> [C]."""
    args = _mixture_rows(x, weights, means, prec_chol, mix_id)
    return gmm_ops.log_prob(_row_gmm(*args), x)


def gmm_nll_and_grad_ref(x, weights, means, prec_chol, mix_id):
    """Plain PyTorch twin of kernel B5 with its gradient:
    `gmm.neg_log_prob_and_grad` on the gathered mixtures -> ([C], [C, D])."""
    args = _mixture_rows(x, weights, means, prec_chol, mix_id)
    return gmm_ops.neg_log_prob_and_grad(_row_gmm(*args), x)


def _launch_gmm(x, weights, means, prec_chol, mix_id, with_grad: bool):
    weights, means, prec_chol, mix_id = (t.contiguous() for t in _mixture_rows(
        x, weights, means, prec_chol, mix_id))
    x = x.contiguous()
    _check_cuda("gmm_scores", x, weights, means, prec_chol)
    c, d = x.shape
    m, k = weights.shape
    if d > GMM_MAX_DIM:
        raise ValueError(f"gmm_scores: the kernel takes D <= {GMM_MAX_DIM} "
                         f"latent dims, got {d}")
    mix_id = mix_id.to(device=x.device, dtype=torch.long).contiguous()
    logp = torch.empty(c, dtype=torch.float32, device=x.device)
    grad = torch.empty_like(x) if with_grad else None
    if c == 0:
        return logp, grad
    lib = cuda_build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.mg_gmm_scores(
            x.data_ptr(), weights.data_ptr(), means.data_ptr(),
            prec_chol.data_ptr(), mix_id.data_ptr(), logp.data_ptr(),
            None if grad is None else grad.data_ptr(), c, m, k, d, stream),
            "gmm_scores launch")
    _launched("gmm_scores")
    return logp, grad


@_counts_errors
def gmm_scores(x: torch.Tensor, weights: torch.Tensor, means: torch.Tensor,
               prec_chol: torch.Tensor, mix_id=None) -> torch.Tensor:
    """Mixture log-likelihood of each row (kernel B5): x [C, D] under one
    mixture (weights [K], means [K, D], prec_chol [K, D, D]; the TPU
    kernel's signature) or, with mix_id [C], under row mix_id[c] of stacked
    mixtures [M, ...] -> log p [C]."""
    if x.device.type == "cpu":
        return gmm_scores_ref(x, weights, means, prec_chol, mix_id)
    if x.device.type != "cuda":
        raise KernelError(f"no kernel for device {x.device}")
    return _launch_gmm(x, weights, means, prec_chol, mix_id, False)[0]


@_counts_errors
def gmm_nll_and_grad(x: torch.Tensor, weights: torch.Tensor,
                     means: torch.Tensor, prec_chol: torch.Tensor,
                     mix_id: torch.Tensor):
    """(-log p [C], d(-log p)/dx [C, D]) of each row x[c] under stacked
    mixture mix_id[c], both from one launch of kernel B5 (what
    `gmm.neg_log_prob_and_grad` returns on the gathered mixtures)."""
    if x.device.type == "cpu":
        return gmm_nll_and_grad_ref(x, weights, means, prec_chol, mix_id)
    if x.device.type != "cuda":
        raise KernelError(f"no kernel for device {x.device}")
    logp, grad = _launch_gmm(x, weights, means, prec_chol, mix_id, True)
    return -logp, grad


class _GmmNll(torch.autograd.Function):
    """-log p of each row with its derivative in x taken from kernel B5's
    gradient: `forward` is `gmm_nll_and_grad` (one launch on a CUDA tensor,
    the twin on a CPU tensor); `jvp` and `backward` are tensor expressions
    of the saved gradient, as the TPU kernel has no derivative kernel
    either.  Only x is differentiable, and only once (the LM is
    Gauss-Newton)."""

    @staticmethod
    def forward(x, weights, means, prec_chol, mix_id):
        # the launch reads data_ptr(): x must be the rows themselves, not a
        # tensor wrapped by a torch.func transform
        if torch._C._functorch.is_functorch_wrapped_tensor(x):
            raise RuntimeError("gmm_nll: x reached the kernel wrapped by a "
                               "torch.func transform")
        return gmm_nll_and_grad(x, weights, means, prec_chol, mix_id)

    @staticmethod
    def setup_context(ctx, inputs, output):
        grad = output[1]
        ctx.mark_non_differentiable(grad)
        ctx.save_for_backward(grad)
        ctx.save_for_forward(grad)

    @staticmethod
    def backward(ctx, g_nll, _g_grad):
        grad, = ctx.saved_tensors
        return g_nll[:, None] * grad, None, None, None, None

    @staticmethod
    def jvp(ctx, x_t, *_):
        grad, = ctx.saved_tensors
        return (grad * x_t).sum(-1), None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise RuntimeError(
            "gmm_nll cannot be vmapped over its inputs: the kernel takes the "
            "crowd's rows as one [C, D] tensor (vmap the tangent of a jvp, "
            "as lm.linearize does, not x)")


def gmm_nll(x: torch.Tensor, weights: torch.Tensor, means: torch.Tensor,
            prec_chol: torch.Tensor, mix_id: torch.Tensor) -> torch.Tensor:
    """-log p [C] of each row x[c] under stacked mixture mix_id[c],
    differentiable in x (forward mode under `lm.linearize`, and reverse
    mode): one launch of kernel B5 gives the value and, through the saved
    gradient, every jacobian column."""
    return _GmmNll.apply(x, weights, means, prec_chol, mix_id)[0]


# ---------------------------------------------------------------------------
# B6: crowd back-projection
# ---------------------------------------------------------------------------

def _back_project_args(alphas, eigen, mean, basis, mix_id):
    """Both signatures of B6 as the stacked one: with mix_id None one
    eigen [D, K], mean [D] and basis [T, n_basis] shared by the crowd."""
    if mix_id is None:
        eigen, mean, basis = eigen[None], mean[None], basis[None]
        mix_id = torch.zeros(alphas.shape[0], dtype=torch.long,
                             device=alphas.device)
    c, k = alphas.shape
    m, d, _ = eigen.shape
    n_basis = basis.shape[-1]
    if eigen.shape[2] != k or mean.shape != (m, d) or basis.dim() != 3 \
            or basis.shape[0] not in (1, c) or d % n_basis != 0 \
            or mix_id.shape != (c,):
        raise ValueError("crowd_back_project expects alphas [C, K], eigen "
                         "[M, n_basis*n_dim, K], mean [M, n_basis*n_dim], "
                         "basis [C or 1, T, n_basis] and mix_id [C] (or "
                         "the unstacked TPU signature)")
    return eigen, mean, basis, mix_id


def crowd_back_project_ref(alphas, eigen, mean, basis, mix_id=None):
    """Plain PyTorch twin of kernel B6: frames[c] = basis[c] @
    reshape(eigen[mix_id[c]] @ alphas[c] + mean[mix_id[c]]) (the einsum
    form of the walk's back-projection) -> [C, T, n_dim]."""
    eigen, mean, basis, mix_id = _back_project_args(alphas, eigen, mean,
                                                    basis, mix_id)
    coeffs = torch.einsum("cdk,ck->cd", eigen[mix_id], alphas) + mean[mix_id]
    return torch.matmul(basis, coeffs.reshape(alphas.shape[0],
                                              basis.shape[-1], -1))


@_counts_errors
def crowd_back_project(alphas: torch.Tensor, eigen: torch.Tensor,
                       mean: torch.Tensor, basis: torch.Tensor,
                       mix_id=None) -> torch.Tensor:
    """Back-projected frames of a crowd (kernel B6): alphas [C, K] with one
    eigen [n_basis*n_dim, K], mean [n_basis*n_dim] and basis [T, n_basis]
    (the TPU kernel's signature), or with mix_id [C] stacked eigen
    [M, n_basis*n_dim, K], mean [M, n_basis*n_dim] and per-character bases
    [C, T, n_basis] (or [1, T, n_basis] shared) -> [C, T, n_dim]."""
    if alphas.device.type == "cpu":
        return crowd_back_project_ref(alphas, eigen, mean, basis, mix_id)
    if alphas.device.type != "cuda":
        raise KernelError(f"no kernel for device {alphas.device}")
    eigen, mean, basis, mix_id = _back_project_args(alphas, eigen, mean,
                                                    basis, mix_id)
    alphas, eigen, mean, basis = (t.contiguous()
                                  for t in (alphas, eigen, mean, basis))
    _check_cuda("crowd_back_project", alphas, eigen, mean, basis)
    mix_id = mix_id.to(device=alphas.device, dtype=torch.long).contiguous()
    c, k = alphas.shape
    m, d, _ = eigen.shape
    t, n_basis = basis.shape[1:]
    n_dim = d // n_basis
    out = torch.empty((c, t, n_dim), dtype=torch.float32,
                      device=alphas.device)
    if c == 0:
        return out
    lib = cuda_build.load_library()
    with torch.cuda.device(alphas.device):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.mg_back_project(
            eigen.data_ptr(), mean.data_ptr(), mix_id.data_ptr(),
            alphas.data_ptr(), basis.data_ptr(), out.data_ptr(), c, m, k,
            n_basis, n_dim, t, int(basis.shape[0] == 1), stream),
            "crowd_back_project launch")
    _launched("crowd_back_project")
    return out


def _emit_args(alphas, eigen, mean, knots, mix_id, t_fn, n_frames,
               prev_last, has_prev):
    c, k = alphas.shape
    m, d, _ = eigen.shape
    n_basis = knots.shape[-1] - bspline.DEGREE - 1
    if eigen.shape[2] != k or mean.shape != (m, d) or knots.dim() != 2 \
            or knots.shape[0] != m or n_basis < 1 or d % n_basis != 0 \
            or mix_id.shape != (c,) or t_fn.dim() != 2 \
            or t_fn.shape[0] != c or n_frames.shape != (c,) \
            or (prev_last is None) == bool(has_prev) \
            or (has_prev and prev_last.shape != (c, d // n_basis)):
        raise ValueError("emit_frames expects alphas [C, K], eigen "
                         "[M, n_basis*n_dim, K], mean [M, n_basis*n_dim], "
                         "knots [M, n_basis+4], mix_id [C], t_fn [C, T], "
                         "n_frames [C] and, exactly when has_prev, "
                         "prev_last [C, n_dim]")
    n_dim = d // n_basis
    if n_dim < 7 or (n_dim - 3) % 4 != 0:
        raise ValueError("emit_frames: frames are a root translation and "
                         f"quaternions, n_dim = 3 + 4 J, got {n_dim}")
    return n_basis, n_dim


def emit_frames_ref(alphas, eigen, mean, knots, mix_id, t_fn, n_frames,
                    prev_last, has_prev: bool, window: int):
    """Plain PyTorch twin of `emit_frames`, the composition a walk step ran
    before the fused kernel: `bspline.basis_matrix` on the time function,
    `crowd_back_project_ref`, and with has_prev
    `align.node_aligning_2d_transform` of frame 0 onto prev_last,
    `align.transform_frames` and `align.smooth_transition`; then the gather
    of row n_frames - 1 -> (frames [C, T, n_dim], new_last [C, n_dim])."""
    _emit_args(alphas, eigen, mean, knots, mix_id, t_fn, n_frames, prev_last,
               has_prev)
    basis = bspline.basis_matrix(knots[mix_id], t_fn)
    frames = crowd_back_project_ref(alphas, eigen, mean, basis, mix_id)
    if has_prev:
        q_y, delta = align.node_aligning_2d_transform(prev_last,
                                                      frames[:, 0])
        frames = align.smooth_transition(
            prev_last, align.transform_frames(frames, q_y, delta), window)
    last_idx = torch.clamp(n_frames - 1, min=0).long()
    rows = torch.arange(frames.shape[0], device=frames.device)
    return frames, frames[rows, last_idx]


@_counts_errors
def emit_frames(alphas: torch.Tensor, eigen: torch.Tensor, mean: torch.Tensor,
                knots: torch.Tensor, mix_id: torch.Tensor,
                t_fn: torch.Tensor, n_frames: torch.Tensor,
                prev_last: torch.Tensor, has_prev: bool, window: int):
    """The frame-emit stage of a walk step in one kernel: back-project
    alphas [C, K] at nodes mix_id [C] (eigen [M, n_basis*n_dim, K], mean
    [M, n_basis*n_dim]) on the cubic B-spline of knots [M, n_basis+4] at
    the times t_fn [C, T]; with has_prev align the clip onto prev_last
    [C, n_dim] (heading and XZ position of frame 0) and smooth the seam over
    `window` frames, without it prev_last is None -> (frames [C, T, n_dim],
    new_last [C, n_dim] = row n_frames[c] - 1).  No basis tensor and no
    unaligned frames reach device memory.  A mix_id outside [0, M) gives
    NaN rows."""
    n_basis, n_dim = _emit_args(alphas, eigen, mean, knots, mix_id, t_fn,
                                n_frames, prev_last, has_prev)
    if alphas.device.type == "cpu":
        return emit_frames_ref(alphas, eigen, mean, knots, mix_id, t_fn,
                               n_frames, prev_last, has_prev, window)
    if alphas.device.type != "cuda":
        raise KernelError(f"no kernel for device {alphas.device}")
    alphas, eigen, mean, knots, t_fn = (
        t.contiguous() for t in (alphas, eigen, mean, knots, t_fn))
    _check_cuda("emit_frames", alphas, eigen, mean, knots, t_fn)
    if has_prev:
        prev_last = prev_last.contiguous()
        _check_cuda("emit_frames", alphas, prev_last)
    dev = alphas.device
    mix_id = mix_id.to(device=dev, dtype=torch.long).contiguous()
    n_frames = n_frames.to(device=dev, dtype=torch.int32).contiguous()
    c, k = alphas.shape
    t = t_fn.shape[1]
    out = torch.empty((c, t, n_dim), dtype=torch.float32, device=dev)
    new_last = torch.empty((c, n_dim), dtype=torch.float32, device=dev)
    if c == 0 or t == 0:
        return out, new_last
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        cuda_build.check(lib.mg_emit_frames(
            eigen.data_ptr(), mean.data_ptr(), knots.data_ptr(),
            mix_id.data_ptr(), alphas.data_ptr(), t_fn.data_ptr(),
            n_frames.data_ptr(),
            prev_last.data_ptr() if has_prev else None, out.data_ptr(),
            new_last.data_ptr(), c, eigen.shape[0], k, n_basis, n_dim, t,
            int(bool(has_prev)), int(window), stream), "emit_frames launch")
    _launched("emit_frames")
    return out, new_last


def reset_launch_counts():
    profiling.reset(LAUNCHES)


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    counts = profiling.counters()
    return {k: counts.get(LAUNCHES + k, 0) for k in KERNELS}
