"""Per-step compiled constraint sets and their residuals (port of
morphablegraphs_tpu.constraints.compiled, the families the walk runs).

The residual vector keeps the JAX package's 49-slot layout
[kf(8) | dir | look-at | rel-transform | joint-rot | pose | ca(4) |
 traj(16) | traj-set(16)].  This port evaluates the keyframe slots (on any
joint, position and orientation), the 2D direction and the trajectory.
The other families are rejected at the walk's boundary by the contract
guards below and their slots are 0.

Tensors of a StepConstraints carry a leading [C] axis inside the walk (one
constraint set per character); host-side sets built here hold numpy leaves.
Every residual function writes nothing in place and branches on no tensor
value, so torch.func.jvp / vmap give the exact LM's jacobian through it.
"""

from __future__ import annotations

import dataclasses
import types
from typing import Optional

import numpy as np
import torch

from ..models.skeleton import (Skeleton, _fk_tables, _rest_table, fk_global,
                               fk_node, fk_root)
from ..ops import align, bspline, quat, spline_path

MAX_KF = 8  # padded keyframe-constraint slots per step
TRAJ_SAMPLES = 16  # canonical-frame samples for trajectory residuals
MAX_CA = 4  # collision-avoidance slots per step

_OFF_CA = MAX_KF + 5  # kf | dir | la | rt | jr | pose
_OFF_TRAJ = _OFF_CA + MAX_CA
_OFF_TS = _OFF_TRAJ + TRAJ_SAMPLES
N_RESIDUALS = _OFF_TS + TRAJ_SAMPLES
_O_LIN = MAX_KF + 1  # first trajectory row of the evaluated frames


@dataclasses.dataclass
class StepConstraints:
    """Fixed-size constraint set of one walk step.  For the families this
    port does not evaluate (look-at, relative transform, joint rotation,
    pose, collision avoidance, trajectory set) only the activity flags and
    node indices the contract guards read are kept."""

    kf_active: object  # [K] 0/1
    kf_node: object  # [K] skeleton node index
    kf_pos: object  # [K, 3]
    kf_pos_mask: object  # [K, 3] 1 where constrained
    kf_quat: object  # [K, 4]
    kf_has_quat: object  # [K] 0/1
    kf_frame: object  # [K] canonical keyframe
    kf_weight: object  # [K]
    dir_active: object
    dir_target: object  # [2] normalized (x, z)
    dir_frame: object
    dir_weight: object
    la_active: object
    rt_active: object
    jr_active: object
    pose_active: object
    ca_active: object  # [MAX_CA]
    ca_node: object  # [MAX_CA]
    ts_active: object
    traj_active: object
    traj: Optional[spline_path.PathSpline]
    traj_node: object
    traj_min_arc: object
    traj_weight: object
    traj_range_start: object
    traj_range_end: object
    has_prev: object
    prev_last: object  # [D] last frame of the motion so far
    start_q: object  # [4] start-pose rotation about Y
    start_delta: object  # [3] start-pose translation
    n_canonical: object

    def replace(self, **kw) -> "StepConstraints":
        return dataclasses.replace(self, **kw)


def empty_step_constraints(skeleton: Skeleton,
                           n_canonical: int = 0) -> StepConstraints:
    """Inactive host-side constraint set (numpy leaves)."""
    f32 = np.float32
    return StepConstraints(
        kf_active=np.zeros(MAX_KF, f32), kf_node=np.zeros(MAX_KF, np.int32),
        kf_pos=np.zeros((MAX_KF, 3), f32),
        kf_pos_mask=np.zeros((MAX_KF, 3), f32),
        kf_quat=np.tile(np.array([1.0, 0, 0, 0], f32), (MAX_KF, 1)),
        kf_has_quat=np.zeros(MAX_KF, f32), kf_frame=np.zeros(MAX_KF, f32),
        kf_weight=np.ones(MAX_KF, f32),
        dir_active=f32(0.0), dir_target=np.array([0.0, 1.0], f32),
        dir_frame=f32(0.0), dir_weight=f32(1.0),
        la_active=f32(0.0), rt_active=f32(0.0), jr_active=f32(0.0),
        pose_active=f32(0.0), ca_active=np.zeros(MAX_CA, f32),
        ca_node=np.zeros(MAX_CA, np.int32), ts_active=f32(0.0),
        traj_active=f32(0.0), traj=None, traj_node=np.int32(0),
        traj_min_arc=f32(0.0), traj_weight=f32(1.0),
        traj_range_start=f32(-np.inf), traj_range_end=f32(np.inf),
        has_prev=f32(0.0), prev_last=np.zeros(skeleton.n_frame_params, f32),
        start_q=np.array([1.0, 0, 0, 0], f32), start_delta=np.zeros(3, f32),
        n_canonical=f32(float(n_canonical)))


def from_jax_numpy(sc, device=None, host: bool = False) -> StepConstraints:
    """A JAX StepConstraints with numpy leaves (any leading axes, user
    keyframe slots included) -> the port's StepConstraints on `device`,
    keeping the port's fields.  host=True keeps numpy leaves and drops the
    trajectory: the form of the walk's per-step sets (`step_scs`)."""
    kw = {}
    for f in dataclasses.fields(StepConstraints):
        if f.name == "traj":
            kw["traj"] = (None if host
                          else spline_path.from_jax_numpy(sc.traj, device))
            continue
        a = np.array(getattr(sc, f.name))
        if host:
            kw[f.name] = a
        else:
            t = torch.as_tensor(a, device=device)
            kw[f.name] = t.float() if t.is_floating_point() else t.long()
    return StepConstraints(**kw)


def set_keyframe_constraint(sc: StepConstraints, slot: int,
                            skeleton: Skeleton, joint: str,
                            canonical_keyframe: float, position=None,
                            quat_wxyz=None,
                            weight: float = 1.0) -> StepConstraints:
    """Host-side set (numpy leaves): keyframe slot `slot` on `joint` at a
    canonical frame; NaN position components are unconstrained."""
    pos = np.zeros(3, np.float32)
    mask = np.zeros(3, np.float32)
    if position is not None:
        p = np.asarray(position, np.float32)
        mask = (~np.isnan(p)).astype(np.float32)
        pos = np.where(np.isnan(p), 0.0, p).astype(np.float32)
    q = np.array([1.0, 0, 0, 0], np.float32)
    has_q = 0.0
    if quat_wxyz is not None:
        q = np.asarray(quat_wxyz, np.float32)
        has_q = 1.0

    def put(arr, val):
        out = np.array(arr, copy=True)
        out[slot] = val
        return out

    return sc.replace(
        kf_active=put(sc.kf_active, 1.0),
        kf_node=put(sc.kf_node, skeleton.index_of(joint)),
        kf_pos=put(sc.kf_pos, pos), kf_pos_mask=put(sc.kf_pos_mask, mask),
        kf_quat=put(sc.kf_quat, q), kf_has_quat=put(sc.kf_has_quat, has_q),
        kf_frame=put(sc.kf_frame, float(canonical_keyframe)),
        kf_weight=put(sc.kf_weight, weight))


# ---------------------------------------------------------------------------
# Host-side contract guards (numpy leaves, any leading step axis)
# ---------------------------------------------------------------------------

def _any_active(a) -> bool:
    return bool(np.any(np.asarray(a) > 0))


def _non_kf_families_inactive(step_scs) -> bool:
    """Every family outside the keyframe slots is inactive (the direction
    slot is the walk's own and is not checked)."""
    return not (_any_active(step_scs.la_active)
                or _any_active(step_scs.rt_active)
                or _any_active(step_scs.jr_active)
                or _any_active(step_scs.pose_active)
                or _any_active(step_scs.ca_active)
                or _any_active(step_scs.ts_active))


def step_scs_locomotion_only(step_scs) -> bool:
    """True when the set carries no user slot beyond the locomotion family:
    keyframe slots 2+ and every non-locomotion family inactive."""
    user_kf = np.asarray(step_scs.kf_active)[..., 2:] > 0
    return not bool(np.any(user_kf)) and _non_kf_families_inactive(step_scs)


def step_scs_pallas_ee_only(step_scs, ee_node: int) -> bool:
    """True when the only user slot beyond the locomotion family is keyframe
    slot 2, position-only, on `ee_node`: what the end-effector selection
    kernel (B3) and the frozen-ee LM model."""
    kf_act = np.atleast_2d(np.asarray(step_scs.kf_active) > 0)
    if np.any(kf_act[:, 3:]):
        return False
    slot2 = kf_act[:, 2]
    node = np.atleast_2d(np.asarray(step_scs.kf_node))[:, 2]
    has_q = np.atleast_2d(np.asarray(step_scs.kf_has_quat))[:, 2]
    if np.any(slot2 & ((node != ee_node) | (has_q > 0))):
        return False
    return _non_kf_families_inactive(step_scs)


def step_scs_root_only(step_scs, root_node: int = 0) -> bool:
    """True when every active slot references the root joint."""
    kf_act = np.asarray(step_scs.kf_active) > 0
    if np.any(kf_act & (np.asarray(step_scs.kf_node) != root_node)):
        return False
    ca_act = np.asarray(step_scs.ca_active) > 0
    if np.any(ca_act & (np.asarray(step_scs.ca_node) != root_node)):
        return False
    if np.any((np.asarray(step_scs.traj_active) > 0)
              & (np.asarray(step_scs.traj_node) != root_node)):
        return False
    return not (_any_active(step_scs.la_active)
                or _any_active(step_scs.rt_active)
                or _any_active(step_scs.pose_active)
                or _any_active(step_scs.ts_active))


def frozen_closed_supported(skeleton: Skeleton) -> bool:
    """The closed frozen LM and the selection kernels read the root
    orientation from frame channels 3:7: the root must be animated joint 0."""
    return _fk_tables(skeleton)[0] == 0


# ---------------------------------------------------------------------------
# Masks and aggregation
# ---------------------------------------------------------------------------

def active_mask(sc: StepConstraints) -> torch.Tensor:
    """0/1 mask [..., N_RESIDUALS] over the active residual slots."""
    lead = sc.kf_active.shape[:-1]

    def one(v):
        return torch.as_tensor(v).reshape(lead + (1,))

    return torch.cat([sc.kf_active, one(sc.dir_active), one(sc.la_active),
                      one(sc.rt_active), one(sc.jr_active),
                      one(sc.pose_active), sc.ca_active,
                      one(sc.traj_active).expand(lead + (TRAJ_SAMPLES,)),
                      one(sc.ts_active).expand(lead + (TRAJ_SAMPLES,))],
                     dim=-1)


def static_family_gate(use_traj: bool = True, use_ca: bool = True,
                       use_ts: bool = False) -> np.ndarray:
    """0/1 gate over the residual layout for families compiled out by the
    static use_* flags (multiply into `active_mask` wherever the mask feeds
    an LM residual vector)."""
    gate = np.ones(N_RESIDUALS, np.float32)
    if not use_ca:
        gate[_OFF_CA:_OFF_TRAJ] = 0.0
    if not use_traj:
        gate[_OFF_TRAJ:_OFF_TS] = 0.0
    if not use_ts:
        gate[_OFF_TS:] = 0.0
    return gate


def error_from_residuals(res: torch.Tensor) -> torch.Tensor:
    """Scalar error: the sum of residuals, except the trajectory and
    trajectory-set blocks enter as their mean when any entry is positive."""
    base = torch.sum(res[..., :_OFF_TRAJ], dim=-1)
    traj = res[..., _OFF_TRAJ:_OFF_TS]
    ts = res[..., _OFF_TS:]
    traj_on = (traj > 0).any(-1).to(res.dtype)
    ts_on = (ts > 0).any(-1).to(res.dtype)
    return base + traj_on * traj.mean(-1) + ts_on * ts.mean(-1)


# ---------------------------------------------------------------------------
# Residual heads shared by the exact evaluator and the frozen LM
# ---------------------------------------------------------------------------

def _query_times(sc: StepConstraints) -> torch.Tensor:
    """Canonical times of the evaluated rows [..., MAX_KF + 1 + 16]:
    keyframe slots, the direction frame, the trajectory samples."""
    lin = torch.linspace(0.0, 1.0, TRAJ_SAMPLES, device=sc.kf_frame.device)
    t_lin = lin * torch.clamp(sc.n_canonical - 1.0, min=1.0)[..., None]
    return torch.cat([sc.kf_frame, sc.dir_frame[..., None], t_lin], dim=-1)


def _kf_residuals(sc, jpos, jori):
    pos_err = torch.sqrt(torch.clamp(torch.sum(
        ((jpos - sc.kf_pos) * sc.kf_pos_mask) ** 2, dim=-1), min=1e-12))
    dot = torch.abs(torch.sum(quat.normalize(jori) * sc.kf_quat, dim=-1))
    ang = 2.0 * torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6))
    return sc.kf_active * sc.kf_weight * (pos_err + sc.kf_has_quat * ang)


def _dir_residual(sc, q_dir):
    ref = torch.tensor([0.0, 0.0, 1.0], dtype=q_dir.dtype,
                       device=q_dir.device)
    heading = quat.rotate_vec(quat.normalize(q_dir), ref)
    motion_dir = torch.stack([heading[..., 0], heading[..., 2]], dim=-1)
    motion_dir = motion_dir / torch.clamp(torch.linalg.vector_norm(
        motion_dir, dim=-1, keepdim=True), min=1e-10)
    cos_a = torch.clamp(torch.sum(sc.dir_target * motion_dir, dim=-1),
                        -1.0, 1.0)
    return sc.dir_active * sc.dir_weight * torch.rad2deg(
        torch.arccos(cos_a))


def _layout(kf_res, dir_res, traj_res):
    """Assemble the 49-slot residual vector; excluded families are 0."""
    lead = kf_res.shape[:-1]
    z = kf_res.new_zeros(lead + (4,))  # la | rt | jr | pose
    ca = kf_res.new_zeros(lead + (MAX_CA,))
    ts = kf_res.new_zeros(lead + (TRAJ_SAMPLES,))
    return torch.cat([kf_res, dir_res[..., None], z, ca, traj_res, ts],
                     dim=-1)


def _traj_residuals(sc, dist, in_range):
    return (sc.traj_active * sc.traj_weight)[..., None] \
        * torch.where(in_range, dist, torch.zeros_like(dist))


def _in_range(sc, arcs):
    return (arcs >= sc.traj_range_start[..., None]) \
        & (arcs <= sc.traj_range_end[..., None])


def _at_nodes(table: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Per-node FK rows table [..., T, n_nodes, W] at one node per row,
    node [..., T] -> [..., T, W]."""
    idx = node[..., None, None].expand(node.shape + (1, table.shape[-1]))
    return torch.gather(table, -2, idx)[..., 0, :]


def residuals_from_coeffs(skeleton: Skeleton, knots_s: torch.Tensor,
                          sc: StepConstraints, coeffs: torch.Tensor,
                          root_only: bool = True,
                          use_traj: bool = True) -> torch.Tensor:
    """Residuals [C, N_RESIDUALS] of aligned B-spline coefficients
    coeffs [C, n_basis, D]: the JAX function with use_ca=use_ts=False,
    chain_fk=False.  use_traj=False leaves the trajectory slots 0 and
    skips their closest-point search.

    root_only=True reads the root transform for every slot (valid only when
    every active slot is on the root, `step_scs_root_only`; only channels
    0:7 are read).  root_only=False runs the dense FK pass (`fk_global`)
    over the query frames and reads each keyframe slot at its own joint and
    the trajectory at traj_node."""
    b_all = bspline.basis_matrix(knots_s, _query_times(sc))
    if root_only:
        frames = torch.matmul(b_all, coeffs[..., :7])
        rp, rq = fk_root(skeleton, frames)
        jpos, jori = rp[..., :MAX_KF, :], rq[..., :MAX_KF, :]
        traj_p = rp[..., _O_LIN:, :]
    else:
        frames = torch.matmul(b_all, coeffs)
        pos_all, ori_all = fk_global(skeleton, frames)  # [C, T, nodes, .]
        jpos = _at_nodes(pos_all[..., :MAX_KF, :, :], sc.kf_node)
        jori = _at_nodes(ori_all[..., :MAX_KF, :, :], sc.kf_node)
        traj_node = sc.traj_node[..., None].expand(
            sc.traj_node.shape + (TRAJ_SAMPLES,))
        traj_p = _at_nodes(pos_all[..., _O_LIN:, :, :], traj_node)
    kf_res = _kf_residuals(sc, jpos, jori)
    # the direction reads the frame's root quaternion channels directly
    dir_res = _dir_residual(sc, frames[..., MAX_KF, 3:7])
    if not use_traj:
        return _layout(kf_res, dir_res, kf_res.new_zeros(
            kf_res.shape[:-1] + (TRAJ_SAMPLES,)))
    _, arcs, traj_d = spline_path.closest_points_advancing(
        sc.traj, traj_p, sc.traj_min_arc)
    return _layout(kf_res, dir_res,
                   _traj_residuals(sc, traj_d, _in_range(sc, arcs)))


# ---------------------------------------------------------------------------
# Locomotion slots
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocoSpec:
    """Locomotion goal of one step (per character)."""

    goal_arc: torch.Tensor  # goal arc length on the path
    node: int  # root joint skeleton index
    end_kf: torch.Tensor  # canonical keyframe of the step end
    dim_mask: torch.Tensor  # [3] 1 where the goal component is constrained
    pos_weight: float
    dir_weight: float


def fill_locomotion_slots(sc: StepConstraints, path: spline_path.PathSpline,
                          loco: LocoSpec) -> StepConstraints:
    """Slot 0 := the goal keyframe on the root at the step end, plus the 2D
    direction constraint at the same frame (the half-step slot is not
    ported)."""
    goal, gdir = spline_path.point_and_dir_at_arc_length(path, loco.goal_arc)

    def set0(arr, val):
        out = arr.clone()
        out[:, 0] = val
        return out

    return sc.replace(
        kf_active=set0(sc.kf_active, 1.0), kf_node=set0(sc.kf_node, loco.node),
        kf_pos=set0(sc.kf_pos, goal * loco.dim_mask),
        kf_pos_mask=set0(sc.kf_pos_mask, loco.dim_mask),
        kf_frame=set0(sc.kf_frame, loco.end_kf),
        kf_weight=set0(sc.kf_weight, loco.pos_weight),
        dir_active=torch.ones_like(sc.dir_active), dir_target=gdir,
        dir_frame=loco.end_kf.clone(),
        dir_weight=torch.full_like(sc.dir_weight, loco.dir_weight))


# ---------------------------------------------------------------------------
# Frozen-correspondence LM models
# ---------------------------------------------------------------------------
#
# Both forms freeze the trajectory closest points at the LM iterate (the
# expensive advancing search runs once per iteration, not once per jacobian
# tangent) and keep the 2D alignment exact.  Their contract is the JAX
# package's: every active slot is on the root, or with ee_node, keyframe
# slots may also be on that one end-effector joint (position only,
# `step_scs_pallas_ee_only`, which the walk checks at its crowd boundary:
# the closed form scores a slot on any other joint against the root).

def _align_from(first, s):
    """The step's aligning transform from the latent's first frame `first`
    (its channels 0:7 are read) and the fields of `s`."""
    q_prev, d_prev = align.node_aligning_2d_transform(s.prev_last, first)
    use_prev = (s.has_prev > 0)[..., None]
    return (torch.where(use_prev, q_prev, s.start_q),
            torch.where(use_prev, d_prev, s.start_delta))


def _frozen_traj_residuals(s, rp_lin, pts, in_range):
    d_tr = torch.sqrt(torch.clamp(torch.sum(
        ((rp_lin - pts) * s.dim_mask[..., None, :]) ** 2, dim=-1),
        min=1e-24))
    return _traj_residuals(s, d_tr, in_range)


def make_frozen_root_residuals(skeleton: Skeleton, knots_s: torch.Tensor,
                               sc: StepConstraints, eigen_s: torch.Tensor,
                               mean_s: torch.Tensor, n_basis: int,
                               n_dim: int, k_s: int, ee_node=None):
    """Frozen-correspondence residual model, the linearize form (port of
    the JAX function with use_traj=True, use_ca=False): the spec the closed
    form is tested against, run by the walk with lm_frozen_closed=False.

    Returns make(s_freeze [C, L]) -> residual_fn(s [C, L]) -> [C, R]; the
    LM differentiates residual_fn by forward mode.  With ee_node the
    keyframe rows resolve through `fk_node` at each slot's joint."""
    c = eigen_s.shape[0]
    b_all = bspline.basis_matrix(knots_s, _query_times(sc))  # [C, T, nb]
    be = torch.einsum("ctb,cbdk->ctdk", b_all, eigen_s[..., :k_s].reshape(
        c, n_basis, n_dim, k_s))  # [C, T, D, k]
    bmu = torch.einsum("ctb,cbd->ctd", b_all,
                       mean_s.reshape(c, n_basis, n_dim))
    first_e, first_mu = eigen_s[:, :n_dim, :k_s], mean_s[:, :n_dim]
    s_dim = types.SimpleNamespace(dim_mask=sc.traj.dim_mask(),
                                  traj_active=sc.traj_active,
                                  traj_weight=sc.traj_weight)

    def frames_at(s_lat):
        alpha = s_lat[:, :k_s]
        base = bmu + torch.einsum("ctdk,ck->ctd", be, alpha)
        first = torch.einsum("cdk,ck->cd", first_e, alpha) + first_mu
        return align.transform_frames(base, *_align_from(first, sc))

    def make(s_freeze: torch.Tensor):
        f0 = frames_at(s_freeze)
        rp0, _ = fk_root(skeleton, f0[:, _O_LIN:])
        pts, arcs, _ = spline_path.closest_points_advancing(
            sc.traj, rp0, sc.traj_min_arc)
        in_range = _in_range(sc, arcs)

        def residual_fn(s_lat: torch.Tensor) -> torch.Tensor:
            f = frames_at(s_lat)
            rp, rq = fk_root(skeleton, f)
            if ee_node is None:
                jpos, jori = rp[:, :MAX_KF], rq[:, :MAX_KF]
            else:
                jpos, jori = fk_node(skeleton, f[:, :MAX_KF], sc.kf_node)
            kf_res = _kf_residuals(sc, jpos, jori)
            dir_res = _dir_residual(sc, f[:, MAX_KF, 3:7])
            return _layout(kf_res, dir_res, _frozen_traj_residuals(
                s_dim, rp[:, _O_LIN:], pts, in_range))

        return residual_fn

    return make


def _ee_chain(skeleton: Skeleton, ee_node: int):
    """(chain nodes below the root, root .. ee, and the animated index of
    each animated one) of the end-effector's ancestor chain."""
    anim_idx = _fk_tables(skeleton)
    chain, n = [], int(ee_node)
    while n >= 0:
        chain.append(n)
        n = int(skeleton.parents[n])
    chain = chain[::-1][1:]
    return chain, [anim_idx[n] for n in chain if anim_idx[n] >= 0]


def make_frozen_root_residuals_closed(skeleton: Skeleton,
                                      knots_s: torch.Tensor,
                                      sc: StepConstraints,
                                      eigen_s: torch.Tensor,
                                      mean_s: torch.Tensor, n_basis: int,
                                      n_dim: int, k_s: int, ee_node=None):
    """Frozen-correspondence residual model, value and jacobian in one pass
    (port of the JAX closed form with use_traj=True, use_ca=False).

    The aligned query frames are affine in the latent (rows = bmu + be @ a,
    first = fe @ a + fmu), and the residual heads read only the seven root
    channels 0:7 of each row, plus, with ee_node, the quaternion channels of
    each animated joint on the end-effector's ancestor chain.  So
    J = (dg/dfirst) @ fe + (dg/drows) . be, with the head gradients from one
    reverse-mode jacobian of the cheap head g (torch.func.jacrev, vmapped
    over characters).  With ee_node the head composes the chain in
    fk_global's order over those channels; a slot on ee_node takes the
    chain's transform, every other slot the root's.

    Returns make(s_freeze [C, L]) -> (r_raw [C, R], J_raw [C, R, k_s],
    value_fn) where the trajectory closest points are frozen at s_freeze
    and value_fn(s) evaluates the frozen model at a probe point."""
    if not frozen_closed_supported(skeleton):
        raise ValueError("closed frozen path requires the root to be "
                         "animated joint 0 (fk_root reads channels 3:7)")
    chain, ch_extra = ([], []) if ee_node is None \
        else _ee_chain(skeleton, ee_node)
    ch_idx = list(range(7)) + [3 + 4 * a + j for a in ch_extra
                               for j in range(4)]
    c = eigen_s.shape[0]
    dt, dev = eigen_s.dtype, eigen_s.device
    b_all = bspline.basis_matrix(knots_s, _query_times(sc))  # [C, T, nb]
    e3 = eigen_s[..., :k_s].reshape(c, n_basis, n_dim, k_s)[:, :, ch_idx, :]
    be7 = torch.einsum("ctb,cbhk->cthk", b_all, e3)  # [C, T, nch, k]
    bmu7 = torch.einsum("ctb,cbh->cth", b_all,
                        mean_s.reshape(c, n_basis, n_dim)[:, :, ch_idx])
    fe7 = eigen_s[:, :7, :k_s]  # [C, 7, k]
    fmu7 = mean_s[:, :7]
    off0 = torch.as_tensor(skeleton.offsets[0], dtype=dt, device=dev)
    offs = torch.as_tensor(skeleton.offsets, dtype=dt, device=dev)
    rest = torch.as_tensor(_rest_table(skeleton), dtype=dt, device=dev)
    anim_idx = _fk_tables(skeleton)

    def root_positions(q_y, delta, rows7):
        return off0 + quat.rotate_vec(q_y[..., None, :], rows7[..., :3]) \
            + delta[..., None, :]

    def affine_at(s_lat):
        alpha = s_lat[:, :k_s]
        first7 = torch.einsum("chk,ck->ch", fe7, alpha) + fmu7
        rows7 = bmu7 + torch.einsum("cthk,ck->cth", be7, alpha)
        return first7, rows7

    def ee_transform(jpos, jori, rows_kf):
        """Ancestor-chain FK from the aligned root transform of the keyframe
        rows over their chain channels (quaternions unnormalized)."""
        col = 7
        for node in chain:
            jpos = jpos + quat.rotate_vec(jori, offs[node].expand_as(jpos))
            if anim_idx[node] >= 0:
                local = rows_kf[..., col: col + 4]
                col += 4
            else:
                local = rest[node].expand_as(jori)
            jori = quat.multiply(jori, local)
        return jpos, jori

    def head(first7, rows7, fields, pts, in_range):
        """Residual heads on one character's channel rows (any leading
        axes); `fields` maps the constraint fields the heads read (a dict,
        so torch.func.vmap splits it per character), pts/in_range are the
        frozen trajectory correspondences."""
        s = types.SimpleNamespace(**fields)
        q_y, delta = _align_from(first7, s)
        rp = root_positions(q_y, delta, rows7)
        rq = quat.multiply(q_y[..., None, :], rows7[..., 3:7])
        jpos, jori = rp[..., :MAX_KF, :], rq[..., :MAX_KF, :]
        if ee_node is not None:
            p_ee, q_ee = ee_transform(jpos, jori, rows7[..., :MAX_KF, :])
            is_ee = (s.kf_node == ee_node)[..., None]
            jpos = torch.where(is_ee, p_ee, jpos)
            jori = torch.where(is_ee, q_ee, jori)
        kf_res = _kf_residuals(s, jpos, jori)
        dir_res = _dir_residual(s, rq[..., MAX_KF, :])
        return _layout(kf_res, dir_res, _frozen_traj_residuals(
            s, rp[..., _O_LIN:, :], pts, in_range))

    fields = {n: getattr(sc, n) for n in _HEAD_FIELDS}
    fields["dim_mask"] = sc.traj.dim_mask()
    jac = torch.func.vmap(torch.func.jacrev(head, argnums=(0, 1)))

    def make(s_freeze: torch.Tensor):
        first7_0, rows7_0 = affine_at(s_freeze)
        rp0 = root_positions(*_align_from(first7_0, sc), rows7_0[:, _O_LIN:])
        pts, arcs, _ = spline_path.closest_points_advancing(
            sc.traj, rp0, sc.traj_min_arc)
        in_range = _in_range(sc, arcs)
        r_raw = head(first7_0, rows7_0, fields, pts, in_range)
        j_first, j_rows = jac(first7_0, rows7_0, fields, pts, in_range)
        j_raw = torch.bmm(j_first, fe7) + torch.einsum(
            "crth,cthk->crk", j_rows, be7)

        def value_fn(s_lat):
            return head(*affine_at(s_lat), fields, pts, in_range)

        return r_raw, j_raw, value_fn

    return make


_HEAD_FIELDS = ("kf_active", "kf_node", "kf_weight", "kf_pos",
                "kf_pos_mask", "kf_quat", "kf_has_quat", "dir_active",
                "dir_weight",
                "dir_target", "traj_active", "traj_weight", "has_prev",
                "prev_last", "start_q", "start_delta")
