"""Per-step compiled constraint sets and their residuals (port of
morphablegraphs_tpu.constraints.compiled).

The residual vector keeps the JAX package's 49-slot layout
[kf(8) | dir | look-at | rel-transform | joint-rot | pose | ca(4) |
 traj(16) | traj-set(16)], and every family is evaluated with the JAX
package's formulas, clamps and epsilons: keyframes on any joint (position
and orientation), the 2D direction, look-at, relative transform, joint
rotation, the transition pose, collision avoidance (the min over the
sampled frames), the trajectory and the trajectory set.  The static flags
use_traj / use_ca / use_ts leave a family's slots 0 and skip its work; the
walk refuses a set whose active slots a flag would leave unscored.

Tensors of a StepConstraints carry a leading [C] axis inside the walk (one
constraint set per character); host-side sets built here hold numpy leaves.
Every residual function writes nothing in place and branches on no tensor
value, so torch.func.jvp / vmap give the exact LM's jacobian through it.
"""

from __future__ import annotations

import dataclasses
import functools
import types
from typing import Optional

import numpy as np
import torch

from ..models.primitive import MotionPrimitive, back_project_spatial
from ..models.skeleton import (Skeleton, _fk_tables, _rest_table, fk_global,
                               fk_node, fk_root)
from ..ops import align, bspline, quat, spline_path

MAX_KF = 8  # padded keyframe-constraint slots per step
TRAJ_SAMPLES = 16  # canonical-frame samples for trajectory residuals
MAX_CA = 4  # collision-avoidance slots per step
MAX_TS_JOINTS = 4  # joints in a trajectory-set constraint

_OFF_CA = MAX_KF + 5  # kf | dir | la | rt | jr | pose
_OFF_TRAJ = _OFF_CA + MAX_CA
_OFF_TS = _OFF_TRAJ + TRAJ_SAMPLES
N_RESIDUALS = _OFF_TS + TRAJ_SAMPLES
# rows of the evaluated query frames: [kf(8) | dir | la | rt | jr |
# the 16 trajectory samples, when a sampled family is on]
_R_DIR, _R_LA, _R_RT, _R_JR = MAX_KF, MAX_KF + 1, MAX_KF + 2, MAX_KF + 3
_O_LIN = MAX_KF + 4
_LIN = slice(_O_LIN, _O_LIN + TRAJ_SAMPLES)
# channels of the root form of a frame: the root translation and joint 0's
# quaternion (0:7), then the joint-rotation slot's quaternion block
ROOT_FORM = 11


@dataclasses.dataclass
class StepConstraints:
    """Fixed-size constraint set of one walk step: every field of the JAX
    package's (shapes per set; the walk adds a leading [C] axis).  `traj`
    is None in a host-side set (the walk fills it with the path);
    `ts_trajs` is a PathSpline stack with leading axes [J] (numpy leaves on
    the host)."""

    # keyframe transform constraints (position and/or orientation)
    kf_active: object  # [K] 0/1
    kf_node: object  # [K] skeleton node index
    kf_pos: object  # [K, 3]
    kf_pos_mask: object  # [K, 3] 1 where constrained
    kf_quat: object  # [K, 4]
    kf_has_quat: object  # [K] 0/1
    kf_frame: object  # [K] canonical keyframe
    kf_weight: object  # [K]
    kf_generated: object  # [K] 1 for the walk's own (locomotion) slots
    # 2D direction
    dir_active: object
    dir_target: object  # [2] normalized (x, z)
    dir_frame: object
    dir_weight: object
    # look-at: a joint's gaze (+z) toward a world target at a keyframe
    la_active: object
    la_node: object
    la_target: object  # [3]
    la_frame: object
    la_weight: object
    # transition pose at frame 0: every node's position
    pose_active: object
    pose_points: object  # [n_nodes, 3]
    pose_weight: object
    pose_joint_weights: object  # [n_nodes]
    # trajectory following
    traj_active: object
    traj: Optional[spline_path.PathSpline]
    traj_node: object
    traj_min_arc: object
    traj_weight: object
    traj_range_start: object  # active arc range; inf = unbounded
    traj_range_end: object
    # collision avoidance: the min distance over the sampled frames
    ca_active: object  # [MAX_CA]
    ca_node: object  # [MAX_CA]
    ca_pos: object  # [MAX_CA, 3]
    ca_pos_mask: object  # [MAX_CA, 3]
    ca_weight: object  # [MAX_CA]
    # trajectory set: joint-set centroid against the target centroid
    ts_active: object
    ts_joints: object  # [J] skeleton node indices
    ts_joint_mask: object  # [J] 1 for real joints
    ts_trajs: spline_path.PathSpline  # leading axes [J]
    ts_arc0: object  # [J] starting arc lengths
    ts_weight: object
    # relative transform: a joint's offset in a parent joint's frame
    rt_active: object
    rt_node: object
    rt_parent: object
    rt_offset: object  # [3]
    rt_frame: object
    rt_weight: object
    # joint rotation: an animated joint's local quaternion at a keyframe
    jr_active: object
    jr_joint: object  # animated joint index (frame quaternion block)
    jr_quat: object  # [4]
    jr_frame: object
    jr_weight: object
    # alignment state
    has_prev: object
    prev_last: object  # [D] last frame of the motion so far
    start_q: object  # [4] start-pose rotation about Y
    start_delta: object  # [3] start-pose translation
    n_canonical: object

    def replace(self, **kw) -> "StepConstraints":
        return dataclasses.replace(self, **kw)


@functools.lru_cache(maxsize=1)
def _dummy_ts() -> spline_path.PathSpline:
    """The inactive trajectory-set stack: the JAX package's dummy spline
    (max_points 32, granularity 1000) MAX_TS_JOINTS times, numpy leaves."""
    dummy = spline_path.build(np.array([[0.0, 0, 0], [1.0, 0, 0]]),
                              device="cpu")
    stack = spline_path.stack_host([dummy] * MAX_TS_JOINTS)
    for f in dataclasses.fields(stack):  # shared by every empty set
        getattr(stack, f.name).setflags(write=False)
    return stack


def empty_step_constraints(skeleton: Skeleton,
                           n_canonical: int = 0) -> StepConstraints:
    """Inactive host-side constraint set (numpy leaves), the JAX package's
    defaults."""
    f32 = np.float32
    j = skeleton.n_nodes
    return StepConstraints(
        kf_active=np.zeros(MAX_KF, f32), kf_node=np.zeros(MAX_KF, np.int32),
        kf_pos=np.zeros((MAX_KF, 3), f32),
        kf_pos_mask=np.zeros((MAX_KF, 3), f32),
        kf_quat=np.tile(np.array([1.0, 0, 0, 0], f32), (MAX_KF, 1)),
        kf_has_quat=np.zeros(MAX_KF, f32), kf_frame=np.zeros(MAX_KF, f32),
        kf_weight=np.ones(MAX_KF, f32), kf_generated=np.zeros(MAX_KF, f32),
        dir_active=f32(0.0), dir_target=np.array([0.0, 1.0], f32),
        dir_frame=f32(0.0), dir_weight=f32(1.0),
        la_active=f32(0.0), la_node=np.int32(0), la_target=np.zeros(3, f32),
        la_frame=f32(0.0), la_weight=f32(1.0),
        pose_active=f32(0.0), pose_points=np.zeros((j, 3), f32),
        pose_weight=f32(1.0), pose_joint_weights=np.ones(j, f32),
        traj_active=f32(0.0), traj=None, traj_node=np.int32(0),
        traj_min_arc=f32(0.0), traj_weight=f32(1.0),
        traj_range_start=f32(-np.inf), traj_range_end=f32(np.inf),
        ca_active=np.zeros(MAX_CA, f32), ca_node=np.zeros(MAX_CA, np.int32),
        ca_pos=np.zeros((MAX_CA, 3), f32),
        ca_pos_mask=np.ones((MAX_CA, 3), f32), ca_weight=np.ones(MAX_CA, f32),
        ts_active=f32(0.0), ts_joints=np.zeros(MAX_TS_JOINTS, np.int32),
        ts_joint_mask=np.zeros(MAX_TS_JOINTS, f32), ts_trajs=_dummy_ts(),
        ts_arc0=np.zeros(MAX_TS_JOINTS, f32), ts_weight=f32(1.0),
        rt_active=f32(0.0), rt_node=np.int32(0), rt_parent=np.int32(0),
        rt_offset=np.zeros(3, f32), rt_frame=f32(0.0), rt_weight=f32(1.0),
        jr_active=f32(0.0), jr_joint=np.int32(0),
        jr_quat=np.array([1.0, 0, 0, 0], f32), jr_frame=f32(0.0),
        jr_weight=f32(1.0),
        has_prev=f32(0.0), prev_last=np.zeros(skeleton.n_frame_params, f32),
        start_q=np.array([1.0, 0, 0, 0], f32), start_delta=np.zeros(3, f32),
        n_canonical=f32(float(n_canonical)))


def _tensor(a, device) -> torch.Tensor:
    t = torch.as_tensor(np.array(a), device=device)
    if t.is_floating_point():
        return t.float()
    return t if t.dtype == torch.bool else t.long()


def from_jax_numpy(sc, device=None, host: bool = False) -> StepConstraints:
    """A StepConstraints with numpy leaves (the JAX package's, or a
    host-side set of this module; any leading axes) -> the port's
    StepConstraints of tensors on `device`, every field carried.
    host=True keeps numpy leaves (the trajectory-set stack as a PathSpline
    of numpy leaves with its leading axes) and drops the trajectory: the
    form of the walk's per-step sets (`step_scs`)."""
    kw = {}
    for f in dataclasses.fields(StepConstraints):
        v = getattr(sc, f.name)
        if f.name == "traj":
            kw[f.name] = (None if host or v is None
                          else spline_path.from_jax_numpy(v, device))
        elif f.name == "ts_trajs":
            kw[f.name] = (spline_path.map_leaves(v, np.array) if host
                          else spline_path.from_jax_numpy(v, device))
        else:
            kw[f.name] = np.array(v) if host else _tensor(v, device)
    return StepConstraints(**kw)


# ---------------------------------------------------------------------------
# Host-side builders (numpy leaves, the JAX package's signatures)
# ---------------------------------------------------------------------------

def _np_set(arr, idx, val):
    """Copy of a host-side leaf with one row set."""
    out = np.array(arr, copy=True)
    out[idx] = val
    return out


def set_keyframe_constraint(sc: StepConstraints, slot: int,
                            skeleton: Skeleton, joint: str,
                            canonical_keyframe: float, position=None,
                            quat_wxyz=None, weight: float = 1.0,
                            generated: bool = False) -> StepConstraints:
    """Keyframe slot `slot` on `joint` at a canonical frame; NaN position
    components are unconstrained; generated marks the walk's own slots."""
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
    return sc.replace(
        kf_active=_np_set(sc.kf_active, slot, 1.0),
        kf_node=_np_set(sc.kf_node, slot, skeleton.index_of(joint)),
        kf_pos=_np_set(sc.kf_pos, slot, pos),
        kf_pos_mask=_np_set(sc.kf_pos_mask, slot, mask),
        kf_quat=_np_set(sc.kf_quat, slot, q),
        kf_has_quat=_np_set(sc.kf_has_quat, slot, has_q),
        kf_frame=_np_set(sc.kf_frame, slot, float(canonical_keyframe)),
        kf_weight=_np_set(sc.kf_weight, slot, weight),
        kf_generated=_np_set(sc.kf_generated, slot, float(generated)))


def set_direction_constraint(sc: StepConstraints, dir_xz,
                             canonical_keyframe: float,
                             weight: float = 1.0) -> StepConstraints:
    d = np.asarray(dir_xz, np.float32)
    d = d / max(np.linalg.norm(d), 1e-10)
    return sc.replace(dir_active=np.float32(1.0), dir_target=d,
                      dir_frame=np.float32(canonical_keyframe),
                      dir_weight=np.float32(weight))


def set_look_at_constraint(sc: StepConstraints, skeleton: Skeleton,
                           joint: str, target, canonical_keyframe: float,
                           weight: float = 1.0) -> StepConstraints:
    return sc.replace(la_active=np.float32(1.0),
                      la_node=np.int32(skeleton.index_of(joint)),
                      la_target=np.asarray(target, np.float32),
                      la_frame=np.float32(canonical_keyframe),
                      la_weight=np.float32(weight))


def set_pose_constraint(sc: StepConstraints, skeleton: Skeleton,
                        target_frame, weight: float = 1.0,
                        joint_weights=None) -> StepConstraints:
    """The transition pose: every node's position in target_frame [D] (FK
    on the host); per-node weights from the skeleton's joint_weight_map
    (1 for nodes without an entry) unless joint_weights is given."""
    pts, _ = fk_global(skeleton, torch.as_tensor(
        np.asarray(target_frame, np.float32)))
    if joint_weights is None:
        wmap = skeleton.joint_weight_map
        joint_weights = [wmap.get(n, 1.0) for n in skeleton.node_names]
    return sc.replace(pose_active=np.float32(1.0),
                      pose_points=pts.numpy(),
                      pose_weight=np.float32(weight),
                      pose_joint_weights=np.asarray(joint_weights,
                                                    np.float32))


def set_trajectory_constraint(sc: StepConstraints, skeleton: Skeleton,
                              traj: spline_path.PathSpline, joint: str,
                              min_arc_length: float = 0.0,
                              weight: float = 1.0) -> StepConstraints:
    return sc.replace(traj_active=np.float32(1.0), traj=traj,
                      traj_node=np.int32(skeleton.index_of(joint)),
                      traj_min_arc=np.float32(min_arc_length),
                      traj_weight=np.float32(weight))


def set_relative_transform_constraint(sc: StepConstraints,
                                      skeleton: Skeleton, joint: str,
                                      parent_joint: str, offset,
                                      canonical_keyframe: float,
                                      weight: float = 1.0
                                      ) -> StepConstraints:
    return sc.replace(
        rt_active=np.float32(1.0),
        rt_node=np.int32(skeleton.index_of(joint)),
        rt_parent=np.int32(skeleton.index_of(parent_joint)),
        rt_offset=np.asarray(offset, np.float32),
        rt_frame=np.float32(canonical_keyframe),
        rt_weight=np.float32(weight))


def set_joint_rotation_constraint(sc: StepConstraints, skeleton: Skeleton,
                                  joint: str, quat_wxyz,
                                  canonical_keyframe: float,
                                  weight: float = 1.0) -> StepConstraints:
    return sc.replace(
        jr_active=np.float32(1.0),
        jr_joint=np.int32(skeleton.animated_index_of(joint)),
        jr_quat=np.asarray(quat_wxyz, np.float32),
        jr_frame=np.float32(canonical_keyframe),
        jr_weight=np.float32(weight))


def set_ca_constraint(sc: StepConstraints, skeleton: Skeleton, joint: str,
                      position, weight: float = 1.0,
                      slot: int = 0) -> StepConstraints:
    """Collision-avoidance slot `slot`: `joint`'s closest approach to
    position over the step (NaN components unconstrained)."""
    p = np.asarray(position, np.float32)
    mask = (~np.isnan(p)).astype(np.float32)
    return sc.replace(
        ca_active=_np_set(sc.ca_active, slot, 1.0),
        ca_node=_np_set(sc.ca_node, slot, skeleton.index_of(joint)),
        ca_pos=_np_set(sc.ca_pos, slot, np.where(np.isnan(p), 0.0, p)),
        ca_pos_mask=_np_set(sc.ca_pos_mask, slot, mask),
        ca_weight=_np_set(sc.ca_weight, slot, weight))


def set_trajectory_set_constraint(sc: StepConstraints, skeleton: Skeleton,
                                  joints, trajs, arc0=None,
                                  weight: float = 1.0) -> StepConstraints:
    """Joint-set trajectory constraint: up to MAX_TS_JOINTS joints, each
    following its own PathSpline (built with the same max_points and
    granularity, so they stack); padded with copies of the last spline."""
    n = len(joints)
    if not 0 < n <= MAX_TS_JOINTS or len(trajs) != n:
        raise ValueError(f"1..{MAX_TS_JOINTS} joints, one spline each")
    idx = np.zeros(MAX_TS_JOINTS, np.int32)
    mask = np.zeros(MAX_TS_JOINTS, np.float32)
    for i, j in enumerate(joints):
        idx[i] = skeleton.index_of(j)
        mask[i] = 1.0
    padded = list(trajs) + [trajs[-1]] * (MAX_TS_JOINTS - n)
    arcs = np.zeros(MAX_TS_JOINTS, np.float32)
    if arc0 is not None:
        arcs[:n] = np.asarray(arc0, np.float32)[:n]
    return sc.replace(ts_active=np.float32(1.0), ts_joints=idx,
                      ts_joint_mask=mask,
                      ts_trajs=spline_path.stack_host(padded), ts_arc0=arcs,
                      ts_weight=np.float32(weight))


def set_trajectory_active_range(sc: StepConstraints, start: float,
                                end: float) -> StepConstraints:
    return sc.replace(traj_range_start=np.float32(start),
                      traj_range_end=np.float32(end))


def set_alignment_from_prev(sc: StepConstraints,
                            prev_last) -> StepConstraints:
    return sc.replace(has_prev=np.float32(1.0),
                      prev_last=np.asarray(prev_last, np.float32))


def set_alignment_from_start_pose(sc: StepConstraints, position,
                                  orientation_y_deg: float
                                  ) -> StepConstraints:
    """The fixed start-pose transform: NaN position components -> 0, a
    rotation about +Y by the heading in degrees."""
    pos = np.asarray(position, np.float32)
    pos = np.where(np.isnan(pos), 0.0, pos)
    half = 0.5 * np.deg2rad(float(orientation_y_deg))
    q = np.array([np.cos(half), 0.0, np.sin(half), 0.0], np.float32)
    return sc.replace(has_prev=np.float32(0.0), start_q=q, start_delta=pos)


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
    """True when every active slot references the root joint.  Direction
    and joint rotation read frame channels directly and are allowed;
    look-at, relative transform, pose and trajectory set read other
    joints' FK and must be inactive."""
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


def active_families(sc: StepConstraints) -> frozenset:
    """The single-slot families with an active slot in a host-side set:
    names among "dir", "la", "rt", "jr", "pose" (residuals_from_coeffs'
    `families`)."""
    return frozenset(name for name, v in (
        ("dir", sc.dir_active), ("la", sc.la_active), ("rt", sc.rt_active),
        ("jr", sc.jr_active), ("pose", sc.pose_active)) if _any_active(v))


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

def _query_times(sc: StepConstraints, need_lin: bool) -> torch.Tensor:
    """Canonical times of the evaluated rows [..., 12 (+ 16)]: keyframe
    slots, the direction, look-at, relative-transform and joint-rotation
    frames, then the trajectory samples when a sampled family is on."""
    parts = [sc.kf_frame] + [v[..., None] for v in (
        sc.dir_frame, sc.la_frame, sc.rt_frame, sc.jr_frame)]
    if need_lin:
        lin = torch.linspace(0.0, 1.0, TRAJ_SAMPLES,
                             device=sc.kf_frame.device)
        parts.append(lin * torch.clamp(sc.n_canonical - 1.0,
                                       min=1.0)[..., None])
    return torch.cat(parts, dim=-1)


def _kf_residuals(sc, jpos, jori):
    pos_err = torch.sqrt(torch.clamp(torch.sum(
        ((jpos - sc.kf_pos) * sc.kf_pos_mask) ** 2, dim=-1), min=1e-12))
    dot = torch.abs(torch.sum(quat.normalize(jori) * sc.kf_quat, dim=-1))
    ang = 2.0 * torch.arccos(torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6))
    return sc.kf_active * sc.kf_weight * (pos_err + sc.kf_has_quat * ang)


def _forward(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)


def _dir_residual(sc, q_dir):
    heading = quat.rotate_vec(quat.normalize(q_dir), _forward(q_dir))
    motion_dir = torch.stack([heading[..., 0], heading[..., 2]], dim=-1)
    motion_dir = motion_dir / torch.clamp(torch.linalg.vector_norm(
        motion_dir, dim=-1, keepdim=True), min=1e-10)
    cos_a = torch.clamp(torch.sum(sc.dir_target * motion_dir, dim=-1),
                        -1.0, 1.0)
    return sc.dir_active * sc.dir_weight * torch.rad2deg(
        torch.arccos(cos_a))


def _look_at_residual(sc, head_pos, head_ori):
    """Gaze angle (degrees) of the joint's +z axis toward la_target."""
    gaze = quat.rotate_vec(quat.normalize(head_ori), _forward(head_ori))
    want = sc.la_target - head_pos
    want = want / torch.clamp(torch.linalg.vector_norm(
        want, dim=-1, keepdim=True), min=1e-10)
    cos_la = torch.clamp(torch.sum(gaze * want, dim=-1), -1.0, 1.0)
    return sc.la_active * sc.la_weight * torch.rad2deg(torch.arccos(cos_la))


def _rel_transform_residual(sc, node_pos, parent_pos, parent_ori):
    target = parent_pos + quat.rotate_vec(quat.normalize(parent_ori),
                                          sc.rt_offset)
    diff = node_pos - target
    # sqrt(x + eps): the inactive default is exactly 0, where the norm's
    # gradient is NaN and would poison the LM jacobian through 0 * NaN
    return sc.rt_active * sc.rt_weight * torch.sqrt(
        torch.sum(diff * diff, dim=-1) + 1e-12)


def _jr_residual(sc, q_local):
    dot = torch.abs(torch.sum(quat.normalize(q_local) * sc.jr_quat, dim=-1))
    return sc.jr_active * sc.jr_weight * 2.0 * torch.arccos(
        torch.clamp(dot, -1.0 + 1e-6, 1.0 - 1e-6))


def _pose_residual(sc, pose_pos):
    diff = pose_pos - sc.pose_points
    pose_d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)
    w = sc.pose_joint_weights
    err = torch.sum(w * pose_d, dim=-1) / torch.clamp(torch.sum(w, dim=-1),
                                                      min=1e-6)
    return sc.pose_active * sc.pose_weight * err


def _ca_residuals(sc, jca):
    """Collision avoidance: jca [..., S, MAX_CA, 3] joint positions over
    the samples -> [..., MAX_CA], the min distance to each target (amin
    splits its derivative over ties evenly, as jnp.min)."""
    d = torch.sqrt(torch.clamp(torch.sum(
        ((jca - sc.ca_pos[..., None, :, :])
         * sc.ca_pos_mask[..., None, :, :]) ** 2, dim=-1), min=1e-12))
    return sc.ca_active * sc.ca_weight * torch.amin(d, dim=-2)


def _ts_targets(sp: spline_path.PathSpline, arcs: torch.Tensor):
    """Points of a trajectory-set stack at per-sample arcs [..., S, J] ->
    (points [..., S, J, 3], each spline's full arc [..., 1, J]).  The
    stack's leading axes are [..., J], or [c, J] for fewer rows c than the
    residual rows R: row r then reads stack row r // (R / c) (the general
    selection path repeats each character's set over its candidates and
    keeps one stack per character)."""
    s_, j = arcs.shape[-2:]
    lead = arcs.shape[:-2]
    rows = int(np.prod(lead, dtype=np.int64))
    sp_lead = sp.n_points.shape
    c = int(np.prod(sp_lead[:-1], dtype=np.int64))
    if sp_lead[-1] != j or rows % c:
        raise ValueError(f"trajectory-set splines {tuple(sp_lead)} do not "
                         f"group the residual rows {tuple(lead)}")
    m = rows // c
    flat = spline_path.map_leaves(
        sp, lambda v: v.reshape((c, j) + v.shape[len(sp_lead):]))
    q = arcs.reshape(c, m, s_, j).permute(0, 3, 1, 2).reshape(c, j, m * s_)
    pts = spline_path.point_at_arc_length(flat, q)  # [c, J, m*S, 3]
    pts = pts.reshape(c, j, m, s_, 3).permute(0, 2, 3, 1, 4)
    full = flat.full_arc_length[:, None, :].expand(c, m, j)
    return pts.reshape(lead + (s_, j, 3)), full.reshape(lead + (1, j))


def _ts_residuals(sc, pos_ts):
    """Trajectory set: joint positions pos_ts [..., S, J, 3] over the
    samples; each joint's arc advances by its own travelled distance.  A
    joint whose arc ran off its spline drops out of both centroids (the
    JAX package's deliberate deviation from the reference, PARITY.md)."""
    steps_d = torch.sqrt(torch.sum(
        (pos_ts[..., 1:, :, :] - pos_ts[..., :-1, :, :]) ** 2, dim=-1)
        + 1e-12)  # [..., S-1, J]
    travelled = torch.cat([torch.zeros_like(steps_d[..., :1, :]),
                           torch.cumsum(steps_d, dim=-2)], dim=-2)
    arcs = sc.ts_arc0[..., None, :] + travelled  # [..., S, J]
    targets, full = _ts_targets(sc.ts_trajs, arcs)
    active = (arcs <= full).to(pos_ts.dtype) * sc.ts_joint_mask[..., None, :]
    w = active / torch.clamp(torch.sum(active, dim=-1, keepdim=True),
                             min=1e-6)
    diff = torch.sum(pos_ts * w[..., None], dim=-2) \
        - torch.sum(targets * w[..., None], dim=-2)
    d = torch.sqrt(torch.sum(diff * diff, dim=-1) + 1e-12)  # [..., S]
    any_active = (torch.sum(active, dim=-1) > 0).to(d.dtype)
    return (sc.ts_active * sc.ts_weight)[..., None] * any_active * d


def _traj_residuals(sc, dist, in_range):
    return (sc.traj_active * sc.traj_weight)[..., None] \
        * torch.where(in_range, dist, torch.zeros_like(dist))


def _in_range(sc, arcs):
    return (arcs >= sc.traj_range_start[..., None]) \
        & (arcs <= sc.traj_range_end[..., None])


def _layout(kf, dir_, la=None, rt=None, jr=None, pose=None, ca=None,
            traj=None, ts=None) -> torch.Tensor:
    """Assemble the 49-slot residual vector; a family left out is 0."""
    lead = kf.shape[:-1]

    def block(v, n):
        return kf.new_zeros(lead + (n,)) if v is None else v.expand(
            lead + (n,))

    def one(v):
        return block(None if v is None else v[..., None], 1)

    return torch.cat([kf, one(dir_), one(la), one(rt), one(jr), one(pose),
                      block(ca, MAX_CA), block(traj, TRAJ_SAMPLES),
                      block(ts, TRAJ_SAMPLES)], dim=-1)


def _pick(table: torch.Tensor, node: torch.Tensor) -> torch.Tensor:
    """Per-node FK rows table [..., Q, n_nodes, W] at node [..., Q|1, N]
    (broadcast against the rows) -> [..., Q, N, W]."""
    lead = table.shape[:-2]
    idx = node.expand(lead + node.shape[-1:])
    return torch.gather(table, -2, idx[..., None].expand(
        idx.shape + table.shape[-1:]))


def _quat_block(row: torch.Tensor, joint: torch.Tensor) -> torch.Tensor:
    """The quaternion of animated joint `joint` [...] in frame rows
    row [..., D] -> [..., 4]."""
    lead = row.shape[:-1]
    quats = row[..., 3:].reshape(lead + (-1, 4))
    idx = joint.expand(lead)[..., None, None].expand(lead + (1, 4))
    return torch.gather(quats, -2, idx)[..., 0, :]


def root_form_channels(jr_joint: torch.Tensor) -> torch.Tensor:
    """Frame channels of the root form [..., ROOT_FORM]: 0:7 (the root
    translation and joint 0's quaternion) and the quaternion block of the
    joint-rotation slot's joint, 3 + 4 * jr_joint."""
    dev = jr_joint.device
    base = torch.arange(7, device=dev).expand(jr_joint.shape + (7,))
    blk = 3 + 4 * jr_joint.long()[..., None] + torch.arange(4, device=dev)
    return torch.cat([base, blk], dim=-1)


def _fk_access(skeleton: Skeleton, frames: torch.Tensor, root_only: bool,
               chain_fk: bool):
    """The FK reads of one mode over the query frames [..., T + 1, W]:
    (at(rows, node) -> (pos [..., Q, N, 3], ori [..., Q, N, 4]) of nodes
    node [..., Q|1, N] at the rows `rows` (a slice), pose_nodes() -> every
    node's position [..., n_nodes, 3] at the last (pose) row, None for
    root_only)."""
    if root_only:
        # every node resolves to the root's transform (by contract only
        # root slots are active); broadcast, never materialized per node
        rp, rq = fk_root(skeleton, frames[..., :7])

        def at(rows, node):
            p, q = rp[..., rows, None, :], rq[..., rows, None, :]
            shape = torch.broadcast_shapes(p.shape[:-1], node.shape)
            return p.expand(shape + (3,)), q.expand(shape + (4,))

        pose_nodes = None  # the pose is inactive by contract
    elif not chain_fk:
        pos_all, ori_all = fk_global(skeleton, frames)

        def at(rows, node):
            return (_pick(pos_all[..., rows, :, :], node),
                    _pick(ori_all[..., rows, :, :], node))

        def pose_nodes():
            return pos_all[..., -1, :, :]
    else:
        # ancestor-chain FK of each queried joint; the pose reads every
        # node at one frame, so it runs the full pass on that frame only
        def at(rows, node):
            return fk_node(skeleton, frames[..., rows, None, :], node)

        def pose_nodes():
            return fk_global(skeleton, frames[..., -1, :])[0]
    return at, pose_nodes


def residuals_from_coeffs(skeleton: Skeleton, knots_s: torch.Tensor,
                          sc: StepConstraints, coeffs: torch.Tensor,
                          use_traj: bool = True, use_ca: bool = True,
                          use_ts: bool = False, root_only: bool = False,
                          chain_fk: bool = False,
                          families=None) -> torch.Tensor:
    """Residuals [..., N_RESIDUALS] of aligned B-spline coefficients
    coeffs [..., n_basis, D] (the set's leading axes).  use_traj / use_ca /
    use_ts=False leave that family's slots 0 and skip its work; a set
    without a trajectory spline (traj None) leaves the trajectory slots 0.

    Every family reads one basis evaluation at the query rows [kf(8) | dir
    | la | rt | jr | 16 samples if traj/ca/ts] plus the pose row
    coeffs[..., 0, :] (a clamped spline's first coefficient is its first
    frame), through one FK mode:
      * root_only=True reads the root transform for every slot (valid only
        when every active slot is on the root, `step_scs_root_only`: the
        look-at, relative-transform and pose slots are inactive, and are
        left 0 unevaluated).  It reads the root form only
        (`root_form_channels`; coeffs may come in that form already,
        [..., n_basis, ROOT_FORM]): the joint-rotation slot still reads its
        own joint's quaternion;
      * the dense FK pass (`fk_global`) over every query row, the default;
      * chain_fk=True: each query through its joint's ancestor chain
        (`fk_node`), the pose through one full pass over its row.
    families (a set of "dir", "la", "rt", "jr", "pose", or None for all)
    names the single-slot families to evaluate; the others are left 0
    unevaluated, which is their value when the caller knows them
    inactive (`active_families`)."""
    need_lin = use_traj or use_ca or use_ts
    b_all = bspline.basis_matrix(knots_s, _query_times(sc, need_lin))
    if root_only:
        if _fk_tables(skeleton)[0] > 0:
            raise ValueError("root_only reads the root from channels 3:7: "
                             "the root must be animated joint 0 or not "
                             "animated")
        if coeffs.shape[-1] != ROOT_FORM:
            ch = root_form_channels(sc.jr_joint)
            lead = torch.broadcast_shapes(coeffs.shape[:-2], ch.shape[:-1])
            coeffs = torch.gather(
                coeffs.expand(lead + coeffs.shape[-2:]), -1,
                ch[..., None, :].expand(lead + (coeffs.shape[-2], ROOT_FORM)))
    frames = torch.cat([torch.matmul(b_all, coeffs), coeffs[..., :1, :]],
                       dim=-2)
    at, pose_nodes = _fk_access(skeleton, frames, root_only, chain_fk)

    def one_node(node):
        return node[..., None, None]

    def wanted(name):
        return families is None or name in families

    jpos, jori = at(slice(0, MAX_KF), sc.kf_node[..., None])
    kf = _kf_residuals(sc, jpos[..., 0, :], jori[..., 0, :])
    # the direction reads joint 0's quaternion channels directly
    dir_ = _dir_residual(sc, frames[..., _R_DIR, 3:7]) if wanted("dir") \
        else None
    la = rt = pose = jr = None
    if not root_only:  # else inactive by contract: their slots are 0
        if wanted("la"):
            hp, ho = at(slice(_R_LA, _R_LA + 1), one_node(sc.la_node))
            la = _look_at_residual(sc, hp[..., 0, 0, :], ho[..., 0, 0, :])
        if wanted("rt"):
            rows_rt = slice(_R_RT, _R_RT + 1)
            pp, po = at(rows_rt, one_node(sc.rt_parent))
            npos, _ = at(rows_rt, one_node(sc.rt_node))
            rt = _rel_transform_residual(sc, npos[..., 0, 0, :],
                                         pp[..., 0, 0, :], po[..., 0, 0, :])
        if wanted("pose"):
            pose = _pose_residual(sc, pose_nodes())
    if wanted("jr"):
        row_jr = frames[..., _R_JR, :]
        if root_only:  # joint 0's block is the aligned 3:7, any other 7:11
            q_jr = torch.where((sc.jr_joint == 0)[..., None],
                               row_jr[..., 3:7], row_jr[..., 7:11])
        else:
            q_jr = _quat_block(row_jr, sc.jr_joint)
        jr = _jr_residual(sc, q_jr)

    traj = ca = ts = None
    if use_traj and sc.traj is not None:
        tp, _ = at(_LIN, one_node(sc.traj_node))
        _, arcs, dist = spline_path.closest_points_advancing(
            sc.traj, tp[..., 0, :], sc.traj_min_arc)
        traj = _traj_residuals(sc, dist, _in_range(sc, arcs))
    if use_ca:
        ca = _ca_residuals(sc, at(_LIN, sc.ca_node[..., None, :])[0])
    if use_ts:
        ts = _ts_residuals(sc, at(_LIN, sc.ts_joints[..., None, :])[0])
    return _layout(kf, dir_, la, rt, jr, pose, ca, traj, ts)


# ---------------------------------------------------------------------------
# Single-primitive entry points
# ---------------------------------------------------------------------------

def _align_from(first, s):
    """The step's aligning transform from the latent's first frame `first`
    (its channels 0:7 are read) and the fields of `s`."""
    q_prev, d_prev = align.node_aligning_2d_transform(s.prev_last, first)
    use_prev = (s.has_prev > 0)[..., None]
    return (torch.where(use_prev, q_prev, s.start_q),
            torch.where(use_prev, d_prev, s.start_delta))


def _as_tensors(sc: StepConstraints, device) -> StepConstraints:
    if isinstance(sc.kf_active, torch.Tensor):
        return sc
    return from_jax_numpy(sc, device)


def aligned_coeffs(prim: MotionPrimitive, s: torch.Tensor,
                   sc: StepConstraints) -> torch.Tensor:
    """Back-project the spatial part of latents s [..., L] and apply the
    step's aligning transform to the coefficient rows -> [..., n_basis,
    n_dim].  Exact: the transform is linear in the frames and a B-spline's
    basis rows sum to 1.  With has_prev the transform comes from the
    candidate's own first frame, so it is differentiable in s."""
    coeffs = back_project_spatial(prim, s[..., : prim.n_spatial])
    q_y, delta = _align_from(coeffs[..., 0, :], sc)
    return align.transform_frames(coeffs, q_y, delta)


def evaluate_residuals(skeleton: Skeleton, prim: MotionPrimitive,
                       sc: StepConstraints, s: torch.Tensor,
                       use_traj: bool = True, use_ca: bool = True,
                       use_ts: bool = False, chain_fk: bool = False,
                       families=None, root_only: bool = False
                       ) -> torch.Tensor:
    """Residual vector [N_RESIDUALS] of a latent s [L] of one primitive
    under a constraint set (numpy leaves or tensors); leading axes on s
    need the same on the set.  Inactive slots are 0.  chain_fk, families
    and root_only as in residuals_from_coeffs."""
    sc = _as_tensors(sc, s.device)
    return residuals_from_coeffs(skeleton, prim.knots_s, sc,
                                 aligned_coeffs(prim, s, sc),
                                 use_traj=use_traj, use_ca=use_ca,
                                 use_ts=use_ts, root_only=root_only,
                                 chain_fk=chain_fk, families=families)


def evaluate_error(skeleton: Skeleton, prim: MotionPrimitive,
                   sc: StepConstraints, s: torch.Tensor,
                   use_traj: bool = True, use_ca: bool = True,
                   use_ts: bool = False) -> torch.Tensor:
    """Scalar constraint error (see error_from_residuals)."""
    return error_from_residuals(evaluate_residuals(
        skeleton, prim, sc, s, use_traj=use_traj, use_ca=use_ca,
        use_ts=use_ts))


# ---------------------------------------------------------------------------
# Locomotion slots
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LocoSpec:
    """Locomotion goals of one step, per character: the end goal and the
    half step on the path and their canonical keyframes."""

    goal_arc: torch.Tensor  # goal arc length on the path
    half_arc: torch.Tensor  # half-step arc length
    node: int  # root joint skeleton index
    end_kf: torch.Tensor  # canonical keyframe of the step end
    mid_kf: torch.Tensor  # canonical keyframe of the step middle
    dim_mask: torch.Tensor  # [3] 1 where the goal component is constrained
    pos_weight: float
    dir_weight: float


def fill_locomotion_slots(sc: StepConstraints, path: spline_path.PathSpline,
                          loco: LocoSpec, use_pos: bool = True,
                          use_dir: bool = True,
                          use_half: bool = False) -> StepConstraints:
    """The walk's own slots from path queries, marked generated: slot 0 :=
    the end goal on the root (use_pos), the half step in slot 1 (slot 0
    without use_pos), and the 2D direction at the end keyframe (use_dir)."""
    goal, gdir = spline_path.point_and_dir_at_arc_length(path, loco.goal_arc)
    goals = []
    if use_pos:
        goals.append((0, goal, loco.end_kf))
    if use_half:
        half, _ = spline_path.point_and_dir_at_arc_length(path,
                                                          loco.half_arc)
        goals.append((1 if use_pos else 0, half, loco.mid_kf))
    names = ("kf_active", "kf_node", "kf_pos", "kf_pos_mask", "kf_frame",
             "kf_weight", "kf_generated")
    kf = {n: getattr(sc, n).clone() for n in names}
    for slot, pos, frame in goals:
        for name, val in (("kf_active", 1.0), ("kf_node", loco.node),
                          ("kf_pos", pos * loco.dim_mask),
                          ("kf_pos_mask", loco.dim_mask),
                          ("kf_frame", frame), ("kf_weight", loco.pos_weight),
                          ("kf_generated", 1.0)):
            kf[name][:, slot] = val
    sc = sc.replace(**kf)
    if use_dir:
        sc = sc.replace(
            dir_active=torch.ones_like(sc.dir_active), dir_target=gdir,
            dir_frame=loco.end_kf.clone(),
            dir_weight=torch.full_like(sc.dir_weight, loco.dir_weight))
    return sc


# ---------------------------------------------------------------------------
# Frozen-correspondence LM models
# ---------------------------------------------------------------------------
#
# Both forms freeze the trajectory closest points at the LM iterate (the
# expensive advancing search runs once per iteration, not once per jacobian
# tangent) and keep the 2D alignment exact.  They evaluate the keyframe,
# direction, joint-rotation, collision-avoidance (use_ca) and trajectory
# (use_traj) rows.  Their contract is the JAX package's: every active slot is
# on the root (joint rotation reads frame channels and may be on any joint),
# or with ee_node, keyframe slots may also be on that one end-effector joint
# (position only, `step_scs_pallas_ee_only`, which the walk checks at its
# crowd boundary: the closed form scores a slot on any other joint against
# the root).

def _frozen_traj_residuals(s, rp_lin, pts, in_range):
    d_tr = torch.sqrt(torch.clamp(torch.sum(
        ((rp_lin - pts) * s.dim_mask[..., None, :]) ** 2, dim=-1),
        min=1e-24))
    return _traj_residuals(s, d_tr, in_range)


def make_frozen_root_residuals(skeleton: Skeleton, knots_s: torch.Tensor,
                               sc: StepConstraints, eigen_s: torch.Tensor,
                               mean_s: torch.Tensor, n_basis: int,
                               n_dim: int, k_s: int, use_traj: bool = True,
                               use_ca: bool = False, ee_node=None):
    """Frozen-correspondence residual model, the linearize form: the spec
    the closed form is tested against, run by the walk with
    lm_frozen_closed=False.

    Returns make(s_freeze [C, L]) -> residual_fn(s [C, L]) -> [C, R]; the
    LM differentiates residual_fn by forward mode.  With ee_node the
    keyframe rows resolve through `fk_node` at each slot's joint."""
    c = eigen_s.shape[0]
    b_all = bspline.basis_matrix(knots_s, _query_times(
        sc, use_traj or use_ca))  # [C, T, nb]
    be = torch.einsum("ctb,cbdk->ctdk", b_all, eigen_s[..., :k_s].reshape(
        c, n_basis, n_dim, k_s))  # [C, T, D, k]
    bmu = torch.einsum("ctb,cbd->ctd", b_all,
                       mean_s.reshape(c, n_basis, n_dim))
    first_e, first_mu = eigen_s[:, :n_dim, :k_s], mean_s[:, :n_dim]
    s_dim = types.SimpleNamespace(
        dim_mask=sc.traj.dim_mask() if use_traj else None,
        traj_active=sc.traj_active, traj_weight=sc.traj_weight)

    def frames_at(s_lat):
        alpha = s_lat[:, :k_s]
        base = bmu + torch.einsum("ctdk,ck->ctd", be, alpha)
        first = torch.einsum("cdk,ck->cd", first_e, alpha) + first_mu
        return align.transform_frames(base, *_align_from(first, sc))

    def make(s_freeze: torch.Tensor):
        if use_traj:
            rp0, _ = fk_root(skeleton, frames_at(s_freeze)[:, _LIN])
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
            traj = ca = None
            if use_traj:
                traj = _frozen_traj_residuals(s_dim, rp[:, _LIN], pts,
                                              in_range)
            if use_ca:
                ca = _ca_residuals(sc, rp[:, _LIN, None, :])
            return _layout(
                _kf_residuals(sc, jpos, jori),
                _dir_residual(sc, f[:, _R_DIR, 3:7]),
                jr=_jr_residual(sc, _quat_block(f[:, _R_JR], sc.jr_joint)),
                ca=ca, traj=traj)

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
                                      n_dim: int, k_s: int,
                                      use_traj: bool = True,
                                      use_ca: bool = False, ee_node=None):
    """Frozen-correspondence residual model, value and jacobian in one pass.

    The aligned query frames are affine in the latent (rows = bmu + be @ a,
    first = fe @ a + fmu), and the residual heads read only the seven root
    channels 0:7 of each row, plus, with ee_node, the quaternion channels of
    each animated joint on the end-effector's ancestor chain, plus the
    joint-rotation slot's quaternion block of its row (jrq = jr_mu +
    jr_map @ a, gathered per character: jr_joint differs between them).
    So J = (dg/dfirst) @ fe + (dg/drows) . be + (dg/djrq) @ jr_map, with the
    head gradients from one reverse-mode jacobian of the cheap head g
    (torch.func.jacrev, vmapped over characters).  With ee_node the head
    composes the chain in fk_global's order over those channels; a slot on
    ee_node takes the chain's transform, every other slot the root's.

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
    b_all = bspline.basis_matrix(knots_s, _query_times(
        sc, use_traj or use_ca))  # [C, T, nb]
    e4 = eigen_s[..., :k_s].reshape(c, n_basis, n_dim, k_s)
    m3 = mean_s.reshape(c, n_basis, n_dim)
    be7 = torch.einsum("ctb,cbhk->cthk", b_all, e4[:, :, ch_idx, :])
    bmu7 = torch.einsum("ctb,cbh->cth", b_all, m3[:, :, ch_idx])
    jr_ch = 3 + 4 * sc.jr_joint.long()[:, None] \
        + torch.arange(4, device=dev)  # [C, 4]
    jr_map = torch.gather(
        torch.einsum("cb,cbdk->cdk", b_all[:, _R_JR], e4), 1,
        jr_ch[..., None].expand(c, 4, k_s))  # [C, 4, k]
    jr_mu = torch.gather(torch.einsum("cb,cbd->cd", b_all[:, _R_JR], m3), 1,
                         jr_ch)  # [C, 4]
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
        jrq = jr_mu + torch.einsum("cqk,ck->cq", jr_map, alpha)
        return first7, rows7, jrq

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

    def head(first7, rows7, jrq, fields, frozen):
        """Residual heads on one character's channel rows (any leading
        axes); `fields` maps the constraint fields the heads read and
        `frozen` the trajectory correspondences (dicts, so torch.func.vmap
        splits them per character)."""
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
        # joint 0's block is the aligned root rotation row; any other
        # joint's passes through the alignment
        q_jr = torch.where((s.jr_joint == 0)[..., None], rq[..., _R_JR, :],
                           jrq)
        traj = ca = None
        if use_traj:
            traj = _frozen_traj_residuals(s, rp[..., _LIN, :],
                                          frozen["pts"], frozen["in_range"])
        if use_ca:
            ca = _ca_residuals(s, rp[..., _LIN, None, :])
        return _layout(_kf_residuals(s, jpos, jori),
                       _dir_residual(s, rq[..., _R_DIR, :]),
                       jr=_jr_residual(s, q_jr), ca=ca, traj=traj)

    fields = {n: getattr(sc, n) for n in _HEAD_FIELDS}
    if use_traj:
        fields["dim_mask"] = sc.traj.dim_mask()
    jac = torch.func.vmap(torch.func.jacrev(head, argnums=(0, 1, 2)))

    def make(s_freeze: torch.Tensor):
        first7_0, rows7_0, jrq_0 = affine_at(s_freeze)
        frozen = {}
        if use_traj:
            rp0 = root_positions(*_align_from(first7_0, sc),
                                 rows7_0[:, _LIN])
            pts, arcs, _ = spline_path.closest_points_advancing(
                sc.traj, rp0, sc.traj_min_arc)
            frozen = dict(pts=pts, in_range=_in_range(sc, arcs))
        r_raw = head(first7_0, rows7_0, jrq_0, fields, frozen)
        j_first, j_rows, j_jr = jac(first7_0, rows7_0, jrq_0, fields, frozen)
        j_raw = torch.bmm(j_first, fe7) + torch.einsum(
            "crth,cthk->crk", j_rows, be7) + torch.bmm(j_jr, jr_map)

        def value_fn(s_lat):
            return head(*affine_at(s_lat), fields, frozen)

        return r_raw, j_raw, value_fn

    return make


_HEAD_FIELDS = ("kf_active", "kf_node", "kf_weight", "kf_pos",
                "kf_pos_mask", "kf_quat", "kf_has_quat", "dir_active",
                "dir_weight", "dir_target", "traj_active", "traj_weight",
                "jr_active", "jr_joint", "jr_quat", "jr_weight", "ca_active",
                "ca_weight", "ca_pos", "ca_pos_mask", "has_prev",
                "prev_last", "start_q", "start_delta")
