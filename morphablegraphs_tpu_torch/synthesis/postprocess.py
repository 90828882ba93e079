"""Post-processing of a synthesized motion (port of
morphablegraphs_tpu.synthesis.postprocess): keyframe IK edits, the
trajectory IK pass and grounding.

Each user keyframe constraint becomes an IK constraint at an output frame,
solved on the frame by `ops.ik.solve_ik` and blended into the surrounding
window on the host.  A trajectory constraint over a frame range (the
collision-avoidance "ik" mode) is one `ops.ik.solve_ik_frames` over the
range.  Everything runs on the CUDA device unless the caller passes
device="cpu"."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_global, fk_positions
from ..ops import ik as ik_ops
from ..ops import quat as quat_ops
from ..ops import spline_path
from ..utils import device as device_mod
from ..utils import profiling
from . import grounding

# actions whose IK orientation constraints are ignored unless
# constrain_place_orientation is set
PLACE_ACTION_LIST = ("placeRight", "placeLeft", "insertRight", "insertLeft",
                     "screwRight", "screwLeft")


@dataclasses.dataclass
class IKConstraint:
    """Positional end-effector constraint at an output frame.

    pin_joints: joints held at their current positions during the solve.
    offset: a local tool offset in the joint's frame (the target applies to
    pos + R_joint @ offset).  orientation: a target global orientation
    quaternion (wxyz), applied after the positional solve when the IK
    settings' optimize_orientation is on."""

    frame_idx: int
    joint: str
    position: np.ndarray  # [3] (NaN components ignored)
    look_at: bool = False
    pin_joints: tuple = ()
    offset: np.ndarray = None
    orientation: np.ndarray = None


def create_ik_constraints(graph, steps, constraint_specs,
                          constrain_place_orientation: bool = False
                          ) -> List[IKConstraint]:
    """Steps' user keyframe constraints -> per-frame IK constraints.
    constraint_specs: {step_index: [(joint, position, canonical keyframe[,
    orientation quaternion])]}; the output frame interpolates the step's
    frame range by the keyframe's canonical position.  Steps of a
    place/insert/screw action (PLACE_ACTION_LIST) drop the orientation
    unless constrain_place_orientation is set."""
    out = []
    for step_idx, specs in constraint_specs.items():
        step = steps[step_idx]
        keep_ori = (constrain_place_orientation
                    or getattr(step, "action_name", "")
                    not in PLACE_ACTION_LIST)
        prim = graph.nodes[step.node_key].primitive
        n_can = max(prim.n_canonical_frames - 1, 1)
        n_out = step.end_frame - step.start_frame
        for spec in specs:
            joint, position, keyframe = spec[:3]
            orientation = spec[3] if len(spec) > 3 and keep_ori else None
            frame_idx = step.start_frame + int(round(keyframe / n_can * n_out))
            out.append(IKConstraint(
                frame_idx=frame_idx, joint=joint,
                position=np.asarray(position, np.float64),
                orientation=None if orientation is None
                else np.asarray(orientation, np.float64)))
    return out


@dataclasses.dataclass
class IKTrajectoryConstraint:
    """A joint's trajectory over an output frame range (inclusive), solved
    by the trajectory IK pass: what the collision-avoidance "ik" mode makes
    of each CA trajectory.  spline: a built PathSpline.  fixed_range=False
    starts the target arcs at the closest point of the joint's position at
    start_frame.  The pass sets one target per frame.  unconstrained_dims
    follow the joint's current path."""

    joint: str
    spline: object
    start_frame: int
    end_frame: int  # inclusive
    fixed_range: bool = False
    unconstrained_dims: tuple = ()


def apply_ik_trajectory_constraints(skeleton: Skeleton, frames: np.ndarray,
                                    constraints: List[IKTrajectoryConstraint],
                                    n_iters: int = 10,
                                    blend_window: int = 10,
                                    device=None) -> np.ndarray:
    """Pull each constraint's joint onto its trajectory across its frame
    range: the targets advance uniformly in arc length from the start arc
    (0, or the closest point of the joint's first position) to the
    spline's end, one per frame; one IK pass over the range's frames
    (every joint but the root moves); the edit ramps linearly to 0 over blend_window frames
    (at most half the range) at both edges.  Constraints apply in order."""
    dev = device_mod.resolve(device, "apply_ik_trajectory_constraints")
    frames = frames.copy()
    m = ik_ops.MAX_IK_CONSTRAINTS
    for c in constraints:
        if c.joint not in skeleton.node_names:
            continue
        s = int(np.clip(c.start_frame, 0, len(frames) - 1))
        e = int(np.clip(c.end_frame, 0, len(frames) - 1))
        if e <= s:
            continue
        n = e - s + 1
        node_idx = skeleton.index_of(c.joint)
        batch = torch.as_tensor(np.asarray(frames[s:e + 1], np.float32),
                                device=dev)
        cur = fk_positions(skeleton, batch)[:, node_idx]  # [n, 3]
        sp = c.spline.to(dev)
        full_arc = float(sp.full_arc_length)
        if c.fixed_range:
            arc0 = 0.0
        else:
            arc0 = float(spline_path.closest_point(
                sp, cur[0], torch.zeros((), device=dev))[1])
        arcs = torch.as_tensor(
            arc0 + (full_arc - arc0) * np.linspace(0.0, 1.0, n,
                                                   dtype=np.float32),
            device=dev)
        pts = spline_path.point_at_arc_length(sp, arcs)  # [n, 3]
        for d_ in c.unconstrained_dims:
            pts[:, d_] = cur[:, d_]
        targets = torch.zeros((n, m, 3), device=dev)
        targets[:, 0] = pts
        nodes = torch.zeros((n, m), dtype=torch.long, device=dev)
        nodes[:, 0] = node_idx
        mask = torch.zeros((n, m), device=dev)
        mask[:, 0] = 1.0
        joint_mask = torch.ones(skeleton.n_animated, device=dev)
        joint_mask[0] = 0.0  # the root stays the walk's alignment anchor
        edited = ik_ops.solve_ik_frames(
            skeleton, batch, nodes, targets, mask, joint_mask,
            n_iters=n_iters).cpu().numpy()
        w = max(1, min(int(blend_window), n // 2))
        ramp = np.ones(n, np.float32)
        edge = np.linspace(0.0, 1.0, w + 1, dtype=np.float32)[1:]
        ramp[:w] = np.minimum(ramp[:w], edge)
        ramp[n - w:] = np.minimum(ramp[n - w:], edge[::-1])
        frames[s:e + 1] = (frames[s:e + 1]
                           + (edited - frames[s:e + 1]) * ramp[:, None])
    return frames


def _np_quat_multiply(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
                     w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
                     w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2], a.dtype)


def _set_global_orientation(skeleton: Skeleton, frame: np.ndarray,
                            joint: str, target_q: np.ndarray,
                            device=None) -> np.ndarray:
    """Rotate `joint`'s local quaternion channels of frame [D] so its
    global orientation equals target_q (wxyz): local' = conj(parent global)
    * target, kept in the hemisphere of the old local quaternion."""
    if joint not in skeleton.node_names:
        return frame
    try:
        sl = skeleton.quat_slice(joint)
    except (KeyError, ValueError):
        return frame  # the joint carries no animated quaternion channels
    _, ori = fk_global(skeleton, torch.as_tensor(
        np.asarray(frame, np.float32), device=device))
    parent = skeleton.parents[skeleton.index_of(joint)]
    if parent < 0:
        parent_q = np.array([1.0, 0.0, 0.0, 0.0], np.float64)
    else:
        parent_q = ori[parent].cpu().numpy().astype(np.float64)
        parent_q = parent_q / max(np.linalg.norm(parent_q), 1e-10)
    target = np.asarray(target_q, np.float64)
    target = target / max(np.linalg.norm(target), 1e-10)
    conj = parent_q * np.array([1.0, -1.0, -1.0, -1.0])
    local = _np_quat_multiply(conj, target)
    if np.dot(local, np.asarray(frame[sl], np.float64)) < 0:
        local = -local
    frame = frame.copy()
    frame[sl] = local
    return frame


def apply_ik_constraints(skeleton: Skeleton, frames: np.ndarray,
                         constraints: List[IKConstraint],
                         interpolation_window: int = 60,
                         n_iters: int = 10,
                         optimize_orientation: bool = True,
                         device=None) -> np.ndarray:
    """Solve each IK constraint on its frame (`ik.solve_ik`, every joint
    but the root free) and blend the edit linearly into the frames within
    interpolation_window // 2 of it; constraints apply in order, each on
    the frames the previous ones left.  optimize_orientation applies the
    orientation of constraints that carry one."""
    device = device_mod.resolve(device, "apply_ik_constraints")
    frames = frames.copy()
    for c in constraints:
        if c.joint not in skeleton.node_names:
            continue
        fi = int(np.clip(c.frame_idx, 0, len(frames) - 1))
        target = np.where(np.isnan(c.position), 0.0, c.position)
        mask_dims = ~np.isnan(c.position)
        frame_t = torch.as_tensor(np.asarray(frames[fi], np.float32),
                                  device=device)
        pos_j, ori_j = fk_global(skeleton, frame_t)
        node_idx = skeleton.index_of(c.joint)
        offset = (np.zeros(3, np.float32) if c.offset is None
                  else np.asarray(c.offset, np.float32))
        # unconstrained dims keep the current tip position
        cur = pos_j.cpu().numpy()
        cur_tip = cur[node_idx] + quat_ops.rotate_vec(
            quat_ops.normalize(ori_j[node_idx]),
            torch.as_tensor(offset, device=device)).cpu().numpy()
        target = np.where(mask_dims, target, cur_tip)

        nodes = np.zeros(ik_ops.MAX_IK_CONSTRAINTS, np.int64)
        targets = np.zeros((ik_ops.MAX_IK_CONSTRAINTS, 3), np.float32)
        mask = np.zeros(ik_ops.MAX_IK_CONSTRAINTS, np.float32)
        offsets = np.zeros((ik_ops.MAX_IK_CONSTRAINTS, 3), np.float32)
        nodes[0] = node_idx
        targets[0] = target
        mask[0] = 1.0
        offsets[0] = offset
        slot = 1
        for pin in c.pin_joints:
            if pin not in skeleton.node_names or slot >= len(nodes):
                continue
            pin_idx = skeleton.index_of(pin)
            nodes[slot] = pin_idx
            targets[slot] = cur[pin_idx]  # hold at the current position
            mask[slot] = 1.0
            slot += 1
        joint_mask = np.ones(skeleton.n_animated, np.float32)
        joint_mask[0] = 0.0  # the root stays the walk's alignment anchor

        def t(a):
            return torch.as_tensor(a, device=device)

        edited = ik_ops.solve_ik(
            skeleton, frame_t, t(nodes), t(targets), t(mask), t(joint_mask),
            n_iters=n_iters, target_offsets=t(offsets)).cpu().numpy()
        if optimize_orientation and c.orientation is not None:
            edited = _set_global_orientation(skeleton, edited, c.joint,
                                             c.orientation, device)
        delta = edited - frames[fi]
        w = interpolation_window // 2
        for off in range(-w, w + 1):
            k = fi + off
            if 0 <= k < len(frames):
                factor = 1.0 - abs(off) / (w + 1)
                frames[k] = frames[k] + delta * factor
    return frames


def post_process_motion(skeleton: Skeleton, frames: np.ndarray, steps,
                        ik_constraints: Optional[List[IKConstraint]] = None,
                        config: Optional[dict] = None, scene=None,
                        ik_trajectories: Optional[
                            List[IKTrajectoryConstraint]] = None,
                        device=None) -> np.ndarray:
    """Keyframe IK edits, then trajectory IK edits (the CA "ik" mode), then
    grounding, under the config's flags: both IK passes take max_iterations
    / 100 (clipped to 1..25) Gauss-Newton steps and run under
    activate_inverse_kinematics; the keyframe pass blends over
    interpolation_window unless activate_blending is off, the trajectory
    pass ramps over transition_window // 6; activate_motion_grounding
    grounds the walk's steps on the scene with motion_grounding_settings."""
    device = device_mod.resolve(device, "post_process_motion")
    config = config or {}
    ik_settings = config.get("inverse_kinematics_settings", {})
    budget = int(np.clip(
        round(int(ik_settings.get("max_iterations", 1000)) / 100), 1, 25))
    if ik_constraints and config.get("activate_inverse_kinematics", True):
        interp = (int(ik_settings.get("interpolation_window", 120))
                  if ik_settings.get("activate_blending", True) else 0)
        with profiling.span("request.ik"):
            profiling.count("request.ik.constraints", len(ik_constraints))
            frames = apply_ik_constraints(
                skeleton, frames, ik_constraints,
                interpolation_window=interp, n_iters=budget,
                optimize_orientation=bool(
                    ik_settings.get("optimize_orientation", True)),
                device=device)
    if ik_trajectories and config.get("activate_inverse_kinematics", True):
        with profiling.span("request.ik_trajectory"):
            frames = apply_ik_trajectory_constraints(
                skeleton, frames, ik_trajectories, n_iters=budget,
                blend_window=int(ik_settings.get("transition_window", 60))
                // 6, device=device)
    if config.get("activate_motion_grounding", False):
        frames = grounding.ground_motion(
            skeleton, frames, steps, scene,
            settings=config.get("motion_grounding_settings"), device=device)
    return frames
