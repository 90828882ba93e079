"""Skeleton model metadata: joint groups, the mirror map and rotation
limits (a copy of morphablegraphs_tpu.models.skeleton_models, which
imports no JAX, on the port's Skeleton).

Replaces the anim_utils skeleton_models surface the reference imports:
`JOINT_CONSTRAINTS`, `UPPER_BODY_JOINTS`, `STANDARD_MIRROR_MAP`, for the
standard humanoid naming convention.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from .skeleton import Skeleton

UPPER_BODY_JOINTS = ("Spine", "Spine1", "Spine2", "Neck", "Head",
                     "LeftShoulder", "LeftArm", "LeftForeArm", "LeftHand",
                     "RightShoulder", "RightArm", "RightForeArm", "RightHand")

LOWER_BODY_JOINTS = ("LeftUpLeg", "LeftLeg", "LeftFoot", "LeftToeBase",
                     "RightUpLeg", "RightLeg", "RightFoot", "RightToeBase")

# Left <-> right joint pairing for motion mirroring
STANDARD_MIRROR_MAP: Dict[str, str] = {}
for _l, _r in [("LeftShoulder", "RightShoulder"), ("LeftArm", "RightArm"),
               ("LeftForeArm", "RightForeArm"), ("LeftHand", "RightHand"),
               ("LeftUpLeg", "RightUpLeg"), ("LeftLeg", "RightLeg"),
               ("LeftFoot", "RightFoot"), ("LeftToeBase", "RightToeBase")]:
    STANDARD_MIRROR_MAP[_l] = _r
    STANDARD_MIRROR_MAP[_r] = _l

# Swing/twist rotation limits per joint in degrees (a pragmatic subset of the
# anim_utils JOINT_CONSTRAINTS table, used to clamp IK results).  Consumed by
# `build_limit_table` + `ops/ik.apply_joint_limits` after look-at/spine IK
# edits (reference mg_state_planner.py:814 apply_joint_constraints; the limit
# source is skeleton_model["joint_constraints"] or this default, :262-266).
JOINT_CONSTRAINTS: Dict[str, dict] = {
    "LeftLeg": {"axis": (1, 0, 0), "min_angle": 0.0, "max_angle": 150.0},
    "RightLeg": {"axis": (1, 0, 0), "min_angle": 0.0, "max_angle": 150.0},
    "LeftForeArm": {"axis": (0, 1, 0), "min_angle": 0.0, "max_angle": 150.0},
    "RightForeArm": {"axis": (0, 1, 0), "min_angle": -150.0, "max_angle": 0.0},
    "Head": {"axis": (0, 1, 0), "min_angle": -80.0, "max_angle": 80.0},
}


def build_limit_table(skel: Skeleton, constraints: Dict[str, dict] = None):
    """Compile a joint-limit dict into the array form
    `ops/ik.apply_joint_limits` consumes: (axes [J,3] unit local-frame limit
    axes, mins [J], maxs [J] in RADIANS, mask [J]) over the skeleton's
    animated joints.  Unlisted joints get mask 0 (and (-2pi, 2pi) bounds so a
    stray unmasked use is a no-op)."""
    if constraints is None:
        constraints = JOINT_CONSTRAINTS
    j = skel.n_animated
    axes = np.tile(np.array([0.0, 1.0, 0.0], np.float32), (j, 1))
    mins = np.full(j, -2.0 * np.pi, np.float32)
    maxs = np.full(j, 2.0 * np.pi, np.float32)
    mask = np.zeros(j, np.float32)
    for name, spec in constraints.items():
        if name not in skel.animated_joints:
            continue
        i = skel.animated_index_of(name)
        a = np.asarray(spec["axis"], np.float32)
        axes[i] = a / max(float(np.linalg.norm(a)), 1e-10)
        mins[i] = np.deg2rad(float(spec["min_angle"]))
        maxs[i] = np.deg2rad(float(spec["max_angle"]))
        mask[i] = 1.0
    return axes, mins, maxs, mask


def mirror_frames(skeleton: Skeleton, frames: np.ndarray) -> np.ndarray:
    """Mirror a motion across the X=0 plane: negate root x, mirror root
    rotation, and swap left/right joint rotations with the appropriate
    quaternion component flips (x-plane mirror: negate y and z of the
    quaternion, i.e. keep (w, x), negate (y, z))."""
    frames = np.asarray(frames, np.float32).copy()
    out = frames.copy()
    out[:, 0] = -frames[:, 0]  # mirror root translation x

    def mirrored_quat(q):
        return np.stack([q[..., 0], q[..., 1], -q[..., 2], -q[..., 3]], axis=-1)

    for name in skeleton.animated_joints:
        src = STANDARD_MIRROR_MAP.get(name, name)
        if src not in skeleton.animated_joints:
            src = name
        dst_sl = skeleton.quat_slice(name)
        src_sl = skeleton.quat_slice(src)
        out[:, dst_sl] = mirrored_quat(frames[:, src_sl])
    return out


def depth_joint_weights(skel: Skeleton, decay: float = 0.9) -> tuple:
    """Per-animated-joint weights attenuated by hierarchy depth
    (root/torso weigh more than extremities), a producer for
    `Skeleton.joint_weights` (anim_utils joint_weight_map semantics: pose
    constraints weight proximal joints above distal ones).

    weight(joint) = decay ** depth, depth counted over the node hierarchy.
    """
    depths = []
    for name in skel.animated_joints:
        i = skel.index_of(name)
        d = 0
        while skel.parents[i] >= 0:
            i = skel.parents[i]
            d += 1
        depths.append(d)
    return tuple(float(decay ** d) for d in depths)
