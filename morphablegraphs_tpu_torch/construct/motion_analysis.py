"""Pose feature analysis for semantic annotation (port of
morphablegraphs_tpu.construct.motion_analysis).

Replaces reference motion_analysis/ (bvh_analyzer.py:33-643 BVHAnalyzer's
per-frame FK and boolean/scalar pose predicates, motion_plane.py:27-99
Plane/plane_fitting).  The FK of ALL frames runs once, batched, on the
card (`models/skeleton.fk_global`, CUDA unless the analyzer is given
another device), with the root's heading; the predicates are host numpy on
its output, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_global
from ..ops import quat as quat_ops
from ..utils import device as device_mod


class Plane:
    """Best-fit plane through points (reference motion_plane.py:27-99)."""

    def __init__(self, normal: np.ndarray, point: np.ndarray):
        self.normal = np.asarray(normal, np.float64)
        self.normal /= max(np.linalg.norm(self.normal), 1e-12)
        self.point = np.asarray(point, np.float64)

    @classmethod
    def fit(cls, points: np.ndarray) -> "Plane":
        points = np.asarray(points, np.float64)
        centroid = points.mean(axis=0)
        _, _, vt = np.linalg.svd(points - centroid)
        return cls(vt[-1], centroid)

    def distance(self, p: np.ndarray) -> float:
        return float(np.dot(np.asarray(p) - self.point, self.normal))

    @classmethod
    def from_three_points(cls, p0, p1, p2) -> "Plane":
        """Plane through three points, normal by the right-hand rule
        (reference motion_plane.py Plane on a 3-point list)."""
        p0, p1, p2 = (np.asarray(p, np.float64) for p in (p0, p1, p2))
        return cls(np.cross(p1 - p0, p2 - p0), p0)

    def is_before(self, p: np.ndarray) -> bool:
        """Signed-side test (reference Plane.is_before_plane)."""
        return self.distance(p) > 0.0


class BVHAnalyzer:
    """Batched pose-feature predicates (reference bvh_analyzer.py:33-643).

    Every reference predicate family (accessors, joint kinematics, elbow/knee
    angles, body-plane tests, hand/leg motion states, feet features) as
    per-frame bool/scalar ARRAYS from one batched FK pass — the reference
    computes each of these per frame in Python loops.
    """

    def __init__(self, skeleton: Skeleton, frames: np.ndarray, device=None):
        self.skeleton = skeleton
        self.frames = np.asarray(frames, np.float32)
        dev = device_mod.resolve(device, "BVHAnalyzer")
        frames_d = torch.as_tensor(self.frames, device=dev)
        pos, ori = fk_global(skeleton, frames_d)
        self.positions = pos.cpu().numpy()  # [T, nodes, 3]
        self.orientations = ori.cpu().numpy()
        # the root's forward axis per frame, for the facing predicates
        self._forward = quat_ops.rotate_vec(
            frames_d[:, 3:7], torch.tensor([0.0, 0.0, 1.0], device=dev)
        ).cpu().numpy()

    def _p(self, joint: str) -> np.ndarray:
        return self.positions[:, self.skeleton.index_of(joint)]

    def has_joint(self, *names) -> bool:
        return all(n in self.skeleton.node_names for n in names)

    # -- scalar features ------------------------------------------------
    def joint_height(self, joint: str) -> np.ndarray:
        return self._p(joint)[:, 1]

    def joint_speed(self, joint: str) -> np.ndarray:
        p = self._p(joint)
        v = np.linalg.norm(np.diff(p, axis=0), axis=1)
        if v.size == 0:  # single-frame motion: length-T (== 1), not empty
            return np.zeros(len(p))
        return np.concatenate([v, v[-1:]])

    def joint_distance(self, a: str, b: str) -> np.ndarray:
        return np.linalg.norm(self._p(a) - self._p(b), axis=1)

    def knee_angle(self, side: str = "Right") -> np.ndarray:
        """Angle at the knee (reference knee-angle predicate)."""
        hip = self._p(f"{side}UpLeg")
        knee = self._p(f"{side}Leg")
        foot = self._p(f"{side}Foot")
        v1 = hip - knee
        v2 = foot - knee
        cos = np.sum(v1 * v2, axis=1) / np.maximum(
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-10)
        return np.degrees(np.arccos(np.clip(cos, -1, 1)))

    # -- boolean predicates --------------------------------------------
    def hand_in_front_of_root(self, side: str = "Right") -> np.ndarray:
        """Hand forward of the hips in the character's local frame
        (reference hand-forward predicate)."""
        fwd = self._forward
        hand = f"{side}Hand"
        if not self.has_joint(hand):
            return np.zeros(len(self.frames), bool)
        rel = self._p(hand) - self._p(self.skeleton.node_names[0])
        return np.sum(rel * fwd, axis=1) > 0

    def foot_behind_other_leg(self, side: str = "Right") -> np.ndarray:
        other = "Left" if side == "Right" else "Right"
        if not self.has_joint(f"{side}Foot", f"{other}Foot"):
            return np.zeros(len(self.frames), bool)
        fwd = self._forward
        rel = self._p(f"{side}Foot") - self._p(f"{other}Foot")
        return np.sum(rel * fwd, axis=1) < 0

    def spine_horizontal(self, threshold_deg: float = 45.0) -> np.ndarray:
        """Spine tilted toward horizontal (bending over)."""
        if not self.has_joint("Spine", "Head"):
            return np.zeros(len(self.frames), bool)
        up = self._p("Head") - self._p("Spine")
        up = up / np.maximum(np.linalg.norm(up, axis=1, keepdims=True), 1e-10)
        angle = np.degrees(np.arccos(np.clip(up[:, 1], -1, 1)))
        return angle > threshold_deg

    # -- accessors (reference bvh_analyzer.py:43-139) --------------------
    def get_global_joint_positions(self, joint: str) -> np.ndarray:
        """[T, 3] global positions (reference get_global_joint_positions)."""
        return self._p(joint)

    def get_global_pos(self, joint: str, frame_idx: int) -> np.ndarray:
        return self._p(joint)[frame_idx]

    def get_relative_joint_position(self, joint: str, frame_idx: int) -> np.ndarray:
        """Position relative to the root (reference
        get_relative_joint_position :74)."""
        root = self.skeleton.node_names[0]
        return self._p(joint)[frame_idx] - self._p(root)[frame_idx]

    def get_parent_joint_name(self, joint: str) -> str:
        parent = self.skeleton.parents[self.skeleton.index_of(joint)]
        return self.skeleton.node_names[parent] if parent >= 0 else ""

    def get_joint_chain(self, joint: str):
        """Names from the root down to `joint` (reference get_joint_chain)."""
        chain = [joint]
        while True:
            parent = self.get_parent_joint_name(chain[0])
            if not parent:
                return chain
            chain.insert(0, parent)

    def joint_acceleration(self, joint: str) -> np.ndarray:
        """Per-frame acceleration magnitude (reference
        get_joint_acceleration :126); padded to T like joint_speed."""
        p = self._p(joint)
        a = np.linalg.norm(np.diff(p, n=2, axis=0), axis=1)
        return np.concatenate([a[:1], a, a[-1:]]) if len(a) else \
            np.zeros(len(p))

    # -- more scalar features (reference :286-357, :494-519) -------------
    def elbow_angle(self, side: str = "Right") -> np.ndarray:
        """Angle at the elbow in degrees (reference get_left/right_elbow_angle
        :286/:302: angle between forearm->arm and forearm->hand)."""
        arm = self._p(f"{side}Arm")
        forearm = self._p(f"{side}ForeArm")
        hand = self._p(f"{side}Hand")
        v1 = forearm - arm
        v2 = forearm - hand
        cos = np.sum(v1 * v2, axis=1) / np.maximum(
            np.linalg.norm(v1, axis=1) * np.linalg.norm(v2, axis=1), 1e-10)
        return np.degrees(np.arccos(np.clip(cos, -1, 1)))

    def feet_distance_on_ground(self) -> np.ndarray:
        """XZ-plane distance between the feet (reference
        feet_distance_on_ground :346)."""
        d = self._p("LeftFoot") - self._p("RightFoot")
        return np.linalg.norm(d[:, [0, 2]], axis=1)

    def feet_moving_towards_each_other(self) -> np.ndarray:
        """Per-frame bool: ground distance between feet is decreasing
        (reference feet_moving_towards_each_other :631, unimplemented `pass`
        there; semantics follow its docstring)."""
        d = self.feet_distance_on_ground()
        towards = np.diff(d) < 0
        if towards.size == 0:  # single-frame motion
            return np.zeros(len(d), bool)
        return np.concatenate([towards[:1], towards])

    def body_planes(self) -> "tuple[np.ndarray, np.ndarray]":
        """Per-frame body plane (normals [T,3], points [T,3]) fit through the
        torso joints in root-relative coordinates (reference get_body_plane
        :278: Hips, Spine, shoulders, up-legs).  Cached: positions are
        immutable after __init__ and the batched SVD is the analyzer's most
        expensive call (feature_vector hits it once per hand)."""
        if getattr(self, "_body_planes", None) is not None:
            return self._body_planes
        names = [n for n in ["Hips", "Spine", "LeftShoulder", "RightShoulder",
                             "LeftUpLeg", "RightUpLeg"]
                 if n in self.skeleton.node_names]
        root = self._p(self.skeleton.node_names[0])
        pts = np.stack([self._p(n) - root for n in names], axis=1)  # [T,J,3]
        centroid = pts.mean(axis=1, keepdims=True)
        _, _, vt = np.linalg.svd(pts - centroid)  # batched
        normals = vt[:, -1]
        normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                              1e-12)
        self._body_planes = (normals, centroid[:, 0])
        return self._body_planes

    def joint_distance_to_body(self, joint: str) -> np.ndarray:
        """Signed distance of a joint to the per-frame body plane (reference
        joint_disntace_to_body :452), in root-relative coordinates."""
        normals, points = self.body_planes()
        root = self._p(self.skeleton.node_names[0])
        rel = self._p(joint) - root
        return np.sum((rel - points) * normals, axis=1)

    # -- more boolean predicates (reference :379-620) ---------------------
    def hand_moving_forwards(self, side: str = "Right",
                             threshold: float = 0.1) -> np.ndarray:
        """Hand distance to the body plane increasing by > threshold next
        frame (reference rhand/lhand_moving_forwards :379/:397)."""
        if not self.has_joint(f"{side}Hand"):
            return np.zeros(len(self.frames), bool)
        d = np.abs(self.joint_distance_to_body(f"{side}Hand"))
        moving = np.diff(d) > threshold
        return np.concatenate([moving, [False]])

    def leg_bending(self, side: str = "Right",
                    angle_threshold: float = 0.001) -> np.ndarray:
        """Knee angle decreasing (reference lleg/rleg_bending :520/:558;
        frame 0 is False there and here)."""
        a = self.knee_angle(side)
        bending = np.diff(a) < -angle_threshold
        return np.concatenate([[False], bending])

    def leg_stretching(self, side: str = "Right",
                       angle_threshold: float = 0.01) -> np.ndarray:
        """Knee angle increasing (reference lleg/rleg_stretching :539/:577)."""
        a = self.knee_angle(side)
        stretching = np.diff(a) > angle_threshold
        return np.concatenate([[False], stretching])

    def toe_before_leg(self, side: str = "Right") -> np.ndarray:
        """Toe of `side` in front of the plane through (Hips, other UpLeg,
        other Leg) in root-relative coordinates (reference
        rtoe_before_lleg/ltoe_before_rleg :596/:610)."""
        other = "Left" if side == "Right" else "Right"
        toe = next((n for n in (f"{side}Toe", f"{side}ToeBase",
                                f"Bip01_{side[0]}_Toe0")
                    if n in self.skeleton.node_names), None)
        if toe is None or not self.has_joint("Hips", f"{other}UpLeg",
                                             f"{other}Leg"):
            return np.zeros(len(self.frames), bool)
        root = self._p(self.skeleton.node_names[0])
        p0 = self._p("Hips") - root
        p1 = self._p(f"{other}UpLeg") - root
        p2 = self._p(f"{other}Leg") - root
        pt = self._p(toe) - root
        normals = np.cross(p1 - p0, p2 - p0)
        return np.sum((pt - p0) * normals, axis=1) > 0

    def feature_vector(self) -> Dict[str, np.ndarray]:
        """All applicable features as named curves (the reference's feature
        table for semantic annotation)."""
        out = {}
        root = self.skeleton.node_names[0]
        out["root_height"] = self.joint_height(root)
        out["root_speed"] = self.joint_speed(root)
        for side in ("Left", "Right"):
            if self.has_joint(f"{side}Foot"):
                out[f"{side}_foot_height"] = self.joint_height(f"{side}Foot")
                out[f"{side}_foot_speed"] = self.joint_speed(f"{side}Foot")
            if self.has_joint(f"{side}UpLeg", f"{side}Leg", f"{side}Foot"):
                out[f"{side}_knee_angle"] = self.knee_angle(side)
            if self.has_joint(f"{side}UpLeg", f"{side}Leg", f"{side}Foot"):
                out[f"{side}_leg_bending"] = self.leg_bending(side)
                out[f"{side}_leg_stretching"] = self.leg_stretching(side)
            if self.has_joint(f"{side}Hand"):
                out[f"{side}_hand_front"] = self.hand_in_front_of_root(side)
            if self.has_joint(f"{side}Arm", f"{side}ForeArm", f"{side}Hand"):
                out[f"{side}_elbow_angle"] = self.elbow_angle(side)
                out[f"{side}_hand_moving_forwards"] = self.hand_moving_forwards(side)
        if self.has_joint("LeftFoot", "RightFoot"):
            out["feet_distance"] = self.feet_distance_on_ground()
            out["feet_towards"] = self.feet_moving_towards_each_other()
        if self.has_joint("Spine", "Head"):
            out["spine_horizontal"] = self.spine_horizontal()
        return out
