"""Hand poses over a motion (port of
morphablegraphs_tpu.synthesis.hand_pose): each hand's status (standard,
pick, ...) switches at keyframe events (attach, detach, transfer); while a
hand's status is not "standard", its pose's joint quaternions overwrite
that hand's joints in every frame, and each switch is slerp-blended over a
window of frames.  Host numpy bookkeeping; the blend is `ops.quat.slerp`
on CPU tensors (a few joints over a few dozen frames)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.skeleton import Skeleton
from ..ops import quat
from ..utils import profiling

RIGHT_HAND_JOINTS_PREFIX = "Right"
LEFT_HAND_JOINTS_PREFIX = "Left"
DEFAULT_SMOOTHING_WINDOW = 30


@dataclasses.dataclass
class HandPose:
    """One static hand pose: {joint_name: quaternion [4]}."""

    name: str
    joint_quats: Dict[str, np.ndarray]


class HandPoseGenerator:
    """HandPoseGenerator(skeleton, smoothing_window): poses by name, the
    hands' statuses and the event -> status map."""

    def __init__(self, skeleton: Skeleton,
                 smoothing_window: int = DEFAULT_SMOOTHING_WINDOW):
        self.skeleton = skeleton
        self.pose_map: Dict[str, HandPose] = {}
        self.status = {"Right": "standard", "Left": "standard"}
        self.smoothing_window = smoothing_window
        self.status_change_map: Dict[str, str] = {}

    def init_from_desc(self, desc: dict):
        """Load the poses of a graph's hand_pose_info: per-hand flattened
        quaternion vectors named by `{left,right}_hand_skeleton.joint_names`,
        or a flat {joint: quaternion} map per pose; and the event ->
        status map."""
        self.status_change_map = dict(desc.get("status_change_map", {}))
        left = desc.get("left_hand_skeleton", {}).get("joint_names", [])
        right = desc.get("right_hand_skeleton", {}).get("joint_names", [])
        for name, pose in desc.get("poses", {}).items():
            if (isinstance(pose, dict)
                    and ("LeftHand" in pose or "RightHand" in pose)
                    and (left or right)):
                joint_quats = {}
                for side, joints in (("LeftHand", left), ("RightHand", right)):
                    vec = np.asarray(pose.get(side, ()),
                                     np.float32).reshape(-1, 4)
                    for j, q in zip(joints, vec):
                        joint_quats[j] = q
                self.pose_map[name] = HandPose(name=name,
                                               joint_quats=joint_quats)
            else:
                self.pose_map[name] = HandPose(
                    name=name,
                    joint_quats={j: np.asarray(q, np.float32)
                                 for j, q in pose.items()})

    def add_pose(self, name: str, joint_quats: Dict[str, np.ndarray]):
        self.pose_map[name] = HandPose(name, {j: np.asarray(q, np.float32)
                                              for j, q in joint_quats.items()})

    def _status_for_event(self, event: str, current: str) -> str:
        """The status an event sets: the status_change_map's entry, else
        attach -> pick, detach -> standard, anything else keeps it."""
        if event in self.status_change_map:
            return self.status_change_map[event]
        if event == "attach":
            return "pick"
        if event == "detach":
            return "standard"
        return current

    def set_pose_in_frame(self, frame: np.ndarray, pose_name: str,
                          hand: str) -> np.ndarray:
        """frame [D] with the hand's joints of the pose "<hand>_<pose>" (or
        "<pose>") written in; an unknown pose leaves it as is."""
        pose = (self.pose_map.get(f"{hand}_{pose_name}")
                or self.pose_map.get(pose_name))
        if pose is None:
            return frame
        out = frame.copy()
        for joint, q in pose.joint_quats.items():
            if joint in self.skeleton.animated_joints and joint.startswith(hand):
                out[self.skeleton.quat_slice(joint)] = q
        return out

    def generate_hand_poses(self, frames: np.ndarray, events: List[dict],
                            carry_status: bool = False) -> np.ndarray:
        """Walk the events in keyframe order over frames [T, D]: an event
        at or before frame i switches its hand's status (a "transfer"
        swaps the two hands'), every frame gets the poses of the hands not
        "standard", then each switch is smoothed.  events: [{keyframe,
        event, parameters: {joint}}].  carry_status starts from the
        statuses the previous call ended with, else both hands start
        "standard"."""
        with profiling.span("request.hand_pose"):
            frames = np.asarray(frames, np.float32).copy()
            switch_frames = []
            status = (dict(self.status) if carry_status
                      else {"Right": "standard", "Left": "standard"})
            changes = sorted(events, key=lambda e: e.get("keyframe", 0))
            ci = 0
            for i in range(len(frames)):
                while (ci < len(changes)
                       and changes[ci].get("keyframe", 0) <= i):
                    e = changes[ci]
                    ci += 1
                    if e.get("event", "") == "transfer":
                        status["Right"], status["Left"] = (status["Left"],
                                                           status["Right"])
                        switch_frames += [(i, "Right"), (i, "Left")]
                        continue
                    joint = e.get("parameters", {}).get("joint", "")
                    hand = "Right" if joint.startswith("Right") else "Left"
                    new_status = self._status_for_event(e.get("event", ""),
                                                        status[hand])
                    if new_status != status[hand]:
                        status[hand] = new_status
                        switch_frames.append((i, hand))
                for hand, st in status.items():
                    if st != "standard":
                        frames[i] = self.set_pose_in_frame(frames[i], st,
                                                           hand)
            for sf, hand in switch_frames:
                frames = self.smooth_state_transition(frames, sf, hand=hand)
            self.status = status
            return frames

    def smooth_state_transition(self, frames: np.ndarray, at_frame: int,
                                window: Optional[int] = None,
                                hand: Optional[str] = None) -> np.ndarray:
        """Slerp the hand's pose joints (the joints any loaded pose writes)
        from frame at_frame - window // 2 to frame at_frame + window // 2
        across the frames between; other joints keep their motion."""
        window = window or self.smoothing_window
        n = len(frames)
        lo = max(at_frame - window // 2, 0)
        hi = min(at_frame + window // 2, n - 1)
        if hi <= lo:
            return frames
        pose_joints = set()
        for pose in self.pose_map.values():
            pose_joints.update(pose.joint_quats.keys())
        joints = [j for j in self.skeleton.animated_joints
                  if j in pose_joints and (hand is None or j.startswith(hand))]
        if not joints:
            return frames
        slots = [self.skeleton.quat_slice(j) for j in joints]
        q_lo = torch.as_tensor(np.stack([frames[lo, s] for s in slots]))
        q_hi = torch.as_tensor(np.stack([frames[hi, s] for s in slots]))
        for i in range(lo, hi + 1):
            t = np.float32((i - lo) / (hi - lo))
            blended = quat.slerp(q_lo, q_hi, t).numpy()
            for s, q in zip(slots, blended):
                frames[i, s] = q
        return frames
