"""Server-side constraint builder: Unity frame conversions and walk
constraints (a copy of morphablegraphs_tpu.constraints.server_builder,
which imports no JAX, on the port's Skeleton and constraint builders).

Replaces reference constraints/constraint_builder.py:33-437 (the variant
the interactive MGStatePlanner uses): conversions between the Unity
client's left-handed frame format and mg quaternion frames, hold-frame
constraints with tool offsets, and per-step walk constraints in the local
frame.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from ..models.skeleton import Skeleton


def unity_frame_to_mg_frame(skeleton: Skeleton, unity_frame: dict,
                            scale: float = 1.0) -> np.ndarray:
    """Unity left-handed {rotations: [{x,y,z,w}], rootTranslation: {x,y,z}}
    -> mg quaternion frame (reference constraint_builder.py:33-58: negate x
    on translation and (w, x) on quaternions — inverse of the exporter's
    to_unity_format handedness flip)."""
    frame = np.zeros(skeleton.n_frame_params, np.float32)
    t = unity_frame["rootTranslation"]
    frame[:3] = [-t["x"] * scale, t["y"] * scale, t["z"] * scale]
    rotations = unity_frame["rotations"]
    non_end = [n for n in skeleton.node_names if not n.endswith("_EndSite")]
    for i, name in enumerate(non_end):
        if i >= len(rotations):
            break
        if name in skeleton.animated_joints:
            r = rotations[i]
            j = skeleton.animated_index_of(name)
            frame[3 + 4 * j: 7 + 4 * j] = [-r["w"], -r["x"], r["y"], r["z"]]
    return frame


def mg_frame_to_unity_frame(skeleton: Skeleton, frame: np.ndarray,
                            scale: float = 1.0) -> dict:
    """Inverse conversion (matches serve.export.AnnotatedMotion unity path)."""
    rotations = []
    root_t = None
    for name in skeleton.node_names:
        if name.endswith("_EndSite"):
            continue
        if name == skeleton.node_names[0]:
            t = frame[:3] * scale
            root_t = {"x": float(-t[0]), "y": float(t[1]), "z": float(t[2])}
        if name in skeleton.animated_joints:
            j = skeleton.animated_index_of(name)
            r = frame[3 + 4 * j: 7 + 4 * j]
            rotations.append({"x": float(-r[1]), "y": float(r[2]),
                              "z": float(r[3]), "w": float(-r[0])})
        else:
            rotations.append({"x": 0.0, "y": 0.0, "z": 0.0, "w": -1.0})
    return {"rotations": rotations, "rootTranslation": root_t}


@dataclasses.dataclass
class UnityFrameConstraint:
    """Hold-frame constraint from the engine: keep a joint at a pose for a
    frame range, with optional tool coordinate offsets (reference
    constraint_builder.py:59-92)."""

    joint: str
    position: np.ndarray
    orientation_q: Optional[np.ndarray] = None  # [4] wxyz
    hold_start: int = 0
    hold_end: int = 0
    src_tool_cos: Optional[dict] = None
    dest_tool_cos: Optional[dict] = None
    mirror_joint: Optional[str] = None


def parse_unity_constraints(skeleton: Skeleton,
                            descs: List[dict]) -> List[UnityFrameConstraint]:
    """Engine constraint JSON -> UnityFrameConstraints (reference
    generate_motion_primitive_constraints :411 input shape)."""
    out = []
    for d in descs:
        pos = np.asarray([-d["position"]["x"], d["position"]["y"],
                          d["position"]["z"]], np.float32)
        q = None
        if d.get("orientation") is not None:
            o = d["orientation"]
            q = np.asarray([-o["w"], -o["x"], o["y"], o["z"]], np.float32)
        out.append(UnityFrameConstraint(
            joint=d["joint"], position=pos, orientation_q=q,
            hold_start=int(d.get("holdStart", 0)),
            hold_end=int(d.get("holdEnd", 0)),
            mirror_joint=d.get("mirrorJoint"),
            # tool coordinate systems for hold alignment (reference
            # constraint_builder.py:264-277 reads srcToolCos/destToolCos
            # axis dicts from the descriptor)
            src_tool_cos=d.get("srcToolCos"),
            dest_tool_cos=d.get("destToolCos")))
    return out


def generate_walk_constraints(skeleton: Skeleton, prim, target_dir_xz,
                              target_pos=None, position_weight: float = 1.0,
                              direction_weight: float = 0.8,
                              prev_frames=None):
    """Per-step locomotion constraints in the planner's format (reference
    generate_walk_constraints :393-410): end-frame direction + optional
    position, aligned against the pose buffer."""
    from . import compiled
    sc = compiled.empty_step_constraints(skeleton, prim.n_canonical_frames)
    slot = 0
    if target_pos is not None:
        p = np.asarray(target_pos, np.float64)
        sc = compiled.set_keyframe_constraint(
            sc, slot, skeleton, skeleton.animated_joints[0],
            prim.n_canonical_frames - 1,
            position=np.array([p[0], np.nan, p[2]]), weight=position_weight)
        slot += 1
    sc = compiled.set_direction_constraint(
        sc, np.asarray(target_dir_xz, np.float32),
        prim.n_canonical_frames - 1, weight=direction_weight)
    if prev_frames is not None and len(prev_frames) > 0:
        sc = compiled.set_alignment_from_prev(sc, prev_frames[-1])
    return sc
