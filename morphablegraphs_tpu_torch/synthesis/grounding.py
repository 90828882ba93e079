"""Foot grounding (port of morphablegraphs_tpu.synthesis.grounding): the
stance/swing model per walk primitive (`MP_CONFIGURATIONS`), moving a
motion onto the ground, the per-step stance-table grounding (anchor frames
with blend windows, the stance-foot pin and the swing-foot clamp), and
foot-plant constraints from detected ground contacts.

FK and IK run on the device (the CUDA device unless the caller passes
device="cpu"); every IK pass over a frame range is one call of
`ik.solve_ik_frames` over the range, where the JAX package vmaps its
one-frame solve.  The bookkeeping (contact bit vectors, runs, blend
ramps) stays numpy on the host, as in the JAX package."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..construct.preprocessing import smooth_bitvector
from ..models.skeleton import Skeleton, fk_positions
from ..ops import ik as ik_ops
from ..utils import device as device_mod
from ..utils import profiling
from ..utils.config import DEFAULT_ALGORITHM_CONFIG as _DAC

LEFT_FOOT = "LeftFoot"
RIGHT_FOOT = "RightFoot"
LEFT_TOE = "LeftToeBase"
RIGHT_TOE = "RightToeBase"

# Stance/swing model per walk primitive
# (reference motion_primitive_grounding.py:43-120)
MP_CONFIGURATIONS: Dict[str, dict] = {
    "leftStance": {"start_stance_foot": "right", "stance_foot": "right",
                   "swing_foot": "left", "end_stance_foot": "left",
                   "stance_mode": "toe", "start_window_size": 10,
                   "end_window_size": 10},
    "rightStance": {"start_stance_foot": "left", "stance_foot": "left",
                    "swing_foot": "right", "end_stance_foot": "right",
                    "stance_mode": "toe", "start_window_size": 10,
                    "end_window_size": 10},
    "beginLeftStance": {"start_stance_foot": "both", "stance_foot": "right",
                        "swing_foot": "left", "end_stance_foot": "left",
                        "stance_mode": "toe", "start_window_size": 10,
                        "end_window_size": 10},
    "beginRightStance": {"start_stance_foot": "both", "stance_foot": "left",
                         "swing_foot": "right", "end_stance_foot": "right",
                         "stance_mode": "toe", "start_window_size": 10,
                         "end_window_size": 10},
    "endRightStance": {"start_stance_foot": "left", "stance_foot": "left",
                       "swing_foot": "right", "end_stance_foot": "both",
                       "stance_mode": "none", "start_window_size": 10,
                       "end_window_size": 10},
    "endLeftStance": {"start_stance_foot": "right", "stance_foot": "right",
                      "swing_foot": "left", "end_stance_foot": "both",
                      "stance_mode": "none", "start_window_size": 10,
                      "end_window_size": 10},
    "turnLeftRightStance": {"start_stance_foot": "both", "stance_foot": "left",
                            "swing_foot": "right", "end_stance_foot": "right",
                            "stance_mode": "none", "start_window_size": 20,
                            "end_window_size": 20},
    "turnRightLeftStance": {"start_stance_foot": "both", "stance_foot": "right",
                            "swing_foot": "left", "end_stance_foot": "left",
                            "stance_mode": "none", "start_window_size": 20,
                            "end_window_size": 20},
}

# the algorithm config's grounding settings without the damp_* keys (the
# IK damping is fixed): what post_process_motion passes by default
DEFAULT_GROUNDING_SETTINGS = {
    k: v for k, v in _DAC["motion_grounding_settings"].items()
    if not k.startswith("damp_")}

IK_ITERS = 8  # Gauss-Newton steps of every grounding solve


def _foot_nodes(skeleton: Skeleton, side: str) -> List[str]:
    names = {"left": [LEFT_FOOT], "right": [RIGHT_FOOT],
             "both": [LEFT_FOOT, RIGHT_FOOT]}[side]
    return [n for n in names if n in skeleton.node_names]


class SceneInterface:
    """Height query adapter (reference motion_generator/scene_interface.py)."""

    def __init__(self, height_fn: Optional[Callable] = None,
                 constant_height: float = 0.0):
        self.height_fn = height_fn
        self.constant_height = constant_height
        self.offset = [0.0, 0.0]

    def set_scene(self, scene) -> None:
        """Install a height source: anything with .get_height(x, z) or a
        plain callable (reference scene_interface.py set_scene)."""
        self.height_fn = getattr(scene, "get_height", scene)

    def set_offset(self, x: float, z: float) -> None:
        self.offset = [float(x), float(z)]

    def get_height(self, x: float, z: float) -> float:
        x += self.offset[0]
        z += self.offset[1]
        if self.height_fn is not None:
            return float(self.height_fn(x, z))
        return self.constant_height


def _positions(skeleton: Skeleton, frames: np.ndarray,
               dev: torch.device) -> np.ndarray:
    """Global joint positions of frames [..., D] by FK on dev -> numpy
    [..., n_nodes, 3]."""
    return fk_positions(skeleton, torch.as_tensor(
        np.asarray(frames, np.float32), device=dev)).cpu().numpy()


def _solve(skeleton: Skeleton, frames: np.ndarray, nodes: np.ndarray,
           targets: np.ndarray, mask: np.ndarray, joint_mask: np.ndarray,
           dev: torch.device) -> np.ndarray:
    """`ik.solve_ik_frames` on host arrays (frames [F, D], nodes [F, C],
    targets [F, C, 3], mask [F, C], joint_mask [J]) -> edited frames
    [F, D] on the host."""
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)
    return ik_ops.solve_ik_frames(
        skeleton, t(frames), t(nodes, torch.long), t(targets), t(mask),
        t(joint_mask), n_iters=IK_ITERS).cpu().numpy()


def move_to_ground(skeleton: Skeleton, frames: np.ndarray,
                   scene: Optional[SceneInterface] = None,
                   source_frame: int = 0, device=None) -> np.ndarray:
    """Shift the whole motion vertically so the lower foot touches the
    scene height under the root at the source frame."""
    dev = device_mod.resolve(device, "move_to_ground")
    scene = scene or SceneInterface()
    feet = _foot_nodes(skeleton, "both")
    if not feet:
        return frames
    pos = _positions(skeleton, frames[source_frame], dev)
    low = min(pos[skeleton.index_of(f)][1] for f in feet)
    root = frames[source_frame][:3]
    target = scene.get_height(float(root[0]), float(root[2]))
    out = frames.copy()
    out[:, 1] += target - low
    return out


def align_xz_to_origin(frames: np.ndarray) -> np.ndarray:
    """Translate so the first frame's root is at the XZ origin."""
    out = frames.copy()
    out[:, 0] -= out[0, 0]
    out[:, 2] -= out[0, 2]
    return out


def _leg_joint_mask(skeleton: Skeleton, feet: List[str]) -> np.ndarray:
    """0/1 mask over animated joints on the root->feet chains (minus root)."""
    mask = np.zeros(skeleton.n_animated, np.float32)
    for f in feet:
        i = skeleton.index_of(f)
        while i >= 0:
            name = skeleton.node_names[i]
            if (name in skeleton.animated_joints
                    and name != skeleton.animated_joints[0]):
                mask[skeleton.animated_index_of(name)] = 1.0
            i = skeleton.parents[i]
    return mask


def _ground_window(skeleton: Skeleton, frames: np.ndarray, frame_indices,
                   feet: List[str], ground_height: float,
                   blend_window: int, dev: torch.device) -> np.ndarray:
    """At each anchor frame put the feet on the ground height by IK (the
    legs move) and blend the edit linearly into the blend_window frames on
    either side; anchors apply in order."""
    if not feet or len(frame_indices) == 0:
        return frames
    frames = frames.copy()
    node_idx = [skeleton.index_of(f) for f in feet]
    joint_mask = _leg_joint_mask(skeleton, feet)
    m = ik_ops.MAX_IK_CONSTRAINTS
    for fi in frame_indices:
        pos = _positions(skeleton, frames[fi], dev)
        targets = np.zeros((1, m, 3), np.float32)
        nodes = np.zeros((1, m), np.int64)
        mask = np.zeros((1, m), np.float32)
        for c, ni in enumerate(node_idx[:m]):
            t = pos[ni].copy()
            t[1] = ground_height
            targets[0, c] = t
            nodes[0, c] = ni
            mask[0, c] = 1.0
        edited = _solve(skeleton, frames[fi][None], nodes, targets, mask,
                        joint_mask, dev)[0]
        delta = edited - frames[fi]
        for w in range(-blend_window, blend_window + 1):
            k = fi + w
            if 0 <= k < len(frames):
                factor = 1.0 - abs(w) / (blend_window + 1)
                frames[k] = frames[k] + delta * factor
    return frames


def ground_stance_swing(skeleton: Skeleton, frames: np.ndarray, cfg: dict,
                        start_frame: int, end_frame: int,
                        ground_height: float, device=None) -> np.ndarray:
    """Over a step's frames, hold the stance foot at its first-frame
    position on the ground height and lift the swing foot to the ground
    height where it would sink below it: one IK pass over the step's
    frames (the legs move).  A configuration with stance_mode "none", a
    skeleton without the feet and a range of one frame return the frames
    unchanged."""
    dev = device_mod.resolve(device, "ground_stance_swing")
    if cfg.get("stance_mode", "none") == "none":
        return frames
    stance = _foot_nodes(skeleton, cfg["stance_foot"])
    swing = _foot_nodes(skeleton, cfg["swing_foot"])
    if not stance or not swing:
        return frames
    end_frame = min(end_frame, len(frames) - 1)
    if end_frame <= start_frame:
        return frames
    frames = frames.copy()
    seg = frames[start_frame: end_frame + 1]
    pos = _positions(skeleton, seg, dev)  # [T, nodes, 3]
    t = len(pos)
    n_c = ik_ops.MAX_IK_CONSTRAINTS
    targets = np.zeros((t, n_c, 3), np.float32)
    nodes = np.zeros((t, n_c), np.int64)
    mask = np.zeros((t, n_c), np.float32)
    si = skeleton.index_of(stance[0])
    pin = pos[0, si].copy()
    pin[1] = ground_height
    targets[:, 0] = pin
    nodes[:, 0] = si
    mask[:, 0] = 1.0
    wi = skeleton.index_of(swing[0])
    cur = pos[:, wi].copy()
    below = cur[:, 1] < ground_height
    cur[:, 1] = np.maximum(cur[:, 1], ground_height)
    targets[:, 1] = cur
    nodes[:, 1] = wi
    mask[:, 1] = below.astype(np.float32)
    joint_mask = _leg_joint_mask(skeleton, [stance[0], swing[0]])
    if not joint_mask.any():
        return frames
    frames[start_frame: end_frame + 1] = _solve(
        skeleton, seg, nodes, targets, mask, joint_mask, dev)
    return frames


def detect_ground_contacts(skeleton: Skeleton, frames: np.ndarray,
                           settings: Optional[dict] = None,
                           scene: Optional[SceneInterface] = None,
                           positions: Optional[np.ndarray] = None,
                           device=None) -> Dict[str, np.ndarray]:
    """Per-frame ground-contact bits per foot [T] int8.  A frame is a strict
    contact when the foot is within contact_tolerance of the scene height
    at its own XZ; a frame within foot_lift_tolerance of it that lies
    within foot_lift_search_window frames of a strict contact is a contact
    too; the bits are then majority-vote smoothed over
    smoothing_constraints_window frames.  positions [T, nodes, 3] skips
    the FK pass."""
    s = dict(DEFAULT_GROUNDING_SETTINGS)
    s.update(settings or {})
    scene = scene or SceneInterface()
    feet = _foot_nodes(skeleton, "both")
    out: Dict[str, np.ndarray] = {}
    if not feet or len(frames) == 0:
        return out
    pos = (_positions(skeleton, frames,
                      device_mod.resolve(device, "detect_ground_contacts"))
           if positions is None else positions)
    win = max(int(s["foot_lift_search_window"]), 1)
    for f in feet:
        p = pos[:, skeleton.index_of(f)]  # [T, 3]
        ground = np.array([scene.get_height(float(x), float(z))
                           for x, z in zip(p[:, 0], p[:, 2])])
        h = p[:, 1] - ground
        strict = h < float(s["contact_tolerance"])
        loose = h < float(s["foot_lift_tolerance"])
        # the kernel clamped to the signal: np.convolve(mode="same")
        # returns max(len(signal), len(kernel)) elements
        kwin = min(2 * win + 1, len(strict))
        near_strict = np.convolve(strict.astype(np.float64),
                                  np.ones(kwin), mode="same") > 0
        bv = (loose & near_strict).astype(np.int8)
        out[f] = smooth_bitvector(bv, int(s["smoothing_constraints_window"]))
    return out


def generate_foot_plant_constraints(skeleton: Skeleton, frames: np.ndarray,
                                    settings: Optional[dict] = None,
                                    scene: Optional[SceneInterface] = None,
                                    steps=None, device=None):
    """Contact runs -> (constraints [(joint, start, end, anchor [3])],
    blend ranges {joint: [(start, end)]}, contacts).  Each contiguous
    contact run pins the foot at its median position over the run, at the
    scene height there; its blend range reaches constraint_range frames
    past each end.  With the walk's steps, a run is clipped to its owning
    step's frame range (the step holding the run's middle frame) widened
    by graph_walk_grounding_window frames.  One FK pass serves the
    contact detection and the medians."""
    dev = device_mod.resolve(device, "generate_foot_plant_constraints")
    s = dict(DEFAULT_GROUNDING_SETTINGS)
    s.update(settings or {})
    scene = scene or SceneInterface()
    pos = _positions(skeleton, frames, dev)
    contacts = detect_ground_contacts(skeleton, frames, s, scene,
                                      positions=pos)
    rng = int(s["constraint_range"])
    gw = int(s["graph_walk_grounding_window"])
    constraints = []
    blend_ranges: Dict[str, list] = {}
    n = len(frames)
    for joint, bv in contacts.items():
        ji = skeleton.index_of(joint)
        edges = np.flatnonzero(np.diff(np.concatenate([[0], bv, [0]])))
        for k in range(0, len(edges), 2):
            start, end = int(edges[k]), int(edges[k + 1]) - 1
            if steps is not None:
                owner = next((st for st in steps
                              if st.start_frame <= (start + end) // 2
                              <= st.end_frame), None)
                if owner is not None:
                    start = max(start, owner.start_frame - gw)
                    end = min(end, owner.end_frame + gw)
            if end < start:
                continue
            anchor = np.median(pos[start: end + 1, ji], axis=0)
            anchor[1] = scene.get_height(float(anchor[0]), float(anchor[2]))
            constraints.append((joint, start, end, anchor))
            blend_ranges.setdefault(joint, []).append(
                (max(start - rng, 0), min(end + rng, n - 1)))
    return constraints, blend_ranges, contacts


def apply_grounding_constraints(skeleton: Skeleton, frames: np.ndarray,
                                constraints, activate_blending: bool = True,
                                constraint_range: int = 10,
                                device=None) -> np.ndarray:
    """Pin each constraint's foot at its anchor over its run, one IK pass
    over the run's frames (the leg moves); with activate_blending the
    edits of the run's first and last frames ramp out linearly over
    constraint_range frames on either side.  Constraints apply in
    order."""
    dev = device_mod.resolve(device, "apply_grounding_constraints")
    if not constraints:
        return frames
    frames = frames.copy()
    n_c = ik_ops.MAX_IK_CONSTRAINTS
    for joint, start, end, anchor in constraints:
        if joint not in skeleton.node_names:
            continue
        joint_mask = _leg_joint_mask(skeleton, [joint])
        if not joint_mask.any():
            continue
        end = min(end, len(frames) - 1)
        seg = frames[start: end + 1].astype(np.float32)
        t = int(end - start + 1)
        targets = np.zeros((t, n_c, 3), np.float32)
        nodes = np.zeros((t, n_c), np.int64)
        mask = np.zeros((t, n_c), np.float32)
        targets[:, 0] = anchor
        nodes[:, 0] = skeleton.index_of(joint)
        mask[:, 0] = 1.0
        edited = _solve(skeleton, seg, nodes, targets, mask, joint_mask, dev)
        frames[start: end + 1] = edited
        if activate_blending and constraint_range > 0:
            delta_s = edited[0] - seg[0]
            delta_e = edited[-1] - seg[-1]
            for w in range(1, constraint_range + 1):
                factor = 1.0 - w / (constraint_range + 1)
                k = start - w
                if k >= 0:
                    frames[k] = frames[k] + delta_s * factor
                k = end + w
                if k < len(frames):
                    frames[k] = frames[k] + delta_e * factor
    return frames


def ground_step(skeleton: Skeleton, frames: np.ndarray, mp_name: str,
                start_frame: int, end_frame: int,
                scene: Optional[SceneInterface] = None,
                device=None) -> np.ndarray:
    """Ground one step by its primitive's configuration: the start and end
    stance feet onto the scene height under the root at each anchor, each
    edit blended over its window, then the stance pin and swing clamp
    between them.  A primitive without a configuration is left as is."""
    dev = device_mod.resolve(device, "ground_step")
    cfg = MP_CONFIGURATIONS.get(mp_name)
    if cfg is None:
        return frames
    scene = scene or SceneInterface()
    end_frame = min(end_frame, len(frames) - 1)
    h_start = scene.get_height(float(frames[start_frame][0]),
                               float(frames[start_frame][2]))
    h_end = scene.get_height(float(frames[end_frame][0]),
                             float(frames[end_frame][2]))
    feet_start = _foot_nodes(skeleton, cfg["start_stance_foot"])
    feet_end = _foot_nodes(skeleton, cfg["end_stance_foot"])
    frames = _ground_window(skeleton, frames, [start_frame], feet_start,
                            h_start, cfg["start_window_size"], dev)
    frames = _ground_window(skeleton, frames, [end_frame], feet_end, h_end,
                            cfg["end_window_size"], dev)
    return ground_stance_swing(skeleton, frames, cfg, start_frame,
                               end_frame, h_start, device=dev)


def ground_motion(skeleton: Skeleton, frames: np.ndarray, steps,
                  scene: Optional[SceneInterface] = None,
                  settings: Optional[dict] = None,
                  device=None) -> np.ndarray:
    """Ground a whole walk: move it onto the ground, then with the
    settings' generate_foot_plant_constraints pin the detected foot plants,
    else ground every step by the stance table (also without settings).
    A skeleton without feet returns the frames unchanged."""
    dev = device_mod.resolve(device, "ground_motion")
    if not _foot_nodes(skeleton, "both"):
        return frames
    with profiling.span("request.ground"):
        frames = move_to_ground(skeleton, frames, scene, device=dev)
        s = settings or {}
        if s.get("generate_foot_plant_constraints", False):
            cs, _, _ = generate_foot_plant_constraints(
                skeleton, frames, s, scene, steps, device=dev)
            return apply_grounding_constraints(
                skeleton, frames, cs,
                activate_blending=bool(s.get("activate_blending", True)),
                constraint_range=int(s.get("constraint_range", 10)),
                device=dev)
        for step in steps:
            frames = ground_step(skeleton, frames, step.node_key[1],
                                 step.start_frame, step.end_frame, scene,
                                 device=dev)
        return frames
