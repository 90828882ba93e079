"""Preprocessing: foot-contact detection, walk segmentation, semantic
annotation, duplicate detection and normalization (port of
morphablegraphs_tpu.construct.preprocessing).

The forward kinematics of a whole clip runs in one batched pass on the
card (CUDA unless a function is given another device); the bit vectors,
keyframes and sections are host numpy on its output, as in the JAX
package.  `smooth_bitvector` is also what grounding's contact detection
applies.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_positions
from ..utils import device as device_mod

DEFAULT_FEATURES = ("LeftFoot", "RightFoot")


def _positions(skeleton: Skeleton, frames, device, who: str) -> np.ndarray:
    """Global node positions [..., n_nodes, 3] of frames, FK on `device`."""
    dev = device_mod.resolve(device, who)
    return fk_positions(skeleton, torch.as_tensor(
        np.asarray(frames, np.float32), device=dev)).cpu().numpy()


def calc_contact_bitvector(skeleton: Skeleton, frames: np.ndarray,
                           features=DEFAULT_FEATURES, threshold: float = 0.2,
                           smoothing_window: int = 5,
                           device=None) -> Dict[str, np.ndarray]:
    """Per-frame ground-contact bits per foot joint (reference bitvector.py
    calc_bitvector_walking :117-230): contact where the squared joint speed
    is below the threshold and the joint is near its lowest height; short
    flickers removed by a majority vote."""
    pos = _positions(skeleton, frames, device, "calc_contact_bitvector")
    out = {}
    for f in features:
        if f not in skeleton.node_names:
            continue
        p = pos[:, skeleton.index_of(f)]  # [T, 3]
        vel2 = np.sum(np.diff(p, axis=0) ** 2, axis=-1)
        vel2 = np.concatenate([vel2, vel2[-1:]])
        low_speed = vel2 < threshold
        y = p[:, 1]
        near_ground = y < (y.min() + max(threshold * 10, 1.0))
        bv = (low_speed & near_ground).astype(np.int8)
        out[f] = smooth_bitvector(bv, smoothing_window)
    return out


def smooth_bitvector(bv: np.ndarray, window: int = 5) -> np.ndarray:
    """Majority vote over a sliding window: bit i is set when more than
    window / 2 bits of the window centred on it are (np.convolve "same");
    a window of 1 or one longer than the vector returns it unchanged."""
    bv = np.asarray(bv, np.int8)
    if window <= 1 or len(bv) < window:
        return bv
    counts = np.convolve(bv, np.ones(window), mode="same")
    return (counts > window / 2).astype(np.int8)


def detect_walking_keyframes(skeleton: Skeleton, frames: np.ndarray,
                             features=DEFAULT_FEATURES,
                             threshold: float = 0.2,
                             device=None) -> Dict[str, List[int]]:
    """Contact-release frames per foot (reference detect_walking_keyframes
    :254-330: where the bit vector drops 1 -> 0, the foot leaves the
    ground)."""
    bitvectors = calc_contact_bitvector(skeleton, frames, features,
                                        threshold, device=device)
    keyframes = {}
    for f, bv in bitvectors.items():
        keyframes[f] = [i for i in range(1, len(bv))
                        if bv[i] == 0 and bv[i - 1] == 1]
    return keyframes


def split_walk_motion(skeleton: Skeleton, frames: np.ndarray,
                      features=DEFAULT_FEATURES, threshold: float = 0.2,
                      device=None) -> List[dict]:
    """Cut a walk clip into alternating stance segments (reference
    splitt_motion :359-430).  -> [{start_idx, end_idx, stance_foot}], the
    section format of the constructor's split DTW."""
    keyframes = detect_walking_keyframes(skeleton, frames, features,
                                         threshold, device=device)
    marks = []
    for f, kfs in keyframes.items():
        marks += [(k, f) for k in kfs]
    marks.sort()
    sections = []
    prev = 0
    for k, f in marks:
        if k - prev >= 5:  # degenerate segments are skipped
            # the foot RELEASING at the segment's end mark was in contact
            # throughout [prev, k): it is the segment's stance foot
            stance = "right" if "Right" in f else "left"
            sections.append({"start_idx": prev, "end_idx": k,
                             "stance_foot": stance})
            prev = k
    if len(frames) - prev >= 5:
        sections.append({"start_idx": prev, "end_idx": len(frames),
                         "stance_foot": "both"})
    return sections


# ---------------------------------------------------------------------------
# Semantic annotation (reference preprocessing/semantic_annotation.py and
# bitvector.py:428-555)
# ---------------------------------------------------------------------------

def planar_joint_speed(skeleton: Skeleton, frames: np.ndarray, joints,
                       device=None) -> Dict[str, np.ndarray]:
    """Squared per-frame xz-plane speed of each joint, 0 at the first
    frame (reference bitvector.py get_joint_speed :428-448), from one
    batched FK pass."""
    pos = _positions(skeleton, frames, device, "planar_joint_speed")
    out = {}
    for j in joints:
        p = pos[:, skeleton.index_of(j)]
        d = np.diff(p[:, [0, 2]], axis=0)
        out[j] = np.concatenate([[0.0], np.sum(d * d, axis=-1)])
    return out


def _contact_from_speed(speed: np.ndarray, threshold: float) -> list:
    """Contact where the planar speed is at most the threshold; majority
    smoothed; the first and last frame in contact (reference gen_annotation
    :502-523)."""
    anno = smooth_bitvector((speed <= threshold).astype(np.int8), window=3)
    anno[0] = 1
    anno[-1] = 1
    return [int(a) for a in anno]


def gen_foot_contact_annotation(skeleton: Skeleton, frames: np.ndarray,
                                feature_joints=DEFAULT_FEATURES,
                                motion_primitive_model: str = "leftStance",
                                side_step_threshold: float = 0.01,
                                device=None) -> Dict:
    """Foot-contact annotation vectors of one walk clip (reference
    bitvector.py gen_foot_contact_annotation :526-555): the stance foot is
    in contact for the whole primitive; the swing foot's contact comes
    from its planar speed against the other foot's largest speed."""
    n_frames = len(frames)
    left_j, right_j = feature_joints
    speeds = planar_joint_speed(skeleton, frames, (left_j, right_j),
                                device=device)
    ls, rs = speeds[left_j], speeds[right_j]
    start = [0.0] * n_frames
    start[0] = 1.0
    end = [0.0] * n_frames
    end[-1] = 1.0
    anno = {"start": start, "end": end}
    ones = [1.0] * n_frames
    if motion_primitive_model == "leftStance":
        anno["RightFootContact"] = ones
        anno["LeftFootContact"] = _contact_from_speed(ls, float(np.max(rs)))
    elif motion_primitive_model == "rightStance":
        anno["LeftFootContact"] = ones
        anno["RightFootContact"] = _contact_from_speed(rs, float(np.max(ls)))
    elif motion_primitive_model == "sideStep":
        anno["LeftFootContact"] = _contact_from_speed(ls,
                                                      side_step_threshold)
        anno["RightFootContact"] = _contact_from_speed(rs,
                                                       side_step_threshold)
    else:
        raise NotImplementedError(motion_primitive_model)
    return anno


_STANCE_MODEL_FOR_PRIMITIVE = (
    ("rightstance", "rightStance"), ("leftstance", "leftStance"),
    ("sidestep", "sideStep"), ("turnleft", "rightStance"),
    ("turnright", "leftStance"))


def create_semantic_annotation(elementary_action: str, motion_primitive: str,
                               skeleton: Skeleton, motions: Dict,
                               feature_joints=DEFAULT_FEATURES,
                               device=None) -> Dict:
    """Semantic annotation of a set of aligned clips of one primitive
    (reference semantic_annotation.py create_low_level_semantic_annotation
    :34-57), over in-memory clips {name: quaternion frames}: walk and
    carry get detected foot contacts, pick and place synthetic hand and
    foot contacts, screw and transfer start and end only."""
    action = elementary_action.lower()
    if "pick" in action or "place" in action:
        return _pick_place_annotation(action, motion_primitive, motions)
    if "walk" in action or "carry" in action:
        model = None
        for needle, m in _STANCE_MODEL_FOR_PRIMITIVE:
            if needle in motion_primitive.lower():
                model = m
                break
        if model is None:
            raise KeyError("unknown motion type: " + motion_primitive)
        data = {name: gen_foot_contact_annotation(skeleton, frames,
                                                  feature_joints, model,
                                                  device=device)
                for name, frames in motions.items()}
        return {"annotation_list": ["LeftFootContact", "RightFootContact",
                                    "start", "end"],
                "data": data}
    if "screw" in action or "transfer" in action:
        data = {}
        for name, frames in motions.items():
            start = [0.0] * len(frames)
            start[0] = 1.0
            end = [0.0] * len(frames)
            end[-1] = 1.0
            data[name] = {"start": start, "end": end}
        return {"annotation_list": ["start", "end"], "data": data}
    raise KeyError("unknown action type: " + elementary_action)


def _pick_place_annotation(action: str, motion_primitive: str,
                           motions: Dict) -> Dict:
    """Synthetic hand and foot contacts of pick/place primitives
    (reference gen_synthetic_semantic_annotation_pick_and_place :91-137):
    a 'first' (reach) primitive ends with hand contact, a 'second'
    (retrieve) primitive holds it throughout; the feet stay grounded."""
    data = {}
    for name, frames in motions.items():
        n = len(frames)
        left_hand = np.zeros(n)
        right_hand = np.zeros(n)
        if motion_primitive == "first":
            idx = slice(-1, None)
        elif motion_primitive == "second":
            idx = slice(None)
        else:
            raise ValueError("unsupported pick/place primitive: "
                             + motion_primitive)
        if "left" in action or "both" in action:
            left_hand[idx] = 1
        if "right" in action or "both" in action:
            right_hand[idx] = 1
        start = np.zeros(n)
        start[0] = 1.0
        end = np.zeros(n)
        end[-1] = 1.0
        data[name] = {"leftHandContact": left_hand.tolist(),
                      "rightHandContact": right_hand.tolist(),
                      "leftFootContact": [1.0] * n,
                      "rightFootContact": [1.0] * n,
                      "start": start.tolist(), "end": end.tolist()}
    return {"annotation_list": ["leftHandContact", "rightHandContact",
                                "leftFootContact", "rightFootContact",
                                "start", "end"],
            "data": data}


# ---------------------------------------------------------------------------
# Duplicate detection (reference preprocessing/hasher.py)
# ---------------------------------------------------------------------------

def hash_motions(motions: Dict) -> Dict[str, list]:
    """Group motions by content hash (reference construction/
    preprocessing/hasher.py duplicate-file detection)."""
    import hashlib
    groups: Dict[str, list] = {}
    for key, m in motions.items():
        h = hashlib.sha1(np.ascontiguousarray(np.asarray(m, np.float32))
                         .tobytes()).hexdigest()
        groups.setdefault(h, []).append(key)
    return groups


def find_duplicates(motions: Dict) -> List[list]:
    """Keys of motions with identical content."""
    return [keys for keys in hash_motions(motions).values() if len(keys) > 1]


# ---------------------------------------------------------------------------
# Normalization (reference motion_normalization.py)
# ---------------------------------------------------------------------------

def normalize_motion(frames: np.ndarray, ref_orientation=(0.0, -1.0),
                     zero_height: bool = True, device=None) -> np.ndarray:
    """Rotate the first frame's heading onto the reference direction and
    move the root start to the origin (reference MotionNormalization).
    zero_height=False keeps the clip's root height (XZ still go to the
    origin; the spatial aligner zeroes all three, so the height is put
    back)."""
    from .constructor import align_frames_spatially
    frames = np.asarray(frames, np.float64)
    y0 = float(frames[0, 1])
    out = align_frames_spatially({0: frames}, ref_orientation,
                                 device=device)[0]
    if not zero_height:
        out[:, 1] += y0
    return out


# ---------------------------------------------------------------------------
# Keyframe detection by pose distance (reference keyframe_detection.py)
# ---------------------------------------------------------------------------

def detect_keyframes_by_pose_distance(skeleton: Skeleton, frames: np.ndarray,
                                      reference_pose: np.ndarray,
                                      n_keyframes: int = 1,
                                      device=None) -> List[int]:
    """Frames whose pose point cloud is closest to a reference pose: the
    local minima of the transform-invariant distance curve, best first,
    more than 10 frames apart."""
    from .dtw import pair_distance
    dev = device_mod.resolve(device, "detect_keyframes_by_pose_distance")
    clouds = fk_positions(skeleton, torch.as_tensor(
        np.asarray(frames, np.float32), device=dev))
    ref_cloud = fk_positions(skeleton, torch.as_tensor(
        np.asarray(reference_pose, np.float32), device=dev))
    d = pair_distance(clouds, ref_cloud[None]).cpu().numpy()
    # LOCAL minima (endpoints allowed), best first: the smallest values
    # with a separation would pick two points on one deep valley's slopes
    n = len(d)
    is_min = np.ones(n, bool)
    if n > 1:
        is_min[1:] &= d[1:] <= d[:-1]
        is_min[:-1] &= d[:-1] <= d[1:]
    minima = np.flatnonzero(is_min)
    order = minima[np.argsort(d[minima])]
    picked: List[int] = []
    for i in order:
        if all(abs(int(i) - p) > 10 for p in picked):
            picked.append(int(i))
        if len(picked) >= n_keyframes:
            break
    return sorted(picked)
