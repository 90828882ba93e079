"""Skeleton-to-skeleton retargeting by global-orientation copy (port of
morphablegraphs_tpu.models.retarget).

The source's global joint orientations come from one batched FK pass; each
mapped target joint's local rotation is solved top-down so its global
orientation equals its source joint's:

    q_local_dst(j) = inv(q_global_dst(parent(j))) * q_global_src(map(j))

Unmapped target joints keep the identity rotation; the root translation is
copied and scaled.  Both rigs are assumed to share a T-pose convention."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..ops import quat
from ..utils import device as device_mod
from .skeleton import Skeleton, fk_global, load_bvh

# the reference REST layer's Rocketbox -> game-engine joint map
ROCKETBOX_TO_GAME_ENGINE_MAP: Dict[str, str] = {
    "Hips": "pelvis",
    "Spine": "spine_01",
    "Spine_1": "spine_02",
    "Neck": "neck_01",
    "Head": "head",
    "LeftShoulder": "clavicle_l",
    "RightShoulder": "clavicle_r",
    "LeftArm": "upperarm_l",
    "RightArm": "upperarm_r",
    "LeftForeArm": "lowerarm_l",
    "RightForeArm": "lowerarm_r",
    "LeftHand": "hand_l",
    "RightHand": "hand_r",
    "LeftUpLeg": "thigh_l",
    "RightUpLeg": "thigh_r",
    "LeftLeg": "calf_l",
    "RightLeg": "calf_r",
    "LeftFoot": "foot_l",
    "RightFoot": "foot_r",
}
GAME_ENGINE_TO_ROCKETBOX_MAP = {v: k for k, v in
                                ROCKETBOX_TO_GAME_ENGINE_MAP.items()}


def load_target_skeleton(file_path: str,
                         scale_factor: float = 1.0) -> Skeleton:
    """A BVH's skeleton with its offsets scaled."""
    skel, _ = load_bvh(file_path)
    if scale_factor != 1.0:
        skel = dataclasses.replace(
            skel, offsets=np.asarray(skel.offsets, np.float64) * scale_factor)
    return skel


def retarget_frames(src_skel: Skeleton, frames, dst_skel: Skeleton,
                    joint_map: Optional[Dict[str, str]] = None,
                    scale_factor: float = 1.0, device=None) -> np.ndarray:
    """Quaternion frames [T, 3 + 4 J_src] -> [T, 3 + 4 J_dst] (float32
    numpy), computed on `device` (the CUDA device unless given another).
    joint_map maps source joint names to target joint names; by default
    every animated joint the two skeletons share."""
    dev = device_mod.resolve(device, "retarget_frames")
    frames = torch.as_tensor(np.asarray(frames, np.float32), device=dev)
    if joint_map is None:
        joint_map = {n: n for n in src_skel.animated_joints
                     if n in dst_skel.animated_joints}
    dst_to_src = [-1] * dst_skel.n_animated
    for src_name, dst_name in joint_map.items():
        if (src_name in src_skel.animated_joints
                and dst_name in dst_skel.animated_joints):
            dst_to_src[dst_skel.animated_index_of(dst_name)] = \
                src_skel.animated_index_of(src_name)
    # each target joint's nearest animated ancestor (animated index)
    name_to_anim = {n: i for i, n in enumerate(dst_skel.animated_joints)}
    dst_parent = [-1] * dst_skel.n_animated
    for i, name in enumerate(dst_skel.animated_joints):
        p = dst_skel.parents[dst_skel.index_of(name)]
        while p >= 0:
            if dst_skel.node_names[p] in name_to_anim:
                dst_parent[i] = name_to_anim[dst_skel.node_names[p]]
                break
            p = dst_skel.parents[p]

    _, src_glob = fk_global(src_skel, frames)  # [T, n_nodes, 4]
    src_glob = src_glob[:, [src_skel.index_of(n)
                            for n in src_skel.animated_joints]]
    identity = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=frames.dtype,
                            device=dev).expand(frames.shape[0], 4)
    # the target's joints are listed parents first, so a parent's global
    # orientation is known before its children's
    glob, locals_ = [], []
    for j in range(dst_skel.n_animated):
        parent = glob[dst_parent[j]] if dst_parent[j] >= 0 else identity
        if dst_to_src[j] >= 0:
            g = src_glob[:, dst_to_src[j]]
            local = quat.multiply(quat.conjugate(parent), g)
        else:
            local = identity
            g = quat.multiply(parent, local)
        glob.append(g)
        locals_.append(quat.normalize(local))
    out = torch.cat([frames[:, :3] * scale_factor] + locals_, dim=1)
    return out.cpu().numpy()
