"""Parity of the PyTorch port's hand poses (`synthesis.hand_pose`) and
`ops.quat.slerp` with the JAX package's on the CPU, on the inputs of
tests/test_aux_components.py (WALK_BVH, whose Right*/Left* leg joints stand
in for hands).  Tolerance: 1e-6 (the overwrite is a copy; the slerp blend
rounds in float32 as JAX's does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.ops import quat as qj  # noqa: E402
from morphablegraphs_tpu.synthesis import hand_pose as hpj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import quat as qt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import hand_pose as hpt  # noqa: E402

from torch_parity import release_jax_executables  # noqa: E402,F401

GRIP = np.array([0.0, 0.0, 1.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def skels():
    return skj.load_bvh(synj.WALK_BVH)[0], skt.load_bvh(synj.WALK_BVH)[0]


def _identity_frames(skel, n):
    frames = np.zeros((n, skel.n_frame_params), np.float32)
    frames[:, 3::4] = 1.0
    return frames


def _random_frames(skel, n, seed=3):
    rng = np.random.default_rng(seed)
    frames = np.zeros((n, skel.n_frame_params), np.float32)
    for j in range(skel.n_animated):
        q = rng.normal(size=(n, 4)).astype(np.float32)
        frames[:, 3 + 4 * j: 7 + 4 * j] = q / np.linalg.norm(
            q, axis=1, keepdims=True)
    return frames


# name -> (smoothing window, poses, frames, events, then a carried call)
CASES = {
    # the attach overlay (tests/test_aux_components.py:88)
    "attach": (4, {"pick": {"RightLeg": GRIP}}, "identity20",
               [{"keyframe": 5, "event": "attach",
                 "parameters": {"joint": "RightLeg"}}], False),
    # the blend touches only the pose's joints (:110)
    "smoothing_random_motion": (
        8, {"pick": {"RightLeg": GRIP}}, "random20",
        [{"keyframe": 10, "event": "attach",
          "parameters": {"joint": "RightLeg"}}], False),
    # transfer swaps the hands, then a carried call without events (:559)
    "transfer_carry_status": (
        0, {"pick": {"RightLeg": GRIP, "LeftLeg": GRIP}}, "identity30",
        [{"keyframe": 5, "event": "attach",
          "parameters": {"joint": "RightLeg"}},
         {"keyframe": 15, "event": "transfer",
          "parameters": {"joint": "LeftLeg"}}], True),
    # attach then detach on both hands, blended over 6 frames
    "attach_detach_both": (
        6, {"pick": {"RightLeg": GRIP, "LeftLeg": GRIP[::-1].copy()}},
        "random30",
        [{"keyframe": 4, "event": "attach",
          "parameters": {"joint": "LeftLeg"}},
         {"keyframe": 8, "event": "attach",
          "parameters": {"joint": "RightLeg"}},
         {"keyframe": 20, "event": "detach",
          "parameters": {"joint": "LeftLeg"}}], False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_generate_hand_poses_matches_jax(skels, name):
    """generate_hand_poses (the status walk, the overwrite and the slerp
    blend) frame for frame, and the statuses it ends with."""
    window, poses, kind, events, carry = CASES[name]
    out = []
    for mod, skel in ((hpj, skels[0]), (hpt, skels[1])):
        frames = (_identity_frames(skel, int(kind[-2:]))
                  if kind.startswith("identity")
                  else _random_frames(skel, int(kind[-2:])))
        gen = mod.HandPoseGenerator(skel, smoothing_window=window)
        for pose, quats in poses.items():
            gen.add_pose(pose, quats)
        res = [gen.generate_hand_poses(frames, events)]
        if carry:
            res.append(gen.generate_hand_poses(frames, [],
                                               carry_status=True))
        out.append((res, dict(gen.status)))
    (res_j, st_j), (res_t, st_t) = out
    assert st_t == st_j
    for a, b in zip(res_j, res_t):
        np.testing.assert_allclose(b, a, atol=1e-6)
    if name == "attach":
        sl = skels[1].quat_slice("RightLeg")
        np.testing.assert_allclose(res_t[0][15, sl], GRIP, atol=1e-6)


HAND_POSE_INFO = {
    "status_change_map": {"attach": "pick", "release": "standard"},
    "right_hand_skeleton": {"joint_names": ["RightLeg", "RightFoot"]},
    "left_hand_skeleton": {"joint_names": ["LeftLeg"]},
    "poses": {"pick": {"RightHand": [0.0, 1.0, 0.0, 0.0,
                                     0.5, 0.5, 0.5, 0.5],
                       "LeftHand": [1.0, 0.0, 0.0, 0.0]},
              "flat": {"RightLeg": [0.0, 0.0, 0.0, 1.0]}},
}


def test_graph_dict_hand_pose_info_matches_jax(skels):
    """A graph dict with hand_pose_info gives both packages' graphs a
    HandPoseGenerator with the same poses and event map (the per-hand
    vector form and the flat joint map), which then pose a motion
    alike."""
    gd = dict(synj.make_graph_dict(n_joints=11),
              hand_pose_info=HAND_POSE_INFO)
    g_j, g_t = gj.build_graph_from_dict(gd), gt.build_graph_from_dict(gd)
    hp_j, hp_t = g_j.hand_pose_generator, g_t.hand_pose_generator
    assert hp_t is not None and sorted(hp_t.pose_map) == sorted(hp_j.pose_map)
    for name, pose in hp_j.pose_map.items():
        assert sorted(hp_t.pose_map[name].joint_quats) == \
            sorted(pose.joint_quats)
        for joint, q in pose.joint_quats.items():
            np.testing.assert_array_equal(hp_t.pose_map[name].joint_quats[
                joint], q)
    assert hp_t.status_change_map == hp_j.status_change_map
    assert hp_t._status_for_event("release", "pick") == "standard"
    assert gt.build_graph_from_dict(
        synj.make_graph_dict()).hand_pose_generator is None
    events = [{"keyframe": 3, "event": "attach",
               "parameters": {"joint": "RightLeg"}},
              {"keyframe": 12, "event": "release",
               "parameters": {"joint": "RightLeg"}}]
    for gen, skel in ((hp_j, skels[0]), (hp_t, skels[1])):
        gen.skeleton = skel
        gen.smoothing_window = 4
    np.testing.assert_allclose(
        hp_t.generate_hand_poses(_random_frames(skels[1], 20), events),
        hp_j.generate_hand_poses(_random_frames(skels[0], 20), events),
        atol=1e-6)


@pytest.mark.parametrize("case", ["scalar_t", "per_quat_t",
                                  "near_parallel"])
def test_slerp_matches_jax(case):
    """quat.slerp: one weight for all, one weight per quaternion, and
    nearly parallel pairs (the nlerp branch) with the sign fix."""
    rng = np.random.default_rng(7)
    q0 = rng.normal(size=(16, 4)).astype(np.float32)
    q1 = rng.normal(size=(16, 4)).astype(np.float32)
    t = np.float32(0.3)
    if case == "per_quat_t":
        t = rng.random(16).astype(np.float32)
    if case == "near_parallel":
        q1 = -(q0 + 1e-7 * rng.normal(size=(16, 4)).astype(np.float32))
    np.testing.assert_allclose(
        qt.slerp(torch.as_tensor(q0), torch.as_tensor(q1), torch.as_tensor(
            t)).numpy(),
        np.asarray(qj.slerp(jnp.asarray(q0), jnp.asarray(q1),
                            jnp.asarray(t))), atol=1e-6)
