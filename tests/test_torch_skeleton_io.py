"""Parity of the port's skeleton I/O with the JAX package: skeleton.json
loading, BVH channel rows <-> quaternion frames, BVH text and the FK point
cloud, on TEST_BVH, WALK_BVH and REF_BVH.

Both packages convert Euler angles with the same float64 numpy and scipy
calls, so quaternion frames and BVH channel rows compare exactly and
write_bvh's text byte for byte.  A write -> load round trip holds
rotations up to quaternion sign within 1e-4 (the text keeps 6 decimals of
a degree) and Euler text only on frames away from the gimbal (middle
angle within 80 degrees); the FK point cloud within 1e-4 cm on unit
quaternions."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402

import torch_parity as tp  # noqa: E402

BVHS = {"test": synj.TEST_BVH, "walk": synj.WALK_BVH, "ref": synj.REF_BVH}


def _euler_rows(skel, n, seed, gimbal_free=True):
    """Random BVH channel rows: positions in +-50 cm, rotations in
    +-170 degrees, the middle angle of each triplet within +-80 (or
    anywhere up to +-180 with gimbal_free=False)."""
    rng = np.random.default_rng(seed)
    cols = []
    for chans in skel.node_channels:
        rot_i = 0
        for c in chans:
            if c.endswith("position"):
                cols.append(rng.uniform(-50, 50, n))
            else:
                lim = 80 if (rot_i == 1 and gimbal_free) else 170
                cols.append(rng.uniform(-lim, lim, n))
                rot_i += 1
    return np.stack(cols, axis=1)


def _rest_skeleton_json():
    half = np.deg2rad(90) / 2
    return {"root": "Hips", "frame_time": 1 / 60,
            "animated_joints": ["Hips", "Arm"],
            "nodes": {
                "Hips": {"offset": [0, 90, 0], "children": ["Fixed", "Arm"]},
                "Fixed": {"offset": [0, 10, 0], "children": ["Tip"],
                          "rotation": [float(np.cos(half)), 0.0, 0.0,
                                       float(np.sin(half))]},
                "Tip": {"offset": [0, 5, 0], "children": []},
                "Arm": {"offset": [10, 0, 0], "children": []},
            }}


def test_skeleton_json_matches_jax():
    data = _rest_skeleton_json()
    no_root = {k: v for k, v in data.items() if k != "root"}
    no_anim = {k: v for k, v in data.items() if k != "animated_joints"}
    for d in (data, no_root, no_anim):
        s_j, s_t = skj.load_skeleton_json(d), skt.load_skeleton_json(d)
        for f in ("node_names", "parents", "node_channels",
                  "animated_joints", "frame_time", "rest_rotations"):
            assert getattr(s_t, f) == getattr(s_j, f), f
        np.testing.assert_array_equal(s_t.offsets, s_j.offsets)


@pytest.mark.parametrize("name", sorted(BVHS))
def test_bvh_frames_and_text_match_jax(name):
    skel_j, _ = skj.load_bvh(BVHS[name])
    skel_t, _ = skt.load_bvh(BVHS[name])
    euler = _euler_rows(skel_t, 12, seed=len(name), gimbal_free=False)
    qf_j = skj.bvh_to_quat_frames(skel_j, euler)
    qf_t = skt.bvh_to_quat_frames(skel_t, euler)
    np.testing.assert_array_equal(qf_t, qf_j)
    np.testing.assert_array_equal(skt.quat_frames_to_bvh(skel_t, qf_t),
                                  skj.quat_frames_to_bvh(skel_j, qf_j))
    assert skt.write_bvh(skel_t, qf_t) == skj.write_bvh(skel_j, qf_j)


@pytest.mark.parametrize("name", sorted(BVHS))
def test_bvh_round_trip(name, tmp_path):
    """write_bvh -> load_bvh + bvh_to_quat_frames gives the frames back:
    rotations up to sign; Euler rows away from the gimbal."""
    skel, _ = skt.load_bvh(BVHS[name])
    euler = _euler_rows(skel, 12, seed=7)
    qf = skt.bvh_to_quat_frames(skel, euler)
    path = str(tmp_path / "out.bvh")
    skt.write_bvh(skel, qf, path)
    skel2, euler2 = skt.load_bvh(path)
    assert skel2.node_names == skel.node_names
    np.testing.assert_allclose(euler2, euler, atol=1e-4)
    assert tp.rotations_diff(skt.bvh_to_quat_frames(skel2, euler2),
                             qf) < 1e-4


def test_rest_rotation_export_matches_jax():
    """A fixed joint's rest rotation is written as rotation channels, the
    same text as the JAX package's, and the reloaded geometry is FK's."""
    data = _rest_skeleton_json()
    s_j, s_t = skj.load_skeleton_json(data), skt.load_skeleton_json(data)
    frames = skt.bvh_to_quat_frames(s_t, _euler_rows(s_t, 3, seed=2))
    text = skt.write_bvh(s_t, frames)
    assert text == skj.write_bvh(s_j, frames)
    s2, e2 = skt.load_bvh(text)
    tip = skt.fk_positions(s_t, torch.as_tensor(frames))[:, s_t.index_of(
        "Tip")]
    tip2 = skt.fk_positions(s2, torch.as_tensor(
        skt.bvh_to_quat_frames(s2, e2)))[:, s2.index_of("Tip")]
    np.testing.assert_allclose(tip2.numpy(), tip.numpy(), atol=1e-3)


@pytest.mark.parametrize("name", sorted(BVHS))
@pytest.mark.parametrize("normalize", [False, True])
def test_fk_point_cloud_matches_jax(name, normalize):
    skel_j, _ = skj.load_bvh(BVHS[name])
    skel_t, _ = skt.load_bvh(BVHS[name])
    qf = skt.bvh_to_quat_frames(skel_t, _euler_rows(skel_t, 5, seed=3))
    pc_j = np.asarray(skj.fk_point_cloud(skel_j, jnp.asarray(qf),
                                         normalize=normalize))
    pc_t = skt.fk_point_cloud(skel_t, torch.as_tensor(qf),
                              normalize=normalize)
    np.testing.assert_allclose(pc_t.numpy(), pc_j, atol=1e-4)
    if normalize:
        np.testing.assert_allclose(pc_t[:, 0].numpy(),
                                   np.tile(skel_t.offsets[0], (5, 1)),
                                   atol=1e-5)
