"""Parity of the host-side pieces of the PyTorch port's streaming planner
with their JAX counterparts on the same seeded numpy inputs:
`quat.conjugate`, the CCD, look-at and joint-limit edits of `ops/ik.py`,
`models/skeleton_models`, `constraints/server_builder`, the state queue
(`synthesis/state_queue.py`) and `synthesis/graph_walk_io.py`.

Tolerance: float32 rounding, 1e-5 absolute or relative, unless a test
states otherwise.  The JAX package edits one frame and vmaps the edit;
the port's functions take the frames at once, so batches compare against
the vmapped JAX call."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import server_builder as sbj  # noqa: E402
from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.models import skeleton_models as smj  # noqa: E402
from morphablegraphs_tpu.ops import ik as ikj  # noqa: E402
from morphablegraphs_tpu.ops import quat as qj  # noqa: E402
from morphablegraphs_tpu.synthesis import graph_walk_io as gwj  # noqa: E402
from morphablegraphs_tpu.synthesis import motion_generator as mgj  # noqa: E402
from morphablegraphs_tpu.synthesis import state_queue as sqj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import \
    server_builder as sbt  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.models import \
    skeleton_models as smt  # noqa: E402
from morphablegraphs_tpu_torch.ops import ik as ikt  # noqa: E402
from morphablegraphs_tpu_torch.ops import quat as qt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    graph_walk_io as gwt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    motion_generator as mgt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    state_queue as sqt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

BVHS = {"toy": synj.TEST_BVH, "ref": synj.REF_BVH}


@pytest.fixture(scope="module", params=sorted(BVHS))
def skels(request):
    """(JAX skeleton, port skeleton) of the toy and the reference-scale
    BVH."""
    return (skj.load_bvh(BVHS[request.param])[0],
            skt.load_bvh(BVHS[request.param])[0])


def _frames(skel, n, seed, unit=True, scale=0.3):
    """n frames [n, D] of the skeleton: root near (0, 90, 0), joint
    quaternions identity plus seeded noise, normalized when unit."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, skel.n_frame_params), np.float32)
    f[:, :3] = rng.standard_normal((n, 3)) * 5 + [0.0, 90.0, 0.0]
    q = rng.standard_normal((n, skel.n_animated, 4)) * scale
    q[..., 0] += 1.0
    if unit:
        q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f[:, 3:] = q.reshape(n, -1)
    return f


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def test_quat_conjugate_matches_jax():
    q = np.random.default_rng(0).standard_normal((7, 3, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(qt.conjugate(_t(q)).numpy(),
                                  np.asarray(qj.conjugate(jnp.asarray(q))))


def _chain(skel, joint, max_len=3, stop_at=None):
    from morphablegraphs_tpu_torch.synthesis.state_planner import _ccd_chain
    return _ccd_chain(skel, joint, max_len, stop_at)


@pytest.mark.parametrize("unit", [True, False])
def test_run_ccd_matches_jax(skels, unit):
    """One frame with one target, and a batch of frames with a target
    each (the gesture edit's form), against run_ccd and its vmap.  The
    CCD passes repeat an atan2 of a cross-product norm, so a few float32
    roundings compound: 1e-4.  The chain's first joint is the effector
    itself, whose from-vector is 0: its turn is the identity in the port,
    and in the JAX package the identity or its negative by the sign of a
    zero dot product (atan2(0, -0.0) = pi), so quaternions compare up to
    sign (one rotation either way)."""
    skel_j, skel_t = skels
    joint = "RightHand" if "RightHand" in skel_t.node_names else "Head"
    chain = _chain(skel_t, joint, max_len=3)
    assert chain == _chain(skel_j, joint, max_len=3)
    node = skel_t.index_of(joint)
    frames = _frames(skel_t, 6, seed=1, unit=unit)
    rng = np.random.default_rng(2)
    pos = np.asarray(skj.fk_positions(skel_j, jnp.asarray(frames)))[:, node]
    targets = (pos + rng.standard_normal(pos.shape) * 10).astype(np.float32)
    out_j = np.asarray(ikj.run_ccd(skel_j, chain, node, jnp.asarray(frames[0]),
                                   jnp.asarray(targets[0]), n_iters=4))
    out_t = ikt.run_ccd(skel_t, chain, node, _t(frames[0]), _t(targets[0]),
                        n_iters=4).numpy()
    assert tp.rotations_diff(out_t, out_j) <= 1e-4
    batch_j = np.asarray(jax.vmap(lambda f, t: ikj.run_ccd(
        skel_j, chain, node, f, t, n_iters=2))(jnp.asarray(frames),
                                               jnp.asarray(targets)))
    batch_t = ikt.run_ccd(skel_t, chain, node, _t(frames), _t(targets),
                          n_iters=2).numpy()
    assert tp.rotations_diff(batch_t, batch_j) <= 1e-4
    if unit:
        # the edit moved the effector toward its target
        before = np.linalg.norm(pos - targets, axis=-1)
        after = np.linalg.norm(skt.fk_positions(skel_t, _t(batch_t)).numpy()[
            :, node] - targets, axis=-1)
        assert float(after.mean()) < float(before.mean())


def test_look_at_matches_jax(skels):
    """A single frame and a batch with one target (the planner's look-at
    window), and a local direction other than +z."""
    skel_j, skel_t = skels
    head = skel_t.animated_index_of("Head")
    frames = _frames(skel_t, 5, seed=3)
    target = np.array([40.0, 150.0, 80.0], np.float32)
    out_j = np.asarray(ikj.look_at(skel_j, head, jnp.asarray(frames[0]),
                                   jnp.asarray(target)))
    out_t = ikt.look_at(skel_t, head, _t(frames[0]), _t(target)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    batch_j = np.asarray(jax.vmap(lambda f: ikj.look_at(
        skel_j, head, f, jnp.asarray(target), (1.0, 0.0, 0.0)))(
            jnp.asarray(frames)))
    batch_t = ikt.look_at(skel_t, head, _t(frames), _t(target),
                          (1.0, 0.0, 0.0)).numpy()
    np.testing.assert_allclose(batch_t, batch_j, atol=1e-5)


def test_apply_joint_limits_matches_jax(skels):
    """The swing-twist clamp over a batch [T, D] and a leading [2, T, D]:
    values against JAX; joints inside their range, and unmasked joints,
    bit for bit the input; quaternions near w = 0 (both signs of w within
    1e-7 of 0, where the w >= 0 canonicalization picks the branch)."""
    skel_j, skel_t = skels
    axes, mins, maxs, mask = smt.build_limit_table(skel_t)
    frames = _frames(skel_t, 12, seed=4, scale=1.5)
    # twists exactly inside every range: identity quaternions
    frames[0, 3:] = np.tile([1.0, 0.0, 0.0, 0.0], skel_t.n_animated)
    # near w = 0: a half-turn about each joint's limit axis, w = +-1e-7
    for k, w in ((1, 1e-7), (2, -1e-7)):
        q = np.concatenate([np.full((skel_t.n_animated, 1), w, np.float32),
                            axes], 1)
        frames[k, 3:] = (q / np.linalg.norm(q, axis=1,
                                            keepdims=True)).reshape(-1)
    args_j = [jnp.asarray(a) for a in (axes, mins, maxs, mask)]
    args_t = [_t(a) for a in (axes, mins, maxs, mask)]
    out_j = np.asarray(ikj.apply_joint_limits(jnp.asarray(frames), *args_j))
    out_t = ikt.apply_joint_limits(_t(frames), *args_t).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    two = np.stack([frames, frames[::-1]])
    np.testing.assert_allclose(
        ikt.apply_joint_limits(_t(two), *args_t).numpy(),
        np.asarray(ikj.apply_joint_limits(jnp.asarray(two), *args_j)),
        atol=1e-5)
    np.testing.assert_array_equal(out_t[0], frames[0])
    q = frames[:, 3:].reshape(len(frames), -1, 4)
    q = np.where(q[..., :1] < 0, -q, q)
    theta = 2 * np.arctan2((q[..., 1:] * axes).sum(-1), q[..., 0])
    inside = (theta > mins + 1e-4) & (theta < maxs - 1e-4)
    keep = inside | (mask == 0)
    got = out_t[:, 3:].reshape(q.shape)
    np.testing.assert_array_equal(got[keep], frames[:, 3:].reshape(
        q.shape)[keep])
    assert (~keep).any()  # some twist was clamped
    # every clamped twist lies in its range
    g = np.where(got[..., :1] < 0, -got, got)
    t_c = 2 * np.arctan2((g[..., 1:] * axes).sum(-1), g[..., 0])
    on = mask > 0
    assert np.all(t_c[:, on] >= mins[on] - 1e-4)
    assert np.all(t_c[:, on] <= maxs[on] + 1e-4)


def test_skeleton_models_match_jax(skels):
    """build_limit_table (default and a custom table), mirror_frames and
    depth_joint_weights against JAX; the name tables are the same."""
    skel_j, skel_t = skels
    assert smt.UPPER_BODY_JOINTS == smj.UPPER_BODY_JOINTS
    assert smt.LOWER_BODY_JOINTS == smj.LOWER_BODY_JOINTS
    assert smt.STANDARD_MIRROR_MAP == smj.STANDARD_MIRROR_MAP
    assert smt.JOINT_CONSTRAINTS == smj.JOINT_CONSTRAINTS
    custom = dict(smj.JOINT_CONSTRAINTS,
                  Spine={"axis": (1, 2, 0), "min_angle": -20.0,
                         "max_angle": 35.0})
    for table in (None, custom):
        for a, b in zip(smt.build_limit_table(skel_t, table),
                        smj.build_limit_table(skel_j, table)):
            np.testing.assert_array_equal(a, b)
    frames = _frames(skel_t, 4, seed=5)
    np.testing.assert_array_equal(smt.mirror_frames(skel_t, frames),
                                  smj.mirror_frames(skel_j, frames))
    assert smt.depth_joint_weights(skel_t, 0.8) == \
        smj.depth_joint_weights(skel_j, 0.8)


def test_unity_round_trip_matches_jax(skels):
    """mg -> Unity -> mg gives the frame back, and both directions are
    JAX's values exactly (the same numpy code)."""
    skel_j, skel_t = skels
    frame = _frames(skel_t, 1, seed=6)[0]
    u_t = sbt.mg_frame_to_unity_frame(skel_t, frame, scale=2.0)
    assert u_t == sbj.mg_frame_to_unity_frame(skel_j, frame, scale=2.0)
    back_t = sbt.unity_frame_to_mg_frame(skel_t, u_t, scale=0.5)
    np.testing.assert_array_equal(
        back_t, sbj.unity_frame_to_mg_frame(skel_j, u_t, scale=0.5))
    np.testing.assert_allclose(back_t, frame, atol=1e-6)


def test_parse_unity_constraints_matches_jax(skels):
    skel_j, skel_t = skels
    descs = [{"joint": "Head", "position": {"x": 1.0, "y": 2.0, "z": 3.0},
              "orientation": {"w": 0.5, "x": 0.5, "y": -0.5, "z": 0.5},
              "holdStart": 3, "holdEnd": 9, "mirrorJoint": "Spine",
              "srcToolCos": {"x": [1, 0, 0]},
              "destToolCos": {"y": [0, 1, 0]}},
             {"joint": "Hips", "position": {"x": -4.0, "y": 0.0, "z": 7.5}}]
    out_t = sbt.parse_unity_constraints(skel_t, descs)
    out_j = sbj.parse_unity_constraints(skel_j, descs)
    assert len(out_t) == len(out_j) == 2
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.position, b.position)
        assert (a.orientation_q is None) == (b.orientation_q is None)
        if a.orientation_q is not None:
            np.testing.assert_array_equal(a.orientation_q, b.orientation_q)
        assert (a.joint, a.hold_start, a.hold_end, a.mirror_joint,
                a.src_tool_cos, a.dest_tool_cos) == (
            b.joint, b.hold_start, b.hold_end, b.mirror_joint,
            b.src_tool_cos, b.dest_tool_cos)


def test_generate_walk_constraints_matches_jax():
    """The per-step walk set (position, direction, alignment) against
    JAX's, every field."""
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    key = ("walk", "leftStance")
    prev = tp.prev_frame(g_t.skeleton.n_frame_params, 3.0, 20.0)[None]
    sc_t = sbt.generate_walk_constraints(
        g_t.skeleton, g_t.nodes[key].primitive, [0.3, 1.0],
        target_pos=[5.0, 0.0, 60.0], position_weight=2.0,
        direction_weight=0.5, prev_frames=prev)
    sc_j = tp.to_numpy(sbj.generate_walk_constraints(
        g_j.skeleton, g_j.nodes[key].primitive, [0.3, 1.0],
        target_pos=[5.0, 0.0, 60.0], position_weight=2.0,
        direction_weight=0.5, prev_frames=prev))
    from morphablegraphs_tpu_torch.constraints import compiled as ct
    ref = ct.from_jax_numpy(sc_j, host=True)
    import dataclasses
    for f in dataclasses.fields(ct.StepConstraints):
        a, b = getattr(sc_t, f.name), getattr(ref, f.name)
        if f.name in ("traj", "ts_trajs"):
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=f.name)


# -- state queue -----------------------------------------------------------

def _queue_frames(n, d=19, z0=0.0, seed=0):
    """test_serve.py's clip: root walking +z from z0, joint quaternions
    identity plus seeded noise."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, d), np.float32)
    f[:, 2] = z0 + np.arange(n)
    f[:, 0] = rng.standard_normal() * 3
    q = rng.standard_normal((n, (d - 3) // 4, 4)) * 0.2
    q[..., 0] += 1.0
    f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, -1)
    return f


def _queues(**kw):
    skel_j = skj.load_bvh(synj.TEST_BVH)[0]
    skel_t = skt.load_bvh(synj.TEST_BVH)[0]
    return (sqj.MGStateQueue(skel_j, 1 / 30, **kw),
            sqt.MGStateQueue(skel_t, 1 / 30, device="cpu", **kw))


def _entries_match(a, b, atol=1e-5):
    assert (a.node_key, a.node_type, a.events, a.hold_frames) == (
        b.node_key, b.node_type, b.events, b.hold_frames)
    np.testing.assert_allclose(b.state.frames, a.state.frames, rtol=1e-5,
                               atol=atol)
    assert len(a.pose_buffer) == len(b.pose_buffer)
    np.testing.assert_allclose(np.stack(b.pose_buffer),
                               np.stack(a.pose_buffer), rtol=1e-5, atol=atol)


def test_state_queue_add_align_and_idle_match_jax():
    """add_state without and with a pose buffer (the aligned, seam-smoothed
    clip), an idle state with ignore_rotation, the buffer's truncation to
    buffer_size, pops from both ends; against JAX's queue."""
    qj_, qt_ = _queues(blend_window=8, buffer_size=25)
    entries = []
    for q in (qj_, qt_):
        e1 = q.add_state(("walk", "a"), "start", _queue_frames(10, seed=1),
                         None, events={3: ["x"]}, hold_frames=(3, 4))
        far = _queue_frames(20, z0=500.0, seed=2)
        far[:, 3:7] = np.asarray(qj.about_y(jnp.asarray(0.7)))
        e2 = q.add_state(("walk", "b"), "standard", far, e1.pose_buffer)
        idle = _queue_frames(6, z0=99.0, seed=3)
        idle[:, 3:7] = np.asarray(qj.about_y(jnp.asarray(np.pi / 2)))
        e3 = q.generate_idle_state(idle, e2.pose_buffer, ignore_rotation=True)
        entries.append((e1, e2, e3))
    for a, b in zip(*entries):
        _entries_match(a, b)
    assert len(entries[1][2].pose_buffer) == 25
    assert len(qt_) == 3
    assert qt_.pop_last_state().node_type == "idle"
    assert qt_.pop().node_key == ("walk", "a")
    assert qt_.peek().node_key == ("walk", "b")


def test_queue_pop_keeps_the_newest_entries():
    """pop(keep) hands out the oldest entry only while more than `keep`
    are queued (the port's streaming consumer leaves the newest state to
    the planner; the JAX queue's pop is keep=0)."""
    _, q = _queues()
    buf = None
    for i in range(3):
        buf = q.add_state(("walk", str(i)), "standard",
                          _queue_frames(5, seed=i), buf).pose_buffer
    assert [q.pop(keep=1).node_key[1] for _ in range(2)] == ["0", "1"]
    assert q.pop(keep=1) is None and len(q) == 1
    assert q.pop().node_key[1] == "2" and q.pop() is None


@pytest.mark.parametrize("window", [10, 50, None])
def test_end_corrections_match_jax(window):
    """apply_end_pos_correction and apply_end_orientation_correction on a
    30-frame clip, with a window inside the clip, one larger than it (the
    clamp of test_serve.py::test_end_correction_window_clamps_to_state_
    length: frame 0 unchanged) and the default blend window."""
    qj_, qt_ = _queues()
    frames = _queue_frames(30, seed=4)
    target = np.array([10.0, 0.0, 40.0])
    pos_t = qt_.apply_end_pos_correction(frames, target, window=window)
    np.testing.assert_allclose(
        pos_t, qj_.apply_end_pos_correction(frames, target, window=window),
        atol=1e-5)
    dir_xz = np.array([1.0, 0.3])
    rot_t = qt_.apply_end_orientation_correction(frames, dir_xz,
                                                 window=window)
    np.testing.assert_allclose(
        rot_t, qj_.apply_end_orientation_correction(frames, dir_xz,
                                                    window=window),
        atol=1e-5)
    np.testing.assert_allclose(pos_t[-1][[0, 2]], target[[0, 2]], atol=1e-4)
    if window == 50:
        np.testing.assert_array_equal(pos_t[0], frames[0])
        np.testing.assert_allclose(rot_t[0], frames[0], atol=1e-6)


def test_correct_last_state_matches_jax():
    """correct_last_state_end_pos (a window, and window 0: the last frame
    only) and correct_last_state_end_dir edit the newest entry's frames
    and its pose buffer tail, as JAX's; an empty queue reports False."""
    qj_, qt_ = _queues(buffer_size=12)
    out = []
    for q in (qj_, qt_):
        e1 = q.add_state(("walk", "a"), "start", _queue_frames(10, seed=5),
                         None)
        q.add_state(("walk", "b"), "standard",
                    _queue_frames(30, z0=7.0, seed=6), e1.pose_buffer)
        assert q.correct_last_state_end_pos(np.array([10.0, 0, 40.0]),
                                            window=10)
        assert q.correct_last_state_end_pos(np.array([12.0, 0, 41.0]),
                                            window=0)
        assert q.correct_last_state_end_dir(np.array([0.6, 0.8]), window=15)
        out.append(q.get_last_state())
    _entries_match(*out)
    np.testing.assert_allclose(out[1].pose_buffer[-1], out[1].state.frames[-1])
    assert not _queues()[1].correct_last_state_end_pos(np.zeros(3))


# -- graph-walk I/O ----------------------------------------------------------

@pytest.fixture(scope="module")
def walk_steps():
    """Both graphs of the toy model and four steps with latents drawn by
    JAX's primitives."""
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    keys = [("walk", "beginLeftStance"), ("walk", "rightStance"),
            ("walk", "leftStance"), ("walk", "endRightStance")]
    steps = []
    for i, key in enumerate(keys):
        s = np.asarray(prj.sample_latent(jax.random.PRNGKey(10 + i),
                                         g_j.nodes[key].primitive, 1)[0])
        steps.append(dict(node_key=key, parameters=s, arc_length=12.5 * i,
                          start_frame=40 * i, end_frame=40 * i + 39,
                          error=0.25 * i,
                          time_constraints=((3, 0.5),) if i == 1 else ()))
    return g_j, g_t, steps


def test_graph_walk_json_round_trips_between_packages(walk_steps, tmp_path):
    """A walk saved by the JAX package loads in the port and the reverse;
    the JSON texts are the same."""
    _, _, steps = walk_steps
    steps_j = [mgj.GraphWalkEntry(**s) for s in steps]
    steps_t = [mgt.GraphWalkEntry(**s) for s in steps]
    assert gwt.steps_to_json(steps_t) == gwj.steps_to_json(steps_j)
    gwj.save_graph_walk(str(tmp_path / "j.json"), steps_j)
    gwt.save_graph_walk(str(tmp_path / "t.json"), steps_t)
    assert json.load(open(tmp_path / "j.json")) == json.load(
        open(tmp_path / "t.json"))
    for loaded, ref in ((gwt.load_graph_walk(str(tmp_path / "j.json")),
                         steps_j),
                        (gwj.load_graph_walk(str(tmp_path / "t.json")),
                         steps_t)):
        assert len(loaded) == len(ref)
        for a, b in zip(loaded, ref):
            assert (a.node_key, a.start_frame, a.end_frame,
                    a.time_constraints) == (b.node_key, b.start_frame,
                                            b.end_frame, b.time_constraints)
            np.testing.assert_array_equal(a.parameters, b.parameters)
            assert (a.arc_length, a.error) == (b.arc_length, b.error)


@pytest.mark.parametrize("use_time", [True, False])
def test_rebuild_frames_matches_jax(walk_steps, use_time):
    """rebuild_frames_from_steps (the emit kernel's twin and align_clip)
    against JAX's, with and without the time warp and a start transform.
    Four steps of aligned clips: 1e-3 on root positions of ~100 cm."""
    g_j, g_t, steps = walk_steps
    start = (np.asarray(qj.about_y(jnp.asarray(0.4))),
             np.array([5.0, 0.0, -3.0], np.float32))
    out_j = gwj.rebuild_frames_from_steps(
        g_j, [mgj.GraphWalkEntry(**s) for s in steps], use_time=use_time,
        window=12, start_transform=tuple(jnp.asarray(a) for a in start))
    out_t = gwt.rebuild_frames_from_steps(
        g_t, [mgt.GraphWalkEntry(**s) for s in steps], use_time=use_time,
        window=12, start_transform=start, device="cpu")
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-3)
    result = mgt.MotionResult(frames=out_t, steps=[
        mgt.GraphWalkEntry(**s) for s in steps], action_ranges=[],
        stats={"average_error": 0.5, "objective_evaluations": 7,
               "time": 2.0})
    assert gwt.get_statistics_string(result) == gwj.get_statistics_string(
        mgj.MotionResult(frames=out_t, steps=result.steps, action_ranges=[],
                         stats=result.stats))


def test_graph_action_definitions_load():
    """The graph loader reads "actionDefinitions" as JAX's does."""
    gd = synj.make_multi_action_graph_dict()
    gd["actionDefinitions"] = {"pickRight": {
        "node_sequence": [["reach", "standard"]],
        "constraint_slots": {"start_contact": {"node": "reach",
                                               "joint": "Head"}}}}
    assert gt.build_graph_from_dict(gd).action_definitions == \
        gj.build_graph_from_dict(gd).action_definitions
    assert gt.build_graph_from_dict(
        synj.make_graph_dict()).action_definitions == {}
