"""Parity of the PyTorch port's streaming planner
(`synthesis.state_planner.MGStatePlanner`) with the JAX package's on the
toy graphs of tests/test_serve.py, the port drawing the JAX planner's own
samples (`torch_parity.jax_key_sampler`: its three `_next_key()` sites are
the port's three sampler calls, in the same order) and the same host
noise (`np.random.default_rng(seed)` in both).

Tolerances, measured on this model:
  * one LM iteration: a step's frames to SEQ_ATOL_1 (measured <= 2.8e-3:
    float32 rounding of the LM's step, carried through the alignment of
    each state onto the one before);
  * the default 10 LM iterations: the toy model's LM is chaotic there.
    From the same start and constraint set, the port's LM lands 0.045
    from JAX's after 4 iterations, where a 1e-7 relative nudge of the
    start moves JAX's own result 0.030.  So whole sequences at the
    defaults are held to JAX's own spread: JAX runs the sequence again on
    inputs nudged by -1e-6 and +1e-6 (relative, the control points' z and
    the frame constraint's position), and each state's frames must agree
    to CHAOS_FACTOR times the larger of the two moves plus SEQ_ATOL_1
    (measured: the port within SEQ_ATOL_1 of JAX, or at most 1.0 times
    JAX's own spread, which reaches 22.9 on the last state of pick_right
    after prevent_action_drift's blend).  The nudged runs must give JAX's node
    keys, which shows the inputs sit away from the planner's distance
    thresholds (target switching, overstepping, the step target
    threshold);
  * the IK snap of frame constraints solves in float64 in the port and in
    float32 in the JAX package, and on the toy model's non-unit
    quaternions some targets are out of reach, where JAX's own float32
    solve is chaotic (a 1e-6 relative nudge of its input moves a snapped
    frame by up to 1.4).  As in the request tests
    (tests/test_torch_request_options.py), steps with frame constraints
    are held to JAX on the frames JAX keeps stable (moving less than
    STABLE_ATOL under relative nudges of the input's joint quaternions by
    -1e-6, +1e-6 and four seeded random draws of 1e-6), to IK_ATOL, the
    bound of the port's apply_ik_constraints tests
    (tests/test_torch_host_ops.py); at least MIN_STABLE of the frames
    must be stable (measured 0.17-1.0 of them, the port within 1.6e-3 of
    JAX on those);
  * the CCD edits turn the effector itself first, with a zero from-vector:
    its quaternion comes out as the identity turn in the port and as the
    identity or its negative in the JAX package (the sign of a zero dot
    product), so frames edited by CCD compare each quaternion up to sign.
Node keys, frame counts, events and hold frames compare exactly."""

import threading
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.synthesis import state_planner as spj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import \
    state_planner as spt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

SEQ_ATOL_1 = 1e-2
CHAOS_FACTOR = 3.0
IK_ATOL = 5e-3
STABLE_ATOL, MIN_STABLE = 1e-3, 0.1

PICK_DEFS = {"pickRight": {
    "node_sequence": [["reach", "standard"]],
    "constraint_slots": {"start_contact": {"node": "reach",
                                           "joint": "Head"}}}}


@pytest.fixture(scope="module")
def walk_graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


@pytest.fixture(scope="module")
def action_graphs():
    """The multi-action toy graph with pickRight's action definition."""
    gd = synj.make_multi_action_graph_dict()
    gd["actionDefinitions"] = PICK_DEFS
    g_j, g_t = tp.request_graphs(gd, synj.TEST_BVH)
    g_j.action_definitions = PICK_DEFS
    return g_j, g_t


@pytest.fixture(scope="module")
def ref_graphs():
    return tp.request_graphs(synj.make_reference_scale_graph_dict(),
                             synj.REF_BVH)


def _config(lm_iterations=10):
    cfg = default_config()
    cfg["lm_iterations"] = lm_iterations
    return cfg


def _planners(graphs, seed=0, lm_iterations=10, **settings):
    """(JAX planner, port planner on the CPU replaying its draws)."""
    g_j, g_t = graphs
    cfg = _config(lm_iterations)
    p_j = spj.MGStatePlanner(g_j, spj.MGStatePlanningSettings(**settings),
                             config=cfg, seed=seed)
    p_t = spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(**settings),
                             config=dict(cfg), seed=seed, device="cpu",
                             sampler=tp.jax_key_sampler(g_j, seed))
    return p_j, p_t


def _assert_entries(e_j, e_t, atol):
    assert (e_t.node_key, e_t.node_type, e_t.events, e_t.hold_frames) == (
        e_j.node_key, e_j.node_type, e_j.events, e_j.hold_frames)
    assert e_t.state.frames.shape == e_j.state.frames.shape
    assert np.all(np.isfinite(e_t.state.frames))
    np.testing.assert_allclose(e_t.state.frames, e_j.state.frames,
                               atol=atol)
    assert len(e_t.pose_buffer) == len(e_j.pose_buffer)


def _quat_nudges(d):
    """Relative scales of a frame's joint quaternion channels [d - 3]:
    -1e-6, +1e-6 and four seeded random draws of 1e-6."""
    rng = np.random.default_rng(0)
    return ([np.float32(1 - 1e-6), np.float32(1 + 1e-6)]
            + [(1 + 1e-6 * rng.standard_normal(d - 3)).astype(np.float32)
               for _ in range(4)])


def _nudged(frames, scale):
    out = np.array(frames, np.float32)
    out[..., 3:] = out[..., 3:] * scale
    return out


def _assert_on_stable_frames(out_t, out_j, nudged_j):
    """out_t against out_j [T, D] on the frames whose values move less
    than STABLE_ATOL across JAX's nudged outputs; at least MIN_STABLE of
    them must be."""
    spread = np.zeros(len(out_j))
    for o in nudged_j:
        spread = np.maximum(spread, np.abs(o - out_j).max(1))
    stable = spread < STABLE_ATOL
    assert stable.mean() >= MIN_STABLE, stable.mean()
    np.testing.assert_allclose(out_t[stable], out_j[stable], atol=IK_ATOL)


def _frames(skel, n, seed=0, z0=0.0):
    """test_serve.py's clip with seeded unit joint quaternions."""
    rng = np.random.default_rng(seed)
    f = np.zeros((n, skel.n_frame_params), np.float32)
    f[:, 1] = 90.0
    f[:, 2] = z0 + np.arange(n)
    q = rng.standard_normal((n, skel.n_animated, 4)) * 0.2
    q[..., 0] += 1.0
    f[:, 3:] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).reshape(n, -1)
    return f


# -- the FSM and direction extraction ----------------------------------------

def test_fsm_and_node_picks_match_jax(walk_graphs):
    """get_next_node_type over every type and flag, and _pick_node from no
    node and along each node type, as JAX's."""
    p_j, p_t = _planners(walk_graphs)
    for t in ("idle", "start", "standard", "end", "cycle_end"):
        for reached in (False, True):
            assert p_t.get_next_node_type(t, reached) == \
                p_j.get_next_node_type(t, reached)
    prev = [None] + list(walk_graphs[0].nodes)
    for key in prev:
        for t in ("start", "standard", "end", "idle"):
            assert p_t._pick_node(key, t, "walk") == \
                p_j._pick_node(key, t, "walk")


def _path_state(cps, **kw):
    state = {"distance": np.inf, "prev_distance": np.inf,
             "prev_direction_vector": None, "prev_target": cps[0],
             "current_position": np.zeros(3)}
    state.update(kw)
    return state


def _buffer(skel, x=0.0, z=0.0, n=1):
    buf = []
    for i in range(n):
        f = np.zeros(skel.n_frame_params, np.float32)
        f[3::4] = 1.0
        f[0], f[2] = x, z + i
        buf.append(f)
    return buf


DIRECTION_CASES = {
    # the first target within min_target_distance pops, the second steers;
    # the step caps at max_step_length (standard) or the begin cap (idle)
    "target_switching": (dict(min_target_distance=10.0, max_step_length=25.0,
                              max_begin_step_length=12.0),
                         [[0.0, 0, 5.0], [0.0, 0, 100.0]], 0.0, 0.0,
                         "standard", {}, None, False, 0),
    "begin_cap": (dict(min_target_distance=10.0, max_step_length=25.0,
                       max_begin_step_length=12.0),
                  [[0.0, 0, 5.0], [0.0, 0, 100.0]], 0.0, 0.0, "idle", {},
                  None, False, 0),
    # 30 from the last target < min_dir_distance: the end direction wins
    "end_direction": (dict(), [[0.0, 0, 100.0]], 0.0, 70.0, "standard", {},
                      [1.0, 0, 0], False, 0),
    # 10 past the last target, inside the overstepping range, the distance
    # growing: the newest state pops and the previous direction stays
    "overstepping_abort": (dict(overstepping_range=50.0,
                                min_target_distance=1.0),
                           [[0.0, 0, 20.0]], 0.0, 30.0, "standard",
                           dict(distance=10.0, prev_distance=5.0,
                                prev_direction_vector=np.array(
                                    [0.0, 0.0, 1.0])), None, False, 2),
    # a buffered pose 12 from the first target (< min_target_distance 20)
    # while the current one is 45 away: the look-back pops it
    "look_back": (dict(), [[0.0, 0, 57.0], [30.0, 0, 150.0]], 0.0, 0.0,
                  "standard", {}, None, False, 3),
    # seeded steering noise from the planner's numpy generator
    "noise": (dict(), [[20.0, 0, 100.0]], 0.0, 0.0, "standard", {}, None,
              True, 0),
}


@pytest.mark.parametrize("name", sorted(DIRECTION_CASES))
def test_direction_extraction_matches_jax(walk_graphs, name):
    """get_direction_from_control_points: the returned direction, step
    distance and pose buffer, the popped control points, the path state
    and the queue after it.  The inputs sit whole centimeters from every
    distance threshold."""
    settings, cps, x, z, node_type, state, end_dir, noise, n_states = \
        DIRECTION_CASES[name]
    p_j, p_t = _planners(walk_graphs, **settings)
    skel = walk_graphs[1].skeleton
    out = []
    for p in (p_j, p_t):
        buf = None
        for i in range(n_states):
            e = p.state_queue.add_state(("walk", f"s{i}"), "standard",
                                        _frames(skel, 10, seed=i), buf)
            buf = e.pose_buffer
        if name == "look_back":
            buf = _buffer(skel, 0.0, 45.0) + _buffer(skel, 0.0, 0.0)
        else:
            buf = _buffer(skel, x, z)
        points = [np.asarray(c) for c in cps]
        st = _path_state(points, **state)
        d, step, buf_out = p.get_direction_from_control_points(
            points, node_type, st, buf, end_direction=end_dir,
            add_noise=noise)
        out.append((d, step, buf_out, points, st, len(p.state_queue)))
    (d_j, s_j, b_j, c_j, st_j, n_j), (d_t, s_t, b_t, c_t, st_t, n_t) = out
    np.testing.assert_array_equal(d_t, d_j)
    assert s_t == s_j and n_t == n_j
    assert len(c_t) == len(c_j) and len(b_t) == len(b_j)
    for key in ("distance", "prev_distance"):
        assert st_t[key] == st_j[key]
    np.testing.assert_array_equal(st_t["prev_target"], st_j["prev_target"])
    np.testing.assert_array_equal(st_t["current_position"],
                                  st_j["current_position"])


# -- one step ----------------------------------------------------------------

STEP_CASES = {
    "unconstrained": dict(),
    "position_direction": dict(target_pos=[4.0, 0.0, 38.0],
                               target_dir=[0.1, 1.0]),
    "keyframe_label": dict(keyframe_constraints=[{
        "joint": "Head", "position": [6.0, np.nan, 20.0],
        "keyframeLabel": "middle", "holdFrame": True,
        "keyframeEvents": [{"event": "attach"}]}]),
    "region_span": dict(keyframe_constraints=[{
        "joint": "Head", "position": [6.0, np.nan, 20.0],
        "keyframeLabel": "contact_start", "endKeyframeLabel": "contact_end",
        "constrainPositionInRegion": True, "holdFrame": True}]),
    "relative_joint": dict(keyframe_constraints=[{
        "joint": "Head", "relativeJoint": "Spine",
        "position": [0.0, 5.0, 0.0], "keyframe": 3}]),
    "mirror_pin": dict(keyframe_constraints=[{
        "joint": "Head", "position": [4.0, np.nan, 22.0], "keyframe": 10,
        "mirrorJoint": "Leg"}]),
    "tool_offset": dict(keyframe_constraints=[{
        "joint": "Head", "position": [5.0, np.nan, 24.0], "keyframe": 12,
        "offset": [0.0, 8.0, 0.0]}]),
    "transition_pose": dict(target_dir=[0.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_generate_step_matches_jax(walk_graphs, name):
    """generate_step on ("walk", "leftStance") at one LM iteration with a
    pose buffer: the set filled by the port's compiled.set_* builders, the
    selection and LM (B2's and B5's twins), the back-projection (the emit
    kernel's twin), the IK snap and the alignment, against JAX's step.
    The region span's labels are set on both graphs; the transition pose
    runs with add_transition_constraint.  Steps with frame constraints
    compare to IK_ATOL."""
    kw = STEP_CASES[name]
    settings = dict(n_samples=6,
                    add_transition_constraint=name == "transition_pose")
    p_j, p_t = _planners(walk_graphs, lm_iterations=1, **settings)
    key = ("walk", "leftStance")
    for g in walk_graphs:
        g.node_groups["walk"].labeled_frames.setdefault(key[1], {}).update(
            {"contact_start": 2, "contact_end": "lastFrame"})
    buf = [tp.prev_frame(walk_graphs[1].skeleton.n_frame_params, 3.0, 20.0,
                         seed=7)]
    e_j = p_j.generate_step(key, buf, **kw)
    e_t = p_t.generate_step(key, buf, **kw)
    if "keyframe_constraints" not in kw or name == "relative_joint":
        _assert_entries(e_j, e_t, SEQ_ATOL_1)
        return
    _assert_entries(e_j, e_t, np.inf)
    nudged = []
    for scale in _quat_nudges(len(buf[0])):
        p_n, _ = _planners(walk_graphs, lm_iterations=1, **settings)
        nudged.append(p_n.generate_step(key, [_nudged(buf[0], scale)],
                                        **kw).state.frames)
    _assert_on_stable_frames(e_t.state.frames, e_j.state.frames, nudged)
    if name == "region_span":
        assert e_t.hold_frames[0] == 2 and len(e_t.hold_frames) > 20


def test_snap_keyframe_constraints_matches_jax(walk_graphs):
    """The IK snap through the inverse aligning transform of a pose
    buffer: a NaN component stays NaN through the transform and is filled
    from the joint's position; a mirror pin and a tool offset (its target
    out of the head's reach); against JAX's float32 solve on its stable
    frames."""
    p_j, p_t = _planners(walk_graphs)
    skel = walk_graphs[1].skeleton
    frames = _frames(skel, 30, seed=2)
    buf = [tp.prev_frame(skel.n_frame_params, -4.0, 30.0, seed=3)]
    kf = [("Head", 12, [6.0, np.nan, 40.0], "Leg", None),
          ("Head", 20, [np.nan, 150.0, 44.0], None, [0.0, 6.0, 0.0])]
    out_j = p_j._snap_keyframe_constraints(frames, buf, kf)
    out_t = p_t._snap_keyframe_constraints(frames, buf, kf)
    nudged = [p_j._snap_keyframe_constraints(_nudged(frames, scale), buf, kf)
              for scale in _quat_nudges(frames.shape[1])]
    _assert_on_stable_frames(out_t, out_j, nudged)
    assert float(np.abs(out_t - frames).max()) > 1e-2


def test_body_orientation_targets_match_jax(walk_graphs):
    """Look-at on the head and the spine (orient_spine) through the
    inverse aligning transform of a pose buffer, over a look-at window
    shorter than the clip, then the joint-limit clamp with a custom table
    that the edit pushes past."""
    settings = dict(look_at_window=12, orient_spine=True)
    p_j, p_t = _planners(walk_graphs, **settings)
    table = dict(spt.skeleton_models.JOINT_CONSTRAINTS,
                 Head={"axis": (0, 1, 0), "min_angle": -20.0,
                       "max_angle": 20.0})
    p_j.joint_constraints = p_t.joint_constraints = table
    skel = walk_graphs[1].skeleton
    frames = _frames(skel, 30, seed=4)
    buf = [tp.prev_frame(skel.n_frame_params, 10.0, -5.0, seed=5)]
    targets = ([-60.0, 140.0, -200.0], [30.0, 100.0, 80.0])
    out_j = p_j.apply_body_orientation_targets(frames, buf, targets)
    out_t = p_t.apply_body_orientation_targets(frames, buf, targets)
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)
    np.testing.assert_array_equal(out_t[:18], frames[:18])
    assert float(np.abs(out_t[18:] - frames[18:]).max()) > 1e-2


# -- the upper body ----------------------------------------------------------

@pytest.mark.parametrize("velocity", [1.0, 1.6])
def test_upper_body_state_cycles_like_jax(walk_graphs, velocity):
    """generate_upper_body_state (the emit kernel's twin: back_project or
    evaluate_at at round(n_canonical / velocityFactor) frames) and the
    splice cycling through it over two steps, against JAX."""
    p_j, p_t = _planners(walk_graphs)
    desc = {"name": "walk", "primitive": "rightStance",
            "velocityFactor": velocity}
    st_j = p_j.generate_upper_body_state(desc)
    st_t = p_t.generate_upper_body_state(desc)
    np.testing.assert_allclose(st_t["frames"], st_j["frames"], atol=1e-4)
    skel = walk_graphs[1].skeleton
    for n in (len(st_j["frames"]) + 5, 17):
        base = _frames(skel, n, seed=n)
        out_j = p_j.combine_frames_with_upper_body(base, st_j)
        out_t = p_t.combine_frames_with_upper_body(base, st_t)
        np.testing.assert_allclose(out_t, out_j, atol=1e-4)
        assert st_t["frame_idx"] == st_j["frame_idx"]
    np.testing.assert_array_equal(
        p_t.overlay_upper_body(base, st_t["frames"]),
        p_j.overlay_upper_body(base, st_t["frames"]))


def test_gesture_parameters_match_jax(ref_graphs):
    """The gesture edits on the reference-scale graph (test_serve.py's
    test_gesture_parameters_modulate_wrist): velocityFactor resampling,
    the noise from the planner's numpy generator and the distance push,
    reproduced by a shoulder-bounded CCD over all frames at once; and the
    edit alone on unit-quaternion frames.  CCD frames compare up to
    quaternion sign; 2e-4 (five CCD passes of atan2 and normalizations)."""
    settings = dict(enable_gesture_parameters=True, gesture_ik_max_iter=5)
    p_j, p_t = _planners(ref_graphs, seed=3, **settings)
    desc = {"action": "walk", "velocityFactor": 2.0, "noiseFactor": 0.5,
            "distanceToHeadFactor": 10.0}
    st_j = p_j.generate_upper_body_state(desc)
    st_t = p_t.generate_upper_body_state(desc)
    assert st_t["frames"].shape == st_j["frames"].shape
    assert tp.rotations_diff(st_t["frames"], st_j["frames"]) <= 2e-4
    skel = ref_graphs[1].skeleton
    frames = _frames(skel, 40, seed=6)
    for noise, dist in ((0.0, 10.0), (1.0, 0.0)):
        out_j = p_j._apply_gesture_parameters(frames, noise, dist)
        out_t = p_t._apply_gesture_parameters(frames, noise, dist)
        assert tp.rotations_diff(out_t, out_j) <= 2e-4
        assert float(np.abs(out_t - frames).max()) > 1e-3


# -- collision edits ---------------------------------------------------------

class _Boundary:
    """A hand collision boundary that reports one hit at frame 5 (pushed
    along -z) and per-frame deltas at frames 4 and 7."""

    joint_name = "Head"

    def __init__(self):
        self.calls = 0

    def check_trajectory(self, points, dt):
        self.calls += 1
        return 5, np.asarray(points[5]), np.array([0.0, 0.0, 1.0])

    def get_delta_trajectory(self, points, dt):
        return True, {4: np.array([0.0, 0.0, -15.0]),
                      7: np.array([3.0, 2.0, 0.0])}


def test_collision_edits_match_jax(walk_graphs):
    """handle_collision (one CCD at the hit frame, n_max_ik_iter passes)
    and handle_collision2 (one-pass CCD reaches per joint at every
    reported frame, batched over the frames of a joint), with a stub
    boundary, against JAX; frames off the hits unchanged."""
    g_j, g_t = walk_graphs
    b_j, b_t = _Boundary(), _Boundary()
    p_j = spj.MGStatePlanner(g_j, hand_collision_boundary=b_j)
    p_t = spt.MGStatePlanner(g_t, hand_collision_boundary=b_t, device="cpu")
    frames = _frames(g_t.skeleton, 10, seed=8)
    out_j = p_j.handle_collision(frames, "walk")
    out_t = p_t.handle_collision(frames, "walk")
    assert tp.rotations_diff(out_t, out_j) <= 1e-4
    assert float(np.abs(out_t[5] - frames[5]).max()) > 1e-3
    np.testing.assert_array_equal(np.delete(out_t, 5, 0),
                                  np.delete(frames, 5, 0))
    out_j = p_j.handle_collision2(frames, "walk", ["Head", "Spine"])
    out_t = p_t.handle_collision2(frames, "walk", ["Head", "Spine"])
    assert tp.rotations_diff(out_t, out_j) <= 1e-4
    np.testing.assert_array_equal(np.delete(out_t, [4, 7], 0),
                                  np.delete(frames, [4, 7], 0))


def test_step_with_collision_boundary_matches_jax(walk_graphs):
    """generate_step runs the CCD edit on the generated frames before the
    alignment (one boundary call a step)."""
    g_j, g_t = walk_graphs
    b_j, b_t = _Boundary(), _Boundary()
    cfg = _config(1)
    p_j = spj.MGStatePlanner(g_j, spj.MGStatePlanningSettings(n_samples=6),
                             config=cfg, hand_collision_boundary=b_j)
    p_t = spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(n_samples=6),
                             config=dict(cfg), device="cpu",
                             sampler=tp.jax_key_sampler(g_j, 0),
                             hand_collision_boundary=b_t)
    e_j = p_j.generate_step(("walk", "beginLeftStance"), None,
                            target_dir=[0.0, 1.0])
    e_t = p_t.generate_step(("walk", "beginLeftStance"), None,
                            target_dir=[0.0, 1.0])
    assert b_t.calls == b_j.calls == 1
    assert tp.rotations_diff(e_t.state.frames,
                             e_j.state.frames) <= SEQ_ATOL_1


# -- PFNN --------------------------------------------------------------------

class _PFNN:
    """test_serve.py's stub controller: 2 units a frame toward the target,
    identity joint rotations."""

    def __init__(self, d):
        self.d = d

    def reset(self, position, phase, direction):
        self.position = np.asarray(position, np.float64)

    def get_next_frame(self, target_dir):
        self.position = self.position + 2.0 * np.asarray(target_dir)
        frame = np.zeros(self.d, np.float32)
        frame[:3] = self.position
        frame[3::4] = 1.0
        return frame


@pytest.mark.parametrize("stretch", [0.0, 0.25])
def test_pfnn_locomotion_matches_jax(walk_graphs, stretch):
    """use_pfnn routes locomotion through the wrapper; the frame stream
    splits into states every min_pfnn_primitive_steps frames; the
    control points optionally upsampled by stretch_points."""
    settings = dict(min_pfnn_target_distance=5.0,
                    min_pfnn_primitive_steps=10, max_pfnn_frames=200,
                    pfnn_stretch_scale=stretch)
    g_j, g_t = walk_graphs
    d = g_t.skeleton.n_frame_params
    queues = []
    for p in (spj.MGStatePlanner(g_j, spj.MGStatePlanningSettings(
                  **settings), pfnn_wrapper=_PFNN(d)),
              spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(
                  **settings), pfnn_wrapper=_PFNN(d), device="cpu")):
        p.use_pfnn = True
        p.generate_locomotion("walk", np.array([[0.0, 0, 30],
                                                [10.0, 0, 60]]))
        queues.append(list(p.state_queue._queue))
    assert len(queues[1]) == len(queues[0]) >= 2
    for e_j, e_t in zip(*queues):
        _assert_entries(e_j, e_t, 1e-4)
    np.testing.assert_array_equal(
        spt.stretch_points([[0.0, 0, 0], [10.0, 0, 0], [10.0, 0, 10]], 0.1),
        spj.stretch_points([[0.0, 0, 0], [10.0, 0, 0], [10.0, 0, 10]], 0.1))


# -- engine constraints and action queues ------------------------------------

def test_resolve_engine_frame_constraints_matches_jax(action_graphs):
    """Engine descs through constraint_slots (and cycle_nodes): the
    handedness flips, a region's end label, hold and events, the mirror
    pin of keepMirrorBoneStatic, the relative bone of
    keepOffsetBetweenBones, and the tool offset from toolEndPoint and
    currentPose (an FK of the engine's pose, float32: 1e-4)."""
    from morphablegraphs_tpu.constraints.server_builder import \
        mg_frame_to_unity_frame
    g_j, g_t = action_graphs
    defs = dict(PICK_DEFS, screw={"constraint_slots": {
        "start_contact": {"cycle_nodes": ["a", "b"], "joint": "Head"}}})
    g_j.action_definitions = defs
    g_t.action_definitions = defs
    p_j, p_t = _planners(action_graphs)
    unity = mg_frame_to_unity_frame(g_j.skeleton,
                                    _frames(g_t.skeleton, 1, seed=9)[0])
    descs = [
        {"keyframe": "start_contact", "cycle": 1,
         "position": {"x": 1.0, "y": 2.0, "z": 3.0},
         "orientation": {"w": 1.0, "x": 0.0, "y": 0.0, "z": 0.0},
         "constrainOrientation": True, "hold": True,
         "keyframeEvents": [{"event": "attach"}],
         "constrainPositionInRegion": True, "endKeyframe": "end"},
        {"keyframe": "start_contact", "cycle": 5, "position": [0, 0, 0],
         "joint": "Spine", "keepMirrorBoneStatic": True,
         "keepOffsetBetweenBones": True, "relativeBoneName": "Hips"},
        {"keyframe": "start_contact", "position": [1.0, 2.0, 3.0],
         "applyOffset": True, "offset": [1.0, 1.0, 1.0],
         "toolEndPoint": [-2.0, 160.0, 4.0], "currentPose": unity},
        {"keyframe": "start_contact", "position": [1.0, 2.0, 3.0],
         "applyOffset": True, "offset": [1.0, 2.0, 3.0]}]
    for action in ("screw", "pickRight"):
        out_j = p_j.resolve_engine_frame_constraints(action, descs)
        out_t = p_t.resolve_engine_frame_constraints(action, descs)
        for a, b in zip(out_j, out_t):
            off_a, off_b = a.pop("offset"), b.pop("offset")
            assert a == b
            assert (off_a is None) == (off_b is None)
            if off_a is not None:
                np.testing.assert_allclose(off_b, off_a, atol=1e-4)
    g_j.action_definitions = PICK_DEFS
    g_t.action_definitions = PICK_DEFS


def test_action_node_queue_matches_jax(action_graphs):
    """generate_action_node_queue: a walk in progress finishes first, the
    node sequence or the cycles, then the idle tail; frame constraints
    grouped by (node, cycle)."""
    g_j, g_t = action_graphs
    defs = dict(PICK_DEFS, screw={
        "cycle_start": ["a", "start"], "cycle_node": ["b", "standard"],
        "cycle_end": ["c", "end"], "cycle_nodes": ["b"]})
    g_j.action_definitions = defs
    g_t.action_definitions = defs
    p_j, p_t = _planners(action_graphs)
    for args in (("screw", None, "idle", 4), ("screw", None, "idle", 1),
                 ("pickRight", ("walk", "leftStance"), "standard", 0),
                 ("pickRight", ("walk", "endRightStance"), "end", 0),
                 ("idle", None, "idle", 0)):
        assert p_t.generate_action_node_queue(*args) == \
            p_j.generate_action_node_queue(*args)
    fcs = [{"node": "b", "cycle": 1, "joint": "Head"}, {"node": "a"},
           {"node": "b", "cycle": 1, "joint": "Spine"}]
    assert spt.MGStatePlanner.map_frame_constraints_to_nodes(fcs) == \
        spj.MGStatePlanner.map_frame_constraints_to_nodes(fcs)
    g_j.action_definitions = PICK_DEFS
    g_t.action_definitions = PICK_DEFS


# -- whole sequences ---------------------------------------------------------

def _sequences(eps=0.0):
    """name -> (graph fixture, actions, settings).  eps nudges the control
    points' z and the frame constraint's position (relative).  The control
    points sit whole centimeters from every distance threshold; the
    nudged runs' node keys show it."""
    def cps(points):
        return [[x, y, z * (1 + eps)] for x, y, z in points]
    return {
        "control_points": ("walk_graphs", [{
            "action": "walk", "controlPoints": cps([[0, 0, 45], [10, 0, 100]]),
            "endDirection": [1.0, 0.0, 0.0]}],
            dict(n_samples=10, step_target_threshold=15.0,
                 max_steps_per_target=10, force_walk_end_targets=True,
                 min_end_distance=1.0, end_target_blend_range=10)),
        "direction_gesture_look_at": ("walk_graphs", [{
            "action": "walk", "direction": [eps, 0.0, 1.0], "n_steps": 3,
            "upper_body_gesture": {"name": "walk"},
            "lookAtTarget": [30.0, 100.0, 80.0]}], dict(n_samples=6)),
        "pick_right": ("action_graphs", [
            {"action": "walk", "controlPoints": cps([[0, 0, 40], [0, 0, 90]])},
            {"action": "pickRight", "frame_constraints": [{
                "node": "reach", "joint": "Head",
                "position": [10.0, np.nan, 40.0 * (1 + eps)],
                "keyframeLabel": "start_contact",
                "keyframeEvents": [{"event": "attach", "parameters": {}}],
                "holdFrame": True}]}], dict(n_samples=6)),
    }


def _run_jax(graph_j, actions, settings, lm_iterations, seed=0):
    p = spj.MGStatePlanner(graph_j, spj.MGStatePlanningSettings(**settings),
                           config=_config(lm_iterations), seed=seed)
    p.generate_motion_states_from_action_sequence(actions)
    return list(p.state_queue._queue)


@pytest.mark.parametrize("lm_iterations", [1, 10])
@pytest.mark.parametrize("name", sorted(_sequences()))
def test_sequence_matches_jax(request, name, lm_iterations):
    """Whole action sequences through generate_motion_states_from_action_
    sequence: a control-point walk with an end direction and the end
    targets forced, a direction walk with a gesture overlay and a look-at
    target, and a walk followed by pickRight with a labeled frame
    constraint carrying an event and a hold (the action definition's node
    sequence, the IK snap, prevent_action_drift).  Node keys, types,
    frame counts, events and hold frames exactly; frames to SEQ_ATOL_1 at
    one LM iteration, to JAX's own spread (CHAOS_FACTOR) at the default
    ten."""
    fixture, actions, settings = _sequences()[name]
    g_j, g_t = request.getfixturevalue(fixture)
    ref = _run_jax(g_j, actions, settings, lm_iterations)
    p_t = spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(**settings),
                             config=_config(lm_iterations), device="cpu",
                             sampler=tp.jax_key_sampler(g_j, 0))
    p_t.generate_motion_states_from_action_sequence(actions)
    out = list(p_t.state_queue._queue)
    assert [e.node_key for e in out] == [e.node_key for e in ref]
    spread = [0.0] * len(ref)
    if lm_iterations > 1:
        for eps in (-1e-6, 1e-6):
            _, nudged_actions, _ = _sequences(eps)[name]
            nudged = _run_jax(g_j, nudged_actions, settings, lm_iterations)
            assert [e.node_key for e in nudged] == [e.node_key for e in ref]
            spread = [max(s, float(np.abs(a.state.frames
                                          - b.state.frames).max()))
                      for s, a, b in zip(spread, ref, nudged)]
    for e_j, e_t, s in zip(ref, out, spread):
        _assert_entries(e_j, e_t, CHAOS_FACTOR * s + SEQ_ATOL_1)
    if name == "pick_right":
        pick = [e for e in out if e.node_key == ("pickRight", "reach")][0]
        (kf, events), = pick.events.items()
        assert events[0]["event"] == "attach" and pick.hold_frames == (kf,)


# -- device, refusals, threads -----------------------------------------------

def test_default_device_needs_a_card(walk_graphs):
    """MGStatePlanner (and its queue) run on the CUDA device unless asked
    for the CPU; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spt.MGStatePlanner(walk_graphs[1])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        spt.MGStateQueue(walk_graphs[1].skeleton, 1 / 30)


def test_cluster_tree_search_is_refused(walk_graphs, monkeypatch):
    """constrained_sampling_mode="cluster_tree_search" in the config (JAX
    scores a node's tree data instead of sampling; the planner refused the
    mode until ROADMAP item 15 was ported): a constrained step on a node
    with a tree scores the tree's rows; under random_discrete the tree is
    not read, and the step equals the step without a tree."""
    from morphablegraphs_tpu_torch.construct.space_partitioning import \
        build_cluster_tree_for_primitive
    from morphablegraphs_tpu_torch.synthesis import generator
    g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)[1]
    key = ("walk", "leftStance")
    cfg = _config(1)
    step = dict(target_dir=[0, 1.0])

    def planner(config):
        return spt.MGStatePlanner(g_t, spt.MGStatePlanningSettings(
            n_samples=4), config=config, seed=3, device="cpu")
    plain = planner(cfg).generate_step(key, None, **step)
    tree = build_cluster_tree_for_primitive(
        torch.Generator().manual_seed(0), g_t.nodes[key].primitive,
        n_samples=50, max_level=2)
    g_t.nodes[key].cluster_tree = tree
    pools = []
    score = generator.score_pool

    def spy(skel, prim, sc, pool, *a, **kw):
        pools.append(pool)
        return score(skel, prim, sc, pool, *a, **kw)
    monkeypatch.setattr(generator, "score_pool", spy)
    e = planner(dict(cfg, constrained_sampling_mode="cluster_tree_search")
                ).generate_step(key, None, **step)
    assert len(pools) == 1 and pools[0] is tree.device_data("cpu")
    assert np.all(np.isfinite(e.state.frames))
    e = planner(cfg).generate_step(key, None, **step)
    assert pools[-1].shape[0] == 4
    np.testing.assert_array_equal(e.state.frames, plain.state.frames)


def test_start_stop_streams_the_same_states(action_graphs):
    """start() runs the action sequence on a worker thread while the main
    thread pops states as they come, leaving the newest queued while the
    worker runs (`pop(keep=1)`: pickRight starts from the queue's last
    state and prevent_action_drift edits it); the states equal a
    synchronous run's on the same draws, and the sampler is called from
    the worker only.  The default sampler (a seeded torch.Generator) is
    reproducible."""
    g_j, g_t = action_graphs
    _, actions, _ = _sequences()["pick_right"]
    settings = spt.MGStatePlanningSettings(n_samples=6)

    def planner(sampler=None):
        return spt.MGStatePlanner(g_t, settings, config=_config(2), seed=4,
                                  device="cpu", sampler=sampler)
    threads = []

    def sampler(key, n, inner=tp.jax_key_sampler(g_j, 4)):
        threads.append(threading.current_thread())
        return inner(key, n)
    ref = planner(tp.jax_key_sampler(g_j, 4))
    ref.generate_motion_states_from_action_sequence(actions)
    p = planner(sampler)
    worker = p.start(actions)
    popped = []
    while worker.is_alive() or len(p.state_queue):
        e = p.state_queue.pop(keep=1 if worker.is_alive() else 0)
        if e is None:
            time.sleep(0.005)  # leave the interpreter to the worker
        else:
            popped.append(e)
    p.stop()
    assert not worker.is_alive()
    assert threads and all(t is worker for t in threads)
    assert [e.node_key for e in popped] == [e.node_key for e in
                                            ref.state_queue._queue]
    assert ("pickRight", "reach") in [e.node_key for e in popped]
    for a, b in zip(popped, ref.state_queue._queue):
        np.testing.assert_array_equal(a.state.frames, b.state.frames)
    runs = []
    for _ in range(2):
        q = planner()
        q.generate_motion_states_from_action_sequence(actions[:1])
        runs.append(q.state_queue._queue)
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a.state.frames, b.state.frames)

