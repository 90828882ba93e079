"""Parity of the PyTorch port's sequential request path
(`synthesis.motion_generator.MotionGenerator.generate_motion`) with the JAX
package's MotionGenerator on the CPU, driven by the JAX generator's own
draws (`torch_parity.jax_key_sampler`) and the JAX graph's step
statistics.

Whole requests are compared at the JAX tests' settings (5 and 8 LM
iterations): on the toy model they hold step for step, so no teacher
forcing is needed.  Tolerances: node keys, step counts and frame ranges
exactly; step errors to rtol 2e-3 (measured <= 6.4e-4: the direction
residual is the arccos of a cosine within float32 ulps of 1, the LM's
damped solve carries such rounding into the latents, and each step
aligns to the one before); latents to atol 5e-3 (measured <= 9e-4);
frames to rtol 1e-3 + atol 1e-2 (measured <= 2.7e-2 absolute, 2.4e-4
relative, on root positions of ~100 cm).  The end-keyframe request is
capped at three steps
(debug_max_step 2): uncapped it runs the 101-step walk of
tests/test_motion_generator.py, whose keyframe holds on every step."""

import gc

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.synthesis.motion_generator import \
    MotionGenerator as MotionGeneratorJ  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis.motion_generator import \
    MotionGenerator  # noqa: E402
from morphablegraphs_tpu_torch.utils.exceptions import \
    ConstraintError  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

WALK_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "trajectoryConstraints": [
            {"position": [0.0, None, 0.0]}, {"position": [5.0, None, 40.0]},
            {"position": [15.0, None, 80.0]},
            {"position": [20.0, None, 120.0]}]}],
    }],
}

KEYFRAME_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0],
            "semanticAnnotation": {"end": True}}]}],
    }],
}

PICK_CARRY_PLACE = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [
        {"action": "pickRight", "constraints": [{
            "joint": "Head", "keyframeConstraints": [{
                "position": [10.0, None, 20.0],
                "semanticAnnotation": {"start_contact": True}}]}]},
        {"action": "carryRight", "constraints": [{
            "joint": "Hips", "trajectoryConstraints": [
                {"position": [0.0, None, 0.0]},
                {"position": [10.0, None, 40.0]},
                {"position": [20.0, None, 80.0]}]}]},
        {"action": "placeRight", "constraints": [{
            "joint": "Head", "keyframeConstraints": [{
                "position": [25.0, None, 90.0],
                "semanticAnnotation": {"end_contact": True}}]}]}],
}


@pytest.fixture(scope="module")
def walk_graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _config(**kw):
    cfg = default_config()
    cfg.update(kw)
    return cfg


def _both(graphs, mg_input, cfg, seed):
    """(JAX result, port result, the port's kernel launches) of one
    request, the port drawing the JAX generator's samples."""
    g_j, g_t = graphs
    res_j = MotionGeneratorJ(g_j, cfg, seed=seed).generate_motion(mg_input)
    kernels.reset_launch_counts()
    res_t = MotionGenerator(g_t, cfg, seed=seed, device="cpu",
                            sampler=tp.jax_key_sampler(g_j, seed)
                            ).generate_motion(mg_input)
    return res_j, res_t, kernels.launch_counts()


def _assert_request_matches(res_j, res_t, frames=True):
    assert [s.node_key for s in res_t.steps] == \
        [s.node_key for s in res_j.steps]
    assert res_t.stats["n_steps"] == res_j.stats["n_steps"]
    assert res_t.stats["objective_evaluations"] == \
        res_j.stats["objective_evaluations"]
    for a, b in zip(res_j.steps, res_t.steps):
        np.testing.assert_allclose(b.error, a.error, rtol=2e-3, atol=1e-4)
        np.testing.assert_allclose(b.parameters, a.parameters, atol=5e-3)
        np.testing.assert_allclose(b.arc_length, a.arc_length, atol=2e-2)
        assert (b.start_frame, b.end_frame) == (a.start_frame, a.end_frame)
        assert len(b.user_constraints) == len(a.user_constraints)
        for (bj, bp, bk, bo), (aj, ap, ak, ao) in zip(b.user_constraints,
                                                      a.user_constraints):
            assert (bj, bk, bo is None) == (aj, ak, ao is None)
            np.testing.assert_array_equal(bp, ap)
    np.testing.assert_allclose(res_t.stats["average_error"],
                               res_j.stats["average_error"], rtol=2e-3)
    assert res_t.action_ranges == res_j.action_ranges
    assert res_t.frames.shape == res_j.frames.shape
    assert np.all(np.isfinite(res_t.frames))
    if frames:
        np.testing.assert_allclose(res_t.frames, res_j.frames, rtol=1e-3,
                                   atol=1e-2)


@pytest.mark.parametrize("n_lm_starts", [1, 4])
def test_walk_request_matches_jax(walk_graphs, n_lm_starts):
    """WALK_INPUT with 30 samples and 5 LM iterations, from the best
    candidate (C = 1) or from the 4 best as one C = 4 LM; the pool, the
    LM's B2 solves and B5 terms and the B6-source frame emission all go
    through the kernel wrappers (their twins on the CPU)."""
    cfg = _config(n_random_samples=30, lm_iterations=5,
                  n_lm_starts=n_lm_starts)
    res_j, res_t, launches = _both(walk_graphs, WALK_INPUT, cfg, seed=0)
    assert len(res_j.steps) >= 3
    _assert_request_matches(res_j, res_t)
    # the twins do not count: only a kernel launch does
    assert all(v == 0 for v in launches.values())


def test_end_keyframe_request_with_ik_matches_jax(walk_graphs):
    """The keyframe request of tests/test_motion_generator.py (8 LM
    iterations, seed 1), capped at three steps: the Hips keyframe is a
    user constraint on every step, so post-processing solves three IK
    constraints; the frames compare after IK."""
    cfg = _config(n_random_samples=30, lm_iterations=8, debug_max_step=2)
    res_j, res_t, _ = _both(walk_graphs, KEYFRAME_INPUT, cfg, seed=1)
    assert len(res_j.steps) == 3
    assert all(s.user_constraints for s in res_t.steps)
    _assert_request_matches(res_j, res_t)


def test_pick_carry_place_request_matches_jax():
    """pick -> carry -> place on the multi-action graph: each action's
    start node is the one linked from the previous action's last node,
    the carry follows a trajectory, the pick and place keyframes go
    through IK."""
    graphs = tp.request_graphs(synj.make_multi_action_graph_dict(),
                               synj.TEST_BVH)
    cfg = _config(n_random_samples=20, lm_iterations=3)
    res_j, res_t, _ = _both(graphs, PICK_CARRY_PLACE, cfg, seed=2)
    assert [s.node_key[0] for s in res_t.steps] == \
        ["pickRight", "carryRight", "placeRight"]
    _assert_request_matches(res_j, res_t)


VARIANTS = {
    # every step a plain GMM sample (the arc still advances), and the
    # conversion's options: savgol-smoothed time functions, the two-sided
    # seam blend, the root's box filter
    "use_constraints_off_convert_options": {
        "use_constraints": False, "smoothing_settings": dict(
            time_smoothing=True, root_filter_window=5,
            spatial_smoothing_method="blending")},
    # the half-step goal and the transition pose slot (dense FK)
    "half_step_and_transition_pose": {"trajectory_following_settings": dict(
        generate_half_step_constraint=True, use_transition_constraint=True)},
    # the canonical timeline and no LM
    "no_time_variation_no_lm": {"activate_time_variation": False,
                                "local_optimization_mode": "none"},
}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_request_config_variants_match_jax(walk_graphs, name):
    """Branches of the request path the settings above switch, on a small
    WALK_INPUT request (8 samples, 2 LM iterations), held like the whole
    requests."""
    cfg = _config(n_random_samples=8, lm_iterations=2)
    for key, val in VARIANTS[name].items():
        if isinstance(val, dict):
            cfg[key] = dict(cfg[key], **val)
        else:
            cfg[key] = val
    res_j, res_t, _ = _both(walk_graphs, WALK_INPUT, cfg, seed=0)
    _assert_request_matches(res_j, res_t)


def test_default_sampler_request_runs(walk_graphs):
    """Without a sampler the port draws from its own torch.Generator: a
    whole request runs, reproducibly for one seed, with finite frames."""
    cfg = _config(n_random_samples=8, lm_iterations=1)
    g_t = walk_graphs[1]
    a = MotionGenerator(g_t, cfg, seed=3, device="cpu").generate_motion(
        WALK_INPUT)
    b = MotionGenerator(g_t, cfg, seed=3, device="cpu").generate_motion(
        WALK_INPUT)
    assert a.stats["n_steps"] >= 2
    assert np.all(np.isfinite(a.frames))
    np.testing.assert_array_equal(a.frames, b.frames)


TIMED_KEYFRAME = {
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0], "time": 0.5,
            "semanticAnnotation": {"end": True}}]}],
    }],
}

CA_INPUT = {
    "elementaryActions": [{
        "action": "walk",
        "constraints": [
            {"joint": "Hips", "trajectoryConstraints": [
                {"position": [0.0, None, 0.0]},
                {"position": [0.0, None, 60.0]}]},
            {"joint": "Head", "trajectoryConstraints": [
                {"position": [20.0, 150.0, 30.0]},
                {"position": [20.0, 150.0, 40.0]}]}],
    }],
}

REFUSALS = {
    "use_transition_model": (dict(use_transition_model=True),
                             WALK_INPUT, "use_transition_model.*item 14"),
    "cluster_tree_search": (
        dict(constrained_sampling_mode="cluster_tree_search"), WALK_INPUT,
        "cluster_tree_search.*item 15"),
}


# the default global_spatial_optimization_settings with unit position and
# orientation weights: at the default 1000 the window LM's damped normal
# equations (lambda 1e-2) have condition numbers (~1e11) past float32's
# precision, so the JAX package's float32 steps are rounding noise where
# the port solves them in float64 (on JAX's own inputs of the "all"
# request below, JAX's first trial step's error is 1.8e10, the port's
# 2.5e9; the port then rejects all 8 steps, JAX accepts a step of 12)
UNIT_WEIGHTS = dict(start_error_threshold=0.0, position_weight=1.0,
                    orientation_weight=1.0)

# the options the port refused before ROADMAP item 13 was finished: name ->
# (skeleton with feet, request, config, seed, the port function each must
# reach, the index of the latents among its arguments or None)
OPTIONS = {
    "global_time_optimization": (
        False, TIMED_KEYFRAME,
        dict(n_random_samples=20, lm_iterations=3, debug_max_step=1), 1,
        ("global_opt", "optimize_time_over_steps", 1)),
    "global_spatial_optimization": (
        False, KEYFRAME_INPUT,
        dict(n_random_samples=20, lm_iterations=3, debug_max_step=2,
             global_spatial_optimization_mode="all",
             global_spatial_optimization_settings=UNIT_WEIGHTS), 1,
        ("global_opt", "optimize_spatial_over_steps", 3)),
    "global_spatial_optimization_trajectory_end": (
        False, WALK_INPUT,
        dict(n_random_samples=20, lm_iterations=3,
             global_spatial_optimization_mode="trajectory_end",
             global_spatial_optimization_settings=UNIT_WEIGHTS), 0,
        ("global_opt", "optimize_spatial_over_steps", 3)),
    # one LM iteration: the trajectory-set LM is chaotic on the toy model
    # (on JAX's own inputs, 3 iterations move the latents 0.08-0.19 apart
    # where a 1e-6 nudge of the start moves JAX's own result 0.01-0.02)
    "ca_extra_pass": (
        False, CA_INPUT,
        dict(n_random_samples=10, lm_iterations=1,
             optimize_collision_avoidance_constraints_extra=True), 0,
        ("generator", "refine_lm", None)),
    "ca_ik_mode": (
        False, CA_INPUT,
        dict(n_random_samples=10, lm_iterations=2,
             collision_avoidance_constraints_mode="ik"), 0,
        ("postprocess", "apply_ik_trajectory_constraints", None)),
    # the default grounding settings pin detected foot plants
    "motion_grounding": (
        True, WALK_INPUT,
        dict(n_random_samples=10, lm_iterations=2, debug_max_step=2,
             activate_motion_grounding=True), 0,
        ("grounding", "apply_grounding_constraints", None)),
    "motion_grounding_stance_table": (
        True, WALK_INPUT,
        dict(n_random_samples=10, lm_iterations=2, debug_max_step=2,
             activate_motion_grounding=True,
             motion_grounding_settings=dict(
                 generate_foot_plant_constraints=False)), 0,
        ("grounding", "ground_step", None)),
}
# the post-process passes of these options are chaotic on the synthetic
# models on some frames (their joint quaternions are not unit, so many IK
# targets are out of reach and the damped solve stops at ill-conditioned
# poses; contact and swing-clamp thresholds and the closest-point search
# switch): a 1e-6 relative nudge of JAX's own post-process input moves
# its output by up to 1.0-3.7, and a chaotic frame can come out
# differently from process to process.  So the port's
# post_process_motion runs on JAX's own post-process input and is held to
# JAX's output on the frames where JAX's output is stable (moves less than
# STABLE_ATOL under relative nudges of the joint quaternions by -1e-6 and
# 1e-6, and by four seeded random draws of 1e-6 each, which find frames
# the uniform ones miss), to POST_ATOL (measured <= 4.5e-4); at least
# MIN_STABLE of the frames must be stable (measured 0.15-0.78).  The
# passes' invariants hold exactly on every frame: the root's X, Z and
# rotation stay (no pass moves the root but the grounding's vertical
# shift, one constant); under grounding every joint off the legs stays.
POST_PROCESSED = ("ca_ik_mode", "motion_grounding",
                  "motion_grounding_stance_table")
STABLE_ATOL, POST_ATOL, MIN_STABLE = 1e-3, 1e-2, 0.1


@pytest.fixture(scope="module")
def feet_graphs():
    """The toy walk graph animating WALK_BVH's 11 joints (feet and toes)."""
    return tp.request_graphs(synj.make_graph_dict(n_joints=11),
                             synj.WALK_BVH)


@pytest.fixture
def fresh_jax_executables():
    """Free the XLA executables each request loads when its test ends (the
    grounding's vmapped IK compiles one per run length): a worker that
    holds them all passes the kernel's memory-map limit (see
    torch_parity.release_jax_executables)."""
    yield
    jax.clear_caches()
    gc.collect()


def _spy(monkeypatch, module, name):
    """Record every call of module.name as (args, kwargs, result)."""
    calls = []
    orig = getattr(module, name)

    def wrapper(*a, **kw):
        out = orig(*a, **kw)
        calls.append((a, kw, out))
        return out
    monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_formerly_refused_option_matches_jax(walk_graphs, feet_graphs,
                                             monkeypatch, name,
                                             fresh_jax_executables):
    """Each request option the port refused before ROADMAP item 13 was
    finished, against JAX's MotionGenerator on JAX's draws: node keys,
    step counts and frame ranges exactly, errors, latents and frames to
    the whole requests' tolerances (the post-processed frames as
    POST_PROCESSED says).  The option's pass must run in the port (a spy
    on its function) and, for the optimizations, move the latents."""
    from morphablegraphs_tpu.synthesis import postprocess as ppj
    from morphablegraphs_tpu_torch.synthesis import (  # noqa: F401
        generator, global_opt, grounding, postprocess)
    feet, mg_input, overrides, seed, (mod, fn, arg) = OPTIONS[name]
    cfg = _config()
    for key, val in overrides.items():
        cfg[key] = dict(cfg[key], **val) if isinstance(val, dict) else val
    calls = _spy(monkeypatch, locals()[mod], fn)
    post_in = []
    post_j = ppj.post_process_motion

    def capture(skel, frames, *a, **kw):
        post_in.append((skel, frames.copy(), a, kw))
        return post_j(skel, frames, *a, **kw)
    monkeypatch.setattr(ppj, "post_process_motion", capture)
    post_t = _spy(monkeypatch, postprocess, "post_process_motion")
    res_j, res_t, _ = _both(feet_graphs if feet else walk_graphs, mg_input,
                            cfg, seed)
    assert calls, f"{fn} never ran"
    if fn == "refine_lm":
        assert any(kw.get("use_ts") for _, kw, _ in calls)
    if arg is not None:
        a, _, out = calls[0]
        new = out[0] if isinstance(out, tuple) else out
        assert max(float(np.abs(n - o).max())
                   for n, o in zip(new, a[arg])) > 1e-3
    if name not in POST_PROCESSED:
        _assert_request_matches(res_j, res_t)
        return
    _assert_request_matches(res_j, res_t, frames=False)
    np.testing.assert_allclose(res_t.frames[:, :7], res_j.frames[:, :7],
                               rtol=1e-3, atol=1e-2)
    _assert_post_process_matches(post_j, post_in[-1], post_t[-1][:2],
                                 grounded=name != "ca_ik_mode")


def _assert_post_process_matches(post_j, jax_call, port_call, grounded):
    """The port's post_process_motion (its own arguments) on JAX's own
    post-process input, against JAX's output on the frames where that is
    stable, and the passes' invariants on every frame (see
    POST_PROCESSED)."""
    from morphablegraphs_tpu_torch.synthesis import grounding, postprocess
    skel_j, frames, a_j, kw_j = jax_call
    (skel_t, _, *a_t), kw_t = port_call
    out_j = post_j(skel_j, frames, *a_j, **kw_j)
    rng = np.random.default_rng(0)
    q = frames[:, 3:]
    scales = [np.float32(1 + eps) for eps in (-1e-6, 1e-6)] + [
        (1 + 1e-6 * rng.standard_normal(q.shape)).astype(np.float32)
        for _ in range(4)]
    spread = np.zeros(len(frames))
    for scale in scales:
        nudged = frames.copy()
        nudged[:, 3:] = q * scale
        spread = np.maximum(spread, np.abs(
            post_j(skel_j, nudged, *a_j, **kw_j) - out_j).max(1))
    stable = spread < STABLE_ATOL
    assert stable.mean() >= MIN_STABLE, stable.mean()
    out_t = postprocess.post_process_motion(skel_t, frames, *a_t, **kw_t)
    np.testing.assert_allclose(out_t[stable], out_j[stable], atol=POST_ATOL)
    assert float(np.abs(out_t - frames).max()) > 1e-2
    kept = np.ones(frames.shape[1], bool)
    kept[1] = False
    if grounded:
        legs = grounding._leg_joint_mask(
            skel_t, grounding._foot_nodes(skel_t, "both"))
        for j in np.flatnonzero(legs):
            kept[3 + 4 * j: 7 + 4 * j] = False
    else:
        kept[7:] = False
    np.testing.assert_array_equal(out_t[:, kept], frames[:, kept])
    shift = out_t[:, 1] - frames[:, 1]
    assert float(np.ptp(shift)) <= 1e-3
    assert grounded or float(np.abs(shift).max()) == 0.0


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_unported_options_are_refused(walk_graphs, name):
    """The branches of the JAX request path the port does not have
    (transition models, cluster-tree search) raise NotImplementedError
    naming their ROADMAP item; none is skipped."""
    overrides, mg_input, pattern = REFUSALS[name]
    cfg = _config(n_random_samples=4, lm_iterations=1, **overrides)
    gen = MotionGenerator(walk_graphs[1], cfg, device="cpu")
    with pytest.raises(NotImplementedError, match=pattern):
        gen.generate_motion(mg_input)


def test_node_cluster_tree_is_refused(walk_graphs):
    """A node carrying a cluster tree (an explicit candidate pool in the
    JAX package) is refused rather than sampled around."""
    g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)[1]
    g_t.nodes[("walk", "beginLeftStance")].cluster_tree = object()
    gen = MotionGenerator(g_t, _config(n_random_samples=4), device="cpu")
    with pytest.raises(NotImplementedError, match="cluster tree.*item 15"):
        gen.generate_motion(WALK_INPUT)


def test_unknown_action_raises_constraint_error(walk_graphs):
    gen = MotionGenerator(walk_graphs[1], default_config(), device="cpu")
    bad = {"elementaryActions": [{"action": "no_such_action"}]}
    with pytest.raises(ConstraintError, match="no_such_action"):
        gen.generate_motion(bad)


def test_default_device_needs_a_card(walk_graphs):
    """MotionGenerator runs on the CUDA device unless asked for the CPU;
    without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MotionGenerator(walk_graphs[1])
