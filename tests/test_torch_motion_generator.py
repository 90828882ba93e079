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
tests/test_motion_generator.py, whose keyframe holds on every step.
The options ROADMAP item 13 finished (global optimizations, the
collision-avoidance passes, grounding) are held to JAX in
tests/test_torch_request_options.py."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.synthesis.motion_generator import \
    MotionGenerator  # noqa: E402
from morphablegraphs_tpu_torch.utils.exceptions import \
    ConstraintError  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import (KEYFRAME_INPUT, WALK_INPUT,  # noqa: E402,F401
                          release_jax_executables)


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


@pytest.mark.parametrize("n_lm_starts", [1, 4])
def test_walk_request_matches_jax(walk_graphs, n_lm_starts):
    """WALK_INPUT with 30 samples and 5 LM iterations, from the best
    candidate (C = 1) or from the 4 best as one C = 4 LM; the pool, the
    LM's B2 solves and B5 terms and the B6-source frame emission all go
    through the kernel wrappers (their twins on the CPU)."""
    cfg = _config(n_random_samples=30, lm_iterations=5,
                  n_lm_starts=n_lm_starts)
    res_j, res_t, launches = tp.request_both(walk_graphs, WALK_INPUT, cfg,
                                             seed=0)
    assert len(res_j.steps) >= 3
    tp.assert_request_matches(res_j, res_t)
    # the twins do not count: only a kernel launch does
    assert all(v == 0 for v in launches.values())


def test_end_keyframe_request_with_ik_matches_jax(walk_graphs):
    """The keyframe request of tests/test_motion_generator.py (8 LM
    iterations, seed 1), capped at three steps: the Hips keyframe is a
    user constraint on every step, so post-processing solves three IK
    constraints; the frames compare after IK."""
    cfg = _config(n_random_samples=30, lm_iterations=8, debug_max_step=2)
    res_j, res_t, _ = tp.request_both(walk_graphs, KEYFRAME_INPUT, cfg,
                                      seed=1)
    assert len(res_j.steps) == 3
    assert all(s.user_constraints for s in res_t.steps)
    tp.assert_request_matches(res_j, res_t)


def test_pick_carry_place_request_matches_jax():
    """pick -> carry -> place on the multi-action graph: each action's
    start node is the one linked from the previous action's last node,
    the carry follows a trajectory, the pick and place keyframes go
    through IK."""
    graphs = tp.request_graphs(synj.make_multi_action_graph_dict(),
                               synj.TEST_BVH)
    cfg = _config(n_random_samples=20, lm_iterations=3)
    res_j, res_t, _ = tp.request_both(graphs, PICK_CARRY_PLACE, cfg, seed=2)
    assert [s.node_key[0] for s in res_t.steps] == \
        ["pickRight", "carryRight", "placeRight"]
    tp.assert_request_matches(res_j, res_t)


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
    res_j, res_t, _ = tp.request_both(walk_graphs, WALK_INPUT, cfg, seed=0)
    tp.assert_request_matches(res_j, res_t)


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


REFUSALS = {
    # refused until transition models and cluster trees were ported; on
    # a graph without models or trees they change nothing (pattern None:
    # the request must run)
    "use_transition_model": (dict(use_transition_model=True),
                             WALK_INPUT, None),
    "cluster_tree_search": (
        dict(constrained_sampling_mode="cluster_tree_search"), WALK_INPUT,
        None),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_unported_options_are_refused(walk_graphs, name):
    """A branch of the JAX request path the port does not have would raise
    NotImplementedError naming its ROADMAP item; none is left.
    use_transition_model and cluster_tree_search, now ported, run, and on
    a graph without transition models or trees give the request without
    them."""
    overrides, mg_input, pattern = REFUSALS[name]
    cfg = _config(n_random_samples=4, lm_iterations=1, **overrides)
    gen = MotionGenerator(walk_graphs[1], cfg, device="cpu")
    if pattern is None:
        plain = MotionGenerator(walk_graphs[1], _config(
            n_random_samples=4, lm_iterations=1), device="cpu")
        np.testing.assert_array_equal(gen.generate_motion(mg_input).frames,
                                      plain.generate_motion(mg_input).frames)
        return
    with pytest.raises(NotImplementedError, match=pattern):
        gen.generate_motion(mg_input)


def test_node_cluster_tree_is_refused(walk_graphs):
    """A node carrying a cluster tree (an explicit candidate pool in the
    JAX package under cluster_tree_search; refused until ROADMAP item 15
    was ported) is searched in that mode: without the LM every step on it
    is one of the tree's rows; under the default random_discrete the tree
    is not read, as in JAX, and the request equals the one without it."""
    from morphablegraphs_tpu_torch.construct.space_partitioning import \
        build_cluster_tree_for_primitive
    g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)[1]
    cfg = _config(n_random_samples=4, lm_iterations=1)
    plain = MotionGenerator(g_t, cfg, device="cpu").generate_motion(
        WALK_INPUT)
    key = ("walk", "beginLeftStance")
    tree = build_cluster_tree_for_primitive(
        torch.Generator().manual_seed(0), g_t.nodes[key].primitive,
        n_samples=50, max_level=2)
    g_t.nodes[key].cluster_tree = tree
    res = MotionGenerator(g_t, _config(
        n_random_samples=4, constrained_sampling_mode="cluster_tree_search",
        local_optimization_mode="none"), device="cpu").generate_motion(
        WALK_INPUT)
    on_tree = [s for s in res.steps if s.node_key == key]
    assert on_tree and np.all(np.isfinite(res.frames))
    for s in on_tree:
        assert np.any(np.all(tree.data == np.asarray(
            s.parameters, np.float32), axis=1))
    res = MotionGenerator(g_t, cfg, device="cpu").generate_motion(WALK_INPUT)
    np.testing.assert_array_equal(res.frames, plain.frames)


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
