"""Parity of the options of the PyTorch port's sequential request path that
ROADMAP item 13 finished (the global time and spatial optimizations, the
extra collision-avoidance pass and the "ik" mode, motion grounding) with
the JAX package's MotionGenerator on the CPU, driven by the JAX
generator's own draws (`torch_parity.jax_key_sampler`).  The whole
requests are held to the tolerances of tests/test_torch_motion_generator.py
(`torch_parity.assert_request_matches`); the post-processed frames as
POST_PROCESSED below says."""

import gc

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import (KEYFRAME_INPUT, WALK_INPUT,  # noqa: E402,F401
                          release_jax_executables)


@pytest.fixture(scope="module")
def walk_graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _config(**kw):
    cfg = default_config()
    cfg.update(kw)
    return cfg


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
    res_j, res_t, _ = tp.request_both(feet_graphs if feet else walk_graphs,
                                      mg_input, cfg, seed)
    assert calls, f"{fn} never ran"
    if fn == "refine_lm":
        assert any(kw.get("use_ts") for _, kw, _ in calls)
    if arg is not None:
        a, _, out = calls[0]
        new = out[0] if isinstance(out, tuple) else out
        assert max(float(np.abs(n - o).max())
                   for n, o in zip(new, a[arg])) > 1e-3
    if name not in POST_PROCESSED:
        tp.assert_request_matches(res_j, res_t)
        return
    tp.assert_request_matches(res_j, res_t, frames=False)
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
