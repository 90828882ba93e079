"""Parity of the host-side functions the port's request path added
(timewarp, align, spline_path, gmm, skeleton, primitive, graph, ik,
action_builder, postprocess, generator) with their JAX counterparts on
the same inputs.  Float32 results compare to ~1e-5 relative; the IK and
the LM, which iterate a damped solve, to the bounds stated at each test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints.input_reader import \
    read_input as read_input_j  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.ops import ik as ikj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.ops import timewarp as twj  # noqa: E402
from morphablegraphs_tpu.synthesis import action_builder as abj  # noqa: E402
from morphablegraphs_tpu.synthesis import generator as gnj  # noqa: E402
from morphablegraphs_tpu.synthesis import postprocess as ppj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.constraints.input_reader import \
    read_input as read_input_t  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import align as alt  # noqa: E402
from morphablegraphs_tpu_torch.ops import gmm as gmt  # noqa: E402
from morphablegraphs_tpu_torch.ops import ik as ikt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.ops import timewarp as twt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import action_builder as abt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import generator as gnt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import postprocess as ppt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

NODES = ("beginLeftStance", "leftStance", "rightStance", "endRightStance")


@pytest.fixture(scope="module")
def graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _prims(graphs, name):
    g_j, g_t = graphs
    return (g_j.nodes[("walk", name)].primitive,
            g_t.nodes[("walk", name)].primitive)


def _latent(prim_j, seed):
    return np.array(prj.sample_latent(jax.random.PRNGKey(seed), prim_j, 1)[0])


# ---------------------------------------------------------------------------
# ops/timewarp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("speed", [1.0, 1.5])
@pytest.mark.parametrize("name", NODES[::3])
def test_time_function_matches_jax(graphs, name, speed):
    """canonical_time_function, invert_time_function and the primitive's
    time_function of a drawn temporal latent."""
    p_j, p_t = _prims(graphs, name)
    gamma = _latent(p_j, 1)[p_j.n_spatial:]
    t_can_j = twj.canonical_time_function(p_j.mean_t_d, p_j.eigen_t_d,
                                          jnp.asarray(gamma))
    t_can_t = twt.canonical_time_function(p_t.mean_t_d, p_t.eigen_t_d,
                                          torch.as_tensor(gamma))
    np.testing.assert_allclose(t_can_t.numpy(), np.asarray(t_can_j),
                               rtol=1e-5, atol=1e-4)
    max_frames = 96
    inv_j, n_j = twj.invert_time_function(t_can_j, p_j.n_canonical_frames,
                                          max_frames, speed)
    inv_t, n_t = twt.invert_time_function(torch.as_tensor(
        np.asarray(t_can_j)), p_t.n_canonical_frames, max_frames, speed)
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), atol=1e-4)
    tf_j, tn_j = prj.time_function(p_j, jnp.asarray(gamma), max_frames,
                                   speed)
    tf_t, tn_t = prt.time_function(p_t, torch.as_tensor(gamma), max_frames,
                                   speed)
    assert int(tn_t) == int(tn_j)
    np.testing.assert_allclose(tf_t.numpy(), np.asarray(tf_j), atol=1e-4)


@pytest.mark.parametrize("speed", [1.0, 0.8])
def test_linear_time_function_matches_jax(speed):
    vals_j, n_j = twj.linear_time_function(40, 64, speed)
    vals_t, n_t = twt.linear_time_function(40, 64, speed)
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(vals_t.numpy(), np.asarray(vals_j),
                               rtol=1e-6)


@pytest.mark.parametrize("n", [10, 15, 37])
def test_savgol_matches_jax(n):
    """savgol_smooth (torch, batched rows) and smooth_time_function_np
    against the JAX package's; rows shorter than the window pass
    through."""
    y = np.cumsum(np.random.default_rng(n).random((3, n)), axis=-1)
    out_j = np.asarray(twj.savgol_smooth(jnp.asarray(y, jnp.float32)))
    out_t = twt.savgol_smooth(torch.as_tensor(y, dtype=torch.float32))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(twt.smooth_time_function_np(y[0]),
                               twj.smooth_time_function_np(y[0]),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# ops/align
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pos", [[3.0, np.nan, -7.5], [0.0, 1.0, 2.0]])
def test_transform_from_start_pose_matches_jax(pos):
    q_j, d_j = alj.transform_from_start_pose(jnp.asarray(pos, jnp.float32),
                                             jnp.asarray(37.0))
    q_t, d_t = alt.transform_from_start_pose(
        torch.tensor(pos, dtype=torch.float32), torch.tensor(37.0))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-7)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("window", [0, 5, 12, 40])
def test_blend_seam_matches_jax(window):
    rng = np.random.default_rng(window)
    prev = rng.standard_normal((20, 11)).astype(np.float32)
    new = rng.standard_normal((15, 11)).astype(np.float32)
    for a, b in zip(alt.blend_seam_np(prev, new, window),
                    alj.blend_seam_np(prev, new, window)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("window", [0, 1, 4, 7, 30])
def test_filter_root_matches_jax(window):
    frames = np.random.default_rng(window).standard_normal(
        (25, 11)).astype(np.float32)
    np.testing.assert_array_equal(alt.filter_root_np(frames, window),
                                  alj.filter_root_np(frames, window))


# ---------------------------------------------------------------------------
# ops/spline_path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("args", [
    (120.0, 1e-3, 5000, 1000), (120.0, 0.5, 5000, 1000),
    (5.0, 1e-6, 5000, 256), (300.0, 1e-3, 7, 1000), (80.0, 0.0, 5000, 1000),
    (80.0, 10.0, 5000, 100)])
def test_refine_iters_matches_jax(args):
    assert spt.refine_iters_for_accuracy(*args) == \
        spj.refine_iters_for_accuracy(*args)


def _paths():
    cp = np.array([[0.0, 0, 0], [5.0, 0, 40], [15.0, 0, 80], [20.0, 0, 120],
                   [0.0, 0, 130]], np.float32)
    return (spj.build(cp, unconstrained_dims=(1,)),
            spt.build(cp, unconstrained_dims=(1,)))


@pytest.mark.parametrize("case", [
    ((6.0, 90.0, 45.0), 0.0, None), ((6.0, 90.0, 45.0), 20.0, None),
    ((6.0, 90.0, 45.0), 10.0, 25.0), ((2.0, 90.0, 125.0), 30.0, 100.0),
    ((2.0, 90.0, 125.0), 130.0, 150.0), ((50.0, 90.0, 60.0), 500.0, None)])
def test_closest_point_matches_jax(case):
    """closest_point with and without the look-ahead window
    (max_arc_length, bounded), including a point nearer a later part of a
    self-approaching path and a floor past the path's end."""
    point, lo, hi = case
    sp_j, sp_t = _paths()
    kw_j = {} if hi is None else dict(max_arc_length=jnp.float32(hi),
                                      bounded=True)
    kw_t = {} if hi is None else dict(max_arc_length=torch.tensor(hi),
                                      bounded=True)
    out_j = spj.closest_point(sp_j, jnp.asarray(point, jnp.float32),
                              jnp.float32(lo), n_refine=12, **kw_j)
    out_t = spt.closest_point(sp_t, torch.tensor(point), torch.tensor(lo),
                              n_refine=12, **kw_t)
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2e-3)
    if hi is not None:
        assert lo - 1e-4 <= float(out_t[1]) <= max(hi, lo) + 1e-4


def test_tangent_at_arc_length_matches_jax():
    sp_j, sp_t = _paths()
    arcs = np.array([0.0, 33.0, 101.5, 200.0], np.float32)
    np.testing.assert_allclose(
        spt.tangent_at_arc_length(sp_t, torch.as_tensor(arcs)).numpy(),
        np.asarray(spj.tangent_at_arc_length(sp_j, jnp.asarray(arcs))),
        atol=1e-5)


# ---------------------------------------------------------------------------
# ops/gmm, models/primitive
# ---------------------------------------------------------------------------

def test_gmm_sample_distribution(graphs):
    """ops.gmm.sample: draws from a torch.Generator, reproducible for a
    seed, with the mixture's mean and covariance (20000 draws: the sample
    mean within 4 standard errors per dim, the covariance to 0.1)."""
    p_j, p_t = _prims(graphs, "leftStance")
    g = p_t.gmm
    draws = gmt.sample(torch.Generator().manual_seed(0), g, 20000).numpy()
    five = gmt.sample(torch.Generator().manual_seed(1), g, 5).numpy()
    w = g.weights.numpy().astype(np.float64)
    mu = g.means.numpy().astype(np.float64)
    ch = g.cov_chol.numpy().astype(np.float64)
    cov_k = np.einsum("kij,klj->kil", ch, ch)
    mean = w @ mu
    cov = np.einsum("k,kij->ij", w, cov_k + np.einsum("ki,kj->kij", mu, mu)) \
        - np.outer(mean, mean)
    se = np.sqrt(np.diag(cov) / len(draws))
    assert np.all(np.abs(draws.mean(0) - mean) < 4 * se)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=0.1)
    sl = prt.sample_latent(torch.Generator().manual_seed(1), p_t, 5)
    np.testing.assert_array_equal(sl.numpy(), five)


@pytest.mark.parametrize("use_time", [True, False])
@pytest.mark.parametrize("name", NODES[:2])
def test_back_project_matches_jax(graphs, name, use_time):
    """back_project (the warped and the canonical timeline; the
    frame-emit kernel's twin on the CPU) and evaluate_at."""
    p_j, p_t = _prims(graphs, name)
    s = _latent(p_j, 3)
    f_j, n_j, t_j = prj.back_project(p_j, jnp.asarray(s), 96,
                                     use_time=use_time)
    f_t, n_t, t_t = prt.back_project(p_t, torch.as_tensor(s), 96,
                                     use_time=use_time)
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=1e-4)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5,
                               atol=2e-4)
    t = np.linspace(0.0, p_j.n_canonical_frames - 1, 23).astype(np.float32)
    np.testing.assert_allclose(
        prt.evaluate_at(p_t, torch.as_tensor(s), torch.as_tensor(t)).numpy(),
        np.asarray(prj.evaluate_at(p_j, jnp.asarray(s), jnp.asarray(t))),
        rtol=1e-5, atol=2e-4)


def test_primitive_metadata_matches_jax(graphs):
    """The metadata the planner reads: has_time, animated_joints and the
    keyframe labels, on the legacy and the v3 schema."""
    legacy = synj.make_legacy_model_json(seed=4)
    for data in (legacy, synj.to_v3_json(legacy)):
        p_j = prj.load_primitive_json(data)
        p_t = prt.load_primitive_json(data)
        assert (p_t.has_time, p_t.animated_joints, p_t.keyframes) == \
            (p_j.has_time, p_j.animated_joints, p_j.keyframes)
        for label in ("start", "middle", "end", "nope"):
            assert p_t.keyframe_for_label(label) == \
                p_j.keyframe_for_label(label)


def test_graph_planner_fields_match_jax():
    """edges_of_type, the label maps and map_label_to_keyframe of the
    multi-action graph (keyframe labels from the model files)."""
    g_j, g_t = tp.request_graphs(synj.make_multi_action_graph_dict(),
                                 synj.TEST_BVH)
    for key, node in g_j.nodes.items():
        for t in ("standard", "end", "start", "action_transition"):
            assert g_t.nodes[key].edges_of_type(t) == node.edges_of_type(t)
        assert g_t.nodes[key].cluster_tree is None
        assert not g_t.nodes[key].has_transition_model(key)
    for action, grp in g_j.node_groups.items():
        grp_t = g_t.node_groups[action]
        assert grp_t.labeled_frames == grp.labeled_frames
        assert grp_t.label_to_motion_primitive_map == \
            grp.label_to_motion_primitive_map
        for _, mp in grp.node_keys:
            for label in ("start", "end", "start_contact", "lastFrame"):
                assert grp_t.map_label_to_keyframe(mp, label, 40) == \
                    grp.map_label_to_keyframe(mp, label, 40)


# ---------------------------------------------------------------------------
# models/skeleton, ops/ik
# ---------------------------------------------------------------------------

def test_add_fixed_joint_parameters_matches_jax():
    """Frames over a joint subset expanded to the full skeleton: missing
    joints take their rest rotation (the fixed-joint skeleton's) or
    identity."""
    skel_j, skel_t = tp.fixed_joint_skeleton()
    frames = np.random.default_rng(0).standard_normal((6, 7)).astype(
        np.float32)
    for subset in (None, ("Hips",)):
        np.testing.assert_array_equal(
            skt.add_fixed_joint_parameters_to_motion(skel_t, frames, subset),
            skj.add_fixed_joint_parameters_to_motion(skel_j, frames, subset))
    ref_j = skj.load_bvh(synj.REF_BVH)[0]
    ref_t = skt.load_bvh(synj.REF_BVH)[0]
    sub = ref_t.animated_joints[::2]
    part = np.random.default_rng(1).standard_normal(
        (4, 3 + 4 * len(sub))).astype(np.float32)
    np.testing.assert_array_equal(
        skt.add_fixed_joint_parameters_to_motion(ref_t, part, sub),
        skj.add_fixed_joint_parameters_to_motion(ref_j, part, sub))


def test_np_from_euler_and_fk_positions_match_jax():
    ang = np.array([[10.0, -35.0, 80.0], [0.0, 0.0, 0.0]])
    np.testing.assert_array_equal(skt._np_from_euler(ang, "rxyz"),
                                  skj._np_from_euler(ang, "rxyz"))
    skel_j, _ = skj.load_bvh(synj.REF_BVH)
    skel_t, _ = skt.load_bvh(synj.REF_BVH)
    f = tp.prev_frame(skel_t.n_frame_params, 10.0, -4.0)
    np.testing.assert_allclose(
        skt.fk_positions(skel_t, torch.as_tensor(f)).numpy(),
        np.asarray(skj.fk_positions(skel_j, jnp.asarray(f))), atol=1e-4)


@pytest.mark.parametrize("scale", ["toy", "ref"])
def test_solve_ik_matches_jax(scale):
    """solve_ik on one frame, one constraint (with a tool offset on the
    toy) and a pinned joint on the reference skeleton, the root held:
    10 damped Gauss-Newton steps agree to 1e-3 (float32 rounding through
    ten [3J, 3J] solves); the tip reaches the JAX result's distance."""
    bvh, joint, pin = ((synj.TEST_BVH, "Head", None) if scale == "toy"
                       else (synj.REF_BVH, "RightHand", "LeftHand"))
    skel_j, _ = skj.load_bvh(bvh)
    skel_t, _ = skt.load_bvh(bvh)
    f = tp.prev_frame(skel_t.n_frame_params, 0.0, 0.0, seed=2)
    pos = np.asarray(skj.fk_positions(skel_j, jnp.asarray(f)))
    m = ikj.MAX_IK_CONSTRAINTS
    nodes = np.zeros(m, np.int32)
    targets = np.zeros((m, 3), np.float32)
    mask = np.zeros(m, np.float32)
    offsets = np.zeros((m, 3), np.float32)
    nodes[0] = skel_j.index_of(joint)
    targets[0] = pos[nodes[0]] + np.array([8.0, -5.0, 6.0], np.float32)
    mask[0] = 1.0
    if pin is None:
        offsets[0] = [0.0, 3.0, 1.0]
    else:
        nodes[1] = skel_j.index_of(pin)
        targets[1] = pos[nodes[1]]
        mask[1] = 1.0
    jm = np.ones(skel_j.n_animated, np.float32)
    jm[0] = 0.0
    out_j = np.asarray(ikj.solve_ik(
        skel_j, jnp.asarray(f), jnp.asarray(nodes), jnp.asarray(targets),
        jnp.asarray(mask), jnp.asarray(jm), n_iters=10,
        target_offsets=jnp.asarray(offsets)))
    out_t = ikt.solve_ik(
        skel_t, torch.as_tensor(f), torch.as_tensor(nodes),
        torch.as_tensor(targets), torch.as_tensor(mask),
        torch.as_tensor(jm), n_iters=10,
        target_offsets=torch.as_tensor(offsets)).numpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-3)
    np.testing.assert_array_equal(out_t[:7], f[:7])  # the root is held


# ---------------------------------------------------------------------------
# synthesis: action_builder, generator, postprocess
# ---------------------------------------------------------------------------

REQUEST = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 20, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [
            {"joint": "Hips", "trajectoryConstraints": [
                {"position": [0.0, None, 0.0]},
                {"position": [5.0, None, 40.0]},
                {"position": [20.0, None, 120.0]}]},
            {"joint": "Head", "keyframeConstraints": [{
                "position": [6.0, 150.0, 30.0], "orientation": [0, 30, 0],
                "semanticAnnotation": {"end": True}}]}],
    }],
}


def _host_leaves_equal(sc_t, sc_j):
    for name in ("kf_active", "kf_node", "kf_pos", "kf_pos_mask", "kf_quat",
                 "kf_has_quat", "kf_frame", "kf_weight", "kf_generated",
                 "dir_active", "dir_target", "dir_frame", "dir_weight",
                 "pose_active", "traj_active", "traj_node", "traj_min_arc",
                 "has_prev", "prev_last", "start_q", "start_delta",
                 "n_canonical"):
        np.testing.assert_allclose(np.asarray(getattr(sc_t, name)),
                                   np.asarray(getattr(sc_j, name)),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("defer", [False, True])
@pytest.mark.parametrize("travelled", [0.0, 35.0])
def test_step_constraints_match_jax(graphs, defer, travelled):
    """build_action_constraints and build_step_constraints (the goal on
    the path or the deferred locomotion spec, the user keyframe with its
    orientation, the alignment from the previous frame or the start
    pose), and the planner's option-evaluation set."""
    g_j, g_t = graphs
    cfg = default_config()
    acs_j = abj.build_action_constraints(g_j, read_input_j(REQUEST), cfg)[0]
    acs_t = abt.build_action_constraints(g_t, read_input_t(REQUEST), cfg)[0]
    assert acs_t.full_arc_length == pytest.approx(acs_j.full_arc_length,
                                                  rel=1e-6)
    np.testing.assert_allclose(acs_t.start_pose_orientation_y,
                               acs_j.start_pose_orientation_y)
    assert sorted(acs_t.keyframe_constraints) == \
        sorted(acs_j.keyframe_constraints)
    prev = None if travelled == 0.0 else tp.prev_frame(
        g_t.skeleton.n_frame_params, 3.0, 30.0)[None]
    key = ("walk", "leftStance")
    out_j = abj.build_step_constraints(g_j, acs_j, key, travelled, prev,
                                       False, cfg, defer_locomotion=defer)
    out_t = abt.build_step_constraints(g_t, acs_t, key, travelled, prev,
                                       False, cfg, defer_locomotion=defer)
    if defer:
        (sc_j, loco_j, flags_j), (sc_t, loco_t, flags_t) = out_j, out_t
        assert flags_t == flags_j
        for f in ("goal_arc", "half_arc", "node", "end_kf", "mid_kf",
                  "dim_mask", "pos_weight", "dir_weight"):
            np.testing.assert_allclose(np.asarray(getattr(loco_t, f)),
                                       np.asarray(getattr(loco_j, f)),
                                       rtol=1e-6)
    else:
        sc_j, sc_t = out_j, out_t
    _host_leaves_equal(sc_t, sc_j)
    opt_j = abj.build_option_eval_constraints(g_j, acs_j, key, travelled,
                                              prev, cfg, True)
    opt_t = abt.build_option_eval_constraints(g_t, acs_t, key, travelled,
                                              prev, cfg, True)
    _host_leaves_equal(opt_t, opt_j)


@pytest.mark.parametrize("n_starts", [1, 3])
def test_constrained_sample_matches_jax(graphs, n_starts):
    """One step's selection on a shared pool: the exact scoring, the
    threshold-gated LM from the best candidate or from the 3 best as one
    C = 3 LM (5 iterations; latents to 2e-3, errors to 1e-3 relative, the
    damped solve's float32 rounding), then the epilogue's frames and
    travelled arc."""
    g_j, g_t = graphs
    cfg = default_config()
    cfg.update(n_random_samples=24, lm_iterations=5, n_lm_starts=n_starts)
    acs_j = abj.build_action_constraints(g_j, read_input_j(REQUEST), cfg)[0]
    acs_t = abt.build_action_constraints(g_t, read_input_t(REQUEST), cfg)[0]
    key = ("walk", "leftStance")
    prev = tp.prev_frame(g_t.skeleton.n_frame_params, 3.0, 30.0)[None]
    sc_j = abj.build_step_constraints(g_j, acs_j, key, 30.0, prev, False,
                                      cfg)
    sc_t = abt.build_step_constraints(g_t, acs_t, key, 30.0, prev, False,
                                      cfg)
    p_j, p_t = _prims(graphs, "leftStance")
    pool = np.array(prj.sample_latent(jax.random.PRNGKey(4), p_j, 24))
    s_j, e_j = gnj.generate_constrained_sample(
        jax.random.PRNGKey(0), g_j.skeleton, p_j, sc_j, cfg,
        candidates=jnp.asarray(pool))
    scd = gnt.device_constraints(sc_t, "cpu")
    p = gnt.selection_params(g_t.skeleton, sc_t, cfg)
    s_t, e_t = gnt.generate_constrained_sample(
        g_t.skeleton, p_t, scd, torch.as_tensor(pool), p)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=2e-3)
    np.testing.assert_allclose(float(e_t), float(e_j), rtol=1e-3)
    window = 20
    f_j, n_j, arc_j = gnj.finalize_step(
        p_j, s_j, sc_j, sc_j.traj, 30.0, max_frames=64, window=window,
        use_traj=True, look_ahead=jnp.float32(100.0), n_refine=8)
    f_t, n_t, arc_t = gnt.finalize_step(
        p_t, torch.as_tensor(np.asarray(s_j)), scd, True,
        spt.map_leaves(acs_t.root_trajectory, lambda a: a[None]), 30.0, 64,
        window, use_traj=True, look_ahead=100.0, n_refine=8)
    assert int(n_t) == int(n_j)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-5,
                               atol=2e-3)
    # the arc to the ternary search's resolution: 8 iterations leave a
    # bracket of 2 cells x (2/3)^8 ~ 0.01 cm on this ~130 cm path
    np.testing.assert_allclose(float(arc_t[0]), float(arc_j), atol=2e-2)


def test_ik_post_process_matches_jax(graphs):
    """create_ik_constraints (the frame from the keyframe's canonical
    position; a place action drops the orientation) and
    apply_ik_constraints with blending and the orientation step."""
    g_j, g_t = graphs
    skel_j, skel_t = g_j.skeleton, g_t.skeleton

    class Step:
        def __init__(self, node_key, start, end, action):
            self.node_key, self.start_frame, self.end_frame = \
                node_key, start, end
            self.action_name = action

    steps = [Step(("walk", "leftStance"), 0, 47, "walk"),
             Step(("walk", "rightStance"), 48, 101, "placeRight")]
    quat = tuple(skj._np_from_euler(np.array([0.0, 40.0, 10.0]), "rxyz"))
    specs = {0: [("Head", np.array([20.0, 150.0, 30.0]), 30, quat)],
             1: [("Leg", np.array([np.nan, 10.0, 60.0]), 20, quat)]}
    ik_j = ppj.create_ik_constraints(g_j, steps, specs)
    ik_t = ppt.create_ik_constraints(g_t, steps, specs)
    assert [(c.frame_idx, c.joint, c.orientation is None) for c in ik_t] == \
        [(c.frame_idx, c.joint, c.orientation is None) for c in ik_j]
    rng = np.random.default_rng(5)
    frames = np.stack([tp.prev_frame(skel_t.n_frame_params, 0.3 * i, 2.0 * i,
                                     seed=int(rng.integers(1 << 30)))
                       for i in range(102)])
    # two sequential solves with blending, then the orientation step:
    # float32 rounding through the damped solves moves joint quaternion
    # components by up to 1.3e-3 (measured)
    out_j = ppj.apply_ik_constraints(skel_j, frames, ik_j,
                                     interpolation_window=30, n_iters=6)
    out_t = ppt.apply_ik_constraints(skel_t, frames, ik_t,
                                     interpolation_window=30, n_iters=6,
                                     device="cpu")
    np.testing.assert_allclose(out_t, out_j, atol=5e-3)
    cfg = default_config()
    np.testing.assert_allclose(
        ppt.post_process_motion(skel_t, frames, steps, ik_t, cfg,
                                device="cpu"),
        ppj.post_process_motion(skel_j, frames, steps, ik_j, cfg),
        atol=5e-3)
