"""Parity of the PyTorch port's global refinement
(`synthesis.global_opt`) with the JAX package's on the CPU, on the inputs
of tests/test_global_opt.py (the toy walk graph, TEST_BVH).

Tolerances: `_chain_residuals` to 1e-4 relative (measured equal: the same
float32 operations in the same order); `adapt_constraint_weights` exactly.
The spatial LM's damped normal equations are ill-conditioned (condition
~1.9e4 at lambda 1e-2 on these inputs, 50 latents and a few active
slots): its jacobian agrees to 1.4e-6 on entries up to 8.3, and JAX's
float32 solve and the port's float64 one then land 6.9e-4 apart after
one iteration (steps of ~10) and 7.8e-3 after eight, with errors 1e-3
and 9.4e-3 relative apart; held at atol 5e-3 / 3e-2 and rtol 5e-3 /
3e-2.  The time LM: held at 1e-2 on gammas moved by ~10."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.ops import timewarp as twj  # noqa: E402
from morphablegraphs_tpu.synthesis import global_opt as goj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import generator as gnt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import global_opt as got  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

KEYS = [("walk", "beginLeftStance"), ("walk", "rightStance")]


@pytest.fixture(scope="module")
def graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _prims(graphs):
    g_j, g_t = graphs
    return ([g_j.nodes[k].primitive for k in KEYS],
            [g_t.nodes[k].primitive for k in KEYS])


def _window_scs(mod, skel, prims, has_prev=False):
    """tests/test_global_opt.py's window: a Hips end keyframe per step,
    the first step placed at the start pose (or, with has_prev, aligned
    to a previous frame)."""
    sc0 = mod.empty_step_constraints(skel, prims[0].n_canonical_frames)
    sc0 = mod.set_keyframe_constraint(
        sc0, 0, skel, "Hips", prims[0].n_canonical_frames - 1,
        position=np.array([5.0, np.nan, 20.0]))
    if has_prev:
        sc0 = mod.set_alignment_from_prev(
            sc0, tp.prev_frame(skel.n_frame_params, -3.0, -20.0))
    else:
        sc0 = mod.set_alignment_from_start_pose(sc0, np.zeros(3), 0.0)
    sc1 = mod.empty_step_constraints(skel, prims[1].n_canonical_frames)
    sc1 = mod.set_keyframe_constraint(
        sc1, 0, skel, "Hips", prims[1].n_canonical_frames - 1,
        position=np.array([10.0, np.nan, 45.0]))
    return [sc0, sc1]


def _params(prims_j, seed):
    key = jax.random.PRNGKey(seed)
    out = []
    for prim in prims_j:
        key, sub = jax.random.split(key)
        out.append(np.asarray(prj.sample_latent(sub, prim, 1)[0]))
    return out


@pytest.mark.parametrize("has_prev", [False, True])
@pytest.mark.parametrize("quality_scale", [0.0, 1e-5])
def test_chain_residuals_matches_jax(graphs, has_prev, quality_scale):
    """The window's residuals with the chained alignment, from the start
    pose or a previous frame, with and without the GMM term (B5's twin
    over the stacked mixtures)."""
    g_j, g_t = graphs
    p_j, p_t = _prims(graphs)
    scs_j = _window_scs(cj, g_j.skeleton, p_j, has_prev)
    scs_t = [gnt.device_constraints(sc, "cpu")
             for sc in _window_scs(ct, g_t.skeleton, p_t, has_prev)]
    params = _params(p_j, 0)
    r_j = np.asarray(goj._chain_residuals(
        g_j.skeleton, p_j, scs_j,
        [jnp.asarray(p[: pr.n_spatial]) for p, pr in zip(params, p_j)],
        [jnp.asarray(p[pr.n_spatial:]) for p, pr in zip(params, p_j)],
        quality_scale))
    r_t = got._chain_residuals(
        g_t.skeleton, p_t, scs_t,
        [torch.as_tensor(p[: pr.n_spatial]) for p, pr in zip(params, p_t)],
        [torch.as_tensor(p[pr.n_spatial:]) for p, pr in zip(params, p_t)],
        quality_scale).numpy()
    assert r_t.shape == r_j.shape == (2 * ct.N_RESIDUALS,)
    np.testing.assert_allclose(r_t, r_j, rtol=1e-4, atol=1e-4)


def _weight_scs(mod, skel, prim):
    """tests/test_global_opt.py's weight sets: a generated goal in slot 0,
    a user keyframe in slot 1, a direction."""
    sc = mod.empty_step_constraints(skel, prim.n_canonical_frames)
    sc = mod.set_keyframe_constraint(
        sc, 0, skel, "Hips", prim.n_canonical_frames - 1,
        position=np.array([5.0, np.nan, 20.0]), weight=2.0, generated=True)
    sc = mod.set_keyframe_constraint(
        sc, 1, skel, "Hips", prim.n_canonical_frames - 1,
        position=np.array([5.0, np.nan, 20.0]), weight=1.0)
    return mod.set_direction_constraint(
        sc, np.array([0.0, 1.0]), prim.n_canonical_frames - 1, weight=3.0)


@pytest.mark.parametrize("form", ["host", "device"])
@pytest.mark.parametrize("mode", ["all", "two_hands", "trajectory_end"])
def test_adapt_constraint_weights_matches_jax(graphs, mode, form):
    """The weights each mode sets, on host sets and on the [1]-axis
    device sets the request path stores; the inputs stay unchanged."""
    g_j, g_t = graphs
    p_j, p_t = _prims(graphs)
    scs_j = [_weight_scs(cj, g_j.skeleton, p_j[0]) for _ in range(2)]
    scs_t = [_weight_scs(ct, g_t.skeleton, p_t[0]) for _ in range(2)]
    if form == "device":
        scs_t = [gnt.device_constraints(sc, "cpu") for sc in scs_t]
    out_j = goj.adapt_constraint_weights(scs_j, mode, 1000.0, 77.0)
    out_t = got.adapt_constraint_weights(scs_t, mode, 1000.0, 77.0)
    for a, b, b_in in zip(out_j, out_t, scs_t):
        np.testing.assert_array_equal(
            np.asarray(b.kf_weight).reshape(-1), np.asarray(a.kf_weight))
        np.testing.assert_array_equal(
            np.asarray(b.dir_weight).reshape(-1),
            np.asarray(a.dir_weight).reshape(-1))
        np.testing.assert_array_equal(
            np.asarray(b_in.kf_weight).reshape(-1)[:2], [2.0, 1.0])


@pytest.mark.parametrize("n_iters", [1, 8])
def test_optimize_spatial_over_steps_matches_jax(graphs, n_iters):
    """The window LM on tests/test_global_opt.py's inputs, element-wise
    (tolerances in the module docstring); B5 is not launched on the
    CPU."""
    g_j, g_t = graphs
    p_j, p_t = _prims(graphs)
    params = _params(p_j, 0)
    new_j, err_j = goj.optimize_spatial_over_steps(
        g_j.skeleton, p_j, _window_scs(cj, g_j.skeleton, p_j), params,
        n_iters=n_iters, quality_scale=1e-5)
    kernels.reset_launch_counts()
    new_t, err_t = got.optimize_spatial_over_steps(
        g_t.skeleton, p_t, _window_scs(ct, g_t.skeleton, p_t), params,
        n_iters=n_iters, quality_scale=1e-5, device="cpu")
    assert kernels.launch_counts()["gmm_scores"] == 0
    tol = 5e-3 if n_iters == 1 else 3e-2
    np.testing.assert_allclose(err_t, err_j, rtol=tol)
    for a, b, p, pr in zip(new_j, new_t, params, p_t):
        np.testing.assert_allclose(b, a, atol=tol)
        np.testing.assert_array_equal(b[pr.n_spatial:], p[pr.n_spatial:])
    assert max(float(np.abs(b - p).max())
               for b, p in zip(new_t, params)) > 0.1


@pytest.mark.parametrize("start_frames", [0.0, 60.0])
def test_optimize_time_over_steps_matches_jax(graphs, start_frames):
    """The time LM on tests/test_global_opt.py's two inputs: step 1's
    middle keyframe at 2.8 s over the two-step window, and one step after
    60 warped frames of earlier steps with its keyframe at 3.0 s; the
    spatial latents are untouched and the keyframe time moves toward its
    target."""
    g_j, g_t = graphs
    p_j, p_t = _prims(graphs)
    if start_frames:
        p_j, p_t = p_j[1:], p_t[1:]
        params = [np.asarray(prj.sample_latent(jax.random.PRNGKey(3),
                                               p_j[0], 1)[0])]
        constrained = [(0, p_j[0].n_canonical_frames // 2, 3.0)]
    else:
        params = _params(p_j, 1)
        constrained = [(1, p_j[1].n_canonical_frames // 2, 2.8)]
    ft = 1.0 / 30
    new_j = goj.optimize_time_over_steps(p_j, params, constrained, ft,
                                         n_iters=40, quality_scale=1e-6,
                                         start_frames=start_frames)
    new_t = got.optimize_time_over_steps(p_t, params, constrained, ft,
                                         n_iters=40, quality_scale=1e-6,
                                         start_frames=start_frames,
                                         device="cpu")
    for a, b, p, pr in zip(new_j, new_t, params, p_t):
        np.testing.assert_allclose(b, a, atol=1e-2)
        np.testing.assert_array_equal(b[: pr.n_spatial], p[: pr.n_spatial])

    def kf_time(parameters):
        step, kf, _ = constrained[0]
        t = [twj.canonical_time_function(pr.mean_t_d, pr.eigen_t_d,
                                         jnp.asarray(p[pr.n_spatial:]))
             for p, pr in zip(parameters, p_j)]
        prior = sum(float(x[-2]) + 2.0 for x in t[:step])
        return (start_frames + prior + float(t[step][kf])) * ft

    want = constrained[0][2]
    assert abs(kf_time(new_t) - want) < abs(kf_time(params) - want)


def test_window_nll_launches_per_step_when_mixtures_differ(graphs):
    """Mixtures of one shape stack into one B5 call (mix_id = arange(W));
    a window whose mixtures differ in their component count calls B5 once
    per step, with the same values."""
    _, g_t = graphs
    p_t = _prims(graphs)[1]
    other = prt.load_primitive_json(synj.make_legacy_model_json(
        seed=9, n_components=2))
    rows = [torch.cat([torch.zeros(pr.n_spatial), torch.zeros(pr.n_time)])
            + 0.3 for pr in p_t]
    stacked = got._WindowNll(p_t)
    assert stacked.stacked
    mixed = got._WindowNll([p_t[0], other])
    assert not mixed.stacked
    want = torch.stack([
        kernels.gmm_nll_and_grad_ref(r[None], pr.gmm.weights[None],
                                     pr.gmm.means[None],
                                     pr.gmm.prec_chol[None],
                                     torch.zeros(1, dtype=torch.long))[0][0]
        for r, pr in zip(rows, [p_t[0], other])])
    torch.testing.assert_close(mixed(rows), want)
    torch.testing.assert_close(stacked(rows)[0], want[0])


@pytest.mark.parametrize("fn", ["spatial", "time"])
def test_global_opt_defaults_to_the_card(graphs, fn):
    """Both optimizations run on the CUDA device unless given
    device="cpu"; without a card the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, g_t = graphs
    p_t = _prims(graphs)[1]
    params = [np.zeros(p.n_latent, np.float32) for p in p_t]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if fn == "spatial":
            got.optimize_spatial_over_steps(
                g_t.skeleton, p_t, _window_scs(ct, g_t.skeleton, p_t),
                params)
        else:
            got.optimize_time_over_steps(p_t, params, [(0, 3, 1.0)], 0.03)


# a timed keyframe request on the reference-scale model (the end keyframe
# at 2.5 s, 30 samples, 8 LM iterations, 4 steps, global spatial mode
# "all" from any error), for the probe below
TIMED_REQUEST = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{
        "action": "walk",
        "constraints": [{"joint": "Hips", "keyframeConstraints": [{
            "position": [10.0, None, 35.0], "time": 2.5,
            "semanticAnnotation": {"end": True}}]}],
    }],
}


def spatial_moves(weights, seeds):
    """The largest move of a latent by the global spatial optimization of
    TIMED_REQUEST on the reference-scale model, in the JAX package and in
    the port on the CPU (on JAX's draws), at each position and orientation
    weight; the post-process is skipped.
    -> {(weight, seed): (JAX's move, the port's move)}."""
    from morphablegraphs_tpu.synthesis import motion_generator as mgj
    from morphablegraphs_tpu.synthesis import postprocess as ppj
    from morphablegraphs_tpu.utils.config import default_config
    from morphablegraphs_tpu_torch.synthesis import motion_generator as mgt
    from morphablegraphs_tpu_torch.synthesis import postprocess as ppt
    g_j, g_t = tp.request_graphs(synj.make_reference_scale_graph_dict(),
                                 synj.REF_BVH)
    out = {}
    for w in weights:
        cfg = default_config()
        cfg.update(n_random_samples=30, lm_iterations=8, debug_max_step=3,
                   global_spatial_optimization_mode="all")
        cfg["global_spatial_optimization_settings"] = dict(
            cfg["global_spatial_optimization_settings"],
            start_error_threshold=0.0, position_weight=w,
            orientation_weight=w)
        for seed in seeds:
            moves = []
            for opt_mod, pp_mod, make in (
                    (goj, ppj, lambda: mgj.MotionGenerator(g_j, cfg,
                                                           seed=seed)),
                    (got, ppt, lambda: mgt.MotionGenerator(
                        g_t, cfg, seed=seed, device="cpu",
                        sampler=tp.jax_key_sampler(g_j, seed)))):
                calls = []
                orig_opt, orig_pp = (opt_mod.optimize_spatial_over_steps,
                                     pp_mod.post_process_motion)

                def spy(*a, _o=orig_opt, **kw):
                    calls.append((a[3], _o(*a, **kw)[0]))
                    return calls[-1][1], 0.0
                opt_mod.optimize_spatial_over_steps = spy
                pp_mod.post_process_motion = lambda *a, **kw: a[1]
                try:
                    make().generate_motion(TIMED_REQUEST)
                finally:
                    opt_mod.optimize_spatial_over_steps = orig_opt
                    pp_mod.post_process_motion = orig_pp
                moves.append(max(float(np.abs(np.asarray(n) - o).max())
                                 for old, new in calls
                                 for n, o in zip(new, old)))
            out[(w, seed)] = tuple(moves)
    return out


if __name__ == "__main__":
    # JAX_PLATFORMS=cpu python tests/test_torch_global_opt.py [WEIGHT...]
    import sys
    jax.config.update("jax_platforms", "cpu")
    for (w, seed), (mj, mt) in spatial_moves(
            [float(a) for a in sys.argv[1:]] or [1000.0, 10.0, 1.0],
            [1, 2, 3]).items():
        print(f"position weight {w:g}, seed {seed}: the spatial LM moved a "
              f"latent by up to {mj:.4f} in JAX, {mt:.4f} in the port",
              flush=True)
