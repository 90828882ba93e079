"""Parity of the port's ops (quat, bspline, gmm, timewarp, align,
spline_path) with the JAX package on the same numpy inputs.  Tolerance
rtol 1e-5 / atol 1e-5 unless a test states another and why."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.ops import bspline as bsj  # noqa: E402
from morphablegraphs_tpu.ops import gmm as gmj  # noqa: E402
from morphablegraphs_tpu.ops import quat as qj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.ops import timewarp as twj  # noqa: E402
from morphablegraphs_tpu_torch.ops import align as alt  # noqa: E402
from morphablegraphs_tpu_torch.ops import bspline as bst  # noqa: E402
from morphablegraphs_tpu_torch.ops import gmm as gmt  # noqa: E402
from morphablegraphs_tpu_torch.ops import quat as qt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.ops import timewarp as twt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

RTOL = ATOL = 1e-5


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=rtol, atol=atol)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rand_quats(rng, shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def test_quat_ops():
    rng = np.random.default_rng(0)
    a, b = _rand_quats(rng, (6, 5)), _rand_quats(rng, (6, 5))
    v = rng.standard_normal((6, 5, 3)).astype(np.float32)
    close(qt.normalize(_t(a * 3.0)), qj.normalize(jnp.asarray(a * 3.0)))
    close(qt.multiply(_t(a), _t(b)), qj.multiply(jnp.asarray(a),
                                                 jnp.asarray(b)))
    close(qt.rotate_vec(_t(a), _t(v)), qj.rotate_vec(jnp.asarray(a),
                                                    jnp.asarray(v)))
    ang = rng.uniform(-4, 4, 7).astype(np.float32)
    close(qt.about_y(_t(ang)), qj.about_y(jnp.asarray(ang)))
    close(qt.fix_signs(_t(a), _t(b)), qj.fix_signs(jnp.asarray(a),
                                                  jnp.asarray(b)))
    frames = rng.standard_normal((4, 3 + 4 * 5)).astype(np.float32)
    ref = rng.standard_normal(3 + 4 * 5).astype(np.float32)
    close(qt.frame_fix_signs(_t(frames), _t(ref)),
          qj.frame_fix_signs(jnp.asarray(frames), jnp.asarray(ref)))


@pytest.mark.parametrize("n_basis,n_frames", [(12, 40), (16, 130), (8, 9)])
def test_clamped_knots_bit_identical(n_basis, n_frames):
    np.testing.assert_array_equal(bst.clamped_knots(n_basis, n_frames),
                                  bsj.clamped_knots(n_basis, n_frames))


def test_bspline_basis_and_evaluate():
    """Single and per-character (batched) knot vectors, queries outside the
    domain and at the end knot."""
    knots = bsj.clamped_knots(16, 130).astype(np.float32)
    t = np.concatenate([[-3.0, 0.0, 129.0, 140.0],
                        np.linspace(0, 129, 61)]).astype(np.float32)
    close(bst.basis_matrix(_t(knots), _t(t)),
          bsj.basis_matrix(jnp.asarray(knots), jnp.asarray(t)))
    coeffs = np.random.default_rng(1).standard_normal((16, 7)).astype(
        np.float32)
    close(bst.evaluate(_t(coeffs), _t(knots), _t(t)),
          bsj.evaluate(jnp.asarray(coeffs), jnp.asarray(knots),
                       jnp.asarray(t)), atol=1e-4)
    kb = np.stack([knots, bsj.clamped_knots(16, 90).astype(np.float32)])
    tb = np.stack([t, t * 0.5])
    out = bst.basis_matrix(_t(kb), _t(tb))
    for c in range(2):
        close(out[c], bsj.basis_matrix(jnp.asarray(kb[c]),
                                       jnp.asarray(tb[c])))
    np.testing.assert_allclose(bst.basis_matrix_np(knots, t),
                               bsj.basis_matrix_np(knots, t), rtol=0,
                               atol=0)


def _gmm(seed, k=4, d=6):
    rng = np.random.default_rng(seed)
    w = rng.random(k)
    w /= w.sum()
    means = rng.standard_normal((k, d))
    covs = []
    for _ in range(k):
        a = rng.standard_normal((d, d)) * 0.3
        covs.append(a @ a.T + 0.4 * np.eye(d))
    return w, means, np.stack(covs)


def test_gmm_log_prob_and_gradient():
    """log_prob_components / log_prob, and the closed-form gradient of
    -log p against jax.grad (rtol 1e-4: log-densities of ~-10 summed
    through a logsumexp)."""
    w, means, covs = _gmm(2)
    gj = gmj.from_covars(w, means, covs)
    gt = gmt.from_covars(w, means, covs)
    x = np.random.default_rng(3).standard_normal((9, 6)).astype(np.float32)
    close(gmt.log_prob_components(gt, _t(x)),
          gmj.log_prob_components(gj, jnp.asarray(x)), rtol=1e-4, atol=1e-4)
    close(gmt.log_prob(gt, _t(x)), gmj.log_prob(gj, jnp.asarray(x)),
          rtol=1e-4, atol=1e-4)
    nll, grad = gmt.neg_log_prob_and_grad(gt, _t(x))
    ref_grad = jax.vmap(jax.grad(lambda v: -gmj.log_prob(gj, v)))(
        jnp.asarray(x))
    close(nll, -gmj.log_prob(gj, jnp.asarray(x)), rtol=1e-4, atol=1e-4)
    close(grad, ref_grad, rtol=1e-4, atol=1e-4)


def test_gmm_batched_mixtures():
    """One mixture per character (the walk gathers a node's GMM per
    character), including zero-weight padded components."""
    mix = [_gmm(s) for s in (4, 5)]
    w = np.stack([m[0] for m in mix])
    w[1, -1] = 0.0
    gt = gmt.from_covars(w[0], mix[0][1], mix[0][2])
    gt2 = gmt.from_covars(w[1], mix[1][1], mix[1][2])
    stacked = gmt.GMM(*(torch.stack([a, b]) for a, b in zip(
        (gt.weights, gt.means, gt.cov_chol, gt.prec_chol),
        (gt2.weights, gt2.means, gt2.cov_chol, gt2.prec_chol))))
    x = np.random.default_rng(6).standard_normal((2, 6)).astype(np.float32)
    out = gmt.log_prob(stacked, _t(x))
    for c, (wc, mu, cv) in enumerate(zip(w, (m[1] for m in mix),
                                         (m[2] for m in mix))):
        ref = gmj.log_prob(gmj.from_covars(wc, mu, cv), jnp.asarray(x[c]))
        close(out[c], ref, rtol=1e-4, atol=1e-4)


def test_timewarp():
    rng = np.random.default_rng(7)
    f_max, k_t = 60, 3
    mean = (rng.standard_normal((2, f_max)) * 0.05).astype(np.float32)
    eig = (rng.standard_normal((2, f_max, k_t)) * 0.05).astype(np.float32)
    gamma = rng.standard_normal((2, k_t)).astype(np.float32)
    n_can = np.array([52, 60], np.int32)
    t_can_t = twt.canonical_time_function_masked(_t(mean), _t(eig),
                                                 _t(gamma), _t(n_can))
    t_fn_t, nf_t = twt.invert_time_function_dynamic(t_can_t, _t(n_can), 96)
    for c in range(2):
        t_can_j = twj.canonical_time_function_masked(
            jnp.asarray(mean[c]), jnp.asarray(eig[c]), jnp.asarray(gamma[c]),
            jnp.asarray(n_can[c]))
        close(t_can_t[c], t_can_j, atol=1e-4)
        t_fn_j, nf_j = twj.invert_time_function_dynamic(
            t_can_j, jnp.asarray(n_can[c]), 96)
        close(t_fn_t[c], t_fn_j, atol=1e-4)
        assert int(nf_t[c]) == int(nf_j)
    x = np.cumsum(rng.random(20) + 0.1).astype(np.float32)
    y = np.arange(20, dtype=np.float32)
    xq = np.linspace(x[0] - 1, x[-1] + 1, 50).astype(np.float32)
    close(twt.interp_cubic(_t(xq), _t(x), _t(y)),
          twj.interp_cubic(jnp.asarray(xq), jnp.asarray(x), jnp.asarray(y)))


def test_align():
    d = 3 + 4 * 4
    prev = np.stack([tp.prev_frame(d, 3.0, 7.0, seed=1),
                     tp.prev_frame(d, -5.0, 2.0, seed=2)])
    frames = np.stack([np.stack([tp.prev_frame(d, i, 2 * i, seed=10 + i)
                                 for i in range(30)]) for _ in range(2)])
    frames[1, :, 3:] *= -1.0  # flipped hemisphere: the smoothing fixes signs
    close(alt.heading_angle(_t(prev[:, 3:7])),
          alj.heading_angle(jnp.asarray(prev[:, 3:7])))
    q_t, d_t = alt.node_aligning_2d_transform(_t(prev), _t(frames[:, 0]))
    out_t = alt.transform_frames(_t(frames), q_t, d_t)
    sm_t = alt.smooth_transition(_t(prev), out_t, 20)
    for c in range(2):
        q_j, d_j = alj.node_aligning_2d_transform(jnp.asarray(prev[c]),
                                                  jnp.asarray(frames[c, 0]))
        close(q_t[c], q_j)
        close(d_t[c], d_j, atol=1e-4)
        out_j = alj.transform_frames(jnp.asarray(frames[c]), q_j, d_j)
        close(out_t[c], out_j, atol=1e-4)
        close(sm_t[c], alj.smooth_transition(jnp.asarray(prev[c]), out_j,
                                             20), atol=1e-4)
    close(alt.smoothing_factors(20, 30), alj.smoothing_factors(20, 30))
    assert alt.smooth_transition(_t(prev), out_t, 0) is out_t


@pytest.fixture(scope="module")
def paths():
    ps = tp.rand_paths(3, seed=9, granularity=1000, seg_len=80.0)
    return ps, tp.port_paths(tp.stack_jax_paths(ps))


def test_spline_build(paths):
    """The port's own build against the JAX build (atol 2e-3 on the arc
    table: a cumulative sum of 1000 fp32 segment lengths, ~200 cm)."""
    rng = np.random.default_rng(1)
    pts = np.cumsum(rng.uniform(-10, 30, (6, 3)), axis=0).astype(np.float32)
    sj = spj.build(pts, unconstrained_dims=(1,))
    st_ = spt.build(pts, unconstrained_dims=(1,))
    close(st_.points, sj.points)
    close(st_.table_u, sj.table_u)
    close(st_.table_points, sj.table_points, atol=1e-4)
    close(st_.table_arc, sj.table_arc, atol=2e-3)
    np.testing.assert_array_equal(st_.unconstrained.numpy(),
                                  np.asarray(sj.unconstrained))
    with pytest.raises(ValueError):
        spt.build(np.zeros((40, 3)))


def test_spline_queries(paths):
    """Arc-length queries, the travelled-arc closest point and the
    advancing closest points of the trajectory residuals (atol 1e-3 on cm
    positions: the tangent is a finite difference of two evaluations)."""
    ps, pt = paths
    arcs = np.array([5.0, 60.0, 500.0], np.float32)
    pos_t, dir_t = spt.point_and_dir_at_arc_length(pt, _t(arcs))
    query = np.array([[3.0, 1.0, 40.0], [-20.0, 0.0, 70.0],
                      [10.0, 5.0, 90.0]], np.float32)
    min_arc = np.array([0.0, 30.0, 80.0], np.float32)
    cp_t = spt.closest_point(pt, _t(query), _t(min_arc))
    rng = np.random.default_rng(2)
    traj = (np.cumsum(rng.uniform(0, 12, (3, 16, 3)), axis=1)
            * np.array([0.3, 0.0, 1.0])).astype(np.float32)
    adv_t = spt.closest_points_advancing(pt, _t(traj), _t(min_arc))
    for c in range(3):
        pos_j, dir_j = spj.point_and_dir_at_arc_length(ps[c],
                                                       jnp.asarray(arcs[c]))
        close(pos_t[c], pos_j, atol=1e-3)
        close(dir_t[c], dir_j, atol=1e-3)
        cp_j = spj.closest_point(ps[c], jnp.asarray(query[c]),
                                 jnp.asarray(min_arc[c]))
        # the ternary refinement compares nearly equal distances at a flat
        # minimum, so the located point and arc may move by ~1e-2 cm while
        # the distance agrees to 1e-3
        for a, b, tol in zip(cp_t, cp_j, (2e-2, 2e-2, 1e-3)):
            close(a[c], b, atol=tol)
        adv_j = spj.closest_points_advancing(ps[c], jnp.asarray(traj[c]),
                                             jnp.asarray(min_arc[c]))
        for a, b in zip(adv_t, adv_j):
            close(a[c], b, atol=1e-3)
