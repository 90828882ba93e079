"""Parity of the rest of the port's ops/ with the JAX package on the same
seeded inputs: the quaternion conversions (matrix, axis-angle, the six
Euler orders), the sequential sign fix and frame arithmetic, the B-spline
least-squares fit, the GMM score and single draw, the z transform of a
time warp and the rigid transform of a path spline.

Tolerances: float32 conversions and compositions to atol 1e-5 (inputs of
unit size); Euler angles to atol 1e-3 degrees on angles away from the
gimbal (|middle angle| < 80 degrees); the QR fit to rtol 1e-4 of the
coefficients' scale; the GMM score to rtol 1e-5; spline points and arc
tables to atol 1e-4 cm on paths of ~100 cm."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import bspline as bsj  # noqa: E402
from morphablegraphs_tpu.ops import gmm as gmj  # noqa: E402
from morphablegraphs_tpu.ops import quat as qj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.ops import timewarp as twj  # noqa: E402
from morphablegraphs_tpu_torch.ops import bspline as bst  # noqa: E402
from morphablegraphs_tpu_torch.ops import gmm as gmt  # noqa: E402
from morphablegraphs_tpu_torch.ops import quat as qt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.ops import timewarp as twt  # noqa: E402

ORDERS = ("rxyz", "rxzy", "ryxz", "ryzx", "rzxy", "rzyx")
JAX_ORDERS = ("rxyz", "ryxz", "rzxy", "rzyx")  # the JAX package's four


def _quats(n, seed):
    q = np.random.default_rng(seed).standard_normal((n, 4)).astype(
        np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _t(a):
    return torch.as_tensor(np.array(a, np.float32))


def test_matrix_and_axis_angle_match_jax():
    q = _quats(64, 0)
    m_j = np.asarray(qj.to_matrix(jnp.asarray(q)))
    m_t = qt.to_matrix(_t(q)).numpy()
    np.testing.assert_allclose(m_t, m_j, atol=1e-5)
    np.testing.assert_allclose(qt.from_matrix(_t(m_j)).numpy(),
                               np.asarray(qj.from_matrix(jnp.asarray(m_j))),
                               atol=1e-5)
    rng = np.random.default_rng(1)
    axis = rng.standard_normal((16, 3)).astype(np.float32)
    angle = rng.uniform(-3, 3, 16).astype(np.float32)
    np.testing.assert_allclose(
        qt.from_axis_angle(_t(axis), _t(angle)).numpy(),
        np.asarray(qj.from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))),
        atol=1e-6)


@pytest.mark.parametrize("order", ORDERS)
def test_euler_orders_match_jax_and_scipy(order):
    """from_euler / to_euler in every rotating-frame order: against the
    JAX package where it has the order, against scipy's intrinsic
    convention always, and round trip."""
    rng = np.random.default_rng(2)
    ang = np.stack([rng.uniform(-170, 170, 64), rng.uniform(-80, 80, 64),
                    rng.uniform(-170, 170, 64)], -1).astype(np.float32)
    q_t = qt.from_euler(_t(ang), order)
    ref = np.roll(Rotation.from_euler(order[1:].upper(), ang,
                                      degrees=True).as_quat(), 1, axis=-1)
    d = np.abs(np.sum(q_t.numpy() * ref, axis=-1))
    assert np.all(d > 1 - 1e-6)
    np.testing.assert_allclose(qt.to_euler(q_t, order).numpy(), ang,
                               atol=1e-3)
    if order in JAX_ORDERS:
        q_j = np.asarray(qj.from_euler(jnp.asarray(ang), order))
        np.testing.assert_allclose(q_t.numpy(), q_j, atol=1e-6)
        np.testing.assert_allclose(
            qt.to_euler(_t(q_j), order).numpy(),
            np.asarray(qj.to_euler(jnp.asarray(q_j), order)), atol=1e-3)
    with pytest.raises(ValueError):
        qt.to_euler(q_t, "xyz")


@pytest.mark.parametrize("t", [1, 2, 17])
def test_fix_signs_sequential_matches_jax(t):
    q = _quats(t * 5, 3).reshape(t, 5, 4)
    q[1::2] *= -1.0
    out = qt.fix_signs_sequential(_t(q))
    assert out.shape == q.shape
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(qj.fix_signs_sequential(jnp.asarray(q))))


def test_add_subtract_frames_match_jax():
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.standard_normal((6, 3)),
                        _quats(6 * 3, 5).reshape(6, 12)], -1)
    b = np.concatenate([rng.standard_normal((6, 3)),
                        _quats(6 * 3, 6).reshape(6, 12)], -1)
    for f_t, f_j in ((qt.add_frames, qj.add_frames),
                     (qt.subtract_frames, qj.subtract_frames)):
        np.testing.assert_allclose(
            f_t(_t(a), _t(b)).numpy(),
            np.asarray(f_j(jnp.asarray(a, jnp.float32),
                           jnp.asarray(b, jnp.float32))), atol=1e-5)
    # subtract inverts add, each quaternion up to its sign
    back = qt.subtract_frames(qt.add_frames(_t(a), _t(b)), _t(a)).numpy()
    np.testing.assert_allclose(back[:, :3], b[:, :3], atol=1e-5)
    dots = np.abs(np.sum(back[:, 3:].reshape(6, 3, 4)
                         * b[:, 3:].reshape(6, 3, 4), axis=-1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-5)


@pytest.mark.parametrize("n_basis,n_frames", [(4, 5), (12, 40), (16, 130)])
def test_fit_coeffs_matches_jax(n_basis, n_frames):
    rng = np.random.default_rng(n_frames)
    knots = bst.clamped_knots(n_basis, n_frames)
    t = np.arange(n_frames, dtype=np.float32)
    y = rng.standard_normal((n_frames, 7)).astype(np.float32)
    c_j = np.asarray(bsj.fit_coeffs(jnp.asarray(y), jnp.asarray(
        knots, jnp.float32), jnp.asarray(t)))
    c_t = bst.fit_coeffs(_t(y), _t(knots), _t(t)).numpy()
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4,
                               atol=1e-4 * np.abs(c_j).max())
    np.testing.assert_array_equal(
        bst.basis_matrix_canonical(knots, n_frames),
        bsj.basis_matrix_canonical(knots, n_frames))


def test_gmm_score_and_sample_one():
    rng = np.random.default_rng(7)
    k, d = 3, 5
    a = rng.standard_normal((k, d, d)) * 0.3
    covars = a @ np.swapaxes(a, 1, 2) + np.eye(d) * 0.5
    w = np.array([0.2, 0.5, 0.3])
    mu = rng.standard_normal((k, d))
    x = rng.standard_normal((40, d)).astype(np.float32)
    g_t = gmt.from_covars(w, mu, covars)
    g_j = gmj.from_covars(w, mu, covars)
    np.testing.assert_allclose(float(gmt.score(g_t, _t(x))),
                               float(gmj.score(g_j, jnp.asarray(x))),
                               rtol=1e-5)
    one = gmt.sample_one(torch.Generator().manual_seed(3), g_t)
    many = gmt.sample(torch.Generator().manual_seed(3), g_t, 1)
    assert one.shape == (d,)
    np.testing.assert_array_equal(one.numpy(), many[0].numpy())


def test_z_transform_matches_jax():
    rng = np.random.default_rng(8)
    w = rng.normal(0.0, 0.2, (3, 30))
    tf = (np.cumsum(np.exp(w), axis=-1) - 1.0).astype(np.float32)
    z_t = twt.z_transform(_t(tf)).numpy()
    np.testing.assert_allclose(
        z_t, np.asarray(twj.z_transform(jnp.asarray(tf))), atol=1e-6)
    np.testing.assert_allclose(z_t, w, atol=1e-4)


def test_spline_transform_matches_jax():
    cp = np.array([[0, 0, 0], [20, 0, 30], [50, 0, 60], [80, 0, 100]],
                  np.float32)
    q = qt.about_y(torch.tensor(0.7)).numpy()
    delta = np.array([5.0, 0.0, -3.0], np.float32)
    sp_j = spj.transform(spj.build(jnp.asarray(cp), granularity=200),
                         jnp.asarray(q), jnp.asarray(delta))
    sp_t = spt.transform(spt.build(cp, granularity=200), _t(q), _t(delta))
    for f in ("points", "table_points", "table_arc"):
        np.testing.assert_allclose(getattr(sp_t, f).numpy(),
                                   np.asarray(getattr(sp_j, f)), atol=1e-4)
    np.testing.assert_allclose(float(sp_t.full_arc_length),
                               float(spt.build(cp, granularity=200)
                                     .full_arc_length), rtol=1e-5)
