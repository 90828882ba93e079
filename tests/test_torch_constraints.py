"""Parity of the port's root-only constraint residuals and the closed-form
frozen LM model with the JAX package."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

N_CAND = 6


def _setup(scale: str):
    """Two characters on different nodes, paths and previous frames, and
    N_CAND latents each (JAX and port forms of the same inputs)."""
    skel_j, st_j, skel_t, st_t = tp.model(scale)
    paths = tp.rand_paths(2, seed=4, granularity=256)
    nodes = [st_j.node_id(("walk", "beginLeftStance")),
             st_j.node_id(("walk", "leftStance"))]
    d = st_j.n_dim
    cases = [dict(travelled=0.0, goal=30.0, prev=np.zeros(d, np.float32),
                  has_prev=0.0),
             dict(travelled=25.0, goal=55.0,
                  prev=tp.prev_frame(d, 8.0, 24.0, seed=2), has_prev=1.0)]
    scs_j = [tp.loco_sc(skel_j, st_j, n, p, c["travelled"], c["goal"],
                        c["prev"], c["has_prev"])
             for n, p, c in zip(nodes, paths, cases)]
    rng = np.random.default_rng(11)
    lat = (rng.standard_normal((2, N_CAND, st_j.gmm_means.shape[-1]))
           * 0.8).astype(np.float32)
    return dict(skel_j=skel_j, st_j=st_j, skel_t=skel_t, st_t=st_t,
                nodes=nodes, scs_j=scs_j, sc_t=tp.port_sc(scs_j), lat=lat)


@pytest.fixture(scope="module", params=["toy", "ref"])
def setup(request):
    return _setup(request.param)


def _jax_residuals(s, c, sv):
    return np.asarray(jax.vmap(lambda v: cwj.stacked_residuals(
        s["skel_j"], s["st_j"], s["nodes"][c], s["scs_j"][c], v, True,
        False, root_only=True))(jnp.asarray(sv)))


def test_residuals_from_coeffs_root_only(setup):
    """Exact residuals and error of every candidate (rtol 1e-5; atol 1e-4
    on ~10-100 cm residuals: the advancing closest point refines through
    different fp32 summation orders)."""
    s = setup
    nodes = torch.as_tensor(s["nodes"])
    for i in range(N_CAND):
        sv = torch.as_tensor(s["lat"][:, i])
        coeffs = cwt._aligned_coeffs(s["st_t"], nodes, s["sc_t"], sv)
        res_t = ct.residuals_from_coeffs(s["skel_t"], s["st_t"].knots_s[nodes],
                                         s["sc_t"], coeffs, use_ca=False,
                                         root_only=True).numpy()
        err_t = cwt.exact_error(s["skel_t"], s["st_t"], nodes, s["sc_t"],
                                sv).numpy()
        for c in range(2):
            res_j = _jax_residuals(s, c, s["lat"][c, i:i + 1])[0]
            assert res_t[c].shape == res_j.shape == (cj.N_RESIDUALS,)
            np.testing.assert_allclose(res_t[c], res_j, rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(
                err_t[c], float(cj.error_from_residuals(res_j)), rtol=1e-5)


def test_error_from_residuals_and_masks():
    rng = np.random.default_rng(0)
    res = np.abs(rng.standard_normal((5, cj.N_RESIDUALS))).astype(np.float32)
    res[1, cj._OFF_TRAJ:] = 0.0
    np.testing.assert_allclose(
        ct.error_from_residuals(torch.as_tensor(res)).numpy(),
        np.asarray(cj.error_from_residuals(jnp.asarray(res))), rtol=1e-6)
    for flags in [(True, False, False), (False, True, True)]:
        np.testing.assert_array_equal(ct.static_family_gate(*flags),
                                      cj.static_family_gate(*flags))


def test_frozen_closed_model(setup):
    """r, J and value_fn of the closed frozen model at the freeze point and
    at a probe point (rtol 1e-4 / atol 1e-3: J comes out of reverse-mode
    differentiation through the alignment, summed in other orders)."""
    s = setup
    st_j, st_t = s["st_j"], s["st_t"]
    nodes = torch.as_tensor(s["nodes"])
    make_t = ct.make_frozen_root_residuals_closed(
        s["skel_t"], st_t.knots_s[nodes], s["sc_t"], st_t.eigen_s[nodes],
        st_t.mean_s[nodes], st_t.n_basis_max, st_t.n_dim, st_t.k_s_max)
    s0 = torch.as_tensor(s["lat"][:, 0])
    probe = torch.as_tensor(s["lat"][:, 0] + 0.05 * s["lat"][:, 1])
    r_t, j_t, vfn_t = make_t(s0)
    v_t = vfn_t(probe)
    for c in range(2):
        n = s["nodes"][c]
        make_j = cj.make_frozen_root_residuals_closed(
            s["skel_j"], st_j.knots_s[n], s["scs_j"][c], st_j.eigen_s[n],
            st_j.mean_s[n], st_j.n_basis_max, st_j.n_dim, st_j.k_s_max,
            use_traj=True, use_ca=False)
        r_j, j_j, vfn_j = make_j(jnp.asarray(s0[c].numpy()))
        np.testing.assert_allclose(r_t[c].numpy(), np.asarray(r_j),
                                   rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(j_t[c].numpy(), np.asarray(j_j),
                                   rtol=1e-4, atol=1e-3)
        v_j = vfn_j(jnp.asarray(probe[c].numpy()))
        np.testing.assert_allclose(v_t[c].numpy(), np.asarray(v_j),
                                   rtol=1e-4, atol=1e-3)


def test_guards_match_jax():
    skel_j, _, skel_t, _ = tp.model("toy")
    scs_t = cwt.default_step_scs(skel_t, 3)
    scs_j = cwj.default_step_scs(skel_j, 3)
    assert ct.step_scs_locomotion_only(scs_t) == \
        cj.step_scs_locomotion_only(scs_j) is True
    assert ct.step_scs_root_only(scs_t) == cj.step_scs_root_only(scs_j)
    assert ct.frozen_closed_supported(skel_t) == \
        cj.frozen_closed_supported(skel_j)
    ca = np.array(scs_t.ca_active)
    ca[1, 0] = 1.0
    scs_t.ca_active = ca
    assert not ct.step_scs_locomotion_only(scs_t)
