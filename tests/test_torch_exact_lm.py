"""Parity of the port's exact LM with the JAX package: the dense-FK
residuals with a non-root keyframe, the exact and linearize-form jacobians
against jax.linearize, the closed end-effector form against the linearize
form, kernel B4's twin against the Pallas step kernel, kernel B2's register
Cholesky emulated on the CPU, and the serving
repair (BatchedGenerator runs the exact LM with JAX's serving flags)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.ops import gmm as gmmj  # noqa: E402
from morphablegraphs_tpu.ops import lm as lmj  # noqa: E402
from morphablegraphs_tpu.ops import pallas_kernels as pk  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.ops import lm as lmt  # noqa: E402
from morphablegraphs_tpu_torch.serve import batch as batch_mod  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402
from morphablegraphs_tpu_torch.utils import synthetic as synt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

N_CAND = 3
EE = {"toy": "Head", "ref": "RightHand"}


def _setup(scale: str):
    """Two characters with the walk's locomotion slots plus a keyframe on
    the end-effector joint in slot 2 (JAX and port forms), and N_CAND
    latents each."""
    skel_j, st_j, skel_t, st_t = tp.model(scale)
    joint = EE[scale]
    paths = tp.rand_paths(2, seed=6, granularity=256)
    nodes = [st_j.node_id(("walk", "leftStance")),
             st_j.node_id(("walk", "beginLeftStance"))]
    d = st_j.n_dim
    cases = [dict(travelled=20.0, goal=50.0,
                  prev=tp.prev_frame(d, 6.0, 18.0, seed=5), has_prev=1.0),
             dict(travelled=0.0, goal=30.0, prev=np.zeros(d, np.float32),
                  has_prev=0.0)]
    scs_j = []
    for n, p, c, tgt in zip(nodes, paths, cases,
                            ([20.0, 110.0, 80.0], [5.0, np.nan, 30.0])):
        sc = tp.loco_sc(skel_j, st_j, n, p, c["travelled"], c["goal"],
                        c["prev"], c["has_prev"])
        end = float(st_j.n_canonical[n]) - 1.0
        scs_j.append(cj.set_keyframe_constraint(
            sc, 2, skel_j, joint, 0.8 * end, position=np.asarray(tgt),
            weight=1.5))
    rng = np.random.default_rng(12)
    lat = (rng.standard_normal((2, N_CAND, st_j.gmm_means.shape[-1]))
           * 0.8).astype(np.float32)
    return dict(skel_j=skel_j, st_j=st_j, skel_t=skel_t, st_t=st_t,
                joint=joint, nodes=nodes, scs_j=scs_j,
                sc_t=tp.port_sc(scs_j), lat=lat)


@pytest.fixture(scope="module", params=["toy", "ref"])
def setup(request):
    return _setup(request.param)


def _jax_residual_fn(s, c, root_only):
    """JAX constrained_walk_full's exact-LM `residuals` for character c."""
    st_j, node, sc = s["st_j"], s["nodes"][c], s["scs_j"][c]
    gmm = cwj.node_gmm(st_j, node)
    act = cj.active_mask(sc) * jnp.asarray(cj.static_family_gate(
        use_traj=True, use_ca=False, use_ts=False))

    def residuals(sv):
        r = cwj.stacked_residuals(s["skel_j"], st_j, node, sc, sv, True,
                                  False, root_only=root_only)
        return act * (r + 0.1 * (-gmmj.log_prob(gmm, sv)))

    return residuals


def test_dense_residuals_nonroot_keyframe(setup):
    """The dense-FK residuals (root_only=False) with an end-effector
    keyframe in slot 2, and the exact error, against JAX's stacked
    residuals (rtol 1e-5; atol 1e-3 on residuals up to ~1e3 cm, the
    end-effector distance through ~6 unnormalized rotations)."""
    s = setup
    nodes = torch.as_tensor(s["nodes"])
    for i in range(N_CAND):
        sv = torch.as_tensor(s["lat"][:, i])
        coeffs = cwt._aligned_coeffs(s["st_t"], nodes, s["sc_t"], sv,
                                     root_only=False)
        res_t = ct.residuals_from_coeffs(
            s["skel_t"], s["st_t"].knots_s[nodes], s["sc_t"], coeffs,
            root_only=False).numpy()
        err_t = cwt.exact_error(s["skel_t"], s["st_t"], nodes, s["sc_t"], sv,
                                root_only=False).numpy()
        for c in range(2):
            res_j = np.asarray(cwj.stacked_residuals(
                s["skel_j"], s["st_j"], s["nodes"][c], s["scs_j"][c],
                jnp.asarray(s["lat"][c, i]), True, False, root_only=False))
            assert res_j[2] > 0.1  # the end-effector slot is live
            np.testing.assert_allclose(res_t[c], res_j, rtol=1e-5, atol=1e-3)
            np.testing.assert_allclose(
                err_t[c], float(cj.error_from_residuals(res_j)), rtol=1e-5)


@pytest.mark.parametrize("root_only", [True, False])
def test_exact_jacobian_matches_jax_linearize(setup, root_only, monkeypatch):
    """The exact LM's residuals and jacobian (`lm.linearize`: torch.func.jvp
    under vmap over the latent tangents) against jax.linearize of the JAX
    walk's residual function (rtol 1e-4, atol 1e-3 relative to each
    jacobian's largest entry: forward-mode derivatives through the
    alignment, FK and the advancing closest points, summed in other
    orders).  root_only=True drops the ee slot, as the walk's guard
    requires there.  The GMM term goes through `kernels.gmm_nll`: its
    wrapper is called once per linearize."""
    s = setup
    sc_t = s["sc_t"]
    scs_j = s["scs_j"]
    if root_only:
        sc_t = sc_t.replace(kf_active=sc_t.kf_active * torch.tensor(
            [1.0, 1, 0, 1, 1, 1, 1, 1]))
        scs_j = [sc.replace(kf_active=np.asarray(sc.kf_active) * np.array(
            [1.0, 1, 0, 1, 1, 1, 1, 1], np.float32)) for sc in scs_j]
    nodes = torch.as_tensor(s["nodes"])
    fn = cwt.lm_residual_fn(s["skel_t"], s["st_t"], nodes, sc_t, root_only)
    sv = torch.as_tensor(s["lat"][:, 0])
    calls = []
    real = kernels.gmm_nll_and_grad
    monkeypatch.setattr(kernels, "gmm_nll_and_grad",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    r_t, j_t = lmt.linearize(fn, sv)
    # the GMM term: one call of kernel B5's wrapper for the value and all
    # the jacobian columns
    assert calls == [sv.shape]
    assert j_t.shape == (2, ct.N_RESIDUALS, sv.shape[1])
    n_lat = sv.shape[1]
    for c in range(2):
        fn_j = _jax_residual_fn(dict(s, scs_j=scs_j), c, root_only)
        r_j, lin = jax.linearize(fn_j, jnp.asarray(s["lat"][c, 0]))
        j_j = np.asarray(jax.vmap(lin)(jnp.eye(n_lat))).T
        np.testing.assert_allclose(r_t[c].numpy(), np.asarray(r_j),
                                   rtol=1e-4, atol=1e-3)
        scale = max(float(np.abs(j_j).max()), 1.0)
        np.testing.assert_allclose(j_t[c].numpy() / scale, j_j / scale,
                                   rtol=1e-4, atol=1e-3)


def test_frozen_forms_with_ee_node(setup):
    """The frozen models with ee_node, as JAX's
    test_frozen_ee_matches_exact_and_linearize: at the freeze point the
    linearize form equals the exact dense residuals (atol 2e-3, rtol 1e-4)
    and its forward-mode jacobian matches jax.linearize of the JAX form
    (rtol 1e-4, atol 1e-3 of the largest entry); the closed form's value,
    jacobian and probe match the linearize form
    (value/probe atol 1e-3, rtol 1e-4; jacobian rtol 1e-3, atol 2e-3 of its
    largest entry); and both match the JAX package's forms."""
    s = setup
    st_t, st_j = s["st_t"], s["st_j"]
    nodes = torch.as_tensor(s["nodes"])
    ee = s["skel_t"].index_of(s["joint"])
    args = (s["skel_t"], st_t.knots_s[nodes], s["sc_t"], st_t.eigen_s[nodes],
            st_t.mean_s[nodes], st_t.n_basis_max, st_t.n_dim, st_t.k_s_max)
    make_lin = ct.make_frozen_root_residuals(*args, ee_node=ee)
    make_cl = ct.make_frozen_root_residuals_closed(*args, ee_node=ee)
    sv = torch.as_tensor(s["lat"][:, 1])
    probe = sv + 0.25
    rfn = make_lin(sv)
    r_exact = ct.residuals_from_coeffs(
        s["skel_t"], st_t.knots_s[nodes], s["sc_t"],
        cwt._aligned_coeffs(st_t, nodes, s["sc_t"], sv, False),
        root_only=False)
    np.testing.assert_allclose(rfn(sv).numpy(), r_exact.numpy(), atol=2e-3,
                               rtol=1e-4)
    r_lin, j_lin = lmt.linearize(rfn, sv)
    r_cl, j_cl, vfn = make_cl(sv)
    k_s = st_t.k_s_max
    np.testing.assert_allclose(j_lin[..., k_s:].numpy(), 0.0, atol=1e-6)
    scale = max(float(j_lin.abs().max()), 1.0)
    np.testing.assert_allclose(r_cl.numpy(), r_lin.numpy(), atol=1e-3,
                               rtol=1e-4)
    np.testing.assert_allclose(j_cl.numpy() / scale,
                               j_lin[..., :k_s].numpy() / scale, atol=2e-3,
                               rtol=1e-3)
    np.testing.assert_allclose(vfn(probe).numpy(), rfn(probe).numpy(),
                               atol=1e-3, rtol=1e-4)
    for c in range(2):
        n = s["nodes"][c]
        args_j = (s["skel_j"], st_j.knots_s[n], s["scs_j"][c],
                  st_j.eigen_s[n], st_j.mean_s[n], st_j.n_basis_max,
                  st_j.n_dim, st_j.k_s_max)
        rfn_j = cj.make_frozen_root_residuals(
            *args_j, use_traj=True, use_ca=False, ee_node=ee)(
                jnp.asarray(sv[c].numpy()))
        r_cj, j_cj, vfn_j = cj.make_frozen_root_residuals_closed(
            *args_j, use_traj=True, use_ca=False, ee_node=ee)(
                jnp.asarray(sv[c].numpy()))
        np.testing.assert_allclose(rfn(probe)[c].numpy(),
                                   np.asarray(rfn_j(jnp.asarray(
                                       probe[c].numpy()))),
                                   atol=1e-3, rtol=1e-4)
        _, lin_j = jax.linearize(rfn_j, jnp.asarray(sv[c].numpy()))
        j_lj = np.asarray(jax.vmap(lin_j)(jnp.eye(sv.shape[1]))).T
        np.testing.assert_allclose(j_lin[c].numpy() / scale, j_lj / scale,
                                   atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(r_cl[c].numpy(), np.asarray(r_cj),
                                   atol=1e-3, rtol=1e-4)
        np.testing.assert_allclose(j_cl[c].numpy() / scale,
                                   np.asarray(j_cj) / scale, atol=2e-3,
                                   rtol=1e-3)


@pytest.mark.parametrize("c,n_res,k", [(300, 25, 14), (64, 12, 7)])
def test_lm_delta_twin_matches_pallas_kernel(c, n_res, k):
    """B4's twin against the Pallas step kernel in interpret mode at the
    JAX package's reduced shapes (its full-size interpret compile crashes
    XLA-CPU in long suites), with lambda over 1e-3..10 and radii over
    0.1..4: scaled by the largest |delta|, atol 2e-5 and rtol 2e-3, the
    JAX test's bounds.  Zero characters give 0; no kernel launches."""
    rng = np.random.default_rng(c)
    j = rng.standard_normal((c, n_res, k)).astype(np.float32)
    r = rng.standard_normal((c, n_res)).astype(np.float32)
    lam = (10.0 ** rng.uniform(-3, 1, c)).astype(np.float32)
    rad = rng.uniform(0.1, 4.0, c).astype(np.float32)
    j[-3:] = 0.0
    r[-3:] = 0.0
    d_t = kernels.lm_delta(*(torch.as_tensor(x) for x in (j, r, lam, rad)))
    assert kernels.launch_counts()["lm_delta"] == 0
    d_j = np.asarray(pk.lm_delta_crowd(*(jnp.asarray(x)
                                         for x in (j, r, lam, rad)),
                                       interpret=True))
    scale = max(float(np.abs(d_j).max()), 1e-9)
    np.testing.assert_allclose(d_t.numpy() / scale, d_j / scale, atol=2e-5,
                               rtol=2e-3)
    assert np.all(d_t[-3:].numpy() == 0.0)


def test_lm_delta_twin_full_size():
    """At the main path's [1024, 49, 28], B4's twin and the fused route of
    lm.lm_delta against jax.vmap(lm._lm_delta_unbatched) (atol 2e-4, rtol
    2e-3: the crowd-solve bounds); the B2 route gives the same step."""
    rng = np.random.default_rng(31)
    j = rng.standard_normal((1024, 49, 28)).astype(np.float32)
    r = rng.standard_normal((1024, 49)).astype(np.float32)
    lam = (10.0 ** rng.uniform(-3, 1, 1024)).astype(np.float32)
    rad = rng.uniform(0.1, 4.0, 1024).astype(np.float32)
    args = [torch.as_tensor(x) for x in (j, r, lam, rad)]
    d_j = np.asarray(jax.vmap(lmj._lm_delta_unbatched)(
        *(jnp.asarray(x) for x in (j, r, lam, rad))))
    for d in (kernels.lm_delta_ref(*args), lmt.lm_delta(*args, fused=True),
              lmt.lm_delta(*args, fused=False)):
        np.testing.assert_allclose(d.numpy(), d_j, atol=2e-4, rtol=2e-3)


def _rows_chol_solve(a, g, width):
    """Kernel B2's register routine in numpy float32, in its order of
    operations: systems padded to `width` with a unit diagonal and a zero
    right-hand side; right-looking, each column scaled by one reciprocal
    square root of the floored pivot; row j takes over column j of L as it
    is broadcast (the mirrored entries); the forward substitution rides
    along as a column sweep and the back substitution is a column sweep
    over the mirrored entries.  a [C, k, k], g [C, k] -> x [C, k]."""
    f = np.float32
    c, k = g.shape
    m = np.tile(np.eye(width, dtype=f), (c, 1, 1))
    m[:, :k, :k] = a
    acc = np.zeros((c, width), f)
    acc[:, :k] = g
    dinv = np.ones((c, width), f)
    lane = np.arange(width)
    for j in range(width):
        rinv = (f(1) / np.sqrt(np.maximum(m[:, j, j], f(1e-12)))).astype(f)
        dinv[:, j] = rinv
        lij = m[:, :, j] * rinv[:, None]
        nl = np.where(lane > j, -lij, f(0))
        yj = acc[:, j] * dinv[:, j]
        acc = np.where(lane == j, yj[:, None], nl * yj[:, None] + acc)
        m[:, j + 1:, j] = lij[:, j + 1:]
        for p in range(j + 1, width):
            lpj = lij[:, p, None]
            m[:, :, p] = np.where(lane == j, lpj, nl * lpj + m[:, :, p])
    x = np.zeros((c, width), f)
    for p in reversed(range(width)):
        xp = acc[:, p] * dinv[:, p]
        x[:, p] = xp
        acc = np.where(lane < p, acc - m[:, :, p] * xp[:, None], acc)
    return x[:, :k]


@pytest.mark.parametrize("k,width", [(5, 28), (28, 28), (28, 32), (32, 32)])
def test_rows_cholesky_emulation_matches_twin_and_jax(k, width):
    """The right-looking, reciprocal-pivot Cholesky with column-sweep
    substitutions that kernel B2 runs in registers, emulated in numpy
    float32 at both instance widths and with padding, against the port's
    `chol_solve_unrolled` and the JAX `chol_solve` on damped normal
    matrices (atol 2e-4, rtol 2e-3: the crowd-solve bounds); zero systems
    give exactly 0."""
    rng = np.random.default_rng(100 * k + width)
    j = rng.standard_normal((64, k + 12, k)).astype(np.float32)
    a = np.einsum("crk,crl->ckl", j, j) + 0.1 * np.eye(k, dtype=np.float32)
    g = rng.standard_normal((64, k)).astype(np.float32)
    a[-3:] = 0.0
    g[-3:] = 0.0
    x = _rows_chol_solve(a, g, width)
    x_t = kernels.chol_solve_unrolled(torch.as_tensor(a), torch.as_tensor(g))
    x_j = np.asarray(jax.vmap(lmj.chol_solve)(jnp.asarray(a), jnp.asarray(g)))
    np.testing.assert_allclose(x, x_t.numpy(), atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(x, x_j, atol=2e-4, rtol=2e-3)
    assert np.all(x[-3:] == 0.0)


def _lane_rows_lm_delta(j, r, lam, rad, width):
    """Kernel B4's register route in numpy float32: lane i builds row i of
    JtJ and entry i of Jt r one residual row at a time (a[p] += J[r][i] *
    J[r][p] over the row padded to `width` with zeros), damps its own
    diagonal with the relative floor, pads lanes past k with a unit
    diagonal, solves with the register Cholesky and clips the step."""
    f = np.float32
    c, n_res, k = j.shape
    jp = np.zeros((c, n_res, width), f)
    jp[:, :, :k] = j
    a = np.zeros((c, width, width), f)
    g = np.zeros((c, width), f)
    for rr in range(n_res):
        ji = jp[:, rr, :, None]  # the lane's own column entry
        a = (ji * jp[:, rr, None, :] + a).astype(f)
        g = (jp[:, rr] * r[:, rr, None] + g).astype(f)
    dg = np.einsum("cii->ci", a).copy()
    floor = np.maximum(f(kernels.DAMP_FLOOR_REL) * dg[:, :k].max(1), f(1e-6))
    damped = (dg + lam[:, None] * np.maximum(dg, floor[:, None])).astype(f)
    idx = np.arange(width)
    a[:, idx, idx] = np.where(idx < k, damped, f(1))
    x = _rows_chol_solve(a[:, :k, :k], g[:, :k], width)
    nrm = np.sqrt(np.maximum((x * x).sum(1, dtype=f), f(1e-20)))
    scale = np.minimum(f(1), rad / np.maximum(nrm, f(1e-10)))
    return (x * scale[:, None]).astype(f)


@pytest.mark.parametrize("n_res,k,width", [(49, 28, 28), (25, 14, 28),
                                           (30, 32, 32), (12, 29, 32)])
def test_lane_rows_jtj_emulation_matches_twin(n_res, k, width):
    """The lane-per-row JtJ of kernel B4 (full rows, summed one residual
    row at a time, the normal matrix never leaving the lanes), emulated in
    numpy float32 at both instance widths and with padded columns, against
    `lm_delta_ref` (atol 2e-4, rtol 2e-3: B4's bounds on the card); zero
    characters give exactly 0."""
    rng = np.random.default_rng(1000 * k + n_res)
    c = 64
    j = rng.standard_normal((c, n_res, k)).astype(np.float32)
    r = rng.standard_normal((c, n_res)).astype(np.float32)
    lam = (10.0 ** rng.uniform(-3, 1, c)).astype(np.float32)
    rad = rng.uniform(0.1, 4.0, c).astype(np.float32)
    j[-3:] = 0.0
    r[-3:] = 0.0
    d = _lane_rows_lm_delta(j, r, lam, rad, width)
    d_t = kernels.lm_delta_ref(*(torch.as_tensor(x) for x in (j, r, lam,
                                                              rad)))
    np.testing.assert_allclose(d, d_t.numpy(), atol=2e-4, rtol=2e-3)
    assert np.all(d[-3:] == 0.0)


def test_lm_minimize_modes_match_jax():
    """lm_minimize's exact (residual_fn) and make_residual_fn modes, with
    the B2 and B4 step routes, against the JAX lm_minimize on a small
    nonlinear crowd problem (atol 1e-5, rtol 1e-4); exactly one residual
    form is accepted."""
    rng = np.random.default_rng(4)
    tgt = rng.random((6, 5)).astype(np.float32)
    s0 = np.ones((6, 5), np.float32)
    t_tgt = torch.as_tensor(tgt)

    def fn_t(x):
        return torch.cat([x * x - t_tgt, 0.1 * torch.sin(x)], dim=1)

    ref = np.stack([np.asarray(lmj.lm_minimize(
        lambda x, t=jnp.asarray(t): jnp.concatenate(
            [x * x - t, 0.1 * jnp.sin(x)]), jnp.asarray(s), 4)[0])
        for t, s in zip(tgt, s0)])
    for kw in (dict(), dict(fused_step=True)):
        out = lmt.lm_minimize(fn_t, torch.as_tensor(s0), 4, **kw)[0]
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)
        out = lmt.lm_minimize(None, torch.as_tensor(s0), 4,
                              make_residual_fn=lambda s: fn_t, **kw)[0]
        np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-4)
    with pytest.raises(ValueError, match="exactly one"):
        lmt.lm_minimize(fn_t, torch.as_tensor(s0), 1,
                        make_residual_fn=lambda s: fn_t)


# ---------------------------------------------------------------------------
# The serving repair: BatchedGenerator runs the exact LM with JAX's flags
# ---------------------------------------------------------------------------

N_CHARS, N_STEPS, MAX_FRAMES = 3, 3, 64


def _traj_request(end_x, end_z):
    return {
        "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
        "elementaryActions": [{
            "action": "walk",
            "constraints": [{"joint": "Hips", "trajectoryConstraints": [
                {"position": [0, None, 0]},
                {"position": [end_x / 2, None, end_z / 2]},
                {"position": [end_x, None, end_z]}]}],
        }],
    }


def test_serving_runs_the_exact_lm_as_jax(monkeypatch):
    """BatchedGenerator passes JAX's single-device serving flags (the B1
    selection with n_samples rounded up to 128, root_only derived from the
    constraint sets, lm_frozen=False), and the port's walk with those flags
    matches cwj.constrained_walk_full_crowd(pallas_selection=True,
    root_only=True, lm_frozen=False) on the same JAX draws: node ids and
    frame counts exactly; errors and frames to atol 1e-2, the whole-walk
    bounds of tests/test_torch_walk.py, plus rtol 1e-4 on errors (the
    exact jacobian agrees with jax.linearize to ~1e-6 relative, see the
    tests above, and each step carries the previous step's ~1e-3 frame
    difference).  The draws are those of PRNGKey(23): under them a
    half-ulp change of the GMM term moves the walk by under 0.2 of these
    bounds, whereas under some keys (21, 25) the third step's LM, damped at
    1e-5 on the toy model's singular JtJ, amplifies the same change to 1.4-10
    times the bounds, so that agreement with another fp32 order of
    operations there would be chance."""
    graph = gt.build_graph_from_dict(synt.make_graph_dict())
    graph.skeleton, _ = skt.load_bvh(synt.TEST_BVH)
    bg = batch_mod.BatchedGenerator(graph, n_steps=N_STEPS, n_samples=40,
                                    max_step_frames=MAX_FRAMES, lm_iters=3,
                                    device="cpu")
    cfg = bg.walk_config()
    assert cfg.n_samples == 128 and not cfg.lm_frozen
    assert cfg.pallas_ee is None and not cfg.lm_fused_step
    seen = {}
    real = cwt.constrained_walk_full_crowd

    def spy(skel, g, paths, start, n_steps, draws, step_scs=None, cfg=None):
        seen.update(cfg=cfg, root_only=ct.step_scs_root_only(step_scs))
        return real(skel, g, paths, start, n_steps, draws, step_scs, cfg)

    monkeypatch.setattr(batch_mod.cw, "constrained_walk_full_crowd", spy)
    outs = bg.generate_batch([_traj_request(20, 100)])
    assert seen["cfg"] == cfg and seen["root_only"] is True
    assert outs[0].shape[0] > 30 and np.all(np.isfinite(outs[0]))

    skel_j, st_j, skel_t, st_t = tp.model("toy")
    paths_j = tp.stack_jax_paths(tp.rand_paths(N_CHARS, seed=2,
                                               seg_len=90.0))
    start = st_j.node_id(("walk", "beginLeftStance"))
    key = jax.random.PRNGKey(23)
    draws = tp.jax_walk_draws(key, N_CHARS, N_STEPS, cfg.n_samples,
                              st_j.gmm_weights.shape[-1],
                              st_j.gmm_means.shape[-1], st_j.n_nodes)
    segs, nf, ids, errs = (np.asarray(a) for a in
                           cwj.constrained_walk_full_crowd(
        skel_j, key, st_j, paths_j, start, n_chars=N_CHARS, n_steps=N_STEPS,
        max_step_frames=MAX_FRAMES, n_samples=cfg.n_samples,
        lm_iters=cfg.lm_iters, pallas_selection=True, root_only=True,
        lm_frozen=False))
    assert np.all(ids >= 0)
    out = real(skel_t, st_t, tp.port_paths(paths_j),
               torch.full((N_CHARS,), start), N_STEPS,
               draws=tp.port_draws(draws), cfg=cfg)
    t_segs, t_nf, t_ids, t_errs = (a.numpy() for a in out)
    np.testing.assert_array_equal(t_ids, ids)
    np.testing.assert_array_equal(t_nf, nf)
    np.testing.assert_allclose(t_errs, errs, rtol=1e-4, atol=1e-2)
    np.testing.assert_allclose(t_segs, segs, atol=1e-2)
