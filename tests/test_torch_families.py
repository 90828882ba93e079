"""Parity of the port's constraint families with the JAX package: each
family's residuals under the dense and the chain FK, the root form's
joint-rotation read, the single-primitive entry points, the host builders
and `from_jax_numpy`, the frozen LM forms with joint rotation and collision
avoidance, the exact LM's jacobian, and the stacked spline queries.

Residuals are held to atol 2e-3 + rtol 1e-4, the JAX package's own bound
between two evaluations of the same residuals in other fp32 orders
(tests/test_constrained_walk_full.py:329-330)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.models import graph as gj  # noqa: E402
from morphablegraphs_tpu.ops import gmm as gmmj  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.models import graph as gt  # noqa: E402
from morphablegraphs_tpu_torch.ops import lm as lmt  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import constrained_walk as cwt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

RTOL, ATOL = 1e-4, 2e-3
N_CAND = 3


def _setup(scale: str):
    """Two characters with the walk's locomotion slots (trajectory on
    their path) on different nodes, one starting the walk and one with a
    previous frame, and N_CAND latents each."""
    skel_j, st_j, skel_t, st_t = tp.model(scale)
    paths = tp.rand_paths(2, seed=8, granularity=256)
    nodes = [st_j.node_id(("walk", "leftStance")),
             st_j.node_id(("walk", "beginLeftStance"))]
    d = st_j.n_dim
    cases = [dict(travelled=20.0, goal=50.0,
                  prev=tp.prev_frame(d, 6.0, 18.0, seed=5), has_prev=1.0),
             dict(travelled=0.0, goal=30.0, prev=np.zeros(d, np.float32),
                  has_prev=0.0)]
    base = [tp.loco_sc(skel_j, st_j, n, p, c["travelled"], c["goal"],
                       c["prev"], c["has_prev"])
            for n, p, c in zip(nodes, paths, cases)]
    rng = np.random.default_rng(21)
    lat = (rng.standard_normal((2, N_CAND, st_j.gmm_means.shape[-1]))
           * 0.8).astype(np.float32)
    return dict(scale=scale, skel_j=skel_j, st_j=st_j, skel_t=skel_t,
                st_t=st_t, nodes=nodes, base=base, lat=lat,
                pose_frame=tp.prev_frame(d, 5.0, 10.0, seed=7))


@pytest.fixture(scope="module", params=["toy", "ref"])
def setup(request):
    return _setup(request.param)


def _family_sets(s, family):
    scs_j = [tp.add_family(cj, spj, sc, s["skel_j"], s["scale"], family,
                           s["pose_frame"]) for sc in s["base"]]
    return scs_j, tp.port_sc(scs_j)


@functools.lru_cache(maxsize=None)
def _jax_residuals(skel_j, chain_fk: bool, root_only: bool = False):
    return jax.jit(functools.partial(
        cj.residuals_from_coeffs, skel_j, use_traj=True, use_ca=True,
        use_ts=True, root_only=root_only, chain_fk=chain_fk))


@pytest.mark.parametrize("chain_fk", [False, True])
@pytest.mark.parametrize("family", tp.FAMILIES + ("all",))
def test_family_residuals_match_jax(setup, family, chain_fk):
    """Each family (and all of them at once) on both characters: JAX
    residuals_from_coeffs against the port's on the same aligned
    coefficients, under the dense FK pass and the ancestor-chain FK; the
    family's slots are live."""
    s = setup
    st_j, st_t = s["st_j"], s["st_t"]
    scs_j, sc_t = _family_sets(s, family)
    fn_j = _jax_residuals(s["skel_j"], chain_fk)
    nodes = torch.as_tensor(s["nodes"])
    for i in range(N_CAND):
        coeffs = np.stack([np.asarray(cwj.stacked_aligned_coeffs(
            st_j, s["nodes"][c], scs_j[c], jnp.asarray(s["lat"][c, i])))
            for c in range(2)])
        res_t = ct.residuals_from_coeffs(
            s["skel_t"], st_t.knots_s[nodes], sc_t, torch.as_tensor(coeffs),
            use_ts=True, chain_fk=chain_fk).numpy()
        for c in range(2):
            res_j = np.asarray(fn_j(st_j.knots_s[s["nodes"][c]], scs_j[c],
                                    jnp.asarray(coeffs[c])))
            np.testing.assert_allclose(res_t[c], res_j, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{family} character {c}")
    live = {"look_at": [cj._OFF_CA - 4], "rel_transform": [cj._OFF_CA - 3],
            "joint_rotation": [cj._OFF_CA - 2], "pose": [cj._OFF_CA - 1],
            "ca": [cj._OFF_CA, cj._OFF_CA + 1],
            "traj_set": [cj._OFF_TS]}  # later samples may run off
    for slot in live.get(family, []):
        assert np.all(res_t[:, slot] > 1e-3), (family, slot)


@pytest.mark.parametrize("jr_joint", ["root", "other"])
def test_root_form_joint_rotation(setup, jr_joint):
    """A joint-rotation slot in a root-only walk: the walk's root form
    (channels 0:7 and the slot's quaternion block) scores the joint's own
    channels, as JAX's root_only residuals read the whole frame row; the
    residuals agree with JAX's root_only ones and with the port's on the
    whole coefficients."""
    s = setup
    skel_j, st_j, st_t = s["skel_j"], s["st_j"], s["st_t"]
    joint = (skel_j.animated_joints[0] if jr_joint == "root"
             else tp.FAMILY_JOINTS[s["scale"]]["spine"])
    scs_j = [cj.set_joint_rotation_constraint(sc, skel_j, joint, tp.JR_QUAT,
                                              12.0) for sc in s["base"]]
    sc_t = tp.port_sc(scs_j)
    nodes = torch.as_tensor(s["nodes"])
    fn_j = _jax_residuals(skel_j, False, root_only=True)
    for i in range(N_CAND):
        sv = torch.as_tensor(s["lat"][:, i])
        flags = dict(use_traj=True, use_ca=True, use_ts=True)
        res_rf = cwt._residuals(s["skel_t"], st_t, nodes, sc_t, sv, True,
                                **flags).numpy()
        res_full = cwt._residuals(s["skel_t"], st_t, nodes, sc_t, sv, False,
                                  **flags).numpy()
        for c in range(2):
            coeffs = cwj.stacked_aligned_coeffs(
                st_j, s["nodes"][c], scs_j[c], jnp.asarray(s["lat"][c, i]))
            res_j = np.asarray(fn_j(st_j.knots_s[s["nodes"][c]], scs_j[c],
                                    coeffs))
            assert res_j[cj._OFF_CA - 2] > 1e-3
            np.testing.assert_allclose(res_rf[c], res_j, rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(res_full[c], res_j, rtol=RTOL,
                                       atol=ATOL)


def _primitives(scale):
    gd = (synj.make_graph_dict() if scale == "toy"
          else synj.make_reference_scale_graph_dict())
    key = ("walk", "leftStance")
    return (gj.build_graph_from_dict(gd).nodes[key].primitive,
            gt.build_graph_from_dict(gd).nodes[key].primitive)


@pytest.mark.parametrize("chain_fk", [False, True])
def test_single_primitive_entry_points(setup, chain_fk):
    """aligned_coeffs, evaluate_residuals and evaluate_error on one
    primitive with every family and a trajectory set (a JAX set carried by
    from_jax_numpy, and the port's own host-side set), both alignment
    modes, against the JAX package's."""
    s = setup
    skel_j, skel_t = s["skel_j"], s["skel_t"]
    prim_j, prim_t = _primitives(s["scale"])
    n_can = prim_j.n_canonical_frames
    path_j = tp.rand_paths(1, seed=2)[0]
    base_j = cj.set_trajectory_constraint(
        cj.empty_step_constraints(skel_j, n_can), skel_j, path_j,
        skel_j.node_names[0], 2.0)
    base_t = ct.set_trajectory_constraint(
        ct.empty_step_constraints(skel_t, n_can), skel_t,
        tp.port_paths(tp.to_numpy(path_j)), skel_t.node_names[0], 2.0)
    for align in ("start_pose", "prev"):
        sets = []
        for mod, sp_mod, base, skel in ((cj, spj, base_j, skel_j),
                                        (ct, spt, base_t, skel_t)):
            sc = (mod.set_alignment_from_start_pose(base, [3.0, np.nan, -4.0],
                                                    30.0)
                  if align == "start_pose" else mod.set_alignment_from_prev(
                      base, s["pose_frame"]))
            sets.append(tp.add_family(mod, sp_mod, sc, skel, s["scale"],
                                      "all", s["pose_frame"]))
        sc_j, sc_host_t = sets
        rng = np.random.default_rng(5)
        for _ in range(2):
            sv = rng.standard_normal(prim_j.n_latent).astype(np.float32)
            res_j = np.asarray(cj.evaluate_residuals(
                skel_j, prim_j, sc_j, jnp.asarray(sv), use_ts=True,
                chain_fk=chain_fk))
            err_j = float(cj.evaluate_error(skel_j, prim_j, sc_j,
                                            jnp.asarray(sv), use_ts=True))
            np.testing.assert_allclose(
                ct.aligned_coeffs(prim_t, torch.as_tensor(sv),
                                  ct.from_jax_numpy(sc_j)).numpy(),
                np.asarray(cj.aligned_coeffs(prim_j, jnp.asarray(sv), sc_j)),
                rtol=1e-5, atol=1e-3)
            for sc_t in (ct.from_jax_numpy(sc_j), sc_host_t):
                res_t = ct.evaluate_residuals(
                    skel_t, prim_t, sc_t, torch.as_tensor(sv), use_ts=True,
                    chain_fk=chain_fk).numpy()
                assert res_t.shape == (ct.N_RESIDUALS,)
                np.testing.assert_allclose(res_t, res_j, rtol=RTOL,
                                           atol=ATOL)
                np.testing.assert_allclose(
                    float(ct.evaluate_error(skel_t, prim_t, sc_t,
                                            torch.as_tensor(sv),
                                            use_ts=True)),
                    err_j, rtol=RTOL, atol=ATOL)


def _leaves(sc):
    """{name: numpy leaf} of a constraint set, splines flattened."""
    out = {}
    for name in ct.StepConstraints.__dataclass_fields__:
        v = getattr(sc, name)
        if name in ("traj", "ts_trajs"):
            if v is not None:
                for leaf in spt.PathSpline.__dataclass_fields__:
                    out[f"{name}.{leaf}"] = np.asarray(getattr(v, leaf))
        else:
            out[name] = np.asarray(v)
    return out


def test_from_jax_numpy_round_trips():
    """Every field of JAX's StepConstraints has its counterpart in the
    port, and from_jax_numpy carries each one: host=True keeps numpy
    leaves with the steps' leading axis (the trajectory-set stack as
    [n_steps, J, ...]) and drops the trajectory; the tensor form carries
    the trajectory too, as tensors of the same values."""
    skel_j, st_j, _, _ = tp.model("ref")
    assert set(ct.StepConstraints.__dataclass_fields__) == set(
        cj.StepConstraints.__dataclass_fields__)
    sc = tp.add_family(cj, spj, tp.loco_sc(
        skel_j, st_j, 0, tp.rand_paths(1)[0], 5.0, 40.0,
        np.zeros(st_j.n_dim, np.float32), 0.0), skel_j, "ref", "all",
        tp.prev_frame(st_j.n_dim, 1.0, 2.0))
    sc = jax.tree.map(np.asarray, sc)
    steps_j = jax.tree.map(lambda x: np.stack([x, x]), sc)
    host = ct.from_jax_numpy(steps_j, host=True)
    assert host.traj is None
    assert host.ts_trajs.table_arc.shape == (2, ct.MAX_TS_JOINTS, 257)
    want = _leaves(steps_j)
    got = _leaves(host)
    assert set(got) == set(want) - {k for k in want if k.startswith("traj.")}
    for k, v in got.items():
        assert isinstance(v, np.ndarray)
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    tens = ct.from_jax_numpy(sc)
    want = _leaves(sc)
    got = _leaves(tens)
    assert set(got) == set(want)
    for name in ct.StepConstraints.__dataclass_fields__:
        v = getattr(tens, name)
        assert isinstance(v, (torch.Tensor, spt.PathSpline)), name
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k].astype(v.dtype), err_msg=k)


@pytest.mark.parametrize("scale", ["toy", "ref"])
def test_builders_match_jax(scale):
    """Every host-side builder of the port gives the JAX builder's leaves
    (the splines of the trajectory set to the rounding of their tables)."""
    skel_j, _, skel_t, _ = tp.model(scale)
    frame = tp.prev_frame(skel_j.n_frame_params, 4.0, -3.0, seed=3)
    scs = []
    for mod, sp_mod, skel in ((cj, spj, skel_j), (ct, spt, skel_t)):
        sc = mod.empty_step_constraints(skel, 44)
        sc = mod.set_keyframe_constraint(sc, 3, skel, "Head", 7.0,
                                         position=[1.0, np.nan, 2.0],
                                         quat_wxyz=tp.JR_QUAT, weight=2.0,
                                         generated=True)
        sc = mod.set_direction_constraint(sc, [0.3, 1.0], 9.0, weight=0.4)
        sc = mod.set_alignment_from_start_pose(sc, [1.0, np.nan, -2.0], 35.0)
        sc = mod.set_alignment_from_prev(sc, frame)
        scs.append(tp.add_family(mod, sp_mod, sc, skel, scale, "all", frame))
    want, got = _leaves(scs[0]), _leaves(scs[1])
    assert set(got) == {k for k in want if not k.startswith("traj.")}
    for k, v in got.items():
        if k.startswith("ts_trajs.") or k == "pose_points":
            np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-3,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(v, want[k], err_msg=k)


def _frozen_sets(s, variant):
    """JAX's test_frozen_closed_matches_linearize sets on both characters:
    a root keyframe with an orientation, the direction, the trajectory
    with an active range, a CA slot on the root, and a joint rotation on
    the root or on another animated joint."""
    skel_j = s["skel_j"]
    out = []
    for c, sc in enumerate(s["base"]):
        end = float(s["st_j"].n_canonical[s["nodes"][c]]) - 1.0
        sc = cj.set_keyframe_constraint(
            sc, 2, skel_j, skel_j.node_names[0], end,
            position=[10.0, np.nan, 50.0], quat_wxyz=[0.9, 0.0, 0.43, 0.0])
        sc = cj.set_trajectory_active_range(sc, 5.0, 100.0)
        sc = cj.set_ca_constraint(sc, skel_j, skel_j.node_names[0],
                                  [30.0, 0.0, 40.0])
        joint = (skel_j.animated_joints[0] if variant == "jr_root"
                 else skel_j.animated_joints[2])
        out.append(cj.set_joint_rotation_constraint(
            sc, skel_j, joint, [0.8, 0.0, 0.6, 0.0], end // 2))
    return out


@pytest.mark.parametrize("use_ca", [False, True])
@pytest.mark.parametrize("variant", ["jr_root", "jr_other"])
def test_frozen_forms_with_jr_and_ca(setup, variant, use_ca):
    """Both frozen forms with joint rotation (on the root: the aligned
    rotation row; elsewhere: the affine pass-through) and CA: the
    linearize form's value and forward-mode jacobian against the JAX
    linearize form's (jax.linearize), the closed form's value, jacobian
    and probe against the JAX closed form's, and at the freeze point the
    exact root-only residuals (JAX's bounds: values atol 2e-3 + rtol 1e-4,
    jacobians atol 2e-3 + rtol 1e-3 of the largest entry)."""
    s = setup
    st_j, st_t = s["st_j"], s["st_t"]
    scs_j = _frozen_sets(s, variant)
    sc_t = tp.port_sc(scs_j)
    nodes = torch.as_tensor(s["nodes"])
    args = (s["skel_t"], st_t.knots_s[nodes], sc_t, st_t.eigen_s[nodes],
            st_t.mean_s[nodes], st_t.n_basis_max, st_t.n_dim, st_t.k_s_max)
    kw = dict(use_traj=True, use_ca=use_ca)
    make_lin = ct.make_frozen_root_residuals(*args, **kw)
    make_cl = ct.make_frozen_root_residuals_closed(*args, **kw)
    sv = torch.as_tensor(s["lat"][:, 1])
    probe = sv + 0.05
    rfn = make_lin(sv)
    r_lin, j_lin = lmt.linearize(rfn, sv)
    r_cl, j_cl, vfn = make_cl(sv)
    exact = cwt._residuals(s["skel_t"], st_t, nodes, sc_t, sv, True,
                           use_traj=True, use_ca=use_ca)
    np.testing.assert_allclose(r_lin.numpy(), exact.numpy(), rtol=RTOL,
                               atol=ATOL)
    assert np.all(r_lin[:, cj._OFF_CA - 2].numpy() > 1e-3)
    if use_ca:
        assert np.all(r_lin[:, cj._OFF_CA].numpy() > 1e-3)
    k_s, n_lat = st_t.k_s_max, sv.shape[1]
    for c in range(2):
        n = s["nodes"][c]
        args_j = (s["skel_j"], st_j.knots_s[n], scs_j[c], st_j.eigen_s[n],
                  st_j.mean_s[n], st_j.n_basis_max, st_j.n_dim, st_j.k_s_max)
        x = jnp.asarray(sv[c].numpy())
        r_j, lin_j = jax.linearize(
            cj.make_frozen_root_residuals(*args_j, **kw)(x), x)
        j_j = np.asarray(jax.vmap(lin_j)(jnp.eye(n_lat))).T
        rc_j, jc_j, vfn_j = cj.make_frozen_root_residuals_closed(
            *args_j, **kw)(x)
        scale = max(float(np.abs(j_j).max()), 1.0)
        np.testing.assert_allclose(r_lin[c].numpy(), np.asarray(r_j),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(j_lin[c].numpy() / scale, j_j / scale,
                                   rtol=1e-3, atol=2e-3)
        np.testing.assert_allclose(r_cl[c].numpy(), np.asarray(rc_j),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(j_cl[c].numpy() / scale,
                                   np.asarray(jc_j) / scale, rtol=1e-3,
                                   atol=2e-3)
        np.testing.assert_allclose(
            vfn(probe)[c].numpy(),
            np.asarray(vfn_j(jnp.asarray(probe[c].numpy()))), rtol=RTOL,
            atol=ATOL)
    np.testing.assert_allclose(j_cl.numpy(), j_lin[..., :k_s].numpy(),
                               rtol=1e-3, atol=2e-3 * max(
                                   float(j_lin.abs().max()), 1.0))


@pytest.mark.parametrize("active", [False, True])
def test_exact_lm_jacobian_finite(setup, active):
    """The exact LM's residuals and jacobian (forward mode through every
    family; inactive slots enter as 0 x derivative, so a NaN there would
    poison the row) are finite with every family inactive and with every
    family active, and match jax.linearize of the JAX walk's residual
    function (rtol 1e-4, atol 1e-3 of the largest entry)."""
    s = setup
    scs_j = ([tp.add_family(cj, spj, sc, s["skel_j"], s["scale"], "all",
                            s["pose_frame"]) for sc in s["base"]]
             if active else list(s["base"]))
    sc_t = tp.port_sc(scs_j)
    nodes = torch.as_tensor(s["nodes"])
    cfg = cwt.WalkConfig(use_ca=True, use_ts=True)
    fn = cwt.lm_residual_fn(s["skel_t"], s["st_t"], nodes, sc_t, False, cfg)
    sv = torch.as_tensor(s["lat"][:, 2])
    r_t, j_t = lmt.linearize(fn, sv)
    assert bool(torch.isfinite(r_t).all()) and bool(torch.isfinite(j_t).all())
    st_j = s["st_j"]
    for c in range(2):
        node, sc = s["nodes"][c], jax.tree.map(jnp.asarray, scs_j[c])
        gmm = cwj.node_gmm(st_j, node)
        act = cj.active_mask(sc) * jnp.asarray(cj.static_family_gate(
            True, True, True))

        def res_j(x, node=node, sc=sc, gmm=gmm, act=act):
            r = cwj.stacked_residuals(s["skel_j"], st_j, node, sc, x, True,
                                      True, True, root_only=False)
            return act * (r + 0.1 * (-gmmj.log_prob(gmm, x)))

        r_j, lin = jax.linearize(res_j, jnp.asarray(s["lat"][c, 2]))
        j_j = np.asarray(jax.vmap(lin)(jnp.eye(sv.shape[1]))).T
        np.testing.assert_allclose(r_t[c].numpy(), np.asarray(r_j),
                                   rtol=1e-4, atol=1e-3)
        scale = max(float(np.abs(j_j).max()), 1.0)
        np.testing.assert_allclose(j_t[c].numpy() / scale, j_j / scale,
                                   rtol=1e-4, atol=1e-3)


def test_stacked_spline_queries():
    """The spline queries on a [C, J] stack of splines (the trajectory
    set's in the crowd) against the JAX queries on each spline; splines of
    another granularity do not stack."""
    c, j = 2, 3
    splines_j = tp.rand_paths(c * j, seed=9, granularity=256)
    stack_t = spt.from_jax_numpy(tp.to_numpy(jax.tree.map(
        lambda *xs: jnp.stack(xs).reshape((c, j) + xs[0].shape),
        *splines_j)))
    rng = np.random.default_rng(4)
    arcs = rng.uniform(-5.0, 200.0, (c, j, 5)).astype(np.float32)
    pts = spt.point_at_arc_length(stack_t, torch.as_tensor(arcs)).numpy()
    pos, dirs = spt.point_and_dir_at_arc_length(
        stack_t, torch.as_tensor(arcs[..., 0]))
    np.testing.assert_allclose(stack_t.full_arc_length.numpy(),
                               np.asarray([float(sp.full_arc_length)
                                           for sp in splines_j]).reshape(c, j),
                               rtol=1e-6)
    for i, sp in enumerate(splines_j):
        a, b = divmod(i, j)
        np.testing.assert_allclose(
            pts[a, b], np.asarray(spj.point_at_arc_length(
                sp, jnp.asarray(arcs[a, b]))), rtol=1e-5, atol=1e-4)
        p_j, d_j = spj.point_and_dir_at_arc_length(
            sp, jnp.asarray(arcs[a, b, 0]))
        np.testing.assert_allclose(pos[a, b].numpy(), np.asarray(p_j),
                                   rtol=1e-5, atol=1e-4)
        # the direction is a finite difference over +-5e-4 in u: fp32
        # rounding of the two ~100 cm points moves it by ~1e-4
        np.testing.assert_allclose(dirs[a, b].numpy(), np.asarray(d_j),
                                   atol=1e-3)
    other = spt.build(np.array([[0.0, 0, 0], [1.0, 0, 0]]), granularity=100)
    with pytest.raises(ValueError, match="granularity"):
        spt.stack_host([spt.build(np.array([[0.0, 0, 0], [1.0, 0, 0]])),
                        other])
