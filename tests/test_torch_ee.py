"""Parity of the port's end-effector selection pieces with the JAX package:
the chain tables, the operator's end-effector rows, the ee cfg slots, kernel
B3's twin against the Pallas kernel (interpret mode), and the host-side
keyframe setter and contract predicate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.constraints import compiled as cj  # noqa: E402
from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.ops import pallas_kernels as pk  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu_torch.constraints import compiled as ct  # noqa: E402
from morphablegraphs_tpu_torch.ops import align as alt  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.ops import spline_path as spt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

JOINT = {"toy": "Head", "ref": "RightHand"}


@pytest.mark.parametrize("which,joint", [("toy", "Head"),
                                         ("ref", "RightHand"),
                                         ("fixed", "Tip")])
def test_pack_ee_chain_matches_jax(which, joint):
    """The chain tables are equal, fixed joints included (exact)."""
    if which == "fixed":
        skel_j, skel_t = tp.fixed_joint_skeleton()
    else:
        skel_j, _, skel_t, _ = tp.model(which)
    idx_j, const_j = pk.pack_ee_chain(skel_j, joint)
    idx_t, const_t = kernels.pack_ee_chain(skel_t, joint)
    np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(const_t, const_j)
    if which == "fixed":
        assert list(idx_t) == [0, -1, -1]
    if which == "ref":
        assert len(idx_t) == 6 and kernels.ee_rows(6) == 32


def _ee_case(scale: str):
    """Two characters' B3 inputs, built by the JAX package per character
    (nodes, paths, previous frames, a y-masked ee target on slot 2)."""
    skel_j, st_j, skel_t, st_t = tp.model(scale)
    joint = JOINT[scale]
    paths = tp.rand_paths(2, seed=8, granularity=256)
    nodes = [st_j.node_id(("walk", "leftStance")),
             st_j.node_id(("walk", "beginLeftStance"))]
    d = st_j.n_dim
    prevs = [tp.prev_frame(d, 3.0, 12.0, seed=4), np.zeros(d, np.float32)]
    has_prev = [1.0, 0.0]
    travelled = [10.0, 0.0]
    targets = np.array([[20.0, np.nan, 40.0], [5.0, 100.0, 30.0]],
                       np.float32)
    weights = [1.3, 0.7]
    off = jnp.asarray(skel_j.offsets[0], jnp.float32)
    chain_idx, chain_const = pk.pack_ee_chain(skel_j, joint)
    rng = np.random.default_rng(17)
    alphas = (rng.standard_normal((2, 128, st_j.k_s_max)) * 0.9).astype(
        np.float32)
    case = dict(skel_j=skel_j, skel_t=skel_t, st_t=st_t, joint=joint,
                nodes=nodes, prevs=prevs, has_prev=has_prev,
                travelled=travelled, alphas=alphas, chain_idx=chain_idx,
                chain=chain_const, mops=[], tables=[], cfgs=[], kf=[],
                paths_t=tp.port_paths(tp.stack_jax_paths(paths)))
    for c in range(2):
        n_can = float(st_j.n_canonical[nodes[c]])
        sc = cj.set_keyframe_constraint(
            cj.empty_step_constraints(skel_j, 0), 2, skel_j, joint,
            n_can - 1.0 - 3.0 * c, position=targets[c], weight=weights[c])
        case["kf"].append(sc)
        goal_pos, goal_dir = spj.point_and_dir_at_arc_length(
            paths[c], jnp.asarray(travelled[c] + 40.0))
        case["mops"].append(pk.selection_operator(
            st_j.eigen_s[nodes[c]], st_j.mean_s[nodes[c]],
            st_j.knots_s[nodes[c]], st_j.n_basis_max, st_j.n_dim,
            goal_frame=jnp.asarray(n_can - 1.0),
            dir_frame=jnp.asarray(n_can - 1.0),
            n_canonical=jnp.asarray(n_can),
            ee_frame=jnp.asarray(sc.kf_frame[2]), ee_chain_idx=chain_idx))
        case["tables"].append(pk.pack_path_table(paths[c], root_offset=off))
        case["cfgs"].append(pk.pack_selection_cfg(
            paths[c], alj.heading_angle(jnp.asarray(prevs[c][3:7])),
            jnp.asarray(prevs[c][:3]), jnp.asarray(0.0), jnp.zeros(3),
            jnp.asarray(has_prev[c]), goal_pos, goal_dir,
            jnp.asarray(travelled[c]), kf_weight=1.0, dir_weight=0.8,
            traj_active=1.0, traj_weight=1.0, root_offset=off,
            ee_active=jnp.asarray(sc.kf_active[2]),
            ee_weight=jnp.asarray(sc.kf_weight[2]),
            ee_target=jnp.asarray(sc.kf_pos[2]),
            ee_mask=jnp.asarray(sc.kf_pos_mask[2])))
    return case


@pytest.fixture(scope="module", params=["toy", "ref"])
def ee(request):
    return _ee_case(request.param)


def test_ee_operator_and_cfg_match_jax(ee):
    """The port's selection_operator with the ee block and its ee cfg
    slots give the JAX package's kernel inputs (operator rtol 1e-5 / atol
    1e-4: sums of ~16 basis-weighted eigen rows; cfg rtol 1e-5 / atol
    1e-5).  Fixed chain joints have zero rows."""
    st_t, skel_t = ee["st_t"], ee["skel_t"]
    nodes = torch.as_tensor(ee["nodes"])
    n_can = st_t.n_canonical[nodes].float()
    sc = tp.port_sc(ee["kf"])
    mop_t = kernels.selection_operator(
        st_t.eigen_s[nodes], st_t.mean_s[nodes], st_t.knots_s[nodes],
        st_t.n_basis_max, st_t.n_dim, n_can - 1.0, n_can - 1.0, n_can,
        ee_frame=sc.kf_frame[:, 2], ee_chain_idx=ee["chain_idx"])
    assert mop_t.shape[1] == kernels.N_EVAL * kernels.CH + kernels.ee_rows(
        len(ee["chain_idx"]))
    off = torch.as_tensor(skel_t.offsets[0])
    paths_t = ee["paths_t"]
    travelled = torch.as_tensor(ee["travelled"])
    goal_pos, goal_dir = spt.point_and_dir_at_arc_length(paths_t,
                                                         travelled + 40.0)
    prev = torch.as_tensor(np.stack(ee["prevs"]))
    cfg_t = kernels.pack_selection_cfg(
        paths_t, alt.heading_angle(prev[:, 3:7]), prev[:, :3],
        torch.zeros(2), torch.zeros(2, 3), torch.as_tensor(ee["has_prev"]),
        goal_pos, goal_dir, travelled, kf_weight=1.0, dir_weight=0.8,
        traj_active=1.0, traj_weight=1.0, range_lo=-1e30, range_hi=1e30,
        root_offset=off, ee_active=sc.kf_active[:, 2],
        ee_weight=sc.kf_weight[:, 2], ee_target=sc.kf_pos[:, 2],
        ee_mask=sc.kf_pos_mask[:, 2])
    for c in range(2):
        np.testing.assert_allclose(mop_t[c].numpy(), np.asarray(ee["mops"][c]),
                                   rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(cfg_t[c].numpy(),
                                   np.asarray(ee["cfgs"][c])[0], rtol=1e-5,
                                   atol=1e-5)


def test_ee_twin_matches_pallas_kernel(ee):
    """B3's twin against the Pallas ee kernel in interpret mode on the same
    packed inputs: the same argmin, errors to rtol 1e-5 (atol 1e-3 on
    errors up to ~1e3)."""
    mop = torch.as_tensor(np.stack([np.asarray(m) for m in ee["mops"]]))
    table = torch.as_tensor(np.stack([np.asarray(t)[:, :5]
                                      for t in ee["tables"]]))
    cfg = torch.as_tensor(np.stack([np.asarray(c)[0] for c in ee["cfgs"]]))
    alphas = torch.as_tensor(ee["alphas"])
    out_t = kernels.score_locomotion_candidates(mop, alphas, table, cfg,
                                                chain=ee["chain"])
    assert kernels.launch_counts()["score_locomotion_candidates_ee"] == 0
    for c in range(2):
        out_j = np.asarray(pk.score_locomotion_candidates(
            ee["mops"][c], jnp.asarray(ee["alphas"][c]), ee["tables"][c],
            ee["cfgs"][c], chain=jnp.asarray(ee["chain"]), interpret=True))
        np.testing.assert_allclose(out_t[c].numpy(), out_j, rtol=1e-5,
                                   atol=1e-3)
        assert int(out_t[c].argmin()) == int(out_j.argmin())
    # the ee term is live: without the chain the scores differ
    base = kernels.score_locomotion_candidates(
        mop[:, : kernels.N_EVAL * kernels.CH].contiguous(), alphas, table,
        cfg)
    assert float((out_t - base).abs().min()) > 1e-3


def test_ee_twin_fixed_joint_rest_rotation():
    """A chain whose non-animated joint carries a rest rotation (JAX's
    tests/test_pallas_kernels.py case): the twin substitutes the rest
    quaternion and matches the Pallas kernel (rtol 1e-5, atol 1e-4), on
    inputs and a chain table the JAX package packed."""
    skel_j, skel_t = tp.fixed_joint_skeleton()
    rng = np.random.default_rng(23)
    k = 4
    eigen = rng.standard_normal((6 * 7, k)).astype(np.float32) * 0.3
    mean = np.tile(np.array([0, 0, 0, 1, 0, 0, 0], np.float32), 6)
    knots = np.asarray(tp.bspline_knots(6, 20), np.float32)
    chain_idx, chain_const = pk.pack_ee_chain(skel_j, "Tip")
    path = spj.build(np.array([[0.0, 0, 0], [0.0, 0, 10.0]]))
    off = jnp.asarray(skel_j.offsets[0], jnp.float32)
    mop = pk.selection_operator(
        jnp.asarray(eigen), jnp.asarray(mean), jnp.asarray(knots), 6, 7,
        goal_frame=jnp.asarray(19.0), dir_frame=jnp.asarray(0.0),
        n_canonical=jnp.asarray(20.0), ee_frame=jnp.asarray(19.0),
        ee_chain_idx=chain_idx)
    cfg = pk.pack_selection_cfg(
        path, jnp.asarray(0.3), jnp.asarray([2.0, 0.0, 5.0]),
        jnp.asarray(0.0), jnp.zeros(3), jnp.asarray(1.0), jnp.zeros(3),
        jnp.asarray([0.0, 1.0]), jnp.asarray(0.0), kf_active=0.0,
        dir_active=0.0, traj_active=0.0, root_offset=off, ee_active=1.0,
        ee_weight=0.7, ee_target=jnp.asarray([1.0, 12.0, 3.0]),
        ee_mask=jnp.ones(3))
    table = pk.pack_path_table(path, root_offset=off)
    alphas = rng.standard_normal((128, k)).astype(np.float32)
    out_j = np.asarray(pk.score_locomotion_candidates(
        mop, jnp.asarray(alphas), table, cfg,
        chain=jnp.asarray(chain_const), interpret=True))
    out_t = kernels.score_locomotion_candidates(
        torch.as_tensor(np.asarray(mop))[None],
        torch.as_tensor(alphas)[None],
        torch.as_tensor(np.asarray(table)[:, :5])[None],
        torch.as_tensor(np.asarray(cfg)), chain=chain_const)
    np.testing.assert_allclose(out_t[0].numpy(), out_j, rtol=1e-5, atol=1e-4)
    # with the rest rotation dropped the errors change: the rotation is read
    no_rest = chain_const.copy()
    no_rest[1, 3:7] = [1.0, 0.0, 0.0, 0.0]
    other = kernels.score_locomotion_candidates(
        torch.as_tensor(np.asarray(mop))[None], torch.as_tensor(alphas)[None],
        torch.as_tensor(np.asarray(table)[:, :5])[None],
        torch.as_tensor(np.asarray(cfg)), chain=no_rest)
    assert float((other - out_t).abs().max()) > 1e-2


def test_keyframe_setter_and_ee_predicate_match_jax():
    """set_keyframe_constraint and step_scs_pallas_ee_only agree with the
    JAX package on the walk's host-side sets; from_jax_numpy(host=True)
    carries JAX sets with user slots across unchanged."""
    skel_j, _, skel_t, _ = tp.model("ref")
    scs_j, scs_t = tp.ee_step_scs(skel_j, "RightHand", 129.0,
                                  [20.0, np.nan, 80.0], 3, weight=2.0)
    own = ct.set_keyframe_constraint(
        ct.empty_step_constraints(skel_t, 0), 2, skel_t, "RightHand", 129.0,
        position=[20.0, np.nan, 80.0], weight=2.0)
    for name in ("kf_active", "kf_node", "kf_pos", "kf_pos_mask", "kf_quat",
                 "kf_has_quat", "kf_frame", "kf_weight"):
        np.testing.assert_array_equal(getattr(scs_t, name)[0],
                                      getattr(own, name))
        np.testing.assert_array_equal(getattr(scs_t, name),
                                      np.asarray(getattr(scs_j, name)))
    assert scs_t.traj is None
    hand = skel_t.index_of("RightHand")
    assert ct.step_scs_pallas_ee_only(scs_t, hand) is True
    assert cj.step_scs_pallas_ee_only(scs_j, hand)
    assert not ct.step_scs_pallas_ee_only(scs_t, 0)
    assert not ct.step_scs_root_only(scs_t)
    assert not ct.step_scs_locomotion_only(scs_t)
    for bad_j in (cj.set_keyframe_constraint(
                      jax.tree.map(lambda x: np.asarray(x)[0], scs_j), 3,
                      skel_j, "RightHand", 0.0, position=np.zeros(3)),
                  cj.set_keyframe_constraint(
                      jax.tree.map(lambda x: np.asarray(x)[0], scs_j), 2,
                      skel_j, "RightHand", 0.0, position=np.zeros(3),
                      quat_wxyz=[1.0, 0, 0, 0])):
        bad_t = ct.from_jax_numpy(bad_j, host=True)
        assert ct.step_scs_pallas_ee_only(bad_t, hand) is \
            cj.step_scs_pallas_ee_only(bad_j, hand) is False
