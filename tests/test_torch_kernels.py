"""The port's kernel twins against the JAX package's Pallas kernels (run in
interpret mode on the CPU).  The kernels themselves are checked against the
twins on the card by tests/test_torch_cuda.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import align as alj  # noqa: E402
from morphablegraphs_tpu.ops import lm as lmj  # noqa: E402
from morphablegraphs_tpu.ops import pallas_kernels as pk  # noqa: E402
from morphablegraphs_tpu.ops import spline_path as spj  # noqa: E402
from morphablegraphs_tpu_torch.ops import align as alt  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.ops import lm as lmt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401


def _selection_case(scale: str, granularity: int):
    """Two characters' B1 inputs built by the JAX package (per character)
    and by the port (batched), from the same nodes, paths and states."""
    skel_j, st_j, skel_t, st_t = tp.model(scale)
    paths = tp.rand_paths(2, seed=5, granularity=granularity)
    nodes = [st_j.node_id(("walk", "beginLeftStance")),
             st_j.node_id(("walk", "rightStance"))]
    d = st_j.n_dim
    prevs = [np.zeros(d, np.float32), tp.prev_frame(d, 6.0, 20.0, seed=3)]
    has_prev = [0.0, 1.0]
    travelled = [0.0, 22.0]
    start_q = np.array([np.cos(0.2), 0.0, np.sin(0.2), 0.0], np.float32)
    start_delta = np.array([1.0, 0.5, -2.0], np.float32)
    off = jnp.asarray(skel_j.offsets[0], jnp.float32)
    rng = np.random.default_rng(21)
    alphas = (rng.standard_normal((2, 256, st_j.k_s_max)) * 0.9).astype(
        np.float32)
    mops, tables, cfgs = [], [], []
    for c in range(2):
        n_can = jnp.asarray(float(st_j.n_canonical[nodes[c]]))
        goal_arc = jnp.asarray(travelled[c] + 30.0)
        goal_pos, goal_dir = spj.point_and_dir_at_arc_length(paths[c],
                                                             goal_arc)
        mops.append(pk.selection_operator(
            st_j.eigen_s[nodes[c]], st_j.mean_s[nodes[c]],
            st_j.knots_s[nodes[c]], st_j.n_basis_max, st_j.n_dim,
            goal_frame=n_can - 1.0, dir_frame=n_can - 1.0,
            n_canonical=n_can))
        tables.append(pk.pack_path_table(paths[c], root_offset=off))
        cfgs.append(pk.pack_selection_cfg(
            paths[c], alj.heading_angle(jnp.asarray(prevs[c][3:7])),
            jnp.asarray(prevs[c][:3]),
            start_theta=alj.heading_angle(jnp.asarray(start_q)),
            start_delta=jnp.asarray(start_delta),
            has_prev=jnp.asarray(has_prev[c]), goal_pos=goal_pos,
            dir_target=goal_dir, min_arc=jnp.asarray(travelled[c]),
            kf_weight=1.0, dir_weight=0.8, traj_active=1.0, traj_weight=1.0,
            root_offset=off))
    return dict(skel_t=skel_t, st_t=st_t, nodes=nodes, prevs=prevs,
                has_prev=has_prev, travelled=travelled, start_q=start_q,
                start_delta=start_delta, alphas=alphas, mops=mops,
                tables=tables, cfgs=cfgs,
                paths_t=tp.port_paths(tp.stack_jax_paths(paths)))


@pytest.fixture(scope="module", params=[("toy", 256), ("ref", 1000)])
def sel(request):
    return _selection_case(*request.param)


def test_selection_packing_matches_jax(sel):
    """The port's selection_operator / pack_path_table / pack_selection_cfg
    give the JAX package's kernel inputs (rtol 1e-5; atol 1e-4 on the
    operator, whose entries are sums of ~16 basis-weighted eigen rows)."""
    st_t = sel["st_t"]
    nodes = torch.as_tensor(sel["nodes"])
    n_can = st_t.n_canonical[nodes].float()
    mop_t = kernels.selection_operator(
        st_t.eigen_s[nodes], st_t.mean_s[nodes], st_t.knots_s[nodes],
        st_t.n_basis_max, st_t.n_dim, n_can - 1.0, n_can - 1.0, n_can)
    off = torch.as_tensor(sel["skel_t"].offsets[0])
    table_t = kernels.pack_path_table(sel["paths_t"], off)
    paths_t = sel["paths_t"]
    travelled = torch.as_tensor(sel["travelled"])
    from morphablegraphs_tpu_torch.ops import spline_path as spt
    goal_pos, goal_dir = spt.point_and_dir_at_arc_length(paths_t,
                                                         travelled + 30.0)
    prev = torch.as_tensor(np.stack(sel["prevs"]))
    sq = torch.as_tensor(sel["start_q"]).expand(2, 4)
    cfg_t = kernels.pack_selection_cfg(
        paths_t, alt.heading_angle(prev[:, 3:7]), prev[:, :3],
        alt.heading_angle(sq), torch.as_tensor(sel["start_delta"]).expand(2, 3),
        torch.as_tensor(sel["has_prev"]), goal_pos, goal_dir, travelled,
        kf_weight=1.0, dir_weight=0.8, traj_active=1.0, traj_weight=1.0,
        range_lo=float("-inf"), range_hi=float("inf"), root_offset=off)
    for c in range(2):
        np.testing.assert_allclose(mop_t[c].numpy(), np.asarray(sel["mops"][c]),
                                   rtol=1e-5, atol=1e-4)
        tab_j = np.asarray(sel["tables"][c])
        np.testing.assert_allclose(table_t[c].numpy(), tab_j[:, :5],
                                   rtol=1e-6, atol=1e-6)
        cfg_j = np.array(sel["cfgs"][c])[0]
        cfg_j[20:22] = [-np.inf, np.inf]  # the port passes the range as-is
        # slots 31+ are the (inactive) end-effector block; the JAX package
        # shifts its zero target by -root_offset too
        np.testing.assert_allclose(cfg_t[c].numpy(), cfg_j, rtol=1e-5,
                                   atol=1e-5)


def test_score_twin_matches_pallas_kernel(sel):
    """B1's twin against the Pallas kernel in interpret mode on the same
    packed inputs: the same argmin, errors to rtol 1e-5 (atol 1e-4 on
    errors of ~10-100)."""
    mop = torch.as_tensor(np.stack([np.asarray(m) for m in sel["mops"]]))
    table = torch.as_tensor(np.stack([np.asarray(t)[:, :5]
                                      for t in sel["tables"]]))
    cfg = torch.as_tensor(np.stack([np.asarray(c)[0] for c in sel["cfgs"]]))
    alphas = torch.as_tensor(sel["alphas"])
    out_t = kernels.score_locomotion_candidates(mop, alphas, table, cfg)
    assert sum(kernels.launch_counts().values()) == 0  # CPU: twin
    for c in range(2):
        out_j = np.asarray(pk.score_locomotion_candidates(
            sel["mops"][c], jnp.asarray(sel["alphas"][c]), sel["tables"][c],
            sel["cfgs"][c], interpret=True))
        np.testing.assert_allclose(out_t[c].numpy(), out_j, rtol=1e-5,
                                   atol=1e-4)
        assert int(out_t[c].argmin()) == int(out_j.argmin())


def _rand_spd(rng, c, k):
    j = rng.standard_normal((c, 40, k)).astype(np.float32)
    a = np.einsum("cri,crj->cij", j, j) + 0.1 * np.eye(k, dtype=np.float32)
    return a, rng.standard_normal((c, k)).astype(np.float32)


@pytest.mark.parametrize("c,k", [(64, 7), (1024, 28)])
def test_chol_solve_twin_matches_jax(c, k):
    """B2's twin against the Pallas crowd solve (interpret mode) and the
    JAX unrolled solve, at the tolerances of the JAX package's own
    crowd-solve test (atol 2e-4, rtol 2e-3); zero systems solve to 0."""
    a, g = _rand_spd(np.random.default_rng(c), c, k)
    a[-2:] = 0.0
    g[-2:] = 0.0
    x_t = kernels.chol_solve(torch.as_tensor(a), torch.as_tensor(g)).numpy()
    assert kernels.launch_counts()["chol_solve"] == 0
    x_pk = np.asarray(pk.chol_solve_crowd(jnp.asarray(a), jnp.asarray(g),
                                          interpret=True))
    x_un = np.asarray(jax.vmap(lmj.chol_solve_unrolled)(jnp.asarray(a),
                                                        jnp.asarray(g)))
    np.testing.assert_allclose(x_t, x_pk, atol=2e-4, rtol=2e-3)
    np.testing.assert_allclose(x_t, x_un, atol=2e-4, rtol=2e-3)
    assert np.all(x_t[-2:] == 0.0)


def test_lm_delta_matches_jax():
    """The LM step block (damped normal equations through B2's path and the
    trust clip) against the JAX package's lm_delta."""
    rng = np.random.default_rng(9)
    j = rng.standard_normal((16, 49, 28)).astype(np.float32)
    r = rng.standard_normal((16, 49)).astype(np.float32)
    lam = np.full(16, 1e-3, np.float32)
    rad = np.linspace(0.1, 4.0, 16).astype(np.float32)
    d_t = lmt.lm_delta(*(torch.as_tensor(x) for x in (j, r, lam, rad)))
    d_j = jax.vmap(lmj._lm_delta_unbatched)(*(jnp.asarray(x)
                                              for x in (j, r, lam, rad)))
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), atol=2e-4,
                               rtol=2e-3)


def test_wrappers_refuse_bad_input():
    with pytest.raises(ValueError, match="multiple of 128"):
        kernels.score_locomotion_candidates(
            torch.zeros(1, 152, 6), torch.zeros(1, 100, 5),
            torch.zeros(1, 8, 5), torch.zeros(1, 48))
    with pytest.raises(ValueError, match="chol_solve expects"):
        kernels.chol_solve(torch.zeros(4, 3, 3), torch.zeros(4, 2))
    with pytest.raises(kernels.KernelError, match="no kernel"):
        kernels.chol_solve(torch.zeros(4, 3, 3, device="meta"),
                           torch.zeros(4, 3, device="meta"))
