"""Parity of the port's forward kinematics (fk_global, fk_node and their
chain tables) with the JAX package, and of their derivatives under
torch.func with jax.jvp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.models import skeleton as skj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu_torch.models import skeleton as skt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401

# FK composes ~6 (chain) to ~24 (dense) rotate/multiply pairs of unnormalized
# quaternions on positions of ~100 cm: fp32 op-order rounding of ~1e-5
# relative, so rtol 1e-5 and atol 1e-4 (cm; quaternion entries are ~1)
RTOL, ATOL = 1e-5, 1e-4


def _skeletons(which: str):
    if which == "fixed":
        return tp.fixed_joint_skeleton()
    bvh = synj.TEST_BVH if which == "toy" else synj.REF_BVH
    return skj.load_bvh(bvh)[0], skt.load_bvh(bvh)[0]


def _frames(skel, shape, seed=0):
    """Random frames: root translations of ~50 cm, quaternions near unit
    but deliberately not normalized (FK must not normalize them)."""
    rng = np.random.default_rng(seed)
    f = np.zeros(shape + (skel.n_frame_params,), np.float32)
    f[..., :3] = rng.normal(0.0, 50.0, shape + (3,))
    q = rng.normal(0.0, 0.3, shape + (skel.n_animated, 4))
    q[..., 0] += 1.0
    f[..., 3:] = q.reshape(shape + (-1,))
    return f


@pytest.mark.parametrize("which", ["toy", "ref", "fixed"])
def test_fk_global_matches_jax(which):
    """Every node's position and orientation over a [2, 5] batch of
    frames (rtol 1e-5, atol 1e-4)."""
    skel_j, skel_t = _skeletons(which)
    f = _frames(skel_j, (2, 5))
    pos_j, ori_j = skj.fk_global(skel_j, jnp.asarray(f))
    pos_t, ori_t = skt.fk_global(skel_t, torch.as_tensor(f))
    assert pos_t.shape == (2, 5, skel_t.n_nodes, 3)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ori_t.numpy(), np.asarray(ori_j), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("which", ["toy", "ref", "fixed"])
def test_chain_tables_and_fk_node_match_jax(which):
    """fk_node at every node, with frames [T, 1, D] and nodes [1, N]
    broadcasting to [T, N], against JAX's fk_node and the port's own
    fk_global (rtol 1e-5, atol 1e-4); the chain tables are equal."""
    skel_j, skel_t = _skeletons(which)
    tbl_j, depth_j = skj._chain_tables(skel_j)
    tbl_t, depth_t = skt._chain_tables(skel_t)
    np.testing.assert_array_equal(tbl_t, tbl_j)
    assert depth_t == depth_j
    f = _frames(skel_j, (4,), seed=1)
    nodes = np.arange(skel_j.n_nodes)
    pos_j, ori_j = skj.fk_node(skel_j, jnp.asarray(f)[:, None, :],
                               jnp.asarray(nodes)[None, :])
    pos_t, ori_t = skt.fk_node(skel_t, torch.as_tensor(f)[:, None, :],
                               torch.as_tensor(nodes)[None, :])
    assert pos_t.shape == (4, skel_t.n_nodes, 3)
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ori_t.numpy(), np.asarray(ori_j), rtol=RTOL,
                               atol=ATOL)
    pos_g, ori_g = skt.fk_global(skel_t, torch.as_tensor(f))
    np.testing.assert_allclose(pos_t.numpy(), pos_g.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(ori_t.numpy(), ori_g.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_fk_under_torch_func_matches_jax_jvp():
    """Forward-mode derivatives through fk_global and fk_node (vmapped
    over tangents, as the exact LM runs them) against jax.jvp on the
    reference skeleton (rtol 1e-4, atol 1e-3: products of ~24 rotations
    differentiated in other orders)."""
    skel_j, skel_t = _skeletons("ref")
    f = _frames(skel_j, (3,), seed=2)
    rng = np.random.default_rng(3)
    tangents = rng.standard_normal((2,) + f.shape).astype(np.float32)
    hand = skel_j.index_of("RightHand")

    def fn_t(x):
        pos, ori = skt.fk_global(skel_t, x)
        p_n, o_n = skt.fk_node(skel_t, x, torch.full((3,), hand))
        return torch.cat([pos.flatten(1), ori.flatten(1), p_n, o_n], dim=1)

    def fn_j(x):
        pos, ori = skj.fk_global(skel_j, x)
        p_n, o_n = skj.fk_node(skel_j, x, jnp.full((3,), hand))
        return jnp.concatenate([pos.reshape(3, -1), ori.reshape(3, -1),
                                p_n, o_n], axis=1)

    x_t = torch.as_tensor(f)
    _, d_t = torch.func.vmap(lambda t: torch.func.jvp(fn_t, (x_t,), (t,)),
                             out_dims=(None, 0))(torch.as_tensor(tangents))
    for i in range(2):
        _, d_j = jax.jvp(fn_j, (jnp.asarray(f),), (jnp.asarray(tangents[i]),))
        np.testing.assert_allclose(d_t[i].numpy(), np.asarray(d_j),
                                   rtol=1e-4, atol=1e-3)
