"""Kernel B6's twin (the crowd back-projection) and the port's
`walk.back_project_node` against the JAX package: the Pallas kernel in
interpret mode, and the vmapped JAX back-projection with and without time
warping, at two speeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import pallas_kernels as pk  # noqa: E402
from morphablegraphs_tpu.synthesis import walk as wj  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402
from morphablegraphs_tpu_torch.synthesis import walk as wt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401


def _tpu_case():
    """The JAX package's kernel test inputs (C=128, K=7, n_basis=12,
    n_dim=19, T=48)."""
    rng = np.random.default_rng(0)
    c, k, n_basis, n_dim, t = 128, 7, 12, 19, 48
    d = n_basis * n_dim
    return (rng.standard_normal((c, k)).astype(np.float32),
            (rng.standard_normal((d, k)) * 0.3).astype(np.float32),
            rng.standard_normal(d).astype(np.float32),
            rng.random((t, n_basis)).astype(np.float32))


def test_twin_matches_pallas_kernel():
    """The twin at the TPU signature against `pk.crowd_back_project` in
    interpret mode: atol 2e-4, the JAX package's own bound for its kernel
    against XLA (fp32 sums of 7 and 12 terms of values ~1 in other
    orders)."""
    args = _tpu_case()
    ref = pk.crowd_back_project(*(jnp.asarray(a) for a in args),
                                interpret=True)
    out = kernels.crowd_back_project_ref(*(torch.as_tensor(a)
                                           for a in args))
    assert out.shape == (128, 48, 19)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4)


def test_gathered_twin_matches_per_mixture_products():
    """With mix_id, character c uses mixture row mix_id[c] and its own
    basis: equal (to fp32 rounding, atol 2e-4) to the TPU signature run on
    each mixture's characters with that character's basis; a shared
    [1, T, n_basis] basis broadcasts."""
    alphas, eigen, mean, basis = _tpu_case()
    rng = np.random.default_rng(1)
    eig = np.stack([eigen, eigen[::-1].copy(), 0.5 * eigen])
    mu = np.stack([mean, -mean, mean + 1.0])
    mix = rng.integers(0, 3, alphas.shape[0])
    bases = (basis[None] * rng.random((alphas.shape[0], 1, 1))).astype(
        np.float32)
    t = torch.as_tensor
    out = kernels.crowd_back_project_ref(t(alphas), t(eig), t(mu), t(bases),
                                         mix_id=t(mix))
    shared = kernels.crowd_back_project_ref(t(alphas), t(eig), t(mu),
                                            t(basis[None]), mix_id=t(mix))
    for c in (0, 1, 2, 50, 127):
        one = pk.crowd_back_project_xla(
            jnp.asarray(alphas[c:c + 1]), jnp.asarray(eig[mix[c]]),
            jnp.asarray(mu[mix[c]]), jnp.asarray(bases[c]))
        np.testing.assert_allclose(out[c].numpy(), np.asarray(one)[0],
                                   atol=2e-4)
        one = pk.crowd_back_project_xla(
            jnp.asarray(alphas[c:c + 1]), jnp.asarray(eig[mix[c]]),
            jnp.asarray(mu[mix[c]]), jnp.asarray(basis))
        np.testing.assert_allclose(shared[c].numpy(), np.asarray(one)[0],
                                   atol=2e-4)


@pytest.fixture(scope="module")
def toy():
    return tp.model("toy")


@pytest.mark.parametrize("use_time,speed", [(True, 1.0), (True, 1.5),
                                            (False, 1.0), (False, 1.5)])
def test_back_project_node_matches_jax(toy, use_time, speed):
    """The port's back_project_node (the gathered B6 twin on the CPU)
    against the vmapped JAX back_project_node, with the time warp
    (use_time=True, speed passed to the inversion) and without it (the
    linspace(0, F, F/speed) timeline): frame counts exactly, frames to
    atol 2e-4 (fp32 products of ~100-cm coefficients)."""
    _, st_j, _, st_t = toy
    rng = np.random.default_rng(3)
    c = 8
    nodes = rng.integers(0, st_j.n_nodes, c)
    s = (rng.standard_normal((c, st_j.gmm_means.shape[-1])) * 0.5).astype(
        np.float32)
    f_j, n_j, _ = jax.vmap(lambda nd, sv: wj.back_project_node(
        st_j, nd, sv, 64, use_time, speed))(jnp.asarray(nodes, jnp.int32),
                                           jnp.asarray(s))
    f_t, n_t = wt.back_project_node(st_t, torch.as_tensor(nodes).long(),
                                    torch.as_tensor(s), 64, use_time, speed)
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=2e-4)


def test_cpu_wrapper_runs_the_twin_and_counts_nothing():
    """Given CPU tensors the wrapper IS the twin (bit-equal) and launches
    nothing; another device is refused rather than served by the twin."""
    alphas, eigen, mean, basis = (torch.as_tensor(a) for a in _tpu_case())
    before = kernels.launch_counts()["crowd_back_project"]
    out = kernels.crowd_back_project(alphas, eigen, mean, basis)
    assert torch.equal(out, kernels.crowd_back_project_ref(alphas, eigen,
                                                           mean, basis))
    assert kernels.launch_counts()["crowd_back_project"] == before
    with pytest.raises(kernels.KernelError, match="no kernel for device"):
        kernels.crowd_back_project(*(a.to("meta") for a in (alphas, eigen,
                                                            mean, basis)))
    with pytest.raises(ValueError, match="crowd_back_project expects"):
        kernels.crowd_back_project(alphas, eigen[:, :3], mean, basis)
