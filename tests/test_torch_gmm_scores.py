"""Kernel B5's twins (the mixture log-likelihood and the gradient of its
negative) against the JAX package: the Pallas kernel in interpret mode,
`jax.grad` of `gmm.log_prob`, and the stacked graph's per-node mixtures
(`constrained_walk.node_gmm`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.ops import gmm as gmm_j  # noqa: E402
from morphablegraphs_tpu.ops import pallas_kernels as pk  # noqa: E402
from morphablegraphs_tpu.synthesis import constrained_walk as cwj  # noqa: E402
from morphablegraphs_tpu_torch.ops import kernels  # noqa: E402

import torch_parity as tp  # noqa: E402


def _mixture(seed=1, n=512, d=7, k=3):
    """The JAX package's kernel test mixture (N=512, D=7, K=3), with the
    precision factor W = L^-T of each covariance's Cholesky L."""
    rng = np.random.default_rng(seed)
    w = rng.random(k)
    w /= w.sum()
    means = rng.standard_normal((k, d))
    prec = []
    for _ in range(k):
        a = rng.standard_normal((d, d)) * 0.3
        chol = np.linalg.cholesky(a @ a.T + np.eye(d) * 0.5)
        prec.append(np.linalg.solve(chol, np.eye(d)).T)
    x = rng.standard_normal((n, d))
    return tuple(a.astype(np.float32) for a in (x, w, means, np.stack(prec)))


def test_twin_matches_pallas_kernel():
    """gmm_scores_ref against `pk.gmm_scores(block_n=128, interpret=True)`:
    atol 1e-3, rtol 1e-4, the JAX package's bound for its kernel against
    XLA (Mahalanobis sums of ~10 in other orders)."""
    x, w, means, prec = _mixture()
    ref = pk.gmm_scores(*(jnp.asarray(a) for a in (x, w, means, prec)),
                        block_n=128, interpret=True)
    out = kernels.gmm_scores_ref(*(torch.as_tensor(a)
                                   for a in (x, w, means, prec)))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-3,
                               rtol=1e-4)


def test_gradient_matches_jax_grad():
    """The twin's closed-form d(-log p)/dx against jax.grad of -log_prob,
    and its value against -log_prob: rtol 1e-4, atol 1e-4 (fp32, gradients
    of order 1-10)."""
    x, w, means, prec = _mixture(seed=2, n=64)
    g = gmm_j.GMM(jnp.asarray(w), jnp.asarray(means), jnp.asarray(prec),
                  jnp.asarray(prec))
    val = -jax.vmap(lambda xi: gmm_j.log_prob(g, xi))(jnp.asarray(x))
    grad = jax.vmap(jax.grad(lambda xi: -gmm_j.log_prob(g, xi)))(
        jnp.asarray(x))
    t = torch.as_tensor
    nll, g_t = kernels.gmm_nll_and_grad_ref(
        t(x), t(w)[None], t(means)[None], t(prec)[None],
        torch.zeros(x.shape[0], dtype=torch.long))
    np.testing.assert_allclose(nll.numpy(), np.asarray(val), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(grad), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("scale", ["toy", "ref"])
def test_per_character_mixtures_match_node_gmm(scale):
    """Rows under the stacked graph's node mixtures (padded components of
    weight 0, padded latent dims of identity precision) against JAX
    `node_gmm` + `log_prob` and its gradient, per character: the value
    through both wrappers (log p and -log p) to rtol 1e-4 / atol 1e-3, the
    gradient to rtol 1e-4 / atol 1e-3 (the reference-scale latents are
    28-dimensional, log-densities ~-50)."""
    _, st_j, _, st_t = tp.model(scale)
    rng = np.random.default_rng(4)
    c = 24
    nodes = rng.integers(0, st_j.n_nodes, c)
    x = (np.asarray(st_j.gmm_means)[nodes, 0]
         + rng.standard_normal((c, st_j.gmm_means.shape[-1]))).astype(
        np.float32)

    def one(nd, xi):
        gm = cwj.node_gmm(st_j, nd)
        return jax.value_and_grad(lambda v: gmm_j.log_prob(gm, v))(xi)

    lp_j, g_j = jax.vmap(one)(jnp.asarray(nodes, jnp.int32), jnp.asarray(x))
    args = (torch.as_tensor(x), st_t.gmm_weights, st_t.gmm_means,
            st_t.gmm_prec_chol)
    node = torch.as_tensor(nodes).long()
    lp = kernels.gmm_scores(*args, mix_id=node)
    nll, grad = kernels.gmm_nll_and_grad(*args, node)
    np.testing.assert_allclose(lp.numpy(), np.asarray(lp_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(-nll.numpy(), np.asarray(lp_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(grad.numpy(), -np.asarray(g_j), rtol=1e-4,
                               atol=1e-3)


def test_cpu_wrappers_run_the_twins_and_count_nothing():
    """Given CPU tensors the wrappers ARE the twins (bit-equal) and launch
    nothing; another device, or shapes that do not agree, are refused."""
    x, w, means, prec = (torch.as_tensor(a) for a in _mixture(n=32))
    mix = torch.zeros(32, dtype=torch.long)
    before = kernels.launch_counts()["gmm_scores"]
    assert torch.equal(kernels.gmm_scores(x, w, means, prec),
                       kernels.gmm_scores_ref(x, w, means, prec))
    for a, b in zip(kernels.gmm_nll_and_grad(x, w[None], means[None],
                                             prec[None], mix),
                    kernels.gmm_nll_and_grad_ref(x, w[None], means[None],
                                                 prec[None], mix)):
        assert torch.equal(a, b)
    assert kernels.launch_counts()["gmm_scores"] == before
    with pytest.raises(ValueError, match="no kernel for device"):
        kernels.gmm_scores(*(a.to("meta") for a in (x, w, means, prec)))
    with pytest.raises(ValueError, match="gmm_scores expects"):
        kernels.gmm_scores(x[:, :3], w, means, prec)
