"""Kernel B5's twins (the mixture log-likelihood and the gradient of its
negative) against the JAX package: the Pallas kernel in interpret mode,
`jax.grad` of `gmm.log_prob`, and the stacked graph's per-node mixtures
(`constrained_walk.node_gmm`); `kernels.gmm_nll`, the differentiable form
the exact LM runs, under `lm.linearize` and in reverse mode; and the
kernel's online logsumexp emulated on the CPU."""

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
from morphablegraphs_tpu_torch.ops import lm as lmt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import release_jax_executables  # noqa: E402,F401


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
    with pytest.raises(kernels.KernelError, match="no kernel for device"):
        kernels.gmm_scores(*(a.to("meta") for a in (x, w, means, prec)))
    with pytest.raises(ValueError, match="gmm_scores expects"):
        kernels.gmm_scores(x[:, :3], w, means, prec)


# ---------------------------------------------------------------------------
# `kernels.gmm_nll`: kernel B5 under the exact LM's forward-mode jacobian
# ---------------------------------------------------------------------------

def _node_rows(scale, c=10, seed=7):
    """c latents near their node's first component on the stacked graph
    (JAX and port forms), over random nodes."""
    _, st_j, _, st_t = tp.model(scale)
    rng = np.random.default_rng(seed)
    nodes = rng.integers(0, st_j.n_nodes, c)
    x = (np.asarray(st_j.gmm_means)[nodes, 0]
         + rng.standard_normal((c, st_j.gmm_means.shape[-1]))).astype(
        np.float32)
    return st_j, st_t, nodes, x


@pytest.mark.parametrize("scale", ["toy", "ref"])
def test_gmm_nll_under_linearize_matches_jax(scale, monkeypatch):
    """`kernels.gmm_nll` under `lm.linearize` (vmap of jvp over the latent
    tangents) against jax.jacfwd of -log_prob under each character's
    `node_gmm`: value rtol 1e-4 / atol 1e-3, jacobian rtol 1e-4 / atol 1e-3
    (the bounds of the wrapper tests above).  One linearize calls the
    kernel's wrapper once, with the plain [C, L] tensor."""
    st_j, st_t, nodes, x = _node_rows(scale)
    node = torch.as_tensor(nodes).long()
    seen = []
    real = kernels.gmm_nll_and_grad

    def counting(xv, *args):
        seen.append((type(xv), tuple(xv.shape)))
        return real(xv, *args)

    monkeypatch.setattr(kernels, "gmm_nll_and_grad", counting)

    def fn(sv):
        return kernels.gmm_nll(sv, st_t.gmm_weights, st_t.gmm_means,
                               st_t.gmm_prec_chol, node)[:, None]

    r, j = lmt.linearize(fn, torch.as_tensor(x))
    assert seen == [(torch.Tensor, x.shape)]
    assert j.shape == (x.shape[0], 1, x.shape[1])

    def one(nd, xi):
        gm = cwj.node_gmm(st_j, nd)
        f = lambda v: -gmm_j.log_prob(gm, v)  # noqa: E731
        return f(xi), jax.jacfwd(f)(xi)

    v_j, j_j = jax.vmap(one)(jnp.asarray(nodes, jnp.int32), jnp.asarray(x))
    np.testing.assert_allclose(r[:, 0].numpy(), np.asarray(v_j), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(j[:, 0].numpy(), np.asarray(j_j), rtol=1e-4,
                               atol=1e-3)


def test_gmm_nll_backward_matches_autograd_of_the_twin():
    """Reverse mode through `gmm_nll` (its `backward`: the saved gradient
    times the incoming one) against torch.autograd.grad through the twin's
    logsumexp, with a non-uniform incoming gradient: 1e-5 (fp32, gradients
    of order 1-10 scaled by weights of order 1)."""
    x, w, means, prec = (torch.as_tensor(a) for a in _mixture(seed=3, n=40))
    mix = torch.zeros(40, dtype=torch.long)
    weight = torch.linspace(0.5, 2.0, 40)
    xa = x.clone().requires_grad_()
    g_fn, = torch.autograd.grad(
        (weight * kernels.gmm_nll(xa, w[None], means[None], prec[None],
                                  mix)).sum(), xa)
    xb = x.clone().requires_grad_()
    g_ref, = torch.autograd.grad(
        (weight * -kernels.gmm_scores_ref(xb, w, means, prec)).sum(), xb)
    torch.testing.assert_close(g_fn, g_ref, rtol=1e-5, atol=1e-5)


def test_gmm_nll_refuses_a_batched_primal():
    """vmap over the rows themselves (not over a tangent) would hand the
    kernel a batched tensor whose data pointer is not the row: refused with
    a clear error instead."""
    x, w, means, prec = (torch.as_tensor(a) for a in _mixture(n=8))
    mix = torch.zeros(1, dtype=torch.long)
    with pytest.raises(RuntimeError, match="cannot be vmapped"):
        torch.func.vmap(lambda xi: kernels.gmm_nll(
            xi[None], w[None], means[None], prec[None], mix))(x)


# ---------------------------------------------------------------------------
# Kernel B5's order of operations, emulated on the CPU
# ---------------------------------------------------------------------------

def _online_nll_and_grad(x, w, means, prec):
    """Kernel B5's arithmetic in numpy float32, component by component: the
    running maximum, sum and gradient of the online logsumexp, rescaled by
    exp(old max - new max) whenever the maximum moves; log|diag P_k| and
    -|y_k|^2 / 2 summed together.  x [C, D] under one mixture ->
    (-log p [C], d(-log p)/dx [C, D])."""
    f = np.float32
    c, d = x.shape
    mx = np.full(c, -np.inf, f)
    se = np.zeros(c, f)
    gacc = np.zeros((c, d), f)
    for k in range(w.shape[0]):
        y = ((x - means[k]) @ prec[k]).astype(f)
        part = np.log(np.abs(np.diagonal(prec[k]))).astype(f) - f(0.5) * y * y
        lp = (part.sum(-1, dtype=f) - f(0.5 * d * np.log(2 * np.pi))
              + np.log(np.maximum(w[k], f(1e-30))).astype(f))
        mx_new = np.maximum(mx, lp)
        with np.errstate(invalid="ignore"):
            keep = np.where(np.isneginf(mx_new), f(1), np.exp(mx - mx_new))
            wk = np.where(np.isneginf(mx_new), f(0), np.exp(lp - mx_new))
        mx = mx_new
        se = (se * keep + wk).astype(f)
        gacc = (gacc * keep[:, None]
                + wk[:, None] * (y @ prec[k].T)).astype(f)
    return -(mx + np.log(se)), gacc / se[:, None]


@pytest.mark.parametrize("order", ["as drawn", "dominant last",
                                   "dominant first"])
def test_online_logsumexp_emulation_matches_closed_form(order):
    """The kernel's online logsumexp with its rescaled gradient against
    `gmm.neg_log_prob_and_grad` (two passes over stored components): 1e-5
    relative on the value and on the gradient (relative to each row's
    largest entry).  In the `dominant` cases the rows sit on one
    component's mean and every other component is over 80 below it in log,
    so the running maximum jumps once, late or at once, and what was
    gathered before the jump is scaled away."""
    x, w, means, prec = _mixture(seed=5, n=96, d=7, k=4)
    if order != "as drawn":
        dom = 3 if order == "dominant last" else 0
        means = means + 9.0
        means[dom] -= 9.0
        x = (means[dom] + 0.1 * x).astype(np.float32)
    nll, grad = _online_nll_and_grad(x, w, means, prec)
    t = torch.as_tensor
    nll_t, grad_t = kernels.gmm_nll_and_grad_ref(
        t(x), t(w)[None], t(means)[None], t(prec)[None],
        torch.zeros(x.shape[0], dtype=torch.long))
    if order != "as drawn":
        lp = gmm_j.log_prob_components(gmm_j.GMM(*(jnp.asarray(a) for a in (
            w, means, prec, prec))), jnp.asarray(x)) + np.log(w)
        gap = np.sort(np.asarray(lp), axis=-1)
        assert float((gap[:, -1] - gap[:, -2]).min()) > 80.0
    np.testing.assert_allclose(nll, nll_t.numpy(), rtol=1e-5, atol=1e-5)
    scale = np.abs(grad_t.numpy()).max(-1, keepdims=True)
    np.testing.assert_allclose(grad / scale, grad_t.numpy() / scale,
                               rtol=1e-5, atol=1e-5)
