"""Parity of the port's GMM trainer and conditional-GMM transition models
with the JAX package, and of MotionGenerator with use_transition_model
against the JAX generator through replayed draws.

Tolerances: k-means++ centres exactly (the same numpy generator); EM
from those centres (float32 in JAX, float64 in the port): weights, means
and covariances to atol 1e-3 and the log-likelihood to rtol 1e-5 on
well-separated clusters; on rank-deficient transition pairs the port's
EM against the same EM in float64 numpy, and JAX's log-likelihood within
1e-2; BIC picks the same K; the conditioning
(`from_joint`, `predict`) to rtol 1e-5 / atol 1e-5 of float64-factored
float32 tensors; requests with transition models at the whole-request
bounds of tests/test_torch_motion_generator.py (torch_parity
.assert_request_matches)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from morphablegraphs_tpu.construct import gmm_trainer as gtj  # noqa: E402
from morphablegraphs_tpu.models import primitive as prj  # noqa: E402
from morphablegraphs_tpu.models import transition_model as tmj  # noqa: E402
from morphablegraphs_tpu.utils import synthetic as synj  # noqa: E402
from morphablegraphs_tpu.utils.config import default_config  # noqa: E402
from morphablegraphs_tpu_torch.construct import gmm_trainer as gtt  # noqa: E402
from morphablegraphs_tpu_torch.models import primitive as prt  # noqa: E402
from morphablegraphs_tpu_torch.models import transition_model as tmt  # noqa: E402
from morphablegraphs_tpu_torch.models.graph import \
    NODE_TYPE_STANDARD  # noqa: E402
from morphablegraphs_tpu_torch.ops import gmm as gmt  # noqa: E402

import torch_parity as tp  # noqa: E402
from torch_parity import WALK_INPUT, release_jax_executables  # noqa: E402,F401


def _clusters(seed, n=300):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.multivariate_normal([5, 0, 0], np.eye(3) * 0.3, n // 2),
        rng.multivariate_normal([-5, 2, 1], np.eye(3) * 0.5, n // 2)])


def test_kmeanspp_centres_match_jax():
    x = _clusters(0)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(
            gtt._kmeanspp_init(np.random.default_rng(k), x, k),
            gtj._kmeanspp_init(np.random.default_rng(k), x, k))
    dup = np.tile(np.array([[1.0, 2.0, 3.0]]), (6, 1))
    assert gtt._kmeanspp_init(np.random.default_rng(0), dup, 3).shape == \
        (3, 3)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fit_gmm_matches_jax(k):
    """Numpy data (EM on the CPU) and the same data as a tensor (EM on its
    device) against the JAX trainer."""
    x = _clusters(3)
    w_j, mu_j, cov_j, ll_j = gtj.fit_gmm(x, k, seed=k)
    for data in (x, torch.as_tensor(x, dtype=torch.float32)):
        w_t, mu_t, cov_t, ll_t = gtt.fit_gmm(data, k, seed=k, device="cpu")
        np.testing.assert_allclose(ll_t, ll_j, rtol=1e-5)
        if k < 3:  # k = 3 splits a cluster: hold the likelihood only
            np.testing.assert_allclose(w_t, w_j, atol=1e-3)
            np.testing.assert_allclose(mu_t, mu_j, atol=1e-3)
            np.testing.assert_allclose(cov_t, cov_j, atol=1e-3)


def test_train_selects_the_jax_k():
    rng = np.random.default_rng(4)
    x = np.concatenate([rng.multivariate_normal([4, 0], np.eye(2) * 0.2, 100),
                        rng.multivariate_normal([-4, 0], np.eye(2) * 0.2,
                                                100)])
    m_t, m_j = gtt.train(x, max_k=5, device="cpu"), gtj.train(x, max_k=5)
    assert len(m_t["gmm_weights"]) == len(m_j["gmm_weights"]) == 2
    np.testing.assert_allclose(np.sort(m_t["gmm_weights"]),
                               np.sort(m_j["gmm_weights"]), atol=1e-3)
    assert gtt.bic(-10.0, 200, 2, 3) == gtj.bic(-10.0, 200, 2, 3)


def _joint_mixture(seed, k, dx, dy):
    rng = np.random.default_rng(seed)
    d = dx + dy
    a = rng.standard_normal((k, d, d)) * 0.4
    covars = a @ np.swapaxes(a, 1, 2) + np.eye(d) * 0.5
    w = rng.uniform(0.5, 1.5, k)
    return w / w.sum(), rng.standard_normal((k, d)) * 2.0, covars


def _assert_gmm_close(g_t, g_j, atol=1e-5):
    for f in ("weights", "means", "cov_chol", "prec_chol"):
        np.testing.assert_allclose(getattr(g_t, f).numpy(),
                                   np.asarray(getattr(g_j, f)), rtol=1e-5,
                                   atol=atol)


def test_from_joint_predict_and_json_match_jax():
    w, mu, cov = _joint_mixture(0, 3, 4, 5)
    m_j = tmj.from_joint(w, mu, cov, n_in=4)
    m_t = tmt.from_joint(w, mu, cov, n_in=4)
    for f in ("weights", "mu_x", "mu_y", "cov_chol_x", "prec_chol_x", "reg",
              "cond_cov_chol", "cond_prec_chol"):
        np.testing.assert_allclose(getattr(m_t, f).numpy(),
                                   np.asarray(getattr(m_j, f)), rtol=1e-5,
                                   atol=1e-6)
    assert (m_t.n_components, m_t.n_in, m_t.n_out) == (3, 4, 5)
    # a JAX model read by the port and the port's read by JAX
    m_tj = tmt.from_json(json.loads(json.dumps(tmj.to_json(m_j))))
    m_jt = tmj.from_json(json.loads(json.dumps(tmt.to_json(m_t))))
    rng = np.random.default_rng(1)
    for x in rng.standard_normal((4, 4)).astype(np.float32) * 2.0:
        p_j = tmj.predict(m_j, jnp.asarray(x))
        _assert_gmm_close(tmt.predict(m_t, torch.as_tensor(x)), p_j)
        _assert_gmm_close(tmt.predict(m_tj, torch.as_tensor(x)), p_j)
        _assert_gmm_close(tmt.predict(m_t, torch.as_tensor(x)),
                          tmj.predict(m_jt, jnp.asarray(x)))
    with pytest.raises(ValueError, match="unknown transition model"):
        tmt.from_json({"type": "gpm"})
    # predict_parameters draws the conditioned mixture from the generator
    x = torch.zeros(4)
    np.testing.assert_array_equal(
        tmt.predict_parameters(torch.Generator().manual_seed(2), m_t, x,
                               n=7).numpy(),
        gmt.sample(torch.Generator().manual_seed(2), tmt.predict(m_t, x),
                   7).numpy())


@pytest.mark.parametrize("n_components", [1, 0])
def test_fit_transition_model_matches_jax(n_components):
    """y = A x + b + noise pairs; K fixed at 1 or chosen by BIC (max_k 3):
    the same K as JAX and the conditional means within 1e-3."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((800, 3))
    y = x @ rng.standard_normal((2, 3)).T + 0.05 * rng.standard_normal(
        (800, 2)) + 1.0
    m_j = tmj.fit_transition_model(x, y, n_components=n_components, max_k=3)
    m_t = tmt.fit_transition_model(x, y, n_components=n_components, max_k=3,
                                    device="cpu")
    assert m_t.n_components == m_j.n_components
    for q in rng.standard_normal((3, 3)).astype(np.float32):
        p_t = tmt.predict(m_t, torch.as_tensor(q))
        p_j = tmj.predict(m_j, jnp.asarray(q))
        np.testing.assert_allclose(
            torch.einsum("k,kd->d", p_t.weights, p_t.means).numpy(),
            np.einsum("k,kd->d", np.asarray(p_j.weights),
                      np.asarray(p_j.means)), atol=1e-3)


def test_match_boundary_poses_matches_bruteforce():
    rng = np.random.default_rng(3)
    xe = rng.normal(size=(40, 7)).astype(np.float32)
    yst = rng.normal(size=(50, 7)).astype(np.float32)
    want = np.argmin(((xe[:, None] - yst[None]) ** 2).sum(-1), axis=1)
    np.testing.assert_array_equal(
        tmt._match_boundary_poses(torch.as_tensor(xe),
                                  torch.as_tensor(yst)).numpy(), want)
    np.testing.assert_array_equal(np.asarray(tmj._match_boundary_poses(
        jnp.asarray(xe), jnp.asarray(yst))), want)


@pytest.fixture(scope="module")
def graphs():
    return tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)


def _np_em(x, k, seed, n_iters=100):
    """The trainer's EM in float64 numpy, from the JAX package's k-means++
    centres: the reference the port's float64 EM must reproduce."""
    from scipy.special import logsumexp
    n, d = x.shape
    mu = gtj._kmeanspp_init(np.random.default_rng(seed), x, k)
    w = np.full(k, 1.0 / k)
    cov = np.tile(np.cov(x.T) + 1e-3 * np.eye(d), (k, 1, 1))
    for _ in range(n_iters):
        chol = np.linalg.cholesky(cov + 1e-6 * np.eye(d))
        sol = np.linalg.solve(chol[:, None], (x[None] - mu[:, None])[
            ..., None])[..., 0]  # [k, n, d]
        lp = (-0.5 * (d * np.log(2 * np.pi) + (sol ** 2).sum(-1))
              - np.log(np.diagonal(chol, axis1=1, axis2=2)).sum(1)[:, None]
              + np.log(np.maximum(w, 1e-30))[:, None])
        lse = logsumexp(lp, axis=0)
        resp = np.exp(lp - lse)
        nk = resp.sum(1) + 10 * np.finfo(np.float32).eps
        w, mu = nk / n, resp @ x / nk[:, None]
        diff = x[None] - mu[:, None]
        cov = (np.einsum("kne,knf->kef", diff * resp[..., None], diff)
               / nk[:, None, None] + 1e-6 * np.eye(d))
        ll = lse.sum()
    return w, mu, cov, ll


def test_fit_models_for_graph_follows_jax(graphs):
    """The port fits a model on every standard edge from its own draws.
    On those draws the boundary poses and pairs equal JAX's; the port's
    float64 EM equals the same EM in float64 numpy (log-likelihood to
    rtol 1e-9, parameters to 1e-6), and the stored model is that fit
    conditioned.  The pairs are rank-deficient (fewer than 50 distinct
    targets of 200), where JAX's float32 EM takes its own path: only its
    log-likelihood is held, within 1e-2 relative of the float64 one."""
    g_j, g_t = graphs
    tmt.fit_transition_models_for_graph(g_t, n_pairs=200, n_components=2,
                                        seed=0)
    gen = torch.Generator().manual_seed(0)
    edges = [(f, t) for f, n in g_t.nodes.items()
             for t in n.edges_of_type(NODE_TYPE_STANDARD)]
    assert edges
    for f, t in edges:
        assert g_t.nodes[f].has_transition_model(t)
        src_t, dst_t = g_t.nodes[f].primitive, g_t.nodes[t].primitive
        src_j, dst_j = g_j.nodes[f].primitive, g_j.nodes[t].primitive
        xs = prt.sample_latent(gen, src_t, 200).numpy()
        ys = prt.sample_latent(gen, dst_t, 200).numpy()
        x_end = jax.vmap(lambda s: prj.evaluate_at(
            src_j, s, jnp.asarray([src_j.n_canonical_frames - 1.0]))[0])(
                jnp.asarray(xs))
        y_start = jax.vmap(lambda s: prj.evaluate_at(
            dst_j, s, jnp.asarray([0.0]))[0])(jnp.asarray(ys))
        match = np.asarray(tmj._match_boundary_poses(x_end[:, 3:],
                                                     y_start[:, 3:]))
        x_end_t = tmt._boundary_pose(src_t, torch.as_tensor(xs),
                                     src_t.n_canonical_frames - 1.0)
        y_start_t = tmt._boundary_pose(dst_t, torch.as_tensor(ys), 0.0)
        np.testing.assert_allclose(x_end_t.numpy(), np.asarray(x_end),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_allclose(y_start_t.numpy(), np.asarray(y_start),
                                   rtol=1e-5, atol=1e-3)
        np.testing.assert_array_equal(tmt._match_boundary_poses(
            x_end_t[:, 3:], y_start_t[:, 3:]).numpy(), match)
        assert len(np.unique(match)) < 50
        joint = np.concatenate([xs, ys[match]], axis=1).astype(np.float64)
        w, mu, cov, ll = _np_em(joint, 2, seed=0)
        w_t, mu_t, cov_t, ll_t = gtt.fit_gmm(joint, 2, seed=0, device="cpu")
        np.testing.assert_allclose(ll_t, ll, rtol=1e-9)
        for a, b in ((w_t, w), (mu_t, mu), (cov_t, cov)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        ref = tmt.from_joint(w, mu, cov, n_in=xs.shape[1])
        stored = g_t.nodes[f].transition_models[t]
        for name in ("weights", "mu_x", "mu_y", "reg", "cond_cov_chol"):
            np.testing.assert_allclose(getattr(stored, name).numpy(),
                                       getattr(ref, name).numpy(),
                                       rtol=1e-5, atol=1e-5)
        ll_j = gtj.fit_gmm(joint, 2, seed=0)[3]
        np.testing.assert_allclose(ll_j, ll, rtol=1e-2)


def _tm_graphs():
    """The toy graphs with JAX-fitted transition models on every standard
    edge, carried into the port's graph through to_json -> from_json."""
    g_j, g_t = tp.request_graphs(synj.make_graph_dict(), synj.TEST_BVH)
    tmj.fit_transition_models_for_graph(g_j, n_pairs=300, n_components=2)
    for key, node in g_j.nodes.items():
        for to_key, model in node.transition_models.items():
            g_t.nodes[key].transition_models[to_key] = tmt.from_json(
                json.loads(json.dumps(tmj.to_json(model))))
    return g_j, g_t


@pytest.fixture(scope="module")
def tm_graphs():
    return _tm_graphs()


UNCONSTRAINED_INPUT = {
    "startPose": {"position": [0, 0, 0], "orientation": [0, 0, 0]},
    "elementaryActions": [{"action": "walk", "constraints": []}],
}


@pytest.mark.parametrize("name", ["trajectory", "unconstrained"])
def test_transition_model_request_matches_jax(tm_graphs, name):
    """use_transition_model: after the first step each step draws its pool
    (a trajectory walk) or its one latent (no constraints, 4 steps) from
    the previous edge's conditioned mixture, in JAX and in the port with
    the JAX generator's keys replayed; the whole request holds at the
    request tests' bounds.  Two LM iterations, as the JAX package's own
    test: each step's latent conditions the next step's pool, so the
    LM's rounding compounds along the walk (at 5 iterations a later
    step's latent left the 5e-3 bound)."""
    cfg = default_config()
    cfg.update(use_transition_model=True, n_random_samples=16,
               lm_iterations=2)
    mg_input = WALK_INPUT
    if name == "unconstrained":
        cfg["debug_max_step"] = 3
        mg_input = UNCONSTRAINED_INPUT
    calls = []
    orig = tmj.predict_parameters

    def spy(key, model, x, n=1):
        calls.append(n)
        return orig(key, model, x, n=n)

    try:
        tmj.predict_parameters = spy
        res_j, res_t, _ = tp.request_both(tm_graphs, mg_input, cfg, seed=0)
    finally:
        tmj.predict_parameters = orig
    assert len(res_j.steps) >= 3
    assert calls and all(n == (16 if name == "trajectory" else 1)
                         for n in calls)
    tp.assert_request_matches(res_j, res_t)
