"""Full-covariance GMM training: EM with BIC model selection (port of
morphablegraphs_tpu.construct.gmm_trainer).

The k-means++ seeding runs on the host with numpy's generator, so it picks
the JAX package's centres for the same data and seed; the EM iterations run
on the device of a tensor's data, or for numpy data on `device` (the CUDA
device unless the caller names another: `utils/device.resolve`), with
sklearn GaussianMixture's full-covariance semantics, in float64 where the
JAX package runs float32: a transition model's pairs have rank-deficient
covariances, which only the 1e-6 regularization keeps positive definite,
and float32 rounding of a covariance (~1e-7 of its norm) exceeds it (on an
H100 the float32 fits of the reference-scale edges lost a Cholesky factor
and turned to NaN, where the same data on the CPU did not)."""

from __future__ import annotations

import numpy as np
import torch

from ..ops import gmm as gmm_ops
from ..utils import device as device_mod

_REG_COVAR = 1e-6  # sklearn's default regularization
# the JAX package's floor of a component's responsibility mass: 10 float32
# epsilons
_NK_FLOOR = 10 * float(np.finfo(np.float32).eps)


def _kmeanspp_init(rng: np.random.Generator, x: np.ndarray,
                   k: int) -> np.ndarray:
    n = x.shape[0]
    centers = [x[rng.integers(n)]]
    for _ in range(1, k):
        d2 = np.min(np.stack([np.sum((x - c) ** 2, axis=1)
                              for c in centers]), axis=0)
        total = d2.sum()
        if total <= 1e-12:
            # every point coincides with a centre (duplicate rows): d2 /
            # total is no distribution, so choose uniformly
            centers.append(x[rng.integers(n)])
            continue
        centers.append(x[rng.choice(n, p=d2 / total)])
    return np.stack(centers)


def _em(x: torch.Tensor, w: torch.Tensor, mu: torch.Tensor,
        cov: torch.Tensor, n_iters: int = 100):
    """n_iters EM iterations from (w, mu, cov) -> (weights, means, covars,
    the data log-likelihood of the last E-step as a 0-d tensor), in the
    dtype of the inputs.  A component whose covariance does not factor
    turns to NaN (the JAX package's Cholesky)."""
    n, d = x.shape
    eye = torch.eye(d, dtype=x.dtype, device=x.device)
    ll = torch.zeros((), dtype=x.dtype, device=x.device)
    for _ in range(n_iters):
        chol, info = torch.linalg.cholesky_ex(cov + _REG_COVAR * eye)
        chol = torch.where((info != 0)[:, None, None],
                           torch.full_like(chol, float("nan")), chol)
        prec_chol = torch.linalg.solve_triangular(
            chol, eye.expand_as(cov), upper=False).transpose(-1, -2)
        g = gmm_ops.GMM(w, mu, chol, prec_chol)
        log_resp = (gmm_ops.log_prob_components(g, x)
                    + torch.log(torch.clamp(w, min=1e-30)))  # [n, K]
        log_norm = torch.logsumexp(log_resp, dim=-1, keepdim=True)
        resp = torch.exp(log_resp - log_norm)
        nk = torch.sum(resp, dim=0) + _NK_FLOOR
        w = nk / n
        mu = (resp.T @ x) / nk[:, None]
        diff = x[None, :, :] - mu[:, None, :]  # [K, n, d]
        cov = (torch.einsum("kne,knf->kef", diff * resp.T[:, :, None], diff)
               / nk[:, None, None] + _REG_COVAR * eye)
        ll = torch.sum(log_norm)
    return w, mu, cov, ll


def data_device(x, device=None) -> torch.device:
    """Where the EM of x runs: a tensor's own device, else `device`
    resolved (CUDA unless named; an error without a card)."""
    if isinstance(x, torch.Tensor):
        return x.device
    return device_mod.resolve(device, "the GMM trainer")


def fit_gmm(x, k: int, seed: int = 0, n_iters: int = 100, device=None):
    """One k-component mixture of the rows of x [N, D] (a tensor: EM on
    its device; numpy: on `device`; float64 either way).  -> (weights,
    means, covars as float64 numpy, the log-likelihood)."""
    dev = data_device(x, device)
    x_np = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x)).astype(np.float64)
    n, d = x_np.shape
    means0 = _kmeanspp_init(np.random.default_rng(seed), x_np, k)
    base_cov = (np.cov(x_np.T).reshape(d, d) if n > 1 else np.eye(d))
    base_cov = np.nan_to_num(base_cov, nan=0.0)
    cov0 = np.tile(base_cov + max(_REG_COVAR, 1e-3) * np.eye(d), (k, 1, 1))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64), device=dev)

    w, mu, cov, ll = _em(t(x_np), t(np.full(k, 1.0 / k)), t(means0), t(cov0),
                         n_iters=n_iters)
    return w.cpu().numpy(), mu.cpu().numpy(), cov.cpu().numpy(), float(ll)


def bic(ll: float, n: int, d: int, k: int) -> float:
    n_params = k * d + k * d * (d + 1) / 2 + (k - 1)
    return -2.0 * ll + n_params * np.log(n)


def train(x, max_k: int = 40, seed: int = 0, device=None) -> dict:
    """Fit K = 1..max_k mixtures (seed + K each; on the device `fit_gmm`
    picks) and keep the lowest BIC.  -> the model-JSON fields
    {gmm_weights, gmm_means, gmm_covars}."""
    dev = data_device(x, device)
    n, d = x.shape
    max_k = max(1, min(max_k, n - 1 if n > 1 else 1))
    best = None
    for k in range(1, max_k + 1):
        w, mu, cov, ll = fit_gmm(x, k, seed=seed + k, device=dev)
        b = bic(ll, n, d, k)
        if best is None or b < best[0]:
            best = (b, w, mu, cov)
    _, w, mu, cov = best
    return {"gmm_weights": w.tolist(), "gmm_means": mu.tolist(),
            "gmm_covars": cov.tolist()}
