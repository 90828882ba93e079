"""Full-covariance Gaussian mixtures: log-likelihood and its gradient
(port of morphablegraphs_tpu.ops.gmm).

log N_k(x) = -0.5 (D log 2pi + ||W_k^T (x - mu_k)||^2) + log|W_k| with W_k
the precision Cholesky factor; the mixture log-prob is a logsumexp over
components.  Every field may carry leading batch axes (one mixture per
character)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

_LOG_2PI = float(np.log(2.0 * np.pi))


@dataclasses.dataclass
class GMM:
    """weights [..., K]; means [..., K, D]; cov_chol [..., K, D, D] (lower
    Cholesky of the covariances, for sampling); prec_chol [..., K, D, D]
    with Sigma^-1 = W W^T."""

    weights: torch.Tensor
    means: torch.Tensor
    cov_chol: torch.Tensor
    prec_chol: torch.Tensor

    @property
    def n_dims(self) -> int:
        return self.means.shape[-1]


def from_covars(weights, means, covars, device=None) -> GMM:
    """GMM from model-JSON weights/means/covars; float64 numpy
    factorization on the host, float32 tensors on `device`."""
    weights = np.asarray(weights, np.float64)
    means = np.asarray(means, np.float64)
    cov_chol = np.linalg.cholesky(np.asarray(covars, np.float64))
    eye = np.eye(means.shape[-1])
    prec_chol = np.stack([np.linalg.solve(l, eye).T for l in cov_chol])

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    return GMM(t(weights), t(means), t(cov_chol), t(prec_chol))


def _whitened(gmm: GMM, x: torch.Tensor) -> torch.Tensor:
    """y[..., k, :] = (x - mu_k) @ W_k for x [..., D] -> [..., K, D]."""
    diff = x[..., None, :] - gmm.means
    return torch.einsum("...kd,...kde->...ke", diff, gmm.prec_chol)


def _log_det(gmm: GMM) -> torch.Tensor:
    return torch.sum(torch.log(torch.abs(
        torch.diagonal(gmm.prec_chol, dim1=-2, dim2=-1))), dim=-1)


def log_prob_components(gmm: GMM, x: torch.Tensor) -> torch.Tensor:
    """Per-component Gaussian log-density, x [..., D] -> [..., K]."""
    y = _whitened(gmm, x)
    maha = torch.sum(y * y, dim=-1)
    return -0.5 * (gmm.n_dims * _LOG_2PI + maha) + _log_det(gmm)


def _log_w(gmm: GMM) -> torch.Tensor:
    return torch.log(torch.clamp(gmm.weights, min=1e-30))


def log_prob(gmm: GMM, x: torch.Tensor) -> torch.Tensor:
    """Mixture log-density, x [..., D] -> [...]."""
    return torch.logsumexp(log_prob_components(gmm, x) + _log_w(gmm), dim=-1)


def neg_log_prob_and_grad(gmm: GMM, x: torch.Tensor):
    """(-log p(x), d(-log p)/dx) in closed form.

    d log N_k / dx = -W_k y_k with y_k = W_k^T (x - mu_k), so the gradient
    of -log p is sum_k r_k W_k y_k with r = softmax(log w + log N) the
    component responsibilities.  x [..., D] -> ([...], [..., D])."""
    y = _whitened(gmm, x)
    lp = (-0.5 * (gmm.n_dims * _LOG_2PI + torch.sum(y * y, dim=-1))
          + _log_det(gmm) + _log_w(gmm))
    nll = -torch.logsumexp(lp, dim=-1)
    resp = torch.softmax(lp, dim=-1)  # [..., K]
    wy = torch.einsum("...kde,...ke->...kd", gmm.prec_chol, y)
    return nll, torch.einsum("...k,...kd->...d", resp, wy)


def sample(generator: torch.Generator, gmm: GMM, n: int) -> torch.Tensor:
    """n draws [n, D] from one mixture: a component per draw from the
    weights, then mu_k + L_k eps, all from `generator` (on the mixture's
    device).  Distributionally the JAX package's `sample`; its threefry
    stream is not reproduced."""
    comp = torch.multinomial(gmm.weights, n, replacement=True,
                             generator=generator)
    eps = torch.randn((n, gmm.n_dims), generator=generator,
                      dtype=gmm.means.dtype, device=gmm.means.device)
    return gmm.means[comp] + torch.einsum("nde,ne->nd", gmm.cov_chol[comp],
                                          eps)


def score(gmm: GMM, x: torch.Tensor) -> torch.Tensor:
    """Mean log-likelihood over the rows of x [..., N, D] -> [...]."""
    return torch.mean(log_prob(gmm, x), dim=-1)


def sample_one(generator: torch.Generator, gmm: GMM) -> torch.Tensor:
    """One draw [D] (see `sample`)."""
    return sample(generator, gmm, 1)[0]
