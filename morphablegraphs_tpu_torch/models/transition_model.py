"""Conditional-GMM transition models (port of
morphablegraphs_tpu.models.transition_model).

One full-covariance mixture over concatenated (previous latent, next
latent) pairs is fitted per standard edge and conditioned on the previous
latent at run time:

    mean_y|x  = mu_y + Sigma_yx Sigma_xx^-1 (x - mu_x)
    Sigma_y|x = Sigma_yy - Sigma_yx Sigma_xx^-1 Sigma_xy   (constant)
    w_k|x    ~ w_k N(x; mu_x_k, Sigma_xx_k)

The conditional covariances and every Cholesky factor are computed once
on the host (float64 numpy) at fit or load time; `predict` is a few
batched tensor ops on the model's device."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import bspline, gmm as gmm_ops


@dataclasses.dataclass
class ConditionalGMM:
    """Joint GMM over (x, y), factored for conditioning on x.

    weights [K]; mu_x [K, Dx]; mu_y [K, Dy]; cov_chol_x, prec_chol_x
    [K, Dx, Dx] (lower Cholesky of Sigma_xx and W with Sigma_xx^-1 = W W^T);
    reg [K, Dy, Dx] (Sigma_yx Sigma_xx^-1); cond_cov_chol, cond_prec_chol
    [K, Dy, Dy] (the same two factors of Sigma_y|x)."""

    weights: torch.Tensor
    mu_x: torch.Tensor
    mu_y: torch.Tensor
    cov_chol_x: torch.Tensor
    prec_chol_x: torch.Tensor
    reg: torch.Tensor
    cond_cov_chol: torch.Tensor
    cond_prec_chol: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.weights.shape[-1]

    @property
    def n_in(self) -> int:
        return self.mu_x.shape[-1]

    @property
    def n_out(self) -> int:
        return self.mu_y.shape[-1]

    def to(self, device) -> "ConditionalGMM":
        return ConditionalGMM(*(getattr(self, f.name).to(device)
                                for f in dataclasses.fields(self)))


def _prec_chol(cov_chol: np.ndarray) -> np.ndarray:
    """W = L^-T per component."""
    eye = np.eye(cov_chol.shape[-1])
    return np.stack([np.linalg.solve(l, eye).T for l in cov_chol])


def _model(device, **fields) -> ConditionalGMM:
    return ConditionalGMM(**{k: torch.as_tensor(np.asarray(v, np.float32),
                                                device=device)
                             for k, v in fields.items()})


def from_joint(weights, means, covars, n_in: int,
               device=None) -> ConditionalGMM:
    """Factor a joint mixture (x ++ y layout) for conditioning on its first
    n_in dims, on the host; the tensors go to `device`."""
    weights = np.asarray(weights, np.float64)
    means = np.asarray(means, np.float64)
    covars = np.asarray(covars, np.float64)
    s_xx = covars[:, :n_in, :n_in]
    s_yx = covars[:, n_in:, :n_in]
    s_yy = covars[:, n_in:, n_in:]
    d_y = s_yy.shape[-1]
    reg = np.stack([np.linalg.solve(s_xx[k].T, s_yx[k].T).T
                    for k in range(len(weights))])
    cond = s_yy - np.einsum("kij,klj->kil", reg, s_yx)
    # symmetrize and regularize before factoring (float64 solve noise)
    cond = 0.5 * (cond + np.swapaxes(cond, -1, -2)) + 1e-6 * np.eye(d_y)
    s_xx = 0.5 * (s_xx + np.swapaxes(s_xx, -1, -2)) + 1e-6 * np.eye(n_in)
    cov_chol_x = np.linalg.cholesky(s_xx)
    cond_chol = np.linalg.cholesky(cond)
    return _model(device, weights=weights, mu_x=means[:, :n_in],
                  mu_y=means[:, n_in:], cov_chol_x=cov_chol_x,
                  prec_chol_x=_prec_chol(cov_chol_x), reg=reg,
                  cond_cov_chol=cond_chol,
                  cond_prec_chol=_prec_chol(cond_chol))


def fit_transition_model(x, y, n_components: int = 0, max_k: int = 8,
                         seed: int = 0, device=None) -> ConditionalGMM:
    """Fit from (previous latent, next latent) pairs x [N, Dx], y [N, Dy]
    (tensors: EM and the model on their device; numpy: on `device`, the
    CUDA device unless named).  n_components=0 selects K by BIC up to
    max_k."""
    from ..construct import gmm_trainer
    dev = gmm_trainer.data_device(x, device)
    if isinstance(x, torch.Tensor):
        joint = torch.cat([x, y], dim=1)
    else:
        joint = np.concatenate([np.asarray(x, np.float64),
                                np.asarray(y, np.float64)], axis=1)
    if n_components > 0:
        w, mu, cov, _ = gmm_trainer.fit_gmm(joint, n_components, seed=seed,
                                            device=dev)
    else:
        fields = gmm_trainer.train(joint, max_k=max_k, seed=seed, device=dev)
        w, mu, cov = (fields["gmm_weights"], fields["gmm_means"],
                      fields["gmm_covars"])
    return from_joint(w, mu, cov, n_in=x.shape[1], device=dev)


def predict(model: ConditionalGMM, x: torch.Tensor) -> gmm_ops.GMM:
    """The mixture over y conditioned on x [Dx], on the model's device."""
    x = torch.as_tensor(x, dtype=torch.float32, device=model.weights.device)
    marg = gmm_ops.GMM(model.weights, model.mu_x, model.cov_chol_x,
                       model.prec_chol_x)
    log_w = (gmm_ops.log_prob_components(marg, x)
             + torch.log(torch.clamp(model.weights, min=1e-30)))  # [K]
    log_w = log_w - torch.logsumexp(log_w, dim=-1)
    means = model.mu_y + torch.einsum("kij,kj->ki", model.reg,
                                      x[None, :] - model.mu_x)
    return gmm_ops.GMM(torch.exp(log_w), means, model.cond_cov_chol,
                       model.cond_prec_chol)


def predict_parameters(generator: torch.Generator, model: ConditionalGMM,
                       x: torch.Tensor, n: int = 1) -> torch.Tensor:
    """n next-step latents [n, Dy] drawn from the conditioned mixture."""
    return gmm_ops.sample(generator, predict(model, x), n)


def to_json(model: ConditionalGMM) -> dict:
    """The JSON-friendly form a graph zip stores (the JAX package's)."""
    def lst(t):
        return t.detach().cpu().numpy().tolist()
    return {"type": "conditional_gmm", "n_in": int(model.n_in),
            "weights": lst(model.weights), "mu_x": lst(model.mu_x),
            "mu_y": lst(model.mu_y), "cov_chol_x": lst(model.cov_chol_x),
            "reg": lst(model.reg), "cond_cov_chol": lst(model.cond_cov_chol)}


def from_json(data: dict, device=None) -> ConditionalGMM:
    if data.get("type") != "conditional_gmm":
        raise ValueError(f"unknown transition model type {data.get('type')!r}"
                         " (the reference's pickled .GPM blobs depend on an"
                         " unshipped package and cannot be loaded)")
    cov_chol_x = np.asarray(data["cov_chol_x"], np.float64)
    cond_chol = np.asarray(data["cond_cov_chol"], np.float64)
    return _model(device, weights=data["weights"], mu_x=data["mu_x"],
                  mu_y=data["mu_y"], cov_chol_x=cov_chol_x,
                  prec_chol_x=_prec_chol(cov_chol_x), reg=data["reg"],
                  cond_cov_chol=cond_chol,
                  cond_prec_chol=_prec_chol(cond_chol))


def _match_boundary_poses(xe: torch.Tensor, yst: torch.Tensor) -> torch.Tensor:
    """argmin_j ||xe_i - yst_j||^2 through the matmul expansion: one
    [N, M] grid, not an [N, M, C] difference."""
    d = (torch.sum(xe * xe, dim=1)[:, None] + torch.sum(yst * yst, dim=1)[None]
         - 2.0 * xe @ yst.T)
    return torch.argmin(d, dim=1)


def _boundary_pose(prim, latents: torch.Tensor, t: float) -> torch.Tensor:
    """The spatial spline of each latent [N, L] at canonical time t ->
    [N, n_dim]."""
    from .primitive import back_project_spatial
    coeffs = back_project_spatial(prim, latents[:, : prim.n_spatial])
    b = bspline.basis_matrix(prim.knots_s, torch.tensor(
        [t], dtype=torch.float32, device=latents.device))  # [1, n_basis]
    return torch.matmul(b, coeffs)[:, 0]


def fit_transition_models_for_graph(graph, n_pairs: int = 2000,
                                    n_components: int = 4, seed: int = 0):
    """Fit a model for every standard edge from self-supervised pairs: n_pairs
    latents of the source node's mixture, each paired with the draw of the
    target's mixture whose first pose (root-relative channels) lies closest
    to its last.  Draws come from a torch.Generator seeded with `seed` on
    the primitives' device, where the fit runs too; they differ from the
    JAX package's threefry draws.  Writes node.transition_models and
    returns the graph."""
    from .graph import NODE_TYPE_STANDARD
    from .primitive import sample_latent
    gens = {}
    for from_key, node in graph.nodes.items():
        for to_key in node.edges_of_type(NODE_TYPE_STANDARD):
            src, dst = node.primitive, graph.nodes[to_key].primitive
            dev = src.mean_s.device
            gen = gens.setdefault(dev, torch.Generator(device=dev).manual_seed(
                seed))
            xs = sample_latent(gen, src, n_pairs)
            ys = sample_latent(gen, dst, n_pairs)
            x_end = _boundary_pose(src, xs, src.n_canonical_frames - 1.0)
            y_start = _boundary_pose(dst, ys, 0.0)
            match = _match_boundary_poses(x_end[:, 3:], y_start[:, 3:])
            node.transition_models[to_key] = fit_transition_model(
                xs, ys[match], n_components=n_components, seed=seed,
                device=dev)
    return graph
