"""Scaled functional PCA: per-joint weights optimized for the Cartesian
error (port of morphablegraphs_tpu.construct.scaled_fpca).

Replaces reference construction/fpca/scaled_fpca.py:43-149
(ScaledFunctionalPCA) and objective_functions.py:33-80
(sfpca_objective_func).  The reference files cannot be imported (they
need `motion_analysis.prepare_data` and `utilities.custom_math`, which are
not in its repository), so the objective follows the documented STEPS of
`sfpca_objective_func`:

1. weight the quaternion functional coefficients (one weight per joint and
   per root translation channel, expanded to the full channel vector);
2. PCA of the weighted coefficients, reconstructed from npc components;
3. un-weight the reconstruction and take it to Cartesian space;
4. the mean squared Cartesian distance to the unreconstructed data.

The objective is one differentiable torch function (diagonal weighting ->
SVD PCA reconstruction -> B-spline evaluation -> batched FK -> mean
squared point distance) on the card, and the weights are optimized by
`torch.optim.Adam` on a softplus parametrization (the reference's SLSQP
bounds (1e-4, inf), scaled_fpca.py:107) with exact gradients.  optax's
Adam, which the JAX package runs, and torch's share the update rule and
every default: beta1 0.9, beta2 0.999, and eps 1e-8 added to sqrt(v_hat).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.skeleton import Skeleton, fk_positions
from ..ops import bspline
from ..utils import device as device_mod

LEN_CARTESIAN = 3  # root translation channels
LEN_QUAT = 4


def expand_weights(weights: torch.Tensor, n_joints: int) -> torch.Tensor:
    """[3 + J] per-group weights -> the [3 + 4J] per-channel vector
    (reference objective_functions.py:49-57)."""
    root = weights[:LEN_CARTESIAN]
    joints = torch.repeat_interleave(
        weights[LEN_CARTESIAN:LEN_CARTESIAN + n_joints], LEN_QUAT)
    return torch.cat([root, joints])


def _pca_reconstruct(flat: torch.Tensor, npc: int):
    """Centre -> SVD -> npc components -> back-projection
    (differentiable).  -> (projections [n, npc], reconstruction [n, D])."""
    mean = torch.mean(flat, dim=0)
    x = flat - mean
    _, _, vt = torch.linalg.svd(x, full_matrices=False)
    v = vt[:npc].T  # [D, npc]
    proj = x @ v
    return proj, proj @ v.T + mean


def _normalize_quats(frames: torch.Tensor, n_joints: int) -> torch.Tensor:
    root = frames[..., :LEN_CARTESIAN]
    q = frames[..., LEN_CARTESIAN:].reshape(frames.shape[:-1]
                                            + (n_joints, 4))
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                        min=1e-8)
    return torch.cat([root, q.reshape(frames.shape[:-1]
                                      + (4 * n_joints,))], dim=-1)


def sfpca_objective(weights: torch.Tensor, coeffs: torch.Tensor,
                    knots: torch.Tensor, skeleton: Skeleton, npc: int,
                    n_eval: int = 20) -> torch.Tensor:
    """The Cartesian reconstruction error of the weighted-PCA
    reconstruction: coeffs [n_samples, n_basis, 3 + 4J] B-spline
    coefficients, each motion and its npc-component reconstruction
    evaluated at n_eval canonical times and put through batched FK; the
    mean squared joint-position distance (a 0-d tensor, differentiable
    in weights)."""
    n, b, d = coeffs.shape
    n_joints = (d - LEN_CARTESIAN) // LEN_QUAT
    ext = expand_weights(weights, n_joints)

    weighted = (coeffs * ext).reshape(n, b * d)
    _, recon_flat = _pca_reconstruct(weighted, npc)
    recon = recon_flat.reshape(n, b, d) / ext

    t = torch.linspace(float(knots[3]), float(knots[-4]), n_eval,
                       dtype=coeffs.dtype, device=coeffs.device)
    frames_ref = bspline.evaluate(coeffs, knots, t)
    frames_rec = bspline.evaluate(recon, knots, t)
    # normalized quaternions, so the FK sees rotations in both
    pos_ref = fk_positions(skeleton, _normalize_quats(frames_ref, n_joints))
    pos_rec = fk_positions(skeleton, _normalize_quats(frames_rec, n_joints))
    return torch.mean(torch.sum((pos_ref - pos_rec) ** 2, dim=-1))


def _tensors(coeffs, knots, device):
    dev = device_mod.resolve(device, "scaled fPCA")
    return (torch.as_tensor(np.asarray(coeffs, np.float32), device=dev),
            torch.as_tensor(np.asarray(knots, np.float32), device=dev))


def heuristic_initialization(coeffs: np.ndarray, knots: np.ndarray,
                             skeleton: Skeleton, npc: int,
                             device=None) -> np.ndarray:
    """The better of all-ones and root-normalized starting weights
    (reference scaled_fpca.py:84-96 heuristic_initialization)."""
    c, k = _tensors(coeffs, knots, device)
    n_joints = (coeffs.shape[2] - LEN_CARTESIAN) // LEN_QUAT
    ones = np.ones(LEN_CARTESIAN + n_joints)
    root_scale = np.max(np.abs(coeffs[..., :LEN_CARTESIAN]), axis=(0, 1))
    root_norm = ones.copy()
    root_norm[:LEN_CARTESIAN] = 1.0 / np.maximum(root_scale, 1e-8)

    def score(w):
        with torch.no_grad():
            return float(sfpca_objective(
                torch.as_tensor(w, dtype=torch.float32, device=c.device),
                c, k, skeleton, npc))
    return root_norm if score(ones) > score(root_norm) else ones


def optimize_weights(coeffs: np.ndarray, knots: np.ndarray,
                     skeleton: Skeleton, npc: int, n_iters: int = 100,
                     learning_rate: float = 0.05,
                     init: Optional[np.ndarray] = None,
                     device=None) -> Tuple[np.ndarray, float]:
    """Optimize the per-joint weights (reference scaled_fpca.py:102-121
    optimize_weights: SLSQP there, Adam on softplus-bounded weights here)
    on `device` (CUDA unless named).  -> (weights [3 + n_joints], the
    final Cartesian MSE)."""
    c, k = _tensors(coeffs, knots, device)
    if init is None:
        init = heuristic_initialization(coeffs, knots, skeleton, npc,
                                        c.device)
    # the inverse of the whole parametrization w = softplus(theta) + 1e-4,
    # so the optimization starts exactly at `init`
    init_arr = np.maximum(np.asarray(init, np.float64), 2e-4)
    theta = torch.tensor(np.log(np.expm1(init_arr - 1e-4)),
                         dtype=torch.float32, device=c.device,
                         requires_grad=True)

    def loss(th):
        w = torch.nn.functional.softplus(th) + 1e-4  # the lower bound
        return sfpca_objective(w, c, k, skeleton, npc)

    opt = torch.optim.Adam([theta], lr=learning_rate)
    for _ in range(n_iters):
        opt.zero_grad()
        loss(theta).backward()
        opt.step()
    with torch.no_grad():
        w = (torch.nn.functional.softplus(theta) + 1e-4).cpu().numpy()
        return w, float(loss(theta))


class ScaledFunctionalPCA:
    """The reference class's surface (scaled_fpca.py:43-149):
    heuristic_initialization / initialize_weights / optimize_weights /
    fit, on `device` (CUDA unless named)."""

    def __init__(self, functional_motion_data: np.ndarray, knots: np.ndarray,
                 skeleton: Skeleton, npc: int, device=None):
        self.data = np.asarray(functional_motion_data, np.float32)
        self.knots = np.asarray(knots, np.float32)
        self.skeleton = skeleton
        self.npc = npc
        self.device = device_mod.resolve(device, "ScaledFunctionalPCA")
        n_joints = (self.data.shape[2] - LEN_CARTESIAN) // LEN_QUAT
        self.weight_vec = np.ones(LEN_CARTESIAN + n_joints)

    def heuristic_initialization(self):
        self.weight_vec = heuristic_initialization(
            self.data, self.knots, self.skeleton, self.npc, self.device)

    def initialize_weights(self, weight_vec: Optional[np.ndarray] = None):
        if weight_vec is not None:
            self.weight_vec = np.asarray(weight_vec)

    def optimize_weights(self, n_iters: int = 100):
        self.weight_vec, err = optimize_weights(
            self.data, self.knots, self.skeleton, self.npc,
            n_iters=n_iters, init=self.weight_vec, device=self.device)
        return err

    def fit(self):
        """The weighted PCA with the current weights, the same weighting,
        PCA and back-projection as the objective's: -> (projections
        [n, npc], reconstruction [n, n_basis, D])."""
        n, b, d = self.data.shape
        n_joints = (d - LEN_CARTESIAN) // LEN_QUAT
        data = torch.as_tensor(self.data, device=self.device)
        ext = expand_weights(torch.tensor(
            self.weight_vec, dtype=torch.float32, device=self.device),
            n_joints)
        proj, recon_flat = _pca_reconstruct((data * ext).reshape(n, b * d),
                                            self.npc)
        recon = recon_flat.reshape(n, b, d) / ext
        return proj.cpu().numpy(), recon.cpu().numpy()
