"""Functional PCA: B-spline fits and PCA of spatial and temporal data (port
of morphablegraphs_tpu.construct.fpca).

  * the per-sample, per-channel cubic B-spline fit (scipy `splrep` loops
    in the reference) is one batched least-squares solve against the
    clamped basis (`ops.bspline.fit_coeffs`) over every sample on the
    card;
  * the PCA is an SVD of the centred coefficients in host float64 numpy
    with the reference's variance-fraction cut (0.95 by default), as in
    the JAX package, so the eigenvectors' signs are its signs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import bspline, timewarp
from ..utils import device as device_mod


@dataclasses.dataclass
class PCAResult:
    eigenvectors: np.ndarray  # [k, D] rows (the reference's layout)
    mean: np.ndarray  # [D]
    projections: np.ndarray  # [n_samples, k] low-dimensional coordinates
    explained: np.ndarray  # [k] variance ratios


def run_pca(data: np.ndarray, fraction: float = 0.95,
            n_components: Optional[int] = None) -> PCAResult:
    """Centred SVD PCA keeping `fraction` of the variance (reference
    construction/fpca/utils.py:33-54), in host float64."""
    data = np.asarray(data, np.float64)
    mean = data.mean(axis=0)
    centered = data - mean
    u, s, vt = np.linalg.svd(centered, full_matrices=False)
    var = s ** 2
    ratios = var / max(var.sum(), 1e-12)
    if n_components is None:
        cum = np.cumsum(ratios)
        n_components = int(np.searchsorted(cum, fraction) + 1)
        n_components = min(n_components, len(s))
    eig = vt[:n_components]  # [k, D]
    proj = centered @ eig.T
    return PCAResult(eigenvectors=eig, mean=mean, projections=proj,
                     explained=ratios[:n_components])


def fit_functional_data(motions: np.ndarray, n_basis: int,
                        device=None) -> np.ndarray:
    """Batched B-spline fit: motions [n_samples, T, D] -> coefficients
    [n_samples, n_basis, D] (the reference's per-channel splrep), float32
    on `device` (CUDA unless named)."""
    dev = device_mod.resolve(device, "fit_functional_data")
    motions = np.asarray(motions, np.float32)
    n_samples, t, d = motions.shape
    knots = torch.as_tensor(bspline.clamped_knots(n_basis, t),
                            dtype=torch.float32, device=dev)
    ts = torch.arange(t, dtype=torch.float32, device=dev)
    y = torch.as_tensor(motions, device=dev).permute(1, 0, 2).reshape(t, -1)
    coeffs = bspline.fit_coeffs(y, knots, ts)  # [n_basis, n_samples * D]
    return coeffs.reshape(n_basis, n_samples, d).permute(1, 0, 2) \
        .cpu().numpy()


@dataclasses.dataclass
class SpatialFPCAData:
    eigenvectors: np.ndarray  # [k, n_basis * n_dim]
    mean: np.ndarray  # [n_basis * n_dim]
    parameters: np.ndarray  # [n_samples, k]
    n_basis: int
    n_dim: int
    scale_vec: list


def fpca_spatial(motions: np.ndarray, n_basis: int, fraction: float = 0.95,
                 n_components: Optional[int] = None,
                 device=None) -> SpatialFPCAData:
    """Spatial fPCA with the root translation's normalization baked back
    in (reference run_spatial_dimension_reduction,
    motion_model_constructor.py:355-393 and construction/utils.py:114-147).
    motions: [n_samples, T, D] aligned quaternion frames."""
    motions = np.asarray(motions, np.float64)
    n_samples, t, d = motions.shape
    # the root translation scaled to [-1, 1] (scale_vec)
    scale_vec = np.abs(motions[..., :3]).reshape(-1, 3).max(axis=0)
    scale_vec = np.where(scale_vec == 0, 1.0, scale_vec)
    scaled = motions.copy()
    scaled[..., :3] /= scale_vec
    # hemisphere alignment against the first frame of the first motion
    # (reference align_quaternion_frames, construction/utils.py:162): ONE
    # flip per (sample, joint), decided at frame 0, since the loader has
    # sign-fixed each clip sequentially and a flip of a suffix of frames
    # would reintroduce a q -> -q jump the spline fit rings around
    ref = scaled[0, 0]
    n_joints = (d - 3) // 4
    for j in range(n_joints):
        sl = slice(3 + 4 * j, 7 + 4 * j)
        dots0 = np.sum(scaled[:, 0, sl] * ref[sl], axis=-1)  # [n_samples]
        scaled[:, :, sl] = np.where((dots0 < 0)[:, None, None],
                                    -scaled[:, :, sl], scaled[:, :, sl])

    coeffs = fit_functional_data(scaled, n_basis, device)
    flat = coeffs.reshape(n_samples, n_basis * d)
    pca = run_pca(flat, fraction, n_components)

    # the scale baked back into the eigenvectors and the mean (reference
    # scale_root_translation_in_fpca_data): exported models carry
    # translation_maxima == [1, 1, 1]
    eig = pca.eigenvectors.copy()
    mean = pca.mean.copy()
    cols = (np.arange(n_basis)[:, None] * d + np.arange(3)[None]).ravel()
    eig[:, cols] *= np.tile(scale_vec, n_basis)
    mean[cols] *= np.tile(scale_vec, n_basis)
    return SpatialFPCAData(eigenvectors=eig, mean=mean,
                           parameters=pca.projections, n_basis=n_basis,
                           n_dim=d, scale_vec=[1.0, 1.0, 1.0])


@dataclasses.dataclass
class TemporalFPCAData:
    eigenvectors: np.ndarray  # [n_basis, k]
    mean: np.ndarray  # [n_basis]
    parameters: np.ndarray  # [n_samples, k]
    n_basis: int


def monotonic_indices(indices: np.ndarray,
                      epsilon: float = 0.01) -> np.ndarray:
    """Strict monotonicity with fixed endpoints (reference
    fpca_time_semantic.py:84-130).  The forward and backward epsilon
    passes can leave interior values below w[0] after a long constant run
    with a small tail gap; a linear ramp between the endpoints (or to an
    epsilon-per-step ceiling when the end is not above the start) is the
    fallback, always strictly increasing."""
    w = np.asarray(indices, np.float64).copy()
    for i in range(1, len(w) - 1):
        while w[i] <= w[i - 1]:
            w[i] += epsilon
    for i in range(len(w) - 2, 0, -1):
        if w[i] >= w[i + 1]:
            w[i] = w[i + 1] - epsilon
    if np.any(np.diff(w) <= 0):
        hi = w[-1] if w[-1] > w[0] else w[0] + epsilon * (len(w) - 1)
        w = np.linspace(w[0], hi, len(w))
    return w


def fpca_temporal(warping_functions, n_basis: int = 8,
                  n_components: int = 3, device=None) -> TemporalFPCAData:
    """Temporal fPCA: warping functions -> z-transform (on the card) ->
    B-spline fit -> PCA (reference FPCATimeSemantic.functional_pca,
    fpca_time_semantic.py:152-200)."""
    dev = device_mod.resolve(device, "fpca_temporal")
    t_len = max(len(w) for w in warping_functions)
    warps = []
    for w in warping_functions:
        w = monotonic_indices(np.asarray(w, np.float64))
        if len(w) != t_len:  # resampled to the common length
            w = np.interp(np.linspace(0, len(w) - 1, t_len),
                          np.arange(len(w)), w)
            w = monotonic_indices(w)
        warps.append(w)
    curves = timewarp.z_transform(torch.as_tensor(
        np.stack(warps), dtype=torch.float32, device=dev)).cpu().numpy()
    coeffs = fit_functional_data(curves[..., None], n_basis,
                                 dev)[..., 0]  # [n, n_basis]
    n_components = min(n_components, len(curves) - 1) or 1
    pca = run_pca(coeffs, n_components=n_components)
    return TemporalFPCAData(eigenvectors=pca.eigenvectors.T, mean=pca.mean,
                            parameters=pca.projections, n_basis=n_basis)
