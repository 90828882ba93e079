"""Motion primitive: fPCA eigenbases + GMM + B-spline knots (port of
morphablegraphs_tpu.models.primitive: loading, back-projection, sampling).

The translation maxima are baked into the eigenvectors/mean at load time,
so back-projection is reshape(E @ alpha + mu); the temporal mean and
eigensplines are discretized onto the canonical frame grid."""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..ops import bspline, gmm as gmm_ops, kernels, timewarp


@dataclasses.dataclass
class MotionPrimitive:
    eigen_s: torch.Tensor  # [D_s, k_s] spatial eigenvectors (pre-scaled)
    mean_s: torch.Tensor  # [D_s]
    knots_s: torch.Tensor  # [n_basis + 4]
    mean_t_d: torch.Tensor  # [F] temporal mean at canonical frames
    eigen_t_d: torch.Tensor  # [F, k_t] temporal eigensplines at frames
    gmm: gmm_ops.GMM
    name: str = ""
    n_basis: int = 0
    n_dim: int = 0
    n_canonical_frames: int = 0
    n_spatial: int = 0
    n_time: int = 0
    has_time: bool = False
    animated_joints: tuple = ()
    keyframes: tuple = ()  # ((label, canonical frame), ...)

    @property
    def n_latent(self) -> int:
        return self.n_spatial + self.n_time

    def keyframe_for_label(self, label: str) -> Optional[int]:
        for k, v in self.keyframes:
            if k == label:
                return int(v)
        return None

    def to(self, device) -> "MotionPrimitive":
        """The primitive with every tensor on `device`."""
        kw = {f.name: getattr(self, f.name)
              for f in dataclasses.fields(self)}
        for name in ("eigen_s", "mean_s", "knots_s", "mean_t_d",
                     "eigen_t_d"):
            kw[name] = kw[name].to(device)
        kw["gmm"] = gmm_ops.GMM(*(getattr(self.gmm, f.name).to(device)
                                  for f in dataclasses.fields(gmm_ops.GMM)))
        return MotionPrimitive(**kw)


def _bake_translation_scale(eigen: np.ndarray, mean: np.ndarray,
                            maxima: np.ndarray, n_basis: int, n_dim: int):
    """Scale the 3 root-translation rows of every coefficient block by the
    per-axis maxima."""
    eigen = eigen.copy()
    mean = mean.copy()
    for c in range(n_basis):
        for axis in range(3):
            row = c * n_dim + axis
            eigen[row, :] *= maxima[axis]
            mean[row] *= maxima[axis]
    return eigen, mean


def load_primitive_json(data: Dict[str, Any], name: str = "",
                        device=None) -> MotionPrimitive:
    """Build a primitive from a parsed model JSON dict (legacy v1/v2, the
    v3 {sspm, tspm, gmm} schema, or a single-exemplar static primitive's
    `spatial_coeffs`) with its tensors on `device`."""
    if "spatial_coeffs" in data:
        from .static_primitive import load_static_primitive_json
        return load_static_primitive_json(data, name, device=device)
    if "sspm" in data:
        sspm, tspm, gmm_d = data["sspm"], data["tspm"], data["gmm"]
        eigen_s = np.asarray(sspm["eigen"], np.float64).T
        mean_s = np.asarray(sspm["mean"], np.float64)
        n_basis = int(sspm["n_coeffs"])
        n_dim = int(sspm["n_dims"])
        knots_s = np.asarray(sspm["knots"], np.float64)
        animated = tuple(sspm.get("animated_joints", ()))
        maxima = np.ones(3)
        n_canonical = int(round(max(knots_s))) + 1
        weights, means, covars = gmm_d["weights"], gmm_d["means"], \
            gmm_d["covars"]
        t_eigen = np.asarray(tspm.get("eigen", []), np.float64)
        t_mean = np.asarray(tspm.get("mean", []), np.float64)
        t_knots = np.asarray(tspm.get("knots", []), np.float64)
    else:
        eigen_s = np.asarray(data["eigen_vectors_spatial"], np.float64).T
        mean_s = np.asarray(data["mean_spatial_vector"], np.float64)
        n_basis = int(data["n_basis_spatial"])
        n_dim = int(data["n_dim_spatial"])
        knots_s = np.asarray(data["b_spline_knots_spatial"], np.float64)
        animated = tuple(data.get("animated_joints", ()))
        maxima = np.asarray(data.get("translation_maxima", [1.0, 1.0, 1.0]),
                            np.float64)
        n_canonical = int(data["n_canonical_frames"])
        weights, means, covars = data["gmm_weights"], data["gmm_means"], \
            data["gmm_covars"]
        if "eigen_vectors_time" in data:
            t_eigen = np.asarray(data["eigen_vectors_time"], np.float64)
            t_mean = np.asarray(data["mean_time_vector"], np.float64)
            t_knots = np.asarray(data["b_spline_knots_time"], np.float64)
        else:
            t_eigen = np.asarray(
                data.get("eigen_vectors_temporal_semantic", []), np.float64)
            t_mean = np.asarray(
                data.get("mean_temporal_semantic_vector", []), np.float64)
            t_knots = np.asarray(
                data.get("b_spline_knots_temporal_semantic", []), np.float64)

    eigen_s, mean_s = _bake_translation_scale(eigen_s, mean_s, maxima,
                                              n_basis, n_dim)
    if t_eigen.size > 0:
        t_eigen = t_eigen.reshape(t_eigen.shape[0], -1)
        basis_t = bspline.basis_matrix_np(t_knots, np.arange(n_canonical))
        mean_t_d = basis_t @ t_mean
        eigen_t_d = basis_t @ t_eigen
    else:
        mean_t_d = np.zeros(n_canonical)
        eigen_t_d = np.zeros((n_canonical, 0))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return MotionPrimitive(
        eigen_s=t(eigen_s), mean_s=t(mean_s), knots_s=t(knots_s),
        mean_t_d=t(mean_t_d), eigen_t_d=t(eigen_t_d),
        gmm=gmm_ops.from_covars(weights, means, covars, device=device),
        name=name or str(data.get("name", "")), n_basis=n_basis,
        n_dim=n_dim, n_canonical_frames=n_canonical,
        n_spatial=eigen_s.shape[1], n_time=eigen_t_d.shape[1],
        has_time=t_eigen.size > 0, animated_joints=animated,
        keyframes=tuple(sorted((str(k), int(v)) for k, v in
                               data.get("keyframes", {}).items())))


def load_primitive(path: str, device=None) -> MotionPrimitive:
    """Load a `<name>_mm.json` model file onto `device`."""
    with open(path) as f:
        data = json.load(f)
    return load_primitive_json(
        data, os.path.basename(path).replace("_mm.json", ""), device=device)


def back_project_spatial(prim: MotionPrimitive,
                         alpha: torch.Tensor) -> torch.Tensor:
    """Spatial latents alpha [..., k_s] -> B-spline coefficients
    [..., n_basis, n_dim] (E @ alpha + mu, the translation scale baked in
    at load)."""
    coeffs = torch.matmul(alpha, prim.eigen_s.T) + prim.mean_s
    return coeffs.reshape(alpha.shape[:-1] + (prim.n_basis, prim.n_dim))


def back_project_unwarped(prim: MotionPrimitive,
                          alpha: torch.Tensor) -> torch.Tensor:
    """Spatial latents alpha [..., k_s] -> frames [..., F, n_dim] on the
    canonical timeline linspace(0, F, F) (no time warping), the sampling
    the step-length statistics use."""
    coeffs = back_project_spatial(prim, alpha)
    f = prim.n_canonical_frames
    i = torch.arange(f, dtype=torch.float32, device=alpha.device)
    t_fn = torch.clamp(i * (float(f) / max(f - 1, 1)), max=float(f - 1))
    return torch.matmul(bspline.basis_matrix(prim.knots_s, t_fn), coeffs)


def time_function(prim: MotionPrimitive, gamma: torch.Tensor,
                  max_frames: int, speed: float = 1.0):
    """Temporal latents gamma [k_t] -> (time_function [max_frames],
    n_frames int32 tensor): the warped canonical times of the output
    frames."""
    t_can = timewarp.canonical_time_function(prim.mean_t_d, prim.eigen_t_d,
                                             gamma)
    return timewarp.invert_time_function(t_can, prim.n_canonical_frames,
                                         max_frames, speed)


def evaluate_at(prim: MotionPrimitive, s: torch.Tensor,
                t: torch.Tensor) -> torch.Tensor:
    """The spatial spline of latent s [L] at canonical times t [T] ->
    frames [T, n_dim].  On a CUDA device one launch of the frame-emit
    kernel without a previous clip (`kernels.emit_frames`, the basis
    weights inside the kernel); on the CPU its twin."""
    dev = s.device
    frames, _ = kernels.emit_frames(
        s[None, : prim.n_spatial], prim.eigen_s[None], prim.mean_s[None],
        prim.knots_s[None], torch.zeros(1, dtype=torch.long, device=dev),
        t[None].to(torch.float32),
        torch.full((1,), t.shape[0], dtype=torch.int32, device=dev), None,
        False, 0)
    return frames[0]


def back_project(prim: MotionPrimitive, s: torch.Tensor, max_frames: int,
                 use_time: bool = True, speed: float = 1.0):
    """Latent s = (alpha | gamma) [L] -> (frames [max_frames, n_dim],
    n_frames int32 tensor, time_function [max_frames]): the time-warped
    timeline when the primitive has a temporal model and use_time, else the
    canonical one; frames past n_frames repeat the last canonical pose."""
    if prim.has_time and use_time:
        t_fn, n_frames = time_function(
            prim, s[prim.n_spatial: prim.n_spatial + prim.n_time],
            max_frames, speed)
    else:
        t_fn, n_frames = timewarp.linear_time_function(
            prim.n_canonical_frames, max_frames, speed, device=s.device)
    return evaluate_at(prim, s, t_fn), n_frames, t_fn


def sample_latent(generator: torch.Generator, prim: MotionPrimitive,
                  n: int = 1) -> torch.Tensor:
    """n latents [n, L] from the primitive's GMM, drawn from `generator`."""
    return gmm_ops.sample(generator, prim.gmm, n)


def sample_frames(generator: torch.Generator, prim: MotionPrimitive,
                  max_frames: int, use_time: bool = True,
                  speed: float = 1.0):
    """One GMM draw back-projected: (frames [max_frames, n_dim], n_frames,
    time_function), as `back_project`."""
    return back_project(prim, sample_latent(generator, prim, 1)[0],
                        max_frames, use_time, speed)
