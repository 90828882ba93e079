"""Single-exemplar "static" motion primitive (port of
morphablegraphs_tpu.models.static_primitive).

When only one training motion exists, the model is that clip's B-spline
coefficients with one inert latent dimension (every draw returns the clip)
and an optional fixed time function.  Model JSON carrying `spatial_coeffs`
loads through here (`primitive.load_primitive_json` dispatches)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..ops import bspline, gmm as gmm_ops
from .primitive import MotionPrimitive


def load_static_primitive_json(data: Dict[str, Any], name: str = "",
                               device=None) -> MotionPrimitive:
    """A MotionPrimitive whose mean holds the clip's coefficients, whose
    eigenvector column is zero and whose GMM is a near-delta at the zero
    latent, so sampling, back-projection and graph stacking work
    unchanged."""
    coeffs = np.asarray(data["spatial_coeffs"], np.float64)
    if coeffs.ndim == 1:
        coeffs = coeffs.reshape(int(data["n_basis_spatial"]), -1)
    n_basis, n_dim = coeffs.shape
    n_canonical = int(data["n_canonical_frames"])
    knots = np.asarray(data.get("b_spline_knots_spatial",
                                bspline.clamped_knots(n_basis, n_canonical)),
                       np.float64)
    mean_t_d = np.zeros(n_canonical)
    if data.get("time_function"):
        # stored as the exp-sum's log increments, so back_project
        # reproduces the time function
        tf = np.asarray(data["time_function"], np.float64)
        shifted = tf + 1.0
        prev = np.concatenate([[0.0], shifted[:-1]])
        w = np.log(np.maximum(shifted - prev, 1e-6))
        mean_t_d = (w[:n_canonical] if len(w) >= n_canonical else
                    np.concatenate([w, np.zeros(n_canonical - len(w))]))

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return MotionPrimitive(
        eigen_s=t(np.zeros((n_basis * n_dim, 1))), mean_s=t(coeffs.reshape(-1)),
        knots_s=t(knots), mean_t_d=t(mean_t_d),
        eigen_t_d=t(np.zeros((n_canonical, 0))),
        gmm=gmm_ops.from_covars([1.0], np.zeros((1, 1)),
                                np.eye(1)[None] * 1e-8, device=device),
        name=name or str(data.get("name", "")),
        n_basis=n_basis, n_dim=n_dim, n_canonical_frames=n_canonical,
        # has_time always: a zero mean_t_d is the identity exp-sum warp,
        # whose inversion samples the exact integer frame grid (the
        # unwarped linspace(0, F, F) timeline stretches by F / (F - 1))
        n_spatial=1, n_time=0, has_time=True,
        animated_joints=tuple(data.get("animated_joints", ())),
        keyframes=tuple(sorted((str(k), int(v))
                               for k, v in data.get("keyframes", {}).items())))


def make_static_model_json(frames, n_basis: int = 16, name: str = "") -> dict:
    """Static-primitive model JSON from one clip [T, D] (numpy or a tensor;
    the fit runs on the tensor's device, numpy on the CPU).  The basis is
    clamped to the clip length, so a short clip's fit stays determined."""
    y = torch.as_tensor(frames).to(torch.float32)
    t, _ = y.shape
    if t < 4:
        raise ValueError(
            f"static primitive needs >= 4 frames for a cubic B-spline fit "
            f"(got {t})")
    n_basis = min(n_basis, t)
    knots = bspline.clamped_knots(n_basis, t)
    coeffs = bspline.fit_coeffs(
        y, torch.as_tensor(knots, dtype=torch.float32, device=y.device),
        torch.arange(t, dtype=torch.float32, device=y.device))
    return {"name": name,
            "spatial_coeffs": coeffs.cpu().numpy().astype(np.float64).tolist(),
            "n_basis_spatial": n_basis,
            "b_spline_knots_spatial": knots.tolist(),
            "n_canonical_frames": t}
