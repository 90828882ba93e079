"""Batched cubic B-spline basis and evaluation (port of
morphablegraphs_tpu.ops.bspline)."""

from __future__ import annotations

import numpy as np
import torch

DEGREE = 3


def clamped_knots(n_basis: int, n_frames: int) -> np.ndarray:
    """Clamped cubic knot vector over [0, n_frames-1] with n_basis
    coefficients: 4 leading zeros, interior linspace(0, n_frames-1,
    n_basis-2), 4 trailing (n_frames-1).  Float64 numpy, bit-identical to
    the JAX package's (the synthetic models are built from it)."""
    knots = np.zeros(n_basis + DEGREE + 1)
    knots[DEGREE: -DEGREE] = np.linspace(0, n_frames - 1, n_basis - 2)
    knots[-DEGREE:] = n_frames - 1
    return knots


def basis_matrix(knots: torch.Tensor, t: torch.Tensor,
                 degree: int = DEGREE) -> torch.Tensor:
    """Cox-de Boor basis matrix B[..., i, j] = N_{j,degree}(t[..., i]).

    knots: [..., n_knots] (leading axes batch several knot vectors, e.g. one
    per character); t: [..., Q] with the same leading axes.  Queries are
    clamped into [knots[0], knots[-1]] and the last non-empty span is
    closed, so a row sums to 1.  Returns [..., Q, n_basis]."""
    n_basis = knots.shape[-1] - degree - 1
    kn = knots[..., None, :]  # [..., 1, n_knots]
    tmax = kn[..., -1:]
    tc = torch.minimum(torch.maximum(t[..., None], kn[..., :1]), tmax)
    left = kn[..., :-1]
    right = kn[..., 1:]
    is_last_span = right >= tmax
    ge_left = tc >= left
    n0 = torch.where(is_last_span, ge_left & (tc <= right) & (left < right),
                     ge_left & (tc < right)).to(knots.dtype)
    n = n0
    for k in range(1, degree + 1):
        d1 = kn[..., k:-1] - kn[..., : -k - 1]
        d2 = kn[..., k + 1:] - kn[..., 1:-k]
        w1 = torch.where(d1 > 0, (tc - kn[..., : -k - 1])
                         / torch.where(d1 > 0, d1, torch.ones_like(d1)),
                         torch.zeros_like(d1))
        w2 = torch.where(d2 > 0, (kn[..., k + 1:] - tc)
                         / torch.where(d2 > 0, d2, torch.ones_like(d2)),
                         torch.zeros_like(d2))
        n = w1 * n[..., :-1] + w2 * n[..., 1:]
    return n[..., :n_basis]


def evaluate(coeffs: torch.Tensor, knots: torch.Tensor,
             t: torch.Tensor) -> torch.Tensor:
    """Multi-channel B-spline at query times: coeffs [..., n_basis, C],
    knots [..., n_knots], t [..., T] -> [..., T, C]."""
    return torch.matmul(basis_matrix(knots, t), coeffs)


def basis_matrix_np(knots: np.ndarray, t: np.ndarray,
                    degree: int = DEGREE) -> np.ndarray:
    """Float64 numpy twin of `basis_matrix` for host-side loaders."""
    knots = np.asarray(knots, np.float64)
    t = np.asarray(t, np.float64)
    n_basis = knots.shape[0] - degree - 1
    tmax = knots[-1]
    tc = np.clip(t, knots[0], tmax)
    left, right = knots[:-1], knots[1:]
    is_last_span = right >= tmax
    ge_left = tc[..., None] >= left
    lt_right = tc[..., None] < right
    le_right = tc[..., None] <= right
    n = np.where(is_last_span, ge_left & le_right & (left < right),
                 ge_left & lt_right).astype(np.float64)
    for k in range(1, degree + 1):
        d1 = knots[k:-1] - knots[: -k - 1]
        d2 = knots[k + 1:] - knots[1:-k]
        w1 = np.where(d1 > 0, (tc[..., None] - knots[: -k - 1])
                      / np.where(d1 > 0, d1, 1.0), 0.0)
        w2 = np.where(d2 > 0, (knots[k + 1:] - tc[..., None])
                      / np.where(d2 > 0, d2, 1.0), 0.0)
        n = w1 * n[..., :-1] + w2 * n[..., 1:]
    return n[..., :n_basis]


def fit_coeffs(y: torch.Tensor, knots: torch.Tensor, t: torch.Tensor,
               degree: int = DEGREE) -> torch.Tensor:
    """Least-squares B-spline fit min ||B(t) C - y||: samples y [T, C] at
    times t [T] -> coefficients [n_basis, C].  Solved by QR, not the
    normal equations, whose Gram matrix squares the basis's condition
    number; exact where the basis has full column rank (T >= n_basis)."""
    q, r = torch.linalg.qr(basis_matrix(knots, t, degree))
    return torch.linalg.solve_triangular(r, q.T @ y, upper=True)


def basis_matrix_canonical(knots: np.ndarray, n_frames: int,
                           degree: int = DEGREE) -> np.ndarray:
    """The basis at the canonical integer frames 0..n_frames-1 (float64
    numpy, computed on the host)."""
    return basis_matrix_np(knots, np.arange(n_frames), degree)
