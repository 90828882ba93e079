"""Temporal fPCA warping (port of morphablegraphs_tpu.ops.timewarp):
t(t') = cumsum(exp(mean_t + T @ gamma)) - 1, inverted by monotone cubic
interpolation onto a fixed frame buffer with a valid-frame count."""

from __future__ import annotations

import functools

import numpy as np
import torch


def interp_cubic(xq: torch.Tensor, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
    """Cubic Hermite interpolation with central-difference slopes on a
    monotone grid.  xq [..., Q]; x, y [..., n] -> [..., Q].

    The interval index is a comparison count; the eight neighbour values
    are gathered (the JAX package's one-hot matmul selects the same values
    exactly)."""
    n = x.shape[-1]
    i = torch.clamp(torch.sum(x[..., None, :] <= xq[..., None], dim=-1) - 1,
                    0, n - 2)

    def at(v, off):
        return torch.gather(v, -1, torch.clamp(i + off, 0, n - 1))

    x0, x1, xm, xp = at(x, 0), at(x, 1), at(x, -1), at(x, 2)
    y0, y1, ym, yp = at(y, 0), at(y, 1), at(y, -1), at(y, 2)
    h = torch.clamp(x1 - x0, min=1e-8)
    t = torch.clamp((xq - x0) / h, 0.0, 1.0)
    m0 = (y1 - ym) / torch.clamp(x1 - xm, min=1e-8)
    m1 = (yp - y0) / torch.clamp(xp - x0, min=1e-8)
    t2 = t * t
    t3 = t2 * t
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return h00 * y0 + h10 * h * m0 + h01 * y1 + h11 * h * m1


def canonical_time_function_masked(mean_t_d: torch.Tensor,
                                   eigen_t_d: torch.Tensor,
                                   gamma: torch.Tensor,
                                   n_canonical: torch.Tensor) -> torch.Tensor:
    """Padded canonical time function: mean_t_d [..., F], eigen_t_d
    [..., F, k_t], gamma [..., k_t], n_canonical [...] -> [..., F];
    increments past n_canonical are zero so the cumsum plateaus."""
    f_max = mean_t_d.shape[-1]
    w = mean_t_d + torch.matmul(eigen_t_d, gamma[..., None])[..., 0]
    mask = torch.arange(f_max, device=w.device) < n_canonical[..., None]
    inc = torch.where(mask, torch.exp(w), torch.zeros_like(w))
    return torch.cumsum(inc, dim=-1) - 1.0


def invert_time_function_dynamic(t_canonical: torch.Tensor,
                                 n_canonical: torch.Tensor, max_frames: int,
                                 speed: float = 1.0):
    """Invert t(t') onto max_frames output slots.  t_canonical [..., F],
    n_canonical [...] int -> (time_function [..., max_frames] float,
    n_frames [...] int32); slots >= n_frames clamp to n_canonical - 1."""
    f_max = t_canonical.shape[-1]
    dt = t_canonical.dtype
    idx = torch.clamp(n_canonical - 2, min=0).long()
    t_end = torch.gather(t_canonical, -1, idx[..., None])[..., 0]
    num = torch.clamp(torch.floor(torch.round(t_end) * (1.0 / speed)),
                      min=1.0)
    n_frames = torch.clamp((num + 2.0).to(torch.int32), max=max_frames)
    i = torch.arange(max_frames, dtype=dt, device=t_canonical.device)
    denom = torch.clamp(num - 1.0, min=1.0)
    interior = 1.0 + (t_end - 1.0)[..., None] * (i - 1.0) / denom[..., None]
    last_can = (n_canonical - 1).to(dt)
    y = torch.minimum(torch.arange(f_max, dtype=dt,
                                   device=t_canonical.device),
                      last_can[..., None])
    tprime = interp_cubic(interior, t_canonical, y)
    out = torch.where(i == 0, torch.zeros_like(tprime), tprime)
    last = (n_frames - 1)[..., None]
    out = torch.where(i >= last, last_can[..., None].expand_as(out), out)
    return out, n_frames


def canonical_time_function(mean_t_d: torch.Tensor, eigen_t_d: torch.Tensor,
                            gamma: torch.Tensor) -> torch.Tensor:
    """One primitive's time function t(t') = cumsum(exp(mean_t + T @ gamma))
    - 1: mean_t_d [F], eigen_t_d [F, k_t], gamma [k_t] -> [F], strictly
    increasing."""
    w = mean_t_d + torch.matmul(eigen_t_d, gamma)
    return torch.cumsum(torch.exp(w), dim=-1) - 1.0


def invert_time_function(t_canonical: torch.Tensor, n_canonical: int,
                         max_frames: int, speed: float = 1.0):
    """Invert one primitive's t(t') onto max_frames output slots: an exact
    0 first frame, round(t[-2]) / speed interior frames at linspace(1,
    t[-2], num), an exact n_canonical - 1 last frame.  Returns
    (time_function [max_frames], n_frames int32 tensor); slots >= n_frames
    clamp to n_canonical - 1."""
    dt = t_canonical.dtype
    t_end = t_canonical[-2]
    num = torch.clamp(torch.floor(torch.round(t_end) * (1.0 / speed)),
                      min=1.0)
    n_frames = torch.clamp((num + 2.0).to(torch.int32), max=max_frames)
    i = torch.arange(max_frames, dtype=dt, device=t_canonical.device)
    denom = torch.clamp(num - 1.0, min=1.0)
    interior = 1.0 + (t_end - 1.0) * (i - 1.0) / denom
    tprime = interp_cubic(interior, t_canonical,
                          torch.arange(n_canonical, dtype=dt,
                                       device=t_canonical.device))
    out = torch.where(i == 0, torch.zeros_like(tprime), tprime)
    out = torch.where(i >= (n_frames - 1),
                      torch.full_like(out, float(n_canonical - 1)), out)
    return out, n_frames


def linear_time_function(n_canonical: int, max_frames: int,
                         speed: float = 1.0, device=None):
    """The canonical (unwarped) timeline linspace(0, F, int(F / speed))
    clamped at F - 1: (time_function [max_frames], n_frames int32
    tensor)."""
    num = int(n_canonical * (1.0 / speed))
    i = torch.arange(max_frames, dtype=torch.float32, device=device)
    vals = torch.clamp(i * (float(n_canonical) / max(num - 1, 1)),
                       max=float(n_canonical - 1))
    return vals, torch.tensor(num, dtype=torch.int32, device=device)


@functools.lru_cache(maxsize=None)
def _savgol_matrices(window: int, polyorder: int):
    """The linear operator of a Savitzky-Golay filter with polynomial edge
    handling (scipy's mode='interp'): (kernel [window], head [half, window],
    tail [half, window])."""
    half = window // 2
    pos = np.arange(-half, half + 1, dtype=np.float64)
    proj = np.linalg.pinv(np.vander(pos, polyorder + 1, increasing=True))
    kernel = proj[0]
    pos_e = np.arange(window, dtype=np.float64)
    proj_e = np.linalg.pinv(np.vander(pos_e, polyorder + 1, increasing=True))
    head = np.vander(np.arange(half, dtype=np.float64),
                     polyorder + 1, increasing=True) @ proj_e
    tail = np.vander(np.arange(window - half, window, dtype=np.float64),
                     polyorder + 1, increasing=True) @ proj_e
    return kernel, head, tail


def savgol_smooth(y: torch.Tensor, window: int = 15,
                  polyorder: int = 3) -> torch.Tensor:
    """Savitzky-Golay filter over the last axis of y [..., N] (identity
    when N < window): the interior a correlation with the kernel, the
    first and last window // 2 samples from a polynomial fit of the end
    windows."""
    n = y.shape[-1]
    if n < window:
        return y
    kernel, head, tail = (torch.as_tensor(m, dtype=y.dtype, device=y.device)
                          for m in _savgol_matrices(window, polyorder))
    interior = torch.matmul(y.unfold(-1, window, 1), kernel)
    hi = torch.matmul(y[..., :window], head.T)
    lo = torch.matmul(y[..., -window:], tail.T)
    return torch.cat([hi, interior, lo], dim=-1)


def smooth_time_function_np(time_function, window: int = 15,
                            polyorder: int = 3) -> np.ndarray:
    """Host numpy form of savgol_smooth for one time function (float64)."""
    tf = np.asarray(time_function, np.float64)
    if tf.shape[-1] < window:
        return tf
    kernel, head, tail = _savgol_matrices(window, polyorder)
    interior = np.correlate(tf, kernel, mode="valid")
    return np.concatenate([head @ tf[:window], interior,
                           tail @ tf[-window:]])


def z_transform(time_functions: torch.Tensor) -> torch.Tensor:
    """The training-side inverse of the exp-sum warp: w(t) = ln(t'(t) -
    t'(t-1)) with the implicit -1 shift prepended.  [..., F] monotone warps
    -> [..., F] log-increment curves."""
    shifted = time_functions + 1.0
    prev = torch.cat([torch.zeros_like(shifted[..., :1]), shifted[..., :-1]],
                     dim=-1)
    return torch.log(torch.clamp(shifted - prev, min=1e-6))
