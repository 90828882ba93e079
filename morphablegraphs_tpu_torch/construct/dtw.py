"""Dynamic time warping over a transform-invariant point-cloud distance
(port of morphablegraphs_tpu.construct.dtw).

The O(N*M*J) pairwise distance grid, training's hot loop, is one batched
closed-form 2D registration over all (i, j) frame pairs in float32 on the
card; the O(N*M) dynamic programme and the path backtracking run in host
numpy, as in the JAX package (sequentially dependent and small), so the
tie-breaking of `find_path` is numpy's argmin order in both.

The distance is Kovar-style: the rotation about Y and the XZ translation
that best align cloud B onto cloud A, then the RMS point distance (the
semantics of anim_utils `_transform_invariant_point_cloud_distance`, which
the reference uses).

`find_optimal_dtw` splits its pair grids over the ranks of a
torch.distributed process group, as the JAX package splits them over a
mesh: the clouds replicated, each rank's contiguous pairs on its own
device, one gather of the grids before the host DP, which every rank runs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils import device as device_mod


def pair_distance(a: torch.Tensor, b: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Transform-invariant distance between point clouds a, b [..., J, 3]
    (broadcast over the leading axes): the closed-form rotation about Y
    and XZ offset minimizing sum w_i ||a_i - T(b_i)||^2 (Kovar et al.
    2002), then the weighted RMS distance."""
    j = a.shape[-2]
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    if weights is None:
        w = torch.full(lead, 1.0 / j, dtype=a.dtype, device=a.device)
    else:
        w = torch.broadcast_to(weights / torch.sum(weights), lead)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    sw = torch.sum(w, -1)
    abar_x = torch.sum(w * ax, -1)
    abar_z = torch.sum(w * az, -1)
    bbar_x = torch.sum(w * bx, -1)
    bbar_z = torch.sum(w * bz, -1)
    num = (torch.sum(w * (ax * bz - bx * az), -1)
           - (abar_x * bbar_z - bbar_x * abar_z) / sw)
    den = (torch.sum(w * (ax * bx + az * bz), -1)
           - (abar_x * bbar_x + abar_z * bbar_z) / sw)
    theta = torch.atan2(num, den)
    ct, st = torch.cos(theta), torch.sin(theta)
    x0 = (abar_x - bbar_x * ct - bbar_z * st) / sw
    z0 = (abar_z + bbar_x * st - bbar_z * ct) / sw
    # T(b): the rotation about Y by theta, then (x0, 0, z0)
    bx_t = ct[..., None] * bx + st[..., None] * bz + x0[..., None]
    bz_t = -st[..., None] * bx + ct[..., None] * bz + z0[..., None]
    d2 = (ax - bx_t) ** 2 + (ay - by) ** 2 + (az - bz_t) ** 2
    return torch.sqrt(torch.sum(w * d2, -1))


def distance_grid(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """All-pairs distance grid: x [N, J, 3], y [M, J, 3] -> [N, M]
    (reference get_distgrid, dtw.py:34-53, without the cumulative pass)."""
    return pair_distance(x[:, None], y[None, :])


def window_mask(n: int, m: int, window: str = "none",
                band: Optional[int] = None) -> np.ndarray:
    """Global path-constraint windows of the legacy DTW class (reference
    preprocessing/motion_dtw.py:213-260; True = cell allowed):

      * "none": no constraint;
      * "sakoechiba": |i - j| <= band (Sakoe & Chiba 1978);
      * "slantedband": |j - i*m/n| <= band, the band around the diagonal
        scaled to the grid's aspect;
      * "itakura": the Itakura parallelogram (local slope between 1/2 and
        2 from both endpoints).
    """
    if window == "none":
        return np.ones((n, m), bool)
    i = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(m)[None, :].astype(np.float64)
    if band is None:
        band = max(1, int(0.1 * max(n, m)))
    if window == "sakoechiba":
        return np.abs(i - j) <= band
    if window == "slantedband":
        return np.abs(j - i * (m - 1) / max(n - 1, 1)) <= band
    if window == "itakura":
        return ((j <= 2 * i + 1) & (i <= 2 * j + 1)
                & (m - 1 - j <= 2 * (n - 1 - i) + 1)
                & (n - 1 - i <= 2 * (m - 1 - j) + 1))
    raise ValueError(f"unknown DTW window: {window}")


def accumulate(grid: np.ndarray, window: str = "none",
               band: Optional[int] = None) -> np.ndarray:
    """Cumulative DP distances (the second half of the reference's
    get_distgrid), cells outside the window at inf."""
    s = np.asarray(grid, np.float64)
    n, m = s.shape
    if window != "none":
        s = np.where(window_mask(n, m, window, band), s, np.inf)
    d = np.zeros_like(s)
    d[0, 0] = s[0, 0]
    d[1:, 0] = np.cumsum(s[1:, 0]) + s[0, 0]
    d[0, 1:] = np.cumsum(s[0, 1:]) + s[0, 0]
    for i in range(1, n):
        row_prev = d[i - 1]
        row = d[i]
        for jj in range(1, m):
            row[jj] = min(row_prev[jj - 1], row_prev[jj],
                          row[jj - 1]) + s[i, jj]
    return d


def find_path(d: np.ndarray) -> List[tuple]:
    """Backtrack the optimal warping path (reference find_path,
    dtw.py:56-75); ties go to numpy's argmin order (diagonal, up, left)."""
    n, m = d.shape
    xi, yi = n - 1, m - 1
    path = [(xi, yi)]
    while xi > 0 or yi > 0:
        if xi == 0:
            yi -= 1
        elif yi == 0:
            xi -= 1
        else:
            candidates = ((xi - 1, yi - 1), (xi - 1, yi), (xi, yi - 1))
            vals = [d[c] for c in candidates]
            xi, yi = candidates[int(np.argmin(vals))]
        path.insert(0, (xi, yi))
    return path


def run_dtw(x: np.ndarray, y: np.ndarray, window: str = "none",
            band: Optional[int] = None, device=None):
    """Full DTW of point clouds x [N, J, 3] and y [M, J, 3]: the grid on
    `device` (CUDA unless named), the DP on the host.  -> (path, the
    cumulative grid)."""
    dev = device_mod.resolve(device, "run_dtw")
    grid = distance_grid(torch.as_tensor(np.asarray(x, np.float32),
                                         device=dev),
                         torch.as_tensor(np.asarray(y, np.float32),
                                         device=dev)).cpu().numpy()
    d = accumulate(grid, window=window, band=band)
    return find_path(d), d


def get_warping_function(path) -> List[int]:
    """Path -> per-reference-frame source index (reference dtw.py:84-113:
    for each x row the LAST matched y index)."""
    warping = {}
    for (xi, yi) in path:
        warping[xi] = yi  # later pairs overwrite: the last index per row
    return [warping[i] for i in range(max(warping) + 1)]


def warp_motion(frames: np.ndarray, warping_function) -> np.ndarray:
    return np.asarray([frames[idx] for idx in warping_function])


def _pad_clouds(point_clouds: Dict):
    """Stack ragged per-motion clouds [T_i, J, 3] into one padded array
    [K, T_max, J, 3] and their lengths (padding rows repeat the last frame
    so their distances stay finite; the DP reads the valid block only)."""
    keys = list(point_clouds.keys())
    lengths = [int(np.shape(point_clouds[k])[0]) for k in keys]
    t_max = max(lengths)
    j = np.shape(point_clouds[keys[0]])[1]
    arr = np.zeros((len(keys), t_max, j, 3), np.float32)
    for i, k in enumerate(keys):
        c = np.asarray(point_clouds[k], np.float32)
        arr[i, : len(c)] = c
        arr[i, len(c):] = c[-1]
    return keys, arr, np.asarray(lengths)


def _pair_grids(clouds: torch.Tensor, a_idx: torch.Tensor,
                b_idx: torch.Tensor) -> torch.Tensor:
    """Distance grids of index pairs: clouds [K, T, J, 3] -> [P, T, T]."""
    return pair_distance(clouds[a_idx][:, :, None], clouds[b_idx][:, None])


# the pairs of one grid launch: one fixed shape for any number of motions,
# and the grids stream back instead of filling [K^2, T, T]
PAIR_CHUNK = 256


def find_optimal_dtw(point_clouds: Dict, mean_key=None, device=None,
                     stats: Optional[dict] = None, group=None) -> Dict:
    """DTW of every motion against a reference (reference
    find_optimal_dtw_async, dtw.py:175-197: with mean_key only that
    reference is tried; otherwise the reference of least total path cost
    wins).  -> {key: path}.

    The pairwise grids, the loop the reference spreads over a process
    pool, are computed in padded chunks of PAIR_CHUNK pairs on `device`
    (CUDA unless named), as the JAX package chunks them; only the small
    sequential DP runs per pair on the host.  Given a torch.distributed
    process `group`, each rank computes its contiguous share of the pairs
    on its own `device` and the grids are gathered to every rank before
    the DP (the pairs padded to a multiple of the ranks by repeating the
    first pair).  `stats`, a dict, gains the
    seconds of the grids ("dtw_grids") and of the DP ("dtw_dp"), and the
    chosen reference's total path cost ("dtw_cost")."""
    import time
    dev = device_mod.resolve(device, "find_optimal_dtw")
    keys = list(point_clouds.keys())
    ref_keys = [mean_key] if mean_key in point_clouds else keys
    keys_p, clouds, lengths = _pad_clouds(point_clouds)
    idx_of = {k: i for i, k in enumerate(keys_p)}
    pairs = [(idx_of[rk], idx_of[k]) for rk in ref_keys for k in keys]
    a_idx = np.asarray([p[0] for p in pairs], np.int64)
    b_idx = np.asarray([p[1] for p in pairs], np.int64)
    from ..parallel.crowd import all_gather_rows, rank_rows
    mine = rank_rows(torch.as_tensor(np.stack([a_idx, b_idx], 1)), group)
    t0 = time.perf_counter()
    clouds_d = torch.as_tensor(clouds, device=dev)
    grid_chunks = []
    for c0 in range(0, len(mine), PAIR_CHUNK):
        ab = mine[c0: c0 + PAIR_CHUNK].to(dev)
        grid_chunks.append(_pair_grids(clouds_d, ab[:, 0], ab[:, 1]).cpu())
    grids = torch.cat(grid_chunks)
    if group is not None:
        grids = all_gather_rows(grids, group)[: len(pairs)]
    grids = grids.numpy()
    t1 = time.perf_counter()

    best_cost, best_results = np.inf, None
    p = 0
    for rk in ref_keys:
        results = {}
        cost = 0.0
        for k in keys:
            g = grids[p][: lengths[idx_of[rk]], : lengths[idx_of[k]]]
            p += 1
            d = accumulate(g)
            results[k] = find_path(d)
            # the total path cost is the last accumulated cell
            cost += float(d[-1, -1])
        if cost < best_cost:
            best_cost, best_results = cost, results
    if stats is not None:
        for k, v in (("dtw_grids", t1 - t0),
                     ("dtw_dp", time.perf_counter() - t1),
                     ("dtw_cost", best_cost)):
            stats[k] = stats.get(k, 0.0) + v
    return best_results
