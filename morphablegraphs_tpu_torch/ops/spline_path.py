"""Arc-length parameterized Catmull-Rom trajectory splines (port of
morphablegraphs_tpu.ops.spline_path).

A PathSpline may carry leading axes: [C] for one path per character, or
[C, J] for a trajectory-set constraint's stack of one spline per joint.
Every query takes matching leading axes on its arguments.  Splines built
with the same max_points and granularity have leaves of the same shapes and
stack (`stack_paths`, `stack_host`)."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .consts import constant

GRANULARITY = 1000  # reference ParameterizedSpline granularity
MAX_PATH_POINTS = 32  # default padded control-point capacity of `build`

_CR_BASE = ((-1.0, 3.0, -3.0, 1.0),
            (2.0, -5.0, 4.0, -1.0),
            (-1.0, 0.0, 1.0, 0.0),
            (0.0, 2.0, 0.0, 0.0))


@dataclasses.dataclass
class PathSpline:
    """Padded Catmull-Rom spline + arc-length table."""

    points: torch.Tensor  # [..., P_max + 3, 3] extended control points
    n_points: torch.Tensor  # [...] int32 true control point count
    table_u: torch.Tensor  # [..., G+1] parameter grid
    table_arc: torch.Tensor  # [..., G+1] cumulative arc length
    table_points: torch.Tensor  # [..., G+1, 3] spline points at the grid
    unconstrained: torch.Tensor  # [..., 3] bool mask of unconstrained dims

    @property
    def full_arc_length(self) -> torch.Tensor:
        return self.table_arc[..., -1]

    def dim_mask(self) -> torch.Tensor:
        """[..., 3] float mask: 0 on unconstrained dims, else 1."""
        return (~self.unconstrained).to(self.table_points.dtype)

    def to(self, device) -> "PathSpline":
        return PathSpline(**{f.name: getattr(self, f.name).to(device)
                             for f in dataclasses.fields(self)})


def from_jax_numpy(sp, device=None) -> PathSpline:
    """A spline with numpy leaves (the JAX package's, or a host-side one of
    `stack_host`) -> the port's PathSpline of tensors."""
    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)
    return PathSpline(points=t(sp.points, torch.float32),
                      n_points=t(sp.n_points, torch.int32),
                      table_u=t(sp.table_u, torch.float32),
                      table_arc=t(sp.table_arc, torch.float32),
                      table_points=t(sp.table_points, torch.float32),
                      unconstrained=t(sp.unconstrained, torch.bool))


def map_leaves(sp: PathSpline, fn) -> PathSpline:
    """The spline with fn applied to every leaf."""
    return PathSpline(**{f.name: fn(getattr(sp, f.name))
                         for f in dataclasses.fields(PathSpline)})


def _check_stackable(paths):
    shapes = {tuple(np.shape(getattr(p, f.name))
                    for f in dataclasses.fields(PathSpline)) for p in paths}
    if len(shapes) > 1:
        raise ValueError("splines stack only when built with the same "
                         "max_points and granularity")


def stack_paths(paths) -> PathSpline:
    """Stack per-character PathSplines along a new leading axis."""
    _check_stackable(paths)
    return PathSpline(**{f.name: torch.stack([getattr(p, f.name)
                                              for p in paths])
                         for f in dataclasses.fields(PathSpline)})


def stack_host(paths) -> PathSpline:
    """Stack PathSplines along a new leading axis as numpy leaves (the
    host-side form of a constraint set's spline stack)."""
    _check_stackable(paths)
    return PathSpline(**{f.name: np.stack([np.asarray(getattr(p, f.name))
                                           for p in paths])
                         for f in dataclasses.fields(PathSpline)})


def _gather_last(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [..., G] at integer positions idx [..., Q] -> [..., Q]."""
    return torch.gather(table, -1, idx.long())


def _eval_u(points: torch.Tensor, n_points: torch.Tensor,
            u: torch.Tensor) -> torch.Tensor:
    """Catmull-Rom point at u in [0, 1].  points [..., P+3, 3], n_points
    [...], u [..., Q] -> [..., Q, 3]."""
    n_seg = torch.clamp(n_points - 1, min=1).to(u.dtype)[..., None]
    scaled = torch.clamp(u, 0.0, 1.0) * n_seg
    hi = (n_points - 2).long()[..., None]
    idx = torch.minimum(torch.clamp(torch.floor(scaled).long(), min=0), hi)
    local = scaled - idx.to(u.dtype)
    lead = points.shape[:-2]
    q = idx.shape[-1]
    gathered = [torch.gather(points, -2, (idx + o)[..., None].expand(
        lead + (q, 3))) for o in range(4)]
    p = torch.stack(gathered, dim=-2)  # [..., Q, 4, 3]
    w = torch.stack([local ** 3, local ** 2, local, torch.ones_like(local)],
                    dim=-1)  # [..., Q, 4]
    coef = torch.matmul(w, constant(_CR_BASE, torch.float32,
                                    points.device))  # [..., Q, 4]
    return 0.5 * torch.sum(coef[..., None] * p, dim=-2)


def _tangent_u(points, n_points, u, eps: float = 5e-4) -> torch.Tensor:
    a = _eval_u(points, n_points, torch.clamp(u - eps, 0.0, 1.0))
    b = _eval_u(points, n_points, torch.clamp(u + eps, 0.0, 1.0))
    d = b - a
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-10)


def build(control_points, max_points: int = MAX_PATH_POINTS,
          unconstrained_dims=(), granularity: int = GRANULARITY,
          device=None) -> PathSpline:
    """Build a PathSpline from control points [P, 3]: pad to max_points and
    tabulate granularity+1 arc-length samples."""
    cp = np.asarray(control_points, np.float32)
    p = cp.shape[0]
    if p < 2:
        raise ValueError("need at least 2 control points")
    if p > max_points:
        raise ValueError(f"too many control points ({p} > {max_points})")
    ext = np.concatenate([cp[:1], cp, cp[-1:], cp[-1:]], axis=0)
    padded = np.zeros((max_points + 3, 3), np.float32)
    padded[: ext.shape[0]] = ext
    padded[ext.shape[0]:] = ext[-1]
    unc = np.zeros(3, bool)
    for d in unconstrained_dims:
        unc[d] = True
    points = torch.as_tensor(padded, device=device)
    n_points = torch.tensor(p, dtype=torch.int32, device=device)
    u = torch.linspace(0.0, 1.0, granularity + 1, device=device)
    pts = _eval_u(points, n_points, u)
    seg = torch.linalg.vector_norm(pts[1:] - pts[:-1], dim=-1)
    arc = torch.cat([torch.zeros(1, device=device), torch.cumsum(seg, 0)])
    return PathSpline(points=points, n_points=n_points, table_u=u,
                      table_arc=arc, table_points=pts,
                      unconstrained=torch.as_tensor(unc, device=device))


def _interp_monotone(xq: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Linear interp on a monotone grid, clamped outside the domain.
    xq [..., Q]; x, y [..., n] -> [..., Q]."""
    n = x.shape[-1]
    i = torch.clamp(torch.sum(x[..., None, :] <= xq[..., None], dim=-1) - 1,
                    0, n - 2)
    x0, x1 = _gather_last(x, i), _gather_last(x, i + 1)
    y0, y1 = _gather_last(y, i), _gather_last(y, i + 1)
    t = torch.clamp((xq - x0) / torch.clamp(x1 - x0, min=1e-8), 0.0, 1.0)
    out = y0 + t * (y1 - y0)
    out = torch.where(xq <= x[..., :1], y[..., :1].expand_as(out), out)
    return torch.where(xq >= x[..., -1:], y[..., -1:].expand_as(out), out)


def _arc_at_u(sp: PathSpline, u: torch.Tensor) -> torch.Tensor:
    """Arc length at u [..., Q] by blending neighbouring table entries of
    the uniform u grid."""
    g = sp.table_arc.shape[-1] - 1
    pos = torch.clamp(u, 0.0, 1.0) * g
    i = torch.clamp(torch.floor(pos).long(), 0, g - 1)
    frac = pos - i.to(pos.dtype)
    return _gather_last(sp.table_arc, i) * (1 - frac) \
        + _gather_last(sp.table_arc, i + 1) * frac


def u_at_arc_length(sp: PathSpline, arc: torch.Tensor) -> torch.Tensor:
    return _interp_monotone(arc, sp.table_arc, sp.table_u)


def point_at_u(sp: PathSpline, u: torch.Tensor) -> torch.Tensor:
    return _eval_u(sp.points, sp.n_points, u)


def point_at_arc_length(sp: PathSpline, arc: torch.Tensor) -> torch.Tensor:
    """Points [..., Q, 3] at Q arc lengths per spline, arc [..., Q]."""
    return point_at_u(sp, u_at_arc_length(sp, arc))


def tangent_at_arc_length(sp: PathSpline, arc: torch.Tensor) -> torch.Tensor:
    """Unit 3D tangents [..., Q, 3] at arc lengths arc [..., Q]."""
    return _tangent_u(sp.points, sp.n_points, u_at_arc_length(sp, arc))


def point_and_dir_at_arc_length(sp: PathSpline, arc: torch.Tensor):
    """(position [..., 3], unit 2D direction (x, z) [..., 2]) at one arc
    length per path; arc [...]."""
    u = u_at_arc_length(sp, arc[..., None])
    pos = point_at_u(sp, u)[..., 0, :]
    tan = _tangent_u(sp.points, sp.n_points, u)[..., 0, :]
    dir2d = torch.stack([tan[..., 0], tan[..., 2]], dim=-1)
    dir2d = dir2d / torch.clamp(torch.linalg.vector_norm(
        dir2d, dim=-1, keepdim=True), min=1e-10)
    return pos, dir2d


def closest_point(sp: PathSpline, point: torch.Tensor,
                  min_arc_length: torch.Tensor, n_refine: int = 8,
                  max_arc_length=None, bounded: bool = False):
    """Closest point at arc >= min_arc_length (and with bounded, <=
    max_arc_length: the travelled-arc update's look-ahead window): masked
    table argmin, then n_refine ternary iterations between the neighbouring
    grid cells, then the clamp into the window.  point [..., 3],
    min_arc_length / max_arc_length [...] -> (pos [..., 3], arc [...],
    distance [...])."""
    mask_dim = sp.dim_mask()[..., None, :]
    d2 = torch.sum(((sp.table_points - point[..., None, :]) * mask_dim) ** 2,
                   dim=-1)
    min_arc_length = torch.as_tensor(min_arc_length, dtype=d2.dtype,
                                     device=d2.device)
    valid = sp.table_arc >= (min_arc_length - 1e-6)[..., None]
    if bounded:
        max_arc_length = torch.as_tensor(max_arc_length, dtype=d2.dtype,
                                         device=d2.device)
        valid = valid & (sp.table_arc <= (max_arc_length + 1e-6)[..., None])
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    last = d2.shape[-1] - 1
    i = torch.where(valid.any(-1), torch.argmin(d2, dim=-1),
                    torch.full_like(min_arc_length, last, dtype=torch.long))
    g = sp.table_u.shape[-1] - 1
    lo = torch.clamp(i - 1, min=0).to(d2.dtype) / g
    hi = torch.clamp(i + 1, max=g).to(d2.dtype) / g
    mask1 = sp.dim_mask()

    def dist(u):
        p = _eval_u(sp.points, sp.n_points, u[..., None])[..., 0, :]
        return torch.sum(((p - point) * mask1) ** 2, dim=-1)

    for _ in range(n_refine):
        m1 = lo + (hi - lo) / 3.0
        m2 = hi - (hi - lo) / 3.0
        keep_lo = dist(m1) < dist(m2)
        lo, hi = torch.where(keep_lo, lo, m1), torch.where(keep_lo, m2, hi)
    u_best = 0.5 * (lo + hi)
    arc = _arc_at_u(sp, u_best[..., None])[..., 0]
    clamped = arc < min_arc_length
    arc = torch.maximum(arc, min_arc_length)
    if bounded:
        max_arc = torch.maximum(max_arc_length, min_arc_length)
        clamped = clamped | (arc > max_arc)
        arc = torch.minimum(arc, max_arc)
    u_best = torch.where(clamped,
                         u_at_arc_length(sp, arc[..., None])[..., 0], u_best)
    pos = point_at_u(sp, u_best[..., None])[..., 0, :]
    return pos, arc, torch.sqrt(dist(u_best))


def refine_iters_for_accuracy(full_arc_length: float,
                              accuracy: float = 1e-3,
                              max_iterations: int = 5000,
                              granularity: int = GRANULARITY) -> int:
    """Ternary-refinement iterations of `closest_point` for a world-space
    accuracy: the table argmin brackets the optimum within ~2 cells of
    2 * full_arc / granularity and each iteration shrinks the bracket by
    2/3.  Rounded up to a multiple of 4 and capped at 32, except that
    max_iterations, the search's hard budget, wins when it binds."""
    bracket = 2.0 * max(float(full_arc_length), 1e-6) / float(granularity)
    if accuracy <= 0.0 or accuracy >= bracket:
        n = 4
    else:
        n = math.ceil(math.log(accuracy / bracket) / math.log(2.0 / 3.0))
    n = min(-(-max(4, min(n, 32)) // 4) * 4, 32)
    return max(1, min(n, int(max_iterations)))


def closest_points_advancing(sp: PathSpline, points: torch.Tensor,
                             min_arc_length: torch.Tensor):
    """Advancing closest points for a sequence points [..., S, 3]: sample
    i searches arc >= the table arc sample i-1 chose, then a closed-form
    parabola through the three neighbouring table distances refines it.
    Distances use the subtract form |t - p|^2.  Returns (positions
    [..., S, 3], arcs [..., S], distances [..., S])."""
    mask_dim = sp.dim_mask()[..., None, None, :]
    d2_all = torch.sum(((sp.table_points[..., None, :, :]
                         - points[..., :, None, :]) * mask_dim) ** 2,
                       dim=-1)  # [..., S, G+1]
    gp1 = sp.table_arc.shape[-1]
    min_arc = min_arc_length
    idx, floors = [], []
    inf = constant(float("inf"), d2_all.dtype, d2_all.device)
    for s in range(points.shape[-2]):
        valid = sp.table_arc >= (min_arc - 1e-6)[..., None]
        d2m = torch.where(valid, d2_all[..., s, :], inf)
        i = torch.where(valid.any(-1), torch.argmin(d2m, dim=-1),
                        torch.full_like(min_arc, gp1 - 1, dtype=torch.long))
        idx.append(i)
        floors.append(min_arc)
        min_arc = torch.maximum(min_arc,
                                _gather_last(sp.table_arc, i[..., None])[
                                    ..., 0])
    idx = torch.stack(idx, dim=-1)  # [..., S]
    floors = torch.stack(floors, dim=-1)
    g = gp1 - 1
    d2_m1 = torch.gather(d2_all, -1, torch.clamp(idx - 1, min=0)[..., None])
    d2_0 = torch.gather(d2_all, -1, idx[..., None])
    d2_p1 = torch.gather(d2_all, -1, torch.clamp(idx + 1, max=g)[..., None])
    d2_m1, d2_0, d2_p1 = d2_m1[..., 0], d2_0[..., 0], d2_p1[..., 0]
    denom = d2_m1 - 2.0 * d2_0 + d2_p1
    offset = torch.where(
        denom > 1e-12,
        torch.clamp(0.5 * (d2_m1 - d2_p1) / torch.clamp(denom, min=1e-12),
                    -1.0, 1.0),
        torch.zeros_like(denom))
    u_best = torch.clamp((idx.to(points.dtype) + offset) / g, 0.0, 1.0)
    arc = _arc_at_u(sp, u_best)
    clamped = arc < floors
    arc = torch.maximum(arc, floors)
    u_best = torch.where(clamped, u_at_arc_length(sp, arc), u_best)
    pos = point_at_u(sp, u_best)
    d = torch.sqrt(torch.sum(((pos - points)
                              * sp.dim_mask()[..., None, :]) ** 2, dim=-1))
    return pos, arc, d


def transform(sp: PathSpline, q_y: torch.Tensor,
              delta: torch.Tensor) -> PathSpline:
    """The spline moved rigidly: control and table points rotated by q_y
    [..., 4] and shifted by delta [..., 3], the arc table recomputed from
    the moved table points."""
    from . import quat
    q = q_y[..., None, :]
    d = delta[..., None, :]
    seg_pts = quat.rotate_vec(q, sp.table_points) + d
    seg = torch.linalg.vector_norm(seg_pts[..., 1:, :] - seg_pts[..., :-1, :],
                                   dim=-1)
    arc = torch.cat([torch.zeros_like(seg[..., :1]),
                     torch.cumsum(seg, dim=-1)], dim=-1)
    return dataclasses.replace(sp, points=quat.rotate_vec(q, sp.points) + d,
                               table_points=seg_pts, table_arc=arc)
