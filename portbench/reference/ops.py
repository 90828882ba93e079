"""Plain PyTorch operations of the reference, in any dtype: cubic B-splines,
quaternions, the 2D alignment and seam blend of consecutive clips, the
temporal warp, Gaussian mixtures and the arc-length parameterised
Catmull-Rom path with its closest-point searches.

Frozen, written for the benchmark from the semantics of the motion model
(the reference's motion_primitive.py and its walk); nothing here imports
the program.  Leading axes are batch axes throughout."""

from __future__ import annotations

import math

import torch

DEGREE = 3


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    to even), as a tensor core reads a TF32 matmul's operands; other
    dtypes pass unchanged."""
    if x.dtype != torch.float32:
        return x
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# -- cubic B-splines -------------------------------------------------------

def basis_matrix(knots: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Cox-de Boor basis [..., Q, n_basis] of knots [..., n_knots] at times
    t [..., Q], clamped into the knot range, the last span closed."""
    n_basis = knots.shape[-1] - DEGREE - 1
    kn = knots[..., None, :]
    tmax = kn[..., -1:]
    tc = torch.minimum(torch.maximum(t[..., None], kn[..., :1]), tmax)
    left, right = kn[..., :-1], kn[..., 1:]
    last = right >= tmax
    n = torch.where(last, (tc >= left) & (tc <= right) & (left < right),
                    (tc >= left) & (tc < right)).to(knots.dtype)
    for k in range(1, DEGREE + 1):
        d1 = kn[..., k:-1] - kn[..., : -k - 1]
        d2 = kn[..., k + 1:] - kn[..., 1:-k]
        one1, one2 = torch.ones_like(d1), torch.ones_like(d2)
        w1 = torch.where(d1 > 0, (tc - kn[..., : -k - 1])
                         / torch.where(d1 > 0, d1, one1), 0.0 * one1)
        w2 = torch.where(d2 > 0, (kn[..., k + 1:] - tc)
                         / torch.where(d2 > 0, d2, one2), 0.0 * one2)
        n = w1 * n[..., :-1] + w2 * n[..., 1:]
    return n[..., :n_basis]


# -- quaternions (w, x, y, z) ------------------------------------------------

def q_normalize(q):
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True),
                           min=1e-12)


def q_multiply(a, b):
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by - ax * bz + ay * bw + az * bx,
                        aw * bz + ax * by - ay * bx + az * bw], dim=-1)


def q_rotate(q, v):
    """v rotated by q: v + 2 w (u x v) + 2 u x (u x v)."""
    u, w = q[..., 1:], q[..., :1]
    uv = torch.linalg.cross(u.expand_as(v), v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u.expand_as(uv), uv,
                                                  dim=-1))


def q_about_y(angle):
    half = 0.5 * angle
    z = torch.zeros_like(half)
    return torch.stack([torch.cos(half), z, torch.sin(half), z], dim=-1)


def forward_xz(q):
    """The ground-plane direction (x, z) of q applied to +Z, unnormalised
    input quaternions normalised first."""
    fwd = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    fwd[..., 2] = 1.0
    v = q_rotate(q_normalize(q), fwd)
    return v[..., 0], v[..., 2]


def heading(q):
    """Angle about +Y of the heading, atan2(x, z)."""
    x, z = forward_xz(q)
    return torch.atan2(x, z)


# -- alignment of consecutive clips ----------------------------------------

def aligning_transform(prev_last, first):
    """(q_y, delta): the rotation about +Y taking the new clip's first-frame
    heading onto the previous clip's last-frame heading, and the XZ shift
    making their root positions meet (Y untouched)."""
    q_y = q_about_y(heading(prev_last[..., 3:7]) - heading(first[..., 3:7]))
    delta = prev_last[..., :3] - q_rotate(q_y, first[..., :3])
    return q_y, delta * torch.tensor([1.0, 0.0, 1.0], dtype=delta.dtype,
                                     device=delta.device)


def transform_frames(frames, q_y, delta):
    """(q_y, delta) applied to the root channels of frames [..., T, D]."""
    pos = q_rotate(q_y[..., None, :], frames[..., :3]) + delta[..., None, :]
    rot = q_multiply(q_y[..., None, :].expand(frames.shape[:-1] + (4,)),
                     frames[..., 3:7])
    return torch.cat([pos, rot, frames[..., 7:]], dim=-1)


def hemisphere(frames, ref):
    """frames [..., T, D] with each joint quaternion's sign flipped where
    its dot with ref [..., D]'s is negative."""
    lead, t, d = frames.shape[:-2], frames.shape[-2], frames.shape[-1]
    q = frames[..., 3:].reshape(lead + (t, -1, 4))
    r = ref[..., 3:].reshape(lead + (1, -1, 4))
    sign = torch.where((q * r).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    return torch.cat([frames[..., :3],
                      (q * sign).reshape(lead + (t, d - 3))], dim=-1)


def seam_blend(prev_last, frames, window: int):
    """Hemisphere-align frames [..., T, D] to prev_last, then add the offset
    prev_last - frame 0 with linear decay 1 - f / window over f <= window."""
    if window <= 0:
        return frames
    flipped = hemisphere(frames, prev_last)
    f = torch.arange(frames.shape[-2], dtype=frames.dtype,
                     device=frames.device)
    decay = torch.where(f <= window, 1.0 - f / window, torch.zeros_like(f))
    return flipped + decay[:, None] * (prev_last - flipped[..., 0, :])[
        ..., None, :]


# -- temporal warp -----------------------------------------------------------

def cubic_hermite(xq, x, y):
    """Cubic Hermite interpolation with central-difference slopes on the
    monotone grid x [..., n]; xq [..., Q] -> [..., Q]."""
    n = x.shape[-1]
    i = torch.clamp((x[..., None, :] <= xq[..., None]).sum(-1) - 1, 0, n - 2)

    def at(v, off):
        return torch.gather(v, -1, torch.clamp(i + off, 0, n - 1))

    x0, x1, xm, xp = at(x, 0), at(x, 1), at(x, -1), at(x, 2)
    y0, y1, ym, yp = at(y, 0), at(y, 1), at(y, -1), at(y, 2)
    h = torch.clamp(x1 - x0, min=1e-8)
    t = torch.clamp((xq - x0) / h, 0.0, 1.0)
    m0 = (y1 - ym) / torch.clamp(x1 - xm, min=1e-8)
    m1 = (yp - y0) / torch.clamp(xp - x0, min=1e-8)
    t2, t3 = t * t, t * t * t
    return ((2 * t3 - 3 * t2 + 1) * y0 + (t3 - 2 * t2 + t) * h * m0
            + (-2 * t3 + 3 * t2) * y1 + (t3 - t2) * h * m1)


def warped_times(mean_t, eigen_t, gamma, n_canonical, max_frames: int,
                 einsum=torch.einsum):
    """The clip's canonical times at its output frames and its frame count.

    The canonical time function t(t') = cumsum(exp(mean_t + E_t gamma)) - 1
    over the node's n_canonical frames (mean_t [..., F], eigen_t
    [..., F, k_t], gamma [..., k_t]) is inverted: frame 0 at 0, the last
    frame at n_canonical - 1, round(t(F - 2)) interior frames evenly spaced
    in t between.  -> (times [..., max_frames], n_frames [...] int64,
    t(F - 2) [...], whose rounding sets the frame count)."""
    f_max = mean_t.shape[-1]
    dt, dev = mean_t.dtype, mean_t.device
    w = mean_t + einsum("...fk,...k->...f", eigen_t, gamma)
    inc = torch.where(torch.arange(f_max, device=dev) < n_canonical[..., None],
                      torch.exp(w), torch.zeros_like(w))
    t_can = torch.cumsum(inc, -1) - 1.0
    t_end = torch.gather(t_can, -1, torch.clamp(n_canonical - 2, min=0)[
        ..., None])[..., 0]
    num = torch.clamp(torch.floor(torch.round(t_end)), min=1.0)
    n_frames = torch.clamp(num.long() + 2, max=max_frames)
    i = torch.arange(max_frames, dtype=dt, device=dev)
    interior = 1.0 + (t_end - 1.0)[..., None] * (i - 1.0) / torch.clamp(
        num - 1.0, min=1.0)[..., None]
    last_can = (n_canonical - 1).to(dt)
    y = torch.minimum(torch.arange(f_max, dtype=dt, device=dev),
                      last_can[..., None])
    times = cubic_hermite(interior, t_can, y)
    times = torch.where(i == 0, torch.zeros_like(times), times)
    return (torch.where(i >= (n_frames - 1)[..., None],
                        last_can[..., None].expand_as(times), times),
            n_frames, t_end)


# -- Gaussian mixtures -------------------------------------------------------

def gmm_neg_log_prob(x, weights, means, prec_chol, einsum=torch.einsum):
    """-log p(x) of x [..., L] under the mixture (weights [..., K], means
    [..., K, L], precision Cholesky factors [..., K, L, L], W W^T the
    precision)."""
    y = einsum("...kl,...klm->...km", x[..., None, :] - means, prec_chol)
    log_det = torch.log(torch.abs(torch.diagonal(
        prec_chol, dim1=-2, dim2=-1))).sum(-1)
    comp = -0.5 * (means.shape[-1] * math.log(2.0 * math.pi)
                   + (y * y).sum(-1)) + log_det
    return -torch.logsumexp(comp + torch.log(torch.clamp(weights, min=1e-30)),
                            dim=-1)


# -- the path: an arc-length parameterised Catmull-Rom spline ---------------

_CR = ((-1.0, 3.0, -3.0, 1.0), (2.0, -5.0, 4.0, -1.0), (-1.0, 0.0, 1.0, 0.0),
       (0.0, 2.0, 0.0, 0.0))


class Path:
    """Catmull-Rom splines through control points [C, P, 3] (ends
    repeated), tabulated at `granularity` + 1 uniform parameters with their
    cumulative chord lengths; Y is free (`mask`)."""

    def __init__(self, control_points: torch.Tensor, granularity: int):
        cp = control_points
        self.pts = torch.cat([cp[:, :1], cp, cp[:, -1:], cp[:, -1:]], dim=1)
        self.n_points = cp.shape[1]
        self.mask = torch.tensor([1.0, 0.0, 1.0], dtype=cp.dtype,
                                 device=cp.device)
        self.g = granularity
        self.table_u = torch.linspace(0.0, 1.0, granularity + 1,
                                      dtype=cp.dtype, device=cp.device)
        self.table_pts = self.eval_u(self.table_u.expand(cp.shape[0], -1))
        seg = torch.linalg.vector_norm(self.table_pts[:, 1:]
                                       - self.table_pts[:, :-1], dim=-1)
        self.table_arc = torch.cat([torch.zeros_like(seg[:, :1]),
                                    torch.cumsum(seg, 1)], dim=1)
        self.full_arc = self.table_arc[:, -1]

    def rows(self, idx):
        """The path of rows idx [R] (a view for the characters judged)."""
        out = Path.__new__(Path)
        out.__dict__.update(self.__dict__)
        for name in ("pts", "table_pts", "table_arc", "full_arc"):
            setattr(out, name, getattr(self, name)[idx])
        return out

    def eval_u(self, u):
        """Points [C, Q, 3] at parameters u [C, Q] (in [0, 1])."""
        n_seg = max(self.n_points - 1, 1)
        scaled = torch.clamp(u, 0.0, 1.0) * n_seg
        idx = torch.clamp(torch.floor(scaled).long(), 0, self.n_points - 2)
        local = scaled - idx.to(u.dtype)
        base = torch.tensor(_CR, dtype=u.dtype, device=u.device)
        w = torch.stack([local ** 3, local ** 2, local,
                         torch.ones_like(local)], -1) @ base  # [C, Q, 4]
        out = 0.0
        for o in range(4):
            p = torch.gather(self.pts, 1, (idx + o)[..., None].expand(
                idx.shape + (3,)))
            out = out + w[..., o: o + 1] * p
        return 0.5 * out

    def _interp(self, xq, x, y):
        n = x.shape[-1]
        i = torch.clamp((x[:, None, :] <= xq[..., None]).sum(-1) - 1, 0,
                        n - 2)
        x0, x1 = torch.gather(x, 1, i), torch.gather(x, 1, i + 1)
        y0, y1 = torch.gather(y, 1, i), torch.gather(y, 1, i + 1)
        out = y0 + torch.clamp((xq - x0) / torch.clamp(x1 - x0, min=1e-8),
                               0.0, 1.0) * (y1 - y0)
        out = torch.where(xq <= x[:, :1], y[:, :1].expand_as(out), out)
        return torch.where(xq >= x[:, -1:], y[:, -1:].expand_as(out), out)

    def u_at_arc(self, arc):
        """Parameters [C, Q] at arc lengths [C, Q]: linear in the table."""
        return self._interp(arc, self.table_arc,
                            self.table_u.expand_as(self.table_arc))

    def arc_at_u(self, u):
        pos = torch.clamp(u, 0.0, 1.0) * self.g
        i = torch.clamp(torch.floor(pos).long(), 0, self.g - 1)
        frac = pos - i.to(pos.dtype)
        return (torch.gather(self.table_arc, 1, i) * (1 - frac)
                + torch.gather(self.table_arc, 1, i + 1) * frac)

    def point_and_dir(self, arc):
        """(point [C, 3], unit ground direction (x, z) [C, 2]) at one arc
        length per path; the tangent is a central difference of 1e-3 in
        the parameter."""
        u = self.u_at_arc(arc[:, None])
        pos = self.eval_u(u)[:, 0]
        d = (self.eval_u(torch.clamp(u + 5e-4, 0.0, 1.0))
             - self.eval_u(torch.clamp(u - 5e-4, 0.0, 1.0)))[:, 0]
        d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                            min=1e-10)
        d2 = torch.stack([d[:, 0], d[:, 2]], -1)
        return pos, d2 / torch.clamp(torch.linalg.vector_norm(
            d2, dim=-1, keepdim=True), min=1e-10)

    def closest_point(self, point, min_arc, n_refine: int = 8):
        """Arc length [C] of the point of the path nearest to point [C, 3]
        (in XZ) at arc >= min_arc [C]: the nearest table sample, then
        n_refine ternary steps between its neighbours, then the floor."""
        d2 = (((self.table_pts - point[:, None]) * self.mask) ** 2).sum(-1)
        valid = self.table_arc >= (min_arc - 1e-6)[:, None]
        d2 = torch.where(valid, d2, torch.full_like(d2, math.inf))
        i = torch.where(valid.any(-1), d2.argmin(-1),
                        torch.full_like(min_arc, self.g, dtype=torch.long))
        lo = torch.clamp(i - 1, min=0).to(point.dtype) / self.g
        hi = torch.clamp(i + 1, max=self.g).to(point.dtype) / self.g

        def dist(u):
            p = self.eval_u(u[:, None])[:, 0]
            return (((p - point) * self.mask) ** 2).sum(-1)

        for _ in range(n_refine):
            m1, m2 = lo + (hi - lo) / 3.0, hi - (hi - lo) / 3.0
            keep = dist(m1) < dist(m2)
            lo, hi = torch.where(keep, lo, m1), torch.where(keep, m2, hi)
        arc = self.arc_at_u(0.5 * (lo + hi)[:, None])[:, 0]
        return torch.maximum(arc, min_arc)

    def closest_points_advancing(self, points, min_arc):
        """Distances [..., S] (in XZ) of a sequence of points [..., S, 3] to
        the path, each sample searching at arc >= the table arc the
        previous one chose (the first at >= min_arc), refined by a
        parabola through the three neighbouring table distances and held
        at its floor -> (distances, arcs); leading axes [C, ...]."""
        lead = points.shape[:-2]
        extra = len(lead) - 1
        tp = self.table_pts.reshape((points.shape[0],) + (1,) * extra
                                    + self.table_pts.shape[1:])
        ta = self.table_arc.reshape((points.shape[0],) + (1,) * extra
                                    + self.table_arc.shape[1:])
        d2 = (((tp[..., None, :, :] - points[..., :, None, :])
               * self.mask) ** 2).sum(-1)  # [..., S, G+1]
        floor = min_arc.reshape((points.shape[0],) + (1,) * extra).expand(
            lead)
        idx, floors = [], []
        for s in range(points.shape[-2]):
            valid = ta >= (floor - 1e-6)[..., None]
            dm = torch.where(valid, d2[..., s, :], torch.full_like(
                d2[..., s, :], math.inf))
            i = torch.where(valid.any(-1), dm.argmin(-1),
                            torch.full_like(floor, self.g, dtype=torch.long))
            idx.append(i)
            floors.append(floor)
            floor = torch.maximum(floor, torch.gather(
                ta.expand(lead + ta.shape[-1:]), -1, i[..., None])[..., 0])
        idx, floors = torch.stack(idx, -1), torch.stack(floors, -1)
        dm1 = torch.gather(d2, -1, torch.clamp(idx - 1, min=0)[..., None])[
            ..., 0]
        d0 = torch.gather(d2, -1, idx[..., None])[..., 0]
        dp1 = torch.gather(d2, -1, torch.clamp(idx + 1, max=self.g)[
            ..., None])[..., 0]
        den = dm1 - 2.0 * d0 + dp1
        off = torch.where(den > 1e-12, torch.clamp(
            0.5 * (dm1 - dp1) / torch.clamp(den, min=1e-12), -1.0, 1.0),
            torch.zeros_like(den))
        u = torch.clamp((idx.to(points.dtype) + off) / self.g, 0.0, 1.0)
        flat_u = u.reshape(points.shape[0], -1)
        arc = self.arc_at_u(flat_u).reshape(u.shape)
        clamped = arc < floors
        arc = torch.maximum(arc, floors)
        u = torch.where(clamped, self.u_at_arc(arc.reshape(
            points.shape[0], -1)).reshape(u.shape), u)
        pos = self.eval_u(u.reshape(points.shape[0], -1)).reshape(
            u.shape + (3,))
        dist = torch.sqrt((((pos - points) * self.mask) ** 2).sum(-1))
        return dist, arc, pos
