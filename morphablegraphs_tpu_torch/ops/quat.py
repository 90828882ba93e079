"""Batched quaternion ops, [w, x, y, z] scalar first; every function
broadcasts over leading batch axes (port of morphablegraphs_tpu.ops.quat)."""

from __future__ import annotations

import torch

_EPS = 1e-12


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalize, guarding against zero norm."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """[w, -x, -y, -z]: the inverse rotation of a unit quaternion."""
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b (w-first)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def rotate_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 3-vector(s) v by quaternion(s) q:
    v' = v + 2*qw*(u x v) + 2*u x (u x v)."""
    u = q[..., 1:]
    w = q[..., :1]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def about_y(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +Y by `angle` radians."""
    half = angle * 0.5
    zeros = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zeros, torch.sin(half), zeros],
                       dim=-1)


def fix_signs(quats: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Flip quaternion signs so dot(ref, q) >= 0."""
    d = torch.sum(quats * ref, dim=-1, keepdim=True)
    return torch.where(d < 0.0, -quats, quats)


def frame_fix_signs(frames: torch.Tensor,
                    ref_frame: torch.Tensor) -> torch.Tensor:
    """Hemisphere-align a frame matrix [..., 3+4J] against a reference frame
    of the same layout."""
    quats = frames[..., 3:].reshape(frames.shape[:-1] + (-1, 4))
    ref = ref_frame[..., 3:].reshape(ref_frame.shape[:-1] + (-1, 4))
    quats = fix_signs(quats, ref)
    return torch.cat([frames[..., :3],
                      quats.reshape(frames.shape[:-1] + (-1,))], dim=-1)


def slerp(q0: torch.Tensor, q1: torch.Tensor, t) -> torch.Tensor:
    """Spherical linear interpolation on the shorter arc; nlerp where the
    quaternions are nearly parallel (sin theta < 1e-5).  t is a scalar or
    one weight per quaternion."""
    q0 = normalize(q0)
    q1 = normalize(q1)
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0.0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    t = torch.as_tensor(t, dtype=q0.dtype, device=q0.device)
    if t.dim() == q0.dim() - 1:
        t = t[..., None]
    near = sin_theta < 1e-5
    sin_c = torch.clamp(sin_theta, min=_EPS)
    w0 = torch.where(near, 1.0 - t, torch.sin((1.0 - t) * theta) / sin_c)
    w1 = torch.where(near, t, torch.sin(t * theta) / sin_c)
    return normalize(w0 * q0 + w1 * q1)


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion [..., 4] -> rotation matrix [..., 3, 3] (normalizes q)."""
    w, x, y, z = normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> unit quaternion [..., 4], branch-free:
    the trace candidate where the trace is positive, else the candidate of
    the largest diagonal entry."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def s(v):
        return torch.sqrt(torch.clamp(v, min=_EPS)) * 2.0

    s0 = s(tr + 1.0)
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0,
                      (m10 - m01) / s0], -1)
    s1 = s(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1,
                      (m02 + m20) / s1], -1)
    s2 = s(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2,
                      (m12 + m21) / s2], -1)
    s3 = s(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3,
                      (m12 + m21) / s3, 0.25 * s3], -1)
    q = torch.where((tr > 0.0)[..., None], q0, torch.where(
        ((m00 >= m11) & (m00 >= m22))[..., None], q1,
        torch.where((m11 >= m22)[..., None], q2, q3)))
    return normalize(q)


def from_axis_angle(axis: torch.Tensor, angle) -> torch.Tensor:
    """Rotation by `angle` radians [...] about `axis` [..., 3]."""
    axis = axis / torch.clamp(torch.linalg.vector_norm(
        axis, dim=-1, keepdim=True), min=_EPS)
    half = torch.as_tensor(angle, dtype=axis.dtype,
                           device=axis.device)[..., None] * 0.5
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


_AXES = {"x": (1.0, 0.0, 0.0), "y": (0.0, 1.0, 0.0), "z": (0.0, 0.0, 1.0)}


def from_euler(angles_deg: torch.Tensor,
               order: str = "rxyz") -> torch.Tensor:
    """Euler angles in degrees [..., 3] -> quaternion.  Order 'rabc' is the
    rotating-frame composition q_a * q_b * q_c, what a BVH 'Arotation
    Brotation Crotation' channel triplet denotes."""
    if not (order.startswith("r") and len(order) == 4):
        raise ValueError(f"euler order {order!r}: expected 'r' and 3 axes")
    rad = torch.deg2rad(angles_deg)
    q = None
    for i, ax in enumerate(order[1:]):
        axis = torch.tensor(_AXES[ax], dtype=rad.dtype, device=rad.device)
        qi = from_axis_angle(axis, rad[..., i])
        q = qi if q is None else multiply(q, qi)
    return q


def to_euler(q: torch.Tensor, order: str = "rxyz") -> torch.Tensor:
    """Quaternion -> Euler angles in degrees [..., 3] for the six
    rotating-frame orders, by factoring the rotation matrix: the middle
    angle from an arcsine, the outer two from arctangents."""
    m = to_matrix(q)

    def asin(v):
        return torch.arcsin(torch.clamp(v, -1.0, 1.0))

    atan2 = torch.atan2
    if order == "rxyz":  # Rx(a) Ry(b) Rz(c)
        a, b, c = (atan2(-m[..., 1, 2], m[..., 2, 2]), asin(m[..., 0, 2]),
                   atan2(-m[..., 0, 1], m[..., 0, 0]))
    elif order == "rxzy":  # Rx(a) Rz(b) Ry(c)
        a, b, c = (atan2(m[..., 2, 1], m[..., 1, 1]), asin(-m[..., 0, 1]),
                   atan2(m[..., 0, 2], m[..., 0, 0]))
    elif order == "ryxz":  # Ry(a) Rx(b) Rz(c)
        a, b, c = (atan2(m[..., 0, 2], m[..., 2, 2]), asin(-m[..., 1, 2]),
                   atan2(m[..., 1, 0], m[..., 1, 1]))
    elif order == "ryzx":  # Ry(a) Rz(b) Rx(c)
        a, b, c = (atan2(-m[..., 2, 0], m[..., 0, 0]), asin(m[..., 1, 0]),
                   atan2(-m[..., 1, 2], m[..., 1, 1]))
    elif order == "rzxy":  # Rz(a) Rx(b) Ry(c)
        a, b, c = (atan2(-m[..., 0, 1], m[..., 1, 1]), asin(m[..., 2, 1]),
                   atan2(-m[..., 2, 0], m[..., 2, 2]))
    elif order == "rzyx":  # Rz(a) Ry(b) Rx(c)
        a, b, c = (atan2(m[..., 1, 0], m[..., 0, 0]), asin(-m[..., 2, 0]),
                   atan2(m[..., 2, 1], m[..., 2, 2]))
    else:
        raise ValueError(f"euler order {order!r}")
    return torch.rad2deg(torch.stack([a, b, c], dim=-1))


def fix_signs_sequential(quats: torch.Tensor) -> torch.Tensor:
    """Hemisphere-align a sequence [T, ..., 4] so each frame's quaternions
    lie on the previous frame's hemisphere: a running product of the
    per-step flip signs."""
    d = torch.sum(quats[1:] * quats[:-1], dim=-1)
    step = torch.where(d < 0.0, -1.0, 1.0).to(quats.dtype)
    run = torch.cat([torch.ones_like(quats[:1, ..., 0]),
                     torch.cumprod(step, dim=0)], dim=0)
    return quats * run[..., None]


def add_frames(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b in quaternion-frame space [..., 3 + 4J]: translations add,
    joint quaternions compose (a * b, normalized)."""
    qa = a[..., 3:].reshape(a.shape[:-1] + (-1, 4))
    qb = b[..., 3:].reshape(b.shape[:-1] + (-1, 4))
    q = normalize(multiply(qa, qb))
    return torch.cat([a[..., :3] + b[..., :3],
                      q.reshape(a.shape[:-1] + (-1,))], dim=-1)


def subtract_frames(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b: the translation difference and the relative quaternions
    b^-1 * a (normalized)."""
    qa = a[..., 3:].reshape(a.shape[:-1] + (-1, 4))
    qb = b[..., 3:].reshape(b.shape[:-1] + (-1, 4))
    q = normalize(multiply(conjugate(qb), qa))
    return torch.cat([a[..., :3] - b[..., :3],
                      q.reshape(a.shape[:-1] + (-1,))], dim=-1)
