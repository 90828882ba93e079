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
