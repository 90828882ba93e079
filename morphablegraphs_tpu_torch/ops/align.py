"""Frame alignment and seam smoothing (port of
morphablegraphs_tpu.ops.align).  Every function takes leading batch axes
(one row per character)."""

from __future__ import annotations

import numpy as np
import torch

from . import quat
from .consts import constant

REF_VECTOR = (0.0, 0.0, 1.0)
XZ_MASK = (1.0, 0.0, 1.0)


def heading_angle(root_q: torch.Tensor) -> torch.Tensor:
    """Angle about +Y of the root's ground-plane heading, atan2(x, z)."""
    v = quat.rotate_vec(quat.normalize(root_q),
                        constant(REF_VECTOR, root_q.dtype, root_q.device))
    return torch.atan2(v[..., 0], v[..., 2])


def node_aligning_2d_transform(prev_last: torch.Tensor,
                               new_first: torch.Tensor):
    """(q_y [..., 4], delta [..., 3]) rotating the new clip's first-frame
    heading onto the previous clip's last-frame heading and making their
    root XZ positions coincide (Y untouched).  Frames [..., D]."""
    theta = heading_angle(prev_last[..., 3:7]) - heading_angle(
        new_first[..., 3:7])
    q_y = quat.about_y(theta)
    delta = prev_last[..., :3] - quat.rotate_vec(q_y, new_first[..., :3])
    return q_y, delta * constant(XZ_MASK, delta.dtype, delta.device)


def transform_from_start_pose(position: torch.Tensor,
                              orientation_deg: torch.Tensor):
    """(q_y, delta) placing a clip at a start pose: position [3] (NaN
    components -> 0) and a rotation about +Y of orientation_deg degrees."""
    pos = torch.where(torch.isnan(position), torch.zeros_like(position),
                      position)
    return quat.about_y(torch.deg2rad(orientation_deg)), pos


def transform_frames(frames: torch.Tensor, q_y: torch.Tensor,
                     delta: torch.Tensor) -> torch.Tensor:
    """Apply (q_y [..., 4], delta [..., 3]) to the root channels of
    frames [..., T, D]."""
    root_pos = quat.rotate_vec(q_y[..., None, :], frames[..., :3]) \
        + delta[..., None, :]
    root_q = quat.multiply(q_y[..., None, :], frames[..., 3:7])
    return torch.cat([root_pos, root_q, frames[..., 7:]], dim=-1)


def smoothing_factors(window: int, n_frames: int, dtype=torch.float32,
                      device=None) -> torch.Tensor:
    """Linear decay 1 - f/w for f <= w, else 0."""
    f = torch.arange(n_frames, dtype=dtype, device=device)
    w = float(window)
    return torch.where(f <= w, 1.0 - f / w, torch.zeros_like(f))


def smooth_transition(prev_frame: torch.Tensor, frames: torch.Tensor,
                      window: int) -> torch.Tensor:
    """Offset-blend frames [..., T, D] toward continuity with prev_frame
    [..., D], in the single-expression form: the per-joint hemisphere flip
    is a +/-1 channel mask inside the blend's multiply-add.
    window <= 0 is the identity."""
    if window <= 0:
        return frames
    t, d = frames.shape[-2:]
    lead = frames.shape[:-2]
    quats = frames[..., 3:].reshape(lead + (t, -1, 4))
    ref = prev_frame[..., 3:].reshape(lead + (1, -1, 4))
    dots = torch.sum(quats * ref, dim=-1)  # [..., T, J]
    sign_q = torch.where(dots < 0.0, -1.0, 1.0).to(frames.dtype)
    sign = torch.cat([torch.ones(lead + (t, 3), dtype=frames.dtype,
                                 device=frames.device),
                      sign_q[..., None].expand(lead + (t, d // 4, 4))
                      .reshape(lead + (t, d - 3))], dim=-1)
    factors = smoothing_factors(window, t, frames.dtype, frames.device)
    magnitude = prev_frame - frames[..., 0, :] * sign[..., 0, :]
    return frames * sign + factors[:, None] * magnitude[..., None, :]


def align_clip(prev_last: torch.Tensor, new_frames: torch.Tensor,
               window: int) -> torch.Tensor:
    """Align and seam-smooth clips new_frames [..., S, D] against the last
    frames prev_last [..., D] of the motions so far (append_frames without
    the write)."""
    q_y, delta = node_aligning_2d_transform(prev_last, new_frames[..., 0, :])
    return smooth_transition(prev_last, transform_frames(new_frames, q_y,
                                                         delta), window)


def append_frames(buffer: torch.Tensor, n_valid: torch.Tensor,
                  new_frames: torch.Tensor, n_new: torch.Tensor,
                  window: int = 20, active=None):
    """Append each character's clip to its motion: align new_frames
    [C, S, D] to buffer[c, n_valid[c] - 1] and write all S rows at offset
    n_valid[c] of buffer [C, MAX_T, D], IN PLACE; n_valid grows by n_new
    [C].  A character's first clip (n_valid 0) is written unaligned.  Rows
    past n_valid + n_new are garbage that later appends overwrite.

    A clip whose whole S-row slab would pass the buffer's end is dropped
    and n_valid stays, as are the clips of characters not in `active` [C]
    (default: all append).  Returns (buffer, new n_valid)."""
    c, s, _ = new_frames.shape
    max_t = buffer.shape[1]
    rows = torch.arange(c, device=buffer.device)
    prev_last = buffer[rows, torch.clamp(n_valid - 1, min=0).long()]
    aligned = torch.where((n_valid > 0)[:, None, None],
                          align_clip(prev_last, new_frames, window),
                          new_frames)
    write = n_valid + s <= max_t
    if active is not None:
        write = write & active
    # characters that do not write rewrite their rows' own values (at
    # in-range columns), so the scatter needs no data-dependent shapes
    cols = torch.clamp(n_valid.long()[:, None]
                       + torch.arange(s, device=buffer.device), max=max_t - 1)
    ri = rows[:, None].expand(c, s)
    buffer[ri, cols] = torch.where(write[:, None, None], aligned,
                                   buffer[ri, cols])
    return buffer, torch.where(write, n_valid + n_new, n_valid)


def blend_seam_np(prev_frames, new_frames, window: int):
    """Two-sided seam smoothing on host arrays (spatial_smoothing_method
    "blending"): the frames within window // 2 of the seam become a linear
    ramp between the two boundary frames, the right boundary's quaternions
    hemisphere-aligned to the left's.  Returns copies (prev_out, new_out)."""
    prev_frames = np.asarray(prev_frames)
    new_frames = np.asarray(new_frames)
    half = min(window // 2, len(prev_frames), len(new_frames))
    if half <= 0:
        return prev_frames, new_frames
    left = prev_frames[-half].copy()
    right = new_frames[half - 1].copy()
    d = left.shape[-1]
    for q0 in range(3, d - 3, 4):
        if np.dot(left[q0:q0 + 4], right[q0:q0 + 4]) < 0:
            right[q0:q0 + 4] = -right[q0:q0 + 4]
    n = 2 * half
    ts = (np.arange(1, n + 1, dtype=left.dtype) / (n + 1))[:, None]
    ramp = left[None, :] * (1.0 - ts) + right[None, :] * ts
    prev_out = prev_frames.copy()
    new_out = new_frames.copy()
    prev_out[-half:] = ramp[:half]
    new_out[:half] = ramp[half:]
    return prev_out, new_out


def filter_root_np(frames, window: int):
    """Box-filter the root translation channels of host frames [T, D] over
    `window` frames (edge-padded); window <= 1 is the identity."""
    frames = np.asarray(frames)
    if window <= 1 or len(frames) < window:
        return frames
    out = frames.copy()
    kernel = np.ones(window) / window
    pad = window // 2
    for c in range(3):
        col = np.pad(frames[:, c], (pad, window - 1 - pad), mode="edge")
        out[:, c] = np.convolve(col, kernel, mode="valid")
    return out
