"""Operations and bytes of the locomotion selection kernel (B1) on the
inputs it was given: each input read and each error written once; 9
operations for every table row its 16 trajectory searches must read (the
valid rows at or above each search's advancing floor: a mul and two FMAs
for the distance, two adds, a compare and a min), and 2 per operator
coefficient of the 60 frame rows it evaluates per candidate.  Frozen from
`chip_smoke.py`'s `_selection_bound` and `_rows_read`; the rows are
counted by a plain copy of the kernel's search order."""

from __future__ import annotations

import math

import torch

from . import peaks

FLOPS_PER_ROW = 9
FRAME_ROWS = 60
N_EVAL, CH, TRAJ_SAMPLES = 19, 8, 16


def _heading(qw, qx, qy, qz):
    n2 = qw * qw + qx * qx + qy * qy + qz * qz
    return 2.0 * (qw * qy + qx * qz), n2 - 2.0 * (qx * qx + qy * qy)


def rows_read(mop, alphas, table, cfg) -> int:
    """Table rows the 16 advancing searches of every candidate read: mop
    [C, N_EVAL * CH, K + 1], alphas [C, N, K], table [C, G8, 5] (points,
    arc, validity), cfg [C, W] in the kernel's layout."""
    c, n, _ = alphas.shape
    a1 = torch.cat([alphas, torch.ones_like(alphas[..., :1])], -1)
    fr = torch.bmm(mop, a1.transpose(1, 2))  # [C, rows, N]

    def p(i):
        return cfg[:, i: i + 1]

    has_prev = p(8) > 0
    f0 = (N_EVAL - 1) * CH
    hx, hz = _heading(*(fr[:, f0 + i] for i in range(3, 7)))
    inv = torch.rsqrt(hx * hx + hz * hz + 1e-30)
    cn, sn = hz * inv, hx * inv
    ct = torch.where(has_prev, p(0) * cn + p(29) * sn, p(4).expand(-1, n))
    st = torch.where(has_prev, p(29) * cn - p(0) * sn, p(30).expand(-1, n))
    r0x = ct * fr[:, f0] + st * fr[:, f0 + 2]
    r0z = -st * fr[:, f0] + ct * fr[:, f0 + 2]
    dx = torch.where(has_prev, p(1) - r0x, p(5).expand(-1, n))
    dz = torch.where(has_prev, p(3) - r0z, p(7).expand(-1, n))
    dy = torch.where(has_prev, torch.zeros_like(r0x), p(6).expand(-1, n))
    pts, arc, ok = table[:, :, 0:3], table[:, :, 3:4], table[:, :, 4:5]
    floor = p(18).expand(-1, n)
    total = 0
    for f in range(2, 2 + TRAJ_SAMPLES):
        x, y, z = fr[:, f * CH], fr[:, f * CH + 1], fr[:, f * CH + 2]
        q = torch.stack([(ct * x + st * z + dx) * p(22), (y + dy) * p(23),
                         (-st * x + ct * z + dz) * p(24)], 1)  # [C, 3, N]
        d2 = ((pts[..., None] - q[:, None]) ** 2).sum(2)  # [C, G8, N]
        valid = (arc >= floor[:, None, :] - 1e-6) * ok
        total += int((valid > 0).sum())
        d2m = torch.where(valid > 0, d2, math.inf)
        dmin = d2m.amin(1)
        pick = torch.where(d2m <= dmin[:, None] + 1e-6, arc, math.inf).amin(1)
        floor = torch.where((valid > 0).any(1), pick, p(28).expand(-1, n))
    return total


def count(c: int, n: int, k: int, g8: int, cfg_w: int, rows: int):
    """(flops, bytes) of one launch over C characters x N candidates of K
    spatial latents on G8-row tables, `rows` table rows read."""
    flops = FLOPS_PER_ROW * rows + c * n * 2 * (k + 1) * FRAME_ROWS
    n_bytes = 4 * (c * N_EVAL * CH * (k + 1) + c * n * k + c * g8 * 5
                   + c * cfg_w + c * n)
    return flops, n_bytes


def bound_ms(c, n, k, g8, cfg_w, rows) -> float:
    flops, n_bytes = count(c, n, k, g8, cfg_w, rows)
    return peaks.bound_ms(n_bytes, flops)
