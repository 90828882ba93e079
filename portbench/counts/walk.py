"""Float32 operations of one whole walk, counted from its shapes for the
work (not for an implementation): what `walk_mfu` divides by the walk's
wall time and the card's float32 peak.

A constrained crowd step, per character: n candidate draws from the node's
mixture (one Cholesky matvec each); the selection (B1's count, from the
table rows its searches read); the exact error of the pick (the root
coefficients, 18 query rows, 16 advancing closest-point searches over the
path table); each LM iteration (residuals and jacobian of the 18 active
rows through the root head, JtJ, Jtr, the damped Cholesky solve, the
mixture's value and gradient at the iterate and at the probe, the probe's
residuals, the frozen closest points); the exact error of the refined
latent; the clip (`emit.count`); the travelled arc's closest point.

A random-walk step, per character: one draw, the time warp (the warp's
increments, their exp and cumsum, the cubic inversion at each frame), the
clip without a previous one (`emit.count`), and the segment's alignment and
seam blend."""

from __future__ import annotations

from . import emit

ROOT_CH, ROWS, TRAJ = 7, 18, 16


def _error_flops(nb: int, k: int, g1: int) -> int:
    return (2 * nb * ROOT_CH * k + 2 * ROWS * nb * ROOT_CH + 60 * ROWS
            + TRAJ * g1 * 8)


def crowd_flops(c: int, steps: int, n: int, k: int, l_dim: int,
                n_comp: int, nb: int, d: int, m: int, t: int, g1: int,
                lm_iters: int, b1_flops: float) -> float:
    """One crowd walk; b1_flops: the selection kernel's operations summed
    over the walk's launches."""
    head = ROWS * (ROOT_CH + ROWS * ROOT_CH + 4) * k * 2
    lm_iter = (head + 2 * ROWS * l_dim * l_dim + 2 * ROWS * l_dim
               + 2 * l_dim ** 3 // 3 + 4 * l_dim * l_dim
               + 2 * n_comp * (2 * l_dim * l_dim + 4 * l_dim)
               + _error_flops(nb, k, g1))
    per_char = (n * (2 * l_dim * l_dim + l_dim) + 2 * _error_flops(nb, k, g1)
                + lm_iters * lm_iter + g1 * 6 + 16 * 40)
    clip_steps = emit.count(c, t, k, m, nb, d, False)[0] \
        + (steps - 1) * emit.count(c, t, k, m, nb, d, True)[0]
    return float(steps * c * per_char + clip_steps + b1_flops)


def segments_flops(c: int, steps: int, k: int, k_t: int, l_dim: int,
                   nb: int, d: int, m: int, t: int, f: int,
                   window: int) -> float:
    """One random-walk batch of C characters x steps segments."""
    warp = 2 * f * k_t + 3 * f + 40 * t
    align = 20 * t + 2 * (window + 1) * d + 2 * t * d
    per_step = c * (2 * l_dim * l_dim + warp + align) \
        + emit.count(c, t, k, m, nb, d, False)[0]
    return float(steps * per_step)
