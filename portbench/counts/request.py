"""Float32 operations of one request of the service cell, counted from its
shapes for the work (not for an implementation): what `request_mfu`
divides by the untraced wall time per request and the card's float32
peak.

Per step: the pool's n draws (a Cholesky matvec each); each candidate's
exact error (`_evaluation`: the coefficients of every channel, the query
rows' frames, the FK of every joint at each row, and on a path step the
16 advancing searches over the path's table); every LM iteration (the
forward-mode jacobian at twice an evaluation per latent, JtJ and Jtr over
the step's residual rows, the Cholesky solve, the probe's evaluation, the
mixture's value and gradient at both); the refined latent's error; the
canonical clip with its seam (`emit.count`); the travelled arc's search.
A path step (walk, carry) reads 18 rows (goal, direction, 16 trajectory
samples), a keyframe step (pick, place) one; each IK target is the
keyframe of a step of its own (the pick's, the place's).  The conversion: every answered
frame's 4-weight blend of each channel and each step's coefficients.  The
keyframe IK: per target and iteration the FK and its jacobian (4 rotations
per joint), the normal equations of 3 rows in 3 rotation components per
joint and their solve; the blend of its 121 frames."""

from __future__ import annotations

from . import emit

ROT = 60  # a quaternion product and a rotation of a vector
PATH_ROWS, TRAJ = 18, 16


def _evaluation(rows: int, k: int, nb: int, d: int, joints: int, g1: int,
                path: bool) -> int:
    return (2 * nb * d * k + 2 * rows * nb * d + rows * joints * ROT
            + (TRAJ * g1 * 8 if path else 0))


def _step(rows, path, n, lm_iters, k, l_dim, n_comp, nb, d, joints, t, g1):
    ev = _evaluation(rows, k, nb, d, joints, g1, path)
    gmm = n_comp * (2 * l_dim * l_dim + 4 * l_dim)
    lm_iter = (2 * l_dim * ev + 2 * rows * l_dim * l_dim + 2 * rows * l_dim
               + l_dim ** 3 // 3 + 2 * l_dim * l_dim + ev + 2 * gmm)
    return (n * (2 * l_dim * l_dim + l_dim) + n * ev + lm_iters * lm_iter
            + ev + emit.count(1, t, k, 1, nb, d, True)[0]
            + (g1 * 8 if path else 0))


def flops(steps: float, frames: float, ik: float, n: int, lm_iters: int,
          ik_iters: int, k: int, l_dim: int, n_comp: int, nb: int, d: int,
          joints: int, t: int, g1: int) -> float:
    """One request of `steps` steps, `ik` of them keyframe steps with an
    IK target each, and `frames` answered frames (means over the window's
    requests); n candidates a step, t frames a canonical clip."""
    shape = (n, lm_iters, k, l_dim, n_comp, nb, d, joints, t, g1)
    per_path = _step(PATH_ROWS, True, *shape)
    per_reach = _step(1, False, *shape)
    convert = frames * 8 * d + steps * 2 * nb * d * k
    dof = 3 * joints
    ik_ops = ik * (ik_iters * (4 * joints * ROT + 2 * 3 * dof * dof
                               + dof ** 3 // 3) + 121 * 2 * d)
    return float((steps - ik) * per_path + ik * per_reach + convert
                 + ik_ops)
