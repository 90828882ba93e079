"""The plain reference of the two walks the benchmark drives.

* `crowd_walk`: the constrained crowd walk with root-only locomotion
  constraints (the step goal one average step along the path, the goal's
  ground direction, the path as a trajectory), step by step: the step's
  GMM candidates (`sample_latents`), each one's exact constraint error
  (`exact_error`), the frozen-correspondence Levenberg-Marquardt
  refinement of the best (`choose`: gated by a threshold, kept where it
  lowers the exact error), then the time-warped back-projection, its
  alignment and seam blend onto the previous clip (`emit`), the travelled
  arc and the next node (`next_node`).
* `random_segments`: random graph walks that emit each step as a segment,
  their boundary transforms chained and every seam blended.

Every function takes the draws the program took (`Draws`) and works in the
dtype of the model it is given."""

from __future__ import annotations

import dataclasses
import math

import torch

from . import model as model_mod
from . import ops

TRAJ_SAMPLES = 16
DIR_WEIGHT = 0.8


@dataclasses.dataclass
class Draws:
    """One step's noise: Gumbel [C, n, K] picking each draw's component,
    standard normals [C, n, L], Gumbel [C, N] picking the transition."""

    comp_gumbel: torch.Tensor
    normal: torch.Tensor
    trans_gumbel: torch.Tensor


def sample_latents(m, node, draws: Draws) -> torch.Tensor:
    """n draws per character from its node's mixture -> [C, n, L]."""
    logits = torch.log(torch.clamp(m.weights[node], min=1e-30))
    comp = torch.argmax(logits[:, None, :] + draws.comp_gumbel.to(
        logits.dtype), -1)  # [C, n]
    nodes = node[:, None].expand_as(comp)
    chol = m.cov_chol[nodes, comp]  # [C, n, L, L]
    mu = m.means[nodes, comp]
    return mu + m.einsum("cnij,cnj->cni", chol, draws.normal.to(mu.dtype))


def next_node(m, node, want_end, trans_gumbel):
    """The uniform pick among the node's edges of type end (want_end) or
    standard -> (next [C], found [C])."""
    row = torch.where(want_end[:, None], m.edges[model_mod.END][node],
                      m.edges[model_mod.STANDARD][node])
    found = row.any(-1)
    logits = torch.where(row, 0.0, -math.inf).to(trans_gumbel.dtype)
    pick = torch.argmax(logits + trans_gumbel, -1)
    return torch.where(found, pick, node), found


def _coeffs(m, node, alpha):
    """Each latent's B-spline coefficients [..., n_basis, n_dim]."""
    return m.mean[node] + m.einsum("...bdk,...k->...bd", m.eigen[node],
                                   alpha)


def emit(m, node, s, prev_last, has_prev: bool, max_frames: int,
         window: int):
    """The clip of latents s [C, L]: time-warped back-projection, aligned
    and seam-blended onto prev_last [C, D] when has_prev -> (frames
    [C, T, D], n_frames [C], last frame [C, D], the unrounded end time
    [C] that set n_frames)."""
    k = m.k_s
    times, n_frames, t_end = ops.warped_times(m.mean_t[node], m.eigen_t[node],
                                       s[:, k:], m.n_canonical[node],
                                       max_frames, m.einsum)
    frames = m.einsum("ctb,cbd->ctd", ops.basis_matrix(m.knots[node], times),
                      _coeffs(m, node, s[:, :k]))
    if has_prev:
        q_y, delta = ops.aligning_transform(prev_last, frames[:, 0])
        frames = ops.seam_blend(prev_last, ops.transform_frames(
            frames, q_y, delta), window)
    rows = torch.arange(frames.shape[0], device=frames.device)
    return frames, n_frames, frames[rows, n_frames - 1], t_end


# ---------------------------------------------------------------------------
# The constrained crowd
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepContext:
    """What a step's constraints read, per character: node [C], the
    previous clip's last frame [C, D] (has_prev), the travelled arc [C], the
    goal point [C, 3] and ground direction [C, 2]."""

    node: torch.Tensor
    prev_last: torch.Tensor
    has_prev: bool
    travelled: torch.Tensor
    goal: torch.Tensor
    goal_dir: torch.Tensor
    root_offset: torch.Tensor

    def rows(self, idx):
        return dataclasses.replace(self, **{
            f: getattr(self, f)[idx] for f in ("node", "prev_last",
                                                "travelled", "goal",
                                                "goal_dir")})


def context(m, path, node, prev_last, has_prev, travelled, root_offset,
            end_threshold: float):
    """The step goal: one average step of the node past the travelled arc,
    or the path's end once that lies within end_threshold of it."""
    step = m.step_length[node]
    arc = torch.where(travelled + step >= path.full_arc - end_threshold,
                      path.full_arc, travelled + step)
    goal, goal_dir = path.point_and_dir(arc)
    return StepContext(node, prev_last, has_prev, travelled, goal, goal_dir,
                       root_offset)


def _query_times(n_can):
    """Canonical times of the rows the constraints read: the end keyframe
    (goal position), the end frame (direction), 16 trajectory samples."""
    end = (n_can - 1).to(torch.float64)
    lin = torch.linspace(0.0, 1.0, TRAJ_SAMPLES, dtype=torch.float64,
                         device=n_can.device)
    return torch.cat([end[..., None], end[..., None],
                      lin * torch.clamp(end, min=1.0)[..., None]], -1)


def root_rows(m, ctx: StepContext, alpha):
    """The aligned root rows of latents alpha [C, n, k] at the query times:
    (root positions [C, n, 18, 3] with the skeleton's root offset, root
    rotations [C, n, 18, 4])."""
    node = ctx.node[:, None].expand(alpha.shape[:2])
    coeffs = m.mean[node][..., :7] + m.einsum(
        "cnbdk,cnk->cnbd", m.eigen[node][..., :7, :], alpha)
    b = ops.basis_matrix(m.knots[ctx.node], _query_times(
        m.n_canonical[ctx.node]).to(alpha.dtype))  # [C, 18, nb]
    rows = m.einsum("cqb,cnbd->cnqd", b, coeffs)
    first = coeffs[:, :, 0]
    if ctx.has_prev:
        q_y, delta = ops.aligning_transform(
            ctx.prev_last[:, None].expand(first.shape[:2] + (-1,)), first)
    else:
        q_y = torch.zeros(first.shape[:2] + (4,), dtype=alpha.dtype,
                          device=alpha.device)
        q_y[..., 0] = 1.0
        delta = torch.zeros(first.shape[:2] + (3,), dtype=alpha.dtype,
                            device=alpha.device)
    pos = ops.q_rotate(q_y[:, :, None], rows[..., :3]) + delta[:, :, None] \
        + ctx.root_offset
    rot = ops.q_multiply(q_y[:, :, None].expand(rows.shape[:3] + (4,)),
                         rows[..., 3:7])
    return pos, rot


def _goal_and_dir(ctx, pos, rot):
    mask = torch.tensor([1.0, 0.0, 1.0], dtype=pos.dtype, device=pos.device)
    kf = torch.sqrt(torch.clamp(((pos[..., 0, :] - ctx.goal[:, None] * mask)
                                 * mask).pow(2).sum(-1), min=1e-12))
    x, z = ops.forward_xz(rot[..., 1, :])
    nrm = torch.clamp(torch.sqrt(x * x + z * z), min=1e-10)
    cos = torch.clamp((ctx.goal_dir[:, None, 0] * x
                       + ctx.goal_dir[:, None, 1] * z) / nrm, -1.0, 1.0)
    return kf, DIR_WEIGHT * torch.rad2deg(torch.arccos(cos))


def exact_error(m, path, ctx: StepContext, s):
    """The exact constraint error [C, n] of latents s [C, n, L]: goal
    distance + weighted direction error (degrees) + the mean distance of
    the 16 trajectory samples from the path (advancing closest points)."""
    pos, rot = root_rows(m, ctx, s[..., : m.k_s])
    kf, dir_err = _goal_and_dir(ctx, pos, rot)
    dist, _, _ = path.closest_points_advancing(pos[..., 2:, :],
                                               ctx.travelled)
    traj_on = (dist > 0).any(-1).to(dist.dtype)
    return kf + dir_err + traj_on * dist.mean(-1)


def _frozen_residuals(m, path, ctx, s_freeze, quality_scale: float):
    """The frozen-correspondence residual function s [C, L] -> [C, 18]: the
    goal, direction and trajectory rows with the trajectory's path points
    held at those s_freeze finds, each plus quality_scale * -log p(s)."""
    k = m.k_s
    pos0, _ = root_rows(m, ctx, s_freeze[:, None, :k])
    _, _, pts = path.closest_points_advancing(pos0[:, 0, 2:], ctx.travelled)
    mask = torch.tensor([1.0, 0.0, 1.0], dtype=s_freeze.dtype,
                        device=s_freeze.device)
    node = ctx.node

    def fn(s):
        pos, rot = root_rows(m, ctx, s[:, None, :k])
        kf, dir_err = _goal_and_dir(ctx, pos, rot)
        traj = torch.sqrt(torch.clamp((((pos[:, 0, 2:] - pts) * mask) ** 2)
                                      .sum(-1), min=1e-24))
        raw = torch.cat([kf, dir_err, traj], -1)  # [C, 18]
        nll = ops.gmm_neg_log_prob(s, m.weights[node], m.means[node],
                                   m.prec_chol[node], m.einsum)
        return raw + quality_scale * nll[:, None]

    return fn


def lm_refine(m, path, ctx, s0, n_iters: int, quality_scale: float = 0.1):
    """Fixed-iteration LM from s0 [C, L] on the frozen model: damped normal
    equations (Marquardt scaling, floor 1e-2 max diag), the step clipped to
    a trust radius; lambda x 0.1 (floor 1e-6) and the radius x 2 (cap 16)
    on a lowered sum of squares, lambda x 10 otherwise."""
    c = s0.shape[0]
    s = s0
    lam = torch.full((c,), 1e-3, dtype=s0.dtype, device=s0.device)
    radius = torch.ones((c,), dtype=s0.dtype, device=s0.device)
    for _ in range(n_iters):
        fn = _frozen_residuals(m, path, ctx, s, quality_scale)
        r = fn(s)
        j = _jacobian(fn, s)
        jtj = m.einsum("crl,crk->clk", j, j)
        dg = torch.diagonal(jtj, dim1=-2, dim2=-1)
        floor = torch.clamp(1e-2 * dg.amax(-1), min=1e-6)
        damp = torch.diag_embed(torch.maximum(dg, floor[:, None]))
        g = m.einsum("crl,cr->cl", j, r)
        delta = torch.linalg.solve(jtj + lam[:, None, None] * damp, g)
        nrm = torch.linalg.vector_norm(delta, dim=-1)
        delta = delta * torch.clamp(radius / torch.clamp(nrm, min=1e-10),
                                    max=1.0)[:, None]
        s_new = s - delta
        err, err_new = (r * r).sum(-1), (fn(s_new) ** 2).sum(-1)
        better = err_new < err
        s = torch.where(better[:, None], s_new, s)
        lam = torch.where(better, torch.clamp(lam * 0.1, min=1e-6), lam * 10.0)
        radius = torch.where(better, torch.clamp(radius * 2.0, max=16.0),
                             radius)
    return s


def _jacobian(fn, s):
    """d fn / d s [C, R, L] of a function whose characters are
    independent: forward mode, one tangent per latent dimension, the
    tangents batched."""
    eye = torch.eye(s.shape[1], dtype=s.dtype, device=s.device)

    def column(t):
        return torch.func.jvp(fn, (s,), (t.expand_as(s),))[1]

    return torch.func.vmap(column)(eye).permute(1, 2, 0)


@dataclasses.dataclass
class CrowdConfig:
    n_samples: int
    max_step_frames: int
    lm_iters: int
    lm_threshold: float
    window: int
    end_threshold: float = 20.0
    quality_scale: float = 0.1


def choose(m, path, ctx, s_pick, e_pick, cfg: CrowdConfig):
    """The gated refinement of the picked latents -> (refined [C, L], the
    refined latents' exact error [C]); the emitted latent is the refined
    one where e_pick >= the threshold and the refinement lowered the exact
    error."""
    s_opt = lm_refine(m, path, ctx, s_pick, cfg.lm_iters, cfg.quality_scale)
    e_opt = exact_error(m, path, ctx, s_opt[:, None])[:, 0]
    return s_opt, e_opt


def crowd_walk(m, path, start, n_steps: int, draws, cfg: CrowdConfig,
               root_offset):
    """The whole walk, the reference in the program's place -> (frames
    [C, S, T, D], n_frames [C, S], node ids [C, S] (-1 once done), the
    emitted latents [C, S, L])."""
    c = start.shape[0]
    dt, dev = m.mean.dtype, m.mean.device
    node, done = start.clone(), torch.zeros(c, dtype=torch.bool, device=dev)
    prev_last = torch.zeros((c, m.n_dim), dtype=dt, device=dev)
    travelled = torch.zeros(c, dtype=dt, device=dev)
    outs = []
    for t in range(n_steps):
        d = draws(t)
        ctx = context(m, path, node, prev_last, t > 0, travelled,
                      root_offset, cfg.end_threshold)
        cand = sample_latents(m, node, d)
        err = exact_error(m, path, ctx, cand)
        best = err.argmin(-1)
        rows = torch.arange(c, device=dev)
        s, e = cand[rows, best], err[rows, best]
        s_opt, e_opt = choose(m, path, ctx, s, e, cfg)
        use = (e >= cfg.lm_threshold) & (e_opt < e)
        s = torch.where(use[:, None], s_opt, s)
        frames, n_frames, last, _ = emit(m, node, s, prev_last, t > 0,
                                         cfg.max_step_frames, cfg.window)
        arc = path.closest_point(last[:, :3], travelled)
        want_end = arc >= path.full_arc - cfg.end_threshold
        nxt, found = next_node(m, node, want_end, d.trans_gumbel)
        is_end = torch.tensor([ty == model_mod.END for ty in m.node_type],
                              device=dev)[node]
        outs.append((frames, torch.where(done, 0, n_frames),
                     torch.where(done, -1, node), s))
        done = done | ~found | (want_end & is_end)
        node, prev_last, travelled = nxt, last, arc
    return tuple(torch.stack([o[i] for o in outs], 1) for i in range(4))


# ---------------------------------------------------------------------------
# Random walks, the segment form
# ---------------------------------------------------------------------------

def random_segments(m, start, n_steps: int, draws, max_frames: int,
                    window: int):
    """Random walks: one draw a step, standard transitions until the
    second-to-last step, then end; each step's clip a segment, the
    boundary transforms chained, every seam blended -> (frames
    [C, S, T, D], n_frames [C, S], node ids [C, S], unrounded end times
    [C, S])."""
    c = start.shape[0]
    dev = m.mean.device
    node, done = start.clone(), torch.zeros(c, dtype=torch.bool, device=dev)
    segs, counts, ids, ends = [], [], [], []
    for t in range(n_steps):
        d = draws(t)
        s = sample_latents(m, node, d)[:, 0]
        frames, n_frames, _, t_end = emit(m, node, s, None, False,
                                          max_frames, 0)
        ends.append(t_end)
        want_end = torch.full((c,), t >= n_steps - 2, device=dev)
        nxt, found = next_node(m, node, want_end, d.trans_gumbel)
        segs.append(frames)
        counts.append(torch.where(done, 0, n_frames))
        ids.append(torch.where(done, -1, node))
        node, done = nxt, done | ~found
    frames = torch.stack(segs, 1)
    n_frames = torch.stack(counts, 1)
    rows = torch.arange(c, device=dev)
    last_idx = torch.clamp(n_frames - 1, min=0)
    out = [frames[:, 0]]
    prev_last = frames[rows, 0, last_idx[:, 0]]
    for t in range(1, n_steps):
        q_y, delta = ops.aligning_transform(prev_last, frames[:, t, 0])
        aligned = ops.transform_frames(frames[:, t], q_y, delta)
        out.append(ops.seam_blend(prev_last, aligned, window))
        last = aligned[rows, last_idx[:, t]]
        prev_last = ops.hemisphere(last[:, None], prev_last)[:, 0]
    return (torch.stack(out, 1), n_frames, torch.stack(ids, 1),
            torch.stack(ends, 1))
