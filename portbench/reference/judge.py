"""The comparisons that decide `correct`: what the program emitted, judged
by the plain reference.

The constrained crowd is judged step by step from the program's own state:
its node, its previous clip's last frame, the arc that frame has travelled,
and the latent it emitted at the step.  Its LM solves normal equations of
18 residual rows in 28 unknowns in float32, so whole walks, and even one
LM's latent, part from a float64 reference by rounding alone; the stages
are therefore checked one by one:

* emit: the reference's clip of the program's latent (time warp,
  back-projection, alignment, seam blend) against the program's clip;
* transitions: the node each step went to, from the program's previous
  clip, against the reference's pick on the same draws;
* selection: at a step whose candidates within the selection kernel's
  precision of the best (`SELECTION_MARGIN`) all lie below the LM's
  threshold, the program must emit one of those candidates unchanged;
* LM: at a step whose best candidate the reference's LM improves by 0.1 or
  more, the program's shortfall, (its latent's exact error - the
  reference's refined error) / the reference's improvement: 0 where the
  program refines as the reference does, 1 where it returns its start.
  Two numbers are compared: the median over such steps, which a weaker LM
  raises, and the share of them whose shortfall exceeds STUCK, which an LM
  skipped for part of the batch raises (a sound float32 LM also returns
  its start at a few steps where float64 improves).

The random walks are judged whole: the reference walks the same draws
from the start."""

from __future__ import annotations

import torch

from . import model as model_mod
from . import walks

# A selection kernel ranks candidates to within 0.1 + 5e-3 |error| of their
# exact errors (its fp32 distance form, its polynomial atan2, its table
# search without refinement): candidates that close to the best are ties.
SELECTION_MARGIN = (0.1, 5e-3)
# a latent within this share of a candidate's size is that candidate
SAME_LATENT = 1e-4
# refinements that improve the exact error by less are not judged
MIN_IMPROVEMENT = 0.1
# an error within this share of the LM's threshold, or a travelled arc
# within this many cm of where the walk heads for its end, decides a gate
# by rounding: such steps and transitions are ties, not judged
GATE_TIE = 1e-3
# an LM step whose shortfall exceeds this has all but returned its start
STUCK = 0.5
# a clip's frame count is round(t_end) + 2: within this of a half, float32
# and float64 may round it apart, and the clip is a tie, not judged
COUNT_TIE = 1e-3


def _clips(frames, n, want, n_want, t_end):
    """(largest absolute difference of each clip over its valid frames, 0
    where not judged; 1 where the frame counts differ off a tie)."""
    t = torch.arange(frames.shape[1], device=frames.device)
    valid = (t[None] < n_want[:, None])[..., None]
    gap = torch.where(valid, (frames - want).abs(), torch.zeros_like(frames))
    gap = gap.flatten(1).amax(-1)
    tie = ((t_end - torch.floor(t_end)) - 0.5).abs() < COUNT_TIE
    same = n == n_want
    return (torch.where(same & ~tie, gap, torch.zeros_like(gap)),
            (~same & ~tie).long())


def crowd(m, path, root_offset, draws, frames, n_frames, node_ids, latents,
          cfg: walks.CrowdConfig) -> dict:
    """Judge a crowd walk's outputs (frames [C, S, T, D], n_frames [C, S],
    node ids [C, S]) and the latents it emitted [C, S, L], given the
    characters' draws and path rows -> {emit_gap: the largest gap of an
    emitted clip from the reference's clip of the same latent,
    counts_wrong: clips whose frame count differs from it (off a tie),
    nodes_wrong: transitions that differ, selection_wrong: steps below the
    threshold that emitted no tied candidate, lm_shortfall: the median
    shortfall, lm_stuck_share: the share of LM steps whose shortfall
    exceeds STUCK, lm_shortfall_max, lm_steps and steps: the steps judged,
    latents_missing: 0}."""
    c, n_steps = node_ids.shape
    dt, dev = m.mean.dtype, m.mean.device
    frames, latents = frames.to(dt), latents.to(dt)
    rows = torch.arange(c, device=dev)
    is_end = torch.tensor([ty == model_mod.END for ty in m.node_type],
                          device=dev)
    travelled = torch.zeros(c, dtype=dt, device=dev)
    prev_last = torch.zeros((c, m.n_dim), dtype=dt, device=dev)
    gap, wrong, counts, off, steps, shortfall = 0.0, 0, 0, 0, 0, []
    for t in range(n_steps):
        node = node_ids[:, t]
        if t > 0:
            before = node_ids[:, t - 1]
            prev_last = frames[rows, t - 1, torch.clamp(
                n_frames[:, t - 1] - 1, min=0)]
            arc = path.closest_point(prev_last[:, :3], travelled)
            want_end = arc >= path.full_arc - cfg.end_threshold
            safe = torch.clamp(before, min=0)
            nxt, found = walks.next_node(m, safe, want_end,
                                         draws[t - 1].trans_gumbel.to(dt))
            done = ~found | (want_end & is_end[safe])
            expect = torch.where(done, -1, nxt)
            tie = (arc - (path.full_arc - cfg.end_threshold)).abs() < GATE_TIE
            wrong += int(((before >= 0) & ~tie & (expect != node)).sum())
            travelled = arc
        live = torch.nonzero(node >= 0)[:, 0]
        if live.numel() == 0:
            continue
        steps += live.numel()
        lp = path.rows(live)
        s_prog = latents[live, t]
        out, n_out, _, t_end = walks.emit(m, node[live], s_prog,
                                          prev_last[live], t > 0,
                                          cfg.max_step_frames, cfg.window)
        g, c_wrong = _clips(frames[live, t], n_frames[live, t], out, n_out,
                            t_end)
        gap, counts = max(gap, float(g.max())), counts + int(c_wrong.sum())
        ctx = walks.context(m, lp, node[live], prev_last[live], t > 0,
                            travelled[live], root_offset, cfg.end_threshold)
        d = draws[t]
        cand = walks.sample_latents(m, node[live], walks.Draws(
            d.comp_gumbel[live], d.normal[live], d.trans_gumbel[live]))
        err = walks.exact_error(m, lp, ctx, cand)
        e_min, best = err.min(-1)
        tied = err <= (e_min + SELECTION_MARGIN[0]
                       + SELECTION_MARGIN[1] * e_min)[:, None]
        same = ((cand - s_prog[:, None]).abs().amax(-1)
                <= SAME_LATENT * (1.0 + cand.abs().amax(-1)))
        below = ~(tied & (err >= cfg.lm_threshold * (1 - GATE_TIE))).any(-1)
        off += int((below & ~(same & tied).any(-1)).sum())
        k = torch.arange(live.numel(), device=dev)
        s0, e0 = cand[k, best], e_min
        _, e_opt = walks.choose(m, lp, ctx, s0, e0, cfg)
        gain = e0 - torch.minimum(e_opt, e0)
        judged = (e0 >= cfg.lm_threshold) & (gain >= MIN_IMPROVEMENT)
        if bool(judged.any()):
            e_prog = walks.exact_error(m, lp, ctx, s_prog[:, None])[:, 0]
            shortfall += ((e_prog - torch.minimum(e_opt, e0)) / gain)[
                judged].tolist()
    short = torch.tensor(shortfall or [0.0], dtype=torch.float64)
    return {"emit_gap": gap, "counts_wrong": counts, "nodes_wrong": wrong,
            "selection_wrong": off,
            "lm_shortfall": float(short.median()),
            "lm_stuck_share": (float((short > STUCK).double().mean())
                               if shortfall else 0.0),
            "lm_shortfall_max": float(short.max()),
            "lm_steps": len(shortfall), "steps": steps,
            "latents_missing": 0}


def missing_latents(n_steps: int) -> dict:
    """The numbers of a crowd walk whose emitted latents were not seen: not
    a number, each, so that no limit holds, and latents_missing 1."""
    nan = float("nan")
    return {"emit_gap": nan, "counts_wrong": nan, "nodes_wrong": nan,
            "selection_wrong": nan, "lm_shortfall": nan,
            "lm_stuck_share": nan, "lm_shortfall_max": nan, "lm_steps": 0,
            "steps": n_steps, "latents_missing": 1}


def segments(m, start, draws, frames, n_frames, node_ids, max_frames: int,
             window: int) -> dict:
    """Judge random walks' outputs against the reference's own walks on the
    same draws -> {frames_gap: the largest gap of a segment, counts_wrong:
    segments whose frame count differs off a tie, nodes_wrong, steps}."""
    want, n_want, ids, t_end = walks.random_segments(
        m, start, len(draws), lambda t: draws[t], max_frames, window)
    gap, counts = 0.0, 0
    for t in range(node_ids.shape[1]):
        live = n_want[:, t] > 0
        if bool(live.any()):
            g, c_wrong = _clips(frames[:, t].to(want.dtype)[live],
                                n_frames[:, t][live], want[:, t][live],
                                n_want[:, t][live], t_end[:, t][live])
            gap, counts = max(gap, float(g.max())), counts + int(
                c_wrong.sum())
    return {"frames_gap": gap, "counts_wrong": counts,
            "nodes_wrong": int((ids != node_ids).sum()),
            "steps": int((n_want > 0).sum())}
