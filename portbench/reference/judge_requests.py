"""The comparisons that decide `correct` for one request of the service,
followed stage by stage from the program's own state: its steps (node,
emitted latent, frame range), each step's LM start and canonical clip,
the converted frames before the keyframe IK and the frames it answered.

The request's exact LM runs 10 iterations on up to 25 residual rows in 28
unknowns in float32; a float64 LM from the same start may end elsewhere,
so, as for the crowd (`judge.py`), each stage is checked alone:

* planning (`nodes_wrong`): each step's node against the reference's
  plan from the program's previous clip (its last root position, and the
  arc the reference's closest-point search finds for it); a decision
  whose comparison lies within GATE_TIE of flipping is a tie, either
  outcome allowed; a step too many or too few counts once;
* selection (`selection_wrong`): the program's LM start must be one of
  the pool's candidates whose exact error lies within the selection's
  margin of the best (`judge.SELECTION_MARGIN`);
* LM (`lm_shortfall`, `lm_stuck_share`): from the program's start, at a
  step the reference's refinement improves by MIN_IMPROVEMENT or more,
  (the exact error of the program's latent - the reference's) / the
  reference's improvement; the median over such steps and the share above
  STUCK;
* emission (`emit_gap`, cm): the reference's canonical clip of the
  program's latent onto its previous frame against the program's clip;
* the conversion (`frames_gap`, cm): each step's warped clip of the
  program's latent, aligned onto the program's converted frame before it,
  against the converted frames; `counts_wrong` counts frame counts that
  differ off a rounding tie (`judge.COUNT_TIE`) and frame ranges that do
  not tile the motion;
* the keyframe IK (`ik_shortfall`, cm): the program's keyframe miss after
  the IK less the reference's IK's from the same frame before it, at the
  keyframes the reference's IK reaches within IK_REACH; and
  (`ik_blend_gap`, cm) every answered frame against the reference's blend
  of the program's solved poses into the converted frames.

`steps_missing` is 1, and every other number not a number, when the
service handed out no MotionResult for the request."""

from __future__ import annotations

import math
import statistics

import torch

from . import requests as rq
from .judge import (COUNT_TIE, MIN_IMPROVEMENT, SAME_LATENT,
                    SELECTION_MARGIN, STUCK)

# cm: an end-condition comparison this close to flipping decides by
# rounding (the arc search's accuracy of 1e-3 cm, float32 arcs of up to
# 600 cm and root positions of ~100 cm)
GATE_TIE = 1e-2
# cm: a keyframe the reference's IK leaves farther than this from its
# target is out of reach; the damped Gauss-Newton steps then wander
# (float32 and float64 solves from one frame end up to 5 cm apart), so its
# miss is not judged (`ik_unreached` counts such keyframes)
IK_REACH = 1.0

NUMBERS = ("nodes_wrong", "counts_wrong", "steps_missing", "selection_wrong",
           "lm_shortfall", "lm_stuck_share", "emit_gap", "frames_gap",
           "ik_shortfall", "ik_blend_gap")


def missing() -> dict:
    out = {k: math.nan for k in NUMBERS}
    out.update(steps_missing=1, steps=0, lm_steps=0)
    return out


def _gap(a, b) -> float:
    return float((a - b).abs().max()) if a.numel() else 0.0


def request(m, skel: rq.Skeleton, graph: rq.Graph, obs: dict,
            s: rq.Settings) -> dict:
    """obs: the judged request's observations in float64 on the model's
    device: request (the JSON), steps [(key, latent [L], first frame,
    last frame)] or None, draws [(key, components, normals)], starts [L]
    and clips (frames [T, D], n) per step, pre_ik [T, D] or None, final
    [T, D] -> the numbers compared and a few notes."""
    if obs["steps"] is None:
        return missing()
    dt, dev = m.mean.dtype, m.mean.device
    start_pos, heading, actions = rq.parse(obs["request"])
    start = rq.start_transform(start_pos, heading, dt, dev)
    steps = obs["steps"]
    observed = (len(obs["starts"]) == len(steps)
                and len(obs["clips"]) == len(steps)
                and len(obs["draws"]) == len(steps))
    wrong = counts = off = 0
    emit_gap, shortfall = 0.0, []
    t, prev_key, prev_last = 0, None, None
    for action in actions:
        path = (None if action.points is None else rq.ops.Path(
            torch.as_tensor(action.points[None], dtype=dt, device=dev),
            s.granularity))
        full = None if path is None else float(path.full_arc[0])
        travelled, kinds = 0.0, {}
        allowed, end_ok = {graph.start_node(action.name, prev_key)}, False
        while True:
            if t >= len(steps) or steps[t][0][0] != action.name:
                wrong += not end_ok
                break
            key, latent = tuple(steps[t][0]), steps[t][1]
            wrong += key not in allowed
            st = rq.step_set(graph, action, path, key, travelled, prev_last,
                             kinds.get(key) == rq.END, start, s, dt, dev)
            if observed:
                off += _selection_off(m, skel, st, obs["draws"][t],
                                      obs["starts"][t])
                short = _lm_shortfall(m, skel, st, obs["starts"][t], latent,
                                      s)
                if short is not None:
                    shortfall.append(short)
                frames, n = obs["clips"][t]
                if n != st.n_canonical:
                    counts += 1
                else:
                    emit_gap = max(emit_gap, _gap(
                        frames[:n], rq.emit(m, st, latent, s.window)))
                prev_last = frames[n - 1]
            else:
                prev_last = None
            if path is not None and prev_last is not None:
                travelled = rq.closest_point(
                    path, prev_last[:3], travelled, travelled + s.look_ahead,
                    full, s)
            t, prev_key = t + 1, key
            allowed, kinds, end_ok = _next(graph, action, path, full, key,
                                           travelled, prev_last, s)
    wrong += max(len(steps) - t, 0)
    frames_gap, c_wrong, ranges = _conversion(m, graph, obs, start, s)
    ik_short, blend_gap, unreached = _ik(skel, graph, actions, ranges, obs,
                                         s)
    short = shortfall or [0.0]
    nan = math.nan
    return {"nodes_wrong": wrong, "counts_wrong": counts + c_wrong,
            "steps_missing": 0,
            "selection_wrong": off if observed else nan,
            "lm_shortfall": statistics.median(short) if observed else nan,
            "lm_stuck_share": (sum(v > STUCK for v in shortfall)
                               / len(shortfall) if shortfall else 0.0)
            if observed else nan,
            "emit_gap": emit_gap if observed else nan,
            "frames_gap": frames_gap, "ik_shortfall": ik_short,
            "ik_blend_gap": blend_gap,
            "lm_shortfall_max": max(short), "lm_steps": len(shortfall),
            "steps": len(steps), "ik_unreached": unreached,
            "stages_observed": int(observed)}


def _next(graph, action, path, full, key, travelled, prev_last, s):
    """After a step: (the nodes the next step may take, their edge types,
    whether the action may end here)."""
    stop = graph.node_type[key] in (rq.END, rq.SINGLE)
    tie = False
    if path is not None and not stop:
        tie = abs(travelled - full) < GATE_TIE
        stop = travelled >= full and not tie
    if stop:
        return set(), {}, True
    outcomes = [False]
    if path is not None and prev_last is not None:
        ended, margin = rq.end_condition(
            prev_last[:3].cpu().numpy(), travelled,
            graph.arc_of_end(action.name, s), full, action.points[-1])
        outcomes = [ended] if margin >= GATE_TIE else [True, False]
    kinds = {}
    for ended in outcomes:
        nxt, kind = graph.next_node(key, ended, path is not None)
        if nxt is not None:
            kinds[nxt] = kind
    return set(kinds), kinds, tie or not kinds


def _selection_off(m, skel, st, draws, start) -> int:
    """1 where the program's LM start is no candidate tied with the pool's
    best."""
    _, comp, z = draws
    cand = rq.pool(m, st.node, comp, z)
    err = rq.error(m, skel, st, cand)
    e_min = err.min()
    tied = err <= e_min + SELECTION_MARGIN[0] + SELECTION_MARGIN[1] * e_min
    same = ((cand - start).abs().amax(-1)
            <= SAME_LATENT * (1.0 + cand.abs().amax(-1)))
    return int(not bool((same & tied).any()))


def _lm_shortfall(m, skel, st, start, latent, s):
    """(program's exact error - reference's refined) / the reference's
    improvement, at a step it improves by MIN_IMPROVEMENT or more."""
    _, _, e0, e_opt = rq.refine(m, skel, st, start, s)
    e_ref = min(float(e0), float(e_opt))
    gain = float(e0) - e_ref
    if gain < MIN_IMPROVEMENT:
        return None
    e_prog = float(rq.error(m, skel, st, latent))
    return (e_prog - e_ref) / gain


def _conversion(m, graph, obs, start, s):
    """(the largest gap of a converted clip, frame counts and ranges that
    are wrong, the steps' (key, first, last) frames)."""
    pre, steps = obs["pre_ik"], obs["steps"]
    ranges = [(tuple(k), a, b) for k, _, a, b in steps]
    if pre is None:
        return math.nan, 0, ranges
    gap, wrong, expect = 0.0, 0, 0
    for key, latent, a, b in steps:
        if a != expect or b < a or b >= len(pre):
            wrong += 1
            expect = b + 1
            continue
        expect = b + 1
        prev = None if a == 0 else pre[a - 1]
        clip, n, t_end = rq.convert_clip(m, graph.index(key), latent, prev,
                                         start, s.window)
        if n != b - a + 1:
            tie = abs((t_end - math.floor(t_end)) - 0.5) < COUNT_TIE
            wrong += not tie
            continue
        gap = max(gap, _gap(pre[a: b + 1], clip))
    wrong += expect != len(pre)
    return gap, wrong, ranges


def _ik(skel, graph, actions, ranges, obs, s):
    """(the program's keyframe miss less the reference IK's, the largest
    gap of an answered frame from the reference's blend of the program's
    solved poses, the keyframes out of the reference IK's reach)."""
    pre, final = obs["pre_ik"], obs["final"]
    if pre is None:
        return math.nan, math.nan, 0
    if final.shape != pre.shape:
        return math.nan, math.inf, 0
    cur, shorts, unreached = pre.clone(), [], 0
    for fi, joint, pos in rq.ik_targets(graph, actions, ranges):
        fi = min(max(fi, 0), len(pre) - 1)
        want = torch.as_tensor(pos, dtype=pre.dtype, device=pre.device)
        free = torch.isnan(want)
        tip, _ = skel.joint(cur[fi], joint)
        target = torch.where(free, tip, want)
        solved = rq.ik(skel, cur[fi], joint, target, s)

        def miss(frame):
            p, _ = skel.joint(frame, joint)
            return float(torch.linalg.vector_norm(
                torch.where(free, torch.zeros_like(p), p - target)))

        if miss(solved) <= IK_REACH:
            shorts.append(miss(final[fi]) - miss(solved))
        else:
            unreached += 1
        cur = rq.blend(cur, fi, final[fi] - cur[fi], s.interpolation_window)
    return max(shorts, default=0.0), _gap(final, cur), unreached
