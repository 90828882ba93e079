"""Per-step constrained latent selection for the sequential request path
(port of morphablegraphs_tpu.synthesis.generator): best-of-N over a
candidate pool scored by the exact evaluator, Levenberg-Marquardt
refinement from the best start or the k best starts, and the step
epilogue (back-projection, alignment, the travelled-arc update).

The pool is drawn by the caller (`MotionGenerator`'s sampler hook), so the
JAX package's PRNG keys become pools [N, L] here.  The LM is the port's one
LM, `ops/lm.lm_minimize`, crowd-shaped: a single start is C = 1, k starts
are C = k; on a CUDA device it solves through kernel B2
(`kernels.chol_solve`) and takes its naturalness term from kernel B5
(`kernels.gmm_nll`), and the whole LM stage is replayed as one CUDA
graph per primitive and constraint layout (`LM_GRAPHS`).  The epilogue
back-projects through the frame-emit kernel (`kernels.emit_frames`, B6's
source).

Constraint sets reach this module as tensors with a leading [1] axis
(`device_constraints`); the pool and the k starts see them expanded to
their rows.  The JAX package's fused/split dispatch switch (MG_FUSED_STEP)
is a TPU round-trip knob with no counterpart in eager torch."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..constraints import compiled
from ..models.primitive import MotionPrimitive
from ..models.skeleton import Skeleton
from ..ops import (align, cuda_graphs, kernels, lm as lm_ops, spline_path,
                   timewarp)
from ..utils import profiling


def device_constraints(sc: compiled.StepConstraints,
                       device) -> compiled.StepConstraints:
    """A host-side constraint set (numpy leaves, the trajectory a
    PathSpline or None) -> tensors on `device` with a leading [1] axis."""
    def lead(a):
        return a[None] if torch.is_tensor(a) else np.asarray(a)[None]

    kw = {}
    for f in dataclasses.fields(compiled.StepConstraints):
        v = getattr(sc, f.name)
        if f.name in ("traj", "ts_trajs"):
            kw[f.name] = None if v is None else spline_path.map_leaves(v,
                                                                       lead)
        else:
            kw[f.name] = lead(v)
    return compiled.from_jax_numpy(compiled.StepConstraints(**kw), device)


def _rows(sc: compiled.StepConstraints, n: int) -> compiled.StepConstraints:
    """A [1, ...] device set expanded to n rows (views).  The
    trajectory-set stack stays one per set, as the walk keeps it."""
    kw = {}
    for f in dataclasses.fields(sc):
        v = getattr(sc, f.name)
        if f.name == "ts_trajs" or v is None:
            kw[f.name] = v
        elif f.name == "traj":
            kw[f.name] = spline_path.map_leaves(
                v, lambda a: a.expand((n,) + a.shape[1:]))
        else:
            kw[f.name] = v.expand((n,) + v.shape[1:])
    return compiled.StepConstraints(**kw)


def families(skeleton: Skeleton, sc_host: compiled.StepConstraints,
             use_dir: bool = False) -> dict:
    """The families a host set evaluates: the trajectory, collision
    avoidance and trajectory-set flags, and the single-slot families with
    an active slot (`compiled.active_families`; use_dir adds the direction
    the locomotion fill will set).  The others are 0, as they would be
    evaluated."""
    fams = compiled.active_families(sc_host)
    return dict(use_traj=bool(float(np.asarray(sc_host.traj_active)) > 0),
                use_ca=bool(np.asarray(sc_host.ca_active).sum() > 0),
                use_ts=bool(float(np.asarray(sc_host.ts_active)) > 0),
                families=fams | {"dir"} if use_dir else fams,
                root_only=root_only(skeleton, sc_host))


def root_only(skeleton: Skeleton, sc_host: compiled.StepConstraints) -> bool:
    """Every active slot of the host set is on the root (the locomotion
    slots the fill adds are too), and the root is animated joint 0: the
    residuals then read the root transform alone, the same values as the
    dense FK pass gives the root (`residuals_from_coeffs(root_only=True)`)."""
    return (compiled.frozen_closed_supported(skeleton)
            and compiled.step_scs_root_only(sc_host))


def score_pool(skeleton: Skeleton, prim: MotionPrimitive,
               sc: compiled.StepConstraints, pool: torch.Tensor,
               use_traj: bool = True, use_ca: bool = True,
               use_ts: bool = False, families=None,
               root_only: bool = False) -> torch.Tensor:
    """Exact constraint error of every candidate: pool [N, L] -> [N]."""
    res = compiled.evaluate_residuals(
        skeleton, prim, _rows(sc, pool.shape[0]), pool, use_traj=use_traj,
        use_ca=use_ca, use_ts=use_ts, families=families, root_only=root_only)
    return compiled.error_from_residuals(res)


def best_of_n(skeleton: Skeleton, pool: torch.Tensor, prim: MotionPrimitive,
              sc: compiled.StepConstraints, use_traj: bool = True,
              use_ca: bool = True, use_ts: bool = False, families=None,
              root_only: bool = False):
    """The best candidate of the pool [N, L] under the constraint error ->
    (s [L], error [])."""
    errors = score_pool(skeleton, prim, sc, pool, use_traj, use_ca, use_ts,
                        families, root_only)
    i = torch.argmin(errors)
    return pool[i], errors[i]


def _gmm_nll(prim: MotionPrimitive, s: torch.Tensor) -> torch.Tensor:
    """-log p [C] of latents s [C, L] under the primitive's mixture
    (kernel B5 on a CUDA device), differentiable in s."""
    g = prim.gmm
    mix = torch.zeros(s.shape[0], dtype=torch.long, device=s.device)
    return kernels.gmm_nll(s, g.weights[None], g.means[None],
                           g.prec_chol[None], mix)


def _lm_stage(skeleton: Skeleton, prim: MotionPrimitive,
              rows: compiled.StepConstraints, s0: torch.Tensor,
              n_iters: int, error_scale: float, quality_scale: float,
              init_lambda: float, use_traj: bool, use_ca: bool, use_ts: bool,
              families, root_only: bool):
    """The stage request.lm: `refine_lm` on the set expanded to the rows
    of s0 [C, L] -> (s_opt [C, L], the exact constraint error of s_opt
    [C])."""
    gate = dict(use_traj=use_traj, use_ca=use_ca, use_ts=use_ts)
    fam = dict(gate, families=families, root_only=root_only)
    active = compiled.active_mask(rows) * compiled.family_gate(s0.device,
                                                               **gate)

    def residuals(s):
        res = compiled.evaluate_residuals(skeleton, prim, rows, s, **fam)
        return active * (error_scale * res
                         + quality_scale * _gmm_nll(prim, s)[:, None])

    s_opt, _ = lm_ops.lm_minimize(residuals, s0, n_iters,
                                  init_lambda=init_lambda)
    err = compiled.error_from_residuals(compiled.evaluate_residuals(
        skeleton, prim, rows, s_opt, **fam))
    return s_opt, err


# request.lm as one CUDA graph for each primitive and constraint layout
# (counters request.lm.eager, .graph_captures, .graph_replays).  A service
# sees every primitive of its graph under each of its family sets, with
# and without a trajectory (the pick/carry/place service, 7 keys), more
# keys than a crowd has sizes
LM_GRAPHS = cuda_graphs.StageGraphs("request.lm", capacity=32)


def refine_lm(skeleton: Skeleton, prim: MotionPrimitive,
              sc: compiled.StepConstraints, s0: torch.Tensor,
              n_iters: int = 10, error_scale: float = 1.0,
              quality_scale: float = 0.1, init_lambda: float = 1e-3,
              use_traj: bool = True, use_ca: bool = True,
              use_ts: bool = False, families=None,
              root_only: bool = False):
    """LM from the starts s0 [C, L], one constraint set for all: the
    residual of every active slot is error_scale * r + quality_scale *
    (-log p(s)), inactive slots stay 0.  Returns (s_opt [C, L], the exact
    constraint error of s_opt [C]).  On a CUDA device the stage is one
    graph replay after a key's first, eager, sight (`LM_GRAPHS`)."""
    settings = (n_iters, error_scale, quality_scale, init_lambda, use_traj,
                use_ca, use_ts, families, root_only)
    # the graph's key: what the stage closes over; its reads: the
    # primitive's tables
    key = (skeleton, prim.n_basis, prim.n_dim, prim.n_spatial, n_iters,
           error_scale, quality_scale, init_lambda, use_traj, use_ca, use_ts,
           root_only, None if families is None else frozenset(families))
    g = prim.gmm
    return LM_GRAPHS.run(
        lambda rows, s: _lm_stage(skeleton, prim, rows, s, *settings),
        (_rows(sc, s0.shape[0]), s0), key,
        (prim.eigen_s, prim.mean_s, prim.knots_s, g.weights, g.means,
         g.prec_chol))


def _refine_starts(skeleton, prim, sc, starts, errs, threshold: float,
                   n_iters: int, error_scale: float, quality_scale: float,
                   **fam):
    """Refine every start of starts [k, L] (errors errs [k]) as one C = k
    LM when the best error is at or above threshold, keep the better of
    each start and its refinement, and return the best -> (s [L],
    error [])."""
    if float(errs.min()) >= threshold:  # the stage's one sync
        s_ref, e_ref = refine_lm(skeleton, prim, sc, starts, n_iters,
                                 error_scale, quality_scale, **fam)
        starts = torch.where((e_ref < errs)[:, None], s_ref, starts)
        errs = torch.minimum(errs, e_ref)
    # a [1] index: indexing by a 0-dim tensor reads it on the host, which
    # would wait here for the LM's device time
    j = torch.argmin(errs)[None]
    return starts[j][0], errs[j][0]


def selection_params(skeleton: Skeleton, sc_host: compiled.StepConstraints,
                     config: dict, use_dir: bool = False) -> dict:
    """The selection's settings from the config and the set's families
    (use_dir: the locomotion fill sets the direction)."""
    opt = config.get("local_optimization_settings", {})
    return dict(
        do_refine=config.get("local_optimization_mode", "all") != "none",
        threshold=float(opt.get("start_error_threshold", 0.0)),
        n_iters=int(config.get("lm_iterations", 10)),
        error_scale=float(opt.get("error_scale_factor", 1.0)),
        quality_scale=float(opt.get("quality_scale_factor", 0.1)),
        n_starts=int(config.get("n_lm_starts", 1)),
        **families(skeleton, sc_host, use_dir))


def cluster_pool(config: dict, node, device) -> Optional[torch.Tensor]:
    """The node's cluster-tree data [N, L] on `device` when the config
    selects constrained_sampling_mode="cluster_tree_search" and the node
    has a tree (the JAX package then ranks the whole tree data with the
    exact evaluator, `generator.py:377-380`); else None."""
    if (config.get("constrained_sampling_mode", "random_discrete")
            != "cluster_tree_search" or node.cluster_tree is None):
        return None
    return node.cluster_tree.device_data(device)


def generate_constrained_sample(skeleton: Skeleton, prim: MotionPrimitive,
                                sc: compiled.StepConstraints,
                                pool: torch.Tensor, p: dict):
    """Best-of-N over the pool [N, L], then the threshold-gated LM: from
    the best candidate (n_starts 1), or from the n_starts best as one
    C = n_starts LM.  p: `selection_params`.  Returns (s [L], error [])."""
    fam = {k: p[k] for k in ("use_traj", "use_ca", "use_ts", "families",
                             "root_only")}
    lm_kw = dict(threshold=p["threshold"], n_iters=p["n_iters"],
                 error_scale=p["error_scale"],
                 quality_scale=p["quality_scale"], **fam)
    with profiling.span("request.select"):
        errors = score_pool(skeleton, prim, sc, pool, **fam)
        if p["do_refine"] and p["n_starts"] > 1:
            k = min(p["n_starts"], pool.shape[0])
            neg, idx = torch.topk(-errors, k)
            starts, errs = pool[idx], -neg
        else:
            i = torch.argmin(errors)
            starts, errs = pool[i][None], errors[i][None]
    if not p["do_refine"]:
        return starts[0], errs[0]
    with profiling.span("request.lm"):
        return _refine_starts(skeleton, prim, sc, starts, errs, **lm_kw)


def generate_constrained_sample_loco(skeleton: Skeleton,
                                     prim: MotionPrimitive,
                                     sc: compiled.StepConstraints, path,
                                     loco: compiled.LocoSpec,
                                     loco_flags: tuple, pool: torch.Tensor,
                                     p: dict):
    """generate_constrained_sample after filling the locomotion slots from
    the path (path and loco with the set's leading [1] axis) -> (s, error,
    the filled set)."""
    sc = compiled.fill_locomotion_slots(sc, path, loco, *loco_flags)
    s, err = generate_constrained_sample(skeleton, prim, sc, pool, p)
    return s, err, sc


def finalize_step(prim: MotionPrimitive, s: torch.Tensor,
                  sc: compiled.StepConstraints, has_prev: bool, path,
                  travelled, max_frames: int, window: int, use_traj: bool,
                  look_ahead: Optional[float] = None, n_refine: int = 8):
    """The step epilogue: back-project s [L] on the canonical timeline,
    align it to the motion so far (has_prev: onto sc.prev_last, the seam
    smoothed over `window` frames) or place it at the start pose, and with
    use_traj advance the travelled arc to the closest point of the clip's
    last root position within [travelled, travelled + look_ahead] (look_ahead
    None: unbounded).  On a CUDA device the back-projection, alignment and
    smoothing are one launch of `kernels.emit_frames`.  Returns (frames
    [max_frames, D], n_frames int32 tensor, travelled [1] tensor)."""
    dev = s.device
    with profiling.span("request.emit"):
        t_fn, n_frames = timewarp.linear_time_function(
            prim.n_canonical_frames, max_frames, device=dev)
        frames, last = kernels.emit_frames(
            s[None, : prim.n_spatial], prim.eigen_s[None], prim.mean_s[None],
            prim.knots_s[None], torch.zeros(1, dtype=torch.long, device=dev),
            t_fn[None], n_frames[None], sc.prev_last if has_prev else None,
            has_prev, window if has_prev else 0)
        if not has_prev:
            frames = align.transform_frames(frames, sc.start_q,
                                            sc.start_delta)
            last = frames[:, torch.clamp(n_frames - 1, min=0)]
    travelled = torch.as_tensor(travelled, dtype=torch.float32,
                                device=dev).reshape(1)
    if use_traj:
        bounded = look_ahead is not None
        _, travelled, _ = spline_path.closest_point(
            path, last[:, :3], travelled, n_refine=n_refine,
            max_arc_length=travelled + look_ahead if bounded else None,
            bounded=bounded)
    return frames[0], n_frames, travelled


def generate_step(skeleton: Skeleton, prim: MotionPrimitive,
                  sc: compiled.StepConstraints, has_prev: bool, pool,
                  p: dict, travelled, max_frames: int, window: int,
                  path=None, loco=None, loco_flags=None,
                  look_ahead: Optional[float] = None, n_refine: int = 8):
    """A constrained step: selection (+ LM) and the epilogue.  With loco
    the locomotion slots fill from the path first and the travelled arc
    advances along it; without, the arc stays.  Returns (s [L], error [],
    the filled set, frames [max_frames, D], n_frames, travelled [1])."""
    if loco is not None:
        s, err, sc = generate_constrained_sample_loco(
            skeleton, prim, sc, path, loco, loco_flags, pool, p)
    else:
        s, err = generate_constrained_sample(skeleton, prim, sc, pool, p)
    frames, n_frames, new_arc = finalize_step(
        prim, s, sc, has_prev, path, travelled, max_frames, window,
        use_traj=loco is not None, look_ahead=look_ahead, n_refine=n_refine)
    return s, err, sc, frames, n_frames, new_arc


def unconstrained_step(prim: MotionPrimitive, s: torch.Tensor,
                       sc: compiled.StepConstraints, has_prev: bool,
                       travelled, max_frames: int, window: int):
    """An unconstrained step: the drawn latent s [L] and the epilogue,
    the travelled arc unchanged -> (s, frames, n_frames, travelled [1])."""
    frames, n_frames, new_arc = finalize_step(
        prim, s, sc, has_prev, None, travelled, max_frames, window,
        use_traj=False)
    return s, frames, n_frames, new_arc
