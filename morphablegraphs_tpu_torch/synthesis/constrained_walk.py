"""Constrained crowd walks (port of morphablegraphs_tpu.synthesis.
constrained_walk): `constrained_walk_full` with the fused selection kernels
(pallas_selection=True, and pallas_ee for one end-effector keyframe) or the
general selection path (pallas_selection=False: every candidate through the
exact evaluator, any constraint family), and the lightweight boundary-row
`constrained_walk`.  WalkConfig's family flags are the JAX walk's: use_traj
(the path's trajectory), use_ca (collision avoidance), use_ts (trajectory
sets) and use_half (the half-step keyframe in slot 1); a user slot of a
family whose flag is off is refused at the crowd boundary, never scored 0.

The crowd is an explicit leading [C] axis and the JAX scan a Python loop
over `full_walk_step`.  Per step and character:
  1. the locomotion goal (goal keyframe + 2D direction, with use_half the
     half-step keyframe) and the trajectory constraint from the travelled
     arc are filled from path queries;
  2. n_samples GMM candidates are ranked by kernel B1 (with an end-effector
     keyframe, B3), and the winner is re-scored by the exact evaluator
     (root-only, or the dense FK pass when a slot is on another joint);
     without pallas_selection the exact evaluator ranks them itself, with
     every family the step's sets carry;
  3. where that error is >= lm_threshold, lm_iters LM iterations refine it,
     kept only if the exact error improves: the exact LM by default, or the
     frozen-correspondence LM (closed form or linearize form).  The normal
     equations of the whole crowd go through kernel B2, or the whole step
     block through kernel B4; every LM form takes its GMM naturalness
     term from kernel B5 (the closed frozen form its gradient too, the
     exact and linearize forms through `kernels.gmm_nll`).  The JAX
     lax.cond gate is a masked select per character, as under vmap.  On a
     CUDA device the closed frozen form's gated stage is replayed as one
     CUDA graph per crowd layout (`LM_GRAPHS`);
  4. the winner is back-projected with time warping, aligned and
     seam-smoothed (`kernels.emit_frames`: one kernel on a CUDA device), the
     travelled arc advances, and the next node is drawn.
Random draws come in through `walk.StepDraws`, so a caller can replay
another generator's noise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..constraints import compiled
from ..models.graph import (NODE_TYPE_END, NODE_TYPE_IDS, NODE_TYPE_STANDARD,
                            StackedGraph, TRANSITION_TYPE_IDS)
from ..models.skeleton import Skeleton
from ..ops import align, cuda_graphs, kernels, lm, quat, spline_path
from ..utils import profiling
from . import walk as walk_mod


@dataclasses.dataclass
class WalkState:
    """Per-character walk state, all [C] except prev_last [C, D]."""

    node_id: torch.Tensor  # int64
    prev_last: torch.Tensor  # last aligned frame so far
    travelled: torch.Tensor  # arc length on the path
    done: torch.Tensor  # bool


@dataclasses.dataclass
class StepOutput:
    frames: torch.Tensor  # [C, max_step_frames, D] aligned segment
    n_frames: torch.Tensor  # [C] int32 valid frames (0 once done)
    node_id: torch.Tensor  # [C] node of this step (-1 once done)
    error: torch.Tensor  # [C] constraint error of the emitted latent
    # [C] the best-of-N selection error before the LM (full walk only)
    pre_lm_error: Optional[torch.Tensor] = None


@dataclasses.dataclass
class WalkConfig:
    """The settings callers choose; defaults are constrained_walk_full's,
    but for pallas_selection.

    pallas_selection: rank the candidates with the selection kernels (B1, or
    with pallas_ee B3), which score the locomotion family only, and re-score
    the winner exactly.  True here, because the port's main path runs the
    kernels; the JAX package's default is False.  Without it every
    candidate goes through the exact evaluator, n_samples need not be a
    multiple of 128, and any user slot the residuals evaluate may be set.
    pallas_ee: joint name of the one end-effector keyframe (user slot 2)
    that selection scores with kernel B3; lm_frozen: the frozen-
    correspondence LM instead of the exact one, in its closed form when
    lm_frozen_closed (else the linearize form); frozen_ee: the end-effector
    joint the frozen LM models beside the root; lm_fused_step: the LM step
    block as kernel B4 (the JAX package's MG_LM_PALLAS_DELTA=1), else its
    solve through kernel B2.

    window: frames of seam smoothing (0: none); error_scale, quality_scale:
    the LM's weights of the constraint residuals and of the GMM naturalness
    term; step_length_factor: the step goal in average step lengths;
    end_threshold: arc left on the path from which the walk heads for its
    end; pos_weight, dir_weight, traj_weight: weights of the goal keyframe,
    the 2D direction and the trajectory; use_traj: evaluate the trajectory
    family; use_ca, use_ts: evaluate the collision-avoidance and the
    trajectory-set slots (off by default, as in the JAX walk; a set that
    carries such a slot needs its flag); use_half: the half-step keyframe
    (half a step along the path at the middle keyframe) in slot 1, which
    the selection kernels do not score, so it needs pallas_selection=False;
    root_node: skeleton index of the joint that follows the path;
    return_pre_lm_err: also return each step's best-of-N selection error
    before the LM."""

    max_step_frames: int = 128
    n_samples: int = 128
    lm_iters: int = 5
    lm_threshold: float = 0.0
    pallas_selection: bool = True
    pallas_ee: Optional[str] = None
    lm_frozen: bool = False
    lm_frozen_closed: bool = True
    frozen_ee: Optional[str] = None
    lm_fused_step: bool = False
    window: int = 20
    error_scale: float = 1.0
    quality_scale: float = 0.1
    step_length_factor: float = 1.0
    end_threshold: float = 20.0
    pos_weight: float = 1.0
    dir_weight: float = 0.8
    traj_weight: float = 1.0
    use_traj: bool = True
    use_ca: bool = False
    use_ts: bool = False
    use_half: bool = False
    root_node: int = 0
    return_pre_lm_err: bool = False


# rows (characters x candidates) the general selection path evaluates at
# once; a crowd with more goes through the exact evaluator in chunks
MAX_EXACT_ROWS = 32768


def stack_steps(base: compiled.StepConstraints, n_steps: int):
    """n_steps copies of a host-side constraint set (numpy leaves; the
    trajectory-set stack's leaves too)."""
    def steps(a):
        a = np.asarray(a)
        return np.broadcast_to(a, (n_steps,) + a.shape)

    return dataclasses.replace(base, **{
        f.name: (spline_path.map_leaves(getattr(base, f.name), steps)
                 if f.name == "ts_trajs" else steps(getattr(base, f.name)))
        for f in dataclasses.fields(base) if f.name != "traj"})


def default_step_scs(skeleton: Skeleton, n_steps: int):
    """n_steps copies of the empty constraint set (numpy leaves)."""
    return stack_steps(compiled.empty_step_constraints(skeleton, 0), n_steps)


def check_pallas_selection_contract(skeleton: Skeleton, step_scs,
                                    pallas_ee: Optional[str] = None):
    """The selection kernels rank candidates on the locomotion family (plus,
    with pallas_ee, one position-only keyframe on that joint in slot 2):
    refuse user constraint slots they would silently ignore."""
    if pallas_ee is not None:
        if not compiled.step_scs_pallas_ee_only(
                step_scs, skeleton.index_of(pallas_ee)):
            raise ValueError(
                "the end-effector selection kernel ranks candidates on the "
                "locomotion family plus ONE position-only keyframe on "
                f"'{pallas_ee}' in slot 2; step_scs carries other user "
                "slots that would be ignored")
    elif not compiled.step_scs_locomotion_only(step_scs):
        raise ValueError(
            "the selection kernel ranks candidates on the locomotion family "
            "only; step_scs carries user constraint slots that would be "
            "ignored")
    if not compiled.frozen_closed_supported(skeleton):
        raise ValueError("the selection kernels read the root rotation from "
                         "channels 3:7: the root must be animated joint 0")


def check_walk_contract(skeleton: Skeleton, step_scs, cfg: WalkConfig,
                        root_only: bool):
    """The host-side guards of constrained_walk_full_crowd: no active slot
    of a family the walk's flags leave unscored (collision avoidance
    without use_ca, a trajectory set without use_ts); with
    cfg.pallas_selection the selection kernels' contract (n_samples in
    tiles of 128, no half step and no user slot they would ignore), and
    the frozen LM's model (root-only slots, or root slots plus one
    position-only keyframe on frozen_ee in slot 2; the closed form would
    score a slot on any other joint against the root)."""
    for flag, name, active in (("use_ca", "collision-avoidance",
                                step_scs.ca_active),
                               ("use_ts", "trajectory-set",
                                step_scs.ts_active)):
        if not getattr(cfg, flag) and np.any(np.asarray(active) > 0):
            raise ValueError(f"step_scs carries {name} slots, which the "
                             f"walk scores only with {flag}=True")
    if cfg.pallas_selection:
        if cfg.n_samples % kernels.N_BLK != 0:
            raise ValueError(
                f"pallas_selection needs n_samples % {kernels.N_BLK} == 0")
        if cfg.use_half:
            raise ValueError(
                "pallas_selection scores the locomotion goal only; the "
                "half-step keyframe slot would be ignored during ranking")
        check_pallas_selection_contract(skeleton, step_scs, cfg.pallas_ee)
    elif cfg.pallas_ee is not None:
        raise ValueError("pallas_ee requires pallas_selection")
    if cfg.lm_frozen and not root_only:
        if cfg.frozen_ee is None:
            raise ValueError("lm_frozen needs root-only slots or a single "
                             "end-effector joint via frozen_ee; anything "
                             "else needs the exact LM")
        if not compiled.step_scs_pallas_ee_only(
                step_scs, skeleton.index_of(cfg.frozen_ee)):
            raise ValueError(
                "lm_frozen+frozen_ee models root slots plus ONE "
                f"position-only keyframe on '{cfg.frozen_ee}' in slot 2; "
                "step_scs carries other user slots - use the exact LM")


def step_constraints(step_scs, step_idx: int, n_chars: int,
                     device) -> compiled.StepConstraints:
    """Step step_idx of the host-side sets, broadcast to [C, ...] tensors
    (the trajectory-set splines to [C, J, ...] views of one copy)."""
    sc = compiled.from_jax_numpy(dataclasses.replace(step_scs, **{
        f.name: (spline_path.map_leaves(step_scs.ts_trajs,
                                        lambda a: np.asarray(a)[step_idx])
                 if f.name == "ts_trajs"
                 else np.asarray(getattr(step_scs, f.name))[step_idx])
        for f in dataclasses.fields(step_scs) if f.name != "traj"}),
        device)

    def crowd(t):
        return t.expand((n_chars,) + t.shape)

    return dataclasses.replace(sc, **{
        f.name: (spline_path.map_leaves(sc.ts_trajs, crowd)
                 if f.name == "ts_trajs"
                 else crowd(getattr(sc, f.name)).clone())
        for f in dataclasses.fields(sc) if f.name != "traj"})


def _gmm_nll(g: StackedGraph, node_id: torch.Tensor,
             s: torch.Tensor) -> torch.Tensor:
    """-log p [C] of latents s [C, L] under each character's node mixture
    (kernel B5 on a CUDA device), differentiable in s."""
    return kernels.gmm_nll(s, g.gmm_weights, g.gmm_means, g.gmm_prec_chol,
                           node_id)


def _aligned_coeffs(g: StackedGraph, node_id, sc, s, root_only: bool = True):
    """Aligned B-spline coefficients of latents s [C, L]: with root_only
    the root form [C, n_basis, ROOT_FORM] the root-only residuals read
    (channels 0:7 and the joint-rotation slot's quaternion block,
    `compiled.root_form_channels`), else every channel [C, n_basis,
    n_dim]."""
    c = s.shape[0]
    e = g.eigen_s[node_id].reshape(c, g.n_basis_max, g.n_dim, -1)
    mu = g.mean_s[node_id].reshape(c, g.n_basis_max, g.n_dim)
    if root_only:
        ch = compiled.root_form_channels(sc.jr_joint)[:, None, :].expand(
            c, g.n_basis_max, compiled.ROOT_FORM)
        e = torch.gather(e, 2, ch[..., None].expand(ch.shape + e.shape[-1:]))
        mu = torch.gather(mu, 2, ch)
    coeffs = torch.einsum("cbhk,ck->cbh", e, s[:, : g.k_s_max]) + mu
    q_prev, d_prev = align.node_aligning_2d_transform(sc.prev_last,
                                                      coeffs[:, 0])
    use_prev = (sc.has_prev > 0)[:, None]
    q_y = torch.where(use_prev, q_prev, sc.start_q)
    delta = torch.where(use_prev, d_prev, sc.start_delta)
    return align.transform_frames(coeffs, q_y, delta)


def _families(cfg: WalkConfig) -> dict:
    """The family flags of a WalkConfig, as residuals_from_coeffs takes
    them."""
    return dict(use_traj=cfg.use_traj, use_ca=cfg.use_ca, use_ts=cfg.use_ts)


def _residuals(skeleton: Skeleton, g: StackedGraph, node_id, sc, s,
               root_only: bool, **families):
    """The exact constraint residuals [C, R] of latents s [C, L] (the JAX
    walk's stacked_residuals)."""
    return compiled.residuals_from_coeffs(
        skeleton, g.knots_s[node_id], sc,
        _aligned_coeffs(g, node_id, sc, s, root_only), root_only=root_only,
        **families)


def exact_error(skeleton: Skeleton, g: StackedGraph, node_id, sc, s,
                root_only: bool = True, use_traj: bool = True,
                use_ca: bool = False, use_ts: bool = False):
    """Exact constraint error [C] of latents s [C, L] (the JAX package's
    stacked_error: root-only, or the dense FK pass)."""
    return compiled.error_from_residuals(_residuals(
        skeleton, g, node_id, sc, s, root_only, use_traj=use_traj,
        use_ca=use_ca, use_ts=use_ts))


def _repeat_rows(tree, n: int):
    """A dataclass of [C, ...] tensors with every row repeated n times, the
    copies side by side ([C * n, ...]); nested dataclasses (the trajectory)
    likewise.  The trajectory-set splines stay one per character: their
    query groups the repeated rows (`compiled._ts_targets`)."""
    kw = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if f.name == "ts_trajs":
            kw[f.name] = v
        else:
            kw[f.name] = (_repeat_rows(v, n) if dataclasses.is_dataclass(v)
                          else v.repeat_interleave(n, dim=0))
    return type(tree)(**kw)


def _rank_exact(skeleton, g, node, sc, samples, root_only: bool,
                cfg: WalkConfig):
    """The general selection path (the JAX walk's vmapped stacked_error):
    the exact error of every candidate, samples [C, N, L] -> [C, N], in
    chunks of candidates where C * N rows pass MAX_EXACT_ROWS."""
    c, n, _ = samples.shape
    per = max(1, min(n, MAX_EXACT_ROWS // max(c, 1)))
    errors = []
    for j0 in range(0, n, per):
        sub = samples[:, j0: j0 + per]
        m = sub.shape[1]
        errors.append(exact_error(
            skeleton, g, node.repeat_interleave(m), _repeat_rows(sc, m),
            sub.reshape(c * m, -1), root_only, **_families(cfg)).reshape(
                c, m))
    return torch.cat(errors, dim=1)


def _select(g, state, sc, samples, path, path_table, goal_arc,
            n_can_f, root_off, cfg: WalkConfig, ee=None):
    """Rank candidates with kernel B1, or with ee = (chain_idx, chain [L, 8])
    kernel B3 scoring the end-effector slot 2 too -> winner latents
    [C, L]."""
    goal_pos, goal_dir = spline_path.point_and_dir_at_arc_length(path,
                                                                 goal_arc)
    node = state.node_id
    mop = kernels.selection_operator(
        g.eigen_s[node], g.mean_s[node], g.knots_s[node], g.n_basis_max,
        g.n_dim, goal_frame=n_can_f - 1.0, dir_frame=n_can_f - 1.0,
        n_canonical=n_can_f,
        ee_frame=None if ee is None else sc.kf_frame[:, 2],
        ee_chain_idx=None if ee is None else ee[0])
    ee_kw = {} if ee is None else dict(
        ee_active=sc.kf_active[:, 2], ee_weight=sc.kf_weight[:, 2],
        ee_target=sc.kf_pos[:, 2], ee_mask=sc.kf_pos_mask[:, 2])
    cfg = kernels.pack_selection_cfg(
        path, align.heading_angle(state.prev_last[:, 3:7]),
        state.prev_last[:, :3], align.heading_angle(sc.start_q),
        sc.start_delta, sc.has_prev, goal_pos, goal_dir, state.travelled,
        kf_weight=cfg.pos_weight, dir_weight=cfg.dir_weight,
        traj_active=1.0 if cfg.use_traj else 0.0,
        traj_weight=cfg.traj_weight,
        range_lo=sc.traj_range_start, range_hi=sc.traj_range_end,
        root_offset=root_off, **ee_kw)
    errors = kernels.score_locomotion_candidates(
        mop.contiguous(), samples[:, :, : g.k_s_max].contiguous(),
        path_table, cfg, chain=None if ee is None else ee[1])
    best = torch.argmin(errors, dim=1)
    return samples[torch.arange(samples.shape[0], device=samples.device),
                   best]


def _lm_mask(sc, cfg: WalkConfig) -> torch.Tensor:
    """The LM's residual mask: active slots of the families the walk
    evaluates (a slot of a family compiled out would degenerate to
    quality_scale * nll)."""
    return compiled.active_mask(sc) * compiled.family_gate(
        sc.kf_active.device, cfg.use_traj, cfg.use_ca, cfg.use_ts)


def lm_residual_fn(skeleton: Skeleton, g: StackedGraph, node_id, sc,
                   root_only: bool, cfg: Optional[WalkConfig] = None):
    """The exact LM's residual function s [C, L] -> [C, R]: the masked
    constraint residuals plus the GMM naturalness term -log p(s), as JAX
    constrained_walk_full's `residuals`.  The GMM term is `kernels.gmm_nll`:
    one launch of kernel B5 per evaluation, whose gradient gives all the
    jacobian columns of the term under `lm.linearize`.  cfg gives
    error_scale, quality_scale and the family flags (default:
    WalkConfig's)."""
    cfg = cfg or WalkConfig()
    act = _lm_mask(sc, cfg)
    es, qs = cfg.error_scale, cfg.quality_scale

    def residuals(sv):
        r = _residuals(skeleton, g, node_id, sc, sv, root_only,
                       **_families(cfg))
        return act * (es * r + qs * _gmm_nll(g, node_id, sv)[:, None])

    return residuals


def _refine(skeleton, g, node_id, sc, s0, e0, cfg: WalkConfig,
            root_only: bool):
    """LM refinement of every character (JAX constrained_walk_full's
    `refine`): the exact LM, or with cfg.lm_frozen the frozen model in its
    closed or linearize form.  Returns (s, err) where the exact error
    improved, else (s0, e0)."""
    act = _lm_mask(sc, cfg)
    es, qs = cfg.error_scale, cfg.quality_scale
    lm_kw = dict(fused_step=cfg.lm_fused_step)

    if not cfg.lm_frozen:
        s_opt, _ = lm.lm_minimize(
            lm_residual_fn(skeleton, g, node_id, sc, root_only, cfg), s0,
            cfg.lm_iters, **lm_kw)
    else:
        ee_idx = (skeleton.index_of(cfg.frozen_ee)
                  if cfg.frozen_ee is not None and not root_only else None)
        args = (skeleton, g.knots_s[node_id], sc, g.eigen_s[node_id],
                g.mean_s[node_id], g.n_basis_max, g.n_dim, g.k_s_max)
        fam = dict(use_traj=cfg.use_traj, use_ca=cfg.use_ca, ee_node=ee_idx)
        if cfg.lm_frozen_closed and compiled.frozen_closed_supported(
                skeleton):
            raw_make = compiled.make_frozen_root_residuals_closed(
                *args, **fam)
            n_lat = s0.shape[1]

            tables = (g.gmm_weights, g.gmm_means, g.gmm_prec_chol)

            def make_vj(sv):
                r_raw, j_raw, vfn = raw_make(sv)
                # kernel B5 on a CUDA device: the value and its gradient
                nll_s, g_nll = kernels.gmm_nll_and_grad(sv, *tables, node_id)
                j_pad = torch.nn.functional.pad(
                    j_raw, (0, n_lat - j_raw.shape[2]))
                r = act * (es * r_raw + qs * nll_s[:, None])
                j = act[:, :, None] * (es * j_pad + qs * g_nll[:, None, :])

                def value(x):  # B5 without its gradient pass
                    logp_x = kernels.gmm_scores(x, *tables, mix_id=node_id)
                    return act * (es * vfn(x) - qs * logp_x[:, None])

                return r, j, value

            s_opt, _ = lm.lm_minimize(None, s0, cfg.lm_iters,
                                      make_value_jac_fn=make_vj, **lm_kw)
        else:
            raw_make = compiled.make_frozen_root_residuals(*args, **fam)

            def make_fn(sv):
                rf = raw_make(sv)
                return lambda x: act * (
                    es * rf(x) + qs * _gmm_nll(g, node_id, x)[:, None])

            s_opt, _ = lm.lm_minimize(None, s0, cfg.lm_iters,
                                      make_residual_fn=make_fn, **lm_kw)
    e_opt = exact_error(skeleton, g, node_id, sc, s_opt, root_only,
                        **_families(cfg))
    better = e_opt < e0
    return (torch.where(better[:, None], s_opt, s0),
            torch.minimum(e0, e_opt))


def _lm_stage(skeleton, g, node_id, sc, s, err, cfg: WalkConfig,
              root_only: bool):
    """The gated LM refinement, stage walk.lm: `_refine`'s (s, err) where
    the selection error err is at least cfg.lm_threshold, else s and err
    as they came."""
    s_ref, err_ref = _refine(skeleton, g, node_id, sc, s, err, cfg,
                             root_only)
    gate = err >= cfg.lm_threshold
    return (torch.where(gate[:, None], s_ref, s),
            torch.where(gate, err_ref, err))


# walk.lm as one CUDA graph for each crowd layout (counters walk.lm.eager,
# .graph_captures, .graph_replays)
LM_GRAPHS = cuda_graphs.StageGraphs("walk.lm")


def _lm_graph_key(skeleton, g: StackedGraph, cfg: WalkConfig,
                  root_only: bool):
    """What walk.lm closes over (`cuda_graphs`): the skeleton, root_only,
    the graph's widths and the whole WalkConfig; None, to run it eagerly,
    for the exact LM and the frozen linearize form."""
    if not (cfg.lm_frozen and cfg.lm_frozen_closed
            and compiled.frozen_closed_supported(skeleton)):
        return None
    return (skeleton, root_only, g.n_basis_max, g.n_dim, g.k_s_max,
            tuple(getattr(cfg, f.name) for f in dataclasses.fields(cfg)))


def full_walk_step(skeleton: Skeleton, g: StackedGraph,
                   path: spline_path.PathSpline, path_table: torch.Tensor,
                   state: WalkState, step_idx: int,
                   sc0: compiled.StepConstraints, draws: walk_mod.StepDraws,
                   cfg: WalkConfig, root_only: bool, ee_chain=None):
    """One step of the crowd walk -> (new WalkState, StepOutput).

    path: the characters' PathSplines ([C] leading axis); path_table:
    `kernels.pack_path_table(path, root offset)`; sc0: this step's user
    constraint set as [C, ...] tensors; root_only: every active slot is on
    the root (`compiled.step_scs_root_only`); ee_chain: with cfg.pallas_ee,
    `kernels.pack_ee_chain`'s (chain_idx, chain [L, 8] tensor)."""
    dev = state.travelled.device
    c = state.node_id.shape[0]
    node = state.node_id
    has_prev = 1.0 if step_idx > 0 else 0.0
    n_can_f = g.n_canonical[node].float()
    root_off = torch.as_tensor(skeleton.offsets[0], device=dev)

    # each stage is a span (walk.*) of the walk's root, and a range of a
    # torch.profiler trace while one records
    with profiling.span("walk.goal"):
        step_len = g.avg_step_length[node] * cfg.step_length_factor
        goal_arc = _goal_arc(g, state, path.full_arc_length,
                             cfg.step_length_factor, cfg.end_threshold)
        sc = sc0.replace(
            traj=path,
            traj_active=torch.full((c,), 1.0 if cfg.use_traj else 0.0,
                                   device=dev),
            traj_node=torch.full((c,), cfg.root_node, device=dev),
            traj_min_arc=state.travelled,
            traj_weight=torch.full((c,), cfg.traj_weight, device=dev),
            n_canonical=n_can_f, prev_last=state.prev_last,
            has_prev=torch.full((c,), has_prev, device=dev))
        sc = compiled.fill_locomotion_slots(sc, path, compiled.LocoSpec(
            goal_arc=goal_arc, half_arc=state.travelled + 0.5 * step_len,
            node=cfg.root_node, end_kf=n_can_f - 1.0,
            mid_kf=0.5 * (n_can_f - 1.0),
            dim_mask=torch.tensor([1.0, 0.0, 1.0], device=dev),
            pos_weight=cfg.pos_weight, dir_weight=cfg.dir_weight),
            use_half=cfg.use_half)

    with profiling.span("walk.sample"):
        samples = walk_mod.sample_node_latents(g, node, draws.comp_gumbel,
                                               draws.normal)
    if cfg.pallas_selection:
        # best of n_samples by kernel B1 (B3), exact re-score of the winner
        with profiling.span("walk.select"):
            s = _select(g, state, sc, samples, path, path_table, goal_arc,
                        n_can_f, root_off, cfg, ee_chain)
        with profiling.span("walk.rescore"):
            err = exact_error(skeleton, g, node, sc, s, root_only,
                              **_families(cfg))
    else:
        # the general path: the exact evaluator ranks, its error is kept
        with profiling.span("walk.select"):
            errors = _rank_exact(skeleton, g, node, sc, samples, root_only,
                                 cfg)
            best = torch.argmin(errors, dim=1)
            rows = torch.arange(c, device=dev)
            s, err = samples[rows, best], errors[rows, best]
    err_pre = err  # best-of-N selection error, before any LM

    # ---- gated LM refinement: the frozen closed form on a CUDA device as
    # one graph launch, after a key's first, eager, sight
    if cfg.lm_iters > 0:
        with profiling.span("walk.lm"):
            s, err = LM_GRAPHS.run(
                lambda *a: _lm_stage(skeleton, g, *a, cfg, root_only),
                (node, sc, s, err), _lm_graph_key(skeleton, g, cfg, root_only),
                (g.eigen_s, g.mean_s, g.knots_s, g.gmm_weights, g.gmm_means,
                 g.gmm_prec_chol))

    state, out = _emit_step(g, path, state, s, err, step_idx > 0,
                            cfg.max_step_frames, draws.trans_gumbel,
                            cfg.window, cfg.end_threshold)
    out.pre_lm_error = err_pre
    return state, out


def _goal_arc(g: StackedGraph, state: WalkState, full_arc: torch.Tensor,
              step_length_factor: float = 1.0,
              end_threshold: float = 20.0) -> torch.Tensor:
    """The step's goal on the path: step_length_factor average steps of the
    node past the travelled arc, or the path's end once that is within
    end_threshold."""
    step_len = g.avg_step_length[state.node_id] * step_length_factor
    near_end = state.travelled + step_len >= full_arc - end_threshold
    return torch.where(near_end, full_arc, state.travelled + step_len)


def _emit_step(g: StackedGraph, path: spline_path.PathSpline,
               state: WalkState, s: torch.Tensor, err: torch.Tensor,
               has_prev: bool, max_step_frames: int,
               trans_gumbel: torch.Tensor, window: int = 20,
               end_threshold: float = 20.0):
    """The constrained walks' shared step end: back-project the chosen
    latents s [C, L] with time warping, align and seam-smooth them against
    the previous step (`kernels.emit_frames`: the time function in torch,
    the rest one kernel on a CUDA device), advance the travelled arc, draw
    the next node -> (new WalkState, StepOutput)."""
    node = state.node_id
    full_arc = path.full_arc_length
    with profiling.span("walk.back_project"):
        t_fn, n_frames = walk_mod.warped_time(g, node, s[:, g.k_s_max:],
                                              max_step_frames)
        aligned, new_last = kernels.emit_frames(
            s[:, : g.k_s_max], g.eigen_s, g.mean_s, g.knots_s, node, t_fn,
            n_frames, state.prev_last if has_prev else None, has_prev,
            window)

    with profiling.span("walk.advance"):
        _, new_arc, _ = spline_path.closest_point(path, new_last[:, :3],
                                                  state.travelled)
        want_end = new_arc >= full_arc - end_threshold
        type_id = torch.where(want_end, TRANSITION_TYPE_IDS[NODE_TYPE_END],
                              TRANSITION_TYPE_IDS[NODE_TYPE_STANDARD])
        next_id, found = walk_mod.choose_transition(g, node, type_id,
                                                    trans_gumbel)
        done = state.done | ~found | (
            want_end & (g.node_type[node] == NODE_TYPE_IDS[NODE_TYPE_END]))
    out = StepOutput(
        frames=aligned,
        n_frames=torch.where(state.done, 0, n_frames),
        node_id=torch.where(state.done, -1, node),
        error=err)
    return WalkState(next_id, new_last, new_arc, done), out


def initial_state(g: StackedGraph, start_ids: torch.Tensor) -> WalkState:
    c = start_ids.shape[0]
    dev = start_ids.device
    return WalkState(node_id=start_ids.long(),
                     prev_last=torch.zeros((c, g.n_dim), device=dev),
                     travelled=torch.zeros(c, device=dev),
                     done=torch.zeros(c, dtype=torch.bool, device=dev))


@profiling.span("crowd", ranged=False)
def constrained_walk_full_crowd(skeleton: Skeleton, g: StackedGraph,
                                paths: spline_path.PathSpline,
                                start_ids: torch.Tensor, n_steps: int,
                                draws: Callable[[int], walk_mod.StepDraws],
                                step_scs=None,
                                cfg: Optional[WalkConfig] = None):
    """A crowd of constrained walks, one per path ([C] leading axis).

    draws(step) supplies each step's noise (`walk.torch_sampler` for the port's
    own generator); step_scs: host-side per-step constraint sets with a
    leading [n_steps] axis (numpy leaves).  root_only is derived here from
    step_scs, as every JAX caller does.  Returns (segments [C, S, T, D],
    n_frames [C, S], node_ids [C, S], errors [C, S]), and with
    cfg.return_pre_lm_err a fifth array [C, S]: each step's best-of-N
    selection error before the LM."""
    cfg = cfg or WalkConfig()
    if step_scs is None:
        step_scs = default_step_scs(skeleton, n_steps)
    root_only = compiled.step_scs_root_only(step_scs)
    check_walk_contract(skeleton, step_scs, cfg, root_only)
    dev = start_ids.device
    c = start_ids.shape[0]
    root_off = torch.as_tensor(skeleton.offsets[0], device=dev)
    path_table = kernels.pack_path_table(paths, root_off)
    ee_chain = None
    if cfg.pallas_ee is not None:
        idx, const = kernels.pack_ee_chain(skeleton, cfg.pallas_ee)
        ee_chain = (idx, torch.as_tensor(const, device=dev))
    state = initial_state(g, start_ids)
    outs = []
    for t in range(n_steps):
        sc0 = step_constraints(step_scs, t, c, dev)
        state, out = full_walk_step(skeleton, g, paths, path_table, state,
                                    t, sc0, draws(t), cfg, root_only,
                                    ee_chain)
        outs.append(out)
    result = _stack_outputs(outs)
    if cfg.return_pre_lm_err:
        result += (torch.stack([o.pre_lm_error for o in outs], dim=1),)
    return result


def _stack_outputs(outs):
    """Per-step StepOutputs -> (segments [C, S, T, D], n_frames [C, S],
    node_ids [C, S], errors [C, S])."""
    return (torch.stack([o.frames for o in outs], dim=1),
            torch.stack([o.n_frames for o in outs], dim=1),
            torch.stack([o.node_id for o in outs], dim=1),
            torch.stack([o.error for o in outs], dim=1))


# ---------------------------------------------------------------------------
# The boundary-row walk (the JAX package's lightweight `constrained_walk`)
# ---------------------------------------------------------------------------

def _boundary_rows(g: StackedGraph, node_id: torch.Tensor):
    """fPCA rows of each node's first and last coefficient blocks, which
    for a clamped B-spline ARE the clip's first and last frames:
    (e2 [C, 2*n_dim, k_s], mu2 [C, 2*n_dim]) with rows [first; last].  The
    last block is the node's own (n_basis - 1), not a zero padded one."""
    c = node_id.shape[0]
    rows = torch.arange(c, device=node_id.device)
    eigen = g.eigen_s[node_id].reshape(c, g.n_basis_max, g.n_dim, -1)
    mean = g.mean_s[node_id].reshape(c, g.n_basis_max, g.n_dim)
    last = (g.node_n_basis[node_id] - 1).long()
    return (torch.cat([eigen[:, 0], eigen[rows, last]], dim=1),
            torch.cat([mean[:, 0], mean[rows, last]], dim=1))


def _score_candidates(g: StackedGraph, node_id: torch.Tensor,
                      samples: torch.Tensor, prev_last: torch.Tensor,
                      goal_pos: torch.Tensor, goal_dir: torch.Tensor,
                      has_prev: bool, dir_weight: float = 0.8):
    """End-position (XZ) plus weighted end-heading error (degrees) of each
    candidate's last frame after its own 2D alignment to the previous step:
    samples [C, N, L], prev_last [C, D], goal_pos [C, 3], goal_dir [C, 2]
    -> errors [C, N]."""
    d = g.n_dim
    e2, mu2 = _boundary_rows(g, node_id)
    rows = torch.einsum("cnk,cdk->cnd", samples[:, :, : g.k_s_max], e2) \
        + mu2[:, None]
    first, last = rows[..., :d], rows[..., d:]
    if has_prev:
        q_y, delta = align.node_aligning_2d_transform(
            prev_last[:, None].expand_as(first), first)
        last = align.transform_frames(last[:, :, None], q_y, delta)[:, :, 0]
    pos_err = torch.sqrt((last[..., 0] - goal_pos[:, None, 0]) ** 2
                         + (last[..., 2] - goal_pos[:, None, 2]) ** 2 + 1e-12)
    fwd = torch.tensor([0.0, 0.0, 1.0], device=samples.device)
    heading = quat.rotate_vec(quat.normalize(last[..., 3:7]), fwd)
    hd = torch.stack([heading[..., 0], heading[..., 2]], dim=-1)
    hd = hd / torch.clamp(torch.linalg.vector_norm(hd, dim=-1, keepdim=True),
                          min=1e-10)
    cos_a = torch.clamp(torch.sum(hd * goal_dir[:, None], dim=-1), -1.0, 1.0)
    return pos_err + dir_weight * torch.rad2deg(torch.arccos(cos_a))


@profiling.span("crowd", ranged=False)
def constrained_walk(g: StackedGraph, paths: spline_path.PathSpline,
                     start_ids: torch.Tensor, n_steps: int,
                     draws: Callable[[int], walk_mod.StepDraws],
                     max_step_frames: int = 128, window: int = 20,
                     step_length_factor: float = 1.0,
                     end_threshold: float = 20.0):
    """Crowd walks that follow their paths with the boundary-row selection
    (the JAX package's `constrained_walk`, bench.py's toy config): per step
    the goal one average step along the path, the best of the step's GMM
    candidates on end position and heading from two coefficient rows, the
    winner back-projected, aligned and smoothed, the arc advanced.

    paths [C] leading axis; draws(step) supplies StepDraws, one candidate
    per draw (the JAX walk's n_samples, default 64); window,
    step_length_factor and end_threshold as in WalkConfig.  Returns
    (segments [C, S, T, D], n_frames [C, S], node_ids [C, S], errors
    [C, S], the winners' selection errors)."""
    dev = start_ids.device
    c = start_ids.shape[0]
    rows = torch.arange(c, device=dev)
    state = initial_state(g, start_ids)
    outs = []
    for t in range(n_steps):
        d = draws(t)
        with profiling.span("walk.goal"):
            goal_pos, goal_dir = spline_path.point_and_dir_at_arc_length(
                paths, _goal_arc(g, state, paths.full_arc_length,
                                 step_length_factor, end_threshold))
        with profiling.span("walk.sample"):
            samples = walk_mod.sample_node_latents(g, state.node_id,
                                                   d.comp_gumbel, d.normal)
        with profiling.span("walk.select"):
            errors = _score_candidates(g, state.node_id, samples,
                                       state.prev_last, goal_pos, goal_dir,
                                       t > 0)
            best = torch.argmin(errors, dim=1)
        state, out = _emit_step(g, paths, state, samples[rows, best],
                                errors[rows, best], t > 0, max_step_frames,
                                d.trans_gumbel, window, end_threshold)
        outs.append(out)
    return _stack_outputs(outs)


@profiling.span("crowd", ranged=False)
def constrained_walk_crowd(g: StackedGraph, paths: spline_path.PathSpline,
                           start_id, n_chars: int, n_steps: int,
                           draws: Callable[[int], walk_mod.StepDraws], **kw):
    """n_chars boundary-row walks from one start node, each on its own path
    (paths with a leading [n_chars] axis); keywords as `constrained_walk`."""
    start = torch.full((n_chars,), int(start_id), dtype=torch.long,
                       device=paths.table_arc.device)
    return constrained_walk(g, paths, start, n_steps, draws, **kw)
