"""Graph walks over a StackedGraph, batched over a crowd (port of
morphablegraphs_tpu.synthesis.walk): the building blocks the constrained
walks share, and the random walks (`random_walk`, `random_walk_segments`).

The crowd is an explicit leading [C] axis and the JAX scan a Python loop
over steps.  Random choices take their noise as arguments:
`jax.random.categorical` is argmax(logits + Gumbel noise), so a component
or a transition is argmax(logits + gumbel) here, with the noise drawn by
the caller (`StepDraws`, from `torch_sampler` or replayed from another
generator).  Every step's back-projection runs on a CUDA device in the
frame-emit kernel (`kernels.emit_frames`), or for the canonical timeline in
kernel B6 (`kernels.crowd_back_project`)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.graph import (NODE_TYPE_END, NODE_TYPE_STANDARD, StackedGraph,
                            TRANSITION_TYPE_IDS)
from ..ops import align, bspline, kernels, quat, timewarp
from ..utils import profiling


@dataclasses.dataclass
class StepDraws:
    """One step's noise: Gumbel [C, n, K_comp] for the n latent draws'
    components, standard normals [C, n, L] for the draws, Gumbel
    [C, N_nodes] for the transition.  The random walks take n = 1."""

    comp_gumbel: torch.Tensor
    normal: torch.Tensor
    trans_gumbel: torch.Tensor


def torch_sampler(generator: torch.Generator, g: StackedGraph, n_chars: int,
                  n_samples: int) -> Callable[[int], StepDraws]:
    """The port's own noise source: step index -> StepDraws drawn from
    `generator` (on the generator's device); n_samples = 1 for the random
    walks."""
    dev = generator.device
    k_comp = g.gmm_weights.shape[-1]
    l_dim = g.gmm_means.shape[-1]

    def gumbel(shape):
        tiny = torch.finfo(torch.float32).tiny
        u = torch.rand(shape, generator=generator, device=dev)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    def draw(step: int) -> StepDraws:
        del step
        return StepDraws(
            comp_gumbel=gumbel((n_chars, n_samples, k_comp)),
            normal=torch.randn((n_chars, n_samples, l_dim),
                               generator=generator, device=dev),
            trans_gumbel=gumbel((n_chars, g.n_nodes)))

    return draw


def sample_node_latents(g: StackedGraph, node_id: torch.Tensor,
                        gumbel: torch.Tensor,
                        normal: torch.Tensor) -> torch.Tensor:
    """n latent draws per character from its node's GMM.

    node_id [C]; gumbel [C, n, K_comp] picks each draw's component;
    normal [C, n, L] are the standard normals -> latents [C, n, L]."""
    w = g.gmm_weights[node_id]  # [C, K]
    logits = torch.log(torch.clamp(w, min=1e-30))
    comps = torch.argmax(logits[:, None, :] + gumbel, dim=-1)  # [C, n]
    mus = g.gmm_means[node_id]  # [C, K, L]
    chols = g.gmm_cov_chol[node_id]  # [C, K, L, L]
    y = torch.einsum("ckij,cnj->cnki", chols, normal)  # [C, n, K, L]
    l_dim = mus.shape[-1]
    y_sel = torch.gather(y, 2, comps[:, :, None, None].expand(
        -1, -1, 1, l_dim))[:, :, 0]
    mu_sel = torch.gather(mus, 1, comps[..., None].expand(-1, -1, l_dim))
    return y_sel + mu_sel


def sample_node_latent(g: StackedGraph, node_id: torch.Tensor,
                       gumbel: torch.Tensor,
                       normal: torch.Tensor) -> torch.Tensor:
    """One latent draw per character with JAX `sample_node_latent`'s noise
    shapes: gumbel [C, K_comp], normal [C, L] -> [C, L]."""
    return sample_node_latents(g, node_id, gumbel[:, None],
                               normal[:, None])[:, 0]


def warped_time(g: StackedGraph, node_id: torch.Tensor, gamma: torch.Tensor,
                max_frames: int, use_time: bool = True, speed: float = 1.0):
    """Each character's timeline and its frame count: (t_fn [C, max_frames]
    canonical times, n_frames [C] int32).  use_time warps the timeline by
    the temporal latents gamma [C, k_t] (at `speed`); otherwise it is
    linspace(0, F, F/speed) over the node's F canonical frames."""
    n_can = g.n_canonical[node_id]
    if use_time:
        t_can = timewarp.canonical_time_function_masked(
            g.mean_t_d[node_id], g.eigen_t_d[node_id], gamma, n_can)
        return timewarp.invert_time_function_dynamic(t_can, n_can, max_frames,
                                                     speed)
    n_can_f = n_can.float()
    num = torch.clamp(torch.floor(n_can_f * (1.0 / speed)), min=2.0)
    i = torch.arange(max_frames, dtype=torch.float32, device=n_can.device)
    t_fn = torch.minimum(i * (n_can_f / (num - 1.0))[:, None],
                         (n_can_f - 1.0)[:, None])
    return t_fn, torch.clamp(num.to(torch.int32), max=max_frames)


def warped_basis(g: StackedGraph, node_id: torch.Tensor, gamma: torch.Tensor,
                 max_frames: int, use_time: bool = True, speed: float = 1.0):
    """B-spline basis of each character's timeline (`warped_time`) and its
    frame count: (basis [C, max_frames, n_basis], n_frames [C] int32)."""
    t_fn, n_frames = warped_time(g, node_id, gamma, max_frames, use_time,
                                 speed)
    return bspline.basis_matrix(g.knots_s[node_id], t_fn), n_frames


def back_project_node(g: StackedGraph, node_id: torch.Tensor,
                      s: torch.Tensor, max_frames: int, use_time: bool = True,
                      speed: float = 1.0):
    """Back-project latents s [C, L] at nodes node_id [C] -> (frames
    [C, max_frames, n_dim], n_frames [C] int32); use_time and speed as in
    `warped_time`.  On a CUDA device the time-warped form takes its basis
    weights inside the kernel (`kernels.emit_frames` without a previous
    clip: no basis tensor is built); the canonical timeline (use_time
    False), which holds no per-character latent, goes through its basis
    and kernel B6 (`kernels.crowd_back_project`).  The twins of both give
    the same frames on the CPU."""
    alphas = s[:, : g.k_s_max]
    if not use_time:
        basis, n_frames = warped_basis(g, node_id, s[:, g.k_s_max:],
                                       max_frames, use_time, speed)
        return kernels.crowd_back_project(alphas, g.eigen_s, g.mean_s, basis,
                                          mix_id=node_id), n_frames
    t_fn, n_frames = warped_time(g, node_id, s[:, g.k_s_max:], max_frames,
                                 use_time, speed)
    frames, _ = kernels.emit_frames(alphas, g.eigen_s, g.mean_s, g.knots_s,
                                    node_id, t_fn, n_frames, None, False, 0)
    return frames, n_frames


def choose_transition(g: StackedGraph, node_id: torch.Tensor,
                      type_id: torch.Tensor, gumbel: torch.Tensor):
    """Uniform pick among the outgoing edges of the given type:
    node_id/type_id [C], gumbel [C, N_nodes] -> (next_id [C], found [C]);
    without a matching edge next_id == node_id and found is False."""
    row = g.transitions[type_id, node_id]  # [C, N]
    found = row.any(-1)
    logits = torch.where(row, 0.0, float("-inf"))
    choice = torch.argmax(logits + gumbel, dim=-1).to(node_id.dtype)
    return torch.where(found, choice, node_id), found


def flatten_segments(frames, n_frames) -> np.ndarray:
    """Host-side flatten of one character's segments [S, T, D] with valid
    counts [S] into one [T_total, D] motion."""
    frames = np.asarray(frames)
    out = [seg[: int(n)] for seg, n in zip(frames, np.asarray(n_frames))]
    return (np.concatenate(out, axis=0) if out
            else np.zeros((0, frames.shape[-1]), frames.dtype))


# ---------------------------------------------------------------------------
# Random walks (BASELINE configs 2 and 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class WalkState:
    """State of the concatenating random walk: buffer [C, MAX_T, D] with
    buffer[c, :n_valid[c]] valid, node_id [C], done [C]."""

    buffer: torch.Tensor
    n_valid: torch.Tensor  # int32
    node_id: torch.Tensor
    done: torch.Tensor  # bool


@dataclasses.dataclass
class SegWalkState:
    """State of the segment-form random walk."""

    node_id: torch.Tensor
    done: torch.Tensor  # bool


def _random_step(g: StackedGraph, node_id, done, step_idx: int, n_steps: int,
                 draws: StepDraws, max_step_frames: int, use_time: bool):
    """The random walks' shared step: a latent from the node's GMM, its
    frames, and the transition (standard until the second-to-last step,
    then end) -> (s, frames, n_frames, next_id, done)."""
    with profiling.span("walk.sample"):
        s = sample_node_latent(g, node_id, draws.comp_gumbel[:, 0],
                               draws.normal[:, 0])
    with profiling.span("walk.back_project"):
        frames, n_frames = back_project_node(g, node_id, s, max_step_frames,
                                             use_time)
    with profiling.span("walk.advance"):
        want_end = step_idx >= n_steps - 2
        type_id = torch.full_like(node_id, TRANSITION_TYPE_IDS[
            NODE_TYPE_END if want_end else NODE_TYPE_STANDARD])
        next_id, found = choose_transition(g, node_id, type_id,
                                           draws.trans_gumbel)
    return s, frames, n_frames, next_id, done | ~found


@profiling.span("random_walk", ranged=False)
def random_walk(g: StackedGraph, start_ids: torch.Tensor, n_steps: int,
                draws: Callable[[int], StepDraws], max_step_frames: int = 128,
                max_total_frames: Optional[int] = None, window: int = 20,
                use_time: bool = True):
    """Random graph walks of a crowd: start nodes start_ids [C], (n_steps-2)
    standard transitions, one end transition; each step's frames aligned
    and appended to the character's buffer with seam smoothing.

    draws(step) supplies each step's noise (`torch_sampler(..., 1)`).
    Returns (buffer [C, MAX_T, D], n_valid [C], node_ids [C, n_steps],
    latents [C, n_steps, L]); node_ids == -1 marks steps after the walk
    ended (no outgoing edge of the requested type)."""
    if max_total_frames is None:
        max_total_frames = n_steps * max_step_frames
    c = start_ids.shape[0]
    dev = start_ids.device
    state = WalkState(
        buffer=torch.zeros((c, max_total_frames, g.n_dim), device=dev),
        n_valid=torch.zeros(c, dtype=torch.int32, device=dev),
        node_id=start_ids.long(),
        done=torch.zeros(c, dtype=torch.bool, device=dev))
    ids, latents = [], []
    for t in range(n_steps):
        s, frames, n_frames, next_id, done = _random_step(
            g, state.node_id, state.done, t, n_steps, draws(t),
            max_step_frames, use_time)
        with profiling.span("walk.append"):
            # the walk owns its buffer: append writes into it in place
            buffer, n_valid = align.append_frames(
                state.buffer, state.n_valid, frames, n_frames, window,
                active=~state.done)
        ids.append(torch.where(state.done, -1, state.node_id))
        latents.append(s)
        state = WalkState(buffer, n_valid, next_id, done)
    return (state.buffer, state.n_valid, torch.stack(ids, dim=1),
            torch.stack(latents, dim=1))


def random_walk_crowd(g: StackedGraph, start_id, n_chars: int, n_steps: int,
                      draws: Callable[[int], StepDraws], **kw):
    """A crowd of n_chars random walks from one start node (BASELINE config
    5's shape); keywords as `random_walk`."""
    start = torch.full((n_chars,), int(start_id), dtype=torch.long,
                       device=g.n_canonical.device)
    return random_walk(g, start, n_steps, draws, **kw)


@profiling.span("random_walk", ranged=False)
def random_walk_segments(g: StackedGraph, start_ids: torch.Tensor,
                         n_steps: int, draws: Callable[[int], StepDraws],
                         max_step_frames: int = 128, window: int = 20,
                         use_time: bool = True):
    """Random walks that emit each step's frames as a SEGMENT instead of
    appending them to one buffer (the JAX package's fast form): the steps'
    aligning transforms are chained on the segments' boundary frames, then
    every segment is transformed and seam-smoothed at once.  Equal to
    `random_walk` except where a step is shorter than the smoothing window.

    Returns (frames [C, n_steps, max_step_frames, D], n_frames [C, n_steps],
    node_ids [C, n_steps], latents [C, n_steps, L])."""
    c = start_ids.shape[0]
    dev = start_ids.device
    state = SegWalkState(node_id=start_ids.long(),
                         done=torch.zeros(c, dtype=torch.bool, device=dev))
    segs, counts, ids, latents = [], [], [], []
    for t in range(n_steps):
        s, frames, n_frames, next_id, done = _random_step(
            g, state.node_id, state.done, t, n_steps, draws(t),
            max_step_frames, use_time)
        segs.append(frames)
        counts.append(torch.where(state.done, 0, n_frames))
        ids.append(torch.where(state.done, -1, state.node_id))
        latents.append(s)
        state = SegWalkState(next_id, done)
    frames = torch.stack(segs, dim=1)  # [C, S, T, D]
    n_frames = torch.stack(counts, dim=1)

    with profiling.span("walk.align"):
        # chained alignment on the boundary frames only
        rows = torch.arange(c, device=dev)
        last_idx = torch.clamp(n_frames - 1, min=0).long()
        q_ys, deltas, prev_lasts = [], [], []
        prev_last = frames[rows, 0, last_idx[:, 0]]
        for t in range(n_steps):
            first = frames[:, t, 0]
            last = frames[rows, t, last_idx[:, t]]
            if t == 0:
                q_y = torch.tensor([1.0, 0.0, 0.0, 0.0],
                                   device=dev).expand(c, 4)
                delta = torch.zeros((c, 3), device=dev)
                new_last = last
            else:
                q_y, delta = align.node_aligning_2d_transform(prev_last,
                                                              first)
                new_last = align.transform_frames(last[:, None], q_y,
                                                  delta)[:, 0]
                # the seam smoothing hemisphere-aligns the whole segment
                # against the anchor, which can flip quaternion signs
                # clip-wide: flip the carried last frame the same way, so
                # the next step chains on the SMOOTHED segment
                new_last = quat.frame_fix_signs(new_last, prev_last)
            q_ys.append(q_y)
            deltas.append(delta)
            prev_lasts.append(prev_last)
            prev_last = new_last
        # transforms and seam smoothing of all segments at once
        aligned = align.transform_frames(frames, torch.stack(q_ys, dim=1),
                                         torch.stack(deltas, dim=1))
        out = align.smooth_transition(torch.stack(prev_lasts, dim=1),
                                      aligned, window)
        out[:, 0] = aligned[:, 0]  # the first segment has no seam
    return out, n_frames, torch.stack(ids, dim=1), torch.stack(latents, dim=1)
