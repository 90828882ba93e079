"""Crowd synthesis over devices (port of morphablegraphs_tpu.parallel.crowd).

The JAX package splits the character axis over a device mesh: per-character
inputs are sharded, the stacked graph is replicated, and the characters
never communicate.  The port runs one process per card, joined in a
torch.distributed process group (`group.launch` starts one over every
visible card, as `make_mesh` spans them; `torchrun --nproc_per_node N`, or
any group the caller initializes, serves too): every rank is handed the
whole crowd, takes its contiguous rows of the padded crowd, with the same
rows of the injected draws, on its own device, and walks them with the
graph and the constraint sets replicated.  Nothing is communicated inside
the walk; one all_gather per output array returns the whole crowd to every
rank.  NCCL gathers the CUDA tensors in place, gloo gathers CPU copies.
With a status group (the status group of `group.launch`), the ranks first
agree that every rank's walk succeeded (`group.agree`), so that a rank that
raised never leaves the others waiting in a gather.

Without a group both entry points run the whole crowd on their one device.
`devices` names this process's device; a list of several is refused: one
process drives one card, and several cards take a process group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch
import torch.distributed as dist

from ..constraints import compiled
from ..models.graph import StackedGraph
from ..models.skeleton import Skeleton
from ..ops import spline_path
from ..synthesis import constrained_walk as cw
from ..synthesis import walk as walk_mod
from ..utils import profiling
from . import group as group_mod


def _single_device(devices: Sequence) -> torch.device:
    """This process's one device; more than one is refused."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device given")
    if len(devices) > 1:
        raise NotImplementedError(
            f"one process drives one device, and {len(devices)} were given: "
            "run one process per device in a torch.distributed process "
            "group (parallel.launch starts one over every visible card) and "
            "pass it as group=, each rank naming its own device")
    return devices[0]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with its first row repeated `pad` more times along axis 0."""
    return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x


def rank_rows(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's contiguous rows of x, whose leading axis is padded to a
    multiple of the group's size by repeating its first row; all of x
    without a group."""
    if group is None:
        return x
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    x = _pad_rows(x, (-x.shape[0]) % world)
    per = x.shape[0] // world
    return x[rank * per: (rank + 1) * per]


def _draws_on(draws: Callable[[int], walk_mod.StepDraws], device, group):
    def at(t: int) -> walk_mod.StepDraws:
        d = draws(t)
        return walk_mod.StepDraws(*(rank_rows(getattr(d, f.name), group)
                                    .to(device)
                                    for f in dataclasses.fields(d)))
    return at


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's x (the same shape on each) concatenated along axis 0 in
    rank order, on x's device.  NCCL gathers CUDA tensors (a CPU x goes
    through this rank's current card), the other backends CPU copies."""
    world = dist.get_world_size(group)
    if dist.get_backend(group) != "nccl":
        on = x.cpu()
    elif x.is_cuda:
        on = x
    else:
        on = x.to(torch.device("cuda", torch.cuda.current_device()))
    on = on.contiguous()
    parts = [torch.empty_like(on) for _ in range(world)]
    try:
        dist.all_gather(parts, on, group=group)
    except RuntimeError as e:
        raise group_mod.RankError(f"the process group lost a rank: {e}") \
            from e
    return torch.cat(parts).to(x.device)


def _gather_outputs(out: tuple, group) -> tuple:
    """Every output's rows of every rank (`all_gather_rows`), under the
    span `crowd.gather`."""
    with profiling.span("crowd.gather", ranged=False):
        return tuple(all_gather_rows(o, group) for o in out)


def crowd_walk_sharded(devices: Sequence, g: StackedGraph, start_id: int,
                       n_chars: int, draws: Callable[[int],
                                                     walk_mod.StepDraws],
                       n_steps: int = 8, max_step_frames: int = 64,
                       group=None):
    """A crowd of n_chars concatenating random walks from start_id
    (`walk.random_walk_crowd`), split over the ranks of `group`;
    n_chars must be a multiple of the group's size.  Returns what
    `walk.random_walk` returns, for the whole crowd on every rank."""
    world = 1 if group is None else dist.get_world_size(group)
    if n_chars % world != 0:
        raise ValueError(f"{n_chars} characters over {world} ranks")
    dev = _single_device(devices)
    out = walk_mod.random_walk_crowd(
        g.to(dev), start_id, n_chars // world, n_steps,
        _draws_on(draws, dev, group), max_step_frames=max_step_frames)
    return out if group is None else _gather_outputs(out, group)


def constrained_crowd_sharded(devices: Sequence, skeleton: Skeleton,
                              g: StackedGraph, paths: spline_path.PathSpline,
                              start_ids: torch.Tensor, n_steps: int,
                              draws: Callable[[int], walk_mod.StepDraws],
                              step_scs=None,
                              cfg: Optional[cw.WalkConfig] = None,
                              group=None, status_group=None):
    """The full-constraint crowd (`constrained_walk_full_crowd`) with
    per-character paths [C] and start_ids [C], split over the ranks of
    `group`.  The walk's contract guards run first; a character count that
    does not divide the ranks is padded by repeating the first character
    (its draws too) and the padding is sliced off the outputs.  With
    `status_group` the ranks agree on every rank's outcome before they
    gather (`group.agree`: a failure on any rank raises on every rank).
    Returns (segments, n_frames, node_ids, errors) as
    `constrained_walk_full_crowd`, with its fifth array under
    cfg.return_pre_lm_err, for the whole crowd on every rank."""
    cfg = cfg or cw.WalkConfig()
    if step_scs is None:
        step_scs = cw.default_step_scs(skeleton, n_steps)
    cw.check_walk_contract(skeleton, step_scs, cfg,
                           compiled.step_scs_root_only(step_scs))
    n_chars = start_ids.shape[0]
    dev = _single_device(devices)
    error = None
    try:
        paths = spline_path.PathSpline(**{
            f.name: rank_rows(getattr(paths, f.name), group).to(dev)
            for f in dataclasses.fields(paths)})
        out = cw.constrained_walk_full_crowd(
            skeleton, g.to(dev), paths, rank_rows(start_ids, group).to(dev),
            n_steps, _draws_on(draws, dev, group), step_scs=step_scs,
            cfg=cfg)
    except Exception as e:  # every rank learns of it before the gathers
        if status_group is None:
            raise
        error = e
    if status_group is not None:
        group_mod.agree(status_group, error)
    if group is not None:
        out = _gather_outputs(out, group)
    return tuple(o[:n_chars] for o in out)
