"""Crowd synthesis over devices (port of morphablegraphs_tpu.parallel.crowd).

The JAX package splits the character axis over a device mesh: per-character
inputs are sharded, the stacked graph is replicated, and the characters
never communicate.  The port takes a list of devices in place of the mesh.
On one device both entry points run the crowd functions there, after the
same host-side checks, padding and slicing as the JAX package; more than one
device raises NotImplementedError (splitting the crowd with
torch.distributed is ROADMAP item 12), so nothing runs elsewhere than
asked."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from ..constraints import compiled
from ..models.graph import StackedGraph
from ..models.skeleton import Skeleton
from ..ops import spline_path
from ..synthesis import constrained_walk as cw
from ..synthesis import walk as walk_mod


def _single_device(devices: Sequence) -> torch.device:
    """The one device of `devices`; more than one is refused."""
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("no device given")
    if len(devices) > 1:
        raise NotImplementedError(
            f"a crowd over {len(devices)} devices needs torch.distributed, "
            "which the port does not use yet (ROADMAP item 12); pass one "
            "device")
    return devices[0]


def _pad_rows(x: torch.Tensor, pad: int) -> torch.Tensor:
    """x with its first row repeated `pad` more times along axis 0."""
    return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x


def _draws_on(draws: Callable[[int], walk_mod.StepDraws], device,
              pad: int = 0):
    def at(t: int) -> walk_mod.StepDraws:
        d = draws(t)
        return walk_mod.StepDraws(*(_pad_rows(getattr(d, f.name), pad)
                                    .to(device)
                                    for f in dataclasses.fields(d)))
    return at


def crowd_walk_sharded(devices: Sequence, g: StackedGraph, start_id: int,
                       n_chars: int, draws: Callable[[int],
                                                     walk_mod.StepDraws],
                       n_steps: int = 8, max_step_frames: int = 64):
    """A crowd of n_chars concatenating random walks from start_id
    (`walk.random_walk_crowd`); n_chars must be a multiple of the device
    count.  Returns what `walk.random_walk` returns."""
    if n_chars % len(devices) != 0:
        raise ValueError(f"{n_chars} characters over {len(devices)} devices")
    dev = _single_device(devices)
    return walk_mod.random_walk_crowd(
        g.to(dev), start_id, n_chars, n_steps, _draws_on(draws, dev),
        max_step_frames=max_step_frames)


def constrained_crowd_sharded(devices: Sequence, skeleton: Skeleton,
                              g: StackedGraph, paths: spline_path.PathSpline,
                              start_ids: torch.Tensor, n_steps: int,
                              draws: Callable[[int], walk_mod.StepDraws],
                              step_scs=None,
                              cfg: Optional[cw.WalkConfig] = None):
    """The full-constraint crowd (`constrained_walk_full_crowd`) with
    per-character paths [C] and start_ids [C].  The walk's contract guards
    run first; a character count that does not divide the devices is
    padded by repeating the first character (its draws too) and the
    padding is sliced off the outputs.  Returns (segments, n_frames,
    node_ids, errors) as `constrained_walk_full_crowd`, with its fifth
    array under cfg.return_pre_lm_err."""
    cfg = cfg or cw.WalkConfig()
    if step_scs is None:
        step_scs = cw.default_step_scs(skeleton, n_steps)
    cw.check_walk_contract(skeleton, step_scs, cfg,
                           compiled.step_scs_root_only(step_scs))
    n_chars = start_ids.shape[0]
    pad = (-n_chars) % len(devices)
    dev = _single_device(devices)
    paths = spline_path.PathSpline(**{
        f.name: _pad_rows(getattr(paths, f.name), pad).to(dev)
        for f in dataclasses.fields(paths)})
    out = cw.constrained_walk_full_crowd(
        skeleton, g.to(dev), paths, _pad_rows(start_ids, pad).to(dev),
        n_steps, _draws_on(draws, dev, pad), step_scs=step_scs, cfg=cfg)
    return tuple(o[:n_chars] for o in out)
