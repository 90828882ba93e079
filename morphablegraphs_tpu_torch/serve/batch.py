"""Batched request serving: many trajectory requests -> one crowd walk
(port of morphablegraphs_tpu.serve.batch).

Each batchable request (one locomotion action following a root trajectory,
no keyframe constraints) becomes one character of a crowd walk.  With
full_constraints (the default) that is `constrained_walk_full_crowd`,
reached through `parallel.constrained_crowd_sharded` on the generator's one
device as in the JAX package, with its single-device serving flags: the
selection kernel B1 (on CUDA; its plain twin on CPU) while the constraint
sets carry the locomotion family only, n_samples then rounded up to its
tile of 128, root_only derived from the constraint sets, and the exact LM
(lm_frozen=False), whose solves go through kernel B2.  Given a
torch.distributed process group, every rank is handed the same requests
and walks its rows of the crowd on its own device (`parallel/`); with a
status group as well (the status group of `parallel.launch`) the ranks
agree that each of them built its inputs and walked its rows before they
gather, so a failure on one rank raises on every rank.  Without
full_constraints it is the boundary-row `constrained_walk_crowd`.
"""

from __future__ import annotations

from typing import List, Optional

import dataclasses

import numpy as np
import torch

from .. import parallel
from ..parallel import group as group_mod
from ..constraints import compiled
from ..constraints.input_reader import read_input
from ..models.graph import MotionStateGraph, stack_graph
from ..ops import kernels, spline_path
from ..synthesis import constrained_walk as cw
from ..synthesis import walk as walk_mod
from ..utils import device as device_mod
from ..utils.config import default_config

_MAX_PATH_POINTS = spline_path.MAX_PATH_POINTS


def _root_trajectory(parsed, root_joint: str):
    """The action's root trajectory, or None."""
    for traj in parsed.actions[0].trajectories:
        if traj.joint in (root_joint, "Hips") and not traj.annotated:
            return traj
    return None


def _is_batchable(parsed, root_joint: str) -> bool:
    """One locomotion action with a root trajectory that fits the padded
    spline, no keyframe constraints and no other trajectory."""
    if len(parsed.actions) != 1:
        return False
    a = parsed.actions[0]
    traj = _root_trajectory(parsed, root_joint)
    if traj is None or a.keyframe_constraints or len(a.trajectories) > 1:
        return False
    return len(traj.control_points) <= _MAX_PATH_POINTS


class BatchedGenerator:
    """Collects parsed locomotion requests and synthesizes them in one
    crowd walk on `device`: the CUDA device unless the caller names
    another (device="cpu" runs the kernels' twins).  Without a card the
    default raises.

    full_constraints routes through `constrained_walk_full_crowd` (the
    complete compiled constraint semantics and the gated LM; n_samples
    rounded up to the selection kernel's tile of 128); False keeps the
    boundary-row scorer of `constrained_walk_crowd` with n_samples as
    given.  `group`, a torch.distributed process group, splits the
    full-constraint crowd over its ranks (each rank's own `device`);
    `status_group` (gloo) carries the ranks' agreement before the
    gathers (`parallel.group.agree`)."""

    def __init__(self, graph: MotionStateGraph, config: Optional[dict] = None,
                 n_steps: int = 12, n_samples: int = 64,
                 max_step_frames: int = 64, full_constraints: bool = True,
                 lm_iters: int = 3, device=None, group=None,
                 status_group=None):
        self.graph = graph
        self.device = device_mod.resolve(device, "BatchedGenerator")
        self.group = group
        self.status_group = status_group
        self.stacked = stack_graph(graph, device=self.device)
        self.config = config or default_config()
        self.n_steps = n_steps
        self.full_constraints = full_constraints
        # the selection kernel scores candidates in tiles of 128
        self.n_samples = (-(-n_samples // kernels.N_BLK) * kernels.N_BLK
                          if full_constraints else n_samples)
        self.max_step_frames = max_step_frames
        self.lm_iters = lm_iters

    def walk_config(self) -> cw.WalkConfig:
        """The walk settings of every batch: constrained_walk_full's
        defaults (the exact LM) with this generator's sizes."""
        return cw.WalkConfig(max_step_frames=self.max_step_frames,
                             n_samples=self.n_samples,
                             lm_iters=self.lm_iters)

    def _start_id(self, action: str) -> int:
        group = self.graph.node_groups[action]
        names = group.start_states or [k[1] for k in group.node_keys]
        return self.stacked.node_id((action, names[0]))

    def _root_joint(self) -> str:
        skel = self.graph.skeleton
        if skel is not None and "Hips" in skel.node_names:
            return "Hips"
        return skel.animated_joints[0] if skel else "Hips"

    def split_batchable(self, mg_inputs: List[dict],
                        activate_coordinate_transform: bool = False):
        """Partition requests into (batchable, fallback, parsed)."""
        batchable, fallback = [], []
        parsed_list = [None] * len(mg_inputs)
        root_joint = self._root_joint()
        for i, mg_input in enumerate(mg_inputs):
            try:
                parsed = read_input(
                    mg_input,
                    activate_coordinate_transform=activate_coordinate_transform)
            except (KeyError, ValueError):
                fallback.append(i)
                continue
            if _is_batchable(parsed, root_joint):
                parsed_list[i] = parsed
                batchable.append(i)
            else:
                fallback.append(i)
        return batchable, fallback, parsed_list

    def generate_batch(self, mg_inputs: List[dict],
                       activate_coordinate_transform: bool = False,
                       seed: int = 0,
                       parsed_list: Optional[list] = None) -> List[np.ndarray]:
        """Synthesize the requests in one launch -> one [T_i, D] frame
        array per request.  Every request must be batchable."""
        try:
            paths, start = self._inputs(mg_inputs,
                                        activate_coordinate_transform,
                                        parsed_list)
            # every rank draws the whole crowd from the seed and walks its
            # own rows of the draws
            gen = torch.Generator(device=self.device).manual_seed(seed)
            draws = walk_mod.torch_sampler(gen, self.stacked,
                                           len(mg_inputs), self.n_samples)
        except Exception as e:  # the other ranks wait in the agreement
            if self.status_group is None or not self.full_constraints:
                raise
            group_mod.agree(self.status_group, e)
        if self.full_constraints:
            skel = self.graph.skeleton
            step_scs = cw.default_step_scs(skel, self.n_steps)
            # the selection kernels rank on the locomotion family only: a
            # batch path that adds user slots falls back to the general
            # selection (the sets are empty today)
            cfg = dataclasses.replace(
                self.walk_config(),
                pallas_selection=compiled.step_scs_locomotion_only(step_scs))
            segs, n_frames, _, _ = parallel.constrained_crowd_sharded(
                [self.device], skel, self.stacked, paths, start,
                self.n_steps, draws, step_scs=step_scs, cfg=cfg,
                group=self.group, status_group=self.status_group)
        else:
            segs, n_frames, _, _ = cw.constrained_walk(
                self.stacked, paths, start, self.n_steps, draws,
                max_step_frames=self.max_step_frames)
        segs = segs.cpu().numpy()
        n_frames = n_frames.cpu().numpy()
        return [walk_mod.flatten_segments(segs[c], n_frames[c])
                for c in range(len(mg_inputs))]

    def _inputs(self, mg_inputs, activate_coordinate_transform, parsed_list):
        """The requests' stacked root paths and start node ids."""
        paths, start_ids = [], []
        root_joint = self._root_joint()
        for i, mg_input in enumerate(mg_inputs):
            parsed = (parsed_list[i] if parsed_list is not None
                      and parsed_list[i] is not None else read_input(
                          mg_input, activate_coordinate_transform=(
                              activate_coordinate_transform)))
            traj = _root_trajectory(parsed, root_joint)
            if traj is None:
                raise ValueError(
                    f"request {i} has no root trajectory — not batchable")
            pts = traj.control_points - traj.control_points[:1] \
                + parsed.start_pose_position
            paths.append(spline_path.build(
                pts, max_points=_MAX_PATH_POINTS,
                unconstrained_dims=traj.unconstrained_dims,
                device=self.device))
            start_ids.append(self._start_id(parsed.actions[0].name))
        return (spline_path.stack_paths(paths),
                torch.tensor(start_ids, device=self.device))
