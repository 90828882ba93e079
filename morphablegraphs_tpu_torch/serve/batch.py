"""Batched request serving: many trajectory requests -> one crowd walk
(port of morphablegraphs_tpu.serve.batch, single device).

Each batchable request (one locomotion action following a root trajectory,
no keyframe constraints) becomes one character of
`constrained_walk_full_crowd`, with the JAX package's single-device serving
flags: the selection kernel B1 (on CUDA; its plain twin on CPU) with
n_samples rounded up to its tile of 128, root_only derived from the
constraint sets, and the exact LM (lm_frozen=False), whose solves go
through kernel B2.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..constraints import compiled
from ..constraints.input_reader import read_input
from ..models.graph import MotionStateGraph, stack_graph
from ..ops import kernels, spline_path
from ..synthesis import constrained_walk as cw
from ..synthesis import walk as walk_mod
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
    default raises."""

    def __init__(self, graph: MotionStateGraph, config: Optional[dict] = None,
                 n_steps: int = 12, n_samples: int = 64,
                 max_step_frames: int = 64, lm_iters: int = 3,
                 device=None):
        self.graph = graph
        self.device = torch.device(device or "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("BatchedGenerator runs on a CUDA device and "
                               "none is available; pass device='cpu' to "
                               "run on the CPU")
        self.stacked = stack_graph(graph, device=self.device)
        self.config = config or default_config()
        self.n_steps = n_steps
        # the selection kernel scores candidates in tiles of 128
        self.n_samples = -(-n_samples // kernels.N_BLK) * kernels.N_BLK
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
        skel = self.graph.skeleton
        step_scs = cw.default_step_scs(skel, self.n_steps)
        if not compiled.step_scs_locomotion_only(step_scs):
            raise ValueError("batched requests carry non-locomotion slots")
        gen = torch.Generator(device=self.device).manual_seed(seed)
        segs, n_frames, _, _ = cw.constrained_walk_full_crowd(
            skel, self.stacked, spline_path.stack_paths(paths),
            torch.tensor(start_ids, device=self.device), self.n_steps,
            draws=walk_mod.torch_sampler(gen, self.stacked, len(mg_inputs),
                                         self.n_samples),
            step_scs=step_scs, cfg=self.walk_config())
        segs = segs.cpu().numpy()
        n_frames = n_frames.cpu().numpy()
        return [walk_mod.flatten_segments(segs[c], n_frames[c])
                for c in range(len(mg_inputs))]
