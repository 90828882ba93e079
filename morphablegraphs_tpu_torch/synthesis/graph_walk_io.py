"""Graph-walk serialization and statistics (port of
morphablegraphs_tpu.synthesis.graph_walk_io).

Replaces reference graph_walk.py:396-485 (`get_statistics_string`,
`to_json`/`from_json`/`save_to_file`, the reference's checkpoint/resume
story) for the GraphWalkEntry step lists MotionGenerator produces.  The
JSON is the JAX package's, so a walk saved by either package loads in
the other.
"""

from __future__ import annotations

import json
from typing import List

import numpy as np
import torch

from ..models import primitive as prim_mod
from ..ops import align
from ..utils import device as device_mod
from .motion_generator import GraphWalkEntry, MotionResult


def steps_to_json(steps: List[GraphWalkEntry]) -> dict:
    """reference graph_walk.py:466-478 to_json shape: list of
    {node_key, parameters, arc_length, frame ranges}."""
    return {
        "steps": [
            {
                "node_key": list(s.node_key),
                "parameters": np.asarray(s.parameters).tolist(),
                "arc_length": float(s.arc_length),
                "start_frame": int(s.start_frame),
                "end_frame": int(s.end_frame),
                "error": float(s.error),
                "time_constraints": [list(t) for t in s.time_constraints],
            }
            for s in steps
        ]
    }


def steps_from_json(data: dict) -> List[GraphWalkEntry]:
    out = []
    for d in data.get("steps", []):
        out.append(GraphWalkEntry(
            node_key=tuple(d["node_key"]),
            parameters=np.asarray(d["parameters"], np.float32),
            arc_length=float(d.get("arc_length", 0.0)),
            start_frame=int(d.get("start_frame", 0)),
            end_frame=int(d.get("end_frame", 0)),
            error=float(d.get("error", 0.0)),
            time_constraints=tuple(tuple(t) for t in d.get("time_constraints", [])),
        ))
    return out


def save_graph_walk(path: str, steps: List[GraphWalkEntry]):
    """reference save_to_file: a saved walk is a resumable synthesis session
    (consumed as prev_graph_walk, motion_generator.py:134-140)."""
    with open(path, "w") as f:
        json.dump(steps_to_json(steps), f)


def load_graph_walk(path: str) -> List[GraphWalkEntry]:
    with open(path) as f:
        return steps_from_json(json.load(f))


def rebuild_frames_from_steps(graph, steps: List[GraphWalkEntry],
                              use_time: bool = True,
                              window: int = 20,
                              start_transform=None,
                              device=None) -> np.ndarray:
    """Re-project a (possibly deserialized) walk to frames — the resume path
    (reference GraphWalk.convert_to_annotated_motion :112).  Each step is
    one back-projection (the frame-emit kernel on a CUDA device) and one
    `align.align_clip` onto the frames before it; start_transform (q_y
    [4], delta [3]) places the first.  Runs on the CUDA device unless
    given device="cpu"."""
    device = device_mod.resolve(device, "rebuild_frames_from_steps")
    frames = None
    for step in steps:
        prim = graph.nodes[step.node_key].primitive.to(device)
        max_f = ((prim.n_canonical_frames * 2 + 31) // 32) * 32
        f, n, _ = prim_mod.back_project(
            prim, torch.as_tensor(np.array(step.parameters, np.float32),
                                  device=device),
            max_frames=max_f, use_time=use_time)
        n = int(n)
        if frames is None:
            f = f[:n]
            if start_transform is not None:
                q_y, delta = (torch.as_tensor(np.asarray(a, np.float32),
                                              device=device)
                              for a in start_transform)
                f = align.transform_frames(f, q_y, delta)
            frames = f.cpu().numpy()
        else:
            prev = torch.as_tensor(frames[-1], device=device)
            aligned = align.align_clip(prev, f, window)[:n]
            frames = np.concatenate([frames, aligned.cpu().numpy()], axis=0)
    return frames if frames is not None else np.zeros((0, 0), np.float32)


def get_statistics_string(result: MotionResult) -> str:
    """reference graph_walk.py:399-414: average error, objective evaluation
    count, time per motion primitive."""
    n = max(len(result.steps), 1)
    avg_error = result.stats.get("average_error", 0.0)
    evaluations = result.stats.get("objective_evaluations", 0)
    total_time = result.stats.get("time", 0.0)
    lines = [
        f"average error: {avg_error:.4f}",
        f"average keyframe constraint error: {avg_error:.4f}",
        f"number of objective evaluations: {evaluations}",
        f"average time per motion primitive: {total_time / n:.4f}s",
        f"total time: {total_time:.4f}s over {len(result.steps)} steps",
    ]
    return "\n".join(lines)
