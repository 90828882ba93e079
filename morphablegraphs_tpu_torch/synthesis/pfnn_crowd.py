"""A crowd of phase-functioned characters, each walking along its own path
(Holden et al.'s controller, `models.pfnn`, batched over the crowd).

`pfnn_crowd_walk` steps N characters a frame at a time: each frame a
character's desired facing is its path's tangent at the arc it has
travelled so far (the running sum of its root's moves), its desired
velocity that facing times its speed, and `pfnn.holden_step` gives the
next state and the frame.  Nothing inside the frame loop waits for the
device.

On a CUDA device the frame step (the path query, the controller step and
the arc's update) goes through `FRAME_GRAPHS` (`ops.cuda_graphs.
StageGraphs`): keyed on the parents, the blend bias and the inputs'
layout, with the network's and the paths' tensors as `reads`; the first
frame of a new key runs eagerly, the second is captured, the rest replay
one graph a frame.  Counters `pfnn.eager`, `pfnn.graph_captures`,
`pfnn.graph_replays` (one per frame) and `pfnn.frames` (character-frames
emitted); spans `pfnn_crowd` (the walk) and `pfnn.frame` (each frame's
step), inside it `pfnn.encode`, `pfnn.net` and `pfnn.decode` where the
step runs eagerly.  None of them is a profiler range (`ranged=False`): a
CUDA trace shows a range as a device annotation as long as the kernels
under it, which a reader of device operations would count as one; the
readers place kernels in the tracer's spans by their launch times."""

from __future__ import annotations

import dataclasses
import functools

import torch

from ..models import pfnn
from ..ops import consts, cuda_graphs, spline_path
from ..utils import profiling

FRAME_GRAPHS = cuda_graphs.StageGraphs("pfnn", capacity=8)


def _frame(model, paths, parents, bias, state, arc, speed):
    """One frame of the crowd -> (the next state's fields, arc, the
    desired facing, y, frame)."""
    _, facing = spline_path.point_and_dir_at_arc_length(paths, arc)
    new, y, frame = pfnn.holden_step(
        model, state, facing, facing * (speed / pfnn.FPS)[:, None], parents,
        bias)
    moved = new.traj_pos[:, pfnn.CURRENT] - state.traj_pos[:, pfnn.CURRENT]
    arc = arc + torch.linalg.vector_norm(moved, dim=-1)
    return tuple(getattr(new, f.name) for f in
                 dataclasses.fields(new)) + (arc, facing, y, frame)


def _frame_step(model, paths, parents, bias, state, arc, speed):
    """One frame: (the next state, its arc [N], the desired facing [N, 2],
    the network's output y [N, Y], the frame [N, 3 + 4 J])."""
    reads = tuple(getattr(model, f.name) for f in dataclasses.fields(model)) \
        + tuple(getattr(paths, f.name) for f in dataclasses.fields(paths))
    out = FRAME_GRAPHS.run(
        functools.partial(_frame, model, paths, parents, bias),
        (state, arc, speed), key=("pfnn.frame", parents, float(bias)),
        reads=reads)
    n = len(dataclasses.fields(pfnn.HoldenState))
    return (pfnn.HoldenState(*out[:n]),) + tuple(out[n:])


@profiling.span("pfnn_crowd", ranged=False)
def pfnn_crowd_walk(model: pfnn.PFNN, paths: spline_path.PathSpline,
                    gait: torch.Tensor, phase: torch.Tensor, n_frames: int,
                    speed: torch.Tensor, blend_bias: float = 0.5,
                    skeleton=None):
    """N characters of Holden's controller along their own paths [N]
    (`spline_path.stack_paths`), each from its path's start facing along
    it, in the rest pose, with gait [N, 6] (`pfnn.GAITS` weights, constant
    through the walk), starting phase [N] in [0, 1) and speed [N] (cm/s),
    for n_frames frames at 60 fps.  skeleton: the network's joints
    (`pfnn.holden_skeleton()` by default).  Returns (frames [N, n_frames,
    3 + 4 J], each character's frame count [N]) on the model's device."""
    skeleton = skeleton or pfnn.holden_skeleton()
    j = pfnn.holden_joints(model.x_mean.shape[0], model.y_mean.shape[0])
    if skeleton.n_animated != j:
        raise ValueError(f"the network drives {j} joints and the skeleton "
                         f"has {skeleton.n_animated}")
    n, dev, dt = gait.shape[0], gait.device, model.w0.dtype
    parents = tuple(skeleton.parents)
    rest = consts.constant(tuple(map(tuple, pfnn.rest_positions(
        skeleton).tolist())), dt, dev)
    arc = torch.zeros((n,), dtype=dt, device=dev)
    start, facing = spline_path.point_and_dir_at_arc_length(paths, arc)
    state = pfnn.holden_initial_state(
        torch.stack([start[:, 0], start[:, 2]], -1), facing, gait, phase,
        rest)
    frames = torch.empty((n, n_frames, 3 + 4 * j), dtype=dt, device=dev)
    for f in range(n_frames):
        with profiling.span("pfnn.frame", ranged=False):
            state, arc, _, _, frame = _frame_step(
                model, paths, parents, blend_bias, state, arc, speed)
            frames[:, f] = frame
        profiling.count("pfnn.frames", n)
    return frames, torch.full((n,), n_frames, dtype=torch.int32, device=dev)
