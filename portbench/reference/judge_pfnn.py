"""The PFNN crowd's comparison: each judged character's every frame of the
judged walk followed from the program's own state (a closed loop's float32
and float64 runs drift apart, and that drift must not decide the verdict).

The driver observes the program's frame step and keeps, for the judged
rows, the state it was handed (with the arc travelled), the desired facing
it took from the path, the network's output y, the frame and the next
state.  The reference (`pfnn.step`, float64) recomputes y, the next state
and the frame from that state and facing, and `Path.point_and_dir` the
facing from the path at that arc.  The numbers:

* net_gap: the largest |y - y_ref| in units of Ystd;
* frame_gap: the largest difference of the frame's root (cm) and of its
  quaternions' components (each joint's quaternion up to its sign);
* state_gap: the largest difference of the next state: trajectory
  positions and the arc (cm), facings, gaits, joint positions (cm) and
  velocities (cm a frame), phase (modulo 1);
* target_gap: the largest difference of the desired facing;
* chain_gap: the largest difference between the state (and arc) a frame
  was handed and the next state (and arc) the frame before returned, so
  each frame steps from the last one's result;
* emitted_gap: the largest difference between the frames the walk
  returned for the judged rows and the frames each step gave, so each
  frame lands in its own slot;
* nonfinite: non-finite values among the whole walk's frames;
* counts_wrong: characters whose frame count is not the walk's;
* state_missing: 1 where the program's frame step could not be observed
  (every other number is then inf)."""

from __future__ import annotations

import math

import torch

from . import ops as ref_ops
from . import pfnn as ref

STATE = ("traj_pos", "traj_dir", "traj_gait", "joint_pos", "joint_vel",
         "phase", "arc")


def missing() -> dict:
    inf = math.inf
    return dict(net_gap=inf, frame_gap=inf, state_gap=inf, target_gap=inf,
                chain_gap=inf, emitted_gap=inf, nonfinite=inf,
                counts_wrong=inf, state_missing=1)


def flat(x):
    """[F, R, ...] -> [F R, ...]."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def path_facing(path: ref_ops.Path, arc, round_fn=None):
    """`Path.point_and_dir`'s facing [C, 2] at arc [C] (one per path),
    with the matrix product of its basis weights' operands rounded by
    round_fn (the control's)."""
    r = round_fn or (lambda a: a)

    def at(u):
        n_seg = max(path.n_points - 1, 1)
        scaled = torch.clamp(u, 0.0, 1.0) * n_seg
        idx = torch.clamp(torch.floor(scaled).long(), 0, path.n_points - 2)
        local = scaled - idx.to(u.dtype)
        base = torch.tensor(ref_ops._CR, dtype=u.dtype, device=u.device)
        w = r(torch.stack([local ** 3, local ** 2, local,
                           torch.ones_like(local)], -1)) @ r(base)
        out = 0.0
        for o in range(4):
            p = torch.gather(path.pts, 1, (idx + o)[..., None].expand(
                idx.shape + (3,)))
            out = out + w[..., o:o + 1] * p
        return 0.5 * out

    u = path.u_at_arc(arc[:, None])
    d = (at(torch.clamp(u + 5e-4, 0.0, 1.0))
         - at(torch.clamp(u - 5e-4, 0.0, 1.0)))[:, 0]
    d2 = torch.stack([d[:, 0], d[:, 2]], -1)
    return d2 / torch.clamp(torch.linalg.vector_norm(d2, dim=-1,
                                                     keepdim=True),
                            min=1e-10)


def frames_path(control_points, granularity: int, frames: int, dtype,
                device) -> ref_ops.Path:
    """The judged rows' paths [R] repeated for every frame, [F R]."""
    path = ref_ops.Path(torch.as_tensor(control_points, dtype=dtype,
                                        device=device), granularity)
    rows = path.table_arc.shape[0]
    return path.rows(torch.arange(rows, device=device).repeat(frames))


def reference_outputs(net: ref.Network, parents, observed: dict, speed,
                      bias: float, dtype, device, path=None) -> dict:
    """The reference's y, next state and frame of every observed frame, in
    dtype, from the program's state; observed: [F, R, ...] tensors
    (`STATE` under "in.<name>" and "out.<name>", "facing", "y", "frame"),
    speed [R] cm/s.  The facing is the program's, or with `path`
    (`frames_path`) the reference's own at the program's arc, its product
    rounded as the network's (the control in the program's place)."""
    f = observed["y"].shape[0]
    state = {k: flat(observed["in." + k]).to(device, dtype) for k in STATE}
    facing = flat(observed["facing"]).to(device, dtype) if path is None \
        else path_facing(path, state["arc"], net.round)
    y, new, frame = ref.step(net, parents, state, facing,
                             speed.to(device, dtype).repeat(f), bias)
    out = {"y": y, "frame": frame, "facing": facing}
    out.update({"out." + k: v for k, v in new.items()})
    return out


def gap_to(a, b, device):
    return (a.to(device, torch.float64) - b).abs()


def phase_gap(a, b):
    """|a - b| of phases modulo 1."""
    d = torch.remainder(a - b, 1.0)
    return torch.minimum(d, 1.0 - d)


def chain_gap(observed: dict, device) -> float:
    """The largest |in.X[f + 1] - out.X[f]| over `STATE` ([F, R, ...]
    observations), the phase modulo 1; 0 for a single frame."""
    gaps = [torch.zeros((), dtype=torch.float64, device=device)]
    for k in STATE:
        handed = observed["in." + k][1:].to(device, torch.float64)
        left = observed["out." + k][:-1].to(device, torch.float64)
        if handed.numel():
            d = phase_gap(handed, left) if k == "phase" \
                else (handed - left).abs()
            gaps.append(d.max())
    return float(torch.stack(gaps).max())


def emitted_gap(observed: dict, emitted, device) -> float:
    """The largest |returned frame - stepped frame| of the judged rows;
    emitted: the walk's returned frames of those rows [R, F, D]."""
    stepped = observed["frame"].to(device, torch.float64)  # [F, R, D]
    returned = emitted.to(device, torch.float64).transpose(0, 1)
    if returned.shape != stepped.shape:
        return math.inf
    return float((returned - stepped).abs().max())


def judge(net: ref.Network, parents, path: ref_ops.Path, observed: dict,
          outputs: dict, speed, bias: float, n_frames, walk_frames: int,
          nonfinite, emitted) -> dict:
    """The numbers of the module's docstring; outputs: the program's
    facing, y, next state and frame ([F R, ...]) or a control's in their
    place; path: the judged rows' paths for every frame (`frames_path`,
    float64); emitted: the judged rows of the walk's frames [R, F, D]."""
    dev, f64 = net.y_std.device, torch.float64
    f = observed["y"].shape[0]
    if f != walk_frames:
        return missing()
    mine = reference_outputs(net, parents, observed, speed, bias, f64, dev)

    def gap(name):
        return gap_to(outputs[name], mine[name], dev)

    net_gap = (gap("y") / net.y_std).max()
    fr, fm = outputs["frame"].to(dev, f64), mine["frame"]
    root = (fr[:, :3] - fm[:, :3]).abs().max()
    q, qm = fr[:, 3:].reshape(fr.shape[0], -1, 4), fm[:, 3:].reshape(
        fm.shape[0], -1, 4)
    quat = torch.minimum((q - qm).abs().amax(-1),
                         (q + qm).abs().amax(-1)).max()
    state = [gap("out." + k).max() for k in STATE if k != "phase"]
    state.append(phase_gap(outputs["out.phase"].to(dev, f64),
                           mine["out.phase"]).max())
    _, want = path.point_and_dir(flat(observed["in.arc"]).to(dev, f64))
    target = gap_to(outputs["facing"], want, dev).max()
    return dict(net_gap=float(net_gap), frame_gap=float(max(root, quat)),
                state_gap=float(torch.stack(state).max()),
                target_gap=float(target), chain_gap=chain_gap(observed, dev),
                emitted_gap=emitted_gap(observed, emitted, dev),
                nonfinite=float(nonfinite),
                counts_wrong=float((n_frames != walk_frames).sum()),
                state_missing=0)
