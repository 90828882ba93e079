"""Holden et al.'s phase-functioned neural network and its controller's
frame step, in plain PyTorch, in any dtype (the judge runs float64; the
control runs float32 with every matrix product's operands rounded to TF32).

Frozen, written for the benchmark from the paper (Holden, Komura and Saito,
ACM TOG 36(4), 2017) and its demo (github.com/sreyafrancis/PFNN,
demo/pfnn.cpp); nothing here imports the program.  Rows are characters
(or a character at one frame: the judge stacks every frame's rows).

The network, as the demo evaluates it: each row's weights are the cubic
Catmull-Rom blend of the 4 control points' weights at its phase (the demo
blends the weights, not the layers' outputs), then

    y = Ystd * (W2 ELU(W1 ELU(W0 (x - Xmean) / Xstd + b0) + b1) + b2)
        + Ymean.

The state of a row (a dict): traj_pos [R, 120, 2] (x, z cm), traj_dir
[R, 120, 2] (unit facing x, z), traj_gait [R, 120, 6], joint_pos and
joint_vel [R, J, 3] (world, cm), phase [R] in [0, 1), arc [R] (the arc
of its path travelled, cm).  `step` is one frame (the layout of X and Y
and the order of the demo's update):

1. the future samples 61..119 are blended toward the desired velocity and
   facing, sample i by a = 1 - (1 - (i - 60) / 60)^bias: position i = the
   blended position i - 1 + mix(step i of the old positions, velocity,
   a); facing i = the facing turned by a times the shorter turn to the
   desired facing (the demo's slerp of two rotations about +Y); the
   future gaits copy the current one;
2. X: the samples 0, 10, .., 110 relative to the root (sample 60) in its
   frame, positions x then z, directions x then z; their 6 gait weights,
   each gait's 12 together; the joints' positions and velocities in the
   previous root's frame (sample 59); 36 terrain heights, 0 on flat ground;
3. joints: y's positions and velocities turned by the root's facing into
   the world (positions moved by the root); a joint's position becomes
   the mean of (its old position + velocity) and the predicted one; its
   global rotation is the root's facing times the rotation of y's
   exponential map (cos |r|, r sin |r| / |r|); the local one the parent's
   global inverse times it;
4. the past shifts by one; the current sample moves by s R(facing)(y0, y1)
   and turns by -s y2, s = (1 - stand)^(1/4); future sample 60 + d takes
   y's future points k = d div 10 and k + 1 (the sixth at most), mixed by
   (d mod 10) / 10, turned by the new facing and moved by the new root;
5. phase += (0.9 s + 0.1) y3 modulo 1; arc += the root's move.

The frame: joint 0's position and the J local quaternions (w, x, y, z).

Departures from the demo, as in the program's controller: the phase in
[0, 1) rather than radians; the desired velocity and facing taken as given
(the demo smooths its stick input); one blend exponent for positions and
facings; the last future samples mixed toward the sixth point rather than
past it (the demo reads the next block of Y there); exp(r) without the
demo's snap to the identity below |r| = 0.01; the bump gait carried in X
(the demo writes 0); no foot IK, walls or terrain."""

from __future__ import annotations

import math

import torch

from .ops import q_about_y, q_multiply, q_normalize

T, CUR, STRIDE, SAMPLES = 120, 60, 10, 12


class Network:
    """The network's arrays (model_pfnn.arrays) in `dtype` on `device`;
    round_fn, where given, rounds every matrix product's operands."""

    def __init__(self, arrays: dict, dtype, device, round_fn=None):
        w, m = arrays["weights"], arrays["means"]

        def t(a):
            return torch.as_tensor(a, device=device).to(dtype)
        self.w = [t(w[f"W{k}"]) for k in range(3)]  # [P, out, in]
        self.b = [t(w[f"b{k}"]) for k in range(3)]  # [P, out]
        self.x_mean, self.x_std = t(m["Xmean"]), torch.clamp(
            t(m["Xstd"]), min=1e-8)
        self.y_mean, self.y_std = t(m["Ymean"]), t(m["Ystd"])
        self.round = round_fn or (lambda a: a)

    def coefficients(self, phase):
        """[R, P] Catmull-Rom weights of the control points at phase."""
        p = self.w[0].shape[0]
        scaled = phase * p
        k = torch.floor(scaled).long()
        mu = scaled - k.to(phase.dtype)
        out = torch.zeros(phase.shape + (p,), dtype=phase.dtype,
                          device=phase.device)
        parts = (-0.5 * mu ** 3 + mu ** 2 - 0.5 * mu,
                 1.5 * mu ** 3 - 2.5 * mu ** 2 + 1.0,
                 -1.5 * mu ** 3 + 2.0 * mu ** 2 + 0.5 * mu,
                 0.5 * mu ** 3 - 0.5 * mu ** 2)
        for off, c in zip((-1, 0, 1, 2), parts):
            out.scatter_add_(-1, ((k + off) % p)[:, None], c[:, None])
        return out

    def __call__(self, x, phase, chunk: int = 128):
        """y [R, Y] for inputs x [R, X] at phases [R]."""
        ys = []
        for lo in range(0, x.shape[0], chunk):
            c = self.coefficients(phase[lo:lo + chunk])
            h = (x[lo:lo + chunk] - self.x_mean) / self.x_std
            for k in range(3):
                w = torch.einsum("rp,poi->roi", c, self.w[k])
                b = c @ self.b[k]
                h = torch.einsum("roi,ri->ro", self.round(w),
                                 self.round(h)) + b
                if k < 2:
                    h = torch.where(h > 0, h, torch.expm1(h))
            ys.append(h * self.y_std + self.y_mean)
        return torch.cat(ys)


def _rot(facing, v):
    """(x, z) pairs v [..., 2] turned from the frame of facing [..., 2]
    (sin, cos of its angle about +Y) into the world."""
    s, c = facing[..., 0], facing[..., 1]
    return torch.stack([c * v[..., 0] + s * v[..., 1],
                        -s * v[..., 0] + c * v[..., 1]], -1)


def _inv(facing, v):
    s, c = facing[..., 0], facing[..., 1]
    return torch.stack([c * v[..., 0] - s * v[..., 1],
                        s * v[..., 0] + c * v[..., 1]], -1)


def _on_xz(fn, facing, v):
    xz = fn(facing, v[..., [0, 2]])
    return torch.stack([xz[..., 0], v[..., 1], xz[..., 1]], -1)


def _exp(r):
    w = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    sinc = torch.where(w > 1e-8, torch.sin(w) / torch.clamp(w, min=1e-30),
                       torch.ones_like(w))
    return q_normalize(torch.cat([torch.cos(w), r * sinc], -1))


def blend(state: dict, facing, velocity, bias: float) -> dict:
    """Step 1: the future half blended toward velocity [R, 2] (cm a frame)
    and facing [R, 2]."""
    pos, dirs = state["traj_pos"].clone(), state["traj_dir"].clone()
    old = state["traj_pos"]
    goal = torch.atan2(facing[:, 0], facing[:, 1])
    for i in range(CUR + 1, T):
        a = 1.0 - (1.0 - (i - CUR) / CUR) ** bias
        step = old[:, i] - old[:, i - 1]
        pos[:, i] = pos[:, i - 1] + (1 - a) * step + a * velocity
        ang = torch.atan2(dirs[:, i, 0], dirs[:, i, 1])
        turn = torch.remainder(goal - ang + math.pi, 2 * math.pi) - math.pi
        ang = ang + a * turn
        dirs[:, i] = torch.stack([torch.sin(ang), torch.cos(ang)], -1)
    gait = state["traj_gait"].clone()
    gait[:, CUR + 1:] = gait[:, CUR:CUR + 1]
    return dict(state, traj_pos=pos, traj_dir=dirs, traj_gait=gait)


def inputs(state: dict):
    """Step 2: X [R, 156 + 6 J]."""
    r = state["traj_pos"].shape[0]
    pos, dirs = state["traj_pos"], state["traj_dir"]
    idx = list(range(0, T, STRIDE))
    root, face = pos[:, CUR], dirs[:, CUR]
    rel = torch.stack([_inv(face, pos[:, i] - root) for i in idx], 1)
    fac = torch.stack([_inv(face, dirs[:, i]) for i in idx], 1)
    gait = torch.cat([state["traj_gait"][:, idx, g] for g in range(6)], 1)
    prev, pface = pos[:, CUR - 1], dirs[:, CUR - 1]
    prev3 = torch.stack([prev[:, 0], torch.zeros_like(prev[:, 0]),
                         prev[:, 1]], -1)
    jp = _on_xz(_inv, pface[:, None], state["joint_pos"] - prev3[:, None])
    jv = _on_xz(_inv, pface[:, None], state["joint_vel"])
    return torch.cat([rel[..., 0], rel[..., 1], fac[..., 0], fac[..., 1],
                      gait, jp.reshape(r, -1), jv.reshape(r, -1),
                      torch.zeros((r, 3 * SAMPLES), dtype=pos.dtype,
                                  device=pos.device)], 1)


def update(state: dict, y, parents):
    """Steps 3-5 -> (the next state, the frame)."""
    r, j = state["joint_pos"].shape[:2]
    pos, dirs, gait = state["traj_pos"], state["traj_dir"], state["traj_gait"]
    root, face = pos[:, CUR], dirs[:, CUR]
    root3 = torch.stack([root[:, 0], torch.zeros_like(root[:, 0]),
                         root[:, 1]], -1)
    ypos = y[:, 32:32 + 3 * j].reshape(r, j, 3)
    yvel = y[:, 32 + 3 * j:32 + 6 * j].reshape(r, j, 3)
    yrot = y[:, 32 + 6 * j:32 + 9 * j].reshape(r, j, 3)
    world = _on_xz(_rot, face[:, None], ypos) + root3[:, None]
    vel = _on_xz(_rot, face[:, None], yvel)
    joint_pos = 0.5 * (state["joint_pos"] + vel) + 0.5 * world
    glob = q_multiply(q_about_y(torch.atan2(face[:, 0], face[:, 1]))[:, None],
                      _exp(yrot))
    local = [glob[:, 0]]
    for i in range(1, j):
        p = glob[:, parents[i]]
        local.append(q_multiply(p * p.new_tensor([1.0, -1.0, -1.0, -1.0]),
                                glob[:, i]))
    frame = torch.cat([joint_pos[:, 0], torch.stack(local, 1).reshape(r, -1)],
                      1)

    s = torch.clamp(1.0 - gait[:, CUR, 0], min=0.0) ** 0.25
    new_root = root + s[:, None] * _rot(face, y[:, 0:2])
    a = -s * y[:, 2]
    new_face = _rot(torch.stack([torch.sin(a), torch.cos(a)], -1), face)
    new_pos = torch.empty_like(pos)
    new_dirs = torch.empty_like(dirs)
    new_pos[:, :CUR], new_dirs[:, :CUR] = pos[:, 1:CUR + 1], dirs[:, 1:CUR + 1]
    new_pos[:, CUR], new_dirs[:, CUR] = new_root, new_face
    for i in range(CUR + 1, T):
        k = (i - CUR) // STRIDE
        k1 = min(k + 1, 5)
        m = ((i - CUR) % STRIDE) / STRIDE
        pt = [(1 - m) * y[:, 8 + 6 * c + k] + m * y[:, 8 + 6 * c + k1]
              for c in range(4)]
        new_pos[:, i] = _rot(new_face, torch.stack(pt[0:2], -1)) + new_root
        d = _rot(new_face, torch.stack(pt[2:4], -1))
        new_dirs[:, i] = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    new_gait = torch.cat([gait[:, 1:CUR + 1], gait[:, CUR:]], 1)
    new = dict(traj_pos=new_pos, traj_dir=new_dirs, traj_gait=new_gait,
               joint_pos=joint_pos, joint_vel=vel,
               phase=torch.remainder(state["phase"] + (0.9 * s + 0.1)
                                     * y[:, 3], 1.0),
               arc=state["arc"] + torch.linalg.vector_norm(new_root - root,
                                                           dim=-1))
    return new, frame


def step(net: Network, parents, state: dict, facing, speed_cm_s,
         bias: float):
    """One frame of the rows: (y, the next state, the frame).  facing
    [R, 2]: the desired facing; speed_cm_s [R]."""
    velocity = facing * (speed_cm_s / 60.0)[:, None]
    blended = blend(state, facing, velocity, bias)
    y = net(inputs(blended), blended["phase"])
    new, frame = update(blended, y, parents)
    return y, new, frame
