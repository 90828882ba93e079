"""Phase-functioned neural network runtime (port of
morphablegraphs_tpu.models.pfnn; Holden, Komura and Saito, "Phase-Functioned
Neural Networks for Character Control", ACM TOG 36(4), SIGGRAPH 2017,
whose public demo is github.com/sreyafrancis/PFNN demo/pfnn.cpp).

A graph zip may carry PFNN weights (pfnn/weights W0..W2, b0..b2 and
pfnn/means Xmean, Ymean, Xstd, Ystd, float32 binaries).  Each weight has a
leading axis of phase control points (4), Catmull-Rom interpolated at the
character's phase; the network is three layers with ELU between them.
The crowd step evaluates every control point's layer for all characters
with one batched matmul and blends the outputs with each character's
interpolation coefficients (the interpolation is linear in the weights).

The network:

    y = Ystd * L2(ELU(L1(ELU(L0((x - Xmean) / Xstd))))) + Ymean
    L_k(h) = sum_p c_p(phi) (W_k[p] h + b_k[p])

c(phi) are the cubic Catmull-Rom weights of the 4 control points at the
phase phi in [0, 1).

Holden's controller (`HoldenState`, `holden_step`), batched over N
characters whose state lives on the device.  Each character carries a
trajectory window of 120 samples at 60 fps (60 past, the current one at
index 60, 59 future): positions (x, z) in cm, facing directions (x, z) and
gait weights (stand, walk, jog, crouch, jump, bump); the current sample is
the root's position and facing.  Besides: the phase and the J joints'
world positions and velocities.  X (48 + 72 + 6 J + 36; 342 at J = 31), in
the demo's order:

    [0:48]     the 12 samples 0, 10, .., 110 in the root's frame:
               positions x (12), z (12), directions x (12), z (12)
    [48:120]   gait stand, walk, jog, crouch, jump, bump at those samples
    [120:120+3J], [120+3J:120+6J]
               the previous frame's joint positions and velocities in the
               previous root's frame (sample 59)
    [120+6J:]  terrain heights right, centre and left at the 12 samples,
               relative to the root's height

Y (32 + 9 J; 311 at J = 31): [0:3] the root's velocity x, z and angular
velocity, [3] the phase change, [4:8] foot contacts, [8:32] the 6 future
samples (positions x, z, directions x, z, 6 each), then the joint
positions, velocities and rotations (exponential maps, 3 J each), all in
the root's frame.

One step (`holden_step`):

1. blend future sample i (61..119) toward the desired velocity and
   direction, by 1 - (1 - (i - 60) / 60)^bias: positions as running sums
   of the mixed steps, directions by the angle's shortest turn;
2. X from the state, y from the network at the phase;
3. joints: predicted positions, velocities and rotations into the world by
   the root (sample 60); positions = the mean of (previous + velocity) and
   the prediction; rotations q_root * exp(r) -> local quaternions through
   the hierarchy;
4. shift the past half; move the current sample by s R (y0, y1) and turn it
   by -s y2, s = (1 - stand)^(1/4); fill the future from y[8:32] between
   the 6 points in the new root's frame;
5. phase += (0.9 s + 0.1) y3, modulo 1.

The frame: the first joint's position, then the J local quaternions
(w, x, y, z), 3 + 4 J channels (127 at J = 31), for `holden_skeleton()`.

Departures from the demo: the phase is in [0, 1) (the demo's radians / 2
pi); the desired velocity and direction are taken as given each frame (the
demo smooths the stick input first); one blend bias serves positions and
directions (the demo's bias_pos and bias_dir); the last future samples
(111..119) interpolate toward the sixth point and not past it (the demo
reads the next block of Y there); exp(r) is exact near 0 (the demo snaps
|r| < 0.01 to the identity); the bump gait is carried in X as the state
holds it (the demo writes 0); foot IK, walls and terrain are left out
(flat ground: the height inputs are 0)."""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import consts, quat
from ..utils import profiling


@dataclasses.dataclass
class PFNN:
    w0: torch.Tensor  # [P, H, X]
    b0: torch.Tensor  # [P, H]
    w1: torch.Tensor  # [P, H, H]
    b1: torch.Tensor  # [P, H]
    w2: torch.Tensor  # [P, Y, H]
    b2: torch.Tensor  # [P, Y]
    x_mean: torch.Tensor  # [X]
    x_std: torch.Tensor  # [X]
    y_mean: torch.Tensor  # [Y]
    y_std: torch.Tensor  # [Y]

    @property
    def n_controls(self) -> int:
        return self.w0.shape[0]


def load_from_arrays(weights: Dict[str, np.ndarray],
                     means: Dict[str, np.ndarray], n_controls: int = 4,
                     hidden: int = 512, device=None) -> PFNN:
    """The zip's flat binaries reshaped into phase-indexed tensors on
    `device` (Xstd clamped at 1e-8)."""
    x_dim = np.asarray(means["Xmean"]).shape[0]
    y_dim = np.asarray(means["Ymean"]).shape[0]

    def t(a, *dims):
        a = np.array(a, np.float32)  # a writable copy of the zip's buffer
        return torch.as_tensor(a.reshape(*dims) if dims else a, device=device)

    return PFNN(
        w0=t(weights["W0"], n_controls, hidden, x_dim),
        b0=t(weights["b0"], n_controls, hidden),
        w1=t(weights["W1"], n_controls, hidden, hidden),
        b1=t(weights["b1"], n_controls, hidden),
        w2=t(weights["W2"], n_controls, y_dim, hidden),
        b2=t(weights["b2"], n_controls, y_dim),
        x_mean=t(means["Xmean"]),
        x_std=t(np.maximum(np.asarray(means["Xstd"], np.float32), 1e-8)),
        y_mean=t(means["Ymean"]), y_std=t(means["Ystd"]))


def _catmull_rom_coeffs(n_controls: int, phase: torch.Tensor) -> torch.Tensor:
    """[N, P] weights of the control points in the cubic Catmull-Rom
    interpolation at each phase in [0, 1): control k1 = floor(phase P) and
    its neighbours k1 - 1, k1 + 1, k1 + 2 (mod P)."""
    p = n_controls
    pscaled = phase * p
    k1 = torch.floor(pscaled).to(torch.long) % p
    w = pscaled - torch.floor(pscaled)
    w2, w3 = w * w, w * w * w
    coeffs = torch.stack([-0.5 * w + w2 - 0.5 * w3,  # k1 - 1
                          1.0 - 2.5 * w2 + 1.5 * w3,  # k1
                          0.5 * w + 2.0 * w2 - 1.5 * w3,  # k1 + 1
                          -0.5 * w2 + 0.5 * w3], dim=-1)  # k1 + 2
    idx = (k1[:, None] + torch.arange(-1, 3, device=phase.device)) % p
    return torch.zeros(phase.shape + (p,), dtype=phase.dtype,
                       device=phase.device).scatter_add_(-1, idx, coeffs)


def _layer(c: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           h: torch.Tensor) -> torch.Tensor:
    """sum_p c[n, p] (w[p] @ h[n] + b[p]) for c [N, P], w [P, O, I],
    b [P, O], h [N, I] -> [N, O]: one [N, I] x [I, P O] matmul, then the
    blend over the control points."""
    p, o, i = w.shape
    z = (h @ w.reshape(p * o, i).T).reshape(-1, p, o) + b  # [N, P, O]
    return (c[:, :, None] * z).sum(dim=1)


def forward_crowd(model: PFNN, xs: torch.Tensor,
                  phases: torch.Tensor) -> torch.Tensor:
    """One step for N characters on the model's device: inputs xs [N, X]
    at phases [N] -> outputs [N, Y] (normalized in, ELU layers with the
    phase-interpolated weights, denormalized out)."""
    c = _catmull_rom_coeffs(model.n_controls, phases.to(torch.float32))
    h = (xs - model.x_mean) / model.x_std
    h = F.elu(_layer(c, model.w0, model.b0, h))
    h = F.elu(_layer(c, model.w1, model.b1, h))
    return _layer(c, model.w2, model.b2, h) * model.y_std + model.y_mean


def forward(model: PFNN, x: torch.Tensor, phase) -> torch.Tensor:
    """One character's step: x [X] at a phase -> [Y]."""
    phase = torch.as_tensor(phase, dtype=torch.float32, device=x.device)
    return forward_crowd(model, x[None], phase.reshape(1))[0]


PFNN_WEIGHT_KEYS = ("W0", "W1", "W2", "b0", "b1", "b2")
PFNN_MEAN_KEYS = ("Xmean", "Ymean", "Xstd", "Ystd")


def read_pfnn_arrays(zf) -> "dict | None":
    """{weights, means} float32 arrays from an open graph zip's pfnn/
    section; None without one.  An incomplete section raises ValueError
    naming the missing binaries."""
    names = set(zf.namelist())
    if not any(n.startswith("pfnn/") for n in names):
        return None
    paths = {k: f"pfnn/weights/{k}.bin" for k in PFNN_WEIGHT_KEYS}
    paths.update({k: f"pfnn/means/{k}.bin" for k in PFNN_MEAN_KEYS})
    missing = [p for p in paths.values() if p not in names]
    if missing:
        raise ValueError(
            f"incomplete pfnn/ section in graph zip: missing {missing}")
    return {"weights": {k: np.frombuffer(zf.read(paths[k]), np.float32)
                        for k in PFNN_WEIGHT_KEYS},
            "means": {k: np.frombuffer(zf.read(paths[k]), np.float32)
                      for k in PFNN_MEAN_KEYS}}


def read_pfnn_from_zip(zip_path: str, n_controls: int = 4,
                       hidden: int = 512, device=None):
    """The PFNN of a graph zip on `device` (the CUDA device unless given
    another), or None when it has none."""
    import zipfile

    from ..utils import device as device_mod
    with zipfile.ZipFile(zip_path, "r") as zf:
        data = read_pfnn_arrays(zf)
    if data is None:
        return None
    return load_from_arrays(data["weights"], data["means"], n_controls,
                            hidden, device=device_mod.resolve(
                                device, "read_pfnn_from_zip"))


class PFNNWrapper:
    """A phase-stepping controller with the surface MGStatePlanner drives:
    reset(position, phase, direction) and get_next_frame(target_dir).

    encode_fn(wrapper, target_dir) -> network input [X];
    decode_fn(y, wrapper) -> (quaternion frame, new position, phase
    advance).  The pair fixes the trained network's I/O layout, which the
    weight blobs alone do not define.  The network runs on the model's
    device; the state stays on the host."""

    def __init__(self, model: PFNN, encode_fn, decode_fn):
        self.model = model
        self.encode_fn = encode_fn
        self.decode_fn = decode_fn
        self.position = np.zeros(3)
        self.phase = 0.0
        self.direction = np.array([0.0, 0.0, 1.0])

    def reset(self, position, phase, direction):
        self.position = np.asarray(position, np.float64)
        self.phase = float(phase)
        self.direction = np.asarray(direction, np.float64)

    def get_next_frame(self, target_dir) -> np.ndarray:
        x = self.encode_fn(self, np.asarray(target_dir, np.float64))
        y = forward(self.model, torch.as_tensor(
            np.asarray(x, np.float32), device=self.model.w0.device),
            self.phase).cpu().numpy()
        frame, self.position, dphase = self.decode_fn(y, self)
        self.phase = float((self.phase + dphase) % 1.0)
        return np.asarray(frame, np.float32)


# -- Holden's controller ------------------------------------------------------

TRAJECTORY = 120  # samples of a character's trajectory window, 60 fps
CURRENT = 60  # the index of the current sample (the root)
STRIDE = 10  # every 10th sample enters X
FPS = 60.0
GAITS = ("stand", "walk", "jog", "crouch", "jump", "bump")
JOINT_SMOOTH = 0.5  # the demo's extra_joint_smooth
# the demo's 31 joints (CMU names), parents and offsets (cm, assumed: the
# demo loads its own from binaries the repository does not ship)
HOLDEN_JOINTS = (
    ("Hips", -1, (0.0, 0.0, 0.0)),
    ("LHipJoint", 0, (0.0, 0.0, 0.0)),
    ("LeftUpLeg", 1, (9.0, -8.0, 1.5)),
    ("LeftLeg", 2, (0.0, -42.0, 0.0)),
    ("LeftFoot", 3, (0.0, -40.0, -2.0)),
    ("LeftToeBase", 4, (0.0, -4.0, 13.0)),
    ("RHipJoint", 0, (0.0, 0.0, 0.0)),
    ("RightUpLeg", 6, (-9.0, -8.0, 1.5)),
    ("RightLeg", 7, (0.0, -42.0, 0.0)),
    ("RightFoot", 8, (0.0, -40.0, -2.0)),
    ("RightToeBase", 9, (0.0, -4.0, 13.0)),
    ("LowerBack", 0, (0.0, 2.0, -1.0)),
    ("Spine", 11, (0.0, 11.0, 0.0)),
    ("Spine1", 12, (0.0, 11.0, 0.5)),
    ("Neck", 13, (0.0, 12.0, 0.0)),
    ("Neck1", 14, (0.0, 5.0, 0.5)),
    ("Head", 15, (0.0, 6.0, 1.0)),
    ("LeftShoulder", 13, (2.0, 9.0, 0.0)),
    ("LeftArm", 17, (15.0, 0.0, 0.0)),
    ("LeftForeArm", 18, (28.0, 0.0, 0.0)),
    ("LeftHand", 19, (25.0, 0.0, 0.0)),
    ("LeftFingerBase", 20, (3.0, 0.0, 0.0)),
    ("LeftHandIndex1", 21, (4.0, 0.0, 0.0)),
    ("LThumb", 20, (2.0, 0.0, 2.5)),
    ("RightShoulder", 13, (-2.0, 9.0, 0.0)),
    ("RightArm", 24, (-15.0, 0.0, 0.0)),
    ("RightForeArm", 25, (-28.0, 0.0, 0.0)),
    ("RightHand", 26, (-25.0, 0.0, 0.0)),
    ("RightFingerBase", 27, (-3.0, 0.0, 0.0)),
    ("RightHandIndex1", 28, (-4.0, 0.0, 0.0)),
    ("RThumb", 27, (-2.0, 0.0, 2.5)),
)


def holden_joints(x_dim: int, y_dim: int) -> int:
    """The joint count J of Holden's layout with these widths (X = 156 +
    6 J, Y = 32 + 9 J); ValueError for widths of another layout."""
    j, rest = divmod(x_dim - 156, 6)
    if rest or j < 1 or y_dim != 32 + 9 * j:
        raise ValueError(f"X {x_dim}, Y {y_dim} is not Holden's layout "
                         "(X = 156 + 6 J, Y = 32 + 9 J)")
    return j


def skeleton_of(joints=HOLDEN_JOINTS):
    """A Skeleton of (name, parent, offset) joints, every joint animated,
    the first the root with its position channels; 60 fps."""
    from .skeleton import Skeleton
    names, parents, offsets = zip(*joints)
    if parents[0] != -1 or any(not 0 <= p < i
                               for i, p in enumerate(parents[1:], 1)):
        raise ValueError("the first joint is the root and every other "
                         "joint's parent comes before it")
    rot = ("Zrotation", "Xrotation", "Yrotation")
    channels = (("Xposition", "Yposition", "Zposition") + rot,) \
        + (rot,) * (len(names) - 1)
    return Skeleton(tuple(names), tuple(parents), np.asarray(offsets),
                    channels, tuple(names), frame_time=1.0 / FPS)


def holden_skeleton():
    """The 31-joint skeleton of Holden's frames, for BVH export."""
    return skeleton_of(HOLDEN_JOINTS)


def rest_positions(skeleton) -> np.ndarray:
    """[J, 3] the joints' positions in the rest pose relative to the root
    on the ground: the offsets' running sums, lifted so that the lowest
    joint stands at height 0."""
    pos = np.zeros((skeleton.n_nodes, 3), np.float64)
    for i, p in enumerate(skeleton.parents):
        pos[i] = skeleton.offsets[i] + (pos[p] if p >= 0 else 0.0)
    pos[:, 1] -= pos[:, 1].min()
    return pos


@dataclasses.dataclass
class HoldenState:
    """N characters' controller state (the module's docstring)."""
    traj_pos: torch.Tensor  # [N, 120, 2] x, z (cm)
    traj_dir: torch.Tensor  # [N, 120, 2] unit facing x, z
    traj_gait: torch.Tensor  # [N, 120, 6] GAITS
    joint_pos: torch.Tensor  # [N, J, 3] world (cm)
    joint_vel: torch.Tensor  # [N, J, 3] world (cm per frame)
    phase: torch.Tensor  # [N] in [0, 1)


def holden_initial_state(position: torch.Tensor, direction: torch.Tensor,
                         gait: torch.Tensor, phase: torch.Tensor,
                         rest: torch.Tensor) -> HoldenState:
    """Characters standing still in the rest pose: every trajectory sample
    at position [N, 2] (x, z) facing direction [N, 2] with gait [N, 6];
    rest [J, 3] (`rest_positions`)."""
    n, t = position.shape[0], TRAJECTORY
    d = direction / torch.linalg.vector_norm(direction, dim=-1, keepdim=True)
    root = torch.stack([position[:, 0], torch.zeros_like(position[:, 0]),
                        position[:, 1]], -1)
    joints = _rotate3(d[:, None], rest.expand(n, -1, -1)) + root[:, None]
    return HoldenState(
        traj_pos=position[:, None].expand(n, t, 2).contiguous(),
        traj_dir=d[:, None].expand(n, t, 2).contiguous(),
        traj_gait=gait[:, None].expand(n, t, gait.shape[-1]).contiguous(),
        joint_pos=joints, joint_vel=torch.zeros_like(joints),
        phase=phase.contiguous())


def _rotate_xz(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v [..., 2] (x, z) in the frame of facing d [..., 2] (sin, cos of the
    angle about +Y) -> the world's."""
    s, c = d[..., 0], d[..., 1]
    x, z = v[..., 0], v[..., 1]
    return torch.stack([x * c + z * s, z * c - x * s], -1)


def _unrotate_xz(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """The world's v [..., 2] -> the frame of facing d."""
    s, c = d[..., 0], d[..., 1]
    x, z = v[..., 0], v[..., 1]
    return torch.stack([x * c - z * s, x * s + z * c], -1)


def _rotate3(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    xz = _rotate_xz(d, torch.stack([v[..., 0], v[..., 2]], -1))
    return torch.stack([xz[..., 0], v[..., 1], xz[..., 1]], -1)


def _unrotate3(d: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    xz = _unrotate_xz(d, torch.stack([v[..., 0], v[..., 2]], -1))
    return torch.stack([xz[..., 0], v[..., 1], xz[..., 1]], -1)


def _turn(d: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Facing d [..., 2] turned by angle about +Y."""
    return _rotate_xz(torch.stack([torch.sin(angle), torch.cos(angle)], -1),
                      d)


def quat_exp(r: torch.Tensor) -> torch.Tensor:
    """The demo's exponential map: r [..., 3] -> (cos |r|, r sin |r| / |r|),
    normalised (|r| is the half angle)."""
    w = torch.linalg.vector_norm(r, dim=-1, keepdim=True)
    small = w < 1e-4
    safe = torch.where(small, torch.ones_like(w), w)
    k = torch.where(small, 1.0 - w * w / 6.0, torch.sin(safe) / safe)
    return quat.normalize(torch.cat([torch.cos(w), r * k], -1))


def blend_trajectory(state: HoldenState, target_dir: torch.Tensor,
                     target_vel: torch.Tensor, bias: float) -> HoldenState:
    """The future half blended toward the desired facing target_dir [N, 2]
    and velocity target_vel [N, 2] (cm per frame): sample i by
    1 - (1 - (i - 60) / 60)^bias, positions as running sums of the mixed
    steps, facings turned by that share of the shortest turn; the future
    gaits are the current one."""
    pos, dirs, dt, dev = (state.traj_pos, state.traj_dir,
                          state.traj_pos.dtype, state.traj_pos.device)
    half = TRAJECTORY - CURRENT
    scale = consts.constant(tuple(1.0 - (1.0 - i / half) ** bias
                                  for i in range(1, half)), dt, dev)
    steps = pos[:, CURRENT + 1:] - pos[:, CURRENT:-1]
    mixed = steps + scale[:, None] * (target_vel[:, None] - steps)
    future = pos[:, CURRENT:CURRENT + 1] + torch.cumsum(mixed, 1)
    ang = torch.atan2(dirs[:, CURRENT + 1:, 0], dirs[:, CURRENT + 1:, 1])
    goal = torch.atan2(target_dir[:, 0], target_dir[:, 1])[:, None]
    turn = torch.remainder(goal - ang + math.pi, 2 * math.pi) - math.pi
    ang = ang + scale * turn
    gait = state.traj_gait
    return dataclasses.replace(
        state,
        traj_pos=torch.cat([pos[:, :CURRENT + 1], future], 1),
        traj_dir=torch.cat([dirs[:, :CURRENT + 1], torch.stack(
            [torch.sin(ang), torch.cos(ang)], -1)], 1),
        traj_gait=torch.cat([gait[:, :CURRENT + 1], gait[:, CURRENT:
                             CURRENT + 1].expand(-1, half - 1, -1)], 1))


def holden_input(state: HoldenState) -> torch.Tensor:
    """X [N, 156 + 6 J] of the state (the module's layout)."""
    n = state.traj_pos.shape[0]
    pos, dirs = state.traj_pos, state.traj_dir
    d = dirs[:, CURRENT, None]
    rel = _unrotate_xz(d, pos[:, ::STRIDE] - pos[:, CURRENT, None])
    fac = _unrotate_xz(d, dirs[:, ::STRIDE])
    gait = state.traj_gait[:, ::STRIDE].transpose(1, 2).reshape(n, -1)
    prev = pos[:, CURRENT - 1]
    prev3 = torch.stack([prev[:, 0], torch.zeros_like(prev[:, 0]),
                         prev[:, 1]], -1)
    pd = dirs[:, CURRENT - 1, None]
    jp = _unrotate3(pd, state.joint_pos - prev3[:, None])
    jv = _unrotate3(pd, state.joint_vel)
    heights = torch.zeros((n, 3 * (TRAJECTORY // STRIDE)), dtype=pos.dtype,
                          device=pos.device)
    return torch.cat([rel[..., 0], rel[..., 1], fac[..., 0], fac[..., 1],
                      gait, jp.reshape(n, -1), jv.reshape(n, -1), heights], 1)


def _future_tables(dt, dev):
    """(lower point, upper point, share of the upper) of the future
    samples 61..119 between the 6 predicted points."""
    lo, hi, m = [], [], []
    for i in range(CURRENT + 1, TRAJECTORY):
        k = (i - CURRENT) // STRIDE
        lo.append(k)
        hi.append(min(k + 1, 5))
        m.append(((i - CURRENT) % STRIDE) / STRIDE)
    return (consts.constant(tuple(lo), torch.long, dev),
            consts.constant(tuple(hi), torch.long, dev),
            consts.constant(tuple(m), dt, dev))


def holden_update(state: HoldenState, y: torch.Tensor, parents: tuple):
    """The state after the network's output y [N, 32 + 9 J] and the frame
    [N, 3 + 4 J] (the module's steps 3-5); parents: the J joints' parent
    indices, the root's -1 first."""
    n, j = state.joint_pos.shape[:2]
    dt, dev = y.dtype, y.device
    pos, dirs, gait = state.traj_pos, state.traj_dir, state.traj_gait
    root, d = pos[:, CURRENT], dirs[:, CURRENT]
    root3 = torch.stack([root[:, 0], torch.zeros_like(root[:, 0]),
                         root[:, 1]], -1)
    o = 32
    world = _rotate3(d[:, None], y[:, o:o + 3 * j].reshape(n, j, 3)) \
        + root3[:, None]
    vel = _rotate3(d[:, None], y[:, o + 3 * j:o + 6 * j].reshape(n, j, 3))
    moved = state.joint_pos + vel
    joint_pos = moved + JOINT_SMOOTH * (world - moved)
    q_root = quat.about_y(torch.atan2(d[:, 0], d[:, 1]))
    q_glob = quat.multiply(q_root[:, None], quat_exp(
        y[:, o + 6 * j:o + 9 * j].reshape(n, j, 3)))
    par = consts.constant(tuple(parents[1:]), torch.long, dev)
    q_loc = torch.cat([q_glob[:, :1], quat.multiply(
        quat.conjugate(q_glob[:, par]), q_glob[:, 1:])], 1)
    frame = torch.cat([joint_pos[:, 0], q_loc.reshape(n, 4 * j)], 1)

    s = torch.clamp(1.0 - gait[:, CURRENT, 0], min=0.0) ** 0.25
    new_root = root + s[:, None] * _rotate_xz(d, y[:, 0:2])
    new_d = _turn(d, -s * y[:, 2])
    lo, hi, m = _future_tables(dt, dev)
    pts = y[:, 8:32].reshape(n, 4, 6).transpose(1, 2)  # [N, 6, (px pz dx dz)]
    fut = pts[:, lo] + m[:, None] * (pts[:, hi] - pts[:, lo])  # [N, 59, 4]
    fut_pos = _rotate_xz(new_d[:, None], fut[..., 0:2]) + new_root[:, None]
    fut_dir = _rotate_xz(new_d[:, None], fut[..., 2:4])
    fut_dir = fut_dir / torch.clamp(torch.linalg.vector_norm(
        fut_dir, dim=-1, keepdim=True), min=1e-8)
    cur = slice(CURRENT, CURRENT + 1)
    new = HoldenState(
        traj_pos=torch.cat([pos[:, 1:CURRENT + 1], new_root[:, None],
                            fut_pos], 1),
        traj_dir=torch.cat([dirs[:, 1:CURRENT + 1], new_d[:, None], fut_dir],
                           1),
        traj_gait=torch.cat([gait[:, 1:CURRENT + 1], gait[:, cur],
                             gait[:, CURRENT + 1:]], 1),
        joint_pos=joint_pos, joint_vel=vel,
        phase=torch.remainder(state.phase + (0.9 * s + 0.1) * y[:, 3], 1.0))
    return new, frame


def holden_step(model: PFNN, state: HoldenState, target_dir: torch.Tensor,
                target_vel: torch.Tensor, parents: tuple, bias: float):
    """One frame of N characters: (the next state, the network's output y
    [N, Y], the frame [N, 3 + 4 J]).  target_dir [N, 2], target_vel [N, 2]
    (cm per frame): the desired facing and velocity; bias: the blend's
    exponent (the planner's pfnn_blend_bias)."""
    with profiling.span("pfnn.encode", ranged=False):
        state = blend_trajectory(state, target_dir, target_vel, bias)
        x = holden_input(state)
    with profiling.span("pfnn.net", ranged=False):
        y = forward_crowd(model, x, state.phase)
    with profiling.span("pfnn.decode", ranged=False):
        new, frame = holden_update(state, y, parents)
    return new, y, frame


@dataclasses.dataclass
class _Trajectory:
    blend_bias: float = 0.5


class HoldenWrapper:
    """Holden's controller at N = 1 with the surface MGStatePlanner drives
    (`reset`, `get_next_frame`; the planner sets `controller.traj.
    blend_bias`): the same `holden_step` as the crowd, its state on the
    model's device.  gait: one of GAITS; speed: cm/s."""

    def __init__(self, model: PFNN, skeleton=None, gait: str = "walk",
                 speed: float = 150.0, blend_bias: float = 0.5):
        self.model = model
        self.skeleton = skeleton or holden_skeleton()
        holden_joints(model.x_mean.shape[0], model.y_mean.shape[0])
        self.parents = tuple(self.skeleton.parents)
        self.gait, self.speed = GAITS.index(gait), float(speed)
        self.traj = _Trajectory(blend_bias)
        self.controller = self
        self.state = None

    def _tensor(self, values):
        return torch.as_tensor(np.asarray(values, np.float32),
                               device=self.model.w0.device)

    def reset(self, position, phase, direction):
        position = np.asarray(position, np.float64)
        direction = np.asarray(direction, np.float64)
        gait = np.zeros(len(GAITS))
        gait[self.gait] = 1.0
        self.state = holden_initial_state(
            self._tensor([[position[0], position[2]]]),
            self._tensor([[direction[0], direction[2]]]),
            self._tensor([gait]), self._tensor([float(phase) % 1.0]),
            self._tensor(rest_positions(self.skeleton)))

    def get_next_frame(self, target_dir) -> np.ndarray:
        """One frame toward the ground direction target_dir (x, y, z)."""
        t = np.asarray(target_dir, np.float64)[[0, 2]]
        t = t / max(float(np.linalg.norm(t)), 1e-12)
        d = self._tensor([t])
        self.state, _, frame = holden_step(
            self.model, self.state, d, d * (self.speed / FPS), self.parents,
            self.traj.blend_bias)
        return frame[0].cpu().numpy()
