"""Inverse kinematics over a batch of frames (port of
morphablegraphs_tpu.ops.ik): damped Gauss-Newton over per-joint rotation
deltas in the exponential map (`solve_ik`), cyclic coordinate descent
along a chain (`run_ccd`), a single-joint look-at edit (`look_at`) and
the swing-twist joint-limit clamp (`apply_joint_limits`).  The JAX
package edits one frame and vmaps the edit over frame ranges; every
function here takes the frames [F, D] at once.

The JAX package solves one frame, takes its exact jacobian with
`jax.jacfwd` and vmaps the solve over frame ranges (grounding, the
trajectory IK pass); here `solve_ik_frames` takes the frames [F, D] at
once, and the jacobian [F, 3C, 3J] is written out in closed form
(`_linearize`): a joint's delta turns every orientation below it by one
left factor, so each constraint's column is a suffix sum along its chain.
That is a few dozen tensor ops a step where forward mode through the
level-batched FK costs thousands of launches; it agrees with forward mode
to float32 rounding (tests/test_torch_grounding.py).  One batched
`torch.linalg.solve` of the [F, 3J, 3J] normal equations a step, as the
JAX package solves them with `jnp.linalg.solve` outside any kernel.  The
normal equations are formed and solved in float64 (the jacobian and the
frames stay float32): on the synthetic models' non-unit quaternions the
jacobian reaches ~1e4, J^T J ~1e8 swamps the 0.8 damping in float32, and
LU then meets an exact zero pivot (the JAX package's float32 solve
returns inf/NaN there).  `solve_ik` is its one-frame call.  The
constraint layout is padded to MAX_IK_CONSTRAINTS masked slots, as in
the JAX package."""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.skeleton import Skeleton, _chain_tables, fk_global
from . import quat

MAX_IK_CONSTRAINTS = 4


def _delta_quat(deltas: torch.Tensor):
    """exp(deltas / 2) [..., 4] of rotation vectors [..., 3], written with
    sinc so its jacobian stays finite at 0, and its derivative [..., 3, 4]
    by each component of the delta."""
    half = deltas * 0.5
    angle = torch.sqrt(torch.sum(half * half, dim=-1, keepdim=True) + 1e-16)
    sin, cos = torch.sin(angle), torch.cos(angle)
    sinc = torch.sinc(angle / torch.pi)
    d_angle = half / (2.0 * angle)  # [..., 3]
    d_sinc = (angle * cos - sin) / (angle * angle)
    eye = torch.eye(3, dtype=deltas.dtype, device=deltas.device)
    d_vec = (0.5 * sinc[..., None] * eye
             + d_angle[..., :, None] * d_sinc[..., None] * half[..., None, :])
    dq = torch.cat([cos, half * sinc], dim=-1)
    return dq, torch.cat([-(sin * d_angle)[..., None], d_vec], dim=-1)


def _apply_deltas(skel: Skeleton, frames: torch.Tensor, deltas: torch.Tensor,
                  joint_mask: torch.Tensor) -> torch.Tensor:
    """frames' [..., D] with q_j <- exp(delta_j / 2) * q_j for joints with
    joint_mask 1; deltas [..., J, 3] rotation vectors."""
    j = skel.n_animated
    lead = frames.shape[:-1]
    quats = frames[..., 3:].reshape(lead + (j, 4))
    dq, _ = _delta_quat(deltas)
    new_quats = torch.where(joint_mask[:, None] > 0,
                            quat.multiply(dq, quats), quats)
    return torch.cat([frames[..., :3], new_quats.reshape(lead + (4 * j,))],
                     dim=-1)


@functools.lru_cache(maxsize=None)
def _ik_tables(skel: Skeleton, device: torch.device):
    """Per node n: its ancestor chain root first, -1-padded [N, P]; the
    offset of the chain's next node at each position, 0 from n on
    [N, P, 3]; its depth [N]; and whether each animated joint lies on the
    chain [N, J].  Per animated joint: its node's depth [J] and parent
    [J]."""
    chain, _ = _chain_tables(skel)
    chain = chain.astype(np.int64)
    depth = (chain >= 0).sum(1) - 1
    nxt = np.concatenate([chain[:, 1:], np.full((len(chain), 1), -1)], 1)
    child_off = np.where((nxt >= 0)[..., None],
                         skel.offsets[np.maximum(nxt, 0)], 0.0)
    joints = np.array([skel.index_of(n) for n in skel.animated_joints])
    on_chain = (chain[:, :, None] == joints).any(1)

    def t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=device)
    return (t(chain), t(child_off, torch.float32), t(depth),
            t(on_chain, torch.float32), t(depth[joints]),
            t(np.asarray(skel.parents)[joints]))


def _rotate_vec_jacobian(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """d quat.rotate_vec(q, v) / d q [..., 3, 4] (q need not be unit)."""
    u, w = q[..., 1:], q[..., :1]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    e_v = quat._cross(eye, v[..., None, :])  # [..., k, 3]: e_k x v
    uv = quat._cross(u, v)
    d_u = 2.0 * (w[..., None] * e_v
                 + quat._cross(eye, uv[..., None, :])
                 + quat._cross(u[..., None, :], e_v))
    return torch.cat([2.0 * uv[..., :, None], d_u.transpose(-1, -2)],
                     dim=-1)


def _right_product(o: torch.Tensor) -> torch.Tensor:
    """The matrix [..., 4, 4] of a -> quat.multiply(a, o)."""
    eye = torch.eye(4, dtype=o.dtype, device=o.device)
    return quat.multiply(eye, o[..., None, :]).transpose(-1, -2)


def _inverse(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1) / torch.sum(
        q * q, dim=-1, keepdim=True)


def _linearize(skel: Skeleton, frames: torch.Tensor, deltas: torch.Tensor,
               joint_mask: torch.Tensor, nodes: torch.Tensor,
               targets: torch.Tensor, offsets: torch.Tensor,
               mask: torch.Tensor):
    """The residuals [F, 3C] of deltas [F, 3J] and their jacobian
    [F, 3C, 3J] in closed form.  A joint a's delta turns every orientation
    below it by one left factor W_a = A dq' dq^-1 A^-1 (A its parent's
    orientation, dq its delta quaternion, dq' that one's derivative), so
    d ori_k = W_a ori_k for each node k under a, and a constraint's tip
    moves by the sum, over the chain positions from a's node down, of
    d rotate_vec(ori_k, next offset) / d ori_k (the tip offset's term at
    the constrained node itself) applied to W_a ori_k: a suffix sum along
    the chain."""
    f, j = frames.shape[0], skel.n_animated
    chain, child_off, depth, on_chain, joint_depth, parent = _ik_tables(
        skel, frames.device)
    d3 = deltas.reshape(f, j, 3)
    dq, d_dq = _delta_quat(d3)
    pos, ori = fk_global(skel, _apply_deltas(skel, frames, d3, joint_mask))
    rows = torch.arange(f, device=frames.device)[:, None]
    ori_n = ori[rows, nodes]  # [F, C, 4]
    norm = torch.clamp(torch.linalg.vector_norm(ori_n, dim=-1,
                                                keepdim=True), min=1e-12)
    unit = ori_n / norm
    tip = pos[rows, nodes] + quat.rotate_vec(unit, offsets)
    r = ((tip - targets) * mask[..., None]).reshape(f, -1)

    ori_chain = ori[rows[..., None], chain[nodes].clamp(min=0)]  # [F,C,P,4]
    terms = _rotate_vec_jacobian(ori_chain, child_off[nodes]) \
        @ _right_product(ori_chain)  # [F, C, P, 3, 4]
    d_unit = (torch.eye(4, dtype=frames.dtype, device=frames.device)
              - unit[..., :, None] * unit[..., None, :]) / norm[..., None]
    tip_term = _rotate_vec_jacobian(unit, offsets) @ d_unit \
        @ _right_product(ori_n)  # [F, C, 3, 4]
    at_node = (torch.arange(chain.shape[1], device=frames.device)
               == depth[nodes][..., None]).to(frames.dtype)  # [F, C, P]
    terms = terms + at_node[..., None, None] * tip_term[:, :, None]
    suffix = torch.flip(torch.cumsum(torch.flip(terms, [2]), 2), [2])

    identity = torch.eye(4, dtype=frames.dtype, device=frames.device)[0]
    a_q = torch.where((parent >= 0)[:, None], ori[:, parent.clamp(min=0)],
                      identity)  # [F, J, 4]: the root's parent is identity
    w = quat.multiply(quat.multiply(quat.multiply(
        a_q[:, :, None], d_dq), _inverse(dq)[:, :, None]),
        _inverse(a_q)[:, :, None])  # [F, J, 3, 4]
    w = w * joint_mask[:, None, None]
    jac = torch.einsum("fcaxq,faeq->fcxae", suffix[:, :, joint_depth], w)
    jac = jac * (on_chain[nodes] * mask[..., None])[:, :, None, :, None]
    return r, jac.reshape(f, r.shape[1], 3 * j)


def solve_ik_frames(skel: Skeleton, frames: torch.Tensor,
                    target_nodes: torch.Tensor,
                    target_positions: torch.Tensor,
                    constraint_mask: torch.Tensor,
                    joint_mask: torch.Tensor = None, n_iters: int = 10,
                    damping: float = 0.5, prior_weight: float = 0.3,
                    target_offsets: torch.Tensor = None) -> torch.Tensor:
    """Damped least-squares IK on each frame of frames [F, D], every frame
    its own problem: target_nodes [F, C] node indices, target_positions
    [F, C, 3], constraint_mask [F, C] 0/1, joint_mask [J] the joints that
    may move (default all), target_offsets [F, C, 3] local offsets in each
    constrained node's frame (the target then applies to pos + R_node @
    offset).  n_iters Gauss-Newton steps from deltas of 0.02 (a zero start
    stalls at singular poses), each minimizing |r|^2 + prior_weight
    |deltas|^2 under damping.  Returns the edited frames [F, D]."""
    j = skel.n_animated
    f = frames.shape[0]
    if joint_mask is None:
        joint_mask = torch.ones(j, dtype=frames.dtype, device=frames.device)
    if target_offsets is None:
        target_offsets = torch.zeros_like(target_positions)
    target_nodes = target_nodes.long()
    eye = torch.eye(3 * j, dtype=torch.float64, device=frames.device)
    deltas = torch.full((f, 3 * j), 0.02, dtype=frames.dtype,
                        device=frames.device)
    for _ in range(n_iters):
        r, jac = _linearize(skel, frames, deltas, joint_mask, target_nodes,
                            target_positions, target_offsets,
                            constraint_mask)  # [F, 3C], [F, 3C, 3J]
        jac, r = jac.double(), r.double()
        jt = jac.transpose(1, 2)
        a = jt @ jac + (damping + prior_weight) * eye
        g = (jt @ r[..., None])[..., 0] + prior_weight * deltas.double()
        deltas = deltas - torch.linalg.solve(a, g).to(frames.dtype)
    return _apply_deltas(skel, frames, deltas.reshape(f, j, 3), joint_mask)


def solve_ik(skel: Skeleton, frame: torch.Tensor,
             target_nodes: torch.Tensor, target_positions: torch.Tensor,
             constraint_mask: torch.Tensor, joint_mask: torch.Tensor = None,
             n_iters: int = 10, damping: float = 0.5,
             prior_weight: float = 0.3,
             target_offsets: torch.Tensor = None) -> torch.Tensor:
    """`solve_ik_frames` on one frame [D]: target_nodes [C],
    target_positions [C, 3], constraint_mask [C], target_offsets [C, 3]
    -> the edited frame [D]."""
    return solve_ik_frames(
        skel, frame[None], target_nodes[None], target_positions[None],
        constraint_mask[None], joint_mask, n_iters, damping, prior_weight,
        None if target_offsets is None else target_offsets[None])[0]


def _rotate_joint_toward(skel: Skeleton, frames: torch.Tensor,
                         ori: torch.Tensor, joint_idx: int, node_idx: int,
                         v_from: torch.Tensor,
                         v_to: torch.Tensor) -> torch.Tensor:
    """Pre-multiply animated joint `joint_idx`'s local quaternion of each
    frame [F, D] with the world rotation aligning v_from [F, 3] onto v_to
    [F, 3], taken into the joint's parent frame: q_local' = q_p^-1 q_world
    q_p q_local (ori [F, N, 4]: the frames' global orientations).  The
    shared core of CCD and look-at."""
    v1 = v_from / torch.clamp(torch.linalg.vector_norm(
        v_from, dim=-1, keepdim=True), min=1e-10)
    v2 = v_to / torch.clamp(torch.linalg.vector_norm(
        v_to, dim=-1, keepdim=True), min=1e-10)
    axis = quat._cross(v1, v2)
    s = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)
    # + 0.0 turns a -0.0 sum into +0.0: a chain's first joint is the
    # effector itself (v_from = 0), where atan2(0, -0.0) = pi would turn
    # its quaternion into its negative (the same rotation; the JAX
    # package's dot gives either sign of zero there)
    c = torch.sum(v1 * v2, dim=-1, keepdim=True) + 0.0
    half = torch.atan2(s, c) * 0.5
    axis = axis / torch.clamp(s, min=1e-10)
    q_world = torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)
    parent = skel.parents[node_idx]
    if parent >= 0:
        p_ori = ori[:, parent]
    else:
        p_ori = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=frames.dtype,
                             device=frames.device).expand_as(q_world)
    q_rel = quat.multiply(quat.conjugate(p_ori),
                          quat.multiply(q_world, p_ori))
    sl = 3 + 4 * joint_idx
    q_new = quat.normalize(quat.multiply(q_rel, frames[:, sl: sl + 4]))
    return torch.cat([frames[:, :sl], q_new, frames[:, sl + 4:]], dim=-1)


def _frames_and_targets(frames: torch.Tensor, target: torch.Tensor):
    """(frames [F, D], target [F, 3], whether one frame [D] came in)."""
    single = frames.dim() == 1
    frames = frames[None] if single else frames
    target = target.to(frames.dtype)
    if target.dim() == 1:
        target = target.expand(frames.shape[0], 3)
    return frames, target, single


def run_ccd(skel: Skeleton, chain: tuple, effector_node: int,
            frames: torch.Tensor, target: torch.Tensor,
            n_iters: int = 5) -> torch.Tensor:
    """Cyclic coordinate descent (anim_utils run_ccd semantics): `chain`
    holds animated-joint indices child -> root; each of n_iters passes
    turns every chain joint so the effector node points at the target.
    frames [F, D] (or one frame [D]) with a target each [F, 3] (or one
    [3] for all); one FK of the frames per chain joint and pass."""
    f, t, single = _frames_and_targets(frames, target)
    for _ in range(n_iters):
        for joint_idx in chain:
            pos, ori = fk_global(skel, f)
            node_idx = skel.index_of(skel.animated_joints[joint_idx])
            pivot = pos[:, node_idx]
            f = _rotate_joint_toward(skel, f, ori, joint_idx, node_idx,
                                     pos[:, effector_node] - pivot,
                                     t - pivot)
    return f[0] if single else f


def look_at(skel: Skeleton, head_joint_idx: int, frames: torch.Tensor,
            target: torch.Tensor, local_dir=(0.0, 0.0, 1.0)) -> torch.Tensor:
    """Turn animated joint head_joint_idx of each frame [F, D] (or [D]) so
    its local `local_dir` points at the target [3] or [F, 3] (anim_utils
    edit_motion_to_look_at_target's core edit)."""
    f, t, single = _frames_and_targets(frames, target)
    pos, ori = fk_global(skel, f)
    node_idx = skel.index_of(skel.animated_joints[head_joint_idx])
    cur_dir = quat.rotate_vec(ori[:, node_idx], torch.tensor(
        local_dir, dtype=f.dtype, device=f.device).expand(f.shape[0], 3))
    f = _rotate_joint_toward(skel, f, ori, head_joint_idx, node_idx,
                             cur_dir, t - pos[:, node_idx])
    return f[0] if single else f


def apply_joint_limits(frames: torch.Tensor, axes: torch.Tensor,
                       mins: torch.Tensor, maxs: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Clamp each constrained joint's twist about its limit axis, every
    frame and joint in one closed-form swing-twist pass (the reference's
    apply_joint_constraints after its look-at and spine edits).

    frames [..., 3 + 4J]; axes [J, 3] unit limit axes in each joint's
    local frame; mins, maxs [J] twist bounds in radians; mask [J] 1 where
    the joint is constrained.  With q canonicalized to w >= 0,
    q = swing x twist, twist = [cos(t/2), sin(t/2) a],
    t = 2 atan2(<q_xyz, a>, q_w); the swing is kept and t is clipped.  A
    joint that is unmasked or whose twist is inside its range keeps its
    input values bit for bit."""
    lead = frames.shape[:-1]
    j = axes.shape[0]
    quats = frames[..., 3:].reshape(lead + (j, 4))
    q = torch.where(quats[..., :1] < 0, -quats, quats)
    p = torch.sum(q[..., 1:] * axes, dim=-1)
    theta = 2.0 * torch.atan2(p, q[..., 0])

    def twist_of(t):
        half = t * 0.5
        return torch.cat([torch.cos(half)[..., None],
                          torch.sin(half)[..., None] * axes], dim=-1)

    swing = quat.multiply(q, quat.conjugate(twist_of(theta)))
    theta_c = torch.minimum(torch.maximum(theta, mins), maxs)
    clamped = quat.multiply(swing, twist_of(theta_c))
    active = (mask > 0) & (theta_c != theta)
    out = torch.where(active[..., None], clamped, quats)
    return torch.cat([frames[..., :3], out.reshape(lead + (4 * j,))],
                     dim=-1)
