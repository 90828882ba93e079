"""Inverse kinematics over a batch of frames (port of
morphablegraphs_tpu.ops.ik, `solve_ik`): damped Gauss-Newton over
per-joint rotation deltas in the exponential map.

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
