"""Inverse kinematics on one frame (port of morphablegraphs_tpu.ops.ik,
`solve_ik`): damped Gauss-Newton over per-joint rotation deltas in the
exponential map, with the exact jacobian from `torch.func.jacfwd`.

The constraint layout is padded to MAX_IK_CONSTRAINTS masked slots, as in
the JAX package.  The [3J, 3J] normal equations are solved with
`torch.linalg.solve`, as the JAX package solves them with
`jnp.linalg.solve` outside any kernel."""

from __future__ import annotations

import torch

from ..models.skeleton import Skeleton, fk_global
from . import quat

MAX_IK_CONSTRAINTS = 4


def _apply_deltas(skel: Skeleton, frame: torch.Tensor, deltas: torch.Tensor,
                  joint_mask: torch.Tensor) -> torch.Tensor:
    """frame' with q_j <- exp(delta_j) * q_j for joints with joint_mask 1.
    deltas [J, 3] rotation vectors.  The quaternion exponential is written
    with sinc so its jacobian stays finite at delta = 0."""
    j = skel.n_animated
    quats = frame[3:].reshape(j, 4)
    half = deltas * 0.5
    angle = torch.sqrt(torch.sum(half * half, dim=-1, keepdim=True) + 1e-16)
    dq = torch.cat([torch.cos(angle), half * torch.sinc(angle / torch.pi)],
                   dim=-1)
    new_quats = torch.where(joint_mask[:, None] > 0,
                            quat.multiply(dq, quats), quats)
    return torch.cat([frame[:3], new_quats.reshape(-1)])


def solve_ik(skel: Skeleton, frame: torch.Tensor,
             target_nodes: torch.Tensor, target_positions: torch.Tensor,
             constraint_mask: torch.Tensor, joint_mask: torch.Tensor = None,
             n_iters: int = 10, damping: float = 0.5,
             prior_weight: float = 0.3,
             target_offsets: torch.Tensor = None) -> torch.Tensor:
    """Damped least-squares IK on one frame [D]: target_nodes [C] node
    indices, target_positions [C, 3], constraint_mask [C] 0/1, joint_mask
    [J] the joints that may move (default all), target_offsets [C, 3]
    local offsets in each constrained node's frame (the target then applies
    to pos + R_node @ offset).  n_iters Gauss-Newton steps from deltas of
    0.02 (a zero start stalls at singular poses), each minimizing
    |r|^2 + prior_weight |deltas|^2 under damping.  Returns the edited
    frame [D]."""
    j = skel.n_animated
    if joint_mask is None:
        joint_mask = torch.ones(j, dtype=frame.dtype, device=frame.device)
    if target_offsets is None:
        target_offsets = torch.zeros_like(target_positions)
    target_nodes = target_nodes.long()

    def residuals(deltas):
        f = _apply_deltas(skel, frame, deltas.reshape(j, 3), joint_mask)
        pos, ori = fk_global(skel, f)
        tip = pos[target_nodes] + quat.rotate_vec(
            quat.normalize(ori[target_nodes]), target_offsets)
        return ((tip - target_positions)
                * constraint_mask[:, None]).reshape(-1)

    eye = torch.eye(3 * j, dtype=frame.dtype, device=frame.device)
    deltas = torch.full((3 * j,), 0.02, dtype=frame.dtype,
                        device=frame.device)
    # the residuals ride along as jacfwd's aux output: one FK pass a step
    jac_fn = torch.func.jacfwd(lambda d: (residuals(d),) * 2, has_aux=True)
    for _ in range(n_iters):
        jac, r = jac_fn(deltas)  # [3C, 3J], [3C]
        a = jac.T @ jac + (damping + prior_weight) * eye
        g = jac.T @ r + prior_weight * deltas
        deltas = deltas - torch.linalg.solve(a, g)
    return _apply_deltas(skel, frame, deltas.reshape(j, 3), joint_mask)
