"""Global refinement of a walk's last steps (port of
morphablegraphs_tpu.synthesis.global_opt): a joint spatial LM over a window
of steps with the alignment chained from step to step, and the time
optimization that moves keyframes onto their desired output times.

Both take the naturalness term -log p(s) of every step in the window from
kernel B5 through `kernels.gmm_nll` (its plain twin on the CPU): one launch
per residual evaluation when the window's mixtures stack (the same number
of components and dimensions; `mix_id = arange(W)`), else one per step.
Both solve their damped normal equations with `torch.linalg.solve`, as the
JAX package solves them with `jnp.linalg.solve` outside any kernel, but
form and solve them in float64 (the residuals and the jacobian stay
float32): at the default position weight of 1000 the spatial system's
condition number reaches ~1e11, past float32's precision, so the JAX
package's float32 steps there are rounding noise.  Both run on the CUDA
device unless the caller passes device="cpu".

Constraint sets are the ones the request path stores with its steps
(tensors with a leading [1] axis, `generator.device_constraints`); a
host-side set (numpy leaves) is moved to the device first."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..constraints import compiled
from ..models.primitive import MotionPrimitive, back_project_spatial
from ..models.skeleton import Skeleton
from ..ops import align, kernels, timewarp
from ..utils import device as device_mod
from ..utils import profiling
from . import generator


def _device_set(sc: compiled.StepConstraints,
                dev: torch.device) -> compiled.StepConstraints:
    """A stored set on dev, or a host-side set moved there with its [1]
    axis."""
    if torch.is_tensor(sc.kf_active):
        return sc
    return generator.device_constraints(sc, dev)


class _WindowNll:
    """-log p of the window's full latents, rows [W, L] -> [W]: one B5
    launch over the stacked mixtures, or one per step when their shapes
    differ."""

    def __init__(self, prims: List[MotionPrimitive]):
        gmms = [p.gmm for p in prims]
        dev = gmms[0].means.device
        self.stacked = len({tuple(g.means.shape) for g in gmms}) == 1
        if self.stacked:
            self.args = (torch.stack([g.weights for g in gmms]),
                         torch.stack([g.means for g in gmms]),
                         torch.stack([g.prec_chol for g in gmms]),
                         torch.arange(len(gmms), device=dev))
        else:
            self.args = [(g.weights[None], g.means[None], g.prec_chol[None],
                          torch.zeros(1, dtype=torch.long, device=dev))
                         for g in gmms]

    def __call__(self, rows: List[torch.Tensor]) -> torch.Tensor:
        if self.stacked:
            return kernels.gmm_nll(torch.stack(rows), *self.args)
        return torch.cat([kernels.gmm_nll(r[None], *a)
                          for r, a in zip(rows, self.args)])


def _chain_residuals(skeleton: Skeleton, prims: List[MotionPrimitive],
                     scs: List[compiled.StepConstraints],
                     alphas: List[torch.Tensor], gammas: List[torch.Tensor],
                     quality_scale: float, nll_fn=None) -> torch.Tensor:
    """Residuals [W * N_RESIDUALS] of every step in the window: the first
    step aligns by its stored state (the previous frame or the start
    pose), each later step against the previous step's last aligned
    coefficient row (a clamped spline's last coefficient is its last
    frame).  Each step's active slots carry r + quality_scale * (-log p),
    gated by the default family flags (trajectory and CA on, trajectory
    set off); inactive slots are 0."""
    nll_fn = nll_fn or _WindowNll(prims)
    nll = nll_fn([torch.cat([a, g]) for a, g in zip(alphas, gammas)])
    gate = torch.as_tensor(compiled.static_family_gate(),
                           device=alphas[0].device)
    all_res = []
    prev_last = None
    for i, (prim, sc, alpha) in enumerate(zip(prims, scs, alphas)):
        if i == 0:
            aligned = compiled.aligned_coeffs(prim, alpha[None], sc)
        else:
            coeffs = back_project_spatial(prim, alpha)[None]
            q_y, delta = align.node_aligning_2d_transform(prev_last,
                                                          coeffs[:, 0])
            aligned = align.transform_frames(coeffs, q_y, delta)
        res = compiled.residuals_from_coeffs(skeleton, prim.knots_s, sc,
                                             aligned)
        active = compiled.active_mask(sc) * gate
        all_res.append((active * (res + quality_scale * nll[i]))[0])
        prev_last = aligned[:, -1]
    return torch.cat(all_res)


def adapt_constraint_weights(scs: List[compiled.StepConstraints], mode: str,
                             position_weight: float,
                             orientation_weight: float):
    """Copies of the window's sets with the weights the global
    optimization uses.  "all" / "two_hands": every step's active keyframe
    slots that the walk did not generate (the user's) get position_weight.
    "trajectory_end": the last step alone, every active keyframe slot
    position_weight and the direction slot orientation_weight.  The inputs
    are not changed; numpy and tensor sets alike."""
    def where(cond, val, other):
        if torch.is_tensor(other):
            return torch.where(cond, torch.full_like(other, val), other)
        return np.where(cond, np.float32(val), np.asarray(other, np.float32))

    out = list(scs)
    if mode in ("all", "two_hands"):
        for i, sc in enumerate(out):
            user = (sc.kf_active > 0) & (sc.kf_generated == 0)
            out[i] = sc.replace(kf_weight=where(user, position_weight,
                                                sc.kf_weight))
    else:  # "trajectory_end"
        sc = out[-1]
        dir_w = (torch.full_like(sc.dir_weight, orientation_weight)
                 if torch.is_tensor(sc.dir_weight)
                 else np.float32(orientation_weight))
        out[-1] = sc.replace(kf_weight=where(sc.kf_active > 0,
                                             position_weight, sc.kf_weight),
                             dir_weight=dir_w)
    return out


def _lm(residuals, x0: torch.Tensor, n_iters: int, init_lambda: float):
    """Minimize |residuals(x)|^2 from x0 [n]: the exact jacobian in forward
    mode, the damped normal equations (J^T J + lambda I) solved per step in
    float64, a step kept when it lowers the error (lambda x 0.3, else x 5).
    Returns (x, the last step's error [])."""
    jac_fn = torch.func.jacfwd(lambda x: (residuals(x),) * 2, has_aux=True)
    eye = torch.eye(x0.shape[0], dtype=torch.float64, device=x0.device)
    x = x0
    lam = torch.tensor(init_lambda, dtype=x0.dtype, device=x0.device)
    err_new = torch.zeros((), dtype=x0.dtype, device=x0.device)
    for _ in range(n_iters):
        jac, r = jac_fn(x)
        err = torch.sum(r * r)
        j64 = jac.double()
        step = torch.linalg.solve(j64.T @ j64 + lam.double() * eye,
                                  j64.T @ r.double())
        x_new = x - step.to(x.dtype)
        err_new = torch.sum(residuals(x_new) ** 2)
        improved = err_new < err
        x = torch.where(improved, x_new, x)
        lam = torch.where(improved, lam * 0.3, lam * 5.0)
    return x, err_new


def optimize_spatial_over_steps(skeleton: Skeleton,
                                prims: List[MotionPrimitive],
                                scs: List[compiled.StepConstraints],
                                parameters: List[np.ndarray],
                                n_iters: int = 8,
                                quality_scale: float = 0.0001,
                                init_lambda: float = 1e-2, device=None):
    """Refine the spatial latents of a window of steps jointly: an LM over
    their concatenation against `_chain_residuals`.  parameters: each
    step's full latent [L_i] (numpy).  Returns (updated copies, the last
    iteration's error)."""
    dev = device_mod.resolve(device, "optimize_spatial_over_steps")
    prims = [p.to(dev) for p in prims]
    scs = [_device_set(sc, dev) for sc in scs]
    sizes = [p.n_spatial for p in prims]
    offsets = np.cumsum([0] + sizes)
    params = [torch.as_tensor(np.asarray(p, np.float32), device=dev)
              for p in parameters]
    gammas = [p[n:] for p, n in zip(params, sizes)]
    x0 = torch.cat([p[:n] for p, n in zip(params, sizes)])
    nll_fn = _WindowNll(prims)

    def residuals(x):
        alphas = [x[offsets[i]: offsets[i + 1]] for i in range(len(prims))]
        return _chain_residuals(skeleton, prims, scs, alphas, gammas,
                                quality_scale, nll_fn)

    with profiling.span("request.global_opt"):
        x, err = _lm(residuals, x0, n_iters, init_lambda)
        x = x.cpu().numpy()
    out = []
    for i, p in enumerate(parameters):
        p = np.asarray(p).copy()
        p[: sizes[i]] = x[offsets[i]: offsets[i + 1]]
        out.append(p)
    return out, float(err)


def optimize_time_over_steps(prims: List[MotionPrimitive],
                             parameters: List[np.ndarray],
                             constrained: List[tuple], frame_time: float,
                             n_iters: int = 20,
                             quality_scale: float = 0.0001,
                             start_frames: float = 0.0,
                             device=None):
    """Refine the window's temporal latents so constrained keyframes land
    on their desired output times.  constrained: (step index, canonical
    keyframe, desired seconds).  A keyframe's output time is (start_frames
    + the warped lengths t_can[-2] + 2 of the window's earlier steps + its
    warped position t_can[kf]) * frame_time; the residuals are those time
    errors and sqrt(max(-log p, 0) * quality_scale) per step, minimized by
    the LM from lambda 1e-3.  start_frames: the warped frames of the steps
    before the window, held fixed.  Returns updated copies of
    parameters."""
    dev = device_mod.resolve(device, "optimize_time_over_steps")
    if not constrained:
        return parameters
    prims = [p.to(dev) for p in prims]
    sizes = [p.n_time for p in prims]
    offsets = np.cumsum([0] + sizes)
    params = [torch.as_tensor(np.asarray(p, np.float32), device=dev)
              for p in parameters]
    alphas = [p[: pr.n_spatial] for p, pr in zip(params, prims)]
    g0 = torch.cat([p[pr.n_spatial:] for p, pr in zip(params, prims)])
    nll_fn = _WindowNll(prims)

    def residuals(g):
        gammas = [g[offsets[i]: offsets[i + 1]] for i in range(len(prims))]
        t_cans = [timewarp.canonical_time_function(p.mean_t_d, p.eigen_t_d,
                                                   gm)
                  for p, gm in zip(prims, gammas)]
        # [1] slices, not 0-d entries: forward mode promotes the tangent
        # of a 0-d tensor times a Python float to float64
        lengths = [t[-2:-1] + 2.0 for t in t_cans]
        res = []
        for step_idx, keyframe, desired in constrained:
            prior = sum(lengths[:step_idx]) if step_idx > 0 else 0.0
            kf = int(keyframe)
            warped_pos = t_cans[step_idx][kf: kf + 1]
            res.append((start_frames + prior + warped_pos) * frame_time
                       - desired)
        nll = nll_fn([torch.cat([a, gm]) for a, gm in zip(alphas, gammas)])
        return torch.cat(res + [torch.sqrt(
            torch.clamp(nll, min=0.0) * quality_scale)])

    with profiling.span("request.time_opt"):
        g, _ = _lm(residuals, g0, n_iters, 1e-3)
        g = g.cpu().numpy()
    out = []
    for i, p in enumerate(parameters):
        p = np.asarray(p).copy()
        p[prims[i].n_spatial:] = g[offsets[i]: offsets[i + 1]]
        out.append(p)
    return out
