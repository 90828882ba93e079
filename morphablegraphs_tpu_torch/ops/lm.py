"""Fixed-iteration Levenberg-Marquardt over a crowd (port of
morphablegraphs_tpu.ops.lm).

Damped normal equations with Marquardt diagonal scaling and a relative
damping floor, solved for the whole crowd at once, then a trust-region
clip on the step norm.  The step block runs either as JtJ/Jtr products
with kernel B2 (`kernels.chol_solve`) for the solve, or, with
fused_step=True (the JAX package's MG_LM_PALLAS_DELTA=1 route), as the one
fused kernel B4 (`kernels.lm_delta`)."""

from __future__ import annotations

import torch

from . import kernels

DAMP_FLOOR_REL = kernels.DAMP_FLOOR_REL


def lm_delta(j: torch.Tensor, r: torch.Tensor, lam: torch.Tensor,
             radius: torch.Tensor, fused: bool = False) -> torch.Tensor:
    """Damped, trust-clipped LM step of every character: j [C, R, L],
    r [C, R], lam/radius [C] -> delta [C, L].  fused=True runs the whole
    block as kernel B4; otherwise the solve goes through kernel B2."""
    if fused:
        return kernels.lm_delta(j, r, lam, radius)
    return kernels.lm_delta_block(j, r, lam, radius, kernels.chol_solve)


def linearize(fn, s: torch.Tensor):
    """(fn(s) [C, R], J [C, R, L]) for a residual function whose
    characters are independent: forward mode, one tangent per latent dim
    with the unit vector broadcast over the crowd (torch.func.jvp under
    torch.func.vmap), so no [C, R, C, L] jacobian is ever formed."""
    c, n_lat = s.shape
    eye = torch.eye(n_lat, dtype=s.dtype, device=s.device)[:, None, :]

    def column(t):
        return torch.func.jvp(fn, (s,), (t.expand(c, n_lat),))

    r, cols = torch.func.vmap(column, out_dims=(None, 0))(eye)
    return r, cols.permute(1, 2, 0)


def lm_minimize(residual_fn, s0: torch.Tensor, n_iters: int,
                init_lambda: float = 1e-3, init_radius: float = 1.0,
                max_radius: float = 16.0, make_residual_fn=None,
                make_value_jac_fn=None, lam_down: float = 0.1,
                lam_up: float = 10.0, fused_step: bool = False):
    """Minimize sum(r(s)^2) per character from s0 [C, L].

    Exactly one of the three residual forms is given:
    residual_fn(s [C, L]) -> r [C, R], differentiated exactly by
    `linearize` (the exact LM); make_residual_fn(s) -> such a function,
    built anew at every iterate (the frozen linearize form);
    make_value_jac_fn(s) -> (r, J [C, R, L], value_fn), the residuals and
    jacobian in one pass plus a value-only probe (the closed frozen form).
    An improving step multiplies lambda by lam_down (floor 1e-6) and
    doubles the trust radius (cap max_radius); a rejected one multiplies
    lambda by lam_up and keeps the radius.  Returns (s_opt [C, L], the last
    iteration's min(err, err_new) [C])."""
    n_modes = sum(fn is not None for fn in (residual_fn, make_residual_fn,
                                            make_value_jac_fn))
    if n_modes != 1:
        raise ValueError("pass exactly one of residual_fn / "
                         "make_residual_fn / make_value_jac_fn")
    c = s0.shape[0]
    s = s0
    lam = torch.full((c,), init_lambda, dtype=s0.dtype, device=s0.device)
    radius = torch.full((c,), init_radius, dtype=s0.dtype, device=s0.device)
    last = torch.zeros((c,), dtype=s0.dtype, device=s0.device)
    for _ in range(n_iters):
        if make_value_jac_fn is not None:
            r, j, value_fn = make_value_jac_fn(s)
        else:
            value_fn = (residual_fn if make_residual_fn is None
                        else make_residual_fn(s))
            r, j = linearize(value_fn, s)
        err = torch.sum(r * r, dim=-1)
        s_new = s - lm_delta(j, r, lam, radius, fused=fused_step)
        r_new = value_fn(s_new)
        err_new = torch.sum(r_new * r_new, dim=-1)
        improved = err_new < err
        s = torch.where(improved[:, None], s_new, s)
        lam = torch.where(improved, torch.clamp(lam * lam_down, min=1e-6),
                          lam * lam_up)
        radius = torch.where(improved,
                             torch.clamp(radius * 2.0, max=max_radius),
                             radius)
        last = torch.minimum(err, err_new)
    return s, last
