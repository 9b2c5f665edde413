"""Batched ADMM QP solver (OSQP-style splitting), float32-robust
(counterpart of ``quadruped_control_tpu/solver/admm.py``).

Companion to solver/ipm.py. The interior-point method is quadratically
convergent but its condensed barrier system grows ill-conditioned as the
barrier sharpens — in float32 a tail of instances stalls. ADMM splitting
has the opposite trade: linear convergence but a FIXED, well-conditioned
linear system

    P = Q + sigma I + rho G^T G

factored once per instance and reused for every iteration — each iteration
is two matvecs, a clip, and a multiplier update, with no data-dependent
control flow. Plain PyTorch: the JAX version runs no Pallas kernel.

Problem form matches ops/dynamics.py and solver/ipm.py:

    min_x 1/2 x^T Q x + c^T x   s.t.   G x <= h

Reference for the algorithm: Stellato et al., "OSQP: An Operator Splitting
Solver for Quadratic Programs" (2020).
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch.solver.ipm import (
    IPMSolution,
    _cholesky_nan,
    _cholesky_solve,
    _polish,
    equilibrate,
)


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, y):
    return torch.einsum("...ji,...j->...i", A, y)


def solve_qp_admm(Q, c, G, h, iterations: int = 120, tol: float = 1e-7,
                  rho: float = 1.0, sigma: float = 1e-6, alpha: float = 1.6,
                  polish: bool = True, scale: bool = True) -> IPMSolution:
    """Solve a batch of QPs by ADMM splitting.

    Args:
      Q, c, G, h: batched problem data (see solve_qp_ipm).
      iterations: fixed ADMM iteration count.
      rho: step/penalty parameter (on the equilibrated problem; the
        constraint rows are unit-norm after scaling so one global rho works).
      sigma: x-regularization.
      alpha: over-relaxation (1.6 is the OSQP default).
      polish: run the active-set polish afterwards (shared with the IPM).
      scale: equilibrate first (strongly recommended; required for f32).

    Returns:
      IPMSolution (same container as the IPM path; ``s`` is the constraint
      slack h - Gx clipped at 0).
    """
    if scale:
        Q0, c0, G0, h0 = Q, c, G, h
        Q, c, G, h, Dv, Er, nu = equilibrate(Q, c, G, h)
    dtype, device = Q.dtype, Q.device
    m = G.shape[-2]
    n = Q.shape[-1]

    P = (Q + sigma * torch.eye(n, dtype=dtype, device=device)
         + rho * torch.einsum("...ki,...kj->...ij", G, G))
    # A non-PD P gives a NaN factor, as jnp.linalg.cholesky does.
    L = _cholesky_nan(P)

    x = torch.zeros_like(c)
    y = torch.zeros(h.shape, dtype=dtype, device=device)  # slack var Gx
    lam = torch.zeros_like(y)
    for _ in range(iterations):
        rhs = sigma * x - c + _mtv(G, rho * y - lam)
        x_t = _cholesky_solve(L, rhs)
        Gx_t = _mv(G, x_t)

        x_new = alpha * x_t + (1.0 - alpha) * x
        y_relax = alpha * Gx_t + (1.0 - alpha) * y
        y_new = torch.minimum(y_relax + lam / rho, h)  # onto {y <= h}
        lam = lam + rho * (y_relax - y_new)
        x, y = x_new, y_new
    z = torch.clamp(lam, min=0.0)
    s = torch.clamp(h - _mv(G, x), min=0.0)

    certified = None
    if polish:
        # Reuse the shared polish; ADMM's multiplier directly flags activity.
        x, z, s, certified = _polish(Q, c, G, h, x, z, s)

    if scale:
        x = x * Dv
        z = z * Er / nu[..., None]
        s = s / Er
        Q, c, G, h = Q0, c0, G0, h0

    r_dual = _mv(Q, x) + c + _mtv(G, z)
    r_prim = torch.clamp(_mv(G, x) - h, min=0.0)
    gap = torch.abs(torch.sum(s * z, dim=-1)) / m
    obj_scale = 1.0 + torch.amax(torch.abs(c), dim=-1)
    h_scale = 1.0 + torch.amax(torch.abs(h), dim=-1)
    pr = torch.amax(r_prim, dim=-1)
    dr = torch.amax(torch.abs(r_dual), dim=-1)
    converged = (pr < tol * h_scale) & (dr < tol * obj_scale) & \
                (gap < tol * obj_scale)
    if certified is not None:
        converged = converged | certified

    return IPMSolution(
        x=x, z=z, s=s, iterations=torch.as_tensor(iterations),
        gap=gap, primal_residual=pr, dual_residual=dr, converged=converged,
    )
