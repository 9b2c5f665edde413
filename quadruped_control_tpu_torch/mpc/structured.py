"""Structured (sparse multiple-shooting) SRB MPC solver: O(N) Riccati IPM
(counterpart of ``quadruped_control_tpu/mpc/structured.py``).

The condensed path (mpc/horizon.py) materializes the dense (12N)^2 Hessian
H = 2(Bqp^T L Bqp + alpha I) and pays O((12N)^3) per IPM iteration. This
module solves the SAME QP without forming H: the horizon's block-tridiagonal
KKT structure is eliminated by a backward Riccati sweep over the time steps.

Math. The condensed Newton system per Mehrotra iteration is

    (H + G^T D G) dF = rhs,    D = diag(z/s)  (block-diag per step)

which is exactly the LQR problem

    min  sum_{t=1..N} dxi_t^T L dxi_t
       + sum_{t=0..N-1} 1/2 df_t^T R_t df_t - rhs_t^T df_t
    s.t. dxi_{t+1} = A dxi_t + B_t df_t,  dxi_0 = 0,

with R_t = 2 alpha I + G_t^T D_t G_t and state weight 2L, solved by the
classic backward Riccati recursion + forward rollout. H-vector products
(for residuals) are one forward + one backward pass over the horizon.

Everything is batched over instances: the loops carry (B, nx, nx) Riccati
matrices. ``state_weights`` may be a per-call tensor, (13,) or per instance
(..., 13). The solve is plain PyTorch with static trip counts, so autograd
flows through it — to the state weights, the initial state and the
reference (tests/test_torch_grad_mpc.py holds it against ``jax.grad``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch.config import ControlConfig
from quadruped_control_tpu_torch.mpc.horizon import (
    NU,
    NX,
    srb_discrete_dynamics,
    state_weight_tensor,
)
from quadruped_control_tpu_torch.ops.dynamics import cone_constraints
from quadruped_control_tpu_torch.solver.ipm import IPMSolution, _cholesky_nan

_M = 24  # cone rows per step


class MPCStructuredData(NamedTuple):
    """Per-step problem data (never condensed)."""

    A: torch.Tensor        # (..., NX, NX) shared across steps
    B: torch.Tensor        # (..., N, NX, NU) stance-masked per step
    G: torch.Tensor        # (..., N, 24, NU)
    h: torch.Tensor        # (..., N, 24)
    err0: torch.Tensor     # (..., N, NX) free-response error Sqp xi0 - xi_ref
    L: torch.Tensor        # (NX,) or (..., NX) state weights
    alpha: float           # force weight


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _mtv(A, y):
    return torch.einsum("...ji,...j->...i", A, y)


def build_mpc_structured(xi0, xi_ref, yaw, feet_world, x_com,
                         stance_schedule, horizon: int, dt,
                         cfg: ControlConfig, state_weights=None,
                         force_weight: float = 1e-6, mass=None,
                         inertia_diag=None, mu=None) -> MPCStructuredData:
    """Same inputs/semantics as mpc/horizon.build_mpc_qp, but emits per-step
    data. err0 (the free response) is an N-step rollout instead of stacked
    powers of A."""
    dtype, device = xi0.dtype, xi0.device
    L = state_weight_tensor(state_weights, dtype, device)

    A, B = srb_discrete_dynamics(yaw, feet_world, x_com, dt, cfg,
                                 mass=mass, inertia_diag=inertia_diag)
    col_mask = torch.repeat_interleave(stance_schedule.to(dtype), 3, dim=-1)
    # (..., N, NX, NU)
    B_steps = B[..., None, :, :] * col_mask[..., :, None, :]

    xs = []
    x = xi0
    for _ in range(horizon):
        x = _mv(A, x)
        xs.append(x)
    err0 = torch.stack(xs, dim=-2) - xi_ref

    G_steps, h_steps = [], []
    for t in range(horizon):
        Gt, ht = cone_constraints(stance_schedule[..., t, :], mu=mu,
                                  cfg=cfg.balance, dtype=dtype)
        G_steps.append(Gt)
        h_steps.append(ht)
    G = torch.stack(torch.broadcast_tensors(*G_steps), dim=-3)
    h = torch.stack(torch.broadcast_tensors(*h_steps), dim=-2)
    return MPCStructuredData(A=A, B=B_steps, G=G, h=h, err0=err0, L=L,
                             alpha=float(force_weight))


def _forward_map(A, B, F):
    """dxi = Bqp F: forward rollout with zero initial state.

    F: (..., N, NU) -> (..., N, NX) (states at t = 1..N)."""
    N = F.shape[-2]
    x = torch.zeros(torch.broadcast_shapes(F.shape[:-2], A.shape[:-2])
                    + (NX,), dtype=F.dtype, device=F.device)
    xs = []
    for t in range(N):
        x = _mv(A, x) + _mv(B[..., t, :, :], F[..., t, :])
        xs.append(x)
    return torch.stack(xs, dim=-2)


def _adjoint_map(A, B, Y):
    """Bqp^T Y: backward adjoint accumulation.

    Y: (..., N, NX) costates at t = 1..N -> (..., N, NU).
    (Bqp^T Y)_t = B_t^T lam_t, lam_t = y_{t+1} + A^T lam_{t+1}."""
    N = Y.shape[-2]
    lam = torch.zeros_like(Y[..., 0, :])
    outs = [None] * N
    for t in reversed(range(N)):
        lam_t = Y[..., t, :] + lam
        outs[t] = _mtv(B[..., t, :, :], lam_t)
        lam = _mtv(A, lam_t)
    return torch.stack(outs, dim=-2)


def _L_bcast(data: MPCStructuredData):
    """State-weight diagonal broadcast against (..., N, NX) arrays."""
    return data.L[..., None, :]


def _hvp(data: MPCStructuredData, F):
    """H F = 2 (Bqp^T L (Bqp F) + alpha F) without materializing H."""
    dxi = _forward_map(data.A, data.B, F)
    y = _L_bcast(data) * dxi
    return 2.0 * (_adjoint_map(data.A, data.B, y) + data.alpha * F)


def _linear_cost(data: MPCStructuredData):
    """c = 2 Bqp^T L err0."""
    return 2.0 * _adjoint_map(data.A, data.B, _L_bcast(data) * data.err0)


def _riccati_solve(data: MPCStructuredData, Rts, rhs, reg):
    """Solve (H + G^T D G) dF = rhs via backward Riccati + forward rollout.

    Args:
      Rts: (..., N, NU, NU) per-step control Hessians
           R_t = 2 alpha I + G_t^T D_t G_t (+ reg I).
      rhs: (..., N, NU).
    Returns dF (..., N, NU).
    """
    dtype, device = rhs.dtype, rhs.device
    A = data.A
    N = rhs.shape[-2]
    batch = rhs.shape[:-2]
    eye_x = torch.eye(NX, dtype=dtype, device=device)
    eye_u = torch.eye(NU, dtype=dtype, device=device)
    Qd = (2.0 * data.L).to(dtype).expand(batch + (NX,))
    Qm = Qd[..., :, None] * eye_x
    P = Qm
    p = torch.zeros(batch + (NX,), dtype=dtype, device=device)
    reg_e = reg[..., None, None] * eye_u
    Ks, ks = [None] * N, [None] * N
    for t in reversed(range(N)):
        Bt = data.B[..., t, :, :]
        PB = P @ Bt
        Luu = Rts[..., t, :, :] + Bt.transpose(-1, -2) @ PB + reg_e
        PA = P @ A
        Lux = Bt.transpose(-1, -2) @ PA                 # B^T P A
        lu = _mtv(Bt, p) - rhs[..., t, :]
        # A non-PD Luu gives a NaN factor (data, not an exception): the
        # finite-step guard of the IPM rejects the step for that lane.
        Lc = _cholesky_nan(Luu)
        # K = -Luu^{-1} Lux ; k = -Luu^{-1} lu
        K = -torch.cholesky_solve(Lux, Lc)
        k = -torch.cholesky_solve(lu[..., None], Lc)[..., 0]
        # P_t = Q + A^T P A + Lux^T K (the state cost applies at t = 1..N;
        # it is also added at t = 0 but P_0 is never used: dxi_0 = 0).
        P = A.transpose(-1, -2) @ PA + Lux.transpose(-1, -2) @ K + Qm
        P = 0.5 * (P + P.transpose(-1, -2))
        p = _mtv(A, p) + _mtv(Lux, k)
        Ks[t], ks[t] = K, k

    x = torch.zeros(batch + (NX,), dtype=dtype, device=device)
    us = []
    for t in range(N):
        u = _mv(Ks[t], x) + ks[t]
        x = _mv(A, x) + _mv(data.B[..., t, :, :], u)
        us.append(u)
    return torch.stack(us, dim=-2)


def _max_step(v, dv, tau):
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0),
                        float("inf"))
    alpha = tau * torch.amin(ratio, dim=(-2, -1))
    return torch.clamp(alpha, max=1.0)


def _amax2(a):
    return torch.amax(a, dim=(-2, -1))


def solve_mpc_qp_structured(data: MPCStructuredData, iterations: int = 30,
                            tol: float = 3e-4, tau: float = 0.995,
                            warm_start=None):
    """Mehrotra IPM on the horizon QP with Riccati KKT solves.

    Returns (F (..., N, NU), IPMSolution with flattened (..., N*NU) fields).
    Forces are solved in units of sigma = 120 N (~fz_max) and the cost is
    normalized by nu = 1 / max |c'| (the structured analogue of
    equilibrate()).

    warm_start: optional (F, s, z) in ORIGINAL units — typically the
    previous receding-horizon tick's solution (shift it by one step before
    passing for best effect). Slacks/duals are pushed to the interior.
    """
    dtype, device = data.err0.dtype, data.err0.device
    N = data.B.shape[-3]
    batch = tuple(torch.broadcast_shapes(data.err0.shape[:-2],
                                         data.h.shape[:-2]))
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny

    sigma = 120.0
    c_raw = _linear_cost(data)  # (..., N, NU)
    nu = 1.0 / torch.clamp(torch.amax(torch.abs(c_raw), dim=(-2, -1),
                                      keepdim=True) * sigma, min=1e-12)
    inv_s = 1.0 / (sigma * sigma * nu)  # (..., 1, 1) scaled->original factor

    Gs = data.G * sigma
    hs = data.h
    cs = c_raw * sigma * nu

    def hvp_s(F):
        return (sigma * sigma) * nu * _hvp(data, F)

    if warm_start is None:
        x = torch.zeros(batch + (N, NU), dtype=dtype, device=device)
        s = torch.clamp(hs, min=1.0).expand(batch + (N, _M))
        z = 1.0 / s
    else:
        Fw, sw, zw = warm_start
        x = (Fw / sigma).expand(batch + (N, NU))
        s = torch.clamp(sw.reshape(sw.shape[:-1] + (N, _M)),
                        min=1e-2).expand(batch + (N, _M))
        z = torch.clamp(zw.reshape(zw.shape[:-1] + (N, _M)) * nu,
                        min=1e-2).expand(batch + (N, _M))

    obj_scale = 1.0 + _amax2(torch.abs(cs))
    h_scale = 1.0 + _amax2(torch.abs(hs))
    freeze_gap = max(1e-4 * tol, 100.0 * eps) * obj_scale
    freeze_pr = max(tol, 50.0 * eps) * h_scale
    freeze_dr = max(tol, 50.0 * eps) * obj_scale
    d_max = 1.0 / eps
    MN = _M * N
    eye_u = torch.eye(NU, dtype=dtype, device=device)

    def gx(F):
        return torch.einsum("...tij,...tj->...ti", Gs, F)

    def gty(zz):
        return torch.einsum("...tji,...tj->...ti", Gs, zz)

    def finite2(a):
        return torch.isfinite(a).all(-1).all(-1)

    bx, bs, bz = x, s, z
    bmerit = torch.full(batch, float("inf"), dtype=dtype, device=device)
    for _ in range(iterations):
        r_prim = gx(x) + s - hs
        r_dual = hvp_s(x) + cs + gty(z)
        merit = (_amax2(torch.abs(r_prim)) / h_scale
                 + _amax2(torch.abs(r_dual)) / obj_scale
                 + torch.abs(torch.sum(s * z, dim=(-2, -1)))
                 / (MN * obj_scale))
        improve = (merit < bmerit) & finite2(x)
        imp = improve[..., None, None]
        bx = torch.where(imp, x, bx)
        bs = torch.where(imp, s, bs)
        bz = torch.where(imp, z, bz)
        bmerit = torch.where(improve, merit, bmerit)

        d = torch.clamp(z / s, max=d_max)
        # R_t = 2 alpha' I + G^T D G in scaled units.
        GtDG = torch.einsum("...tki,...tk,...tkj->...tij", Gs, d, Gs)
        Rts = 2.0 * (sigma * sigma) * nu[..., None] * data.alpha * eye_u \
            + GtDG
        diag_R = torch.diagonal(Rts, dim1=-2, dim2=-1)
        reg = (100.0 * eps) * _amax2(diag_R)
        # The Riccati recursion runs in ORIGINAL units: H' + GtDG =
        # sigma^2 nu (H + GtDG * inv_s).
        Rts_orig = 2.0 * data.alpha * eye_u + GtDG * inv_s[..., None]
        reg_orig = reg * inv_s[..., 0, 0]

        def kkt_solve(rhs):
            dx = _riccati_solve(data, Rts_orig, rhs * inv_s, reg_orig)
            # One refinement pass against the scaled operator.
            resid = rhs - (hvp_s(dx)
                           + torch.einsum("...tij,...tj->...ti", GtDG, dx))
            return dx + _riccati_solve(data, Rts_orig, resid * inv_s,
                                       reg_orig)

        mu = torch.sum(s * z, dim=(-2, -1)) / MN

        def newton(rc):
            tt = (z * r_prim - rc) / s
            dxF = kkt_solve(-(r_dual + gty(tt)))
            ds = -r_prim - gx(dxF)
            dz = -(rc + z * ds) / s
            return dxF, ds, dz

        dx_a, ds_a, dz_a = newton(s * z)
        a_aff = torch.minimum(_max_step(s, ds_a, 1.0), _max_step(z, dz_a, 1.0))
        a_ = a_aff[..., None, None]
        mu_aff = torch.sum((s + a_ * ds_a) * (z + a_ * dz_a),
                           dim=(-2, -1)) / MN
        sig = (mu_aff / torch.clamp(mu, min=1e-30)) ** 3
        rc = s * z + ds_a * dz_a - (sig * mu)[..., None, None]
        dxF, ds, dz = newton(rc)
        alpha = torch.minimum(_max_step(s, ds, tau), _max_step(z, dz, tau))

        done = ((mu < freeze_gap)
                & (_amax2(torch.abs(r_prim)) < freeze_pr)
                & (_amax2(torch.abs(r_dual)) < freeze_dr))
        step_ok = finite2(dxF) & finite2(ds) & finite2(dz)
        a = torch.where(done | ~step_ok, 0.0, alpha)[..., None, None]
        x = x + a * dxF
        s = torch.clamp(s + a * ds, min=tiny)
        z = torch.clamp(z + a * dz, min=tiny)

    # Final best-iterate pick.
    r_prim_f = gx(x) + s - hs
    r_dual_f = hvp_s(x) + cs + gty(z)
    merit_f = (_amax2(torch.abs(r_prim_f)) / h_scale
               + _amax2(torch.abs(r_dual_f)) / obj_scale
               + torch.abs(torch.sum(s * z, dim=(-2, -1))) / (MN * obj_scale))
    kf = ((merit_f < bmerit) & finite2(x))[..., None, None]
    x = torch.where(kf, x, bx)
    s = torch.where(kf, s, bs)
    z = torch.where(kf, z, bz)

    # Original units: x = sigma x', z = z'/nu; slacks are unscaled.
    F = x * sigma
    z_orig = z / nu
    r_dual = _hvp(data, F) + c_raw + torch.einsum("...tji,...tj->...ti",
                                                  data.G, z_orig)
    r_prim = torch.einsum("...tij,...tj->...ti", data.G, F) + s - data.h
    gap = torch.abs(torch.sum(s * z_orig, dim=(-2, -1))) / MN
    pr = _amax2(torch.abs(r_prim))
    dr = _amax2(torch.abs(r_dual))
    # The converged flag in the SCALED units the solver controls.
    nu_s = nu[..., 0, 0]
    converged = ((pr < tol * (1.0 + _amax2(torch.abs(data.h))))
                 & (dr * nu_s * sigma < tol * obj_scale)
                 & (gap * nu_s < tol * obj_scale))
    sol = IPMSolution(
        x=F.reshape(batch + (N * NU,)), z=z_orig.reshape(batch + (N * _M,)),
        s=s.reshape(batch + (N * _M,)),
        iterations=torch.as_tensor(iterations), gap=gap, primal_residual=pr,
        dual_residual=dr, converged=converged)
    return F, sol


def solve_mpc_structured(xi0, xi_ref, yaw, feet_world, x_com,
                         stance_schedule, horizon: int, dt,
                         cfg: ControlConfig, iterations: int = 30,
                         mass=None, inertia_diag=None, mu=None, tol=None,
                         state_weights=None, force_weight: float = 1e-6):
    """Drop-in analogue of mpc/horizon.solve_mpc using the O(N) structured
    solver. Returns (F (..., N, 12), IPMSolution). ``state_weights`` may be
    a (..., 13) tensor of per-instance weight diagonals."""
    data = build_mpc_structured(xi0, xi_ref, yaw, feet_world, x_com,
                                stance_schedule, horizon, dt, cfg,
                                mass=mass, inertia_diag=inertia_diag, mu=mu,
                                state_weights=state_weights,
                                force_weight=force_weight)
    if tol is None:
        tol = 1e-6 if data.err0.dtype == torch.float64 else 3e-4
    return solve_mpc_qp_structured(data, iterations=iterations, tol=tol)
