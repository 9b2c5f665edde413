"""Receding-horizon SRB MPC: the stacked GRF QP over a time horizon
(counterpart of ``quadruped_control_tpu/mpc/horizon.py``).

The convex SRB MPC of Di Carlo et al., "Dynamic Locomotion in the MIT
Cheetah 3 Through Convex Model-Predictive Control" (IROS 2018): N SRB steps
stack into one QP over F = [f_0 ... f_{N-1}] with per-step friction cones,
condensed through the linearized dynamics so the whole problem feeds the
batched IPM of ``solver/ipm.py``.

Linearized SRB state (13-dim, gravity as an affine state):
    xi = [rpy(3), p(3), w(3), v(3), 1]
    rpy_dot ~ Rz(yaw)^T w        (small roll/pitch, Di Carlo Eq. 10)
    p_dot   = v
    w_dot   = Iw^-1 sum_i r_i x f_i   (omega x Iw omega dropped — Eq. 14)
    v_dot   = sum_i f_i / m - g zhat
discretized by forward Euler at the MPC step dt.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch.config import GRAVITY, ControlConfig
from quadruped_control_tpu_torch.math.rotations import skew
from quadruped_control_tpu_torch.ops.dynamics import cone_constraints
from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm

NX = 13  # state dim
NU = 12  # GRFs per step

# Di Carlo-style default state weights: orientation, height, velocities.
DEFAULT_STATE_WEIGHTS = (50.0, 50.0, 10.0, 1.0, 1.0, 100.0,
                         1.0, 1.0, 5.0, 5.0, 5.0, 2.0, 0.0)


class MPCProblem(NamedTuple):
    H: torch.Tensor  # (..., N*12, N*12)
    c: torch.Tensor  # (..., N*12)
    G: torch.Tensor  # (..., N*24, N*12)
    h: torch.Tensor  # (..., N*24)


def state_weight_tensor(state_weights, dtype, device):
    """``state_weights`` (None = the default, a sequence, or a (..., 13)
    tensor of per-instance diagonals) as a tensor."""
    if state_weights is None:
        state_weights = DEFAULT_STATE_WEIGHTS
    return torch.as_tensor(state_weights, dtype=dtype, device=device)


def srb_discrete_dynamics(yaw, feet_world, x_com, dt,
                          cfg: ControlConfig, mass=None, inertia_diag=None):
    """One-step discrete (A, B) of the linearized SRB.

    Args:
      yaw: (...,) current yaw (rotation linearization point).
      feet_world: (..., 4, 3) foot positions (world).
      x_com: (..., 3) CoM position.
      dt: MPC step.
    Returns:
      A: (..., 13, 13), B: (..., 13, 12).
    """
    dtype, device = feet_world.dtype, feet_world.device
    kw = dict(dtype=dtype, device=device)
    bal = cfg.balance
    m = torch.as_tensor(bal.mass if mass is None else mass, **kw)
    Ib_diag = torch.as_tensor(
        bal.inertia_diag if inertia_diag is None else inertia_diag, **kw)
    yaw = torch.as_tensor(yaw, **kw)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(cy)
    one = torch.ones_like(cy)
    # Rz(yaw)^T maps world angular velocity to rpy rates (Di Carlo Eq. 10).
    Rz_T = torch.stack([
        torch.stack([cy, sy, zero], dim=-1),
        torch.stack([-sy, cy, zero], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    Rz = Rz_T.transpose(-1, -2)
    # World inertia at the linearization yaw.
    Iw = (Rz * Ib_diag[..., None, :]) @ Rz_T
    Iw_inv = torch.linalg.inv(Iw)

    batch = tuple(torch.broadcast_shapes(cy.shape, feet_world.shape[:-2]))
    eye3 = torch.eye(3, **kw)
    A = torch.eye(NX, **kw).expand(batch + (NX, NX)).clone()
    A[..., 0:3, 6:9] += dt * Rz_T.expand(batch + (3, 3))
    A[..., 3:6, 9:12] += dt * eye3
    A[..., 11, 12] += -dt * GRAVITY

    B = torch.zeros(batch + (NX, NU), **kw)
    r = feet_world - x_com[..., None, :]
    for leg in range(4):
        cols = slice(3 * leg, 3 * leg + 3)
        B[..., 6:9, cols] = dt * (Iw_inv @ skew(r[..., leg, :]))
        B[..., 9:12, cols] = (dt / m)[..., None, None] * eye3
    return A, B


def build_mpc_qp(xi0, xi_ref, yaw, feet_world, x_com, stance_schedule,
                 horizon: int, dt, cfg: ControlConfig,
                 state_weights=None, force_weight: float = 1e-6,
                 mass=None, inertia_diag=None, mu=None) -> MPCProblem:
    """Condense the N-step SRB tracking problem into one dense QP.

    min sum_t |xi_t - xi_ref_t|^2_L + alpha |f_t|^2
    s.t. xi_{t+1} = A xi_t + B_t f_t,  cone(f_t, stance_t)

    Args:
      xi0: (..., 13) initial state.
      xi_ref: (..., N, 13) reference trajectory.
      yaw / feet_world / x_com: linearization data (held over the horizon —
        the standard convex-MPC approximation).
      stance_schedule: (..., N, 4) stance mask per step (from the gait).
      horizon: N.
    Returns:
      MPCProblem in the solver's standard form.
    """
    dtype, device = xi0.dtype, xi0.device
    L = state_weight_tensor(state_weights, dtype, device)

    A, B = srb_discrete_dynamics(yaw, feet_world, x_com, dt, cfg,
                                 mass=mass, inertia_diag=inertia_diag)
    batch = tuple(A.shape[:-2])

    # xi_t = A^t xi0 + sum_{k<t} A^(t-1-k) B_k f_k,  t = 1..N. B_k has its
    # swing-leg columns zeroed per the step's contact schedule: swing forces
    # decouple from the dynamics and the alpha|f|^2 cost pins them to 0.
    N = horizon
    eye = torch.eye(NX, dtype=dtype, device=device).expand(batch + (NX, NX))
    Apow = [eye]
    for _ in range(N):
        Apow.append(A @ Apow[-1])

    col_mask = torch.repeat_interleave(stance_schedule.to(dtype), 3, dim=-1)
    B_steps = [B * col_mask[..., t, None, :] for t in range(N)]

    # Sqp: (N*NX, NX); Bqp: (N*NX, N*NU) block lower-triangular.
    Sqp = torch.cat([Apow[t] for t in range(1, N + 1)], dim=-2)
    zero_blk = torch.zeros(batch + (NX, NU), dtype=dtype, device=device)
    rows = []
    for t in range(1, N + 1):
        rows.append(torch.cat(
            [Apow[t - 1 - k] @ B_steps[k] if k < t else zero_blk
             for k in range(N)], dim=-1))
    Bqp = torch.cat(rows, dim=-2)

    Lbar = L.repeat(N) if L.dim() == 1 else L.repeat(
        (1,) * (L.dim() - 1) + (N,))
    err0 = torch.einsum("...ij,...j->...i", Sqp, xi0) - xi_ref.reshape(
        xi_ref.shape[:-2] + (N * NX,))
    H = 2.0 * (torch.einsum("...ki,...k,...kj->...ij", Bqp, Lbar, Bqp)
               + force_weight * torch.eye(N * NU, dtype=dtype, device=device))
    c = 2.0 * torch.einsum("...ki,...k,...k->...i", Bqp, Lbar, err0)

    # Per-step cone constraints, block-diagonal over the horizon.
    G = torch.zeros(batch + (24 * N, 12 * N), dtype=dtype, device=device)
    h_steps = []
    for t in range(N):
        Gt, ht = cone_constraints(stance_schedule[..., t, :], mu=mu,
                                  cfg=cfg.balance, dtype=dtype)
        G[..., 24 * t:24 * t + 24, 12 * t:12 * t + 12] = Gt
        h_steps.append(ht.expand(batch + (24,)))
    h = torch.cat(h_steps, dim=-1)
    return MPCProblem(H=H, c=c, G=G, h=h)


def solve_mpc(xi0, xi_ref, yaw, feet_world, x_com, stance_schedule,
              horizon: int, dt, cfg: ControlConfig, iterations: int = 30,
              mass=None, inertia_diag=None, mu=None, tol=None,
              state_weights=None, force_weight: float = 1e-6):
    """Build + solve the horizon QP; returns (forces (..., N, 12), solution).

    The generic IPM without the unrolled-12 linear algebra (the stacked
    system is 12N-dimensional) and without polish (MPC consumes only f_0)."""
    qp = build_mpc_qp(xi0, xi_ref, yaw, feet_world, x_com, stance_schedule,
                      horizon, dt, cfg, mass=mass, inertia_diag=inertia_diag,
                      mu=mu, state_weights=state_weights,
                      force_weight=force_weight)
    if tol is None:
        # f32 cannot certify 1e-6-relative residuals on the 12N-var stacked
        # system: the dual-residual floor sits ~2e-4 in the original units.
        tol = 1e-6 if qp.H.dtype == torch.float64 else 3e-4
    sol = solve_qp_ipm(qp.H, qp.c, qp.G, qp.h, iterations=iterations,
                       polish=False, tol=tol, unrolled_linalg=False)
    F = sol.x.reshape(sol.x.shape[:-1] + (horizon, NU))
    return F, sol


def make_reference_trajectory(xi0, cmd_twist, horizon: int, dt,
                              target_height: float = 0.26):
    """Constant-twist reference: integrate the commanded planar twist from
    the current state (the MPC analogue of integrate_twist_yaw)."""
    dtype, device = xi0.dtype, xi0.device
    N = horizon
    t = torch.arange(1, N + 1, dtype=dtype, device=device) * dt
    ref = torch.zeros(xi0.shape[:-1] + (N, NX), dtype=dtype, device=device)
    vx, vy, wz = cmd_twist[..., 0:1], cmd_twist[..., 1:2], cmd_twist[..., 5:6]
    ref[..., 2] = xi0[..., 2:3] + t * wz
    ref[..., 3] = xi0[..., 3:4] + t * vx
    ref[..., 4] = xi0[..., 4:5] + t * vy
    ref[..., 5] = target_height
    ref[..., 9] = vx
    ref[..., 10] = vy
    ref[..., 8] = wz
    ref[..., 12] = 1.0
    return ref
