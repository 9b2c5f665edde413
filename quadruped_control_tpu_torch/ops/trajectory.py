"""Swing-foot trajectories, twist integration, and support polygon
(counterpart of ``quadruped_control_tpu/ops/trajectory.py``; reference
trajectory.{hpp,cpp}).

  - ``FootTrajectory``: a 6th-order polynomial per axis through 7 boundary
    constraints (trajectory.cpp:256-296). The constraint matrix A is constant,
    so ``A^-1`` is computed once in float64 and every replan is one
    (7x7)@(7x3) product.
  - ``FootTrajectoryManager``: phase -> trajectory-time affine clamp
    (trajectory.cpp:300-307, 366-388) as pure functions over
    :class:`FootTrajCoeffs`.
  - ``integrate_twist_yaw`` (trajectory.cpp:29-69): desired CoM pose from a
    commanded body twist, with roll/pitch zeroed to stop drift.
  - ``SupportPolygon`` (trajectory.cpp:71-147): erf-weighted virtual CoM
    target from scheduled contact phases.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_control_tpu_torch.config import GaitConfig
from quadruped_control_tpu_torch.math.rotations import (
    matrix_to_rpy,
    rpy_to_matrix,
    so3_exp,
    transform_apply,
)
from quadruped_control_tpu_torch.types import FootState, FootTrajCoeffs, Gait

# The constant 7x7 constraint system (trajectory.cpp:267-274):
# rows = [s(0), s(1), s(0.5), sdot(0), sdot(1), sddot(0), sddot(1)].
_A_CONSTRAINTS = np.array(
    [
        [1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
        [1.0, 0.5, 0.25, 0.125, 0.0625, 0.03125, 0.015625],
        [0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 1.0, 2.0, 3.0, 4.0, 5.0, 6.0],
        [0.0, 0.0, 2.0, 0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 2.0, 6.0, 12.0, 20.0, 30.0],
    ]
)
_A_INV = np.linalg.inv(_A_CONSTRAINTS)


def sextic_coefficients(p_start, p_center, p_final):
    """Polynomial coefficients through (p0, pc, pf) with zero boundary
    velocity/acceleration (trajectory.cpp:220-225, 279-296).

    Args:
      p_start, p_center, p_final: (..., 3) waypoints.
    Returns:
      (..., 7, 3) coefficients (constant term first).
    """
    zeros = torch.zeros_like(p_start)
    # B rows: [p_start, p_final, p_center, 0, 0, 0, 0] (trajectory.cpp:290-294).
    B = torch.stack([p_start, p_final, p_center, zeros, zeros, zeros, zeros],
                    dim=-2)
    a_inv = torch.as_tensor(_A_INV, dtype=p_start.dtype,
                            device=p_start.device)
    return a_inv @ B


def _powers(t):
    one = torch.ones_like(t)
    t2 = t * t
    t3 = t2 * t
    t4 = t3 * t
    t5 = t4 * t
    return one, t, t2, t3, t4, t5


def sextic_track(coeffs, t):
    """Position/velocity on the polynomial at normalized time ``t`` in [0,1]
    (trajectory.cpp:227-254).

    Args:
      coeffs: (..., 7, 3).
      t: broadcastable to coeffs' batch shape.
    Returns:
      FootState with (..., 3) position and velocity.
    """
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    one, t1, t2, t3, t4, t5 = _powers(t)
    powers = torch.stack([one, t1, t2, t3, t4, t5, t5 * t], dim=-1)
    zero = torch.zeros_like(t)
    dpowers = torch.stack(
        [zero, one, 2 * t1, 3 * t2, 4 * t3, 5 * t4, 6 * t5], dim=-1)
    position = torch.einsum("...k,...kd->...d", powers, coeffs)
    velocity = torch.einsum("...k,...kd->...d", dpowers, coeffs)
    return FootState(position=position, velocity=velocity)


def sextic_accel(coeffs, t):
    """Second derivative of the sextic at normalized time ``t`` in [0,1]
    (the reference computes and comments out exactly this,
    trajectory.cpp:246-251). Real-time acceleration is this value /
    t_swing^2; zero at both boundaries by construction."""
    t = torch.as_tensor(t, dtype=coeffs.dtype, device=coeffs.device)
    one, t1, t2, t3, t4, _ = _powers(t)
    zero = torch.zeros_like(t)
    ddpowers = torch.stack(
        [zero, zero, 2 * one, 6 * t1, 12 * t2, 20 * t3, 30 * t4], dim=-1)
    return torch.einsum("...k,...kd->...d", ddpowers, coeffs)


def swing_time_of_phase(phase, cfg: GaitConfig):
    """Gait phase -> trajectory time t = clamp(slope*phase + intercept, 0, 1)
    (trajectory.cpp:300-307, 373)."""
    slope = 1.0 / (1.0 - cfg.stance_phase)
    intercept = 1.0 - slope
    return torch.clamp(slope * phase + intercept, 0.0, 1.0)


def plan_swing_trajectories(traj: FootTrajCoeffs, p_start, p_final,
                            replan_mask, cfg: GaitConfig) -> FootTrajCoeffs:
    """Replan per-leg swing trajectories where ``replan_mask`` is set.

    The apex is the midpoint at z = swing height (trajectory.cpp:322-324).
    Legs not replanned keep their carried coefficients.

    Args:
      traj: carried coefficients.
      p_start, p_final: (..., 4, 3) world-frame bounds.
      replan_mask: (..., 4) bool.
    """
    p_center = 0.5 * (p_start + p_final)
    p_center = torch.cat(
        [p_center[..., :2],
         torch.full_like(p_center[..., 2:], cfg.swing_height)], dim=-1)
    new_coeffs = sextic_coefficients(p_start, p_center, p_final)
    coeffs = torch.where(replan_mask[..., None, None], new_coeffs,
                         traj.coeffs)
    valid = torch.logical_or(traj.valid, replan_mask)
    return FootTrajCoeffs(coeffs=coeffs, valid=valid)


def reference_foot_states(traj: FootTrajCoeffs, gait: Gait,
                          cfg: GaitConfig) -> FootState:
    """Reference foot states for all legs at the gait's phases
    (trajectory.cpp:348-388). Legs without a valid trajectory return zeros —
    the reference's lookup-miss path (trajectory.cpp:382-388)."""
    t = swing_time_of_phase(gait.phase, cfg)
    state = sextic_track(traj.coeffs, t)
    mask = traj.valid[..., None]
    return FootState(
        position=torch.where(mask, state.position, 0.0),
        velocity=torch.where(mask, state.velocity, 0.0),
    )


def integrate_twist_yaw(R, x, twist, dt):
    """Desired CoM pose from a commanded body twist (trajectory.cpp:29-69).

    The body pose used for integration keeps only yaw (roll/pitch zeroed to
    stop drift, trajectory.cpp:57-62). The twist is ``[v; w]`` in body frame;
    the incremental rotation is exp([w dt]) and the translation is rotated by
    it before composing (trajectory.cpp:48-54).

    Args:
      R: (..., 3, 3) current world-from-body rotation.
      x: (..., 3) current CoM position.
      twist: (..., 6) [vx, vy, vz, wx, wy, wz] body twist.
      dt: integration step (commander uses 0.001, commander_node.cpp:344).
    Returns:
      (R_desired, x_desired).
    """
    delta_aa = twist[..., 3:] * dt
    Rbbp = so3_exp(delta_aa)
    tbbp = (Rbbp @ (twist[..., :3] * dt)[..., None])[..., 0]

    rpy = matrix_to_rpy(R)
    zero = torch.zeros_like(rpy[..., 0])
    yaw_only = torch.stack([zero, zero, rpy[..., 2]], dim=-1)
    Rwb_yaw = rpy_to_matrix(yaw_only)
    # Twb' = Twb_yaw * Tbb'
    R_new = Rwb_yaw @ Rbbp
    x_new = transform_apply(Rwb_yaw, x, tbbp)
    return R_new, x_new


# Adjacent legs (clockwise, counter-clockwise) per leg in [RL, FL, RR, FR]
# order (trajectory.cpp:73-79): RL->(FL,RR), FL->(FR,RL), FR->(RR,FL),
# RR->(RL,FR).
_ADJ_MINUS = (1, 3, 0, 2)  # clockwise neighbor index
_ADJ_PLUS = (2, 0, 3, 1)  # counter-clockwise neighbor index


def support_polygon_position(stance_start, stance_end, swing_start, swing_end,
                             foot_positions, gait: Gait):
    """Virtual predictive support-polygon CoM (x, y) target
    (trajectory.cpp:81-147).

    Args:
      stance_start/stance_end/swing_start/swing_end: (..., 4) scheduled phase
        windows per leg (reference ``ScheduledPhasesMap``).
      foot_positions: (..., 4, 3) foot positions.
      gait: current gait snapshot.
    Returns:
      (..., 2) virtual CoM target.
    """
    erf = torch.special.erf
    phase = gait.phase
    root2 = torch.sqrt(torch.tensor(2.0, dtype=phase.dtype,
                                    device=phase.device))
    eps = 1e-12

    w_stance = 0.5 * (
        erf(phase / (stance_start * root2 + eps))
        + erf((1.0 - phase) / (stance_end * root2 + eps))
    )
    w_swing = 0.5 * (
        2.0
        + erf(-phase / (swing_start * root2 + eps))
        + erf((phase - 1.0) / (swing_end * root2 + eps))
    )
    weight = torch.where(gait.in_stance, w_stance, w_swing)

    p = foot_positions[..., :2]
    minus, plus = list(_ADJ_MINUS), list(_ADJ_PLUS)
    p_minus = p[..., minus, :]
    p_plus = p[..., plus, :]
    w_minus = weight[..., minus]
    w_plus = weight[..., plus]

    wcol = weight[..., None]
    zeta_minus = p * wcol + p_minus * (1.0 - wcol)
    zeta_plus = p * wcol + p_plus * (1.0 - wcol)

    supports = (
        wcol * p + w_minus[..., None] * zeta_minus
        + w_plus[..., None] * zeta_plus
    ) / (weight + w_minus + w_plus)[..., None]

    return torch.mean(supports, dim=-2)
