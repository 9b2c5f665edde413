"""Raibert-heuristic foothold planning as masked dataflow (counterpart of
``quadruped_control_tpu/ops/foot_planner.py``; reference foot_planner.cpp).

The reference plans a new world-frame foothold only for legs on a
stance->swing transition, tracked by a mutable ``state_map_``
(foot_planner.cpp:106-157). Here the edge detector is a pure function of a
carried ``(prev_in_stance, initialized)`` state, and the Raibert +
linear-inverted-pendulum foothold formula (foot_planner.cpp:76-104) is
evaluated for all four legs at once with the replan decision as a mask.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch.config import FootPlannerConfig
from quadruped_control_tpu_torch.types import Gait


class FootholdPlan(NamedTuple):
    replan: torch.Tensor  # (..., 4) bool — legs whose foothold was replanned
    footholds: torch.Tensor  # (..., 4, 3) world-frame footholds (z = 0)
    prev_in_stance: torch.Tensor  # (..., 4) carried leg states
    initialized: torch.Tensor  # (...,) carried first-call flag


def raibert_footholds(t_stance, R, x, xdot, w, xdot_d, foot_positions,
                      cfg: FootPlannerConfig = FootPlannerConfig(),
                      symmetric_velocity=None, symmetric_omega=None,
                      capture_scale=None):
    """World-frame footholds for all legs (reference ``singleFoot``,
    foot_planner.cpp:76-104).

    foothold = p_thigh + (t_stance/2) xdot + k (xdot - xdot_d)
             + (t_stance/2) (w x (R p_foot)) + 0.5 sqrt(z/g) xdot,  z -> 0

    Args:
      R: (..., 3, 3) world-from-body rotation.
      x, xdot, w, xdot_d: (..., 3) CoM state / desired velocity.
      foot_positions: (..., 4, 3) current foot positions in the body frame.
      symmetric_velocity: optional (..., 3) velocity for the ``t_stance/2``
        travel term instead of the measured ``xdot``.
      symmetric_omega: optional (..., 3) angular velocity for the tangential
        term instead of the measured ``w``.
      capture_scale: optional coefficient (float or per-instance tensor)
        replacing the reference's 0.5 in the capture term.
    Returns:
      (..., 4, 3) footholds projected to the ground plane.
    """
    hips = cfg.hip_offsets(foot_positions.dtype, device=foot_positions.device)
    p_thigh = torch.einsum("...ij,lj->...li", R, hips) + x[..., None, :]
    pcom_foot = torch.einsum("...ij,...lj->...li", R, foot_positions)
    w_t = w if symmetric_omega is None else symmetric_omega
    tang_vel = torch.linalg.cross(
        w_t[..., None, :].expand(pcom_foot.shape), pcom_foot)

    v_sym = xdot if symmetric_velocity is None else symmetric_velocity
    p_linear = (t_stance / 2.0) * v_sym + cfg.k * (xdot - xdot_d)
    p_tangent = (t_stance / 2.0) * tang_vel
    # z clamped >= 0: a fallen base must not NaN-poison a batched sweep.
    cap = 0.5 if capture_scale is None else capture_scale
    if not isinstance(cap, float):
        cap = torch.as_tensor(cap, dtype=x.dtype, device=x.device)[..., None]
    p_lip = cap * torch.sqrt(
        torch.clamp(x[..., 2:3], min=0.0) / cfg.gravity) * xdot

    foothold = p_thigh + (p_linear + p_lip)[..., None, :] + p_tangent
    return torch.cat(
        [foothold[..., :2], torch.zeros_like(foothold[..., 2:])], dim=-1)


def plan_footholds(prev_in_stance, initialized, gait: Gait, t_stance, R, x,
                   xdot, w, xdot_d, foot_positions,
                   cfg: FootPlannerConfig = FootPlannerConfig(),
                   symmetric_velocity=None, symmetric_omega=None,
                   capture_scale=None) -> FootholdPlan:
    """Edge-triggered foothold replanning (reference ``positions`` +
    ``updateStates``, foot_planner.cpp:45-74, 106-157).

    First call (``initialized`` false): plan for every swing leg. Afterwards:
    plan only on a stance->swing transition.
    """
    swing_now = torch.logical_not(gait.in_stance)
    edge = torch.logical_and(prev_in_stance, swing_now)
    replan = torch.where(initialized[..., None], edge, swing_now)

    footholds = raibert_footholds(t_stance, R, x, xdot, w, xdot_d,
                                  foot_positions, cfg,
                                  symmetric_velocity=symmetric_velocity,
                                  symmetric_omega=symmetric_omega,
                                  capture_scale=capture_scale)
    footholds = torch.where(replan[..., None], footholds, 0.0)

    return FootholdPlan(
        replan=replan,
        footholds=footholds,
        prev_in_stance=gait.in_stance,
        initialized=torch.ones_like(initialized),
    )
