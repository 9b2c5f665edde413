"""Core state containers (counterpart of ``quadruped_control_tpu/types.py``).

The reference keys everything by leg-name strings (types.hpp:27-127). Here
each map is a fixed-axis tensor over legs in ``[RL, FL, RR, FR]`` order,
packed into NamedTuples of tensors. ``in_stance`` is a boolean mask of shape
(..., 4); ``True`` is stance, ``False`` is swing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch import resolve_device


class ComState(NamedTuple):
    """Body CoM state in world frame (reference ``RobotStateCoM``)."""

    R: torch.Tensor  # (..., 3, 3) world-from-body rotation Rwb
    x: torch.Tensor  # (..., 3) CoM position
    xdot: torch.Tensor  # (..., 3) CoM linear velocity
    w: torch.Tensor  # (..., 3) body angular velocity (world frame)


class JointState(NamedTuple):
    """Per-leg joint positions/velocities (reference ``LegJointStates``)."""

    q: torch.Tensor  # (..., 4, 3)
    qdot: torch.Tensor  # (..., 4, 3)


class FootState(NamedTuple):
    """Reference/actual foot kinematic state (reference ``FootState``)."""

    position: torch.Tensor  # (..., 4, 3)
    velocity: torch.Tensor  # (..., 4, 3)


class Gait(NamedTuple):
    """Gait snapshot: stance mask + phase per leg (reference ``GaitMap``)."""

    in_stance: torch.Tensor  # (..., 4) bool
    phase: torch.Tensor  # (..., 4) in [0, 1)


class FootTrajCoeffs(NamedTuple):
    """Per-leg sextic swing-trajectory coefficients (trajectory.hpp:89-136).
    ``coeffs[leg]`` is the 7x3 coefficient matrix; ``valid`` marks legs that
    have a planned trajectory."""

    coeffs: torch.Tensor  # (..., 4, 7, 3)
    valid: torch.Tensor  # (..., 4) bool


class PlannerState(NamedTuple):
    """Carried state for stance->swing edge detection + planned footholds."""

    prev_in_stance: torch.Tensor  # (..., 4) bool
    initialized: torch.Tensor  # (...,) bool — first-call semantics
    traj: FootTrajCoeffs


def make_stance_gait(batch_shape=(), dtype=torch.float32,
                     device=None) -> Gait:
    """All-legs-stance gait at phase 0 (reference gait.cpp:24-34)."""
    device = resolve_device(device)
    batch_shape = tuple(batch_shape)
    return Gait(
        in_stance=torch.ones(batch_shape + (4,), dtype=torch.bool,
                             device=device),
        phase=torch.zeros(batch_shape + (4,), dtype=dtype, device=device),
    )


def init_planner_state(batch_shape=(), dtype=torch.float32,
                       device=None) -> PlannerState:
    device = resolve_device(device)
    batch_shape = tuple(batch_shape)
    return PlannerState(
        prev_in_stance=torch.ones(batch_shape + (4,), dtype=torch.bool,
                                  device=device),
        initialized=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        traj=FootTrajCoeffs(
            coeffs=torch.zeros(batch_shape + (4, 7, 3), dtype=dtype,
                               device=device),
            valid=torch.zeros(batch_shape + (4,), dtype=torch.bool,
                              device=device),
        ),
    )
