"""Swing-leg joint PD control (reference joint_controller.cpp:21-39).

tau = kp * wrap(q_ref - q) + kd * (qdot_ref - qdot) + kff, with the joint
error computed exactly as the reference does: both angles normalized to
[0, 2pi), differenced, then wrapped to (-pi, pi].
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch.config import JointControlConfig
from quadruped_control_tpu_torch.math.numerics import (
    normalize_angle_2pi,
    normalize_angle_pi,
)


def joint_pd_control(q_ref, qdot_ref, q, qdot,
                     cfg: JointControlConfig = JointControlConfig()):
    """Joint torques for all legs; apply a swing mask downstream.

    Args:
      q_ref, qdot_ref, q, qdot: (..., 4, 3).
    Returns:
      (..., 4, 3) torques.
    """
    kw = dict(dtype=q.dtype, device=q.device)
    kp = torch.tensor(cfg.kp, **kw)
    kd = torch.tensor(cfg.kd, **kw)
    kff = torch.tensor(cfg.kff, **kw)

    q_error = normalize_angle_pi(
        normalize_angle_2pi(q_ref) - normalize_angle_2pi(q)
    )
    qdot_error = qdot_ref - qdot
    return kp * q_error + kd * qdot_error + kff
