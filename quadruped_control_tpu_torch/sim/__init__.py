"""Whole-body articulated rigid-body simulation (counterpart of
``quadruped_control_tpu/sim``).

A floating-base 13-body (trunk + 4x3 leg links) rigid-body dynamics engine as
batched PyTorch — spatial-algebra RNEA for bias forces, mass matrix from
unit-acceleration RNEA columns, compliant point contact at the feet, torque
driven like the reference's simulation (the ONLY input is the joint torque
command, drake_interface_node.cpp:63-87) — plus the kernel versions of its
hot loops: the fused substep kernel (``fused_substep``) and the three-kernel
closed-loop tick (``fused_tick``).
"""

from quadruped_control_tpu_torch.sim.model import (
    WholeBodyModel,
    mit_cheetah_urdf_model,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim.dynamics import (
    LegKinematics,
    precompute_leg_kinematics,
    rnea,
    rnea_bias,
    mass_matrix,
    body_coms_world,
    total_mass,
)
from quadruped_control_tpu_torch.sim.plant import (
    ContactConfig,
    WholeBodyState,
    init_whole_body_state,
    whole_body_step,
    whole_body_com_state,
)
from quadruped_control_tpu_torch.sim.fused_substep import make_fused_stepper
from quadruped_control_tpu_torch.sim.rollout import (
    WholeBodyRolloutResult,
    init_whole_body_rollout,
    rollout_whole_body,
)

__all__ = [
    "WholeBodyModel",
    "mit_cheetah_urdf_model",
    "mit_cheetah_whole_body_model",
    "LegKinematics",
    "precompute_leg_kinematics",
    "rnea",
    "rnea_bias",
    "mass_matrix",
    "body_coms_world",
    "total_mass",
    "ContactConfig",
    "WholeBodyState",
    "init_whole_body_state",
    "whole_body_step",
    "whole_body_com_state",
    "WholeBodyRolloutResult",
    "init_whole_body_rollout",
    "make_fused_stepper",
    "rollout_whole_body",
]
