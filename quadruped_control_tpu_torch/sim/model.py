"""Whole-body model parameters for the MIT Mini Cheetah (counterpart of
``quadruped_control_tpu/sim/model.py``).

The kinematic tree is fully determined by the controller-side constants the
reference ships (kinematics.cpp:23-31): per-leg chain
``Rx(q1) · [0,l1,0] · Ry(q2) · [0,0,-l2] · Ry(q3) · [0,0,-l3]`` hanging off
hip offsets ``(±0.196, ±0.050, 0)``. Inertial parameters are not in the
reference checkout; two documented sets are provided:

  - :func:`mit_cheetah_whole_body_model`: trunk = the SRB inertia the
    controller uses, mass = total − legs; leg links with Mini-Cheetah-like
    masses (abad 0.54 kg, thigh 0.634 kg, shank 0.151 kg) and thin-rod
    inertias; reflected rotor inertia on each joint.
  - :func:`mit_cheetah_urdf_model`: the published Mini Cheetah link
    inertials (Katz, Di Carlo & Kim, ICRA 2019).

Total mass equals ``BalanceConfig.mass`` (11 kg) so the SRB controller's
model and the simulated robot agree on weight.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig, KinematicsConfig


class WholeBodyModel(NamedTuple):
    """Parameter container for the 13-body floating tree.

    Bodies: 0 = trunk (free joint); per leg ``l`` in [RL, FL, RR, FR] order
    a 3-joint chain abad -> thigh -> shank. All per-link tensors carry a
    leading leg axis of size 4 and a joint axis of size 3. Link frame
    ``(l, j)`` sits at joint ``j`` with the joint rotation applied; joint
    axes are x (abad) and y (thigh, knee) in the local frame.
    """

    joint_offsets: torch.Tensor  # (4, 3, 3) parent frame -> joint, parent coords
    joint_axes: torch.Tensor  # (4, 3, 3) unit axes in the child link frame
    link_mass: torch.Tensor  # (4, 3)
    link_com: torch.Tensor  # (4, 3, 3) COM offsets in link frame
    link_inertia: torch.Tensor  # (4, 3, 3, 3) about the link COM
    trunk_mass: torch.Tensor  # ()
    trunk_inertia: torch.Tensor  # (3, 3) about trunk COM = base origin
    armature: torch.Tensor  # (4, 3) reflected rotor inertia
    joint_damping: torch.Tensor  # (4, 3) viscous damping


def _model_from_numpy(fields: dict, dtype, device) -> WholeBodyModel:
    device = resolve_device(device)
    return WholeBodyModel(**{
        k: torch.as_tensor(np.array(v, np.float64), dtype=dtype).to(device)
        for k, v in fields.items()})


def _signed_l1(kin: KinematicsConfig):
    return kin.l1_signed_np()


def _default_fields(cfg, abad_mass, thigh_mass, shank_mass, armature,
                    joint_damping) -> dict:
    kin = cfg.kinematics
    hips = kin.hip_offsets_np()
    l1s = _signed_l1(kin)
    zeros4 = np.zeros(4)

    # Joint offsets in parent coordinates: abad joint at the hip offset
    # (parent = trunk); thigh joint at (0, ±l1, 0) in the abad frame; knee
    # joint at (0, 0, -l2) in the thigh frame.
    off_thigh = np.stack([zeros4, l1s, zeros4], axis=-1)
    off_knee = np.stack([zeros4, zeros4, np.full(4, -kin.l2)], axis=-1)
    joint_offsets = np.stack([hips, off_thigh, off_knee], axis=1)

    ex, ey = np.array([1.0, 0.0, 0.0]), np.array([0.0, 1.0, 0.0])
    joint_axes = np.broadcast_to(np.stack([ex, ey, ey]), (4, 3, 3))
    link_mass = np.broadcast_to(
        np.array([abad_mass, thigh_mass, shank_mass]), (4, 3))

    # COM offsets: abad COM halfway to the hip-pitch joint (lateral);
    # thigh/shank COM halfway along the (0, 0, -l) link vector.
    com_abad = np.stack([zeros4, 0.5 * l1s, zeros4], axis=-1)
    com_thigh = np.stack([zeros4, zeros4, np.full(4, -0.5 * kin.l2)], axis=-1)
    com_shank = np.stack([zeros4, zeros4, np.full(4, -0.5 * kin.l3)], axis=-1)
    link_com = np.stack([com_abad, com_thigh, com_shank], axis=1)

    def rod_inertia(m, length, axis):
        """Thin rod along `axis`: I_perp = m l^2 / 12 plus a small floor so
        no principal moment is exactly zero."""
        diag = [m * length * length / 12.0 + 1e-5] * 3
        diag[axis] = 1e-5
        return np.diag(diag)

    link_inertia = np.broadcast_to(
        np.stack([rod_inertia(abad_mass, kin.l1, 1),
                  rod_inertia(thigh_mass, kin.l2, 2),
                  rod_inertia(shank_mass, kin.l3, 2)]), (4, 3, 3, 3))

    leg_mass_total = 4.0 * (abad_mass + thigh_mass + shank_mass)
    return dict(
        joint_offsets=joint_offsets, joint_axes=joint_axes,
        link_mass=link_mass, link_com=link_com, link_inertia=link_inertia,
        trunk_mass=cfg.balance.mass - leg_mass_total,
        trunk_inertia=np.diag(np.asarray(cfg.balance.inertia_diag)),
        armature=np.full((4, 3), armature),
        joint_damping=np.full((4, 3), joint_damping),
    )


def mit_cheetah_whole_body_model(
    cfg: Optional[ControlConfig] = None,
    dtype=torch.float32,
    abad_mass: float = 0.54,
    thigh_mass: float = 0.634,
    shank_mass: float = 0.151,
    armature: float = 0.002,
    joint_damping: float = 0.01,
    device=None,
) -> WholeBodyModel:
    """The default whole-body model from the controller config: geometry from
    ``cfg.kinematics``, the synthesized inertials of the module docstring,
    ``trunk_mass = cfg.balance.mass − 4·(leg link masses)``."""
    cfg = cfg or ControlConfig()
    return _model_from_numpy(
        _default_fields(cfg, abad_mass, thigh_mass, shank_mass, armature,
                        joint_damping), dtype, device)


def mit_cheetah_urdf_model(
    cfg: Optional[ControlConfig] = None,
    dtype=torch.float32,
    total_mass: Optional[float] = None,
    joint_damping: float = 0.01,
    device=None,
) -> WholeBodyModel:
    """Whole-body model with the PUBLISHED Mini Cheetah link inertials:

      abad:  m 0.54 kg,  com (0, +-0.036, 0),     I (381, 560, 444)e-6;
      thigh: m 0.634 kg, com (0, +-0.016, -0.02), I (1983, 2103, 676)e-6;
      shank: m 0.064 kg, com (0, 0, -0.061),      I (245, 248, 6)e-6;
      rotor: I 33e-6 kg m^2 at gear ratio 6 -> armature 1.188e-3 per joint.

    (+- mirrors left/right with the hip y sign.) Link GEOMETRY stays the
    reference's kinematic constants. ``total_mass`` (default
    ``cfg.balance.mass``): the trunk absorbs the difference between the
    published bare robot and the controller's SRB mass.
    """
    cfg = cfg or ControlConfig()
    f = _default_fields(cfg, 0.54, 0.634, 0.151, 0.002, joint_damping)
    side = np.sign(_signed_l1(cfg.kinematics))  # +1 left legs, -1 right legs
    zeros4 = np.zeros(4)

    abad_mass, thigh_mass, shank_mass = 0.54, 0.634, 0.064
    f["link_mass"] = np.broadcast_to(
        np.array([abad_mass, thigh_mass, shank_mass]), (4, 3))
    com_abad = np.stack([zeros4, 0.036 * side, zeros4], axis=-1)
    com_thigh = np.stack([zeros4, 0.016 * side, np.full(4, -0.02)], axis=-1)
    com_shank = np.stack([zeros4, zeros4, np.full(4, -0.061)], axis=-1)
    f["link_com"] = np.stack([com_abad, com_thigh, com_shank], axis=1)
    e6 = 1e-6
    f["link_inertia"] = np.broadcast_to(
        np.stack([np.diag(np.array([381., 560., 444.]) * e6),
                  np.diag(np.array([1983., 2103., 676.]) * e6),
                  np.diag(np.array([245., 248., 6.]) * e6)]), (4, 3, 3, 3))
    total = float(cfg.balance.mass) if total_mass is None else float(
        total_mass)
    f["trunk_mass"] = total - 4.0 * (abad_mass + thigh_mass + shank_mass)
    f["armature"] = np.full((4, 3), 33e-6 * 36.0)
    return _model_from_numpy(f, dtype, device)
