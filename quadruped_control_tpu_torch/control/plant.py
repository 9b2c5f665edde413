"""Single-rigid-body plant surrogate (counterpart of
``quadruped_control_tpu/control/plant.py``).

The batched "environment" of the SRB closed-loop rollouts: the model the
controller itself assumes — a single rigid body with massless legs and
pinned stance feet — integrated at the control rate.

Dynamics (world frame):
    xddot = (sum_i f_i) / m + g
    dL/dt = sum_i (p_i - x) x f_i,   w = Iw^-1 L   (angular momentum form)
    Rdot  = [w]x R
integrated semi-implicitly (velocities first, then pose). Contact: stance
feet are pinned where they first touch; swing feet follow the commanded
trajectory kinematically. Joint states come from leg IK of the body-frame
foot positions.

Every clip is ``torch.minimum(torch.maximum(x, lo), hi)``, the arithmetic of
``jnp.clip``: a NaN passes through, and at a tie the gradient is split in
half as JAX splits it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import GRAVITY, ControlConfig
from quadruped_control_tpu_torch.math.rotations import so3_exp
from quadruped_control_tpu_torch.ops.kinematics import (
    forward_kinematics,
    inverse_kinematics,
)
from quadruped_control_tpu_torch.types import ComState, JointState


class PlantState(NamedTuple):
    com: ComState
    feet_world: torch.Tensor  # (..., 4, 3) foot positions in world frame
    joints: JointState


def _clip(x, lo, hi):
    """``jnp.clip(x, lo, hi)``; float bounds become tensors on the device
    (a fill, never a host copy)."""
    if not torch.is_tensor(lo):
        lo = torch.full_like(x, lo)
    if not torch.is_tensor(hi):
        hi = torch.full_like(x, hi)
    return torch.minimum(torch.maximum(x, lo), hi)


def _floor0(v):
    return torch.maximum(v, torch.zeros_like(v))


def _set_z(a, z):
    return torch.cat([a[..., :2], z[..., None]], dim=-1)


def init_plant_state(cfg: ControlConfig, batch_shape=(),
                     dtype=torch.float32, height=None,
                     device=None) -> PlantState:
    """Initial state: the reference's laying pose — base at z = 0.06 with the
    init joint configuration (mit_cheetah_config.yaml:8, 43). ``device=None``
    means ``cuda``."""
    device = resolve_device(device)
    batch_shape = tuple(batch_shape)
    kw = dict(dtype=dtype, device=device)
    q0 = torch.tensor([0.0, 1.61, -2.78], **kw).expand(
        batch_shape + (4, 3)).contiguous()
    h0 = 0.06 if height is None else height
    x0 = torch.zeros(batch_shape + (3,), **kw)
    x0[..., 2] = h0
    R0 = torch.eye(3, **kw).expand(batch_shape + (3, 3)).contiguous()
    feet_body = forward_kinematics(q0, cfg.kinematics)
    feet_world = (torch.einsum("...ij,...lj->...li", R0, feet_body)
                  + x0[..., None, :])
    feet_world = _set_z(feet_world, _floor0(feet_world[..., 2]))
    com = ComState(R=R0, x=x0, xdot=torch.zeros_like(x0),
                   w=torch.zeros_like(x0))
    return PlantState(com=com, feet_world=feet_world,
                      joints=JointState(q=q0, qdot=torch.zeros_like(q0)))


def plant_step(state: PlantState, forces_world, stance_mask, swing_foot_refs,
               dt, cfg: ControlConfig) -> PlantState:
    """Advance the SRB surrogate one physics step.

    Args:
      forces_world: (..., 12) ground-reaction forces ON the robot, world
        frame (the QP's primal solution).
      stance_mask: (..., 4) current stance legs.
      swing_foot_refs: (..., 4, 3) world-frame reference positions for swing
        feet (from the trajectory manager).
      dt: physics step.
    Returns:
      next PlantState.
    """
    com = state.com
    dtype, device = com.x.dtype, com.x.device
    m = cfg.balance.mass
    Ib_diag = torch.tensor(cfg.balance.inertia_diag, dtype=dtype,
                           device=device)

    f_legs = forces_world.reshape(forces_world.shape[:-1] + (4, 3))
    f_legs = torch.where(stance_mask[..., None], f_legs, 0.0)
    # Contact saturation: the ground cannot pull (fz >= 0) and tangential
    # forces stay inside the friction cone. The QP enforces this when it
    # converged; the plant enforces it always, so an unconverged float32
    # solve cannot inject unbounded force and NaN the whole batch.
    fz = _clip(f_legs[..., 2], 0.0, 2.0 * cfg.balance.fz_max)
    ft_max = cfg.balance.mu * fz
    f_legs = torch.stack(
        [_clip(f_legs[..., 0], -ft_max, ft_max),
         _clip(f_legs[..., 1], -ft_max, ft_max),
         fz],
        dim=-1,
    )
    f_total = torch.sum(f_legs, dim=-2)

    gvec = torch.tensor([0.0, 0.0, -GRAVITY], dtype=dtype, device=device)
    xddot = f_total / m + gvec

    r = state.feet_world - com.x[..., None, :]
    torque = torch.sum(torch.linalg.cross(r, f_legs, dim=-1), dim=-2)
    Iw = (com.R * Ib_diag[..., None, :]) @ com.R.transpose(-1, -2)
    # Angular momentum integration: dL/dt = torque (world frame), then
    # w = Iw^-1 L. Explicit Euler on wdot = Iw^-1 (tau - w x Iw w) is
    # unstable in the gyroscopic term once the body tumbles; the momentum
    # form conserves L exactly under zero torque.
    L = (Iw @ com.w[..., None])[..., 0]
    L_new = L + dt * torque
    w_new = torch.linalg.solve(Iw, L_new[..., None])[..., 0]

    # Semi-implicit Euler: velocities first, then pose. The saturation
    # bounds keep a fallen, tumbling body finite, so one crashed scenario
    # never poisons a batched sweep.
    xdot_new = com.xdot + dt * xddot
    xdot_new = _clip(xdot_new, -50.0, 50.0)
    w_new = _clip(w_new, -100.0, 100.0)
    x_new = com.x + dt * xdot_new
    x_new = _set_z(x_new, _clip(x_new[..., 2], -1.0, 10.0))
    R_new = so3_exp(w_new * dt) @ com.R

    # Feet: stance pinned, swing tracks the reference trajectory.
    feet_world = torch.where(stance_mask[..., None], state.feet_world,
                             swing_foot_refs)
    feet_world = _set_z(feet_world, _floor0(feet_world[..., 2]))

    # Joint states from IK of body-frame foot positions (exact transform).
    feet_body = torch.einsum("...ji,...lj->...li", R_new,
                             feet_world - x_new[..., None, :])
    q_new = inverse_kinematics(feet_body, cfg.kinematics)
    qdot_new = (q_new - state.joints.q) / dt

    return PlantState(
        com=ComState(R=R_new, x=x_new, xdot=xdot_new, w=w_new),
        feet_world=feet_world,
        joints=JointState(q=q_new, qdot=qdot_new),
    )
