"""Closed loop: commander x whole-body articulated plant (counterpart of
``quadruped_control_tpu/sim/rollout.py``).

One tick = measure (base pose + joints) -> commander_step -> joint torques
(zero-order hold) -> ``n_substeps`` physics substeps. The only coupling
between controller and plant is the torque command and the measured (base
pose, joint) state. This is the loop of many small tensor operations; the
three-kernel version of the same tick is sim/fused_tick.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quadruped_control_tpu_torch.config import ControlConfig
from quadruped_control_tpu_torch.control.commander import (
    CommanderCarry,
    commander_step,
    init_commander_carry,
)
from quadruped_control_tpu_torch.control.rollout import RolloutTrace
from quadruped_control_tpu_torch.ops.kinematics import forward_kinematics
from quadruped_control_tpu_torch.sim.dynamics import (
    leg_gravity_torques,
    leg_mass_matrices,
)
from quadruped_control_tpu_torch.sim.model import WholeBodyModel
from quadruped_control_tpu_torch.sim.plant import (
    ContactConfig,
    WholeBodyState,
    init_whole_body_state,
    whole_body_com_state,
    whole_body_step,
)


class WholeBodyRolloutResult(NamedTuple):
    plant: WholeBodyState
    carry: CommanderCarry
    trace: Optional[RolloutTrace]


def rollout_whole_body(plant: WholeBodyState, carry: CommanderCarry,
                       cmd_twist, steps: int, cfg: ControlConfig,
                       model: WholeBodyModel,
                       contact: ContactConfig = ContactConfig(),
                       n_substeps: Optional[int] = None,
                       qp_iterations: int = 12, qp_polish: bool = False,
                       qp_backend: str = "jnp",
                       record: bool = True, controller: str = "balance",
                       mpc_horizon: int = 8, mpc_dt: float = 0.05,
                       mpc_iterations: int = 25,
                       mpc_backend: str = "structured",
                       mpc_state_weights=None,
                       weight_shift: float = 0.0,
                       m_update: str = "tick",
                       contact_gate: float = 0.0,
                       raibert_cmd_symmetric: bool = False,
                       heading_hold: bool = False,
                       foothold_trim=None,
                       swing_vel_rescale: bool = False,
                       swing_accel_ff: bool = False,
                       stance_pose=False,
                       swing_start_ground: bool = False,
                       body_frame_exact: bool = False,
                       gravity_comp: bool = False,
                       stepper=None,
                       cmd_schedule: bool = False) -> WholeBodyRolloutResult:
    """Run ``steps`` control ticks of the full-physics closed loop.

    ``stepper``: optional fused plant stepper built by
    ``sim.fused_substep.make_fused_stepper(model, cfg, contact)``
    (``torque_input="tau"``) — the kernel replacement for the substep loop.
    It holds the model/contact constants, so it must match
    ``model``/``contact``; requires an explicit ``n_substeps`` and implies
    ``m_update="tick"``.

    ``cmd_schedule=True``: ``cmd_twist`` is a (steps, ..., 6) PER-TICK
    command (build with control/rollout.piecewise_command).

    ``controller="mpc"`` with the ``mpc_*`` options runs the receding-
    horizon MPC (control/commander.commander_step); ``mpc_backend=
    "riccati-pallas"`` solves it in the MPC kernel on CUDA tensors.
    """
    dt = 1.0 / cfg.frequency
    if stepper is not None and n_substeps is None:
        raise ValueError("stepper= requires explicit n_substeps")
    batch = tuple(plant.x.shape[:-1])
    kw = dict(dtype=plant.x.dtype, device=plant.x.device)
    if foothold_trim is not None and carry.ref_pose is None:
        carry = carry._replace(ref_pose=torch.zeros(batch + (3,), **kw))
    if stance_pose is not False and stance_pose is not None \
            and carry.pose_cmd is None:
        carry = carry._replace(pose_cmd=torch.zeros(batch + (4,), **kw))
    if cmd_schedule and cmd_twist.shape[0] != steps:
        raise ValueError(f"cmd_schedule: {tuple(cmd_twist.shape)} does not "
                         f"start with steps = {steps}")

    wb, cc = plant, carry
    traces = []
    for t in range(steps):
        cmd = cmd_twist[t] if cmd_schedule else cmd_twist
        com, joints = whole_body_com_state(wb, cfg)
        g_tau = (leg_gravity_torques(model, joints.q, com.R)
                 if gravity_comp else None)
        sw_mass = (leg_mass_matrices(model, joints.q)
                   if swing_accel_ff else None)
        out, cc = commander_step(
            com, joints, cc, cmd, dt, cfg,
            qp_iterations=qp_iterations, qp_polish=qp_polish,
            qp_backend=qp_backend, controller=controller,
            mpc_horizon=mpc_horizon, mpc_dt=mpc_dt,
            mpc_iterations=mpc_iterations, mpc_backend=mpc_backend,
            mpc_state_weights=mpc_state_weights,
            weight_shift=weight_shift, contact_gate=contact_gate,
            raibert_cmd_symmetric=raibert_cmd_symmetric,
            heading_hold=heading_hold,
            foothold_trim=foothold_trim,
            swing_vel_rescale=swing_vel_rescale,
            swing_accel_ff=swing_accel_ff,
            swing_mass=sw_mass,
            stance_pose=stance_pose,
            swing_start_ground=swing_start_ground,
            body_frame_exact=body_frame_exact,
            gravity_comp_tau=g_tau,
        )
        if stepper is not None:
            wb = stepper(wb, out.torques, dt, n_substeps)
        else:
            wb = whole_body_step(wb, out.torques, dt, model, cfg, contact,
                                 n_substeps=n_substeps, m_update=m_update)
        if record:
            feet_body = forward_kinematics(wb.q, cfg.kinematics)
            feet_w = torch.einsum("...ij,...lj->...li", wb.R,
                                  feet_body) + wb.x[..., None, :]
            traces.append(RolloutTrace(
                x=wb.x,
                xdot=(wb.R @ wb.u[..., 3:6, None])[..., 0],
                standing=cc.standing,
                in_stance=out.gait.in_stance,
                qp_converged=out.qp_converged,
                torque_max=out.torques.abs().flatten(-2).max(-1).values,
                feet=feet_w,
                R=wb.R,
            ))
    trace = None
    if record and traces:
        trace = RolloutTrace(*(torch.stack(parts) for parts in zip(*traces)))
    return WholeBodyRolloutResult(plant=wb, carry=cc, trace=trace)


def init_whole_body_rollout(cfg: ControlConfig, batch_shape=(),
                            dtype=torch.float32, device=None, **kwargs):
    """Convenience: (plant, carry) pair in the laying start pose."""
    plant = init_whole_body_state(cfg, batch_shape, dtype=dtype,
                                  device=device, **kwargs)
    carry = init_commander_carry(batch_shape, dtype=dtype, device=device)
    return plant, carry
