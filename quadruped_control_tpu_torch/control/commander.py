"""The commander control tick as a single pure function (counterpart of
``quadruped_control_tpu/control/commander.py``; reference
commander_node.cpp:372-557).

One function maps (robot state, carried controller state, command) to joint
torques; it broadcasts over leading batch dimensions.

State machine parity (commander_node.cpp:377-479):
  - not standing: stance gait, balance control drives the CoM to the stand
    target (the ``stand_up`` path).
  - standing height reached (|z - 0.26| < 5 mm): start the gait clock.
  - walking: integrate the commanded twist for the desired pose, plan
    footholds on stance->swing edges, track sextic swing trajectories.

``controller="mpc"``: the stance forces come from f_0 of a receding-horizon
SRB MPC over the gait's scheduled contacts (mpc/), through one of three
backends: "condensed" (dense stacked QP), "structured" (O(N) Riccati IPM) or
"riccati-pallas" (the MPC kernel K6: CUDA on CUDA tensors, its plain version
on CPU tensors; the option keeps the JAX package's name).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig, StancePoseConfig
from quadruped_control_tpu_torch.math.numerics import almost_equal
from quadruped_control_tpu_torch.math.rotations import (
    matrix_to_rpy,
    rpy_to_matrix,
    transform_adjoint,
)
from quadruped_control_tpu_torch.ops import dynamics as dyn
from quadruped_control_tpu_torch.ops.foot_planner import plan_footholds
from quadruped_control_tpu_torch.ops.gait import gait_at_time
from quadruped_control_tpu_torch.ops.joint_control import joint_pd_control
from quadruped_control_tpu_torch.ops.kinematics import (
    forward_kinematics,
    inverse_kinematics,
    jacobian_transpose_control,
    leg_jacobian_inverse,
)
from quadruped_control_tpu_torch.ops.trajectory import (
    integrate_twist_yaw,
    plan_swing_trajectories,
    reference_foot_states,
    sextic_accel,
    sextic_track,
    support_polygon_position,
    swing_time_of_phase,
)
from quadruped_control_tpu_torch.solver.ipm import IPMSolution, solve_qp_ipm
from quadruped_control_tpu_torch.types import (
    ComState,
    Gait,
    JointState,
    PlannerState,
    init_planner_state,
)

_MPC_BACKENDS = ("condensed", "structured", "riccati-pallas")


class CommanderCarry(NamedTuple):
    """Carried controller state (the reference's static/global flags:
    ``standing``, ``gait_running`` commander_node.cpp:365-366, the gait
    clock, the planner/trajectory state, and the QP warm-start triple)."""

    standing: torch.Tensor  # (...,) bool
    gait_time: torch.Tensor  # (...,) seconds since gait start (<0: not running)
    planner: PlannerState
    qp_x: torch.Tensor  # (..., 12) previous primal solution
    qp_s: torch.Tensor  # (..., 24) previous slacks
    qp_z: torch.Tensor  # (..., 24) previous duals
    # (..., 3) [x_ref, y_ref, yaw_ref] command-integrated reference pose for
    # the foothold-trim regulator (None = regulator off).
    ref_pose: Optional[torch.Tensor] = None
    # (..., 4) [roll, pitch, yaw, dz] rate-integrated desired body pose for
    # the stance_pose mode (None = mode off).
    pose_cmd: Optional[torch.Tensor] = None


class CommanderOutput(NamedTuple):
    torques: torch.Tensor  # (..., 4, 3) clamped joint torques
    forces_body: torch.Tensor  # (..., 4, 3) stance GRFs in body frame
    forces_world: torch.Tensor  # (..., 12) raw QP solution
    gait: Gait
    foot_refs_world: torch.Tensor  # (..., 4, 3) swing foot reference positions
    swing_q_ref: torch.Tensor  # (..., 4, 3)
    qp_converged: torch.Tensor  # (...,)
    # Full horizon forces (..., N, 12) when controller="mpc", else None.
    forces_horizon: Optional[torch.Tensor] = None


def init_commander_carry(batch_shape=(), dtype=torch.float32,
                         ref_pose: bool = False, pose_cmd: bool = False,
                         device=None) -> CommanderCarry:
    device = resolve_device(device)
    batch_shape = tuple(batch_shape)
    kw = dict(dtype=dtype, device=device)
    return CommanderCarry(
        standing=torch.zeros(batch_shape, dtype=torch.bool, device=device),
        gait_time=torch.full(batch_shape, -1.0, **kw),
        planner=init_planner_state(batch_shape, dtype=dtype, device=device),
        qp_x=torch.zeros(batch_shape + (12,), **kw),
        qp_s=torch.ones(batch_shape + (24,), **kw),
        qp_z=torch.ones(batch_shape + (24,), **kw),
        ref_pose=torch.zeros(batch_shape + (3,), **kw) if ref_pose else None,
        pose_cmd=torch.zeros(batch_shape + (4,), **kw) if pose_cmd else None,
    )


class CommanderPrecursors(NamedTuple):
    """Everything commander steps 1-8 produce (the pre-QP stage): inputs to
    the stance-force controller plus the swing pipeline's results."""

    feet_body: torch.Tensor  # (..., 4, 3)
    standing: torch.Tensor  # (...,)
    gait_time: torch.Tensor  # (...,)
    walking: torch.Tensor  # (...,)
    gait: Gait
    eff_stance: torch.Tensor  # (..., 4) gait stance AND (opt) contact gate
    R_d: torch.Tensor  # (..., 3, 3)
    x_d: torch.Tensor  # (..., 3)
    xdot_d: torch.Tensor  # (..., 3)
    w_d: torch.Tensor  # (..., 3)
    plan: "object"  # FootholdPlan
    traj: "object"  # FootTrajCoeffs
    foot_ref: "object"  # FootState
    q_ref: torch.Tensor  # (..., 4, 3)
    qdot_ref: torch.Tensor  # (..., 4, 3)
    tau_swing: torch.Tensor  # (..., 4, 3)
    p_start: torch.Tensor  # (..., 4, 3) current feet in world frame
    ref_pose: Optional[torch.Tensor] = None
    pose_cmd: Optional[torch.Tensor] = None


def _set(a, index, value):
    """Functional ``a[..., index] = value`` (the ``.at[...].set`` of the
    reference)."""
    out = a.clone()
    out[..., index] = value
    return out


def _yaw_rotation(yaw):
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zr, on = torch.zeros_like(cy), torch.ones_like(cy)
    return torch.stack([
        torch.stack([cy, -sy, zr], dim=-1),
        torch.stack([sy, cy, zr], dim=-1),
        torch.stack([zr, zr, on], dim=-1),
    ], dim=-2)


def _wrap_angle(e):
    return torch.atan2(torch.sin(e), torch.cos(e))


def _enabled(option):
    return option is not False and option is not None


def commander_precursors(com: ComState, joints: JointState,
                         carry: CommanderCarry, cmd_twist, dt,
                         cfg: ControlConfig, *, weight_shift: float = 0.0,
                         contact_gate: float = 0.0,
                         raibert_cmd_symmetric: bool = False,
                         heading_hold: bool = False,
                         foothold_trim=None,
                         swing_vel_rescale: bool = False,
                         swing_accel_ff: bool = False,
                         swing_mass=None,
                         stance_pose=False,
                         swing_start_ground: bool = False,
                         body_frame_exact: bool = False,
                         ) -> CommanderPrecursors:
    """Commander steps 1-8: FK, the standing/gait state machine,
    desired-state generation, foothold planning, swing-trajectory tracking,
    IK, and swing PD — everything before the stance-force solve. All
    arguments broadcast over leading batch dims.

    Args:
      com: CoM state (world frame).
      joints: per-leg joint states.
      carry: carried controller state.
      cmd_twist: (..., 6) commanded body twist (cmd_vel).
      dt: control period (1 / cfg.frequency).
      weight_shift: 0 disables (reference behavior). >0 blends the walking
        (x, y) target toward the reference's virtual predictive support
        polygon (trajectory.cpp:71-147). 1.0 = full shift.
      contact_gate: 0 disables (stance purely clock-scheduled). >0: a
        scheduled-stance foot measured (via FK) more than this height [m]
        above the ground is NOT handed to the GRF QP; gated legs keep
        swing-PD tracking toward their planned foothold.
      raibert_cmd_symmetric: True = the Raibert travel term uses the
        COMMANDED velocity instead of the measured one.
      heading_hold: experimental absolute-heading regulation (a measured
        negative result of the reference; kept for reproducibility).
      foothold_trim: None disables. A ``config.FootholdTrimConfig`` enables
        the foothold-level heading/station regulator; needs
        ``carry.ref_pose``.
      swing_vel_rescale: True = physical-units swing velocity feedforward
        (1 / t_swing); a float or per-instance tensor = explicit multiplier.
      swing_accel_ff / swing_mass: model-based swing inertia feedforward
        tau_ff = D(q) qddot_ref with ``swing_mass`` from
        ``sim.dynamics.leg_mass_matrices``.
      stance_pose: False disables. True or a ``config.StancePoseConfig``
        enables the stance body-posing mode; needs ``carry.pose_cmd``.
      swing_start_ground: plan swing trajectories from the ground-projected
        start.
      body_frame_exact: use the exact transform p_b = R^T (p_w - x) instead
        of the reference's quirk p_b = R^T p_w - x.
    """
    kin = cfg.kinematics
    gait_cfg = cfg.gait

    # 1. FK: feet in body frame (commander_node.cpp:383-384).
    feet_body = forward_kinematics(joints.q, kin)

    # 2. Standing detection (commander_node.cpp:387-391); latching.
    standing = torch.logical_or(
        carry.standing,
        almost_equal(com.x[..., 2], cfg.stand.height,
                     cfg.stand.height_tolerance),
    )
    # Gait clock starts one tick after standing (commander_node.cpp:474-478).
    gait_running = carry.gait_time >= 0.0
    gait_time = torch.where(
        gait_running, carry.gait_time + dt,
        torch.where(standing, torch.zeros_like(carry.gait_time),
                    carry.gait_time),
    )
    if _enabled(stance_pose):
        # Stance body-posing mode: the gait clock NEVER starts.
        gait_time = carry.gait_time
    walking = gait_time >= 0.0

    # 3. Desired CoM state: stand target, or integrated twist when walking
    #    (commander_node.cpp:346-364, 399-427).
    R_d_walk, x_d_walk = integrate_twist_yaw(
        com.R, com.x, cmd_twist, cfg.cmd_integration_dt
    )
    x_d_walk = _set(x_d_walk, 2, cfg.stand.height)  # height pinned (:407)
    if heading_hold:
        yaw_ref = cmd_twist[..., 5] * torch.clamp(gait_time, min=0.0)
        yaw_meas = torch.atan2(com.R[..., 1, 0], com.R[..., 0, 0])
        err = _wrap_angle(yaw_ref - yaw_meas)
        R_d_walk = _yaw_rotation(yaw_meas + torch.clamp(err, -0.05, 0.05))
    hl = (getattr(foothold_trim, "heading_lead", 0.0)
          if foothold_trim is not None else 0.0)
    heading_servo = not (isinstance(hl, float) and hl == 0.0)
    if heading_servo:
        if carry.ref_pose is None:
            raise ValueError(
                "heading_lead needs carry.ref_pose — build the carry with "
                "init_commander_carry(ref_pose=True)")
        yaw_meas_h = torch.atan2(com.R[..., 1, 0], com.R[..., 0, 0])
        yaw_tgt = torch.where(walking,
                              carry.ref_pose[..., 2] + cmd_twist[..., 5] * dt,
                              yaw_meas_h)
        e_h = _wrap_angle(yaw_tgt - yaw_meas_h)
        R_d_walk = _yaw_rotation(yaw_meas_h + torch.clamp(e_h, -hl, hl))
    Vw = (transform_adjoint(com.R, com.x) @ cmd_twist[..., None])[..., 0]

    eye = torch.eye(3, dtype=com.R.dtype,
                    device=com.R.device).expand(com.R.shape)
    x_stand = _set(torch.zeros_like(com.x), 2, cfg.stand.height)
    wmask = walking[..., None]
    R_d = torch.where(wmask[..., None], R_d_walk, eye)
    x_d = torch.where(wmask, x_d_walk, x_stand)
    xdot_d = torch.where(wmask, Vw[..., :3], 0.0)
    w_d = torch.where(wmask, Vw[..., 3:], 0.0)

    # 3b. (extension, opt-in) Stance body-pose integrator.
    new_pose_cmd = carry.pose_cmd
    if _enabled(stance_pose):
        if carry.pose_cmd is None:
            raise ValueError(
                "stance_pose needs carry.pose_cmd — build the carry with "
                "init_commander_carry(pose_cmd=True)")
        spc = (stance_pose if isinstance(stance_pose, StancePoseConfig)
               else StancePoseConfig())
        kw = dict(dtype=com.x.dtype, device=com.x.device)
        rate = torch.cat([cmd_twist[..., 3:6], cmd_twist[..., 2:3]], dim=-1)
        lo = torch.tensor([-spc.roll_max, -spc.pitch_max, -spc.yaw_max,
                           spc.dz_min], **kw)
        hi = torch.tensor([spc.roll_max, spc.pitch_max, spc.yaw_max,
                           spc.dz_max], **kw)
        pc = torch.minimum(torch.maximum(carry.pose_cmd + rate * dt, lo), hi)
        new_pose_cmd = torch.where(standing[..., None], pc, carry.pose_cmd)
        smask = standing[..., None]
        R_d = torch.where(smask[..., None],
                          rpy_to_matrix(new_pose_cmd[..., :3]), R_d)
        x_d = torch.where(
            smask, _set(x_stand, 2, x_stand[..., 2] + new_pose_cmd[..., 3]),
            x_d)
        xdot_d = torch.where(
            smask, _set(torch.zeros_like(xdot_d), 2, cmd_twist[..., 2]),
            xdot_d)
        w_d = torch.where(
            smask, (com.R @ cmd_twist[..., 3:6, None])[..., 0], w_d)

    # 4. Gait schedule: stance until the clock runs (commander_node.cpp:369,433).
    gait_walk = gait_at_time(torch.clamp(gait_time, min=0.0), gait_cfg,
                             dtype=com.x.dtype)
    gait = Gait(
        in_stance=torch.where(wmask, gait_walk.in_stance,
                              torch.ones_like(gait_walk.in_stance)),
        phase=torch.where(wmask, gait_walk.phase, 0.0),
    )

    # 4b. (extension, opt-in) Anticipatory weight shift.
    if weight_shift:
        s_ph = gait_cfg.stance_phase
        pn = torch.where(
            gait.in_stance,
            gait.phase / s_ph,
            (gait.phase - s_ph) / (1.0 - s_ph),
        )
        gait_n = Gait(in_stance=gait.in_stance, phase=pn)
        feet_w = (
            torch.einsum("...ij,...lj->...li", com.R, feet_body)
            + com.x[..., None, :]
        )
        sig = torch.full_like(pn, 0.25)
        p_sup = support_polygon_position(sig, sig, sig, sig, feet_w, gait_n)
        shift = weight_shift * (p_sup - x_d[..., :2])
        x_d = torch.cat(
            [x_d[..., :2] + torch.where(wmask, shift, 0.0), x_d[..., 2:]],
            dim=-1)

    # 5. Foothold planning on stance->swing edges (commander_node.cpp:436-441).
    cap = None
    if foothold_trim is not None:
        cs = getattr(foothold_trim, "capture_scale", 0.5)
        if not (isinstance(cs, float) and cs == 0.5):
            cap = cs
    plan = plan_footholds(
        carry.planner.prev_in_stance, carry.planner.initialized, gait,
        gait_cfg.t_stance, com.R, com.x, com.xdot, com.w, xdot_d, feet_body,
        cfg.foot_planner,
        symmetric_velocity=xdot_d if raibert_cmd_symmetric else None,
        capture_scale=cap,
    )

    # 5b. (extension, opt-in) Foothold-level heading/station regulation.
    new_ref = carry.ref_pose
    if foothold_trim is not None:
        if carry.ref_pose is None:
            raise ValueError(
                "foothold_trim needs carry.ref_pose — build the carry with "
                "init_commander_carry(ref_pose=True)")
        ft = foothold_trim
        yaw_meas = torch.atan2(com.R[..., 1, 0], com.R[..., 0, 0])
        anchored = torch.stack(
            [com.x[..., 0], com.x[..., 1], yaw_meas], dim=-1)
        ref = torch.where(wmask, carry.ref_pose, anchored)
        rx, ry, ryaw = ref[..., 0], ref[..., 1], ref[..., 2]
        hx, hy = torch.cos(ryaw), torch.sin(ryaw)
        dx, dy = com.x[..., 0] - rx, com.x[..., 1] - ry
        e_ct = -hy * dx + hx * dy  # cross-track error (+ = left of path)
        v_ct = -hy * com.xdot[..., 0] + hx * com.xdot[..., 1]
        e_yaw = _wrap_angle(yaw_meas - ryaw)
        delta = torch.clamp(-ft.yaw_gain * e_yaw, -ft.yaw_max, ft.yaw_max)
        lat = torch.clamp(ft.lat_gain * e_ct + ft.lat_vel_gain * v_ct,
                          -ft.lat_max, ft.lat_max)
        r_g = getattr(ft, "roll_gain", 0.0)
        rv_g = getattr(ft, "roll_vel_gain", 0.0)
        roll = torch.atan2(com.R[..., 2, 1], com.R[..., 2, 2])
        wx_b = torch.einsum("...i,...i->...", com.R[..., :, 0], com.w)
        lat_r = torch.clamp(r_g * roll + rv_g * wx_b,
                            -ft.roll_max, ft.roll_max)
        byx, byy = com.R[..., 0, 1], com.R[..., 1, 1]
        cd, sd = torch.cos(delta), torch.sin(delta)
        relx = plan.footholds[..., 0] - com.x[..., 0:1]
        rely = plan.footholds[..., 1] - com.x[..., 1:2]
        fx = (com.x[..., 0:1] + cd[..., None] * relx - sd[..., None] * rely
              - (lat * hy)[..., None] + (lat_r * byx)[..., None])
        fy = (com.x[..., 1:2] + sd[..., None] * relx + cd[..., None] * rely
              + (lat * hx)[..., None] + (lat_r * byy)[..., None])
        trimmed = torch.stack([fx, fy, torch.zeros_like(fx)], dim=-1)
        plan = plan._replace(footholds=torch.where(
            plan.replan[..., None], trimmed, plan.footholds))
        along = hx * dx + hy * dy
        vx_c, vy_c, wz_c = (cmd_twist[..., 0], cmd_twist[..., 1],
                            cmd_twist[..., 5])
        walk_ref = torch.stack([
            rx + hx * along + dt * (hx * vx_c - hy * vy_c),
            ry + hy * along + dt * (hy * vx_c + hx * vy_c),
            ryaw + dt * wz_c,
        ], dim=-1)
        new_ref = torch.where(wmask, walk_ref, anchored)

    # 6. Swing trajectory replan: p_start = world-frame current foot
    #    (commander_node.cpp:451-461).
    p_start = (
        torch.einsum("...ij,...lj->...li", com.R, feet_body)
        + com.x[..., None, :]
    )
    p_plan = p_start
    if swing_start_ground:
        p_plan = _set(p_plan, 2, torch.clamp(p_plan[..., 2], max=0.0))
    traj = plan_swing_trajectories(
        carry.planner.traj, p_plan, plan.footholds, plan.replan, gait_cfg
    )

    # 7. Swing-leg joint references (commander_node.cpp:482-500). World ->
    #    body with the reference's exact quirk: p_b = R^T p_w - x
    #    (commander_node.cpp:491, NOT R^T (p - x)).
    def to_body(p_w):
        if body_frame_exact:
            return torch.einsum("...ji,...lj->...li", com.R,
                                p_w - com.x[..., None, :])
        return (torch.einsum("...ji,...lj->...li", com.R, p_w)
                - com.x[..., None, :])

    foot_ref = reference_foot_states(traj, gait, gait_cfg)
    p_ref_body = to_body(foot_ref.position)
    v_ref_body = torch.einsum("...ji,...lj->...li", com.R, foot_ref.velocity)
    if _enabled(swing_vel_rescale):
        if swing_vel_rescale is True:
            v_ref_body = v_ref_body / gait_cfg.t_swing
        else:
            scale = torch.as_tensor(swing_vel_rescale, dtype=com.x.dtype,
                                    device=com.x.device)
            v_ref_body = v_ref_body * scale[..., None, None]
    q_ref = inverse_kinematics(p_ref_body, kin)
    jinv = leg_jacobian_inverse(q_ref, kin)
    qdot_ref = (jinv @ v_ref_body[..., None])[..., 0]
    tau_ff_inertia = None
    if swing_accel_ff:
        if swing_mass is None:
            raise ValueError(
                "swing_accel_ff needs swing_mass — pass "
                "sim.dynamics.leg_mass_matrices(model, joints.q)")
        t_n = swing_time_of_phase(gait.phase, gait_cfg)
        a_norm = sextic_accel(traj.coeffs, t_n)
        a_w = torch.where(traj.valid[..., None], a_norm, 0.0) / (
            gait_cfg.t_swing ** 2)
        a_body = torch.einsum("...ji,...lj->...li", com.R, a_w)
        qdd_ref = (jinv @ a_body[..., None])[..., 0]
        tau_ff_inertia = (swing_mass @ qdd_ref[..., None])[..., 0]

    # 7b. (extension, opt-in) Contact-aware stance gating.
    eff_stance = gait.in_stance
    if contact_gate:
        grounded = p_start[..., 2] < contact_gate
        eff_stance = torch.logical_and(gait.in_stance, grounded)
        end_state = sextic_track(traj.coeffs, torch.ones_like(gait.phase))
        end_pos = torch.where(traj.valid[..., None], end_state.position,
                              p_start)
        q_end = inverse_kinematics(to_body(end_pos), kin)
        gated = torch.logical_and(gait.in_stance, ~grounded)
        q_ref = torch.where(gated[..., None], q_end, q_ref)
        qdot_ref = torch.where(gated[..., None], 0.0, qdot_ref)

    # 8. Swing PD torques (commander_node.cpp:503-504).
    tau_swing = joint_pd_control(q_ref, qdot_ref, joints.q, joints.qdot,
                                 cfg.joint_control)
    if tau_ff_inertia is not None:
        tau_swing = tau_swing + tau_ff_inertia

    return CommanderPrecursors(
        feet_body=feet_body, standing=standing, gait_time=gait_time,
        walking=walking, gait=gait, eff_stance=eff_stance, R_d=R_d, x_d=x_d,
        xdot_d=xdot_d, w_d=w_d, plan=plan, traj=traj, foot_ref=foot_ref,
        q_ref=q_ref, qdot_ref=qdot_ref, tau_swing=tau_swing,
        p_start=p_start, ref_pose=new_ref, pose_cmd=new_pose_cmd,
    )


def mpc_precursors(com: ComState, gait_time, walking, eff_stance,
                   cmd_twist, cfg: ControlConfig, mpc_horizon: int,
                   mpc_dt: float, contact_gate: float = 0.0,
                   yaw_d=None):
    """MPC input assembly of ``commander_step(controller="mpc")`` (the
    unfused twin of the commander-pre kernel's MPC precursor block).

    Returns (xi0, xi_ref, yaw, stance_sched):
      xi0: (..., 13) [rpy, x, w_world, xdot_world, 1] SRB-MPC state;
      xi_ref: (..., N, 13) constant-twist reference
        (mpc/horizon.make_reference_trajectory);
      stance_sched: (..., N, 4) contact schedule sampled from the SAME gait
        clock that produced this tick's stance mask (step 0 equals
        gait.in_stance when walking); all-stance until the clock runs. With
        contact gating, step 0 carries the measured-contact gate.
    ``yaw_d``: the servoed desired yaw of ``heading_lead`` — seeds the
    reference's yaw instead of the measured one (the dynamics stay
    linearized at the measured yaw).
    """
    from quadruped_control_tpu_torch.mpc.horizon import (
        make_reference_trajectory,
    )

    dtype = com.x.dtype
    rpy = matrix_to_rpy(com.R)
    ones = torch.ones(com.x.shape[:-1] + (1,), dtype=dtype,
                      device=com.x.device)
    xi0 = torch.cat([rpy, com.x, com.w, com.xdot, ones], dim=-1)

    t0 = torch.clamp(gait_time, min=0.0)
    t_hor = t0[..., None] + mpc_dt * torch.arange(
        mpc_horizon, dtype=dtype, device=com.x.device)
    gait_hor = gait_at_time(t_hor, cfg.gait, dtype=dtype)
    stance_sched = torch.where(walking[..., None, None], gait_hor.in_stance,
                               True)
    if contact_gate:
        stance_sched = stance_sched.clone()
        stance_sched[..., 0, :] = stance_sched[..., 0, :] & eff_stance

    # Constant-twist reference from the command (zero twist: hold the
    # current (x, y, yaw) and drive to the stand height).
    cmd_eff = torch.where(walking[..., None], cmd_twist, 0.0)
    xi_seed = xi0
    if yaw_d is not None:
        xi_seed = _set(xi0, 2, torch.where(walking, yaw_d, xi0[..., 2]))
    xi_ref = make_reference_trajectory(xi_seed, cmd_eff, mpc_horizon, mpc_dt,
                                       target_height=cfg.stand.height)
    return xi0, xi_ref, rpy[..., 2], stance_sched


def commander_step(com: ComState, joints: JointState, carry: CommanderCarry,
                   cmd_twist, dt, cfg: ControlConfig,
                   qp_iterations: int = 15, qp_polish: bool = True,
                   qp_warm_start: bool = False, qp_backend: str = "jnp",
                   controller: str = "balance", mpc_horizon: int = 8,
                   mpc_dt: float = 0.05, mpc_iterations: int = 25,
                   mpc_backend: str = "structured", forces_override=None,
                   mpc_state_weights=None, weight_shift: float = 0.0,
                   contact_gate: float = 0.0,
                   raibert_cmd_symmetric: bool = False,
                   heading_hold: bool = False,
                   foothold_trim=None,
                   swing_vel_rescale: bool = False,
                   swing_accel_ff: bool = False,
                   swing_mass=None,
                   stance_pose=False,
                   swing_start_ground: bool = False,
                   body_frame_exact: bool = False,
                   gravity_comp_tau=None):
    """One control tick. All arguments broadcast over leading batch dims.

    Args:
      com, joints, carry, cmd_twist, dt, cfg: as
        :func:`commander_precursors`.
      qp_backend: "jnp" (the name the reference gives its batched IPM:
        here ``solver.ipm.solve_qp_ipm``; any batch, supports warm start) or
        "fused" (``solver.fused.solve_balance_qp_fused``: the CUDA kernel on
        CUDA tensors, its plain version on CPU tensors).
      controller: "balance" — the reference's single-step GRF QP
        (balance_controller.cpp:98-235); "mpc" — receding-horizon convex SRB
        MPC (Di Carlo et al. 2018, mpc/): the stance GRFs are f_0 of the
        horizon solve over the gait's scheduled contacts; the swing pipeline
        is the same.
      mpc_horizon / mpc_dt / mpc_iterations: horizon length N, MPC step
        (>= control dt; the schedule is sampled from the gait clock), and
        the IPM's iteration count for controller="mpc".
      mpc_backend: "condensed" (mpc/horizon, dense stacked QP),
        "structured" (O(N) Riccati IPM), or "riccati-pallas" (the MPC
        kernel, mpc/fused_riccati.solve_mpc_fused; any batch).
      mpc_state_weights: optional (13,) or (..., 13) MPC state-cost
        diagonal for every backend.
      forces_override: optional (..., 12) world-frame GRFs — skip the
        stance-force solve and apply these; the swing pipeline still runs.
      gravity_comp_tau: optional (..., 4, 3) leg gravity torques added to
        the commanded torques (stance AND swing) before clamping — e.g.
        ``sim.dynamics.leg_gravity_torques(model, joints.q, com.R)``.
    Returns:
      (CommanderOutput, CommanderCarry).
    """
    if controller not in ("balance", "mpc"):
        raise ValueError(f"controller must be 'balance'|'mpc': {controller}")
    if controller == "mpc" and mpc_backend not in _MPC_BACKENDS:
        raise ValueError(f"mpc_backend must be one of {_MPC_BACKENDS}: "
                         f"{mpc_backend}")
    if qp_backend not in ("jnp", "fused"):
        raise ValueError(f"qp_backend must be 'jnp'|'fused': {qp_backend}")
    dtype = com.x.dtype
    kin = cfg.kinematics

    pre = commander_precursors(
        com, joints, carry, cmd_twist, dt, cfg, weight_shift=weight_shift,
        contact_gate=contact_gate,
        raibert_cmd_symmetric=raibert_cmd_symmetric,
        heading_hold=heading_hold,
        foothold_trim=foothold_trim,
        swing_vel_rescale=swing_vel_rescale,
        swing_accel_ff=swing_accel_ff,
        swing_mass=swing_mass,
        stance_pose=stance_pose,
        swing_start_ground=swing_start_ground,
        body_frame_exact=body_frame_exact,
    )
    feet_body, gait, eff_stance = pre.feet_body, pre.gait, pre.eff_stance
    R_d, x_d, xdot_d, w_d = pre.R_d, pre.x_d, pre.xdot_d, pre.w_d
    batch = com.x.shape[:-1]

    # 9. Stance-force controller: the single-step balance QP (the
    #    reference's hot path, commander_node.cpp:507-508) or the
    #    receding-horizon MPC.
    forces_horizon = None
    if forces_override is not None:
        kw = dict(dtype=dtype, device=com.x.device)
        sol = IPMSolution(
            x=forces_override.to(dtype).expand(batch + (12,)),
            z=carry.qp_z, s=carry.qp_s, iterations=torch.as_tensor(0),
            gap=torch.zeros(batch, **kw),
            primal_residual=torch.zeros(batch, **kw),
            dual_residual=torch.zeros(batch, **kw),
            converged=torch.ones(batch, dtype=torch.bool,
                                 device=com.x.device),
        )
    elif controller == "mpc":
        F, sol = _mpc_solve(com, pre, carry, cmd_twist, cfg, mpc_horizon,
                            mpc_dt, mpc_iterations, mpc_backend,
                            mpc_state_weights, contact_gate, foothold_trim)
        forces_horizon = F.to(dtype)
    elif qp_backend == "fused":
        from quadruped_control_tpu_torch.solver.fused import (
            solve_balance_qp_fused,
        )

        sol = solve_balance_qp_fused(
            com.R, R_d, com.x, com.xdot, com.w, x_d, xdot_d, w_d, feet_body,
            eff_stance, cfg.balance, iterations=qp_iterations,
            polish=qp_polish,
        )
    else:
        qp = dyn.build_balance_qp(
            com.R, R_d, com.x, com.xdot, com.w, x_d, xdot_d, w_d, feet_body,
            eff_stance, cfg.balance,
        )
        # Warm-starting across ticks is opt-in. A leg that flipped
        # stance<->swing since the previous tick has its 6 cone rows'
        # carried (s, z) on the wrong side of the new bounds; those rows
        # cold-start while the unchanged rows keep the warm point.
        warm = reset = None
        if qp_warm_start:
            warm = (carry.qp_x, carry.qp_s, carry.qp_z)
            stance_changed = (
                gait.in_stance != carry.planner.prev_in_stance
            ) | ~carry.planner.initialized[..., None]
            reset = torch.repeat_interleave(stance_changed, 6, dim=-1)
        sol = solve_qp_ipm(qp.Q, qp.c, qp.G, qp.h, iterations=qp_iterations,
                           polish=qp_polish, tol=3e-5, warm_start=warm,
                           warm_reset_mask=reset)
    # The fused solve answers in float32 whatever the state's type.
    forces_body = dyn.forces_to_body_frame(sol.x.to(dtype), com.R, eff_stance)

    # 10. Stance torques tau = J^T f; merge by stance mask; clamp
    #     (commander_node.cpp:511-531).
    tau_stance = jacobian_transpose_control(joints.q, forces_body, kin)
    tau = torch.where(eff_stance[..., None], tau_stance, pre.tau_swing)
    if gravity_comp_tau is not None:
        tau = tau + gravity_comp_tau
    tau = torch.clamp(tau, cfg.balance.torque_min, cfg.balance.torque_max)

    new_carry = CommanderCarry(
        standing=pre.standing,
        gait_time=pre.gait_time,
        planner=PlannerState(
            prev_in_stance=pre.plan.prev_in_stance,
            initialized=pre.plan.initialized,
            traj=pre.traj,
        ),
        qp_x=sol.x.to(dtype),
        qp_s=sol.s.to(dtype),
        qp_z=sol.z.to(dtype),
        ref_pose=pre.ref_pose,
        pose_cmd=pre.pose_cmd,
    )
    out = CommanderOutput(
        torques=tau,
        forces_body=forces_body.to(dtype),
        forces_world=sol.x.to(dtype),
        gait=gait,
        foot_refs_world=pre.foot_ref.position,
        swing_q_ref=pre.q_ref,
        qp_converged=sol.converged,
        forces_horizon=forces_horizon,
    )
    return out, new_carry


def _mpc_solve(com, pre, carry, cmd_twist, cfg, mpc_horizon, mpc_dt,
               mpc_iterations, mpc_backend, mpc_state_weights, contact_gate,
               foothold_trim):
    """controller="mpc": the horizon solve of one of the three backends.
    Returns (F (..., N, 12), IPMSolution whose x is f_0 and whose s, z are
    the carry's QP triple, untouched)."""
    hl = (getattr(foothold_trim, "heading_lead", 0.0)
          if foothold_trim is not None else 0.0)
    yaw_d = None
    if not (isinstance(hl, float) and hl == 0.0):
        # The servoed desired yaw of commander_precursors' heading_lead
        # block (R_d is a pure-z rotation there).
        yaw_d = torch.atan2(pre.R_d[..., 1, 0], pre.R_d[..., 0, 0])
    xi0, xi_ref, yaw, sched = mpc_precursors(
        com, pre.gait_time, pre.walking, pre.eff_stance, cmd_twist, cfg,
        mpc_horizon, mpc_dt, contact_gate=contact_gate, yaw_d=yaw_d)
    args = (xi0, xi_ref, yaw, pre.p_start, com.x, sched, mpc_horizon, mpc_dt,
            cfg)
    if mpc_backend == "riccati-pallas":
        from quadruped_control_tpu_torch.mpc.fused_riccati import (
            solve_mpc_fused,
        )

        F, sol = solve_mpc_fused(*args, iterations=mpc_iterations,
                                 state_weights=mpc_state_weights)
    elif mpc_backend == "structured":
        from quadruped_control_tpu_torch.mpc.structured import (
            solve_mpc_structured,
        )

        F, sol = solve_mpc_structured(*args, iterations=mpc_iterations,
                                      state_weights=mpc_state_weights)
    else:
        from quadruped_control_tpu_torch.mpc.horizon import solve_mpc

        F, sol = solve_mpc(*args, iterations=mpc_iterations,
                           state_weights=mpc_state_weights)
    sol = sol._replace(x=F[..., 0, :], s=carry.qp_s, z=carry.qp_z)
    return F, sol
