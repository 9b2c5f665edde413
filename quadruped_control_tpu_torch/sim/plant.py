"""Torque-driven whole-body plant with compliant ground contact (counterpart
of ``quadruped_control_tpu/sim/plant.py``; the stand-in for the reference's
Drake simulation node, drake_interface_node.cpp).

A floating-base articulated robot on a halfspace ground with Coulomb
friction, driven ONLY by joint torques, stepped at a fine physics substep
inside each control tick.

Contact model (penalty/point contact):
  normal:     fz = max(0, k_n * phi + d_n * k_n * phi * phidot)
  tangential: anchor stiction (default) or regularized Coulomb,
              f_t = -mu * fz * v_t / max(|v_t|, v_s)
Contact points: the 4 feet plus 4 trunk-corner points so a fallen robot
rests on its body instead of falling through the world.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig
from quadruped_control_tpu_torch.math.rotations import so3_exp
from quadruped_control_tpu_torch.ops.kinematics import (
    forward_kinematics,
    leg_jacobian,
)
from quadruped_control_tpu_torch.sim.dynamics import (
    mass_matrix,
    precompute_leg_kinematics,
    prefactor_mass_matrix,
    rnea_bias,
    solve_prefactored,
)
from quadruped_control_tpu_torch.sim.model import WholeBodyModel
from quadruped_control_tpu_torch.types import ComState, JointState


@dataclasses.dataclass(frozen=True)
class ContactConfig:
    """Compliant contact + integration parameters (physics.yaml analogue).

    Tangential model ``"anchor"`` (default) is spring-damper stiction to a
    per-point contact anchor, clamped to the friction cone with the anchor
    sliding on saturation — true static friction. ``"coulomb"`` is
    velocity-regularized Coulomb: simpler and stateless, but effectively
    viscous below ``stiction_velocity``.
    """

    stiffness: float = 3.0e4  # N/m (~1 mm static penetration per 30 N)
    dissipation: float = 1.0  # s/m, Hunt-Crossley style
    mu: float = 0.8  # ground Coulomb friction (physics.yaml / config)
    tangential: str = "anchor"  # "anchor" | "coulomb"
    tangent_stiffness: float = 1.2e4  # N/m anchor spring
    tangent_damping: float = 80.0  # N*s/m
    stiction_velocity: float = 0.05  # m/s ("coulomb" regularization)
    substep_dt: float = 1.0e-4  # physics step (physics.yaml:6, 0.1 ms)
    trunk_contact_z: float = -0.05  # trunk corner points below hip plane


class WholeBodyState(NamedTuple):
    """Floating-base maximal state: base pose + generalized velocity.
    ``anchor`` is the per-contact-point tangential stiction anchor (world
    xy); it resets to the point's current position whenever the point is
    airborne."""

    R: torch.Tensor  # (..., 3, 3) world-from-base
    x: torch.Tensor  # (..., 3) base origin in world
    u: torch.Tensor  # (..., 18) [omega_b, v_b (base coords), qdot (12)]
    q: torch.Tensor  # (..., 4, 3) joint angles
    anchor: torch.Tensor  # (..., 8, 2) tangential contact anchors


def init_whole_body_state(cfg: ControlConfig, batch_shape=(),
                          dtype=torch.float32, height=None,
                          q0=(0.0, 1.61, -2.78),
                          contact: Optional[ContactConfig] = None,
                          device=None) -> WholeBodyState:
    """Laying pose (mit_cheetah_config.yaml:8,43): init joints, base resting
    so the lowest contact point just touches the ground."""
    contact = contact or ContactConfig()
    device = resolve_device(device)
    batch_shape = tuple(batch_shape)
    kw = dict(dtype=dtype, device=device)
    q = torch.tensor(q0, **kw).expand(batch_shape + (4, 3)).contiguous()
    feet_body = forward_kinematics(q, cfg.kinematics)
    lowest = torch.min(feet_body[..., 2], dim=-1).values
    h0 = -lowest if height is None else torch.as_tensor(height, **kw)
    x = torch.zeros(batch_shape + (3,), **kw)
    x[..., 2] = h0.expand(batch_shape)
    R = torch.eye(3, **kw).expand(batch_shape + (3, 3)).contiguous()
    u = torch.zeros(batch_shape + (18,), **kw)
    pts_b = _contact_points_body(q, cfg, contact)
    anchor = (pts_b + x[..., None, :])[..., :2].contiguous()
    return WholeBodyState(R=R, x=x, u=u, q=q, anchor=anchor)


def whole_body_com_state(state: WholeBodyState, cfg: ControlConfig):
    """What the controller 'measures': base pose published as the CoM state
    (the reference does the same, drake_interface_node.cpp:340-359)."""
    R, x, u, q = state.R, state.x, state.u, state.q
    w_world = (R @ u[..., :3, None])[..., 0]
    xdot_world = (R @ u[..., 3:6, None])[..., 0]
    com = ComState(R=R, x=x, xdot=xdot_world, w=w_world)
    qdot = u[..., 6:].reshape(u.shape[:-1] + (4, 3))
    return com, JointState(q=q, qdot=qdot)


def _contact_points_body(state_q, cfg: ControlConfig,
                         contact: ContactConfig):
    """Body-frame contact points (..., 8, 3): 4 feet then 4 trunk corners."""
    feet = forward_kinematics(state_q, cfg.kinematics)
    corners = cfg.kinematics.hip_offsets(feet.dtype, device=feet.device)
    corners = corners.clone()
    corners[..., 2] += contact.trunk_contact_z
    return torch.cat([feet, corners.expand(feet.shape)], dim=-2)


def _contact_forces_world(p_w, v_w, anchor, contact: ContactConfig):
    """Compliant normal + stiction-capable tangential friction, per point.

    p_w, v_w: (..., P, 3) world positions/velocities of contact points;
    anchor: (..., P, 2) tangential stiction anchors (world xy).
    Returns ((..., P, 3) world forces on the robot, updated anchors).
    """
    phi = -p_w[..., 2]  # penetration depth
    phidot = -v_w[..., 2]
    fn = contact.stiffness * phi * (1.0 + contact.dissipation * phidot)
    fn = torch.where(phi > 0.0, torch.clamp(fn, min=0.0), 0.0)

    vt = v_w[..., :2]
    p_xy = p_w[..., :2]
    in_contact = phi > 0.0
    ft_max = contact.mu * fn
    if contact.tangential == "anchor":
        kt = contact.tangent_stiffness
        ct = contact.tangent_damping
        ft_raw = -kt * (p_xy - anchor) - ct * vt
        ft_norm = torch.sqrt(torch.sum(ft_raw * ft_raw, dim=-1) + 1e-16)
        scale = torch.clamp(ft_max / ft_norm, max=1.0)
        ft = torch.where(in_contact[..., None], scale[..., None] * ft_raw,
                         0.0)
        # Anchor consistency: a' = p + (ft + ct*v)/kt keeps the spring
        # exactly at the (possibly cone-clamped) force — no-op while
        # sticking, slides the anchor while slipping; airborne resets.
        anchor_new = torch.where(
            in_contact[..., None], p_xy + (ft + ct * vt) / kt, p_xy
        )
    else:
        speed = torch.sqrt(torch.sum(vt * vt, dim=-1) + 1e-16)
        scale = ft_max / torch.clamp(speed, min=contact.stiction_velocity)
        ft = -scale[..., None] * vt
        anchor_new = p_xy
    return torch.cat([ft, fn[..., None]], dim=-1), anchor_new


def substep(s: WholeBodyState, tau_flat, h: float, model: WholeBodyModel,
            cfg: ControlConfig, contact: ContactConfig,
            factor=None) -> WholeBodyState:
    """One physics substep of length ``h`` under joint torques ``tau_flat``
    (..., 12). ``factor``: a prefactored mass matrix held across the tick,
    or None to factor M(q) at the current state."""
    R, x, u, q, anchor = s
    dtype = x.dtype
    batch = tuple(x.shape[:-1])
    kin = precompute_leg_kinematics(model, q)
    base_v = u[..., :6]
    qdot = u[..., 6:].reshape(batch + (4, 3))
    bias = rnea_bias(model, kin, R, base_v, qdot)
    if factor is None:
        factor = prefactor_mass_matrix(mass_matrix(model, kin, batch, dtype))

    # Contact kinematics (world frame).
    pts_b = _contact_points_body(q, cfg, contact)  # (..., 8, 3)
    p_w = torch.einsum("...ij,...pj->...pi", R, pts_b) + x[..., None, :]
    w_b = u[..., :3]
    v_b = u[..., 3:6]
    J_leg = leg_jacobian(q, cfg.kinematics)  # (..., 4, 3, 3)
    v_pts_b = v_b[..., None, :] + torch.linalg.cross(
        w_b[..., None, :].expand(pts_b.shape), pts_b)
    v_feet_joint = (J_leg @ qdot[..., None])[..., 0]  # (..., 4, 3)
    v_pts_b = torch.cat(
        [v_pts_b[..., :4, :] + v_feet_joint, v_pts_b[..., 4:, :]], dim=-2)
    v_w = torch.einsum("...ij,...pj->...pi", R, v_pts_b)

    f_w, anchor_new = _contact_forces_world(p_w, v_w, anchor, contact)
    f_b = torch.einsum("...ji,...pj->...pi", R, f_w)

    # Generalized contact force: tau_w = p x f, tau_v = f,
    # tau_leg = J^T f (feet only).
    g_w = torch.sum(torch.linalg.cross(pts_b, f_b), dim=-2)
    g_v = torch.sum(f_b, dim=-2)
    g_leg = (J_leg.transpose(-1, -2) @ f_b[..., :4, :, None])[..., 0]
    g_contact = torch.cat([g_w, g_v, g_leg.reshape(batch + (12,))], dim=-1)

    damping = model.joint_damping.reshape(12).to(dtype=dtype, device=x.device)
    g_applied = torch.cat(
        [torch.zeros(batch + (6,), dtype=dtype, device=x.device),
         tau_flat - damping * u[..., 6:]], dim=-1)

    rhs = g_applied + g_contact - bias
    udot = solve_prefactored(factor, rhs)

    # Semi-implicit Euler: velocity first, then pose. Two-stage guard
    # against a fallen robot's explosive substep: (1) clamp generalized
    # velocities to a far-beyond-envelope bound (200; the trot peaks
    # |u| < 30); (2) if a substep still produces a non-finite value, FREEZE
    # that instance at its last finite state with zeroed velocity — one
    # crashed scenario can never poison a batched sweep. torch.clamp passes
    # a NaN through, which stage 2 then catches.
    u_new = torch.clamp(u + h * udot, -200.0, 200.0)
    w_new = u_new[..., :3]
    v_new = u_new[..., 3:6]
    x_new = x + h * (R @ v_new[..., None])[..., 0]
    R_new = R @ so3_exp(w_new * h)
    q_new = q + h * u_new[..., 6:].reshape(batch + (4, 3))
    ok = (
        torch.isfinite(u_new).all(-1)
        & torch.isfinite(x_new).all(-1)
        & torch.isfinite(R_new).flatten(-2).all(-1)
        & torch.isfinite(q_new).flatten(-2).all(-1)
        & torch.isfinite(anchor_new).flatten(-2).all(-1)
    )
    okv = ok[..., None]
    return WholeBodyState(
        R=torch.where(okv[..., None], R_new, R),
        x=torch.where(okv, x_new, x),
        u=torch.where(okv, u_new, torch.zeros_like(u)),
        q=torch.where(okv[..., None], q_new, q),
        anchor=torch.where(okv[..., None], anchor_new, anchor),
    )


def whole_body_step(state: WholeBodyState, tau, dt,
                    model: WholeBodyModel, cfg: ControlConfig,
                    contact: ContactConfig = ContactConfig(),
                    n_substeps: Optional[int] = None,
                    m_update: str = "substep") -> WholeBodyState:
    """Advance the articulated plant by one control period ``dt``.

    Args:
      tau: (..., 4, 3) joint torques, held constant over the period.
      n_substeps: physics substeps (default: round(dt / contact.substep_dt)).
      m_update: "substep" recomputes the mass matrix every physics substep;
        "tick" computes + prefactors M(q) once per control period and holds
        it across substeps (what the closed-loop rollouts use). Contact
        kinematics and bias forces always use the current substep state.
    """
    if m_update not in ("substep", "tick"):
        raise ValueError(f"m_update must be 'substep'|'tick': {m_update}")
    if n_substeps is None:
        n_substeps = max(1, int(round(dt / contact.substep_dt)))
    h = dt / n_substeps
    dtype = state.x.dtype
    tau_flat = tau.reshape(tau.shape[:-2] + (12,)).to(dtype)

    factor0 = None
    if m_update == "tick":
        kin0 = precompute_leg_kinematics(model, state.q)
        M0 = mass_matrix(model, kin0, state.x.shape[:-1], dtype)
        factor0 = prefactor_mass_matrix(M0)

    for _ in range(n_substeps):
        state = substep(state, tau_flat, h, model, cfg, contact,
                        factor=factor0)
    return state
