"""Batched spatial rigid-body dynamics for the floating 13-body tree
(counterpart of ``quadruped_control_tpu/sim/dynamics.py``).

Featherstone spatial-algebra Recursive Newton-Euler in link coordinates, with
the mass matrix assembled from unit-acceleration RNEA columns (``M e_i =
ID(q, 0, e_i)``; the 18 columns are one RNEA call with a leading column
axis). Everything is expressed on ``(...,)`` scenario batches; the four legs
are a vectorized axis, the 3-joint chains are unrolled Python loops.

Generalized coordinates (the floating-base convention):
  u = [omega_b (3, base coords), v_b (3, base-origin velocity, base
  coords), qdot (12, legs in [RL, FL, RR, FR] x [abad, thigh, knee])].

Spatial vectors are ``(omega, v)`` pairs; a coordinate transform from parent
to child is carried as ``(E, r)`` — child axes ``E`` (maps parent coords to
child coords) and child origin ``r`` in parent coords.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from quadruped_control_tpu_torch.config import GRAVITY
from quadruped_control_tpu_torch.math.rotations import skew as _skew
from quadruped_control_tpu_torch.sim.model import WholeBodyModel

NU = 18  # 6 base + 12 joint velocities


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _param(t, like):
    return t.to(dtype=like.dtype, device=like.device)


def _axis_rotation_T(axis, q):
    """E = R(axis, q)^T via Rodrigues — maps parent coords to child coords.
    axis: (..., 3) unit vector; q: (...,) angle."""
    a = _skew(axis)
    s = torch.sin(q)[..., None, None]
    c = torch.cos(q)[..., None, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return eye - s * a + (1.0 - c) * (a @ a)


class LegKinematics(NamedTuple):
    """Per-joint transforms for all four legs, precomputed from q.
    ``E[j]``: (..., 4, 3, 3) parent->child rotation of joint j; ``r[j]``:
    (..., 4, 3) joint origin in parent coords."""

    E: tuple
    r: tuple


def precompute_leg_kinematics(model: WholeBodyModel, q) -> LegKinematics:
    """q: (..., 4, 3) joint angles -> per-joint (E, r)."""
    Es, rs = [], []
    for j in range(3):
        axis = _param(model.joint_axes[:, j, :], q)
        Es.append(_axis_rotation_T(axis, q[..., :, j]))
        rs.append(_param(model.joint_offsets[:, j, :], q).expand(
            q.shape[:-2] + (4, 3)))
    return LegKinematics(E=tuple(Es), r=tuple(rs))


def _xform_motion(E, r, w, v):
    """(E, r) parent->child on a motion vector (w, v)."""
    return _mv(E, w), _mv(E, v - _cross(r, w))


def _xform_force_T(E, r, fw, fv):
    """Transpose (child->parent) on a force vector (fw, fv)."""
    Et = E.transpose(-1, -2)
    fv_p = _mv(Et, fv)
    fw_p = _mv(Et, fw) + _cross(r, fv_p)
    return fw_p, fv_p


def _spatial_inertia_apply(I_c, m, c, w, v):
    """Apply the spatial inertia (about the link-frame origin, COM offset c)
    to a motion vector: returns (h_ang, h_lin)."""
    cxw = _cross(c, w)
    h_ang = _mv(I_c, w) + m[..., None] * _cross(
        c, _cross(w, c)
    ) + m[..., None] * _cross(c, v)
    h_lin = m[..., None] * (v - cxw)
    return h_ang, h_lin


def rnea(model: WholeBodyModel, kin: LegKinematics, base_R, base_v, qdot,
         base_a, qddot, gravity: bool = True):
    """Inverse dynamics: generalized forces for the given motion.

    Args:
      kin: precomputed joint transforms (functions of q only).
      base_R: (..., 3, 3) world-from-base rotation (only used for gravity).
      base_v: (..., 6) base spatial velocity (omega, v) in base coords.
      qdot, qddot: (..., 4, 3).
      base_a: (..., 6) base spatial acceleration in base coords.
      gravity: include gravity (via the a0 = -g offset trick).
    Returns:
      tau: (..., 18) = [base wrench (ang, lin), joint torques (12)].
    """
    batch = torch.broadcast_shapes(base_v.shape[:-1], base_a.shape[:-1],
                                   qdot.shape[:-2], qddot.shape[:-2])

    w0 = base_v[..., :3]
    v0 = base_v[..., 3:]
    aw0 = base_a[..., :3]
    av0 = base_a[..., 3:]
    if gravity:
        g_base = GRAVITY * base_R.transpose(-1, -2)[..., :, 2]
        av0 = av0 + g_base  # a0 = base_a - g, g = (0,0,-9.81) world

    m_tr = _param(model.trunk_mass, qdot)
    I_tr = _param(model.trunk_inertia, qdot)
    # Trunk spatial momentum/force (COM at base origin: c = 0).
    hw0 = _mv(I_tr, w0)
    f0w = _mv(I_tr, aw0) + _cross(w0, hw0)
    f0v = m_tr * av0 + _cross(w0, m_tr * v0)

    def leg_bcast(x):
        return x[..., None, :].expand(batch + (4, 3))

    w_p, v_p = leg_bcast(w0), leg_bcast(v0)
    aw_p, av_p = leg_bcast(aw0), leg_bcast(av0)

    fs = []
    for j in range(3):
        E, r = kin.E[j], kin.r[j]
        axis = _param(model.joint_axes[:, j, :], qdot)
        qd = qdot[..., :, j, None]
        qdd = qddot[..., :, j, None]

        w_j, v_j = _xform_motion(E, r, w_p, v_p)
        aw_j, av_j = _xform_motion(E, r, aw_p, av_p)
        # Joint contribution: vJ = S qd (angular only), plus the velocity
        # product v_j x vJ.
        wJ = axis * qd
        w_new = w_j + wJ
        aw_j = aw_j + axis * qdd + _cross(w_new, wJ)
        av_j = av_j + _cross(v_j, wJ)
        w_j = w_new

        m = _param(model.link_mass[:, j], qdot)
        c = _param(model.link_com[:, j, :], qdot)
        I_c = _param(model.link_inertia[:, j], qdot)

        hw, hv = _spatial_inertia_apply(I_c, m, c, w_j, v_j)
        fw_a, fv_a = _spatial_inertia_apply(I_c, m, c, aw_j, av_j)
        fw = fw_a + _cross(w_j, hw) + _cross(v_j, hv)
        fv = fv_a + _cross(w_j, hv)

        fs.append((fw, fv))
        w_p, v_p = w_j, v_j
        aw_p, av_p = aw_j, av_j

    # Backward pass.
    tau_joints = []
    fw_child = torch.zeros(batch + (4, 3), dtype=qdot.dtype,
                           device=qdot.device)
    fv_child = torch.zeros_like(fw_child)
    for j in (2, 1, 0):
        fw = fs[j][0] + fw_child
        fv = fs[j][1] + fv_child
        axis = _param(model.joint_axes[:, j, :], qdot)
        tau_j = torch.sum(axis * fw, dim=-1)
        tau_j = tau_j + _param(model.armature[:, j], qdot) * qddot[..., :, j]
        tau_joints.append(tau_j)
        fw_child, fv_child = _xform_force_T(kin.E[j], kin.r[j], fw, fv)

    tau_joints = torch.stack(tau_joints[::-1], dim=-1)  # (..., 4, 3)
    f0w = f0w + torch.sum(fw_child, dim=-2)
    f0v = f0v + torch.sum(fv_child, dim=-2)

    return torch.cat(
        [f0w.expand(batch + (3,)), f0v.expand(batch + (3,)),
         tau_joints.reshape(batch + (12,))], dim=-1)


def rnea_bias(model: WholeBodyModel, kin: LegKinematics, base_R, base_v,
              qdot):
    """Bias force h(q, u): Coriolis/centrifugal + gravity (zero accel)."""
    return rnea(model, kin, base_R, base_v, qdot, torch.zeros_like(base_v),
                torch.zeros_like(qdot), gravity=True)


def mass_matrix(model: WholeBodyModel, kin: LegKinematics, batch_shape,
                dtype):
    """M(q): (..., 18, 18) from the 18 unit-acceleration RNEA columns."""
    batch_shape = tuple(batch_shape)
    device = kin.E[0].device
    kw = dict(dtype=dtype, device=device)
    nb = len(batch_shape)
    eye = torch.eye(NU, **kw).reshape((NU,) + (1,) * nb + (NU,))
    zeros6 = torch.zeros((1,) + batch_shape + (6,), **kw)
    zeros_q = torch.zeros((1,) + batch_shape + (4, 3), **kw)
    eyeR = torch.eye(3, **kw)
    base_a = eye[..., :6].expand((NU,) + batch_shape + (6,))
    qdd = eye[..., 6:].expand((NU,) + batch_shape + (12,)).reshape(
        (NU,) + batch_shape + (4, 3))
    cols = rnea(model, kin, eyeR, zeros6, zeros_q, base_a, qdd,
                gravity=False)  # (18, ..., 18)
    M = torch.movedim(cols, 0, -1)  # columns -> last axis
    return 0.5 * (M + M.transpose(-1, -2))


def total_mass(model: WholeBodyModel):
    return model.trunk_mass + torch.sum(model.link_mass)


def leg_mass_matrices(model: WholeBodyModel, q):
    """Per-leg (..., 4, 3, 3) joint-space mass matrices with the base held
    fixed — the D blocks of the floating-tree mass matrix. Feeds the
    commander's ``swing_accel_ff`` feedforward: tau_ff = D(q) qddot_ref."""
    kin = precompute_leg_kinematics(model, q)
    batch = tuple(q.shape[:-2])
    kw = dict(dtype=q.dtype, device=q.device)
    zeros6 = torch.zeros((1,) + batch + (6,), **kw)
    zeros_q = torch.zeros((1,) + batch + (4, 3), **kw)
    # One column per joint axis, the same axis on all 4 legs at once (legs
    # are independent blocks given a fixed base).
    basis = torch.eye(3, **kw).reshape((3,) + (1,) * len(batch) + (1, 3))
    qdd = basis.expand((3,) + batch + (4, 3))
    tau = rnea(model, kin, torch.eye(3, **kw), zeros6, zeros_q, zeros6, qdd,
               gravity=False)
    cols = tau[..., 6:].reshape((3,) + batch + (4, 3))
    D = torch.movedim(cols, 0, -1)  # (..., 4, 3row, 3col)
    return 0.5 * (D + D.transpose(-1, -2))


def leg_gravity_torques(model: WholeBodyModel, q, base_R):
    """Per-joint gravity torques of the legs alone: the joint rows of the
    bias at zero velocity, tau_g = dV_legs/dq. Used by the commander's
    optional gravity compensation."""
    kin = precompute_leg_kinematics(model, q)
    batch = tuple(q.shape[:-2])
    zeros6 = torch.zeros(batch + (6,), dtype=q.dtype, device=q.device)
    zeros_q = torch.zeros_like(q)
    tau = rnea(model, kin, base_R, zeros6, zeros_q, zeros6, zeros_q,
               gravity=True)
    return tau[..., 6:].reshape(batch + (4, 3))


def _inv3(m):
    """Closed-form (..., 3, 3) inverse via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = torch.stack(
        [
            torch.stack([A, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([B, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([C, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    return adj / det[..., None, None]


class MassFactor(NamedTuple):
    """Prefactored mass matrix (tree-sparsity Schur form), reusable across
    substeps within a control tick."""

    Dinv: torch.Tensor  # (..., 4, 3, 3) per-leg joint-block inverses
    Bl: torch.Tensor  # (..., 4, 6, 3) base-leg coupling
    BDinv: torch.Tensor  # (..., 4, 6, 3)
    Sinv: torch.Tensor  # (..., 6, 6) inverse base Schur complement


def prefactor_mass_matrix(M) -> MassFactor:
    """Factor M exploiting the floating-tree sparsity: the four leg chains
    couple only through the base, so ``M = [[A (6x6), B (6x12)], [B^T, D]]``
    with D block-diagonal in 4 per-leg 3x3 blocks. A Schur complement on the
    base block reduces a solve to 4 closed-form 3x3 inverses plus one 6x6
    inverse."""
    batch = tuple(M.shape[:-2])
    A = M[..., :6, :6]
    B = M[..., :6, 6:]
    Db = torch.stack(
        [M[..., 6 + 3 * l:9 + 3 * l, 6 + 3 * l:9 + 3 * l] for l in range(4)],
        dim=-3,
    )
    Dinv = _inv3(Db)  # (..., 4, 3, 3)
    Bl = B.reshape(batch + (6, 4, 3))
    Bl = torch.movedim(Bl, -2, -3)  # (..., 4, 6, 3)
    BDinv = Bl @ Dinv
    S = A - torch.einsum("...lij,...lkj->...ik", BDinv, Bl)
    Sinv = torch.linalg.inv(S)
    return MassFactor(Dinv=Dinv, Bl=Bl, BDinv=BDinv, Sinv=Sinv)


def solve_prefactored(f: MassFactor, rhs):
    """Solve M u = rhs with a :func:`prefactor_mass_matrix` factor."""
    batch = tuple(rhs.shape[:-1])
    r_b = rhs[..., :6]
    r_q = rhs[..., 6:].reshape(batch + (4, 3))
    rhs_b = r_b - torch.einsum("...lij,...lj->...i", f.BDinv, r_q)
    u_b = _mv(f.Sinv, rhs_b)
    u_q = _mv(f.Dinv, r_q - torch.einsum("...lji,...j->...li", f.Bl, u_b))
    return torch.cat([u_b, u_q.reshape(batch + (12,))], dim=-1)


def solve_mass_matrix(M, rhs):
    """One-shot tree-sparsity solve (factor + solve)."""
    return solve_prefactored(prefactor_mass_matrix(M), rhs)


def body_coms_world(model: WholeBodyModel, q, base_R, base_x):
    """World positions of all 13 body COMs.

    Returns:
      trunk_com: (..., 3); link_coms: (..., 4, 3, 3) [leg, joint, xyz].
    """
    batch = tuple(q.shape[:-2])
    B = torch.eye(3, dtype=q.dtype, device=q.device).expand(
        batch + (4, 3, 3))
    p = torch.zeros(batch + (4, 3), dtype=q.dtype, device=q.device)
    coms = []
    for j in range(3):
        axis = _param(model.joint_axes[:, j, :], q)
        # Link frame expressed in base coords: rotate by R(axis, q).
        Rj = _axis_rotation_T(axis, q[..., :, j]).transpose(-1, -2)
        r = _param(model.joint_offsets[:, j, :], q)
        p = p + _mv(B, r)
        B = B @ Rj
        c = _param(model.link_com[:, j, :], q)
        coms.append(p + _mv(B, c))
    link_coms_body = torch.stack(coms, dim=-2)  # (..., 4, 3, 3)
    link_coms_world = (
        torch.einsum("...ij,...lkj->...lki", base_R, link_coms_body)
        + base_x[..., None, None, :]
    )
    return base_x, link_coms_world
