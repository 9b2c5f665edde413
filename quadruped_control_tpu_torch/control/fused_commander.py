"""The commander tick's pre-QP stage as one kernel (K4), on the
structure-of-arrays ``(k, B)`` layout the GRF-QP kernel and the substep
kernel share (counterpart of
``quadruped_control_tpu/control/pallas_commander.py``).

One launch runs commander steps 1-9 — measurement, FK, the standing latch
and gait clock, desired pose, gait schedule, Raibert footholds, sextic replan
and tracking, IK, J^-1 with the damped fallback, swing PD, PD accelerations,
``so3_log``, the SRB right-hand side and the stance-masked levers — and emits
exactly the tensors the fused QP kernel consumes plus the swing torques and
the updated controller carry, so a whole-body closed-loop tick is three
launches (sim/fused_tick.py).

With ``mpc_horizon = N > 0`` the same launch also emits the MPC precursor
block (:func:`mpc_block_size` words per robot: xi0, the world levers, the
N-step stance schedule sampled from the gait clock, the constant-twist
reference) that the MPC kernel (mpc/fused_riccati.py, K6) consumes, so the
MPC tick is three launches too.

``commander_pre_plain`` is the plain PyTorch version of the kernel: the same
arithmetic on ``(k, B)`` tensors of any dtype. ``commander_pre_packed``
launches the CUDA kernel (csrc/qct_commander.cu) on CUDA tensors and runs the
plain version on CPU tensors.

Parity: reproduces control/commander.commander_precursors step for step,
including the reference quirks (world->body ``R^T p - x`` transform,
commander_node.cpp:491; the inverse-adjoint twist; the kff index-1 yaw
feedforward typo, balance_controller.cpp:137-139; the inclusive stance
boundary, gait.cpp:127). It has none of ``body_frame_exact``,
``heading_hold``, ``foothold_trim``, ``stance_pose``.

Unsupported: ``weight_shift`` (refused, as in the reference kernel).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import GRAVITY, ControlConfig
from quadruped_control_tpu_torch.mpc.fused_riccati import (  # noqa: F401
    mpc_block_size,  # re-exported: the block layout K4 writes
)
from quadruped_control_tpu_torch.ops.trajectory import _A_INV

# Component layouts (k axis of (k, B) tensors).
# State comps match sim/fused_substep: R 0:9 | x 9:12 | u 12:30 | q 30:42.
N_STATE_USED = 42
# Carry comps:
#   0 standing | 1 gait_time | 2:6 prev_in_stance | 6 initialized
#   7:91 traj coeffs [leg*21 + k*3 + axis] | 91:95 traj valid
N_CARRY = 95
C_STANDING, C_GAIT_TIME, C_PREV, C_INIT, C_COEF, C_VALID = 0, 1, 2, 6, 7, 91
N_CMD = 6

_TWO_PI = 2.0 * math.pi


class CommanderConsts:
    """Python-float snapshot of every constant the kernel takes (the CUDA
    launcher copies them into a by-value struct, kernels.CommanderParams)."""

    def __init__(self, cfg: ControlConfig, dt: float):
        kin = cfg.kinematics
        self.hips = kin.hip_offsets_np()
        self.l1s = [float(v) for v in kin.l1_signed_np()]
        self.l1 = float(kin.l1)
        self.l2 = float(kin.l2)
        self.l3 = float(kin.l3)
        self.sl2 = -float(kin.l2)
        self.sl3 = -float(kin.l3)
        self.left = [1.0, 1.0, -1.0, -1.0]  # ops/kinematics._LEFT_SIGN
        self.ik_sum = self.l1 * self.l1 + self.l2 * self.l2 + self.l3 * self.l3
        self.inv_ik_den = 1.0 / (2.0 * self.l2 * self.l3)

        self.dt = float(dt)
        self.dt_cmd = float(cfg.cmd_integration_dt)
        self.stand_h = float(cfg.stand.height)
        self.stand_tol = float(cfg.stand.height_tolerance)

        g = cfg.gait
        self.period = float(g.period)
        self.inv_period = 1.0 / self.period
        self.stance_phase = float(g.stance_phase)
        self.stance_thresh = float(g.stance_phase) + 1e-12  # ops/gait eps
        self.t_stance = float(g.t_stance)
        self.half_t_stance = self.t_stance / 2.0
        self.swing_height = float(g.swing_height)
        self.offsets = [float(v) for v in g.offsets]
        self.slope = 1.0 / (1.0 - float(g.stance_phase))
        self.intercept = 1.0 - self.slope

        fp = cfg.foot_planner
        self.fp_hips = fp.hip_offsets_np()
        self.fp_k = float(fp.k)
        self.fp_g = float(fp.gravity)
        self.inv_fp_g = 1.0 / self.fp_g

        jc = cfg.joint_control
        self.kp_j = [float(v) for v in jc.kp]
        self.kd_j = [float(v) for v in jc.kd]
        self.kff_j = [float(v) for v in jc.kff]

        bal = cfg.balance
        self.mass = float(bal.mass)
        self.inertia = [float(v) for v in bal.inertia_diag]
        self.kp_p = [float(v) for v in bal.kp_p]
        self.kd_p = [float(v) for v in bal.kd_p]
        self.kp_w = [float(v) for v in bal.kp_w]
        self.kd_w = [float(v) for v in bal.kd_w]
        self.kff = [float(v) for v in bal.kff]
        self.kff_mg = self.kff[2] * self.mass * GRAVITY
        self.gravity_z = float(bal.gravity_z_term)
        self.mu = float(bal.mu)
        self.fz_min = float(bal.fz_min)
        self.fz_max = float(bal.fz_max)
        self.tau_min = float(bal.torque_min)
        self.tau_max = float(bal.torque_max)

        self.a_inv = np.asarray(_A_INV)  # (7, 7); only cols 0:3 used
        self._params = {}

    def params(self, contact_gate: float, raibert_cmd_symmetric: bool,
               mpc_horizon: int = 0, mpc_dt: float = 0.0):
        """The kernel's by-value argument struct for these options."""
        key = (float(contact_gate), bool(raibert_cmd_symmetric),
               int(mpc_horizon), float(mpc_dt))
        if key not in self._params:
            self._params[key] = kernels.commander_params(self, *key)
        return self._params[key]


# ---------------------------------------------------------------------------
# Small 3-vector / 3x3 helpers on Python lists of (B,) tensors. The sums run
# left to right, as in the CUDA source.
# ---------------------------------------------------------------------------

def _mv(M, v):
    return [M[i][0] * v[0] + M[i][1] * v[1] + M[i][2] * v[2]
            for i in range(3)]


def _mtv(M, v):
    return [M[0][i] * v[0] + M[1][i] * v[1] + M[2][i] * v[2]
            for i in range(3)]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _adj3(M):
    """Adjugate and determinant of a 3x3 (ops/kinematics._adjugate_3x3)."""
    (a, b, c), (d, e, f), (g, h, i) = M
    A = e * i - f * h
    B = f * g - d * i
    C = d * h - e * g
    det = a * A + b * B + c * C
    adj = [[A, c * h - b * i, b * f - c * e],
           [B, a * i - c * g, c * d - a * f],
           [C, b * g - a * h, a * e - b * d]]
    return adj, det


def _so3_exp(aa, zero):
    """Rodrigues with math/rotations.so3_exp's branch semantics (Taylor
    series below 1e-8). Returns a 3x3 list."""
    t2 = aa[0] * aa[0] + aa[1] * aa[1] + aa[2] * aa[2]
    theta = torch.sqrt(t2)
    taylor = theta < 1e-8
    safe_t2 = torch.where(taylor, 1.0, t2)
    a = torch.where(taylor, 1.0 - t2 / 6.0,
                    torch.sin(theta) / torch.sqrt(safe_t2))
    b = torch.where(taylor, 0.5 - t2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe_t2)
    K = [[zero, -aa[2], aa[1]], [aa[2], zero, -aa[0]], [-aa[1], aa[0], zero]]
    R = [[None] * 3 for _ in range(3)]
    for i in range(3):
        for j in range(3):
            k2 = zero
            for m in range(3):
                k2 = k2 + K[i][m] * K[m][j]
            v = a * K[i][j] + b * k2
            if i == j:
                v = v + 1.0
            R[i][j] = v
    return R


def _so3_log(E, zero):
    """math/rotations.so3_log on a 3x3 list: the three regimes (small /
    generic / near pi) as masked dataflow with first-max tie-breaking."""
    tr = E[0][0] + E[1][1] + E[2][2]
    cos_t = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    # unskew(E - E^T) = 2 sin(theta) * axis.
    ws = [E[2][1] - E[1][2], E[0][2] - E[2][0], E[1][0] - E[0][1]]
    sin_t = 0.5 * torch.sqrt(ws[0] * ws[0] + ws[1] * ws[1] + ws[2] * ws[2])
    theta = torch.atan2(sin_t, cos_t)

    small = theta < 1e-7
    near_pi = theta > math.pi - 1e-2
    gen_scale = torch.where(
        small, 0.5 * (1.0 + theta * theta / 6.0),
        0.5 * theta / torch.where(small | near_pi, 1.0, sin_t))
    w_gen = [ws[i] * gen_scale for i in range(3)]

    # Near pi: dominant column of B = (R + R^T)/2 + (1 - tr)/2 * I.
    B = [[0.5 * (E[i][j] + E[j][i]) for j in range(3)] for i in range(3)]
    add = 0.5 * (1.0 - tr)
    for i in range(3):
        B[i][i] = B[i][i] + add
    d0, d1, d2 = B[0][0], B[1][1], B[2][2]
    pick0 = (d0 >= d1) & (d0 >= d2)  # argmax with first-max tie-breaking
    pick1 = (~pick0) & (d1 >= d2)
    axis = [torch.where(pick0, B[i][0], torch.where(pick1, B[i][1], B[i][2]))
            for i in range(3)]
    norm = torch.maximum(
        torch.sqrt(axis[0] * axis[0] + axis[1] * axis[1] + axis[2] * axis[2]),
        zero + 1e-12)
    axis = [axis[i] / norm for i in range(3)]
    dot_ws = axis[0] * ws[0] + axis[1] * ws[1] + axis[2] * ws[2]
    sgn_theta = torch.where(dot_ws < 0.0, -theta, theta)
    w_pi = [axis[i] * sgn_theta for i in range(3)]
    return [torch.where(near_pi, w_pi[i], w_gen[i]) for i in range(3)]


def _wrap_2pi(a):
    w = a - torch.floor(a / _TWO_PI) * _TWO_PI
    return torch.where(w < 0.0, w + _TWO_PI, w)


def _wrap_pi(a):
    shifted = a + math.pi
    w = shifted - torch.floor(shifted / _TWO_PI) * _TWO_PI
    w = torch.where(w < 0.0, w + _TWO_PI, w)
    return w - math.pi


def _ik(c: CommanderConsts, leg, p, zero):
    """Analytic leg IK (ops/kinematics.inverse_kinematics) for one leg;
    ``p`` is the hip-relative target."""
    x, y, z = p
    d = (x * x + y * y + z * z - c.ik_sum) * c.inv_ik_den
    d = torch.clamp(d, -1.0, 1.0)
    root = torch.sqrt(torch.maximum(y * y + z * z - c.l1 * c.l1, zero))
    neg_l1 = zero - c.l1
    if c.left[leg] > 0:
        q0 = -(torch.atan2(z, -y) + torch.atan2(root, neg_l1))
    else:
        q0 = torch.atan2(z, y) + torch.atan2(root, neg_l1)
    s2v = -torch.sqrt(torch.maximum(1.0 - d * d, zero))
    q2 = torch.atan2(s2v, d)
    q1 = -torch.atan2(x, root) - torch.atan2(c.l3 * s2v, c.l2 + c.l3 * d)
    return q0, q1, q2


def _jacobian(c: CommanderConsts, leg, s1, c1, s2, c2, s23, c23, zero):
    """Leg Jacobian rows (ops/kinematics.leg_jacobian)."""
    L1, sl2, sl3 = c.l1s[leg], c.sl2, c.sl3
    zl = sl2 * c2 + sl3 * c23
    xl = sl2 * s2 + sl3 * s23
    l3s23 = sl3 * s23
    return [[zero, zl, sl3 * c23],
            [-L1 * s1 - c1 * zl, xl * s1, l3s23 * s1],
            [L1 * c1 - s1 * zl, -(xl * c1), -(l3s23 * c1)]]


def commander_pre_plain(c: CommanderConsts, state, carry, cmd, *,
                        contact_gate: float = 0.0,
                        raibert_cmd_symmetric: bool = False,
                        mpc_horizon: int = 0, mpc_dt: float = 0.0):
    """The plain PyTorch version of the commander-pre kernel.

    Args:
      c: constants.
      state: (>= 42, B); carry: (95, B); cmd: (6, B); any float dtype.
      mpc_horizon / mpc_dt: N > 0 appends the MPC precursor block.
    Returns:
      (r (12,B), b (6,B), st (4,B), mu (1,B), fz_min (1,B), fz_max (1,B),
       tau_swing (12,B), carry (95,B), q_ref (12,B)) and, with N > 0, the
      MPC block (25 + 17 N, B).
    """
    R = [state[i] for i in range(9)]
    Rm = [R[0:3], R[3:6], R[6:9]]
    x = [state[9 + i] for i in range(3)]
    w_b = [state[12 + i] for i in range(3)]
    v_b = [state[15 + i] for i in range(3)]
    qd = [state[18 + i] for i in range(12)]
    q = [state[30 + i] for i in range(12)]
    zero = torch.zeros_like(x[0])
    one = zero + 1.0

    standing0 = carry[C_STANDING]
    gait_time0 = carry[C_GAIT_TIME]
    prev_st = [carry[C_PREV + l] for l in range(4)]
    initialized = carry[C_INIT]
    coef0 = [[[carry[C_COEF + leg * 21 + k * 3 + ax] for ax in range(3)]
              for k in range(7)] for leg in range(4)]
    valid0 = [carry[C_VALID + l] for l in range(4)]

    # Measurement (sim/plant.whole_body_com_state): world twist.
    w_w = _mv(Rm, w_b)
    xdot_w = _mv(Rm, v_b)

    # 1. FK (commander_node.cpp:383-384).
    sin = [torch.sin(q[i]) for i in range(12)]
    cos = [torch.cos(q[i]) for i in range(12)]
    feet_body = []
    for leg in range(4):
        s1, c1 = sin[leg * 3], cos[leg * 3]
        s2, c2 = sin[leg * 3 + 1], cos[leg * 3 + 1]
        s3, c3 = sin[leg * 3 + 2], cos[leg * 3 + 2]
        s23 = s2 * c3 + c2 * s3
        c23 = c2 * c3 - s2 * s3
        L1 = c.l1s[leg]
        hx, hy, hz = (float(v) for v in c.hips[leg])
        zl = c.sl2 * c2 + c.sl3 * c23
        feet_body.append([c.sl2 * s2 + c.sl3 * s23 + hx,
                          L1 * c1 - s1 * zl + hy,
                          L1 * s1 + c1 * zl + hz])

    # 2. Standing latch + gait clock (commander_node.cpp:387-391, 474-478).
    near = torch.abs(x[2] - c.stand_h) < c.stand_tol
    standing = torch.maximum(standing0, torch.where(near, one, zero))
    running = gait_time0 >= 0.0
    gait_time = torch.where(
        running, gait_time0 + c.dt,
        torch.where(standing > 0.5, zero, gait_time0))
    walking = gait_time >= 0.0

    # 3. Desired pose: integrate_twist_yaw (trajectory.cpp:29-69) under the
    #    walking mask, stand target otherwise.
    aa = [cmd[3 + i] * c.dt_cmd for i in range(3)]
    Rbbp = _so3_exp(aa, zero)
    v_dt = [cmd[i] * c.dt_cmd for i in range(3)]
    tbbp = _mv(Rbbp, v_dt)
    yaw = torch.atan2(R[3], R[0])  # atan2(R10, R00)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    Rdw = [[cy * Rbbp[0][j] - sy * Rbbp[1][j] for j in range(3)],
           [sy * Rbbp[0][j] + cy * Rbbp[1][j] for j in range(3)],
           [Rbbp[2][j] for j in range(3)]]
    xdw = [cy * tbbp[0] - sy * tbbp[1] + x[0],
           sy * tbbp[0] + cy * tbbp[1] + x[1]]

    # Vw = Ad(Twb) @ cmd with the reference's inverse-adjoint quirk
    # (rigid3d.cpp:259-271): lin = R^T (v - x x w), ang = R^T w.
    w_cmd = [cmd[3], cmd[4], cmd[5]]
    xw = _cross(x, w_cmd)
    delta = [cmd[i] - xw[i] for i in range(3)]
    Vw_lin = _mtv(Rm, delta)
    Vw_ang = _mtv(Rm, w_cmd)

    R_d = [[torch.where(walking, Rdw[i][j], one if i == j else zero)
            for j in range(3)] for i in range(3)]
    x_d = [torch.where(walking, xdw[0], zero),
           torch.where(walking, xdw[1], zero),
           zero + c.stand_h]  # height pinned in BOTH branches (:354, :407)
    xdot_d = [torch.where(walking, Vw_lin[i], zero) for i in range(3)]
    w_d = [torch.where(walking, Vw_ang[i], zero) for i in range(3)]

    # 4. Gait schedule (ops/gait.gait_at_time under the walking mask).
    t_gait = torch.maximum(gait_time, zero)
    in_stance, phase = [], []
    for leg in range(4):
        ph = c.offsets[leg] + t_gait * c.inv_period
        ph = ph - torch.floor(ph)
        in_stance.append((ph <= c.stance_thresh) | ~walking)
        phase.append(torch.where(walking, ph, zero))

    # 5. Foothold planning (ops/foot_planner.plan_footholds):
    #    replan = initialized ? (prev_stance & swing_now) : swing_now.
    init_m = initialized > 0.5
    replan = [~in_stance[leg] & ((prev_st[leg] > 0.5) | ~init_m)
              for leg in range(4)]
    pcom_foot = [_mv(Rm, feet_body[leg]) for leg in range(4)]
    v_sym = xdot_d if raibert_cmd_symmetric else xdot_w
    p_lin = [c.half_t_stance * v_sym[i] + c.fp_k * (xdot_w[i] - xdot_d[i])
             for i in range(3)]
    lip = 0.5 * torch.sqrt(torch.maximum(x[2], zero) * c.inv_fp_g)
    p_lip = [lip * xdot_w[i] for i in range(3)]
    foothold = []
    for leg in range(4):
        hip = [float(v) for v in c.fp_hips[leg]]
        tang = _cross(w_w, pcom_foot[leg])
        fh = []
        for i in range(2):
            hip_w = (Rm[i][0] * hip[0] + Rm[i][1] * hip[1]
                     + Rm[i][2] * hip[2] + x[i])
            fh.append(hip_w + (p_lin[i] + p_lip[i])
                      + c.half_t_stance * tang[i])
        # z projected to ground, then replan-masked.
        foothold.append([torch.where(replan[leg], fh[0], zero),
                         torch.where(replan[leg], fh[1], zero), zero])

    # 6. Swing-trajectory replan (ops/trajectory.plan_swing_trajectories):
    #    coeffs = A^-1 [p_start; p_final; p_center; 0...] — 3 products per
    #    coefficient since B rows 3-6 are zero.
    p_start = [[pcom_foot[leg][i] + x[i] for i in range(3)]
               for leg in range(4)]
    coef = [[[None] * 3 for _ in range(7)] for _ in range(4)]
    valid = []
    for leg in range(4):
        pc = [0.5 * (p_start[leg][0] + foothold[leg][0]),
              0.5 * (p_start[leg][1] + foothold[leg][1]),
              zero + c.swing_height]
        for ax in range(3):
            p0 = p_start[leg][ax]
            pf = foothold[leg][ax]
            for k in range(7):
                new = (float(c.a_inv[k, 0]) * p0 + float(c.a_inv[k, 1]) * pf
                       + float(c.a_inv[k, 2]) * pc[ax])
                coef[leg][k][ax] = torch.where(replan[leg], new,
                                               coef0[leg][k][ax])
        valid.append(torch.where(replan[leg], one,
                                 torch.where(valid0[leg] > 0.5, one, zero)))

    # 7. Swing references (ops/trajectory.reference_foot_states) + the
    #    world->body quirk transform + IK + J^-1 (commander steps 7-8).
    q_ref = [None] * 12
    qdot_ref = [None] * 12
    grounded = []
    for leg in range(4):
        t = torch.clamp(c.slope * phase[leg] + c.intercept, 0.0, 1.0)
        pw = [zero, zero, zero]
        vw = [zero, zero, zero]
        tp = one  # t^k
        for k in range(7):
            for ax in range(3):
                pw[ax] = pw[ax] + coef[leg][k][ax] * tp
            tp = tp * t
        tp = one  # t^(k-1) for the derivative
        for k in range(1, 7):
            for ax in range(3):
                vw[ax] = vw[ax] + float(k) * coef[leg][k][ax] * tp
            tp = tp * t
        vmask = valid[leg] > 0.5
        pw = [torch.where(vmask, pw[ax], zero) for ax in range(3)]
        vw = [torch.where(vmask, vw[ax], zero) for ax in range(3)]

        # p_b = R^T p_w - x (commander_node.cpp:491 quirk).
        rtp = _mtv(Rm, pw)
        hip = [float(v) for v in c.hips[leg]]
        p_rel = [rtp[i] - x[i] - hip[i] for i in range(3)]
        v_b_ref = _mtv(Rm, vw)
        q0v, q1v, q2v = _ik(c, leg, p_rel, zero)

        # Contact gating (opt-in): measured foot height of scheduled-stance
        # legs (see control/commander.py step 7b).
        if contact_gate:
            grounded.append(p_start[leg][2] < contact_gate)
            # End-of-swing target for gated legs: the sextic at t = 1 is the
            # plain coefficient sum.
            pe = [zero, zero, zero]
            for k in range(7):
                for ax in range(3):
                    pe[ax] = pe[ax] + coef[leg][k][ax]
            pe = [torch.where(vmask, pe[ax], p_start[leg][ax])
                  for ax in range(3)]
            rte = _mtv(Rm, pe)
            pe_rel = [rte[i] - x[i] - hip[i] for i in range(3)]
            qe0, qe1, qe2 = _ik(c, leg, pe_rel, zero)
            gated = in_stance[leg] & ~grounded[leg]
            q0v = torch.where(gated, qe0, q0v)
            q1v = torch.where(gated, qe1, q1v)
            q2v = torch.where(gated, qe2, q2v)

        # J^-1 at q_ref (ops/kinematics.leg_jacobian_inverse): adjugate
        # inverse with the damped-pinv singularity fallback.
        J = _jacobian(c, leg, torch.sin(q0v), torch.cos(q0v),
                      torch.sin(q1v), torch.cos(q1v),
                      torch.sin(q1v + q2v), torch.cos(q1v + q2v), zero)
        adj, det = _adj3(J)
        singular = torch.abs(det) <= 1e-8
        inv_det = 1.0 / torch.where(singular, one, det)
        JJt = [[J[i][0] * J[j][0] + J[i][1] * J[j][1] + J[i][2] * J[j][2]
                for j in range(3)] for i in range(3)]
        for i in range(3):
            JJt[i][i] = JJt[i][i] + 1e-6
        adj_d, det_d = _adj3(JJt)
        inv_det_d = 1.0 / det_d
        for i in range(3):
            # Row i of J^-1 = adj[i] * inv_det; damped row i of
            # J^T (JJt + lam)^-1 = sum_k J[k][i] * adj_d[k] * inv_det_d.
            acc_inv = ((adj[i][0] * inv_det) * v_b_ref[0]
                       + (adj[i][1] * inv_det) * v_b_ref[1]
                       + (adj[i][2] * inv_det) * v_b_ref[2])
            acc_d = zero
            for j2 in range(3):
                row = (J[0][i] * adj_d[0][j2] + J[1][i] * adj_d[1][j2]
                       + J[2][i] * adj_d[2][j2])
                acc_d = acc_d + (row * inv_det_d) * v_b_ref[j2]
            qdr = torch.where(singular, acc_d, acc_inv)
            if contact_gate:
                qdr = torch.where(gated, zero, qdr)
            qdot_ref[leg * 3 + i] = qdr
        q_ref[leg * 3], q_ref[leg * 3 + 1], q_ref[leg * 3 + 2] = q0v, q1v, q2v

    # 8. Swing PD (ops/joint_control.joint_pd_control, exact wrap chain).
    tau_swing = []
    for i in range(12):
        j = i % 3
        err = _wrap_pi(_wrap_2pi(q_ref[i]) - _wrap_2pi(q[i]))
        tau_swing.append(c.kp_j[j] * err
                         + c.kd_j[j] * (qdot_ref[i] - qd[i]) + c.kff_j[j])

    # Effective stance mask for the QP (gate applied if enabled).
    if contact_gate:
        eff_stance = [in_stance[leg] & grounded[leg] for leg in range(4)]
    else:
        eff_stance = in_stance

    # 9. QP precursors (ops/dynamics.pd_accelerations + srb_rhs + the
    #    stance-masked world levers).
    xddot_d = [c.kp_p[i] * (x_d[i] - x[i]) + c.kd_p[i] * (xdot_d[i] - xdot_w[i])
               for i in range(3)]
    xddot_d[0] = xddot_d[0] + c.kff[0] * xdot_d[0]
    xddot_d[1] = xddot_d[1] + c.kff[1] * xdot_d[1]
    xddot_d[2] = xddot_d[2] + c.kff_mg

    # R_error = R_d R^T -> so3_log (balance_controller.cpp:133-136).
    E = [[R_d[i][0] * Rm[j][0] + R_d[i][1] * Rm[j][1] + R_d[i][2] * Rm[j][2]
          for j in range(3)] for i in range(3)]
    logv = _so3_log(E, zero)
    wdot_d = [c.kp_w[i] * logv[i] + c.kd_w[i] * (w_d[i] - w_w[i])
              for i in range(3)]
    wdot_d[0] = wdot_d[0] + c.kff[3] * w_d[0]
    # Reference typo preserved: index 1 accumulates BOTH kff[4] and kff[5]
    # terms (balance_controller.cpp:137-139).
    wdot_d[1] = wdot_d[1] + c.kff[4] * w_d[1] + c.kff[5] * w_d[2]

    b_out = [c.mass * xddot_d[0], c.mass * xddot_d[1],
             c.mass * (xddot_d[2] + c.gravity_z)]
    # Iw = R diag(Ib) R^T; b_ang = Iw wdot_d + w_d x (Iw w_d).
    Iw = [[c.inertia[0] * (Rm[i][0] * Rm[j][0])
           + c.inertia[1] * (Rm[i][1] * Rm[j][1])
           + c.inertia[2] * (Rm[i][2] * Rm[j][2])
           for j in range(3)] for i in range(3)]
    Iw_wdot = _mv(Iw, wdot_d)
    cross_term = _cross(w_d, _mv(Iw, w_d))
    b_out += [Iw_wdot[i] + cross_term[i] for i in range(3)]

    r_out = [torch.where(eff_stance[leg], pcom_foot[leg][ax], zero)
             for leg in range(4) for ax in range(3)]

    carry_new = [None] * N_CARRY
    carry_new[C_STANDING] = standing
    carry_new[C_GAIT_TIME] = gait_time
    carry_new[C_INIT] = one
    for leg in range(4):
        carry_new[C_PREV + leg] = torch.where(in_stance[leg], one, zero)
        carry_new[C_VALID + leg] = valid[leg]
        for k in range(7):
            for ax in range(3):
                carry_new[C_COEF + leg * 21 + k * 3 + ax] = coef[leg][k][ax]

    st = [torch.where(eff_stance[leg], one, zero) for leg in range(4)]
    out = (torch.stack(r_out), torch.stack(b_out), torch.stack(st),
           (zero + c.mu)[None], (zero + c.fz_min)[None],
           (zero + c.fz_max)[None], torch.stack(tau_swing),
           torch.stack(carry_new), torch.stack(q_ref))
    if not mpc_horizon:
        return out

    # 10. MPC precursor block (control/commander.mpc_precursors): xi0, the
    #     world levers, the N-step stance schedule sampled from the SAME gait
    #     clock as this tick's stance mask, the constant-twist reference.
    #     Products mpc_dt * k are Python floats, rounded once.
    r20 = R[6]
    roll = torch.atan2(R[7], R[8])
    pitch = torch.atan2(-r20, torch.sqrt(torch.maximum(1.0 - r20 * r20,
                                                       zero)))
    xi0 = [roll, pitch, yaw, x[0], x[1], x[2]] + w_w + xdot_w + [one]
    mpc = list(xi0)
    for leg in range(4):
        mpc.extend(pcom_foot[leg])
    # All stance until the gait clock runs; with contact gating, step 0
    # carries the gated mask.
    for t in range(mpc_horizon):
        tk = t_gait + mpc_dt * t
        for leg in range(4):
            ph = c.offsets[leg] + tk * c.inv_period
            ph = ph - torch.floor(ph)
            stl = (ph <= c.stance_thresh) | ~walking
            if contact_gate and t == 0:
                stl = stl & eff_stance[leg]
            mpc.append(torch.where(stl, one, zero))
    # Constant-twist reference from cmd_eff = walking ? cmd : 0.
    vx = torch.where(walking, cmd[0], zero)
    vy = torch.where(walking, cmd[1], zero)
    wz = torch.where(walking, cmd[5], zero)
    for t in range(mpc_horizon):
        tt = mpc_dt * (t + 1)
        mpc.extend([zero, zero, yaw + tt * wz, x[0] + tt * vx,
                    x[1] + tt * vy, zero + c.stand_h, zero, zero, wz, vx, vy,
                    zero, one])
    return out + (torch.stack(mpc),)


def commander_pre_packed(state_p, carry_p, cmd_p, *, consts: CommanderConsts,
                         rows=None, contact_gate: float = 0.0,
                         raibert_cmd_symmetric: bool = False,
                         weight_shift: float = 0.0,
                         mpc_horizon: int = 0, mpc_dt: float = 0.0):
    """Run the commander-pre kernel (K4) on ``(k, B)`` tensors.

    ``state_p`` needs >= 42 leading comps laid out as in sim/fused_substep
    (the full 58-comp substep state works as-is). Returns (r, b, st, mu,
    fz_min, fz_max, tau_swing, carry, q_ref) and, with ``mpc_horizon = N >
    0``, the MPC precursor block (25 + 17 N, B) as a tenth tensor.

    CUDA tensors launch the kernel (one launch, counted in
    ``kernels.launch_counts["qct_commander_pre"]``); CPU tensors run
    :func:`commander_pre_plain`. ``rows`` is ignored (a tile height of the
    TPU kernel).
    """
    if weight_shift:
        raise ValueError("the commander-pre kernel does not support "
                         "weight_shift; use control.commander")
    if mpc_horizon < 0 or (mpc_horizon and not mpc_dt > 0.0):
        raise ValueError(f"mpc_horizon must be >= 0 and mpc_dt > 0 with it: "
                         f"{mpc_horizon}, {mpc_dt}")
    B = state_p.shape[1]
    if (state_p.dim() != 2 or state_p.shape[0] < N_STATE_USED
            or tuple(carry_p.shape) != (N_CARRY, B)
            or tuple(cmd_p.shape) != (N_CMD, B)):
        raise ValueError(
            f"expected state (>= {N_STATE_USED}, B), carry ({N_CARRY}, B), "
            f"cmd ({N_CMD}, B); got {tuple(state_p.shape)}, "
            f"{tuple(carry_p.shape)}, {tuple(cmd_p.shape)}")
    if state_p.device.type == "cpu":
        return commander_pre_plain(
            consts, state_p, carry_p, cmd_p, contact_gate=contact_gate,
            raibert_cmd_symmetric=raibert_cmd_symmetric,
            mpc_horizon=mpc_horizon, mpc_dt=mpc_dt)
    return kernels.commander_pre(
        state_p, carry_p, cmd_p,
        consts.params(contact_gate, raibert_cmd_symmetric, mpc_horizon,
                      mpc_dt))


def pack_comps(a, rows=None):
    """(B, k) -> contiguous (k, B). ``rows`` is ignored: nothing is padded."""
    return a.t().contiguous()


def unpack_comps(a):
    """(k, B) -> (B, k)."""
    return a.t()


def pack_commander_carry(carry, rows=None, batch=None):
    """control/commander.CommanderCarry (any batch shape) -> (95, B). Only
    the fields the fused path uses are packed (the QP warm-start triple,
    ``ref_pose`` and ``pose_cmd`` are dropped)."""
    dtype = carry.gait_time.dtype
    B = carry.gait_time.numel() if batch is None else int(batch)
    cols = [
        carry.standing.reshape(B, 1).to(dtype),
        carry.gait_time.reshape(B, 1),
        carry.planner.prev_in_stance.reshape(B, 4).to(dtype),
        carry.planner.initialized.reshape(B, 1).to(dtype),
        carry.planner.traj.coeffs.reshape(B, 4 * 7 * 3),
        carry.planner.traj.valid.reshape(B, 4).to(dtype),
    ]
    return pack_comps(torch.cat(cols, dim=-1))


def unpack_commander_carry(carry_p, batch_shape, template):
    """(95, B) carry -> CommanderCarry (QP triple, ``ref_pose`` and
    ``pose_cmd`` taken from ``template``)."""
    from quadruped_control_tpu_torch.control.commander import CommanderCarry
    from quadruped_control_tpu_torch.types import FootTrajCoeffs, PlannerState

    batch_shape = tuple(batch_shape)
    flat = unpack_comps(carry_p)

    def shp(a, tail=()):
        return a.reshape(batch_shape + tail)

    return CommanderCarry(
        standing=shp(flat[:, C_STANDING]) > 0.5,
        gait_time=shp(flat[:, C_GAIT_TIME]),
        planner=PlannerState(
            prev_in_stance=shp(flat[:, C_PREV:C_PREV + 4], (4,)) > 0.5,
            initialized=shp(flat[:, C_INIT]) > 0.5,
            traj=FootTrajCoeffs(
                coeffs=shp(flat[:, C_COEF:C_COEF + 84], (4, 7, 3)),
                valid=shp(flat[:, C_VALID:C_VALID + 4], (4,)) > 0.5,
            ),
        ),
        qp_x=template.qp_x, qp_s=template.qp_s, qp_z=template.qp_z,
        ref_pose=template.ref_pose, pose_cmd=template.pose_cmd,
    )
