"""Typed configuration (replacement for the rosparam/YAML layer).

The reference loads every gain/mass/timing from YAML through the ROS
parameter server (commander_node.cpp:239-334, mit_cheetah_config.yaml). Here
the same values live in frozen dataclasses that hash; they are field for
field the presets of ``quadruped_control_tpu.config``. Array-valued fields
are materialized on demand as torch tensors (``dtype=``, ``device=``; the
default device is ``cuda``) or, by the ``*_np`` twins, as float64 NumPy.

Leg axis order everywhere: ``[RL, FL, RR, FR]`` (index 0..3) — the
reference's canonical order (commander_node.cpp:61).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from quadruped_control_tpu_torch import resolve_device


def _tensor(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=resolve_device(device))


LEG_NAMES: Tuple[str, str, str, str] = ("RL", "FL", "RR", "FR")
NUM_LEGS = 4
NUM_JOINTS = 12
GRAVITY = 9.81


@dataclasses.dataclass(frozen=True)
class KinematicsConfig:
    """Leg geometry (reference kinematics.cpp:19-47).

    ``hip_x/hip_y``: base->hip offsets; signs per leg follow the reference:
    RL=(-x,+y), FL=(+x,+y), RR=(-x,-y), FR=(+x,-y). ``l1`` flips sign for
    right legs (left_links vs right_links, kinematics.cpp:41-42).
    """

    hip_x: float = 0.196
    hip_y: float = 0.050
    hip_z: float = 0.0
    l1: float = 0.077
    l2: float = 0.211
    l3: float = 0.230

    def hip_offsets(self, dtype=torch.float32, device=None):
        """(4, 3) base->hip translation per leg, [RL, FL, RR, FR]."""
        x, y, z = self.hip_x, self.hip_y, self.hip_z
        return _tensor(
            [[-x, y, z], [x, y, z], [-x, -y, z], [x, -y, z]], dtype, device)

    def hip_offsets_np(self) -> np.ndarray:
        """float64 NumPy twin of ``hip_offsets`` for host-side snapshots
        (kernel constant baking)."""
        x, y, z = self.hip_x, self.hip_y, self.hip_z
        return np.array(
            [[-x, y, z], [x, y, z], [-x, -y, z], [x, -y, z]], dtype=np.float64
        )

    def l1_signed(self, dtype=torch.float32, device=None):
        """(4,) l1 with the left/right sign convention (left +, right -)."""
        return _tensor([self.l1, self.l1, -self.l1, -self.l1], dtype, device)

    def l1_signed_np(self) -> np.ndarray:
        """float64 NumPy twin of ``l1_signed`` (host-side snapshots)."""
        return np.array([self.l1, self.l1, -self.l1, -self.l1], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class GaitConfig:
    """Gait timing (mit_cheetah_config.yaml:16-20, gait.cpp:36-46)."""

    t_stance: float = 0.8
    t_swing: float = 0.18
    swing_height: float = 0.08
    offsets: Tuple[float, float, float, float] = (0.0, 0.5, 0.5, 0.0)

    @property
    def period(self) -> float:
        return self.t_stance + self.t_swing

    @property
    def stance_phase(self) -> float:
        """Fraction of the cycle in stance (gait.cpp:45)."""
        return self.t_stance / self.period

    def offsets_array(self, dtype=torch.float32, device=None):
        return _tensor(self.offsets, dtype, device)


@dataclasses.dataclass(frozen=True)
class FootPlannerConfig:
    """Raibert foothold heuristic constants (foot_planner.cpp:22-42)."""

    k: float = 0.01
    hip_x: float = 0.196
    hip_y: float = 0.127
    hip_z: float = 0.0
    gravity: float = GRAVITY

    def hip_offsets(self, dtype=torch.float32, device=None):
        x, y, z = self.hip_x, self.hip_y, self.hip_z
        return _tensor(
            [[-x, y, z], [x, y, z], [-x, -y, z], [x, -y, z]], dtype, device)

    def hip_offsets_np(self) -> np.ndarray:
        """float64 NumPy twin (host-side snapshots)."""
        x, y, z = self.hip_x, self.hip_y, self.hip_z
        return np.array(
            [[-x, y, z], [x, y, z], [-x, -y, z], [x, -y, z]], dtype=np.float64
        )


@dataclasses.dataclass(frozen=True)
class FootholdTrimConfig:
    """Foothold-level heading/station regulation (opt-in extension; no
    reference equivalent — this is the PILOT ANALOGUE).

    The reference re-anchors its desired pose to the MEASURED pose every
    tick (commander_node.cpp:399-412), so heading/cross-track drift is
    never regulated; its backward/sideways demos are stabilized by the
    human on the PS4 pad (teleop_ps4_walking.yaml). This regulator closes
    the same loop the way a pilot does — through WHERE THE FEET GO, not by
    demanding GRF yaw moments the diagonal-support trot cannot deliver
    (the measured failure of ``heading_hold``, PARITY.md "Reverse-walking
    anatomy"):

      - a carried reference pose (x, y, yaw) integrates the COMMANDED
        twist (cross-track projected so only heading/lateral error
        persists, like a pilot steering relative to the path);
      - the heading error rotates the planned foothold pattern about the
        CoM (``yaw_gain``, clamped to ``yaw_max``) — the body aligns its
        hips over the rotated feet during the next stance, steering
        through stance geometry;
      - the cross-track error shifts footholds laterally
        (``lat_gain``/``lat_vel_gain``, clamped to ``lat_max``) — the
        linear-inverted-pendulum pushes the CoM away from the feet, back
        toward the path.

    All corrections act at replan edges only (foothold placement), leaving
    the GRF/MPC force budget untouched.
    """

    yaw_gain: float = 0.8     # foothold-pattern rotation per rad of heading error
    yaw_max: float = 0.15     # clamp on the pattern rotation [rad]
    lat_gain: float = 0.35    # foothold shift per m of cross-track error
    lat_vel_gain: float = 0.05  # foothold shift per m/s of cross-track velocity
    lat_max: float = 0.04     # clamp on the lateral shift [m]
    # Capture-point coefficient for the Raibert LIP term. The reference
    # HALVES the classic capture gain (0.5 sqrt(z/g) xdot,
    # foot_planner.cpp:95-96 vs Pratt's sqrt(z/g)). Measured on the
    # full-physics reverse trot: BOOSTING it destabilizes (the velocity is
    # sampled at LIFT-OFF, ~120 deg out of phase with touchdown for the
    # gait-locked roll cycle) — keep 0.5 and use the roll-phase terms
    # below instead.
    capture_scale: float = 0.5
    # Roll-phase foothold reflex: lateral shift (along the body y axis)
    # = clip(roll_gain * roll + roll_vel_gain * roll_rate, +-roll_max),
    # sampled at the replan edge. Because footholds are planned one
    # swing-time before they act, a linear (roll, roll_rate) combination
    # can target the touchdown phase of the trot's gait-locked roll
    # oscillation — the damping instrument for the reverse-walking roll
    # pump. 0 = off.
    roll_gain: float = 0.0      # m per rad of roll
    roll_vel_gain: float = 0.0  # m per rad/s of body roll rate
    roll_max: float = 0.05      # clamp on the roll-reflex shift [m]
    # Absolute-heading desired-pose servo (round 5; VERDICT round-4 #2).
    # 0 = reference behavior: the desired yaw RE-ANCHORS to measured +
    # wz*dt every tick (commander_node.cpp:399-412), so commanded wz is
    # never servoed — measured: in-place turns run ~2x the commanded
    # rate (the gait's own yaw impulses are unopposed) and yaw is
    # absorbed entirely while walking. >0 = the desired yaw pulls toward
    # the SAME carried reference heading the foothold trim integrates
    # (``carry.ref_pose[..., 2]``), with the pull clamped to this many
    # rad beyond measured — so the GRF/MPC yaw moment and the foothold
    # pattern rotation servo ONE consistent heading. (The round-3
    # ``heading_hold`` probe failed with a similar lead but no foothold
    # channel and no round-4 operating point; the combination is what
    # works — see PARITY.md "Yaw authority".)
    heading_lead: float = 0.0   # rad of desired-yaw lead beyond measured


@dataclasses.dataclass(frozen=True)
class BalanceConfig:
    """Balance (GRF QP) controller gains and SRB parameters.

    Values from mit_cheetah_config.yaml:66-99 and commander_node.cpp:289-334.
    """

    mass: float = 11.0
    inertia_diag: Tuple[float, float, float] = (0.011253, 0.036203, 0.042673)
    mu: float = 0.8
    fz_min: float = 10.0
    fz_max: float = 120.0
    s_diag: Tuple[float, ...] = (1.0, 1.0, 1.0, 10.0, 10.0, 5.0)
    w_diag: float = 1e-5
    kff: Tuple[float, ...] = (0.0, 0.0, 0.15, 0.0, 0.0, 0.0)
    kp_p: Tuple[float, float, float] = (100.0, 100.0, 100.0)
    kd_p: Tuple[float, float, float] = (50.0, 50.0, 50.0)
    kp_w: Tuple[float, float, float] = (5000.0, 5000.0, 5000.0)
    kd_w: Tuple[float, float, float] = (500.0, 500.0, 500.0)
    torque_min: float = -20.0
    torque_max: float = 20.0
    # z-component of the gravity term added to xddot_d in the SRB b-vector.
    # The reference codes b = m (xddot_d + g) with g = (0, 0, -9.81)
    # (balance_controller.cpp:78, 265) — the OPPOSITE sign from [R1] Focchi
    # Eq. 5, partially compensated by the tuned kff z feedforward. Kept as
    # the parity default; the "physical" preset flips it (+9.81) and zeroes
    # kff so the closed-loop equilibrium sits exactly at the commanded
    # height under true rigid-body physics.
    gravity_z_term: float = -GRAVITY

    def inertia(self, dtype=torch.float32, device=None):
        return torch.diag(_tensor(self.inertia_diag, dtype, device))

    def S(self, dtype=torch.float32, device=None):
        return torch.diag(_tensor(self.s_diag, dtype, device))

    def W(self, dtype=torch.float32, device=None):
        return self.w_diag * torch.eye(
            NUM_JOINTS, dtype=dtype, device=resolve_device(device))


@dataclasses.dataclass(frozen=True)
class JointControlConfig:
    """Swing-leg joint PD gains (mit_cheetah_config.yaml:50-53)."""

    kff: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    kp: Tuple[float, float, float] = (40.0, 40.0, 50.0)
    kd: Tuple[float, float, float] = (1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class StandConfig:
    """Standing target (commander_node.cpp:353-354, 387)."""

    height: float = 0.26
    height_tolerance: float = 0.005


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Batched interior-point solver knobs (no reference equivalent — the
    reference warm-starts qpOASES's active set, balance_controller.cpp:
    177-202; the batched solver amortizes over instances instead)."""

    max_iterations: int = 25
    tolerance: float = 1e-7
    # Big-M bound the reference uses for the one-sided cone rows
    # (balance_controller.cpp:296-297). The IPM drops infinite rows instead.
    big_bound: float = 1.0e6


@dataclasses.dataclass(frozen=True)
class ControlConfig:
    """Top-level bundle: everything the commander node reads."""

    frequency: float = 300.0  # mit_cheetah_config.yaml:3
    cmd_integration_dt: float = 0.001  # commander_node.cpp:344
    kinematics: KinematicsConfig = KinematicsConfig()
    gait: GaitConfig = GaitConfig()
    foot_planner: FootPlannerConfig = FootPlannerConfig()
    balance: BalanceConfig = BalanceConfig()
    joint_control: JointControlConfig = JointControlConfig()
    stand: StandConfig = StandConfig()
    solver: SolverConfig = SolverConfig()


def mit_cheetah_config() -> ControlConfig:
    """The shipped MIT Mini Cheetah preset (mit_cheetah_config.yaml)."""
    return ControlConfig()


def mit_cheetah_physical_config() -> ControlConfig:
    """MIT Mini Cheetah preset with physically-consistent gravity handling.

    Fixes the reference's SRB gravity-sign slip (see
    ``BalanceConfig.gravity_z_term``) and removes the compensating kff z
    feedforward, so closed-loop rollouts on the SRB plant surrogate settle
    exactly at the commanded height. Use for demos/rollouts; use
    ``mit_cheetah_config`` for parity validation against the reference."""
    return ControlConfig(
        balance=BalanceConfig(
            kff=(0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
            gravity_z_term=GRAVITY,
        )
    )


def mit_cheetah_fast_trot_config() -> ControlConfig:
    """Physical preset with a running-trot gait (t_stance 0.3 / t_swing
    0.15, duty 0.67) for high-speed locomotion.

    The reference ships a slow walking trot (t_stance 0.8 / t_swing 0.18,
    duty 0.82 — mit_cheetah_config.yaml:16-20) whose long diagonal-support
    intervals destabilize laterally above ~0.22 m/s on the SRB surrogate.
    With this gait, the MPC controller (``controller="mpc"``) sustains
    commanded speeds up to ~1.5 m/s on the surrogate — past the reference's
    0.4 m/s Drake headline (README.md:56) — holding height within ~1 cm and
    lateral drift under 7 cm at 1.0 m/s."""
    base = mit_cheetah_physical_config()
    return dataclasses.replace(
        base, gait=dataclasses.replace(base.gait, t_stance=0.3,
                                       t_swing=0.15))


def mit_cheetah_whole_body_config() -> ControlConfig:
    """Operating point for the FULL-PHYSICS plant (sim/): the fast-trot
    gait with swing PD stiffened for real leg inertias (kp 80/80/100 vs
    the reference's 40/40/50, which tracks the 0.15 s sextic with 3-8 cm
    of lag on the articulated legs and lands late).

    Use with ``rollout_whole_body(..., controller="mpc",
    mpc_backend="structured", mpc_dt=0.03, gravity_comp=True)`` — the
    measured robust envelope of the reference package: stepping in place and
    0.2 m/s across every tested contact/integration variant, 0.4 m/s (the
    reference's published maximum, README.md:56) in most. The reference's
    own slow trot (duty 0.82) is marginally stable on full physics —
    see PARITY.md "Full-physics closed loop"."""
    base = mit_cheetah_fast_trot_config()
    return dataclasses.replace(
        base,
        joint_control=JointControlConfig(kp=(80.0, 80.0, 100.0),
                                         kd=(2.0, 2.0, 2.0)),
    )


@dataclasses.dataclass(frozen=True)
class TeleopLimits:
    """Commanded-twist scaling (the reference's PS4 teleop presets,
    teleop_ps4_walking.yaml:5-12 — these ARE the published walking-envelope
    numbers, README.md:56-63)."""

    vx: float = 0.20
    vy: float = 0.10
    wz: float = 0.05

    def clamp(self, twist):
        """Clamp a (..., 6) body twist to the teleop envelope."""
        lim = torch.tensor([self.vx, self.vy, 0.0, 0.0, 0.0, self.wz],
                           dtype=twist.dtype, device=twist.device)
        return torch.clamp(twist, -lim, lim)


def teleop_walking_limits() -> TeleopLimits:
    return TeleopLimits()


@dataclasses.dataclass(frozen=True)
class StanceTeleopLimits:
    """Stance-mode commanded-rate scaling (the reference's PS4 stance
    preset, teleop_ps4_stance.yaml:5-14: linear z scale 0.5, angular
    roll/pitch/yaw scale 0.5 — the body-posing demo envelope,
    media body_control.gif / stance.gif).

    In stance mode the twist channels are RATES of the desired body pose:
    ``vz`` moves the stand height, ``wx/wy/wz`` move desired
    roll/pitch/yaw (commander ``stance_pose`` option)."""

    vz: float = 0.5
    wx: float = 0.5
    wy: float = 0.5
    wz: float = 0.5

    def clamp(self, twist):
        """Clamp a (..., 6) stance-rate command to the teleop envelope."""
        lim = torch.tensor([0.0, 0.0, self.vz, self.wx, self.wy, self.wz],
                           dtype=twist.dtype, device=twist.device)
        return torch.clamp(twist, -lim, lim)


def teleop_stance_limits() -> StanceTeleopLimits:
    return StanceTeleopLimits()


@dataclasses.dataclass(frozen=True)
class StancePoseConfig:
    """Body-pose integrator limits for the commander's ``stance_pose``
    mode (the reference's stance body-posing demo genre: roll/pitch/yaw/
    height on the PS4 stance mapping, teleop_ps4_stance.yaml:5-14,
    media body_control.gif / stance.gif).

    Commanded rates integrate into a carried desired pose
    ``[roll, pitch, yaw, dz]`` (dz relative to ``StandConfig.height``),
    clamped to these bounds; the balance QP then tracks the posed
    ``R_d``/``x_d`` on all-stance support. Bounds sized to the Mini
    Cheetah's leg reach at the 0.26 m stand (0.30 m is near full
    extension; 0.18 m is the deep crouch the stand-up passes through)."""

    roll_max: float = 0.3
    pitch_max: float = 0.3
    yaw_max: float = 0.5
    dz_min: float = -0.08
    dz_max: float = 0.045


def srb_params_array(cfg: BalanceConfig, dtype=np.float64):
    """Pack SRB dynamics params as a flat numpy array for scenario dumps."""
    return np.array(
        [cfg.mass, *cfg.inertia_diag, cfg.mu, cfg.fz_min, cfg.fz_max], dtype=dtype
    )
