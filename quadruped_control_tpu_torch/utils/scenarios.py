"""On-device scenario generators for the GRF QP benchmark suite.

Mirrors the reference's operating envelope (BASELINE configs 1-5): static
stance / laying-to-standing targets, body-pose tracking sweeps, trot contact
schedules, and domain-randomized SRB parameters. Everything is drawn from an
explicit ``torch.Generator`` directly on the target device, so
multi-million-instance batches never touch the host.

The distributions are those of ``quadruped_control_tpu.utils.scenarios``;
the random streams are not (a ``torch.Generator`` and a JAX key give
different numbers from the same seed), so parity tests hand both packages
NumPy-made inputs instead (``convert.scenarios_from_numpy``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig, mit_cheetah_config
from quadruped_control_tpu_torch.math.rotations import rpy_to_matrix
from quadruped_control_tpu_torch.ops import dynamics as dyn
from quadruped_control_tpu_torch.ops.kinematics import forward_kinematics

# Stance patterns: all-stance (configs 1-2), the two trot pairs (config 3).
_STANCE_PATTERNS = (
    (True, True, True, True),
    (True, False, False, True),
    (False, True, True, False),
)


class ScenarioBatch(NamedTuple):
    R: torch.Tensor
    R_d: torch.Tensor
    x: torch.Tensor
    xdot: torch.Tensor
    w: torch.Tensor
    x_d: torch.Tensor
    xdot_d: torch.Tensor
    w_d: torch.Tensor
    feet: torch.Tensor
    stance: torch.Tensor
    # Optional per-instance SRB randomization (config 5); None -> preset.
    mass: Optional[torch.Tensor] = None
    inertia_diag: Optional[torch.Tensor] = None
    mu: Optional[torch.Tensor] = None


def standing_feet(cfg: ControlConfig, dtype=torch.float32, device=None):
    """Feet at the reference init pose (mit_cheetah_config.yaml:43)."""
    device = resolve_device(device)
    q0 = torch.tensor([0.0, 1.61, -2.78], dtype=dtype,
                      device=device).repeat(4, 1)
    return forward_kinematics(q0, cfg.kinematics)


def grf_scenarios(generator: torch.Generator, batch: int,
                  cfg: ControlConfig = None, dtype=torch.float32,
                  device=None, randomize_params: bool = False
                  ) -> ScenarioBatch:
    """Mixed batch over configs 1-3 (+5 with randomize_params).

    ``generator`` must live on ``device`` (``torch.Generator(device=...)``);
    every draw is made there.
    """
    cfg = cfg or mit_cheetah_config()
    device = resolve_device(device)
    if torch.device(generator.device).type != device.type:
        raise ValueError(
            f"generator lives on {generator.device}, scenarios are asked "
            f"for on {device}: make the generator with "
            "torch.Generator(device=...) of the same device")
    kw = dict(dtype=dtype, device=device, generator=generator)

    def uniform(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, **kw)

    def normal(shape):
        return torch.randn(shape, **kw)

    feet0 = standing_feet(cfg, dtype, device)

    rpy = uniform((batch, 3), -0.25, 0.25)
    R = rpy_to_matrix(rpy)
    z = uniform((batch,), 0.08, 0.32)
    x = torch.zeros((batch, 3), dtype=dtype, device=device)
    x[..., 2] = z
    xdot = 0.3 * normal((batch, 3))
    w = 0.25 * normal((batch, 3))
    xdot_d = 0.2 * normal((batch, 3))
    w_d = 0.1 * normal((batch, 3))
    x_d = torch.zeros((batch, 3), dtype=dtype, device=device)
    x_d[..., 2] = cfg.stand.height
    feet = feet0 + 0.01 * normal((batch, 4, 3))
    pattern = torch.randint(0, 3, (batch,), device=device,
                            generator=generator)
    stance = torch.tensor(_STANCE_PATTERNS, dtype=torch.bool,
                          device=device)[pattern]
    eye = torch.eye(3, dtype=dtype, device=device).expand(batch, 3, 3)

    mass = inertia = mu = None
    if randomize_params:
        mass = cfg.balance.mass * uniform((batch,), 0.8, 1.2)
        inertia = torch.tensor(cfg.balance.inertia_diag, dtype=dtype,
                               device=device) * uniform((batch, 3), 0.8, 1.2)
        mu = uniform((batch,), 0.5, 1.0)

    return ScenarioBatch(
        R=R, R_d=eye, x=x, xdot=xdot, w=w, x_d=x_d, xdot_d=xdot_d, w_d=w_d,
        feet=feet, stance=stance, mass=mass, inertia_diag=inertia, mu=mu,
    )


def assemble_qp_batch(s: ScenarioBatch, cfg: ControlConfig = None):
    """ScenarioBatch -> QPData (the solver's input)."""
    cfg = cfg or mit_cheetah_config()
    return dyn.build_balance_qp(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, cfg.balance, mass=s.mass, inertia_diag=s.inertia_diag,
        mu=s.mu,
    )


def _so3_exp_np(w):
    theta = np.linalg.norm(w, axis=-1)[..., None, None]
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -w[..., 2], w[..., 1]
    K[..., 1, 0], K[..., 1, 2] = w[..., 2], -w[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -w[..., 1], w[..., 0]
    safe = np.where(theta < 1e-8, 1.0, theta)
    return (np.eye(3) + np.sin(safe) / safe * K
            + (1.0 - np.cos(safe)) / (safe * safe) * (K @ K))


def _feet_body_np(q, cfg: ControlConfig):
    kin = cfg.kinematics
    l1 = kin.l1_signed_np()
    s1, c1 = np.sin(q[..., 0]), np.cos(q[..., 0])
    s2, c2 = np.sin(q[..., 1]), np.cos(q[..., 1])
    s23, c23 = np.sin(q[..., 1] + q[..., 2]), np.cos(q[..., 1] + q[..., 2])
    hips = kin.hip_offsets_np()
    zl = -kin.l2 * c2 - kin.l3 * c23
    return np.stack([-kin.l2 * s2 - kin.l3 * s23 + hips[:, 0],
                     l1 * c1 - s1 * zl + hips[:, 1],
                     l1 * s1 + c1 * zl + hips[:, 2]], axis=-1)


def whole_body_walk_states(seed: int, batch: int, cfg: ControlConfig,
                           on_ground: bool = False,
                           trunk_contact_z: float = -0.05) -> dict:
    """Synthetic mid-walk whole-body states drawn with NumPy from ``seed``
    (float64 arrays; the two packages cannot share a random stream): base
    tilted ~0.15 rad, height 0.26 +- 0.02 m so that lanes sit on both sides
    of the standing latch, generalized velocities 0.5 sigma, joints around
    a walking pose, a trot command.

    ``on_ground=True`` instead sets each base height so that the lowest foot
    penetrates the ground by 0 to 2 mm (a state with moderate contact
    forces, for the plant). Keys: R (B,3,3), x (B,3), u (B,18), q (B,4,3),
    anchor (B,8,2), cmd (B,6).
    """
    rng = np.random.default_rng(seed)
    R = _so3_exp_np(0.15 * rng.standard_normal((batch, 3)))
    x = np.stack([0.1 * rng.standard_normal(batch),
                  0.1 * rng.standard_normal(batch),
                  0.26 + 0.02 * rng.standard_normal(batch)], axis=-1)
    u = 0.5 * rng.standard_normal((batch, 18))
    q = np.array([0.0, 1.0, -1.6]) + 0.3 * rng.standard_normal((batch, 4, 3))
    cmd = np.broadcast_to(np.array([0.2, 0.05, 0.0, 0.0, 0.0, 0.1]),
                          (batch, 6)).copy()
    feet = _feet_body_np(q, cfg)
    corners = cfg.kinematics.hip_offsets_np() + np.array(
        [0.0, 0.0, trunk_contact_z])
    pts = np.concatenate(
        [feet, np.broadcast_to(corners, (batch, 4, 3))], axis=1)
    pts_w = np.einsum("bij,bpj->bpi", R, pts)
    if on_ground:
        x[:, 2] = -pts_w[..., 2].min(axis=1) - 2e-3 * rng.uniform(size=batch)
    anchor = (pts_w + x[:, None, :])[..., :2] + 1e-3 * rng.standard_normal(
        (batch, 8, 2))
    return dict(R=R, x=x, u=u, q=q, anchor=anchor, cmd=cmd)


def commander_carry_walk(seed: int, batch: int, cfg: ControlConfig) -> dict:
    """Synthetic mid-walk commander carries drawn with NumPy from ``seed``,
    so that a few chained ticks cross the standing latch, the gait start and
    stance->swing edges: 70 % of the lanes stand, 5/7 of those have a running
    gait clock somewhere in the first three periods (the rest start theirs on
    the next tick), the planner's edge detector and trajectories are in a
    random state. Keys (the CommanderCarry / PlannerState / FootTrajCoeffs
    field names): standing (B,), gait_time (B,), prev_in_stance (B,4),
    initialized (B,), coeffs (B,4,7,3), valid (B,4)."""
    rng = np.random.default_rng(seed)
    standing = rng.uniform(size=batch) < 0.7
    running = standing & (rng.uniform(size=batch) < 5.0 / 7.0)
    gait_time = np.where(
        running, rng.uniform(0.0, 3.0 * cfg.gait.period, batch), -1.0)
    initialized = running & (rng.uniform(size=batch) < 0.8)
    prev_in_stance = rng.uniform(size=(batch, 4)) < 0.7
    valid = initialized[:, None] & (rng.uniform(size=(batch, 4)) < 0.8)
    # Plausible sextics: from a point near the ground to one ~10 cm ahead.
    p0 = np.stack([0.2 * rng.standard_normal((batch, 4)),
                   0.15 * rng.standard_normal((batch, 4)),
                   0.01 * rng.uniform(size=(batch, 4))], axis=-1)
    pf = p0 + np.stack([0.1 * rng.standard_normal((batch, 4)),
                        0.05 * rng.standard_normal((batch, 4)),
                        -p0[..., 2]], axis=-1)
    pc = 0.5 * (p0 + pf)
    pc[..., 2] = cfg.gait.swing_height
    from quadruped_control_tpu_torch.ops.trajectory import _A_INV
    rhs = np.zeros((batch, 4, 7, 3))
    rhs[..., 0, :], rhs[..., 1, :], rhs[..., 2, :] = p0, pf, pc
    coeffs = np.where(valid[..., None, None], _A_INV @ rhs, 0.0)
    return dict(standing=standing, gait_time=gait_time,
                prev_in_stance=prev_in_stance, initialized=initialized,
                coeffs=coeffs, valid=valid)


def walk_state_comps(d: dict):
    """:func:`whole_body_walk_states` dict -> (58, B) float64 NumPy array in
    the kernels' state layout (sim/fused_substep.py)."""
    B = d["x"].shape[0]
    return np.concatenate(
        [d["R"].reshape(B, 9), d["x"], d["u"], d["q"].reshape(B, 12),
         d["anchor"].reshape(B, 16)], axis=-1).T.copy()


def walk_carry_comps(c: dict):
    """:func:`commander_carry_walk` dict -> (95, B) float64 NumPy array in
    the commander carry's layout (control/fused_commander.py)."""
    B = c["gait_time"].shape[0]
    return np.concatenate(
        [c["standing"][:, None], c["gait_time"][:, None],
         c["prev_in_stance"], c["initialized"][:, None],
         c["coeffs"].reshape(B, 84), c["valid"]],
        axis=-1).astype(np.float64).T.copy()
