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
