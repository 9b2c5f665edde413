"""Gait phase generation as a pure function of time (counterpart of
``quadruped_control_tpu/ops/gait.py``; reference gait.cpp).

    phase_i(t) = (offset_i + t / (t_swing + t_stance)) mod 1

and a leg is in stance iff ``phase <= t_stance / (t_swing + t_stance)``
(gait.cpp:125-134, boundary inclusive via ``almost_equal``).
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import GaitConfig
from quadruped_control_tpu_torch.types import Gait, make_stance_gait

__all__ = ["gait_at_time", "phases_at_time", "leg_states", "make_stance_gait"]


def phases_at_time(t, cfg: GaitConfig, dtype=None, device=None):
    """Per-leg phases in [0, 1) at time(s) ``t`` since gait start.

    Args:
      t: tensor (...,) or a Python scalar (then ``device`` says where the
        result lives; None means ``cuda``).
    Returns:
      (..., 4) phases, [RL, FL, RR, FR].
    """
    if torch.is_tensor(t):
        t = t if dtype is None else t.to(dtype)
    else:
        t = torch.as_tensor(t, dtype=dtype or torch.float32,
                            device=resolve_device(device))
    offsets = cfg.offsets_array(t.dtype, device=t.device)
    return torch.remainder(offsets + t[..., None] / cfg.period, 1.0)


def leg_states(phases, cfg: GaitConfig, eps: float = 1e-12):
    """Stance mask from phases (reference gait.cpp:125-134): stance iff
    ``0 <= phase <= stance_phase`` with the reference's ``almost_equal``
    tolerance at the boundary."""
    return phases <= cfg.stance_phase + eps


def gait_at_time(t, cfg: GaitConfig, dtype=None, device=None) -> Gait:
    """Full gait snapshot at time ``t`` (replaces ``schedule()``,
    gait.cpp:85-96)."""
    phases = phases_at_time(t, cfg, dtype=dtype, device=device)
    return Gait(in_stance=leg_states(phases, cfg), phase=phases)
