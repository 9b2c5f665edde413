"""Rollout telemetry and command schedules (the part of
``quadruped_control_tpu/control/rollout.py`` the whole-body loops need).

The single-rigid-body rollouts of that module (``rollout``,
``rollout_mpc_decimated``) and ``control/plant.py`` are not ported yet: that
loop runs no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from quadruped_control_tpu_torch import resolve_device


class RolloutTrace(NamedTuple):
    """Per-step telemetry (stacked along the leading time axis)."""

    x: torch.Tensor  # (T, ..., 3) CoM position
    xdot: torch.Tensor  # (T, ..., 3)
    standing: torch.Tensor  # (T, ...)
    in_stance: torch.Tensor  # (T, ..., 4)
    qp_converged: torch.Tensor  # (T, ...)
    torque_max: torch.Tensor  # (T, ...) inf-norm of commanded torques
    feet: Optional[torch.Tensor] = None  # (T, ..., 4, 3) world foot positions
    R: Optional[torch.Tensor] = None  # (T, ..., 3, 3) base orientation


def piecewise_command(segments, frequency: float, dtype=torch.float32,
                      ramp: float = 0.0, device=None):
    """Build a (T, 6) per-tick command schedule from piecewise-constant
    segments — the teleop command stream as data.

        cmd = piecewise_command([(1.5, [0, 0, 0, 0, 0, 0]),       # stand
                                 (2.0, [0.2, 0, 0, 0, 0, 0]),     # fwd
                                 (2.0, [-0.2, 0, 0, 0, 0, 0])],   # back
                                cfg.frequency, ramp=0.5)

    Args:
      segments: iterable of ``(seconds, twist6)`` pairs, each held constant
        for ``round(seconds * frequency)`` ticks.
      frequency: control-loop rate (cfg.frequency).
      ramp: seconds of linear interpolation at the START of each segment
        (from the previous segment's twist). 0 = hard steps.

    Returns (T, 6) with T the total tick count, on ``device`` (None means
    ``cuda``). (T, 6) commands a whole batch uniformly; for per-scenario
    schedules pass (T, B, 6) to the rollout directly.
    """
    rows = []
    prev = None
    for seconds, twist in segments:
        n = int(round(float(seconds) * float(frequency)))
        tw = np.asarray(twist, np.float64)
        seg = np.broadcast_to(tw, (n, 6)).copy()
        if ramp > 0.0 and prev is not None:
            nr = min(int(round(float(ramp) * float(frequency))), n)
            if nr > 0:
                a = np.linspace(0.0, 1.0, nr + 1)[1:, None]
                seg[:nr] = (1.0 - a) * prev + a * tw
        rows.append(seg)
        prev = tw
    return torch.as_tensor(np.concatenate(rows, axis=0),
                           dtype=dtype).to(resolve_device(device))
