"""Closed-loop rollouts: commander x SRB plant (counterpart of
``quadruped_control_tpu/control/rollout.py``), plus the rollout telemetry
and command schedules the whole-body loops share.

One tick is ``commander_step`` then ``plant_step``; a rollout is a Python
loop over ticks (the JAX package's ``lax.scan``), with the per-tick trace
stacked on a leading time axis. The rollouts choose no backend of their
own: they pass ``qp_backend`` / ``mpc_backend`` to ``commander_step``.
With ``qp_backend="fused"`` every tick launches the fused GRF-QP kernel
(K1) once; with ``controller="mpc", mpc_backend="riccati-pallas"`` every
MPC solve launches the MPC kernel (K6) once. On CPU tensors those backends
run the kernels' plain versions. Neither kernel has a backward: asking for
a gradient through them raises (``kernels.refuse_grad``); the "jnp"
balance QP and the "structured" / "condensed" MPC are differentiable.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig
from quadruped_control_tpu_torch.control.commander import (
    CommanderCarry,
    commander_step,
    init_commander_carry,
)
from quadruped_control_tpu_torch.control.plant import (
    PlantState,
    init_plant_state,
    plant_step,
)


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


class RolloutResult(NamedTuple):
    plant: PlantState
    carry: CommanderCarry
    trace: object  # RolloutTrace, or 0 when record=False (as in JAX)


def _trace_entry(plant: PlantState, carry: CommanderCarry, out):
    return RolloutTrace(
        x=plant.com.x,
        xdot=plant.com.xdot,
        standing=carry.standing,
        in_stance=out.gait.in_stance,
        qp_converged=out.qp_converged,
        torque_max=torch.amax(torch.abs(out.torques), dim=(-2, -1)),
        feet=plant.feet_world,
        R=plant.com.R,
    )


def _tick(plant: PlantState, carry: CommanderCarry, cmd, dt,
          cfg: ControlConfig, **kw):
    """commander_step then plant_step: (plant, carry, commander output)."""
    out, carry = commander_step(plant.com, plant.joints, carry, cmd, dt, cfg,
                                **kw)
    plant = plant_step(plant, out.forces_world, out.gait.in_stance,
                       out.foot_refs_world, dt, cfg)
    return plant, carry, out


def _stack(entries, record):
    if not record:
        return 0
    return RolloutTrace(*(torch.stack(parts) for parts in zip(*entries)))


def rollout(plant: PlantState, carry: CommanderCarry, cmd_twist, steps: int,
            cfg: ControlConfig, qp_iterations: int = 12,
            qp_polish: bool = False, record: bool = True,
            qp_backend: str = "jnp", controller: str = "balance",
            mpc_horizon: int = 8, mpc_dt: float = 0.05,
            mpc_iterations: int = 25, mpc_backend: str = "structured",
            mpc_state_weights=None, weight_shift: float = 0.0,
            cmd_schedule: bool = False,
            heading_hold: bool = False,
            foothold_trim=None) -> RolloutResult:
    """Run ``steps`` control ticks of the closed loop.

    Args:
      plant: initial plant state (see control/plant.init_plant_state).
      carry: initial commander carry.
      cmd_twist: (..., 6) commanded body twist, constant over the rollout —
        or, with ``cmd_schedule=True``, a (steps, ..., 6) per-tick command
        (build schedules with :func:`piecewise_command`).
      steps: number of control ticks.
      cfg: control configuration; the control period is 1/cfg.frequency and
        the plant integrates one step per tick.
      qp_polish: polish is off by default in rollouts — closed-loop control
        needs ~1e-3 N force accuracy, not certificate-grade parity.
      qp_backend, controller, mpc_*: passed to ``commander_step``.
    Returns:
      RolloutResult with final states and (with ``record``) the trace;
      ``trace`` is 0 when ``record=False``.
    """
    dt = 1.0 / cfg.frequency
    if cmd_schedule:
        assert cmd_twist.shape[0] == steps, (tuple(cmd_twist.shape), steps)
    if foothold_trim is not None and carry.ref_pose is None:
        carry = carry._replace(ref_pose=torch.zeros(
            plant.com.x.shape[:-1] + (3,), dtype=plant.com.x.dtype,
            device=plant.com.x.device))

    entries = []
    for t in range(steps):
        cmd = cmd_twist[t] if cmd_schedule else cmd_twist
        plant, carry, out = _tick(
            plant, carry, cmd, dt, cfg,
            qp_iterations=qp_iterations, qp_polish=qp_polish,
            qp_backend=qp_backend, controller=controller,
            mpc_horizon=mpc_horizon, mpc_dt=mpc_dt,
            mpc_iterations=mpc_iterations, mpc_backend=mpc_backend,
            mpc_state_weights=mpc_state_weights, weight_shift=weight_shift,
            heading_hold=heading_hold, foothold_trim=foothold_trim,
        )
        if record:
            entries.append(_trace_entry(plant, carry, out))
    return RolloutResult(plant=plant, carry=carry,
                         trace=_stack(entries, record))


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


def hold_indices(mpc_every: int, dt: float, mpc_dt: float,
                 mpc_horizon: int, hold_mode: str = "zoh"):
    """The horizon step each held tick k = 1 .. mpc_every - 1 applies:
    0 for "zoh"; floor(k dt / mpc_dt) capped at N - 1 for "horizon" (+1e-9
    makes the floor deterministic at exact tick/mpc_dt boundaries, e.g.
    dt = 1/300, mpc_dt = 0.03, k = 9 -> 1.0000000000000002)."""
    assert hold_mode in ("zoh", "horizon"), hold_mode
    if hold_mode == "horizon":
        return [min(int(k * dt / mpc_dt + 1e-9), mpc_horizon - 1)
                for k in range(1, mpc_every)]
    return [0] * (mpc_every - 1)


def rollout_mpc_decimated(plant: PlantState, carry: CommanderCarry,
                          cmd_twist, steps: int, cfg: ControlConfig,
                          mpc_every: int = 10, mpc_horizon: int = 8,
                          mpc_dt: float = 0.05, mpc_iterations: int = 25,
                          mpc_backend: str = "structured",
                          mpc_state_weights=None,
                          record: bool = True,
                          hold_mode: str = "zoh") -> RolloutResult:
    """Closed loop with the MPC re-solved every ``mpc_every`` ticks.

    Each group solves the MPC once (a full commander tick), then
    ``mpc_every - 1`` held ticks re-run only the swing pipeline and torque
    mapping with held forces (``forces_override``), which launch no kernel.

    ``hold_mode``:
      - "zoh": zero-order-hold F_0 for the whole window (exact while the
        window fits one horizon step, mpc_every * dt <= mpc_dt).
      - "horizon": held tick k applies the horizon's own plan for that
        moment, F_{floor(k dt / mpc_dt)} (:func:`hold_indices`).

    ``steps`` must be a multiple of ``mpc_every``. Telemetry is recorded at
    the group level (one entry per MPC solve, post-group state).
    """
    assert steps % mpc_every == 0, (steps, mpc_every)
    dt = 1.0 / cfg.frequency
    hold_idx = hold_indices(mpc_every, dt, mpc_dt, mpc_horizon, hold_mode)
    mpc_kw = dict(controller="mpc", mpc_horizon=mpc_horizon, mpc_dt=mpc_dt,
                  mpc_iterations=mpc_iterations, mpc_backend=mpc_backend,
                  mpc_state_weights=mpc_state_weights)

    entries = []
    for _ in range(steps // mpc_every):
        plant, carry, out = _tick(plant, carry, cmd_twist, dt, cfg,
                                  **mpc_kw)
        for i in hold_idx:
            plant, carry, _ = _tick(
                plant, carry, cmd_twist, dt, cfg,
                forces_override=out.forces_horizon[..., i, :])
        if record:
            entries.append(_trace_entry(plant, carry, out))
    return RolloutResult(plant=plant, carry=carry,
                         trace=_stack(entries, record))


def rollout_chunked(plant: PlantState, carry: CommanderCarry, cmd_twist,
                    steps: int, cfg: ControlConfig, chunk: int = 50,
                    **kwargs) -> RolloutResult:
    """``rollout`` split into chunks of ``chunk`` ticks, run in sequence,
    with the traces concatenated: the same ticks in the same order as one
    ``rollout``."""
    cmd_schedule = kwargs.get("cmd_schedule", False)
    record = kwargs.get("record", True)
    chunks = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        cmd = cmd_twist[done:done + n] if cmd_schedule else cmd_twist
        res = rollout(plant, carry, cmd, n, cfg, **kwargs)
        plant, carry = res.plant, res.carry
        chunks.append(res.trace)
        done += n
    trace = (RolloutTrace(*(torch.cat(parts) for parts in zip(*chunks)))
             if record else 0)
    return RolloutResult(plant=plant, carry=carry, trace=trace)


def stand_up_rollout(cfg: ControlConfig, seconds: float = 2.0,
                     batch_shape=(), dtype=torch.float32,
                     qp_iterations: int = 12, device=None,
                     **rollout_kwargs) -> RolloutResult:
    """The reference's stand_up scenario: from the laying pose, pure balance
    control to the standing height, zero commanded twist. ``device=None``
    means ``cuda``."""
    steps = int(seconds * cfg.frequency)
    plant = init_plant_state(cfg, batch_shape, dtype=dtype, device=device)
    carry = init_commander_carry(batch_shape, dtype=dtype, device=device)
    cmd = torch.zeros(tuple(batch_shape) + (6,), dtype=dtype,
                      device=plant.com.x.device)
    return rollout(plant, carry, cmd, steps, cfg,
                   qp_iterations=qp_iterations, **rollout_kwargs)


def walk_rollout(cfg: ControlConfig, vx: float = 0.2, vy: float = 0.0,
                 wz: float = 0.0, seconds: float = 4.0, batch_shape=(),
                 dtype=torch.float32, qp_iterations: int = 12, device=None,
                 **rollout_kwargs) -> RolloutResult:
    """Stand up (1.5 s), then trot with the commanded planar twist (the
    reference's teleop walking demo)."""
    stand = stand_up_rollout(cfg, seconds=1.5, batch_shape=batch_shape,
                             dtype=dtype, qp_iterations=qp_iterations,
                             device=device, **rollout_kwargs)
    steps = int(seconds * cfg.frequency)
    cmd = torch.zeros(tuple(batch_shape) + (6,), dtype=dtype,
                      device=stand.plant.com.x.device)
    cmd[..., 0], cmd[..., 1], cmd[..., 5] = vx, vy, wz
    return rollout(stand.plant, stand.carry, cmd, steps, cfg,
                   qp_iterations=qp_iterations, **rollout_kwargs)
