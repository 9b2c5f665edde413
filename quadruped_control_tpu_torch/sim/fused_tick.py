"""The whole-body closed-loop tick as three chained kernels (counterpart of
``quadruped_control_tpu/sim/pallas_tick.py``).

One control tick is exactly three launches (four with ``qp_tail``):

  1. commander-pre (control/fused_commander.py, K4): measurement, FK, the
     standing/gait state machine, Raibert planning, sextic tracking, IK,
     swing PD -> QP precursors + swing torques + new carry (+ the MPC
     precursor block with ``controller="mpc"``);
  2. the fused GRF-QP kernel (solver/fused.py, K1) consuming those tensors
     directly, warm-started from the previous tick's solution — or, with
     ``controller="mpc"``, the receding-horizon MPC kernel
     (mpc/fused_riccati.py, K6), whose step-0 forces drive the stance legs;
  3. the whole-body substep kernel (sim/fused_substep.py, K5,
     ``torque_input="qp"``): torque mapping as the prologue, then the
     N-substep physics loop.

Everything between kernels stays in the structure-of-arrays ``(k, B)``
layout: the loop carry IS those tensors, so the host side of a tick is the
three launches and nothing else (no allocation besides the kernels' outputs,
no synchronisation). Packing happens once per rollout at the boundary. The
loop is a Python loop.

``rollout_whole_body_fused_decimated`` re-solves the MPC every
``mpc_every`` ticks and holds its forces in between (``tick.held``: K4 + K5,
no K6).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from quadruped_control_tpu_torch.config import ControlConfig
from quadruped_control_tpu_torch.control.commander import CommanderCarry
from quadruped_control_tpu_torch.control.fused_commander import (
    CommanderConsts,
    commander_pre_packed,
    pack_commander_carry,
    pack_comps,
    unpack_commander_carry,
)
from quadruped_control_tpu_torch.mpc.fused_riccati import (
    MC as _MC,
    MpcSettings,
    solve_mpc_qp_riccati_packed,
)
from quadruped_control_tpu_torch.sim.fused_substep import (
    comps_to_state,
    make_fused_stepper,
    state_to_comps,
)
from quadruped_control_tpu_torch.sim.model import WholeBodyModel
from quadruped_control_tpu_torch.sim.plant import ContactConfig, WholeBodyState
from quadruped_control_tpu_torch.solver.fused import (
    _POLISH_REFINE,
    _POLISH_SWEEPS_FUSED,
    M as _M,
    N as _N,
    solve_grf_qp_fused_packed,
    solve_grf_qp_tail_packed,
)

class FusedRolloutTrace(NamedTuple):
    """Per-tick trace of the fused loop (a light cousin of
    control/rollout.RolloutTrace — torques never leave the kernel)."""

    x: torch.Tensor  # (steps, ..., 3) base position
    standing: torch.Tensor  # (steps, ...)
    in_stance: torch.Tensor  # (steps, ..., 4) effective stance mask
    qp_converged: torch.Tensor  # (steps, ...)


class FusedWholeBodyResult(NamedTuple):
    plant: WholeBodyState
    carry: CommanderCarry
    trace: Optional[FusedRolloutTrace]
    # Final QP warm carry (x_p, s_p, z_p, st_p) when the tick was built with
    # qp_warm_start=True, else None. Feed it back as the ``warm`` argument of
    # the next rollout call so the warm start survives host-side chunking.
    warm: Optional[tuple] = None


def make_fused_tick(model: WholeBodyModel, cfg: ControlConfig,
                    contact: ContactConfig = ContactConfig(), *,
                    rows=None, qp_iterations: Optional[int] = None,
                    qp_polish: bool = True, qp_warm_start: bool = True,
                    qp_polish_sweeps: Optional[int] = None,
                    qp_polish_refine: Optional[int] = None,
                    qp_polish_multi_swap: bool = False,
                    qp_tail: bool = False, qp_tail_divisor: int = 4,
                    qp_tail_rows=None, qp_tail_sweeps: int = 24,
                    qp_tail_prox_steps: int = 2,
                    qp_tail_prox_iterations: int = 8,
                    qp_tail_prox_sweeps: Optional[int] = None,
                    contact_gate: float = 0.0,
                    raibert_cmd_symmetric: bool = False,
                    gravity_comp: bool = False,
                    controller: str = "balance", mpc_horizon: int = 8,
                    mpc_dt: float = 0.03, mpc_iterations: int = 15,
                    mpc_state_weights=None, mpc_warm_start: bool = False):
    """Build the fused tick: ``tick(state_p, carry_p, cmd_p, dt,
    n_substeps) -> (state_p, carry_p, (st_p, diag_p))`` on ``(k, B)``
    tensors.

    Model/config constants are snapshot here. The returned callable also
    carries ``.consts``, ``.stepper`` and ``.warm_start``.

    ``qp_warm_start=True`` (the default) threads the QP solution (x, s, z)
    and the stance mask through the loop carry and warm-starts the barrier
    from the previous tick's solution (stance-transition rows reset cold).
    The tick signature becomes ``tick(state_p, carry_p, warm_p, cmd_p, dt,
    n_substeps) -> (state_p, carry_p, warm_p, (st_p, diag_p))`` with
    ``warm_p = (x_p, s_p, z_p, st_p)``; build the first-tick carry with
    :func:`init_qp_warm_packed` (zeros + st = -1 == cold start).

    ``qp_tail=True`` appends the in-loop certification tail
    (solver/fused.solve_grf_qp_tail_packed): after the per-tick QP kernel,
    the uncertified instances are compacted into a ``B / qp_tail_divisor``
    slice and re-solved by a second launch of the QP kernel with the long
    warm-seeded polish (``qp_tail_sweeps``) plus proximal restarts. The
    improved (x, s, z) scatter back into the output AND the warm carry.
    Typical use: ``qp_polish=False, qp_tail=True``.

    ``qp_iterations=None`` resolves to 6 warm / 12 cold, the reference's
    operating points. ``rows`` / ``qp_tail_rows`` (tile heights of the TPU
    kernels, default 8) set the size of the ``qp_tail`` slice as in the JAX
    package (solver/fused.qp_tail_size) and nothing else.

    ``controller="mpc"`` replaces kernel 2 with the receding-horizon MPC
    kernel (K6): commander-pre additionally emits the MPC precursor block
    and the tick applies the horizon's step-0 forces. ``qp_*`` options are
    ignored; ``mpc_horizon`` / ``mpc_dt`` / ``mpc_iterations`` /
    ``mpc_state_weights`` (one (13,) diagonal) mirror
    control/commander.commander_step. ``mpc_warm_start=True`` threads the
    previous tick's horizon solution (F, s, z) and its stance schedule
    through the loop carry (schedule-changed rows reset cold): the tick
    takes the warm 6-argument form, ``warm_p = (F_p (12N, B), sz_p (48N, B),
    sched_p (4N, B))``, first built by :func:`init_mpc_warm_packed` (a -1
    schedule: tick 1 is exactly the cold start). The recommended operating
    point is ``mpc_warm_start=True, mpc_iterations=8`` ("warm-8"). The MPC
    tick also carries ``.held`` (K4 + K5 with held forces, for
    :func:`rollout_whole_body_fused_decimated`), ``.pre``, ``.solve``,
    ``.mpc_horizon``, ``.mpc_dt`` and, warm, ``.init_warm``.
    """
    if controller not in ("balance", "mpc"):
        raise ValueError(f"controller must be 'balance'|'mpc': {controller}")
    if qp_iterations is None:
        qp_iterations = 6 if qp_warm_start else 12
    if qp_polish_sweeps is None:
        qp_polish_sweeps = _POLISH_SWEEPS_FUSED
    if qp_polish_refine is None:
        qp_polish_refine = _POLISH_REFINE
    consts = CommanderConsts(cfg, dt=1.0 / cfg.frequency)
    stepper = make_fused_stepper(
        model, cfg, contact, prefactor="kernel", torque_input="qp",
        gravity_comp=gravity_comp)
    if controller == "mpc":
        return _make_mpc_tick(
            consts, stepper, cfg, contact_gate, raibert_cmd_symmetric,
            mpc_horizon, mpc_dt, mpc_iterations, mpc_state_weights,
            mpc_warm_start)
    qp_kw = dict(
        s_diag=tuple(cfg.balance.s_diag), w_diag=float(cfg.balance.w_diag),
        iterations=qp_iterations, polish=qp_polish,
        polish_sweeps=qp_polish_sweeps, polish_refine=qp_polish_refine,
        polish_multi_swap=qp_polish_multi_swap)
    tail_kw = dict(
        s_diag=qp_kw["s_diag"], w_diag=qp_kw["w_diag"],
        tail_divisor=qp_tail_divisor, rows=rows, tail_rows=qp_tail_rows,
        tail_sweeps=qp_tail_sweeps,
        tail_prox_steps=qp_tail_prox_steps,
        tail_prox_iterations=qp_tail_prox_iterations,
        tail_prox_sweeps=qp_tail_prox_sweeps)

    def pre(state_p, carry_p, cmd_p):
        return commander_pre_packed(
            state_p, carry_p, cmd_p, consts=consts,
            contact_gate=contact_gate,
            raibert_cmd_symmetric=raibert_cmd_symmetric)

    def solve(qp_in, warm_p):
        # The QP kernel computes float32 whatever the plant's type (a
        # float64 plant exists only in CPU tests).
        qp_in = tuple(a if a.dtype == torch.float32 else a.float()
                      for a in qp_in)
        out = solve_grf_qp_fused_packed(*qp_in, *warm_p, **qp_kw)
        if qp_tail:
            out = solve_grf_qp_tail_packed(*qp_in, *out, **tail_kw)
        return out

    if qp_warm_start:
        def tick(state_p, carry_p, warm_p, cmd_p, dt: float,
                 n_substeps: int):
            (r_p, b_p, st_p, mu_p, fmin_p, fmax_p, tausw_p, carry_new_p,
             _qref_p) = pre(state_p, carry_p, cmd_p)
            x_p, s_p, z_p, diag_p = solve(
                (r_p, b_p, st_p, mu_p, fmin_p, fmax_p), warm_p)
            state_new_p = _step(stepper, state_p, x_p, tausw_p, st_p, dt,
                                n_substeps)
            st32 = st_p if st_p.dtype == torch.float32 else st_p.float()
            return (state_new_p, carry_new_p, (x_p, s_p, z_p, st32),
                    (st_p, diag_p))
    else:
        def tick(state_p, carry_p, cmd_p, dt: float, n_substeps: int):
            (r_p, b_p, st_p, mu_p, fmin_p, fmax_p, tausw_p, carry_new_p,
             _qref_p) = pre(state_p, carry_p, cmd_p)
            x_p, _s_p, _z_p, diag_p = solve(
                (r_p, b_p, st_p, mu_p, fmin_p, fmax_p), ())
            state_new_p = _step(stepper, state_p, x_p, tausw_p, st_p, dt,
                                n_substeps)
            return state_new_p, carry_new_p, (st_p, diag_p)

    tick.pre = pre
    tick.consts = consts
    tick.stepper = stepper
    tick.warm_start = qp_warm_start
    tick.launches_per_tick = 4 if qp_tail else 3
    return tick


def init_qp_warm_packed(B: int, rows=None, dtype=torch.float32, device=None):
    """First-tick warm carry for a ``qp_warm_start`` fused tick over ``B``
    instances: zero (x, s, z) plus st_prev = -1 marks every cone row stale,
    which the kernel resets cold — tick 1 is bitwise the cold start. The
    dtype should stay float32 (the QP kernel's). ``rows`` is ignored."""
    from quadruped_control_tpu_torch import resolve_device

    kw = dict(dtype=dtype, device=resolve_device(device))
    return (torch.zeros((_N, B), **kw), torch.zeros((_M, B), **kw),
            torch.zeros((_M, B), **kw), -torch.ones((4, B), **kw))


def _step(stepper, state_p, x_p, tausw_p, st_p, dt, n_substeps):
    if x_p.dtype != state_p.dtype:
        x_p = x_p.to(state_p.dtype)
    return stepper.packed(state_p, x_p, tausw_p, st_p, dt, n_substeps)


def mpc_diag(dg):
    """Reorder the MPC kernel's diag [conv, pr, dr, gap, nu, 0] into the QP
    diag convention [cert, conv, pr, dr, gap, nu] the rollout trace reads
    (row 1 = converged)."""
    return torch.cat([torch.zeros_like(dg[0:1]), dg[0:5]])


def _make_mpc_tick(consts, stepper, cfg, contact_gate, raibert_cmd_symmetric,
                   mpc_horizon, mpc_dt, mpc_iterations, mpc_state_weights,
                   mpc_warm_start):
    """The MPC tick: K4 with the MPC block -> K6 -> K5 (three launches)."""
    N = int(mpc_horizon)
    bal = cfg.balance
    mpc_kw = dict(
        n_steps=N, dt=float(mpc_dt), mass=float(bal.mass),
        inertia_diag=tuple(float(v) for v in bal.inertia_diag),
        mu=float(bal.mu), fz_min=float(bal.fz_min), fz_max=float(bal.fz_max),
        state_weights=mpc_state_weights, iterations=int(mpc_iterations))
    settings = MpcSettings(**mpc_kw)
    nsz = 2 * _MC * N

    def pre(state_p, carry_p, cmd_p):
        return commander_pre_packed(
            state_p, carry_p, cmd_p, consts=consts,
            contact_gate=contact_gate,
            raibert_cmd_symmetric=raibert_cmd_symmetric, mpc_horizon=N,
            mpc_dt=mpc_dt)

    def solve(mpc_p, warm_p=None):
        return solve_mpc_qp_riccati_packed(mpc_p, warm_p, settings=settings,
                                           **mpc_kw)

    def next_warm(mpc_p, szf_p):
        # The kernel's [s | z | F] of the FINAL iterate (a consistent
        # primal-dual triple; F_p is the best-merit control output and is not
        # recycled) + the schedule it was solved against.
        sched = mpc_p[25:25 + 4 * N]
        if sched.dtype != torch.float32:
            sched = sched.float()
        return (szf_p[nsz:], szf_p[:nsz], sched)

    if mpc_warm_start:
        def tick(state_p, carry_p, warm_p, cmd_p, dt: float,
                 n_substeps: int):
            (_r, _b, st_p, _mu, _fmin, _fmax, tausw_p, carry_new_p, _qref,
             mpc_p) = pre(state_p, carry_p, cmd_p)
            F_p, dg, szf_p = solve(mpc_p, warm_p)
            state_new_p = _step(stepper, state_p, F_p[0:12], tausw_p, st_p,
                                dt, n_substeps)
            return (state_new_p, carry_new_p, next_warm(mpc_p, szf_p),
                    (st_p, mpc_diag(dg)))
    else:
        def tick(state_p, carry_p, cmd_p, dt: float, n_substeps: int):
            (_r, _b, st_p, _mu, _fmin, _fmax, tausw_p, carry_new_p, _qref,
             mpc_p) = pre(state_p, carry_p, cmd_p)
            F_p, dg = solve(mpc_p)
            state_new_p = _step(stepper, state_p, F_p[0:12], tausw_p, st_p,
                                dt, n_substeps)
            return state_new_p, carry_new_p, (st_p, mpc_diag(dg))

    def held(state_p, carry_p, x_hold_p, cmd_p, dt: float, n_substeps: int):
        """Hold tick between MPC solves: commander-pre runs (swing PD, gait,
        planning) without the MPC block, the held forces drive the stance
        legs; the MPC kernel is not launched."""
        (_r, _b, st_p, _mu, _fmin, _fmax, tausw_p, carry_new_p,
         _qref) = commander_pre_packed(
            state_p, carry_p, cmd_p, consts=consts,
            contact_gate=contact_gate,
            raibert_cmd_symmetric=raibert_cmd_symmetric)
        state_new_p = _step(stepper, state_p, x_hold_p, tausw_p, st_p, dt,
                            n_substeps)
        return state_new_p, carry_new_p, st_p

    tick.pre = pre
    tick.solve = solve
    tick.held = held
    tick.next_warm = next_warm
    tick.consts = consts
    tick.stepper = stepper
    tick.settings = settings
    tick.warm_start = bool(mpc_warm_start)
    tick.mpc_horizon = N
    tick.mpc_dt = float(mpc_dt)
    tick.launches_per_tick = 3
    if mpc_warm_start:
        def init_warm(B, rows=None, dtype=torch.float32, device=None):
            return init_mpc_warm_packed(B, horizon=N, dtype=dtype,
                                        device=device)
        tick.init_warm = init_warm
    return tick


def init_mpc_warm_packed(B: int, *, horizon: int, rows=None,
                         dtype=torch.float32, device=None):
    """First-tick warm carry for an ``mpc_warm_start`` fused tick over ``B``
    instances: zero (F, [s | z]) plus a schedule of -1, which mismatches
    every current schedule bit, so the MPC kernel resets every row cold —
    tick 1 is exactly the cold start. ``rows`` is ignored."""
    from quadruped_control_tpu_torch import resolve_device

    kw = dict(dtype=dtype, device=resolve_device(device))
    N = int(horizon)
    return (torch.zeros((12 * N, B), **kw),
            torch.zeros((2 * _MC * N, B), **kw),
            -torch.ones((4 * N, B), **kw))


def _flat_batch(batch):
    B = 1
    for d in batch:
        B *= int(d)
    return B


def pack_whole_body_state(state: WholeBodyState, rows=None):
    """WholeBodyState (any batch shape) -> ((58, B) tensor, B). Nothing is
    padded; ``rows`` is ignored."""
    batch = tuple(state.x.shape[:-1])
    B = _flat_batch(batch)
    flat = WholeBodyState(
        R=state.R.reshape(B, 3, 3), x=state.x.reshape(B, 3),
        u=state.u.reshape(B, 18), q=state.q.reshape(B, 4, 3),
        anchor=state.anchor.reshape(B, 8, 2))
    return state_to_comps(flat), B


def unpack_whole_body_state(state_p, batch_shape) -> WholeBodyState:
    batch = tuple(batch_shape)
    s = comps_to_state(state_p)
    return WholeBodyState(
        R=s.R.reshape(batch + (3, 3)), x=s.x.reshape(batch + (3,)),
        u=s.u.reshape(batch + (18,)), q=s.q.reshape(batch + (4, 3)),
        anchor=s.anchor.reshape(batch + (8, 2)))


def _pack_cmd(cmd_twist, batch, B, dtype, device, steps=None):
    """Broadcast + flatten + transpose a command twist. With ``steps``:
    cmd_twist is a (steps, ..., 6) PER-TICK schedule -> (steps, 6, B).
    Without: one (6, B) command."""
    cmd = torch.as_tensor(cmd_twist, dtype=dtype, device=device)
    if steps is not None:
        if cmd.shape[0] != steps:
            raise ValueError(f"cmd_schedule: {tuple(cmd.shape)} does not "
                             f"start with steps = {steps}")
        if cmd.dim() == 2:  # (steps, 6) commands the whole batch uniformly
            cmd = cmd.reshape((steps,) + (1,) * len(batch) + (6,))
        cmd = cmd.expand((steps,) + batch + (6,)).reshape(steps, B, 6)
        return cmd.transpose(1, 2).contiguous()
    return pack_comps(cmd.expand(batch + (6,)).reshape(B, 6))


def _broadcast_carry(carry: CommanderCarry, batch):
    def leaf(a, tail):
        return None if a is None else a.expand(batch + tail)

    pl = carry.planner
    return carry._replace(
        standing=leaf(carry.standing, ()),
        gait_time=leaf(carry.gait_time, ()),
        planner=pl._replace(
            prev_in_stance=leaf(pl.prev_in_stance, (4,)),
            initialized=leaf(pl.initialized, ()),
            traj=pl.traj._replace(
                coeffs=leaf(pl.traj.coeffs, (4, 7, 3)),
                valid=leaf(pl.traj.valid, (4,)))),
        qp_x=leaf(carry.qp_x, (12,)), qp_s=leaf(carry.qp_s, (24,)),
        qp_z=leaf(carry.qp_z, (24,)), ref_pose=leaf(carry.ref_pose, (3,)),
        pose_cmd=leaf(carry.pose_cmd, (4,)))


def rollout_whole_body_fused(plant: WholeBodyState, carry: CommanderCarry,
                             cmd_twist, steps: int, tick,
                             n_substeps: int = 10, record: bool = False,
                             warm: Optional[tuple] = None,
                             cmd_schedule: bool = False
                             ) -> FusedWholeBodyResult:
    """Run ``steps`` fused control ticks (drop-in sibling of
    sim/rollout.rollout_whole_body for the balance-QP and MPC
    controllers).

    Args:
      tick: built by :func:`make_fused_tick`.
      cmd_twist: (..., 6), broadcast over the batch — or, with
        ``cmd_schedule=True``, a (steps, ..., 6) PER-TICK command schedule
        (build with control/rollout.piecewise_command).
      warm: for a warm-started tick, the warm carry from a previous
        rollout's ``.warm`` (the QP's ``(x_p, s_p, z_p, st_p)``, or the MPC's
        ``(F_p, sz_p, sched_p)``). None = cold first tick. The final warm
        carry comes back in ``result.warm``.

    The plant's device decides where the loop runs (CUDA: the kernels; CPU:
    their plain versions).
    """
    dt = tick.consts.dt
    batch = tuple(plant.x.shape[:-1])
    dtype, device = plant.x.dtype, plant.x.device
    state_p, B = pack_whole_body_state(plant)
    carry_b = _broadcast_carry(carry, batch)
    carry_p = pack_commander_carry(carry_b, batch=B)
    cmd_p = _pack_cmd(cmd_twist, batch, B, dtype, device,
                      steps=steps if cmd_schedule else None)
    warm_start = tick.warm_start
    warm_p = None
    if warm_start:
        init_warm = getattr(tick, "init_warm", init_qp_warm_packed)
        warm_p = warm if warm is not None else init_warm(B, device=device)

    rec = None
    if record:
        rec = (torch.empty((steps, 3, B), dtype=dtype, device=device),
               torch.empty((steps, B), dtype=dtype, device=device),
               torch.empty((steps, 4, B), dtype=dtype, device=device),
               torch.empty((steps, B), dtype=torch.float32, device=device))

    for t in range(steps):
        cmd_t = cmd_p[t] if cmd_schedule else cmd_p
        if warm_start:
            state_p, carry_p, warm_p, (st_p, diag_p) = tick(
                state_p, carry_p, warm_p, cmd_t, dt, n_substeps)
        else:
            state_p, carry_p, (st_p, diag_p) = tick(
                state_p, carry_p, cmd_t, dt, n_substeps)
        if record:
            rec[0][t].copy_(state_p[9:12])
            rec[1][t].copy_(carry_p[0])
            rec[2][t].copy_(st_p)
            rec[3][t].copy_(diag_p[1])

    trace = None
    if record:
        x_r, standing_r, st_r, conv_r = rec
        trace = FusedRolloutTrace(
            x=x_r.transpose(1, 2).reshape((steps,) + batch + (3,)),
            standing=standing_r.reshape((steps,) + batch) > 0.5,
            in_stance=st_r.transpose(1, 2).reshape(
                (steps,) + batch + (4,)) > 0.5,
            qp_converged=conv_r.reshape((steps,) + batch) > 0.5,
        )

    return FusedWholeBodyResult(
        plant=unpack_whole_body_state(state_p, batch),
        carry=unpack_commander_carry(carry_p, batch, carry_b),
        trace=trace,
        warm=warm_p,
    )


def rollout_whole_body_fused_chunked(plant: WholeBodyState,
                                     carry: CommanderCarry, cmd_twist,
                                     steps: int, tick, chunk: int = 50,
                                     n_substeps: int = 10,
                                     record: bool = False,
                                     warm: Optional[tuple] = None,
                                     cmd_schedule: bool = False
                                     ) -> FusedWholeBodyResult:
    """``rollout_whole_body_fused`` split into host-side chunks of ``chunk``
    ticks (the last one may be shorter), so a caller can look at the state
    between chunks. Plant, commander carry AND the QP warm carry thread
    across chunk boundaries, so a long warm drive keeps its warm start end to
    end instead of resetting cold every ``chunk`` ticks. Traces concatenate.
    Chunked equals unchunked bitwise.
    """
    traces = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        cmd = cmd_twist[done:done + n] if cmd_schedule else cmd_twist
        res = rollout_whole_body_fused(
            plant, carry, cmd, n, tick, n_substeps=n_substeps,
            record=record, warm=warm, cmd_schedule=cmd_schedule)
        plant, carry, warm = res.plant, res.carry, res.warm
        if record:
            traces.append(res.trace)
        done += n
    trace = None
    if record:
        trace = FusedRolloutTrace(*(torch.cat(parts) for parts in zip(*traces)))
    return FusedWholeBodyResult(plant=plant, carry=carry, trace=trace,
                                warm=warm)


def rollout_whole_body_fused_decimated(plant: WholeBodyState,
                                       carry: CommanderCarry, cmd_twist,
                                       steps: int, tick,
                                       mpc_every: int = 4,
                                       n_substeps: int = 10,
                                       record: bool = False,
                                       cmd_schedule: bool = False,
                                       hold_mode: str = "zoh"
                                       ) -> FusedWholeBodyResult:
    """Fused MPC closed loop with the MPC re-solved every ``mpc_every``
    ticks: each group is one full MPC tick, then ``mpc_every - 1`` held
    ticks (K4 + K5 with held horizon forces) — the MPC kernel's cost drops
    by ~``mpc_every``. ``steps`` must be a multiple of ``mpc_every``. Trace
    entries are per GROUP (one per MPC solve, post-group state). Needs a
    ``controller="mpc"`` tick. A warm tick threads its horizon carry across
    solve groups (the carry ages ``mpc_every`` ticks between solves; the
    kernel's schedule-changed rows still reset cold); the final one comes
    back in ``result.warm``.

    ``hold_mode``: what the held ticks apply.
      - "zoh": the step-0 forces F_0 for the whole window — consistent when
        the hold window fits one horizon step (mpc_every * dt <= mpc_dt).
      - "horizon": held tick k applies the horizon's own plan for that
        moment, F_{floor(k dt / mpc_dt)}; equal to "zoh" when every k maps
        to step 0.

    ``cmd_schedule=True``: (steps, ..., 6) per-tick commands; the solve tick
    takes the group's first command, the held ticks the rest."""
    if steps % mpc_every != 0:
        raise ValueError(f"steps ({steps}) must be a multiple of mpc_every "
                         f"({mpc_every})")
    if not hasattr(tick, "held"):
        raise ValueError("needs a controller='mpc' fused tick")
    if hold_mode not in ("zoh", "horizon"):
        raise ValueError(f"hold_mode must be 'zoh'|'horizon': {hold_mode}")
    dt = tick.consts.dt
    if hold_mode == "horizon":
        # +1e-9: a deterministic floor at exact tick / mpc_dt boundaries.
        hold_idx = [min(int(k * dt / tick.mpc_dt + 1e-9),
                        tick.mpc_horizon - 1) for k in range(1, mpc_every)]
    else:
        hold_idx = [0] * (mpc_every - 1)
    batch = tuple(plant.x.shape[:-1])
    dtype, device = plant.x.dtype, plant.x.device
    state_p, B = pack_whole_body_state(plant)
    carry_b = _broadcast_carry(carry, batch)
    carry_p = pack_commander_carry(carry_b, batch=B)
    cmd_p = _pack_cmd(cmd_twist, batch, B, dtype, device,
                      steps=steps if cmd_schedule else None)
    warm_p = tick.init_warm(B, device=device) if tick.warm_start else None
    groups = steps // mpc_every
    rec = None
    if record:
        rec = (torch.empty((groups, 3, B), dtype=dtype, device=device),
               torch.empty((groups, B), dtype=dtype, device=device),
               torch.empty((groups, 4, B), dtype=dtype, device=device),
               torch.empty((groups, B), dtype=torch.float32, device=device))

    for g in range(groups):
        t0 = g * mpc_every
        cmd_solve = cmd_p[t0] if cmd_schedule else cmd_p
        (_r, _b, st_p, _mu, _fmin, _fmax, tausw_p, carry_p, _qref,
         mpc_p) = tick.pre(state_p, carry_p, cmd_solve)
        if warm_p is not None:
            F_p, dg, szf_p = tick.solve(mpc_p, warm_p)
            warm_p = tick.next_warm(mpc_p, szf_p)
        else:
            F_p, dg = tick.solve(mpc_p)
        state_p = _step(tick.stepper, state_p, F_p[0:12], tausw_p, st_p, dt,
                        n_substeps)
        for k, i in enumerate(hold_idx):
            cmd_h = cmd_p[t0 + 1 + k] if cmd_schedule else cmd_p
            state_p, carry_p, _st = tick.held(
                state_p, carry_p, F_p[12 * i:12 * i + 12], cmd_h, dt,
                n_substeps)
        if record:
            rec[0][g].copy_(state_p[9:12])
            rec[1][g].copy_(carry_p[0])
            rec[2][g].copy_(st_p)
            rec[3][g].copy_(dg[0])

    trace = None
    if record:
        x_r, standing_r, st_r, conv_r = rec
        trace = FusedRolloutTrace(
            x=x_r.transpose(1, 2).reshape((groups,) + batch + (3,)),
            standing=standing_r.reshape((groups,) + batch) > 0.5,
            in_stance=st_r.transpose(1, 2).reshape(
                (groups,) + batch + (4,)) > 0.5,
            qp_converged=conv_r.reshape((groups,) + batch) > 0.5,
        )
    return FusedWholeBodyResult(
        plant=unpack_whole_body_state(state_p, batch),
        carry=unpack_commander_carry(carry_p, batch, carry_b),
        trace=trace,
        warm=warm_p,
    )
