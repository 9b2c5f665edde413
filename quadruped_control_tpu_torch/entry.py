"""Entry points: the single-card forward step and the multi-device dry
run (counterpart of the repository's ``__graft_entry__.py``, which drives the
JAX package).

``entry()`` returns the flagship forward step, the balance controller's hot
path (scenario -> SRB/QP assembly -> batched interior-point GRF solve), the
equivalent of the reference's ``BalanceController::control`` tick
(balance_controller.cpp:98-235).

``dryrun_multichip(n)`` builds an n-entry scenario mesh
(parallel/mesh.py), runs one sharded step of each closed loop on tiny
shapes (2 scenarios per device) and prints one ``ok`` line per stage: the
SRB commander + plant step with the global convergence fraction, the
whole-body rollout, the fused balance tick (K4 -> K1 -> K5 on CUDA) and the
warm decimated MPC tick (K4 -> K6 -> K5). Everything runs on the card unless
the caller passes CPU devices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import (
    mit_cheetah_config,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm
from quadruped_control_tpu_torch.utils.scenarios import (
    ScenarioBatch,
    assemble_qp_batch,
    grf_scenarios,
)

ENTRY_BATCH = 256


def entry(device=None):
    """-> (forward, example_args): the forward step on one device.

    ``forward(source)`` draws ``ENTRY_BATCH`` = 256 scenarios from
    ``source`` (a ``torch.Generator`` on the device) — or takes ``source``
    as the scenario batch itself when it is a ``ScenarioBatch`` — assembles
    the balance QPs and solves them with ``solve_qp_ipm(iterations=12,
    polish=True, tol=3e-5)``, in float32. Returns (x, converged).
    ``example_args`` is ``(torch.Generator(device).manual_seed(0),)``.
    """
    device = resolve_device(device)
    cfg = mit_cheetah_config()

    def forward(source):
        s = source
        if not isinstance(source, ScenarioBatch):
            s = grf_scenarios(source, ENTRY_BATCH, cfg, dtype=torch.float32,
                              device=device)
        qp = assemble_qp_batch(s, cfg)
        sol = solve_qp_ipm(qp.Q, qp.c, qp.G, qp.h, iterations=12,
                           polish=True, tol=3e-5)
        return sol.x, sol.converged

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    return forward, (gen,)


def _finite(what, *tensors):
    if not all(bool(torch.isfinite(a).all()) for a in tensors):
        raise RuntimeError(f"dryrun_multichip: non-finite {what}")


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None
                     ) -> None:
    """Run ONE sharded step of each closed loop on an ``n_devices`` mesh.

    ``devices=None``: the first ``n_devices`` CUDA devices (raises when the
    machine has fewer). Given ``devices`` (which may repeat one device, as
    ``[torch.device("cpu")] * 8`` does), the first ``n_devices`` of them.
    """
    from quadruped_control_tpu_torch.control.commander import (
        commander_step,
        init_commander_carry,
    )
    from quadruped_control_tpu_torch.control.plant import (
        init_plant_state,
        plant_step,
    )
    from quadruped_control_tpu_torch.parallel.mesh import (
        convergence_fraction,
        map_shards,
        scenario_mesh,
        shard_rollout_whole_body,
        shard_rollout_whole_body_fused,
    )
    from quadruped_control_tpu_torch.sim import (
        ContactConfig,
        init_whole_body_rollout,
        mit_cheetah_whole_body_model,
    )
    from quadruped_control_tpu_torch.sim.fused_tick import make_fused_tick

    mesh = scenario_mesh(devices)
    if len(mesh) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(mesh)}")
    mesh = mesh[:n_devices]
    home = mesh[0]

    cfg = mit_cheetah_physical_config()
    batch = (2 * n_devices,)  # tiny: 2 scenarios per device
    dt = 1.0 / cfg.frequency
    f32 = torch.float32

    plant = init_plant_state(cfg, batch, dtype=f32, device=home)
    carry = init_commander_carry(batch, dtype=f32, device=home)
    cmd = torch.zeros(batch + (6,), dtype=f32, device=home)
    cmd[..., 0] = 0.2

    def full_step(p, c, u):
        out, c_next = commander_step(p.com, p.joints, c, u, dt, cfg,
                                     qp_iterations=8, qp_polish=True)
        p_next = plant_step(p, out.forces_world, out.gait.in_stance,
                            out.foot_refs_world, dt, cfg)
        return p_next, c_next, out.qp_converged

    plant2, _carry2, conv = map_shards(mesh, full_step, plant, carry, cmd)
    frac = convergence_fraction(conv, f32)
    _finite("SRB plant state", plant2.com.x)
    print(f"dryrun_multichip({n_devices}): ok — SRB step over "
          f"{len(mesh)} shards, conv_frac={float(frac):.3f}", flush=True)

    model = mit_cheetah_whole_body_model(cfg, dtype=f32, device=home)
    wb_plant, wb_carry = init_whole_body_rollout(cfg, batch, dtype=f32,
                                                 device=home)
    run = shard_rollout_whole_body(mesh, cfg, model, n_substeps=2,
                                   qp_iterations=6)
    res = run(wb_plant, wb_carry, cmd, 1)
    _finite("whole-body plant state", res.plant.x)
    print(f"dryrun_multichip({n_devices}): whole-body ok — x on "
          f"{res.plant.x.device}", flush=True)

    # The fused three-kernel tick, barrier-only QP (the certified polish
    # adds nothing to what this run checks: the sharded dispatch).
    tick = make_fused_tick(model, cfg, ContactConfig(), rows=8,
                           gravity_comp=True, qp_polish=False)
    res_f = shard_rollout_whole_body_fused(mesh, tick, n_substeps=2)(
        wb_plant, wb_carry, cmd, 1)
    _finite("fused-tick plant state", res_f.plant.x)
    print(f"dryrun_multichip({n_devices}): fused ok — x on "
          f"{res_f.plant.x.device}", flush=True)

    # The deployment-shape configuration: the warm MPC tick, decimated
    # (re-solved every 2 ticks, forces held between). Small horizon, few
    # iterations: this checks the sharded dispatch and the warm carry across
    # solve groups, not MPC convergence.
    tick_mpc = make_fused_tick(model, cfg, ContactConfig(), rows=8,
                               gravity_comp=True, controller="mpc",
                               mpc_horizon=4, mpc_dt=0.02, mpc_iterations=3,
                               mpc_warm_start=True)
    res_m = shard_rollout_whole_body_fused(mesh, tick_mpc, n_substeps=2,
                                           mpc_every=2)(
        wb_plant, wb_carry, cmd, 2)
    _finite("MPC-tick plant state", res_m.plant.x)
    print(f"dryrun_multichip({n_devices}): mpc ok — x on "
          f"{res_m.plant.x.device}", flush=True)
