#!/usr/bin/env python
"""Verification drive of the PyTorch port's public surfaces on the card, in
float32 (twin of scripts/verify_drive.py, with its limits): the fused
balance solve (solver/fused.py, K1 + K2) on standing scenarios with physical
checks, the structured Riccati MPC (mpc/structured.py) on a hover problem,
the two-phase fused solve and the commander's fused backend, and the MPC
kernel K6 (mpc/fused_riccati.solve_mpc_fused) on 1024 hover problems.

Run from the repository root on a machine with a card:

    python3 scripts/torch_verify_drive.py

Prints VERIFY OK on stderr and exits 0 when every limit holds.
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch import resolve_device  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config  # noqa: E402
from quadruped_control_tpu_torch.control.commander import (  # noqa: E402
    commander_step,
    init_commander_carry,
)
from quadruped_control_tpu_torch.control.plant import init_plant_state  # noqa: E402
from quadruped_control_tpu_torch.mpc.fused_riccati import solve_mpc_fused  # noqa: E402
from quadruped_control_tpu_torch.mpc.horizon import (  # noqa: E402
    NX,
    make_reference_trajectory,
)
from quadruped_control_tpu_torch.mpc.structured import solve_mpc_structured  # noqa: E402
from quadruped_control_tpu_torch.solver.fused import solve_balance_qp_fused  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    grf_scenarios,
    standing_feet,
)

B = 1024
N = 8
DT = 0.03


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    dev = resolve_device(None)
    log(f"device: {torch.cuda.get_device_name(dev)}")
    cfg = mit_cheetah_physical_config()
    kw = dict(dtype=torch.float32, device=dev)

    # --- fused balance solve: B standing instances, all legs stance ---
    feet = standing_feet(cfg, **kw).expand(B, 4, 3)
    eye = torch.eye(3, **kw).expand(B, 3, 3)
    x = torch.zeros((B, 3), **kw)
    x[:, 2] = 0.26
    zero3 = torch.zeros((B, 3), **kw)
    stance = torch.ones((B, 4), dtype=torch.bool, device=dev)
    sol = solve_balance_qp_fused(eye, eye, x, zero3, zero3, x, zero3, zero3,
                                 feet, stance, cfg.balance)
    f = sol.x.reshape(B, 4, 3)
    conv = sol.converged.float().mean().item()

    # --- structured MPC hover ---
    xi0 = torch.zeros(NX, **kw)
    xi0[5], xi0[12] = 0.22, 1.0
    com = torch.tensor([0.0, 0.0, 0.26], **kw)
    feet_w = standing_feet(cfg, **kw) + com
    ref = make_reference_trajectory(xi0, torch.zeros(6, **kw), N, DT)
    F, msol = solve_mpc_structured(
        xi0, ref, torch.zeros((), **kw), feet_w, com,
        torch.ones((N, 4), dtype=torch.bool, device=dev), N, DT, cfg,
        iterations=30)

    # --- the MPC kernel K6 ---
    Bm = 1024
    xi0m = torch.zeros((Bm, NX), **kw)
    xi0m[:, 5], xi0m[:, 12] = 0.22, 1.0
    refm = make_reference_trajectory(xi0m, torch.zeros((Bm, 6), **kw), N,
                                     DT)
    Fm, msol2 = solve_mpc_fused(
        xi0m, refm, torch.zeros((Bm,), **kw), feet_w.expand(Bm, 4, 3),
        com.expand(Bm, 3), torch.ones((Bm, N, 4), dtype=torch.bool,
                                      device=dev), N, DT, cfg,
        iterations=40)
    Fm3 = Fm.reshape(-1, N, 4, 3).cpu()
    mconv3 = msol2.converged.float().mean().item()
    log(f"riccati kernel: conv {mconv3:.4f}, step-0 sum fz "
        f"{Fm3[0, 0, :, 2].sum().item():.1f} N, finite "
        f"{bool(torch.isfinite(Fm3).all())}")
    assert bool(torch.isfinite(Fm3).all())
    assert mconv3 > 0.98
    assert Fm3[0, 0, :, 2].sum().item() > 11 * 9.81  # pushes harder when low

    # --- two-phase fused solve + commander fused backend ---
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    s = grf_scenarios(gen, 16384, cfg, device=dev)
    sol2 = solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, cfg.balance, rows=16, two_phase=True, polish_sweeps=2,
        split=True)
    plant = init_plant_state(cfg, (1024,), **kw)
    carry = init_commander_carry((1024,), **kw)
    out, _ = commander_step(plant.com, plant.joints, carry,
                            torch.zeros((1024, 6), **kw),
                            1.0 / cfg.frequency, cfg, qp_backend="fused")
    conv2 = sol2.converged.float().mean().item()
    tau = out.torques
    log(f"two-phase: conv {conv2:.4f}; commander-fused torques finite "
        f"{bool(torch.isfinite(tau).all())}, max "
        f"{tau.abs().max().item():.2f} N*m")
    assert conv2 > 0.99
    assert bool(torch.isfinite(tau).all())
    assert tau.abs().max().item() <= 20.0 + 1e-5

    total_fz = f[..., 2].sum(-1)
    log(f"fused: conv {conv:.4f}, sum fz mean {total_fz.mean().item():.2f} N "
        f"(mg = {11 * 9.81:.2f}), fz range [{f[..., 2].min().item():.1f}, "
        f"{f[..., 2].max().item():.1f}]")
    assert conv > 0.99
    assert abs(total_fz.mean().item() - 11 * 9.81) < 5.0
    assert f[..., 2].min().item() > 9.9 and f[..., 2].max().item() < 120.1

    Fs = F.reshape(N, 4, 3).cpu()
    log(f"structured MPC: conv {bool(msol.converged)}, step-0 sum fz "
        f"{Fs[0, :, 2].sum().item():.1f} N, finite "
        f"{bool(torch.isfinite(Fs).all())}")
    assert bool(torch.isfinite(Fs).all())
    # Starting 4 cm low the plan pushes harder than weight initially.
    assert Fs[0, :, 2].sum().item() > 11 * 9.81
    log("VERIFY OK")


if __name__ == "__main__":
    main()
