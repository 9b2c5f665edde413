#!/usr/bin/env python
"""Drive the PyTorch port's behaviour surface on the card in float32 (twin
of scripts/verify_range_drive.py, with its limits).

Flows: FK -> IK round trip, the balance QP on a standing scenario, the
whole-body loop (the URDF inertials, the N = 24 MPC) standing up and
walking at 0.4 m/s with the swing instruments, and turning while walking
with body_frame_exact and the heading servo. 100-tick chunks, as the
original.

One change from the original: its MPC backend is "structured" (the O(N)
Riccati IPM, which XLA fuses on the TPU); here the same N = 24 horizon QP
goes to the MPC kernel K6 (``mpc_backend="riccati-pallas"``), because the
port's structured MPC is eager PyTorch, one small launch per operation of
the sweep, and would take over an hour for the drive's 2,100 ticks on the
card (scripts/torch_mpc_backend_ticks.py times a tick both ways). The
limits are the original's.

    python3 scripts/torch_verify_range_drive.py

Prints VERIFY_OK as its last line when every limit holds.
"""

import dataclasses
import math
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch import resolve_device  # noqa: E402
from quadruped_control_tpu_torch.config import (  # noqa: E402
    FootholdTrimConfig,
    JointControlConfig,
    mit_cheetah_whole_body_config,
)
from quadruped_control_tpu_torch.ops.dynamics import build_balance_qp  # noqa: E402
from quadruped_control_tpu_torch.ops.kinematics import (  # noqa: E402
    forward_kinematics,
    inverse_kinematics,
)
from quadruped_control_tpu_torch.sim import (  # noqa: E402
    ContactConfig,
    init_whole_body_rollout,
    mit_cheetah_urdf_model,
    rollout_whole_body,
)
from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm  # noqa: E402


def main():
    dev = resolve_device(None)
    print("device:", torch.cuda.get_device_name(dev), flush=True)
    f32 = dict(dtype=torch.float32, device=dev)
    cfg = dataclasses.replace(mit_cheetah_whole_body_config(),
                              joint_control=JointControlConfig())
    model = mit_cheetah_urdf_model(cfg, **f32)
    contact = ContactConfig()

    # --- flow 1: FK -> IK round trip on the reference init pose ---
    q0 = torch.tensor([0.0, 1.61, -2.78], **f32).repeat(4, 1)
    p = forward_kinematics(q0, cfg.kinematics)
    qerr = (inverse_kinematics(p, cfg.kinematics) - q0).abs().max().item()
    print("FK feet:", [[round(v, 4) for v in r] for r in p.tolist()],
          flush=True)
    print("IK roundtrip max err:", qerr, flush=True)
    assert qerr < 1e-4
    assert abs(abs(p[0, 0].item()) - 0.196) < 0.01
    assert abs(p[0, 2].item() + 0.0815) < 0.01

    # --- flow 2: balance QP, standing scenario ---
    R = torch.eye(3, **f32)
    x = torch.tensor([0.0, 0.0, 0.26], **f32)
    z3 = torch.zeros(3, **f32)
    prob = build_balance_qp(R, R, x, z3, z3, x, z3, z3, p,
                            torch.ones(4, dtype=torch.bool, device=dev),
                            cfg.balance)
    sol = solve_qp_ipm(prob.Q, prob.c, prob.G, prob.h, iterations=20)
    fz = sol.x.reshape(4, 3)[:, 2]
    print("QP stance fz:", [round(v, 2) for v in fz.tolist()], "conv:",
          bool(sol.converged), flush=True)
    assert bool(sol.converged)
    assert bool((fz > 10).all()) and bool((fz < 120).all())
    assert abs(fz.sum().item() - cfg.balance.mass * 9.81) < 2.0

    # --- flow 3: whole-body loop, the operating point + swing instruments --
    wts = torch.tensor([50.0, 1000.0, 10.0, 1.0, 1.0, 100.0,
                        1.0, 1.0, 5.0, 5.0, 5.0, 2.0, 0.0], **f32)
    kw = dict(controller="mpc", mpc_backend="riccati-pallas", mpc_horizon=24,
              mpc_dt=0.02, mpc_iterations=25, gravity_comp=True,
              raibert_cmd_symmetric=True,
              foothold_trim=FootholdTrimConfig(yaw_gain=0.6, lat_gain=0.2),
              mpc_state_weights=wts, n_substeps=10)
    walk_kw = dict(kw, swing_vel_rescale=True, swing_start_ground=True,
                   foothold_trim=FootholdTrimConfig(yaw_gain=0.6,
                                                    lat_gain=0.2,
                                                    heading_lead=0.15))
    plant, carry = init_whole_body_rollout(cfg, **f32)

    def drive(state, cmd, chunks, run_kw):
        for _ in range(chunks):
            res = rollout_whole_body(state[0], state[1], cmd, 100, cfg,
                                     model, contact, record=False, **run_kw)
            state = (res.plant, res.carry)
        torch.cuda.synchronize()
        return state

    t0 = time.time()
    state = drive((plant, carry), torch.zeros(6, **f32), 9, kw)
    print(f"stand-up 900 ticks: {time.time() - t0:.1f}s  "
          f"z={state[0].x[2].item():.3f} "
          f"standing={bool(state[1].standing)}", flush=True)
    assert bool(state[1].standing)
    # The JAX original's bound, set on the TPU in float32 (the in-place
    # gait holds ~2 cm above the float64 CPU height there).
    assert abs(state[0].x[2].item() - cfg.stand.height) < 0.035

    cmd = torch.zeros(6, **f32)
    cmd[0] = 0.4
    t0 = time.time()
    x0 = state[0].x[0].item()
    state = drive(state, cmd, 6, walk_kw)  # 2 s at 0.4 m/s
    dx = state[0].x[0].item() - x0
    rz = state[0].R[2, 2].item()
    print(f"walk 0.4 m/s 600 ticks: {time.time() - t0:.1f}s  dx={dx:+.3f} "
          f"z={state[0].x[2].item():.3f} R22={rz:.3f}", flush=True)
    assert bool(torch.isfinite(state[0].x).all())
    assert rz > 0.85
    assert dx > 0.3

    # --- flow 4: body_frame_exact + the heading servo, turning while
    # walking ---
    bfe_kw = dict(kw, body_frame_exact=True,
                  foothold_trim=FootholdTrimConfig(yaw_gain=0.6, lat_gain=0.2,
                                                   heading_lead=0.1))
    cmd = torch.zeros(6, **f32)
    cmd[0], cmd[5] = 0.2, 0.05
    t0 = time.time()
    x0 = state[0].x[0].item()
    state = drive(state, cmd, 6, bfe_kw)  # 2 s turning while walking
    dx = state[0].x[0].item() - x0
    rz = state[0].R[2, 2].item()
    yaw = math.atan2(state[0].R[1, 0].item(), state[0].R[0, 0].item())
    print(f"turn-while-walk (bfe+servo) 600 ticks: {time.time() - t0:.1f}s "
          f"dx={dx:+.3f} yaw={yaw:+.3f} R22={rz:.3f}", flush=True)
    assert bool(torch.isfinite(state[0].x).all())
    assert rz > 0.9
    assert dx > 0.25          # kept walking
    assert 0.02 < yaw < 0.35  # heading advanced with the commanded wz

    print("VERIFY_OK", flush=True)


if __name__ == "__main__":
    main()
