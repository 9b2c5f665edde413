#!/usr/bin/env python
"""Host-clock ms per tick of the port's MPC loops on the card, by MPC
backend: the whole-body loop of scripts/torch_verify_range_drive.py
(batch-less, URDF inertials, N = 24, 25 iterations) with the structured MPC
(eager PyTorch) and with the MPC kernel K6 (``riccati-pallas``), and the SRB
loop of scripts/torch_verify_mpc_drive.py (B = 256, N = 6, 20 iterations,
structured). It says what those drives cost on the card and why the range
drive runs its horizon in K6.

    python3 scripts/torch_mpc_backend_ticks.py

Prints one line per loop; the card's name and power limit first.
"""

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch import resolve_device  # noqa: E402
from quadruped_control_tpu_torch.config import (  # noqa: E402
    FootholdTrimConfig,
    JointControlConfig,
    mit_cheetah_physical_config,
    mit_cheetah_whole_body_config,
)
from quadruped_control_tpu_torch.control.commander import init_commander_carry  # noqa: E402
from quadruped_control_tpu_torch.control.plant import init_plant_state  # noqa: E402
from quadruped_control_tpu_torch.control.rollout import rollout  # noqa: E402
from quadruped_control_tpu_torch.sim import (  # noqa: E402
    ContactConfig,
    init_whole_body_rollout,
    mit_cheetah_urdf_model,
    rollout_whole_body,
)


def per_tick_ms(run, warm, ticks):
    run(warm)
    torch.cuda.synchronize()
    t0 = time.time()
    run(ticks)
    torch.cuda.synchronize()
    return (time.time() - t0) / ticks * 1e3


def main():
    dev = resolve_device(None)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip(), flush=True)
    f32 = dict(dtype=torch.float32, device=dev)
    cfg = dataclasses.replace(mit_cheetah_whole_body_config(),
                              joint_control=JointControlConfig())
    model = mit_cheetah_urdf_model(cfg, **f32)
    wts = torch.tensor([50.0, 1000.0, 10.0, 1.0, 1.0, 100.0,
                        1.0, 1.0, 5.0, 5.0, 5.0, 2.0, 0.0], **f32)
    plant, carry = init_whole_body_rollout(cfg, **f32)
    for backend in ("structured", "riccati-pallas"):
        kw = dict(controller="mpc", mpc_backend=backend, mpc_horizon=24,
                  mpc_dt=0.02, mpc_iterations=25, gravity_comp=True,
                  raibert_cmd_symmetric=True,
                  foothold_trim=FootholdTrimConfig(yaw_gain=0.6,
                                                   lat_gain=0.2),
                  mpc_state_weights=wts, n_substeps=10)
        ms = per_tick_ms(lambda n, kw=kw: rollout_whole_body(
            plant, carry, torch.zeros(6, **f32), n, cfg, model,
            ContactConfig(), record=False, **kw), 1, 5)
        print(f"range drive's whole-body tick, N = 24, {backend}: {ms:.1f} "
              f"ms a tick (host clock over 5 ticks, batch-less)", flush=True)

    pcfg = mit_cheetah_physical_config()
    p = init_plant_state(pcfg, (256,), **f32)
    c = init_commander_carry((256,), **f32)
    kw = dict(controller="mpc", mpc_horizon=6, mpc_dt=0.04,
              mpc_iterations=20, mpc_backend="structured")
    ms = per_tick_ms(lambda n: rollout(p, c, torch.zeros((256, 6), **f32), n,
                                       pcfg, record=False, **kw), 2, 10)
    print(f"mpc drive's SRB tick, N = 6, structured, B = 256: {ms:.1f} ms a "
          f"tick (host clock over 10 ticks)", flush=True)


if __name__ == "__main__":
    main()
