#!/usr/bin/env python
"""Verify drive of the PyTorch port: the MPC-in-the-loop commander on the
card in float32 (twin of scripts/verify_mpc_drive.py, with its limits).

The public rollout API with controller="mpc" (the structured Riccati
backend, plain PyTorch) for a batched stand-up and a short trot, chunked
(control/rollout.rollout_chunked), with physical checks.

    python3 scripts/torch_verify_mpc_drive.py
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch import resolve_device  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config  # noqa: E402
from quadruped_control_tpu_torch.control.commander import init_commander_carry  # noqa: E402
from quadruped_control_tpu_torch.control.plant import init_plant_state  # noqa: E402
from quadruped_control_tpu_torch.control.rollout import rollout_chunked  # noqa: E402


def main():
    dev = resolve_device(None)
    cfg = mit_cheetah_physical_config()
    B = (256,)
    print("device:", torch.cuda.get_device_name(dev), flush=True)
    kw = dict(controller="mpc", mpc_horizon=6, mpc_dt=0.04,
              mpc_iterations=20, mpc_backend="structured")
    f32 = dict(dtype=torch.float32, device=dev)

    plant = init_plant_state(cfg, B, **f32)
    carry = init_commander_carry(B, **f32)
    cmd0 = torch.zeros(B + (6,), **f32)
    cmd_walk = cmd0.clone()
    cmd_walk[..., 0] = 0.2

    # cfg.frequency is 300 Hz: 450 ticks = 1.5 s (the MPC approach to the
    # stand height is asymptotic and needs ~1.2 s).
    stand = rollout_chunked(plant, carry, cmd0, 450, cfg, **kw)
    z = stand.trace.x[..., 2]
    print("stand: z end", z[-1, :3].tolist(), "standing frac",
          stand.trace.standing[-1].float().mean().item(), flush=True)
    assert bool(((z[-1] - 0.26).abs() < 0.015).all()), z[-1].min().item()
    assert bool(torch.isfinite(z).all())

    T_WALK = 600  # 2 s
    walk = rollout_chunked(stand.plant, stand.carry, cmd_walk, T_WALK, cfg,
                           **kw)
    x = walk.trace.x
    conv = walk.trace.qp_converged.float()
    v = (x[-1, :, 0] - x[0, :, 0]) / (T_WALK / cfg.frequency)
    dz = (x[..., 2] - 0.26).abs().max().item()
    print("walk: mean vx", v.mean().item(), "height dev max", dz, flush=True)
    print("mpc converged frac:", conv.mean().item(), flush=True)
    assert v.mean().item() > 0.1
    assert dz < 0.05
    assert bool(torch.isfinite(x).all())
    print("OK: MPC commander drives the closed loop on the card in float32")


if __name__ == "__main__":
    main()
