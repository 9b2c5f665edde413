#!/usr/bin/env python
"""Drive the PyTorch port's fused three-kernel whole-body tick on the card
in float32 (twin of scripts/verify_fused_tick.py, with its limits).

Behaviour: stand-up from the laying pose latches the 0.26 m target; a
0.2 m/s trot (the reference's gait-transition demo speed, README.md:57)
stays upright. Then marginal ms per tick (CUDA events) of the fused tick
(K4 -> K1 -> K5) against the three-stage path it replaces (the plain
commander with the fused QP backend, K1, and the fused substep stepper,
K5), at B = 1024 and 4096.

    python3 scripts/torch_verify_fused_tick.py

Prints PASS or FAIL as its last line (exit 0 / 1).
"""

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch import resolve_device  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config  # noqa: E402
from quadruped_control_tpu_torch.control.commander import init_commander_carry  # noqa: E402
from quadruped_control_tpu_torch.sim import (  # noqa: E402
    ContactConfig,
    init_whole_body_state,
    make_fused_stepper,
    mit_cheetah_whole_body_model,
    rollout_whole_body,
)
from quadruped_control_tpu_torch.sim.fused_tick import (  # noqa: E402
    make_fused_tick,
    rollout_whole_body_fused,
)


def log(m):
    print(m, file=sys.stderr, flush=True)


def device_ms(fn):
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def main():
    dev = resolve_device(None)
    cfg = mit_cheetah_physical_config()
    f32 = dict(dtype=torch.float32, device=dev)
    model = mit_cheetah_whole_body_model(cfg, **f32)
    contact = ContactConfig()
    log(f"device: {torch.cuda.get_device_name(dev)}")

    # gravity_comp=True is the documented full-physics operating point;
    # barrier-only QP (qp_polish=False), 12 cold iterations: the JAX
    # original's configuration. Criteria of tests/test_whole_body_loop.py.
    tick = make_fused_tick(model, cfg, contact, rows=8, qp_iterations=12,
                           qp_polish=False, qp_warm_start=False,
                           gravity_comp=True)

    # ---- behaviour: stand-up then trot at 0.2 m/s -------------------------
    B = 256
    wb = init_whole_body_state(cfg, (B,), **f32)
    carry = init_commander_carry((B,), **f32)
    cmd0 = torch.zeros((B, 6), **f32)
    res = rollout_whole_body_fused(wb, carry, cmd0, 600, tick,
                                   n_substeps=10, record=True)
    z = res.plant.x[:, 2]
    up = res.plant.R[:, 2, 2]
    conv = res.trace.qp_converged.float().mean().item()
    standing = res.carry.standing.float().mean().item()
    log(f"stand-up: z mean {z.mean().item():.4f} (min {z.min().item():.4f}), "
        f"upright R22 min {up.min().item():.4f}, conv {conv:.4f}, standing "
        f"{standing:.3f}")
    ok_stand = (abs(z.mean().item() - cfg.stand.height) < 0.015
                and up.min().item() > 0.98 and conv > 0.98
                and standing > 0.9)

    cmd = torch.zeros((B, 6), **f32)
    cmd[:, 0] = 0.2
    res2 = rollout_whole_body_fused(res.plant, res.carry, cmd, 600, tick,
                                    n_substeps=10, record=True)
    up2 = res2.plant.R[:, 2, 2]
    xtrav = res2.plant.x[:, 0].mean().item()
    upright_frac = (up2 > 0.9).float().mean().item()
    log(f"trot 0.2 m/s, 600 ticks (2 s): x {xtrav:.3f} m, z mean "
        f"{res2.plant.x[:, 2].mean().item():.4f}, upright frac "
        f"{upright_frac:.4f}, conv "
        f"{res2.trace.qp_converged.float().mean().item():.4f}")
    ok_trot = upright_frac > 0.95 and xtrav > 0.15

    # ---- timing: fused tick vs commander(fused QP) + fused stepper ---------
    for B in (1024, 4096):
        wb = init_whole_body_state(cfg, (B,), **f32)
        carry = init_commander_carry((B,), **f32)
        carry = carry._replace(standing=torch.ones((B,), dtype=torch.bool,
                                                   device=dev))
        cmdB = torch.zeros((B, 6), **f32)
        cmdB[:, 0] = 0.2
        tickB = make_fused_tick(model, cfg, contact, rows=8,
                                qp_iterations=12, qp_polish=False,
                                qp_warm_start=False)
        stepper = make_fused_stepper(model, cfg, contact, rows=8,
                                     prefactor="kernel")

        def run_fused(steps):
            return rollout_whole_body_fused(wb, carry, cmdB, steps, tickB,
                                            n_substeps=10, record=False)

        def run_ref(steps):
            return rollout_whole_body(
                wb, carry, cmdB, steps, cfg, model, contact, n_substeps=10,
                qp_iterations=12, qp_backend="fused", record=False,
                stepper=stepper)

        for name, fn, lo, hi in (("fused-tick", run_fused, 50, 450),
                                 ("ref-3stage", run_ref, 20, 100)):
            best = {}
            for steps in (lo, hi):
                fn(steps)  # warm-up
                best[steps] = min(device_ms(lambda: fn(steps))
                                  for _ in range(3))
            per = (best[hi] - best[lo]) / (hi - lo)
            log(f"B={B} {name}: {per:.4f} ms/tick -> "
                f"{B / per * 1e3:,.0f} scenario-ticks/s "
                f"({B / per * 1e3 / cfg.frequency:,.0f}x realtime)")

    print("PASS" if (ok_stand and ok_trot) else "FAIL")
    return 0 if (ok_stand and ok_trot) else 1


if __name__ == "__main__":
    sys.exit(main())
