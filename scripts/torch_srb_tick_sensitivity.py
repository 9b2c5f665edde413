#!/usr/bin/env python3
"""How far one SRB closed-loop tick of the port moves under 1-ulp noise on
its float32 state: the floor under any comparison of the same tick on two
devices (chip_smoke.py's teacher-forced ticks, SRB_TF_TOLS).

Runs the port's plain versions on the CPU (no card needed):

    python3 scripts/torch_srb_tick_sensitivity.py

Three states of the balance loop (stood up after the 2 s stand-up, then 150
and 300 ticks into a 0.2 m/s trot; K1's plain version, barrier only, 12
iterations) and three of the MPC loop (stood up after 450 decimated ticks,
then 200 and 400 ticks into the trot; K6's plain version, N = 8, cold, 25
iterations), four robots each. From each state the tick (commander_step +
plant_step) runs once as is and five times with the state's R, x, xdot, w,
q and qdot multiplied by (1 + 2^-23 n), n standard normal; printed is the
largest change of each output and whether the stance and converged masks
moved.
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from quadruped_control_tpu_torch.config import (  # noqa: E402
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control import rollout as srb  # noqa: E402
from quadruped_control_tpu_torch.control.commander import (  # noqa: E402
    commander_step,
    init_commander_carry,
)
from quadruped_control_tpu_torch.control.plant import (  # noqa: E402
    init_plant_state,
    plant_step,
)

B, REPS = 4, 5
CFG = mit_cheetah_physical_config()
DT = 1.0 / CFG.frequency
BALANCE = dict(qp_backend="fused", qp_iterations=12, qp_polish=False)
MPC = dict(controller="mpc", mpc_horizon=8, mpc_dt=0.05, mpc_iterations=25,
           mpc_backend="riccati-pallas")


def tick(plant, carry, cmd, kw):
    out, _ = commander_step(plant.com, plant.joints, carry, cmd, DT, CFG,
                            **kw)
    return out, plant_step(plant, out.forces_world, out.gait.in_stance,
                           out.foot_refs_world, DT, CFG)


def outputs(out, plant):
    return dict(forces=out.forces_world, torques=out.torques,
                x=plant.com.x, xdot=plant.com.xdot, w=plant.com.w,
                R=plant.com.R, feet=plant.feet_world, q=plant.joints.q,
                qdot=plant.joints.qdot)


def sensitivity(name, plant, carry, cmd, kw, gen):
    def noisy(t):
        return t * (1.0 + 2.0 ** -23 * torch.randn(t.shape, generator=gen))

    out0, p0 = tick(plant, carry, cmd, kw)
    ref = outputs(out0, p0)
    worst = {k: 0.0 for k in ref}
    masks_equal = True
    for _ in range(REPS):
        com = plant.com._replace(R=noisy(plant.com.R), x=noisy(plant.com.x),
                                 xdot=noisy(plant.com.xdot),
                                 w=noisy(plant.com.w))
        joints = plant.joints._replace(q=noisy(plant.joints.q),
                                       qdot=noisy(plant.joints.qdot))
        out1, p1 = tick(plant._replace(com=com, joints=joints), carry, cmd,
                        kw)
        for k, v in outputs(out1, p1).items():
            worst[k] = max(worst[k], (v - ref[k]).abs().max().item())
        masks_equal &= bool(torch.equal(out1.qp_converged,
                                        out0.qp_converged)
                            and torch.equal(out1.gait.in_stance,
                                            out0.gait.in_stance))
    print(f"{name}: " + ", ".join(f"{k} {v:.2e}" for k, v in worst.items())
          + f"; masks unmoved {masks_equal}; converged "
          f"{out0.qp_converged.float().mean().item():.3f}", flush=True)


def main():
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    t0 = time.time()
    cmd = torch.zeros(B, 6)
    cmd[:, 0] = 0.2
    state = srb.stand_up_rollout(CFG, seconds=2.0, batch_shape=(B,),
                                 device="cpu", record=False)
    sensitivity("balance, stood up", state.plant, state.carry, cmd, BALANCE,
                gen)
    for k in (150, 300):
        state = srb.rollout(state.plant, state.carry, cmd, 150, CFG,
                            record=False)
        sensitivity(f"balance, trot + {k}", state.plant, state.carry, cmd,
                    BALANCE, gen)
    dec = dict(mpc_every=10, record=False,
               **{k: v for k, v in MPC.items() if k != "controller"})
    state = srb.rollout_mpc_decimated(
        init_plant_state(CFG, (B,), device="cpu"),
        init_commander_carry((B,), device="cpu"), 0.0 * cmd, 450, CFG, **dec)
    sensitivity("MPC, stood up", state.plant, state.carry, cmd, MPC, gen)
    for k in (200, 400):
        state = srb.rollout_mpc_decimated(state.plant, state.carry, cmd, 200,
                                          CFG, **dec)
        sensitivity(f"MPC, trot + {k}", state.plant, state.carry, cmd, MPC,
                    gen)
    print(f"{time.time() - t0:.0f} s")


if __name__ == "__main__":
    main()
