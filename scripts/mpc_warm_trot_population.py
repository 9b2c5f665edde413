#!/usr/bin/env python
"""The JAX package's fused MPC tick on a population of robots whose start
poses differ by 1e-4 m, on the CPU (Pallas kernels in interpret mode): the
reference's own answer to "does the warm-8 trot hold on every robot?".

scripts/verify_mpc_warm_tick.py drives one trajectory copied B times; the trot
of mit_cheetah_whole_body_config is a marginal limit cycle (PARITY.md
"stability anatomy"), so that run says survive or fall for all robots at once.
This script starts B = 1024 robots (one kernel tile) from the laying pose with
x and y shifted by 1e-4 * N(0, 1) m (numpy seed 80: the first 1024 robots of
chip_smoke.py's MPC phase), runs 600 ticks of stand-up and 900 of the 0.2 m/s
trot with the warm carry threaded through, and prints the share of robots
upright (R22 > 0.9) and with z > 0.15 m after every 100 trot ticks, the mean
x speed and the MPC converged fraction. Robot 0 has no shift: it is the
trajectory of scripts/verify_mpc_warm_tick.py.

Run (about 45 minutes on 8 CPU cores, most of it the interpreted kernels):

    JAX_PLATFORMS=cpu PYTHONPATH=. python scripts/mpc_warm_trot_population.py \
        [--iterations 8] [--cold]
"""

import argparse
import json
import sys
import time

import jax.numpy as jnp
import numpy as np

from quadruped_control_tpu.config import mit_cheetah_whole_body_config
from quadruped_control_tpu.control.commander import init_commander_carry
from quadruped_control_tpu.sim import (
    ContactConfig,
    init_whole_body_state,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu.sim.pallas_tick import (
    make_fused_tick,
    rollout_whole_body_fused_chunked,
)

B = 1024
STAND, TROT, CHUNK = 600, 900, 300


def log(m):
    print(m, file=sys.stderr, flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iterations", type=int, default=8)
    ap.add_argument("--cold", action="store_true",
                    help="no warm start (cold-15 is --cold --iterations 15)")
    a = ap.parse_args()
    cfg = mit_cheetah_whole_body_config()
    model = mit_cheetah_whole_body_model(cfg, dtype=jnp.float32)
    tick = make_fused_tick(model, cfg, ContactConfig(), rows=8,
                           controller="mpc", mpc_horizon=8, mpc_dt=0.03,
                           mpc_iterations=a.iterations,
                           mpc_warm_start=not a.cold, gravity_comp=True,
                           interpret=True)
    name = f"{'cold' if a.cold else 'warm'}-{a.iterations}"
    wb = init_whole_body_state(cfg, (B,), dtype=jnp.float32)
    shift = np.zeros((B, 3), np.float32)
    shift[:, :2] = 1e-4 * np.random.default_rng(80).standard_normal((B, 2))
    shift[0] = 0.0
    wb = wb._replace(x=wb.x + jnp.asarray(shift))
    carry = init_commander_carry((B,), dtype=jnp.float32)

    t0 = time.time()
    res = rollout_whole_body_fused_chunked(
        wb, carry, jnp.zeros((B, 6), jnp.float32), STAND, tick, chunk=CHUNK,
        n_substeps=10, record=True)
    z = np.asarray(res.plant.x[:, 2])
    stand = dict(z_mean=float(z.mean()),
                 standing=float(np.asarray(res.carry.standing).mean()),
                 upright=float((np.asarray(res.plant.R[:, 2, 2]) > 0.9)
                               .mean()),
                 mpc_converged=float(np.asarray(res.trace.qp_converged)
                                     .mean()))
    log(f"{name} stand-up ({time.time() - t0:.0f} s): {stand}")

    cmd = jnp.zeros((B, 6), jnp.float32).at[:, 0].set(0.2)
    x0 = np.asarray(res.plant.x[:, 0])
    t0 = time.time()
    res2 = rollout_whole_body_fused_chunked(
        res.plant, res.carry, cmd, TROT, tick, chunk=CHUNK, n_substeps=10,
        record=True, warm=res.warm)
    zt = np.asarray(res2.trace.x[:, :, 2])
    R22 = np.asarray(res2.plant.R[:, 2, 2])
    trot = dict(
        speed=float((np.asarray(res2.plant.x[:, 0]) - x0).mean()
                    / (TROT / cfg.frequency)),
        upright=float((R22 > 0.9).mean()),
        robot0_upright=bool(R22[0] > 0.9),
        mpc_converged=float(np.asarray(res2.trace.qp_converged).mean()),
        z_above_015_by_100=[float((zt[k] > 0.15).mean())
                            for k in range(99, TROT, 100)])
    log(f"{name} trot ({time.time() - t0:.0f} s): {trot}")
    print(json.dumps(dict(config=name, B=B, stand=stand, trot=trot)))


if __name__ == "__main__":
    sys.exit(main())
