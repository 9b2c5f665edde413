"""PyTorch port: gradients through the whole MPC walking loop
(``rollout_mpc_decimated`` with the structured MPC: FK, the gait clock, the
Raibert planner, sextic swing tracking, IK, the Riccati IPM, the J^T torque
map and the SRB plant, across ticks), against ``jax.grad`` in float64 from
the same standing state (the JAX package's 2 s stand-up), the setting of
tests/test_mpc_commander.py:91 and :160.

d loss / d vx over 30 ticks: the port's autograd equals ``jax.grad`` within
1e-8 relative (on a CPU the two agree to ~1e-15) and the port's
own central difference within 1e-7, the JAX test's bar.

d loss / d state weights over 20 ticks runs only with ``QCT_HEAVY=1``: its
``jax.grad`` compiles for ~25 s on a CPU, beside the ~25 s of the first
test, and the file must stay under a minute. Same tolerances; the central
difference on the height weight within the JAX test's 1e-5.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control import rollout as jroll
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import rollout as troll

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
F64 = torch.float64
W0 = np.array([50.0, 50.0, 10.0, 1.0, 1.0, 100.0,
               1.0, 1.0, 5.0, 5.0, 5.0, 2.0, 0.0])


@pytest.fixture(scope="module")
def stand():
    """The JAX package's 2 s stand-up, and the same state in the port."""
    res = jroll.stand_up_rollout(JCFG, seconds=2.0, dtype=jnp.float64)
    assert bool(res.carry.standing)
    return res, (convert.plant_state_from_numpy(res.plant, dtype=F64,
                                                device="cpu"),
                 convert.commander_carry_from_numpy(res.carry, dtype=F64,
                                                    device="cpu"))


def _cmd_torch(vx):
    return torch.cat([vx.reshape(1), torch.zeros(5, dtype=F64)])


def test_gradient_through_mpc_walking_loop(stand):
    jstand, (plant, carry) = stand
    kw = dict(mpc_every=5, mpc_horizon=4, mpc_dt=0.04, mpc_iterations=12,
              mpc_backend="structured", record=False)

    def jloss(vx):
        cmd = jnp.zeros((6,), jnp.float64).at[0].set(vx)
        res = jroll.rollout_mpc_decimated(jstand.plant, jstand.carry, cmd,
                                          30, JCFG, **kw)
        return (res.plant.com.xdot[0] - 0.2) ** 2

    def tloss(vx):
        res = troll.rollout_mpc_decimated(plant, carry, _cmd_torch(vx), 30,
                                          TCFG, **kw)
        return (res.plant.com.xdot[0] - 0.2) ** 2

    g_j = float(jax.grad(jloss)(0.1))
    vx = torch.tensor(0.1, dtype=F64, requires_grad=True)
    tloss(vx).backward()
    g_t = float(vx.grad)
    assert np.isfinite(g_t)
    assert abs(g_t - g_j) <= 1e-8 * (1.0 + abs(g_j)), (g_t, g_j)
    with torch.no_grad():
        fd = float(tloss(torch.tensor(0.1 + 1e-6, dtype=F64))
                   - tloss(torch.tensor(0.1 - 1e-6, dtype=F64))) / 2e-6
    assert abs(g_t - fd) / (1.0 + abs(fd)) < 1e-7, (g_t, fd)


@pytest.mark.skipif(os.environ.get("QCT_HEAVY") != "1",
                    reason="jax.grad compiles ~25 s; set QCT_HEAVY=1")
def test_gradient_wrt_mpc_state_weights(stand):
    jstand, (plant, carry) = stand
    kw = dict(mpc_every=5, mpc_horizon=4, mpc_dt=0.04, mpc_iterations=12,
              mpc_backend="structured", record=False)
    cmd_j = jnp.zeros((6,), jnp.float64).at[0].set(0.2)
    cmd_t = torch.tensor([0.2, 0, 0, 0, 0, 0], dtype=F64)

    def jloss(w):
        res = jroll.rollout_mpc_decimated(jstand.plant, jstand.carry, cmd_j,
                                          20, JCFG, mpc_state_weights=w, **kw)
        return ((res.plant.com.x[2] - 0.26) ** 2 * 1e4
                + (res.plant.com.xdot[0] - 0.2) ** 2)

    def tloss(w):
        res = troll.rollout_mpc_decimated(plant, carry, cmd_t, 20, TCFG,
                                          mpc_state_weights=w, **kw)
        return ((res.plant.com.x[2] - 0.26) ** 2 * 1e4
                + (res.plant.com.xdot[0] - 0.2) ** 2)

    g_j = np.asarray(jax.grad(jloss)(jnp.asarray(W0)))
    w = torch.tensor(W0, dtype=F64, requires_grad=True)
    tloss(w).backward()
    g_t = w.grad.numpy()
    assert np.all(np.isfinite(g_t))
    np.testing.assert_allclose(g_t, g_j, rtol=0.0,
                               atol=1e-8 * (1.0 + np.abs(g_j).max()))
    e = np.zeros(13)
    e[5] = 1e-4
    with torch.no_grad():
        fd = float(tloss(torch.tensor(W0 + e)) - tloss(torch.tensor(W0 - e))
                   ) / 2e-4
    assert abs(fd - g_t[5]) / (1.0 + abs(fd)) < 1e-5, (fd, g_t[5])
