"""PyTorch port: gradients through the structured MPC solve and the
whole-body dynamics, and the kernel backends' refusal to give one.
``torch.autograd`` against ``jax.grad`` in float64 on the same inputs:

- the structured MPC solve (mpc/structured.py) with traced state weights
  and initial state (tests/test_mpc_structured.py:209), three robots on a
  trot schedule: 1e-8 relative to the largest entry;
- the gravity bias as the gradient of the potential
  (tests/test_whole_body.py:99-108): the port's autograd of the potential
  equals JAX's within 1e-12 and the port's RNEA bias within 1e-10.

A gradient asked for through K1 (``qp_backend="fused"``), K6
(``mpc_backend="riccati-pallas"``) or the dense kernels
(``solve_qp_ipm_fused``) raises instead of returning zero: the kernels
have no backward, as their Pallas counterparts have none.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_control_tpu.config import GRAVITY as JG
from quadruped_control_tpu.config import mit_cheetah_physical_config as jpcfg
from quadruped_control_tpu.mpc import structured as jms
from quadruped_control_tpu.sim import body_coms_world as jcoms
from quadruped_control_tpu.sim import mit_cheetah_whole_body_model as jmodel
from quadruped_control_tpu_torch import sim as tsim
from quadruped_control_tpu_torch.config import (
    GRAVITY,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control.commander import (
    commander_step,
    init_commander_carry,
)
from quadruped_control_tpu_torch.control.plant import init_plant_state
from quadruped_control_tpu_torch.mpc import fused_riccati as tfr
from quadruped_control_tpu_torch.mpc import structured as tms
from quadruped_control_tpu_torch.solver.fused_ipm import solve_qp_ipm_fused
from quadruped_control_tpu_torch.utils.scenarios import assemble_qp_batch
from torch_port_helpers import (
    mpc_args_jax,
    mpc_args_torch,
    mpc_problem_np,
    numpy_scenarios,
    t2n,
    torch_scenarios,
)

torch.set_num_threads(1)
F64 = torch.float64


def _close(got, want, tol, what=""):
    """|got - want| <= tol * (1 + max|want|)."""
    got = np.asarray(t2n(got) if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=tol * (1.0 + np.abs(want).max()),
                               err_msg=what)


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)


def test_structured_mpc_gradient_wrt_weights_and_state():
    cfg_j, cfg_t = jpcfg(), mit_cheetah_physical_config()
    N, dt = 4, 0.04
    d = mpc_problem_np(2, 3, N, dt, cfg_t)
    w0 = np.array([50.0, 50.0, 10.0, 1.0, 1.0, 100.0,
                   1.0, 1.0, 5.0, 5.0, 5.0, 2.0, 0.0])
    u = np.random.default_rng(4).normal(size=(N, 12))

    def jloss(w, xi0):
        args = mpc_args_jax(d)
        F, _ = jms.solve_mpc_structured(xi0, *args[1:], N, dt, cfg_j,
                                        iterations=25, state_weights=w)
        return jnp.sum(F * u) + jnp.sum(F[:, 0] ** 2) * 1e-3

    g_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w0),
                                          jnp.asarray(d["xi0"]))
    wt, xt = _leaf(w0), _leaf(d["xi0"])
    args = mpc_args_torch(d)
    F, _ = tms.solve_mpc_structured(xt, *args[1:], N, dt, cfg_t,
                                    iterations=25, state_weights=wt)
    (torch.sum(F * torch.as_tensor(u))
     + torch.sum(F[:, 0] ** 2) * 1e-3).backward()
    assert np.all(np.isfinite(t2n(wt.grad)))
    _close(wt.grad, g_j[0], 1e-8, "d/d weights")
    _close(xt.grad, g_j[1], 1e-8, "d/d xi0")


def test_gravity_bias_is_potential_gradient():
    jm = jmodel(jpcfg(), dtype=jnp.float64)
    tm = tsim.mit_cheetah_whole_body_model(mit_cheetah_physical_config(),
                                           dtype=F64, device="cpu")
    q = np.random.default_rng(0).uniform(-1.2, 1.2, (4, 3))
    R, x = np.eye(3), np.zeros(3)

    def jpot(qq):
        trunk, links = jcoms(jm, qq, jnp.asarray(R), jnp.asarray(x))
        return (jm.trunk_mass * JG * trunk[..., 2]
                + jnp.sum(jm.link_mass * JG * links[..., 2], axis=(-1, -2)))

    dV_j = jax.grad(jpot)(jnp.asarray(q))
    qt = _leaf(q)
    trunk, links = tsim.body_coms_world(tm, qt, torch.as_tensor(R),
                                        torch.as_tensor(x))
    (tm.trunk_mass * GRAVITY * trunk[..., 2]
     + torch.sum(tm.link_mass * GRAVITY * links[..., 2],
                 dim=(-1, -2))).backward()
    _close(qt.grad, dV_j, 1e-12, "dV/dq")
    kin = tsim.precompute_leg_kinematics(tm, torch.as_tensor(q))
    hb = tsim.rnea_bias(tm, kin, torch.as_tensor(R),
                        torch.zeros(6, dtype=F64),
                        torch.zeros((4, 3), dtype=F64))
    _close(hb[6:].reshape(4, 3), t2n(qt.grad), 1e-10, "RNEA bias")


def test_kernel_backends_refuse_gradients():
    cfg = mit_cheetah_physical_config()
    plant = init_plant_state(cfg, (2,), dtype=torch.float32, device="cpu")
    carry = init_commander_carry((2,), dtype=torch.float32, device="cpu")
    x = plant.com.x.clone().requires_grad_(True)
    com = plant.com._replace(x=x)
    cmd = torch.zeros(2, 6)
    with pytest.raises(RuntimeError, match="no backward"):
        commander_step(com, plant.joints, carry, cmd, 1 / 300, cfg,
                       qp_backend="fused")
    w = torch.ones(13, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        commander_step(plant.com, plant.joints, carry, cmd, 1 / 300, cfg,
                       controller="mpc", mpc_horizon=4,
                       mpc_backend="riccati-pallas", mpc_state_weights=w)
    qp = assemble_qp_batch(torch_scenarios(numpy_scenarios(0, 4), F64), cfg)
    Q = qp.Q.clone().requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        solve_qp_ipm_fused(Q, qp.c, qp.G, qp.h, device="cpu")
    # Without a gradient to build, the same calls run (plain versions).
    with torch.no_grad():
        out, _ = commander_step(com, plant.joints, carry, cmd, 1 / 300, cfg,
                                qp_backend="fused")
    assert torch.all(torch.isfinite(out.torques))
    d = mpc_problem_np(0, 2, 4, 0.04, cfg)
    F, _ = tfr.solve_mpc_fused(*mpc_args_torch(d, torch.float32), 4, 0.04,
                               cfg, iterations=10)
    assert torch.all(torch.isfinite(F))
