"""PyTorch port: sim/rollout.rollout_whole_body (the closed loop of many small
tensor operations: commander_step -> whole_body_step) against the JAX
package, float64, the dense IPM in the loop on both sides.

Three ticks from a state near standing height, with gravity compensation
and a per-tick command schedule. Two implementations of one solver close the
loop, so the tolerance is the solvers' agreement (1e-6 N on the forces,
tests/test_torch_commander.py) carried through a few substeps of stiff
contact: 1e-6 relative on the trace and the final state; masks exactly.
Then the port's own variants: ``stepper=`` (the fused substep stepper in the
loop), the re-exports, the argument checks.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control.commander import (
    init_commander_carry as j_init_carry,
)
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu.sim import plant as jplant
from quadruped_control_tpu.sim import rollout as jroll
from quadruped_control_tpu_torch import sim as tsim
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control.rollout import piecewise_command
from torch_port_helpers import assert_close, t2n

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
JM = jmodel.mit_cheetah_whole_body_model(JCFG, dtype=jnp.float64)
TM = tsim.mit_cheetah_whole_body_model(TCFG, dtype=torch.float64,
                                       device="cpu")
DT = 1.0 / TCFG.frequency
B, STEPS, N_SUB = 2, 3, 2
KW = dict(n_substeps=N_SUB, qp_iterations=20, qp_polish=True,
          gravity_comp=True, cmd_schedule=True)


def _start():
    """Both packages' (plant, carry) near standing height, lane 1 lower, and
    a (STEPS, 6) schedule: stand, then a trot command."""
    height = np.array([0.26, 0.22])
    tp, tc = tsim.init_whole_body_rollout(TCFG, (B,), dtype=torch.float64,
                                          device="cpu")
    tp = tp._replace(x=torch.stack(
        [tp.x[:, 0], tp.x[:, 1], torch.as_tensor(height)], dim=-1))
    jp = jplant.init_whole_body_state(JCFG, (B,), dtype=jnp.float64)
    jp = jp._replace(x=jp.x.at[:, 2].set(jnp.asarray(height)))
    jc = j_init_carry((B,), dtype=jnp.float64)
    sched = piecewise_command([(DT, [0.0] * 6),
                               (2 * DT, [0.2, 0, 0, 0, 0, 0.1])],
                              TCFG.frequency, dtype=torch.float64,
                              device="cpu")
    return tp, tc, jp, jc, sched


def test_rollout_whole_body_matches_jax():
    tp, tc, jp, jc, sched = _start()
    jres = jroll.rollout_whole_body(jp, jc, jnp.asarray(t2n(sched)), STEPS,
                                    JCFG, JM, **KW)
    tres = tsim.rollout_whole_body(tp, tc, sched, STEPS, TCFG, TM, **KW)
    for field in ("R", "x", "u", "q", "anchor"):
        assert_close(getattr(tres.plant, field), getattr(jres.plant, field),
                     1e-6, field)
    for field in ("standing", "in_stance", "qp_converged"):
        assert np.array_equal(t2n(getattr(tres.trace, field)),
                              np.asarray(getattr(jres.trace, field))), field
    for field in ("x", "xdot", "torque_max", "feet", "R"):
        assert_close(getattr(tres.trace, field), getattr(jres.trace, field),
                     1e-6, field)
    assert np.array_equal(t2n(tres.carry.standing),
                          np.asarray(jres.carry.standing))
    assert_close(tres.carry.gait_time, jres.carry.gait_time, 1e-12)
    assert tres.trace.x.shape == (STEPS, B, 3)
    assert bool(tres.carry.standing.any())


def test_stepper_in_the_loop_and_checks():
    tp, tc, _, _, sched = _start()
    ref = tsim.rollout_whole_body(tp, tc, sched, STEPS, TCFG, TM,
                                  record=False, **KW)
    assert ref.trace is None
    stepper = tsim.make_fused_stepper(TM, TCFG, tsim.ContactConfig(),
                                      prefactor="xla")
    res = tsim.rollout_whole_body(tp, tc, sched, STEPS, TCFG, TM,
                                  stepper=stepper, record=False, **KW)
    for a, b in zip(res.plant, ref.plant):
        assert_close(a, t2n(b), 1e-12)
    # One command for every tick, the fused QP back end in the loop.
    fused = tsim.rollout_whole_body(tp, tc, sched[0], 2, TCFG, TM,
                                    n_substeps=N_SUB, qp_backend="fused",
                                    qp_polish=True)
    dense = tsim.rollout_whole_body(tp, tc, sched[0], 2, TCFG, TM,
                                    n_substeps=N_SUB, qp_polish=True)
    assert_close(fused.plant.x, t2n(dense.plant.x), 1e-5)
    assert bool(fused.trace.qp_converged.all())
    with pytest.raises(ValueError, match="n_substeps"):
        tsim.rollout_whole_body(tp, tc, sched, STEPS, TCFG, TM,
                                stepper=stepper, cmd_schedule=True)
    with pytest.raises(ValueError, match="cmd_schedule"):
        tsim.rollout_whole_body(tp, tc, sched, 2, TCFG, TM, **KW)
    # controller="mpc" runs; an unknown MPC backend raises.
    mpc = tsim.rollout_whole_body(tp, tc, sched[0], 1, TCFG, TM,
                                  n_substeps=N_SUB, controller="mpc",
                                  mpc_horizon=3, mpc_iterations=6,
                                  mpc_backend="riccati-pallas")
    assert bool(torch.isfinite(mpc.plant.x).all())
    with pytest.raises(ValueError, match="mpc_backend"):
        tsim.rollout_whole_body(tp, tc, sched[0], 1, TCFG, TM,
                                controller="mpc", mpc_backend="osqp")


def test_sim_package_reexports():
    from quadruped_control_tpu import sim as jsim

    ours = set(tsim.__all__)
    for name in jsim.__all__:
        port_name = name.replace("make_pallas_stepper", "make_fused_stepper")
        assert port_name in ours and hasattr(tsim, port_name), name
