"""PyTorch port: the SRB rollouts with the receding-horizon MPC
(``controller="mpc"``, ``mpc_backend="structured"``) against the JAX
package, float64: per-tick ``rollout`` and ``rollout_mpc_decimated``.

Teacher-forced as in test_torch_rollout.py: the JAX package's ``rollout``
steps two robots one tick at a time with the MPC of
tests/test_mpc_commander.py (N = 5, mpc_dt = 0.04, 18 iterations) from the
laying pose to the standing latch and 100 ticks of a trot command beyond
it (a pair of legs lifts off); the port takes one tick from chosen recorded
states. Then one decimated
group (``mpc_every=10``: one MPC solve, nine held ticks) from the last
recorded state in both hold modes, at an MPC step (0.01 s) for which the
"horizon" hold walks through four horizon steps. Both packages run the same
structured Riccati IPM in float64, so the tolerance is round-off carried
through one solve and ten plant steps: 1e-8 relative to each field's
largest value, plus 1e-8; masks exactly. ``hold_indices`` is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control import commander as jcmd
from quadruped_control_tpu.control import plant as jplant
from quadruped_control_tpu.control import rollout as jroll
from quadruped_control_tpu_torch import convert, kernels
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import rollout as troll
from torch_port_helpers import assert_trees_close

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
TOL = 1e-8
F64 = torch.float64
MPC_KW = dict(controller="mpc", mpc_horizon=5, mpc_dt=0.04,
              mpc_iterations=18, mpc_backend="structured")
WALK = 100
CMD = np.array([[0.2, 0, 0, 0, 0, 0], [0.1, -0.05, 0, 0, 0, -0.05]])
DEC_KW = dict(mpc_every=10, mpc_horizon=5, mpc_dt=0.01, mpc_iterations=18,
              mpc_backend="structured")


@pytest.fixture(scope="module")
def jax_record():
    """[(plant, carry, cmd, trace entry)] of the JAX package's MPC rollout,
    one tick a call, up to WALK ticks past the standing latch."""
    p = jplant.init_plant_state(JCFG, (2,), dtype=jnp.float64)
    c = jcmd.init_commander_carry((2,), dtype=jnp.float64)
    rec, latch = [], None
    while latch is None or len(rec) < latch + WALK:
        cmd = jnp.asarray(CMD if latch is not None else 0.0 * CMD)
        res = jroll.rollout(p, c, cmd, 1, JCFG, **MPC_KW)
        rec.append((p, c, cmd, jax.tree.map(lambda a: a[0], res.trace)))
        p, c = res.plant, res.carry
        if latch is None and bool(np.all(np.asarray(c.standing))):
            latch = len(rec)
        assert len(rec) < 600, "the MPC stand-up never latched"
    rec.append((p, c, None, None))
    return rec, latch


def _torch_state(jp, jc):
    return (convert.plant_state_from_numpy(jp, dtype=F64, device="cpu"),
            convert.commander_carry_from_numpy(jc, dtype=F64, device="cpu"))


def test_teacher_forced_mpc_ticks(jax_record):
    rec, latch = jax_record
    n = len(rec) - 1
    for t in sorted({0, latch - 1, latch, latch + 1, n - 2, n - 1}):
        jp, jc, cmd, jtrace = rec[t]
        res = troll.rollout(*_torch_state(jp, jc),
                            torch.as_tensor(np.array(cmd)), 1, TCFG,
                            **MPC_KW)
        assert_trees_close(res.plant, rec[t + 1][0], TOL, f"plant {t}")
        assert_trees_close(res.carry, rec[t + 1][1], TOL, f"carry {t}")
        assert_trees_close(troll.RolloutTrace(*(a[0] for a in res.trace)),
                           jtrace, TOL, f"trace {t}")
    # The recorded walk reached a swing phase.
    st = np.stack([np.asarray(r[3].in_stance) for r in rec[latch:-1]])
    assert not st.all()


@pytest.mark.parametrize("hold_mode", ["zoh", "horizon"])
def test_decimated_group_matches_jax(jax_record, hold_mode):
    rec, _ = jax_record
    jp, jc = rec[-1][0], rec[-1][1]
    cmd = np.array(CMD)
    want = jroll.rollout_mpc_decimated(jp, jc, jnp.asarray(cmd), 20, JCFG,
                                       hold_mode=hold_mode, **DEC_KW)
    got = troll.rollout_mpc_decimated(*_torch_state(jp, jc),
                                      torch.as_tensor(cmd), 20, TCFG,
                                      hold_mode=hold_mode, **DEC_KW)
    assert got.trace.x.shape == (2, 2, 3)  # group level: 20 / 10 entries
    for a, b, what in ((got.plant, want.plant, "plant"),
                       (got.carry, want.carry, "carry"),
                       (got.trace, want.trace, "trace")):
        assert_trees_close(a, b, TOL, f"{hold_mode} {what}")


def test_hold_indices_exact():
    dt = 1.0 / 300.0
    assert troll.hold_indices(10, dt, 0.03, 8, "zoh") == [0] * 9
    # k = 9 sits exactly on 0.03 s: the +1e-9 floor picks step 1.
    assert troll.hold_indices(10, dt, 0.03, 8, "horizon") == [0] * 8 + [1]
    assert troll.hold_indices(10, dt, 0.01, 5, "horizon") == [
        0, 0, 1, 1, 1, 2, 2, 2, 3]
    assert troll.hold_indices(10, dt, 0.01, 2, "horizon") == [
        0, 0, 1, 1, 1, 1, 1, 1, 1]  # capped at N - 1
    assert troll.hold_indices(1, dt, 0.03, 8, "horizon") == []
    with pytest.raises(AssertionError):
        troll.hold_indices(10, dt, 0.03, 8, "linear")


def test_decimated_rules(jax_record):
    rec, _ = jax_record
    plant, carry = _torch_state(rec[-1][0], rec[-1][1])
    cmd = torch.as_tensor(np.array(CMD))
    with pytest.raises(AssertionError):
        troll.rollout_mpc_decimated(plant, carry, cmd, 15, TCFG, **DEC_KW)
    res = troll.rollout_mpc_decimated(plant, carry, cmd, 10, TCFG,
                                      record=False, **DEC_KW)
    assert res.trace == 0


def test_riccati_backend_on_cpu_launches_nothing(jax_record):
    """On CPU tensors mpc_backend="riccati-pallas" runs K6's plain version
    (float32): no launch is counted, and the loop stays finite."""
    rec, latch = jax_record
    plant, carry = (convert.plant_state_from_numpy(rec[latch][0],
                                                   device="cpu"),
                    convert.commander_carry_from_numpy(rec[latch][1],
                                                       device="cpu"))
    kernels.reset_launch_counts()
    res = troll.rollout_mpc_decimated(
        plant, carry, torch.as_tensor(CMD, dtype=torch.float32), 10, TCFG,
        **dict(DEC_KW, mpc_backend="riccati-pallas"))
    assert not any(kernels.launch_counts.values())
    assert torch.all(torch.isfinite(res.plant.com.x))
    assert res.plant.com.x.dtype == torch.float32
