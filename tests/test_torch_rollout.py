"""PyTorch port: the SRB closed-loop rollouts of control/rollout.py with the
balance controller (``qp_backend="jnp"``), against the JAX package, float64.

Teacher-forced: the JAX package's own ``rollout`` steps two robots one tick
at a time from the laying pose (560 ticks of stand-up, then 120 of a trot
command that differs per robot) and records every state; the port's
``rollout`` then takes one tick from each chosen recorded state (the first
ticks, the standing latch, the gait start, a leg's lift-off and its next
tick, the last). Per tick the next plant state, the next carry and the trace
entry agree within 1e-9 (relative to each field's largest value, plus
1e-9); masks (standing, stance, converged, planner flags) exactly. Two
implementations of one dense IPM close the loop: they agree to ~1e-15 on a
free-running stand-up, so 1e-9 leaves room for nothing but round-off.

Then the port's own rules, as the JAX tests hold them: ``rollout_chunked``
bitwise one ``rollout`` (tests/test_rollout.py:82), a constant
``cmd_schedule`` bitwise the plain rollout (106), ``record=False``, the
schedule's shape check, the ``foothold_trim`` carry, and a short stand-up
with the behaviour limits of tests/test_rollout.py:30-45 that apply to it.
The multi-second walks run on the card (chip_smoke.py phase f).
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
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import (
    FootholdTrimConfig,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control import rollout as troll
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.control.plant import init_plant_state
from torch_port_helpers import assert_trees_close

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
TOL = 1e-9
F64 = torch.float64
STAND, WALK = 560, 120
CMD = np.array([[0.2, 0, 0, 0, 0, 0], [-0.1, 0.05, 0, 0, 0, 0.05]])


@pytest.fixture(scope="module")
def jax_record():
    """[(plant, carry, cmd, trace entry of the tick from it)] of the JAX
    package's rollout, one tick a call."""
    p = jplant.init_plant_state(JCFG, (2,), dtype=jnp.float64)
    c = jcmd.init_commander_carry((2,), dtype=jnp.float64)
    rec = []
    for t in range(STAND + WALK):
        cmd = jnp.asarray(CMD if t >= STAND else 0.0 * CMD)
        res = jroll.rollout(p, c, cmd, 1, JCFG)
        rec.append((p, c, cmd, jax.tree.map(lambda a: a[0], res.trace)))
        p, c = res.plant, res.carry
    rec.append((p, c, None, None))
    return rec


def _lift_off(rec):
    """First walking tick at which a leg goes from stance to swing."""
    for t in range(STAND, STAND + WALK):
        prev = np.asarray(rec[t][1].planner.prev_in_stance)
        now = np.asarray(rec[t][3].in_stance)
        if np.any(prev & ~now):
            return t
    raise AssertionError("no lift-off in the recorded walk")


def test_teacher_forced_balance_ticks(jax_record):
    rec = jax_record
    stand_tick = int(np.argmax(np.asarray(
        [np.all(np.asarray(r[3].standing)) for r in rec[:STAND]])))
    lift = _lift_off(rec)
    ticks = sorted({0, 1, stand_tick, stand_tick + 1, STAND - 1, STAND,
                    lift, lift + 1, STAND + WALK - 1})
    assert 0 < stand_tick < STAND
    for t in ticks:
        jp, jc, cmd, jtrace = rec[t]
        res = troll.rollout(
            convert.plant_state_from_numpy(jp, dtype=F64, device="cpu"),
            convert.commander_carry_from_numpy(jc, dtype=F64, device="cpu"),
            torch.as_tensor(np.array(cmd)), 1, TCFG)
        assert_trees_close(res.plant, rec[t + 1][0], TOL, f"plant {t}")
        assert_trees_close(res.carry, rec[t + 1][1], TOL, f"carry {t}")
        assert_trees_close(
            convert.rollout_trace_to_numpy(res.trace),
            convert.rollout_trace_to_numpy(jax.tree.map(lambda a: a[None],
                                                        jtrace)),
            TOL, f"trace {t}")
    # The walk covered both phases and both robots moved their own way.
    st = np.stack([np.asarray(r[3].in_stance) for r in rec[STAND:-1]])
    assert st.any() and not st.all()
    x_end = np.asarray(rec[-1][0].com.x)
    assert x_end[0, 0] > x_end[1, 0]


def _init(batch=(), dtype=F64):
    return (init_plant_state(TCFG, batch, dtype=dtype, device="cpu"),
            init_commander_carry(batch, dtype=dtype, device="cpu"))


def test_rollout_chunked_matches_single_rollout():
    plant, carry = _init()
    cmd = torch.zeros(6, dtype=F64)
    a = troll.rollout(plant, carry, cmd, 45, TCFG)
    b = troll.rollout_chunked(plant, carry, cmd, 45, TCFG, chunk=20)
    for got, want in ((b.trace, a.trace), (b.plant, a.plant),
                      (b.carry, a.carry)):
        assert_trees_close(got, want, 0.0)
    assert a.trace.x.shape == (45, 3)
    c = troll.rollout_chunked(plant, carry, cmd, 45, TCFG, chunk=20,
                              record=False)
    assert c.trace == 0
    assert_trees_close(c.plant, a.plant, 0.0)


def test_cmd_schedule_constant_matches_plain():
    plant, carry = _init()
    cmd = torch.tensor([0.2, 0, 0, 0, 0, 0], dtype=F64)
    steps = 30
    sched = cmd.expand(steps, 6)
    a = troll.rollout(plant, carry, cmd, steps, TCFG)
    b = troll.rollout(plant, carry, sched, steps, TCFG, cmd_schedule=True)
    assert_trees_close(b.trace, a.trace, 0.0)
    assert_trees_close(b.plant, a.plant, 0.0)
    # Chunked with a schedule slices it chunk by chunk.
    c = troll.rollout_chunked(plant, carry, sched, steps, TCFG, chunk=7,
                              cmd_schedule=True)
    assert_trees_close(c.trace, a.trace, 0.0)
    with pytest.raises(AssertionError):
        troll.rollout(plant, carry, sched[:-1], steps, TCFG,
                      cmd_schedule=True)


def test_record_false_and_foothold_trim_carry():
    plant, carry = _init((2,))
    cmd = torch.zeros(2, 6, dtype=F64)
    res = troll.rollout(plant, carry, cmd, 2, TCFG, record=False)
    assert res.trace == 0
    assert carry.ref_pose is None
    trimmed = troll.rollout(plant, carry, cmd, 2, TCFG,
                            foothold_trim=FootholdTrimConfig())
    assert trimmed.carry.ref_pose.shape == (2, 3)
    assert trimmed.carry.ref_pose.dtype == F64


def test_short_stand_up_behaviour():
    """0.5 s of the stand-up from the laying pose (the first 150 of
    tests/test_rollout.py's 600 ticks): finite, rising, torques within the
    20 N m clamp, every QP converged, and not yet standing (the latch sits
    at 0.26 m +- 5 mm)."""
    res = troll.stand_up_rollout(TCFG, seconds=0.5, batch_shape=(2,),
                                 dtype=F64, device="cpu")
    z = res.trace.x[..., 2].numpy()
    assert res.trace.x.shape == (150, 2, 3)
    assert np.all(np.isfinite(res.trace.x.numpy()))
    assert z[-1, 0] > z[0, 0] + 0.05, (z[0, 0], z[-1, 0])
    assert np.all(res.trace.torque_max.numpy() <= 20.0 + 1e-9)
    assert res.trace.qp_converged.numpy().mean() > 0.99
    assert not res.trace.standing[-1].any()
    np.testing.assert_array_equal(res.trace.x[:, 0].numpy(),
                                  res.trace.x[:, 1].numpy())


def test_walk_rollout_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        troll.walk_rollout(TCFG, seconds=0.01)
