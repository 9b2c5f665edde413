"""PyTorch port: sim/fused_tick.py — the closed-loop whole-body tick as a
whole (commander-pre K4 -> GRF QP K1 -> physics substeps K5), on the CPU
through the kernels' plain versions. The plant is float64 here, the QP
float32 inside (its kernel's type).

Teacher-forced against the JAX package, stage by stage, on tick 1 from the
laying pose and on two synthetic mid-walk ticks:

  - K4's outputs against the JAX kernel body ``commander_pre_sym`` called
    eagerly (1e-8 relative: its polynomial atan2 is 1.6e-10 off), masks
    exactly;
  - the QP at the objective level only — the 4-stance family is flat along
    its near-nullspace, so forces are not compared: against the JAX dense IPM
    in float64 on the same problem, median 1e-6 and maximum 1e-4 relative on
    the converged lanes;
  - the state after the substeps against the JAX torque map +
    ``whole_body_step(m_update="tick")`` fed the SAME forces: 1e-8 (in-kernel
    factor).

The JAX fused tick itself is three Pallas kernels; in interpret mode its
compiles take tens of minutes on a CPU, so it is not run here.

Then the loop: warm tick 1 bitwise equals cold tick 1, chunked equals
unchunked bitwise (warm carry across chunks, per-tick command schedule,
trace), pack/unpack round trips, the options reach K4, ``controller="mpc"``
builds the MPC tick (held in tests/test_torch_fused_mpc_tick.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control import pallas_commander as jpc
from quadruped_control_tpu.ops.dynamics import (
    forces_to_body_frame as j_forces_to_body_frame,
)
from quadruped_control_tpu.ops.kinematics import (
    jacobian_transpose_control as j_jt_control,
)
from quadruped_control_tpu.sim import dynamics as jdyn
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu.sim import plant as jplant
from quadruped_control_tpu.solver import ipm as jipm
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import fused_commander as fc
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.control.rollout import piecewise_command
from quadruped_control_tpu_torch.ops.dynamics import SWING_ROW_RELAX
from quadruped_control_tpu_torch.sim import (
    ContactConfig,
    init_whole_body_rollout,
    init_whole_body_state,
)
from quadruped_control_tpu_torch.sim import fused_tick as ft
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.solver import fused as pf
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    assert_close,
    carry_comps_np,
    objective_np,
    state_comps_np,
    t2n,
    torch_commander_carry,
    torch_whole_body_state,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
JM = jmodel.mit_cheetah_whole_body_model(JCFG, dtype=jnp.float64)
TM = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float64,
                                         device="cpu")
TM32 = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float32,
                                           device="cpu")
DT = 1.0 / TCFG.frequency
N_SUB = 4
K4_NAMES = ("r", "b", "st", "mu", "fz_min", "fz_max", "tau_swing", "carry",
            "q_ref")
DISCRETE_CARRY = [0, 2, 3, 4, 5, 6, 91, 92, 93, 94]
BASE = dict(s_diag=tuple(TCFG.balance.s_diag),
            w_diag=float(TCFG.balance.w_diag))


def _tick_inputs(case):
    """(state (58, B), carry (95, B), cmd (6, B)) as float64 NumPy arrays."""
    if case == "init":
        B = 4
        plant = init_whole_body_state(TCFG, (B,), dtype=torch.float64,
                                      device="cpu")
        state = t2n(ft.pack_whole_body_state(plant)[0])
        carry = t2n(fc.pack_commander_carry(init_commander_carry(
            (B,), dtype=torch.float64, device="cpu")))
        return state, carry, np.zeros((6, B))
    seed = {"walk-a": 101, "walk-b": 202}[case]
    B = 24
    d = whole_body_walk_states(seed, B, TCFG, on_ground=True)
    return (state_comps_np(d),
            carry_comps_np(commander_carry_walk(seed + 1, B, TCFG)),
            d["cmd"].T.copy())


def _jax_commander_pre(state, carry, cmd):
    s, c, m = jnp.asarray(state), jnp.asarray(carry), jnp.asarray(cmd)
    out = jpc.commander_pre_sym(jpc.CommanderConsts(JCFG, DT),
                                lambda i: s[i], lambda i: c[i],
                                lambda i: m[i])
    one = {k: np.asarray(out[k])[None] for k in ("mu", "fz_min", "fz_max")}
    return dict({k: np.stack(out[k]) for k in K4_NAMES if k not in one},
                **one)


def _jax_after_tick(state, fw, tau_sw, st):
    """The JAX package's torque map + plant step fed the given forces."""
    B = state.shape[1]
    flat = state.T
    js = jplant.WholeBodyState(
        R=jnp.asarray(flat[:, 0:9].reshape(B, 3, 3)),
        x=jnp.asarray(flat[:, 9:12]), u=jnp.asarray(flat[:, 12:30]),
        q=jnp.asarray(flat[:, 30:42].reshape(B, 4, 3)),
        anchor=jnp.asarray(flat[:, 42:58].reshape(B, 8, 2)))
    f_b = j_forces_to_body_frame(jnp.asarray(fw.T), js.R,
                                 jnp.ones((B, 4), bool))
    tau = jnp.where(jnp.asarray(st.T > 0.5)[..., None],
                    j_jt_control(js.q, f_b, JCFG.kinematics),
                    jnp.asarray(tau_sw.T.reshape(B, 4, 3)))
    tau = tau + jdyn.leg_gravity_torques(JM, js.q, js.R)
    tau = jnp.clip(tau, JCFG.balance.torque_min, JCFG.balance.torque_max)
    out = jplant.whole_body_step(js, tau, DT, JM, JCFG, n_substeps=N_SUB,
                                 m_update="tick")
    return np.concatenate(
        [np.asarray(out.R).reshape(B, 9), np.asarray(out.x),
         np.asarray(out.u), np.asarray(out.q).reshape(B, 12),
         np.asarray(out.anchor).reshape(B, 16)], axis=-1).T


@pytest.mark.parametrize("case", ["init", "walk-a", "walk-b"])
def test_tick_teacher_forced_against_jax(case):
    state, carry, cmd = _tick_inputs(case)
    B = state.shape[1]
    # Tick 1 of a run uses the defaults (6 warm barrier iterations, here
    # reset cold by st_prev = -1: enough from the laying pose). The synthetic
    # mid-walk states are wild and have no previous solution to start from:
    # their cold solve gets the long barrier (20 iterations), as a first
    # tick of such a state would need.
    tick = ft.make_fused_tick(TM, TCFG, ContactConfig(), gravity_comp=True,
                              qp_iterations=None if case == "init" else 20)
    assert tick.warm_start and tick.launches_per_tick == 3
    warm0 = ft.init_qp_warm_packed(B, device="cpu")
    state_t, carry_t, cmd_t = (torch.as_tensor(a) for a in (state, carry, cmd))
    new_state, new_carry, warm, (st_p, diag) = tick(
        state_t, carry_t, warm0, cmd_t, DT, N_SUB)

    # Stage 1: K4 against the JAX kernel body.
    want = _jax_commander_pre(state, carry, cmd)
    got = dict(zip(K4_NAMES, tick.pre(state_t, carry_t, cmd_t)))
    assert np.array_equal(t2n(got["st"]), want["st"])
    assert np.array_equal(t2n(got["carry"])[DISCRETE_CARRY],
                          want["carry"][DISCRETE_CARRY])
    for name in K4_NAMES:
        assert_close(got[name], want[name], 1e-8, name)
    assert torch.equal(new_carry, got["carry"])
    assert torch.equal(st_p, got["st"])
    assert new_carry.dtype == torch.float64

    # Stage 2: the QP, at the objective level, on the problem the JAX K4
    # outputs define (dense data from the port's assembly, float64).
    x_p, s_p, z_p, st_w = warm
    assert x_p.dtype == torch.float32 and st_w.dtype == torch.float32
    assert torch.equal(st_w.double(), st_p)
    qp_in = tuple(torch.as_tensor(want[k].copy()) for k in K4_NAMES[:6])
    Q, c, G, h = (t2n(a).T for a in pf._assembly_plain(
        *qp_in, swing_relax=SWING_ROW_RELAX, equilibrated=False, **BASE))
    Q, G = Q.reshape(B, 12, 12), G.reshape(B, 24, 12)
    ref = jipm.solve_qp_ipm(jnp.asarray(Q), jnp.asarray(c), jnp.asarray(G),
                            jnp.asarray(h), iterations=30, polish=True)
    conv = (t2n(diag[1]) > 0.5) & np.asarray(ref.converged)
    assert conv.mean() >= 0.75, conv.mean()
    obj = objective_np(Q, c, t2n(x_p).T)
    obj_ref = objective_np(Q, c, np.asarray(ref.x))
    rel = (np.abs(obj - obj_ref) / (1.0 + np.abs(obj_ref)))[conv]
    assert np.median(rel) < 1e-6 and rel.max() < 1e-4, (np.median(rel),
                                                        rel.max())
    viol = np.einsum("bij,bj->bi", G, t2n(x_p).T.astype(np.float64)) - h
    assert viol[conv].max() < 1e-3

    # Stage 3: the substeps, both sides fed the port's forces.
    want_state = _jax_after_tick(state, t2n(x_p).astype(np.float64),
                                 want["tau_swing"], want["st"])
    assert new_state.dtype == torch.float64
    assert_close(new_state, want_state, 1e-8, "state after the tick")
    assert bool(torch.isfinite(new_state).all())


def _rollout_inputs(batch, dtype=torch.float32):
    plant, carry = init_whole_body_rollout(TCFG, batch, dtype=dtype,
                                           device="cpu")
    return plant, carry


def _equal_trees(a, b):
    if a is None or b is None:
        return a is b
    if torch.is_tensor(a):
        return a.dtype == b.dtype and torch.equal(a, b)
    return len(a) == len(b) and all(_equal_trees(x, y) for x, y in zip(a, b))


def test_warm_tick_first_tick_is_cold_start():
    """A zero warm carry with st_prev = -1 marks every cone row stale: tick 1
    of the warm tick is bitwise the cold tick with the same iteration
    count."""
    state, carry, cmd = (torch.as_tensor(a, dtype=torch.float32)
                         for a in _tick_inputs("walk-a"))
    B = state.shape[1]
    warm_tick = ft.make_fused_tick(TM32, TCFG, gravity_comp=True)
    cold_tick = ft.make_fused_tick(TM32, TCFG, gravity_comp=True,
                                   qp_warm_start=False, qp_iterations=6)
    assert not cold_tick.warm_start
    sw, cw, warm, (stw, dw) = warm_tick(
        state, carry, ft.init_qp_warm_packed(B, device="cpu"), cmd, DT, N_SUB)
    sc, cc, (stc, dc) = cold_tick(state, carry, cmd, DT, N_SUB)
    assert torch.equal(sw, sc) and torch.equal(cw, cc)
    assert torch.equal(stw, stc) and torch.equal(dw, dc)
    # The warm carry of tick 1 changes tick 2 (it is really used).
    sw2, _, _, (_, dw2) = warm_tick(sw, cw, warm, cmd, DT, N_SUB)
    sc2, _, (_, dc2) = cold_tick(sc, cc, cmd, DT, N_SUB)
    assert not torch.equal(dw2, dc2) and not torch.equal(sw2, sc2)
    # Default iteration counts: 6 warm, 12 cold.
    cold12 = ft.make_fused_tick(TM32, TCFG, gravity_comp=True,
                                qp_warm_start=False)
    _, _, (_, d12) = cold12(state, carry, cmd, DT, N_SUB)
    assert not torch.equal(d12, dc)


def test_chunked_equals_unchunked_bitwise():
    batch = (2, 2)
    plant, carry = _rollout_inputs(batch)
    # Start near standing height so the latch and the gait start are crossed.
    plant = plant._replace(x=plant.x + torch.tensor([0.0, 0.0, 0.17]))
    # Two polish sweeps keep the CPU's plain QP short; the loop is the same.
    tick = ft.make_fused_tick(TM32, TCFG, gravity_comp=True,
                              qp_polish_sweeps=2)
    steps = 5
    sched = piecewise_command([(2 * DT, [0.0] * 6),
                               (3 * DT, [0.2, 0, 0, 0, 0, 0.1])],
                              TCFG.frequency, device="cpu")
    assert sched.shape == (steps, 6)
    whole = ft.rollout_whole_body_fused(plant, carry, sched, steps, tick,
                                        n_substeps=2, record=True,
                                        cmd_schedule=True)
    # Chunks of 2, 2 and 1 ticks; the schedule given per lane, (steps, 2, 2,
    # 6) with every lane equal, is the same run as the (steps, 6) one.
    per_lane = sched[:, None, None, :].expand(steps, 2, 2, 6)
    parts = ft.rollout_whole_body_fused_chunked(
        plant, carry, per_lane, steps, tick, chunk=2, n_substeps=2,
        record=True, cmd_schedule=True)
    assert _equal_trees(whole.plant, parts.plant)
    assert _equal_trees(whole.carry, parts.carry)
    assert _equal_trees(whole.trace, parts.trace)
    assert _equal_trees(whole.warm, parts.warm)
    assert whole.trace.x.shape == (steps, 2, 2, 3)
    assert whole.trace.in_stance.shape == (steps, 2, 2, 4)
    assert whole.trace.in_stance.dtype == torch.bool
    assert whole.trace.qp_converged.dtype == torch.bool
    assert whole.plant.q.shape == (2, 2, 4, 3)
    assert whole.carry.gait_time.shape == (2, 2)
    assert all(bool(torch.isfinite(a).all()) for a in whole.plant)
    plain = ft.rollout_whole_body_fused(plant, carry, sched[0], 1, tick,
                                        n_substeps=2)
    assert plain.trace is None and plain.warm is not None
    with pytest.raises(ValueError, match="cmd_schedule"):
        ft.rollout_whole_body_fused(plant, carry, sched, 3, tick,
                                    n_substeps=2, cmd_schedule=True)


def test_cold_tick_rollout_and_the_tail():
    """qp_warm_start=False returns no warm carry. qp_polish=False with
    qp_tail=True is four launches per tick: the tail re-solves the worst
    lanes, as many as the JAX package's slice at this batch (rows 8 pad 24
    lanes to 1024, whose quarter exceeds 24: every lane), and never loses a
    converged one."""
    plant, carry = _rollout_inputs((3,))
    cold = ft.make_fused_tick(TM32, TCFG, gravity_comp=True,
                              qp_warm_start=False)
    res = ft.rollout_whole_body_fused(plant, carry, torch.zeros(6), 1, cold,
                                      n_substeps=2, record=True)
    assert res.warm is None and res.trace.x.shape == (1, 3, 3)
    assert bool(res.trace.qp_converged.all())

    state, carry_p, cmd = (torch.as_tensor(a, dtype=torch.float32)
                           for a in _tick_inputs("walk-a"))
    B = state.shape[1]
    kw = dict(gravity_comp=True, qp_polish=False, qp_iterations=12)
    bare = ft.make_fused_tick(TM32, TCFG, **kw)
    tail = ft.make_fused_tick(TM32, TCFG, qp_tail=True, rows=8,
                              qp_tail_rows=1, qp_tail_sweeps=8,
                              qp_tail_prox_steps=1, **kw)
    assert bare.launches_per_tick == 3 and tail.launches_per_tick == 4
    warm0 = ft.init_qp_warm_packed(B, device="cpu")
    _, _, wb, (_, db) = bare(state, carry_p, warm0, cmd, DT, 2)
    _, _, wt, (_, dt_) = tail(state, carry_p, warm0, cmd, DT, 2)
    conv_b, conv_t = db[1] > 0.5, dt_[1] > 0.5
    assert bool((conv_t | ~conv_b).all())
    assert int(conv_t.sum()) - int(conv_b.sum()) >= 1
    Bt = pf.qp_tail_size(B, rows=8, tail_rows=1, tail_divisor=4)
    assert Bt == B
    assert int((conv_t & ~conv_b).sum()) <= Bt
    # The improved lanes changed in the warm carry too; the others did not.
    changed = (wt[0] != wb[0]).any(0)
    assert bool((changed & ~conv_b)[conv_t & ~conv_b].all())
    assert not bool(changed[conv_b].any())


def test_options_reach_the_commander_kernel():
    state, carry, cmd = (torch.as_tensor(a) for a in _tick_inputs("walk-b"))
    kw = dict(contact_gate=0.01, raibert_cmd_symmetric=True)
    tick = ft.make_fused_tick(TM, TCFG, **kw)
    got = tick.pre(state, carry, cmd)
    want = fc.commander_pre_plain(tick.consts, state, carry, cmd, **kw)
    plain = fc.commander_pre_plain(tick.consts, state, carry, cmd)
    assert _equal_trees(got, want)
    assert not _equal_trees(got, plain)
    assert tick.consts.dt == DT
    assert not tick.stepper.consts.gravity_comp
    assert tick.stepper.consts.torque_qp and tick.stepper.consts.prefactor_kernel


def test_pack_unpack_round_trips():
    d = whole_body_walk_states(7, 6, TCFG)
    state = torch_whole_body_state(d)
    shaped = type(state)(*(a.reshape((2, 3) + a.shape[1:]) for a in state))
    packed, B = ft.pack_whole_body_state(shaped, rows=8)
    assert B == 6 and packed.shape == (58, 6) and packed.is_contiguous()
    assert np.array_equal(t2n(packed), state_comps_np(d))
    back = ft.unpack_whole_body_state(packed, (2, 3))
    assert _equal_trees(back, shaped)
    back_np = convert.to_numpy(ft.unpack_whole_body_state(packed, (6,)))
    assert all(np.array_equal(back_np[k], d[k]) for k in back_np)

    c = commander_carry_walk(8, 6, TCFG)
    carry = torch_commander_carry(c)
    carry_p = fc.pack_commander_carry(carry)
    again = fc.unpack_commander_carry(carry_p, (6,), carry)
    assert torch.equal(fc.pack_commander_carry(again), carry_p)

    warm = ft.init_qp_warm_packed(5, rows=8, device="cpu")
    assert [tuple(a.shape) for a in warm] == [(12, 5), (24, 5), (24, 5),
                                              (4, 5)]
    assert all(a.dtype == torch.float32 for a in warm)
    assert bool((warm[3] == -1).all()) and not any(
        bool(a.any()) for a in warm[:3])

    one = ft._pack_cmd([0.2, 0, 0, 0, 0, 0.1], (2, 3), 6, torch.float64,
                       torch.device("cpu"))
    assert one.shape == (6, 6) and bool((one[0] == 0.2).all())
    sched = ft._pack_cmd(torch.arange(24.0).reshape(4, 6), (2, 3), 6,
                         torch.float64, torch.device("cpu"), steps=4)
    assert sched.shape == (4, 6, 6) and sched.is_contiguous()
    assert bool((sched[2, 1] == 13.0).all())


def test_mpc_is_the_third_slice():
    """controller="mpc" builds the MPC tick (tests/test_torch_fused_mpc_tick.py
    holds it); the balance tick has none of its attributes, and unknown
    arguments raise."""
    mpc = ft.make_fused_tick(TM, TCFG, controller="mpc")
    assert hasattr(mpc, "held") and mpc.launches_per_tick == 3
    assert (mpc.mpc_horizon, mpc.mpc_dt) == (8, 0.03)
    assert not mpc.warm_start and not hasattr(mpc, "init_warm")
    warm = ft.init_mpc_warm_packed(5, horizon=8, rows=8, device="cpu")
    assert [tuple(a.shape) for a in warm] == [(96, 5), (384, 5), (32, 5)]
    with pytest.raises(ValueError, match="mpc"):
        ft.rollout_whole_body_fused_decimated(
            *_rollout_inputs((2,)), torch.zeros(6), 4,
            ft.make_fused_tick(TM32, TCFG))
    with pytest.raises(ValueError, match="controller"):
        ft.make_fused_tick(TM, TCFG, controller="lqr")
    with pytest.raises(TypeError, match="horizon"):
        ft.make_fused_tick(TM, TCFG, horizon=8)
    # The MPC options are taken (and unused) by the balance tick, as in the
    # JAX package.
    balance = ft.make_fused_tick(TM, TCFG, mpc_horizon=8, mpc_dt=0.03)
    assert not hasattr(balance, "held")
