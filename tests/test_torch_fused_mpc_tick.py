"""PyTorch port: the MPC tick of sim/fused_tick.py (commander-pre K4 with
its MPC block -> MPC kernel K6 -> substeps K5), on the CPU through the
kernels' plain versions; float64 plant, the MPC float32 inside (its kernel's
type).

  - Teacher-forced, two chained ticks from the laying pose and from a
    synthetic mid-walk state, against the port's own unfused composition
    ``commander_step(controller="mpc", mpc_backend="structured")`` +
    ``whole_body_step``: the stance mask and the swing torques exactly, the
    horizon forces at the objective level against the structured solve in
    float64 on the lanes the tick certifies, the state after the substeps
    (both fed the tick's step-0 forces) to 1e-8.
  - The loop: warm tick 1 from ``init_mpc_warm_packed`` equals the cold tick
    bitwise; ``rollout_whole_body_fused_decimated`` with ``mpc_every=1``
    equals the per-tick rollout, ``hold_mode="horizon"`` equals ``"zoh"``
    when every held tick maps to horizon step 0 (and differs when one does
    not), chunked equals unchunked with the warm carry; launch structure.
  - convert.py's MPC layouts round trip, the TPU tiles included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.mpc import pallas_riccati as jpr
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import commander as tcmd
from quadruped_control_tpu_torch.control import fused_commander as fc
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.mpc import horizon as th
from quadruped_control_tpu_torch.sim import (
    ContactConfig,
    init_whole_body_rollout,
    init_whole_body_state,
)
from quadruped_control_tpu_torch.sim import dynamics as tdyn
from quadruped_control_tpu_torch.sim import fused_tick as ft
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.sim import plant as tplant
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    assert_close,
    carry_comps_np,
    state_comps_np,
    t2n,
)

torch.set_num_threads(1)
TCFG = mit_cheetah_physical_config()
TM = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float64,
                                         device="cpu")
TM32 = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float32,
                                           device="cpu")
DT = 1.0 / TCFG.frequency
N_SUB = 4
NH, MDT = 8, 0.03


def _tick_inputs(case):
    if case == "init":
        B = 4
        plant = init_whole_body_state(TCFG, (B,), dtype=torch.float64,
                                      device="cpu")
        state = ft.pack_whole_body_state(plant)[0]
        carry = fc.pack_commander_carry(init_commander_carry(
            (B,), dtype=torch.float64, device="cpu"))
        return state, carry, torch.zeros((6, B), dtype=torch.float64)
    B = 12
    d = whole_body_walk_states(303, B, TCFG, on_ground=True)
    carry = carry_comps_np(commander_carry_walk(304, B, TCFG))
    return (torch.as_tensor(state_comps_np(d)), torch.as_tensor(carry),
            torch.as_tensor(d["cmd"].T.copy()))


def _com_joints(state_p):
    s = ft.unpack_whole_body_state(state_p, (state_p.shape[1],))
    com, joints = tplant.whole_body_com_state(s, TCFG)
    return s, com, joints


@pytest.mark.parametrize("case", ["init", "walk"])
def test_tick_against_the_unfused_composition(case):
    state, carry, cmd = _tick_inputs(case)
    B = state.shape[1]
    # 60 iterations: the kernel's converged flag (tol 5e-4, scaled) is loose
    # on these wild states; at 15 a flagged lane was seen 1.3e-2 off the
    # float64 objective, at 30 4e-3, from 60 on within 5e-4.
    tick = ft.make_fused_tick(TM, TCFG, ContactConfig(), controller="mpc",
                              mpc_horizon=NH, mpc_dt=MDT, mpc_iterations=60,
                              gravity_comp=True)
    assert tick.launches_per_tick == 3 and not tick.warm_start
    for _ in range(2):
        new_state, new_carry, (st_p, diag) = tick(state, carry, cmd, DT,
                                                  N_SUB)
        pre = tick.pre(state, carry, cmd)
        F_p, dg = tick.solve(pre[9])
        assert torch.equal(diag, ft.mpc_diag(dg))
        assert F_p.dtype == torch.float32 and new_state.dtype == torch.float64

        plant, com, joints = _com_joints(state)
        carry_t = fc.unpack_commander_carry(
            carry, (B,), init_commander_carry((B,), dtype=torch.float64,
                                              device="cpu"))
        g_tau = tdyn.leg_gravity_torques(TM, joints.q, com.R)
        out, _ = tcmd.commander_step(
            com, joints, carry_t, cmd.t(), DT, TCFG, controller="mpc",
            mpc_backend="structured", mpc_horizon=NH, mpc_dt=MDT,
            mpc_iterations=30, gravity_comp_tau=g_tau)
        assert torch.equal(st_p > 0.5, out.gait.in_stance.t())
        # Horizon forces at the objective level (float64 problem).
        pre_t = tcmd.commander_precursors(com, joints, carry_t, cmd.t(), DT,
                                          TCFG)
        xi0, xi_ref, yaw, sched = tcmd.mpc_precursors(
            com, pre_t.gait_time, pre_t.walking, pre_t.eff_stance, cmd.t(),
            TCFG, NH, MDT)
        qp = th.build_mpc_qp(xi0, xi_ref, yaw, pre_t.p_start, com.x, sched,
                             NH, MDT, TCFG)
        H, c = t2n(qp.H), t2n(qp.c)

        def obj(F):
            x = np.asarray(F, np.float64).reshape(B, -1)
            return 0.5 * np.einsum("bi,bij,bj->b", x, H, x) + (c * x).sum(-1)

        conv = t2n(diag[1]) > 0.5
        o_k = obj(t2n(F_p).T)
        o_s = obj(t2n(out.forces_horizon))
        rel = (np.abs(o_k - o_s) / (1.0 + np.abs(o_s)))[conv]
        assert conv.mean() > 0.7
        assert np.median(rel) < 1e-4 and rel.max() < 1e-3, rel

        # The state after the substeps: the unfused step fed the same forces.
        f0 = F_p[0:12].t().double()
        out_f, _ = tcmd.commander_step(
            com, joints, carry_t, cmd.t(), DT, TCFG, forces_override=f0,
            gravity_comp_tau=g_tau)
        assert torch.equal(out_f.gait.in_stance.t(), st_p > 0.5)
        want = tplant.whole_body_step(plant, out_f.torques, DT, TM, TCFG,
                                      n_substeps=N_SUB, m_update="tick")
        assert_close(new_state, t2n(ft.pack_whole_body_state(want)[0]), 1e-8,
                     "state after the tick")
        assert torch.equal(new_carry, pre[7])
        state, carry = new_state, new_carry
    assert bool(torch.isfinite(state).all())


def _f32_inputs():
    return tuple(a.float() for a in _tick_inputs("walk"))


def test_warm_first_tick_is_the_cold_start():
    state, carry, cmd = _f32_inputs()
    B = state.shape[1]
    kw = dict(controller="mpc", mpc_horizon=4, mpc_dt=MDT, mpc_iterations=8,
              gravity_comp=True)
    warm = ft.make_fused_tick(TM32, TCFG, mpc_warm_start=True, **kw)
    cold = ft.make_fused_tick(TM32, TCFG, **kw)
    w0 = ft.init_mpc_warm_packed(B, horizon=4, device="cpu")
    assert [tuple(a.shape) for a in w0] == [(48, B), (192, B), (16, B)]
    assert torch.equal(w0[2], -torch.ones(16, B))
    assert [tuple(a.shape) for a in warm.init_warm(B, device="cpu")] == [
        tuple(a.shape) for a in w0]
    sw, cw, w1, (stw, dw) = warm(state, carry, w0, cmd, DT, 2)
    sc, cc, (stc, dc) = cold(state, carry, cmd, DT, 2)
    assert torch.equal(sw, sc) and torch.equal(cw, cc)
    assert torch.equal(stw, stc) and torch.equal(dw, dc)
    assert torch.equal(w1[2], tick_sched(warm, state, carry, cmd))
    assert bool((w1[1] > 0).all())
    # The carry of tick 1 changes tick 2 (it is really used).
    sw2, _, _, (_, dw2) = warm(sw, cw, w1, cmd, DT, 2)
    sc2, _, (_, dc2) = cold(sc, cc, cmd, DT, 2)
    assert not torch.equal(dw2, dc2)


def tick_sched(tick, state, carry, cmd):
    return tick.pre(state, carry, cmd)[9][25:25 + 4 * tick.mpc_horizon]


@pytest.mark.parametrize("warm_start", [False, True], ids=["cold", "warm"])
def test_decimated_every_tick_is_the_per_tick_rollout(warm_start):
    plant, carry = init_whole_body_rollout(TCFG, (2,), device="cpu")
    plant = plant._replace(x=plant.x + torch.tensor([0.0, 0.0, 0.17]))
    tick = ft.make_fused_tick(TM32, TCFG, controller="mpc", mpc_horizon=4,
                              mpc_dt=MDT, mpc_iterations=6,
                              mpc_warm_start=warm_start, gravity_comp=True)
    steps = 3
    per = ft.rollout_whole_body_fused(plant, carry, torch.zeros(6), steps,
                                      tick, n_substeps=2, record=True)
    dec = ft.rollout_whole_body_fused_decimated(
        plant, carry, torch.zeros(6), steps, tick, mpc_every=1, n_substeps=2,
        record=True)
    for a, b in zip(per.plant, dec.plant):
        assert torch.equal(a, b)
    for a, b in zip(per.trace, dec.trace):
        assert torch.equal(a, b)
    assert torch.equal(fc.pack_commander_carry(per.carry),
                       fc.pack_commander_carry(dec.carry))
    assert (per.warm is None) == (not warm_start)
    if warm_start:
        assert all(torch.equal(a, b) for a, b in zip(per.warm, dec.warm))
        # Chunked equals unchunked, the warm carry threaded through.
        parts = ft.rollout_whole_body_fused_chunked(
            plant, carry, torch.zeros(6), steps, tick, chunk=2, n_substeps=2,
            record=True)
        for a, b in zip(per.trace, parts.trace):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(per.warm, parts.warm))
    with pytest.raises(ValueError, match="multiple"):
        ft.rollout_whole_body_fused_decimated(plant, carry, torch.zeros(6),
                                              3, tick, mpc_every=2)


def test_hold_modes():
    """With mpc_dt = 0.03 s and 300 Hz ticks, held ticks 1..3 of a group of
    4 all map to horizon step 0: "horizon" is "zoh" bitwise. With mpc_dt =
    0.005 s, held tick 2 maps to step 1 and 3 to step 2: they differ."""
    state, carry, cmd = _f32_inputs()
    plant = ft.unpack_whole_body_state(state, (state.shape[1],))
    carry_t = fc.unpack_commander_carry(
        carry, (state.shape[1],), init_commander_carry(
            (state.shape[1],), device="cpu"))
    cmd_t = cmd.t()
    out = {}
    for mdt in (MDT, 0.005):
        tick = ft.make_fused_tick(TM32, TCFG, controller="mpc",
                                  mpc_horizon=4, mpc_dt=mdt,
                                  mpc_iterations=6, gravity_comp=True)
        for mode in ("zoh", "horizon"):
            out[mdt, mode] = ft.rollout_whole_body_fused_decimated(
                plant, carry_t, cmd_t, 4, tick, mpc_every=4, n_substeps=2,
                hold_mode=mode, record=True)
    for a, b in zip(out[MDT, "zoh"].plant, out[MDT, "horizon"].plant):
        assert torch.equal(a, b)
    assert not torch.equal(out[0.005, "zoh"].plant.u,
                           out[0.005, "horizon"].plant.u)
    assert out[MDT, "zoh"].trace.x.shape == (1, state.shape[1], 3)
    with pytest.raises(ValueError, match="hold_mode"):
        ft.rollout_whole_body_fused_decimated(plant, carry_t, cmd_t, 4, tick,
                                              hold_mode="linear")
    balance = ft.make_fused_tick(TM32, TCFG)
    with pytest.raises(ValueError, match="mpc"):
        ft.rollout_whole_body_fused_decimated(plant, carry_t, cmd_t, 4,
                                              balance)


def test_convert_round_trips():
    rng = np.random.default_rng(9)
    B, N = 6, 3
    xi0 = rng.standard_normal((B, 13))
    r = rng.standard_normal((B, 4, 3))
    sched = rng.uniform(size=(B, N, 4)) < 0.5
    ref = rng.standard_normal((B, N, 13))
    blk = convert.mpc_block_from_numpy(xi0, r, sched, ref, dtype=torch.float64,
                                       device="cpu")
    assert blk.shape == (fc.mpc_block_size(N), B) and blk.is_contiguous()
    back = convert.mpc_block_to_numpy(blk, N)
    assert np.array_equal(back["xi0"], xi0) and np.array_equal(back["xi_ref"],
                                                                ref)
    assert np.array_equal(back["r_levers"], r)
    assert np.array_equal(back["stance_schedule"], sched)

    F = rng.standard_normal((B, N, 12))
    s = rng.uniform(0.1, 1.0, (B, 24 * N))
    z = rng.uniform(0.1, 1.0, (B, N, 24))
    warm = convert.mpc_warm_from_numpy(F, s, z, sched, device="cpu")
    assert [tuple(a.shape) for a in warm] == [(12 * N, B), (48 * N, B),
                                              (4 * N, B)]
    w = convert.mpc_warm_to_numpy(warm, N)
    np.testing.assert_allclose(w["F"], F, rtol=1e-6)
    np.testing.assert_allclose(w["z"], z.reshape(B, -1), rtol=1e-6)
    np.testing.assert_allclose(w["s"], s, rtol=1e-6)
    assert np.array_equal(w["stance_schedule"] > 0.5, sched)
    cold = convert.mpc_warm_from_numpy(F, s, z, device="cpu")
    assert bool((cold[2] == -1).all())

    # The TPU kernel's tiles: the JAX package's own packing, both ways.
    a = rng.standard_normal((2048, 5)).astype(np.float32)
    tiles = np.asarray(jpr._pack(jnp.asarray(a), 5))
    comps = convert.tiles_to_comps(tiles, device="cpu")
    assert np.array_equal(t2n(comps), a.T)
    assert np.array_equal(convert.comps_to_tiles(comps), tiles)
    padded = convert.comps_to_tiles(comps[:, :100])
    assert padded.shape == (1, 5, 8, 128)
    back = convert.tiles_to_comps(padded, device="cpu")
    assert np.array_equal(t2n(back)[:, :100], a[:100].T)


def test_mpc_tick_options():
    tick = ft.make_fused_tick(TM32, TCFG, controller="mpc",
                              mpc_warm_start=True, mpc_iterations=8,
                              contact_gate=0.01)
    assert tick.mpc_horizon == 8 and tick.mpc_dt == 0.03
    assert tick.settings.iterations == 8 and tick.settings.track_best
    assert tick.warm_start and hasattr(tick, "held")
    state, carry, cmd = _f32_inputs()
    got = tick.pre(state, carry, cmd)
    want = fc.commander_pre_plain(tick.consts, state, carry, cmd,
                                  contact_gate=0.01, mpc_horizon=8,
                                  mpc_dt=0.03)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # held: K4 without the block, then K5 with the given forces.
    x_hold = torch.zeros((12, state.shape[1]))
    s_h, c_h, st_h = tick.held(state, carry, x_hold, cmd, DT, 2)
    assert torch.equal(c_h, want[7]) and torch.equal(st_h, want[2])
    assert torch.equal(s_h, tick.stepper.packed(state, x_hold, want[6],
                                                want[2], DT, 2))
    with pytest.raises(ValueError, match="one state-weight diagonal"):
        ft.make_fused_tick(TM32, TCFG, controller="mpc",
                           mpc_state_weights=torch.ones(3, 13))
    weights = tuple(float(v) for v in np.linspace(1.0, 13.0, 13))
    custom = ft.make_fused_tick(TM32, TCFG, controller="mpc",
                                mpc_state_weights=weights)
    assert custom.settings.state_weights == weights
