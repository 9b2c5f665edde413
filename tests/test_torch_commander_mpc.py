"""PyTorch port: the commander's MPC stage against the JAX package (float64,
the same NumPy-made walk states and carries).

  - The MPC precursor block of the commander-pre kernel's plain version
    (control/fused_commander.commander_pre_plain with ``mpc_horizon``)
    against the JAX kernel body ``commander_pre_sym(..., mpc_horizon=8,
    mpc_dt=0.03)`` called eagerly: the stance schedule exactly, continuous
    values to 1e-8 relative (the JAX body's polynomial atan2 is 1.6e-10
    off); the other nine outputs unchanged by the block, bitwise.
  - control/commander.mpc_precursors against the JAX one (1e-12), with
    contact gating and with the heading servo's desired yaw, and against the
    kernel's block (the schedule exactly).
  - commander_step(controller="mpc") with each backend: "condensed" and
    "structured" against the JAX package's same backend (forces to 1e-6 of
    their scale, torques 1e-6), "riccati-pallas" (the kernel's plain version
    here, float32 inside) against the port's structured backend in float64
    (the optimum to ~1e-12) at the objective level: median 1e-4, max 2e-3
    relative to 1 + |objective| — the float32 solve stops at its residual
    tolerance (5e-4 scaled), ~1e-3 absolute on objectives of 0..50 on these
    wild mid-walk states (5.4e-5 median, 9.1e-4 max when this was written).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu import config as jconfig
from quadruped_control_tpu.control import commander as jcmd
from quadruped_control_tpu.control import pallas_commander as jpc
from quadruped_control_tpu_torch import config as tconfig
from quadruped_control_tpu_torch.control import commander as tcmd
from quadruped_control_tpu_torch.control import fused_commander as fc
from quadruped_control_tpu_torch.mpc import horizon as th
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    assert_close,
    carry_comps_np,
    jax_com_joints,
    jax_commander_carry,
    state_comps_np,
    t2n,
    torch_com_joints,
    torch_commander_carry,
)

torch.set_num_threads(1)
JCFG, TCFG = (jconfig.mit_cheetah_physical_config(),
              tconfig.mit_cheetah_physical_config())
DT = 1.0 / TCFG.frequency
B = 48
NH, MDT = 8, 0.03


def _inputs(seed, batch=B):
    c = commander_carry_walk(seed, batch, TCFG)
    d = whole_body_walk_states(seed + 1, batch, TCFG)
    return c, d


@pytest.mark.parametrize("gate", [0.0, 0.01], ids=["reference", "gated"])
def test_kernel_block_matches_jax_body(gate):
    c, d = _inputs(60)
    state, carry, cmd = state_comps_np(d), carry_comps_np(c), d["cmd"].T.copy()
    s, cj, m = jnp.asarray(state), jnp.asarray(carry), jnp.asarray(cmd)
    out = jpc.commander_pre_sym(jpc.CommanderConsts(JCFG, DT), lambda i: s[i],
                                lambda i: cj[i], lambda i: m[i],
                                contact_gate=gate, mpc_horizon=NH,
                                mpc_dt=MDT)
    want = np.stack([np.asarray(v) for v in out["mpc"]])
    consts = fc.CommanderConsts(TCFG, DT)
    args = [torch.as_tensor(a) for a in (state, carry, cmd)]
    got = fc.commander_pre_plain(consts, *args, contact_gate=gate,
                                 mpc_horizon=NH, mpc_dt=MDT)
    assert len(got) == 10 and got[9].shape == (fc.mpc_block_size(NH), B)
    sched = slice(25, 25 + 4 * NH)
    assert np.array_equal(t2n(got[9][sched]), want[sched])
    assert 0.0 < want[sched].mean() < 1.0     # the schedule is not trivial
    assert_close(got[9], want, 1e-8, "MPC block")
    plain = fc.commander_pre_plain(consts, *args, contact_gate=gate)
    assert all(torch.equal(a, b) for a, b in zip(got[:9], plain))
    # The wrapper returns the same ten tensors on the CPU.
    wrapped = fc.commander_pre_packed(*args, consts=consts, contact_gate=gate,
                                      mpc_horizon=NH, mpc_dt=MDT)
    assert all(torch.equal(a, b) for a, b in zip(wrapped, got))


def _pre_both(c, d, **kw):
    jcom, jj = jax_com_joints(d)
    tcom, tj = torch_com_joints(d)
    jpre = jcmd.commander_precursors(jcom, jj, jax_commander_carry(c),
                                     jnp.asarray(d["cmd"]), DT, JCFG, **kw)
    tpre = tcmd.commander_precursors(tcom, tj, torch_commander_carry(c),
                                     torch.as_tensor(d["cmd"]), DT, TCFG,
                                     **kw)
    return (jcom, jpre), (tcom, tpre)


@pytest.mark.parametrize("case", ["reference", "gated", "yaw_d"])
def test_mpc_precursors_match_jax(case):
    c, d = _inputs(70)
    gate = 0.01 if case == "gated" else 0.0
    (jcom, jpre), (tcom, tpre) = _pre_both(c, d, contact_gate=gate)
    jyaw = tyaw = None
    if case == "yaw_d":
        yaw_d = np.random.default_rng(71).uniform(-1.0, 1.0, B)
        jyaw, tyaw = jnp.asarray(yaw_d), torch.as_tensor(yaw_d)
    want = jcmd.mpc_precursors(jcom, jpre.gait_time, jpre.walking,
                               jpre.eff_stance, jnp.asarray(d["cmd"]), JCFG,
                               NH, MDT, contact_gate=gate, yaw_d=jyaw)
    got = tcmd.mpc_precursors(tcom, tpre.gait_time, tpre.walking,
                              tpre.eff_stance, torch.as_tensor(d["cmd"]),
                              TCFG, NH, MDT, contact_gate=gate, yaw_d=tyaw)
    for name, a, b in zip(("xi0", "xi_ref", "yaw", "schedule"), got, want):
        if name == "schedule":
            assert a.dtype == torch.bool
            assert np.array_equal(t2n(a), np.asarray(b))
        else:
            assert_close(a, np.asarray(b), 1e-12, name)

    # The kernel's block carries the same inputs (levers = feet - x).
    consts = fc.CommanderConsts(TCFG, DT)
    block = fc.commander_pre_plain(
        consts, torch.as_tensor(state_comps_np(d)),
        torch.as_tensor(carry_comps_np(c)), torch.as_tensor(d["cmd"].T),
        contact_gate=gate, mpc_horizon=NH, mpc_dt=MDT)[9]
    if case != "yaw_d":
        xi0, xi_ref, _, sched = got
        assert np.array_equal(t2n(block[25:25 + 4 * NH]).T,
                              t2n(sched).reshape(B, -1).astype(np.float64))
        assert_close(block[:13].t(), t2n(xi0), 1e-12, "xi0")
        assert_close(block[25 + 4 * NH:].t(), t2n(xi_ref).reshape(B, -1),
                     1e-12, "reference")
        levers = tpre.p_start - tcom.x[:, None, :]
        assert_close(block[13:25].t(), t2n(levers).reshape(B, 12), 1e-12,
                     "levers")


def _step(lib, c, d, **kw):
    if lib == "jax":
        jcom, jj = jax_com_joints(d)
        return jcmd.commander_step(jcom, jj, jax_commander_carry(c),
                                   jnp.asarray(d["cmd"]), DT, JCFG, **kw)
    tcom, tj = torch_com_joints(d)
    return tcmd.commander_step(tcom, tj, torch_commander_carry(c),
                               torch.as_tensor(d["cmd"]), DT, TCFG, **kw)


@pytest.mark.parametrize("backend", ["condensed", "structured"])
def test_commander_step_mpc_matches_jax(backend):
    c, d = _inputs(80, batch=16)
    kw = dict(controller="mpc", mpc_backend=backend, mpc_horizon=4,
              mpc_dt=MDT, mpc_iterations=25)
    jout, jnew = _step("jax", c, d, **kw)
    tout, tnew = _step("torch", c, d, **kw)
    assert tout.forces_horizon.shape == (16, 4, 12)
    assert torch.equal(tout.forces_world, tout.forces_horizon[:, 0])
    assert np.array_equal(t2n(tout.qp_converged),
                          np.asarray(jout.qp_converged))
    assert_close(tout.forces_horizon, np.asarray(jout.forces_horizon), 1e-6,
                 "forces_horizon")
    assert_close(tout.torques, np.asarray(jout.torques), 1e-6, "torques")
    assert_close(tnew.qp_x, np.asarray(jnew.qp_x), 1e-6, "carry qp_x")
    # The QP triple's s and z ride through untouched.
    assert torch.equal(tnew.qp_s, torch.ones(16, 24, dtype=torch.float64))


def test_commander_step_riccati_pallas_backend():
    c, d = _inputs(90, batch=16)
    kw = dict(controller="mpc", mpc_horizon=4, mpc_dt=MDT, mpc_iterations=40)
    kern, _ = _step("torch", c, d, mpc_backend="riccati-pallas", **kw)
    ref, _ = _step("torch", c, d, mpc_backend="structured", **kw)
    assert kern.forces_horizon.shape == (16, 4, 12)
    assert bool(torch.isfinite(kern.torques).all())
    # Objective of each lane's horizon forces on its own (float64) problem.
    tcom, _ = torch_com_joints(d)
    (_, jpre), (_, tpre) = _pre_both(c, d)
    xi0, xi_ref, yaw, sched = tcmd.mpc_precursors(
        tcom, tpre.gait_time, tpre.walking, tpre.eff_stance,
        torch.as_tensor(d["cmd"]), TCFG, 4, MDT)
    qp = th.build_mpc_qp(xi0, xi_ref, yaw, tpre.p_start, tcom.x, sched, 4,
                         MDT, TCFG)
    H, cc = t2n(qp.H), t2n(qp.c)

    def obj(F):
        x = t2n(F).reshape(16, -1).astype(np.float64)
        return 0.5 * np.einsum("bi,bij,bj->b", x, H, x) + (cc * x).sum(-1)

    both = t2n(kern.qp_converged) & t2n(ref.qp_converged)
    assert both.mean() >= 0.5, both.mean()
    ok, orf = obj(kern.forces_horizon), obj(ref.forces_horizon)
    rel = (np.abs(ok - orf) / (1.0 + np.abs(orf)))[both]
    assert np.median(rel) < 1e-4 and rel.max() < 2e-3, rel
    with pytest.raises(ValueError, match="mpc_backend"):
        _step("torch", c, d, mpc_backend="qpoases", **kw)
