"""PyTorch port: the plain version of the commander-pre kernel (K4),
control/fused_commander.commander_pre_plain, against

  - the JAX kernel body itself, ``commander_pre_sym``, called eagerly with
    ``lambda i: arr[i]`` loaders on jnp arrays (the kernel's own arithmetic
    without Pallas), over 8 chained ticks, float64, <= 1e-8 relative to the
    largest value: the JAX body uses a polynomial atan2 with 1.6e-10 absolute
    error where the port calls atan2;
  - the port's own control/commander.commander_precursors (+ the QP
    precursors), 1e-10;

with and without contact_gate / raibert_cmd_symmetric; discrete outputs
(stance mask, standing latch, prev_in_stance, initialized, valid) exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control import pallas_commander as jpc
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import commander as tcmd
from quadruped_control_tpu_torch.control import fused_commander as fc
from quadruped_control_tpu_torch.solver.fused import balance_precursors
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    assert_close,
    carry_comps_np,
    state_comps_np,
    t2n,
    torch_com_joints,
    torch_commander_carry,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
DT = 1.0 / TCFG.frequency
B = 64
NAMES = ("r", "b", "st", "mu", "fz_min", "fz_max", "tau_swing", "carry",
         "q_ref")
DISCRETE_CARRY = [0, 2, 3, 4, 5, 6, 91, 92, 93, 94]
OPTIONS = [dict(contact_gate=0.0, raibert_cmd_symmetric=False),
           dict(contact_gate=0.01, raibert_cmd_symmetric=True)]


def _jax_body(consts, state, carry, cmd, **kw):
    s, c, m = jnp.asarray(state), jnp.asarray(carry), jnp.asarray(cmd)
    out = jpc.commander_pre_sym(consts, lambda i: s[i], lambda i: c[i],
                                lambda i: m[i], **kw)
    return {
        "r": np.stack(out["r"]), "b": np.stack(out["b"]),
        "st": np.stack(out["st"]), "mu": np.asarray(out["mu"])[None],
        "fz_min": np.asarray(out["fz_min"])[None],
        "fz_max": np.asarray(out["fz_max"])[None],
        "tau_swing": np.stack(out["tau_swing"]),
        "carry": np.stack(out["carry"]), "q_ref": np.stack(out["q_ref"])}


@pytest.mark.parametrize("kw", OPTIONS, ids=["reference", "gate+symmetric"])
def test_plain_version_matches_the_jax_kernel_body(kw):
    jconsts = jpc.CommanderConsts(JCFG, DT)
    tconsts = fc.CommanderConsts(TCFG, DT)
    carry = carry_comps_np(commander_carry_walk(3, B, TCFG))
    seen = dict(latch=0, start=0, edges=0, replans=0)
    for tick in range(8):
        d = whole_body_walk_states(60 + tick, B, TCFG)
        state, cmd = state_comps_np(d), d["cmd"].T.copy()
        want = _jax_body(jconsts, state, carry, cmd, **kw)
        got = dict(zip(NAMES, fc.commander_pre_packed(
            torch.as_tensor(state), torch.as_tensor(carry),
            torch.as_tensor(cmd), consts=tconsts, **kw)))
        assert np.array_equal(t2n(got["st"]), want["st"]), f"tick {tick}"
        assert np.array_equal(t2n(got["carry"])[DISCRETE_CARRY],
                              want["carry"][DISCRETE_CARRY]), f"tick {tick}"
        for name in NAMES:
            assert got[name].dtype == torch.float64
            assert_close(got[name], want[name], 1e-8, f"tick {tick} {name}")
        new = want["carry"]
        seen["latch"] += int(((new[0] > 0.5) & (carry[0] < 0.5)).sum())
        seen["start"] += int(((new[1] >= 0) & (carry[1] < 0)).sum())
        seen["edges"] += int(((new[2:6] < 0.5) & (carry[2:6] > 0.5)).sum())
        seen["replans"] += int((new[7:91] != carry[7:91]).any(0).sum())
        carry = new      # both sides continue from the JAX body's carry
    assert all(v > 0 for v in seen.values()), seen


@pytest.mark.parametrize("kw", OPTIONS, ids=["reference", "gate+symmetric"])
def test_plain_version_matches_the_ports_commander(kw):
    consts = fc.CommanderConsts(TCFG, DT)
    c = commander_carry_walk(4, B, TCFG)
    d = whole_body_walk_states(70, B, TCFG)
    got = dict(zip(NAMES, fc.commander_pre_plain(
        consts, torch.as_tensor(state_comps_np(d)),
        torch.as_tensor(carry_comps_np(c)), torch.as_tensor(d["cmd"].T.copy()),
        **kw)))
    com, joints = torch_com_joints(d)
    pre = tcmd.commander_precursors(com, joints, torch_commander_carry(c),
                                    torch.as_tensor(d["cmd"]), DT, TCFG, **kw)
    r, b = balance_precursors(com.R, pre.R_d, com.x, com.xdot, com.w,
                              pre.x_d, pre.xdot_d, pre.w_d, pre.feet_body,
                              pre.eff_stance, TCFG.balance)
    assert np.array_equal(t2n(got["st"]).T > 0.5, t2n(pre.eff_stance))
    assert_close(got["r"].T, t2n(r).reshape(B, 12), 1e-10, "r")
    assert_close(got["b"].T, t2n(b), 1e-10, "b")
    assert_close(got["tau_swing"].T, t2n(pre.tau_swing).reshape(B, 12),
                 1e-10, "tau_swing")
    assert_close(got["q_ref"].T, t2n(pre.q_ref).reshape(B, 12), 1e-10)
    carry = t2n(got["carry"])
    assert np.array_equal(carry[0] > 0.5, t2n(pre.standing))
    assert_close(carry[1], t2n(pre.gait_time), 1e-12)
    assert np.array_equal(carry[2:6].T > 0.5, t2n(pre.plan.prev_in_stance))
    assert (carry[6] == 1).all()
    assert_close(carry[7:91].T, t2n(pre.traj.coeffs).reshape(B, 84), 1e-10)
    assert np.array_equal(carry[91:95].T > 0.5, t2n(pre.traj.valid))
    assert (t2n(got["mu"]) == TCFG.balance.mu).all()


def test_float32_plain_version_is_close_to_float64():
    """The card runs float32: the plain version in float32 stays within
    float32 round-off of the float64 one on the same inputs (masks equal
    except lanes within an ulp of a threshold: none in this draw). Relative
    to the largest value: 5e-6, 2e-5 on the SRB right-hand side (gains of
    1e2..1e3 on pose errors) and 1e-4 on the swing torques (the Jacobian
    inverse of a leg near full extension amplifies the round-off of its
    joint-velocity target; 3.7e-5 seen)."""
    consts = fc.CommanderConsts(TCFG, DT)
    c = carry_comps_np(commander_carry_walk(5, B, TCFG))
    d = whole_body_walk_states(80, B, TCFG)
    args = (state_comps_np(d), c, d["cmd"].T.copy())
    o64 = fc.commander_pre_plain(consts, *(torch.as_tensor(a) for a in args))
    o32 = fc.commander_pre_plain(
        consts, *(torch.as_tensor(a, dtype=torch.float32) for a in args))
    for name, a, b in zip(NAMES, o32, o64):
        assert a.dtype == torch.float32
        tol = {"b": 2e-5, "tau_swing": 1e-4}.get(name, 5e-6)
        assert_close(a.double(), t2n(b), tol, name)
    assert torch.equal(o32[2].double(), o64[2])


def test_unsupported_options_raise():
    consts = fc.CommanderConsts(TCFG, DT)
    s = torch.zeros(58, 4, dtype=torch.float64)
    c = torch.zeros(95, 4, dtype=torch.float64)
    m = torch.zeros(6, 4, dtype=torch.float64)
    # The MPC block needs its step.
    with pytest.raises(ValueError, match="mpc_dt"):
        fc.commander_pre_packed(s, c, m, consts=consts, mpc_horizon=8)
    assert len(fc.commander_pre_packed(s, c, m, consts=consts, mpc_horizon=8,
                                       mpc_dt=0.03)) == 10
    with pytest.raises(ValueError, match="weight_shift"):
        fc.commander_pre_packed(s, c, m, consts=consts, weight_shift=0.5)
    with pytest.raises(ValueError):
        fc.commander_pre_packed(s[:30], c, m, consts=consts)
    with pytest.raises(ValueError):
        fc.commander_pre_packed(s, c[:90], m, consts=consts)


def test_carry_packing_round_trip_and_layout():
    assert (fc.N_CARRY, fc.C_STANDING, fc.C_GAIT_TIME, fc.C_PREV, fc.C_INIT,
            fc.C_COEF, fc.C_VALID) == (
        jpc.N_CARRY, jpc.C_STANDING, jpc.C_GAIT_TIME, jpc.C_PREV, jpc.C_INIT,
        jpc.C_COEF, jpc.C_VALID)
    c = commander_carry_walk(6, 12, TCFG)
    carry = torch_commander_carry(c)
    packed = fc.pack_commander_carry(carry)
    assert packed.shape == (95, 12) and packed.is_contiguous()
    assert np.array_equal(t2n(packed), carry_comps_np(c))
    back = fc.unpack_commander_carry(packed, (3, 4), carry)
    assert back.standing.shape == (3, 4)
    assert torch.equal(back.planner.traj.coeffs.reshape(12, 4, 7, 3),
                       carry.planner.traj.coeffs)
    assert torch.equal(back.planner.prev_in_stance.reshape(12, 4),
                       carry.planner.prev_in_stance)
    a = torch.arange(24.0).reshape(8, 3)
    assert torch.equal(fc.unpack_comps(fc.pack_comps(a, rows=8)), a)
    jconsts, tconsts = jpc.CommanderConsts(JCFG, DT), fc.CommanderConsts(
        TCFG, DT)
    for name in ("dt", "stance_thresh", "slope", "intercept", "mass", "mu"):
        assert getattr(jconsts, name) == getattr(tconsts, name)
    assert np.array_equal(jconsts.a_inv, tconsts.a_inv)
