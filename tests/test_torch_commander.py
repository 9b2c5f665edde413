"""PyTorch port: control/commander (balance path) and control/rollout against
the JAX package on the same NumPy-made states and carries (float64).

commander_precursors: every field, every option of the signature once, over
chained ticks whose synthetic carries cross the standing latch, the gait start
and stance->swing edges; masks exactly, the rest to 1e-10 relative (same
formulas, same order; atan2/asin/erf of two libraries). commander_step: the
torque path exactly as far as it does not depend on a QP solver (forces
given), and with both QP back ends at the level the solvers agree."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu import config as jconfig
from quadruped_control_tpu.control import commander as jcmd
from quadruped_control_tpu.control import rollout as jroll
from quadruped_control_tpu.sim import dynamics as jdyn
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu.types import PlannerState as JPlannerState
from quadruped_control_tpu_torch import config as tconfig
from quadruped_control_tpu_torch.control import commander as tcmd
from quadruped_control_tpu_torch.control import rollout as troll
from quadruped_control_tpu_torch.sim import dynamics as tdyn
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.types import PlannerState
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    assert_close,
    jax_com_joints,
    jax_commander_carry,
    t2n,
    torch_com_joints,
    torch_commander_carry,
)

torch.set_num_threads(1)
JCFG, TCFG = (jconfig.mit_cheetah_physical_config(),
              tconfig.mit_cheetah_physical_config())
B = 32
DT = 1.0 / TCFG.frequency
TOL = 1e-10

OPTIONS = {
    "reference": ({}, {}),
    "weight_shift": (dict(weight_shift=0.6), dict(weight_shift=0.6)),
    "contact_gate": (dict(contact_gate=0.01), dict(contact_gate=0.01)),
    "raibert_cmd_symmetric": (dict(raibert_cmd_symmetric=True),) * 2,
    "heading_hold": (dict(heading_hold=True),) * 2,
    "foothold_trim": (
        dict(foothold_trim=jconfig.FootholdTrimConfig(
            heading_lead=0.05, capture_scale=0.7, roll_gain=0.02,
            roll_vel_gain=0.01)),
        dict(foothold_trim=tconfig.FootholdTrimConfig(
            heading_lead=0.05, capture_scale=0.7, roll_gain=0.02,
            roll_vel_gain=0.01))),
    "swing_vel_rescale": (dict(swing_vel_rescale=True),) * 2,
    "swing_vel_rescale_value": (dict(swing_vel_rescale=2.5),) * 2,
    "swing_accel_ff": (dict(swing_accel_ff=True),) * 2,
    "stance_pose": (dict(stance_pose=jconfig.StancePoseConfig(roll_max=0.2)),
                    dict(stance_pose=tconfig.StancePoseConfig(roll_max=0.2))),
    "swing_start_ground": (dict(swing_start_ground=True),) * 2,
    "body_frame_exact": (dict(body_frame_exact=True,
                              contact_gate=0.02),) * 2,
}


def _flatten(pre, prefix=""):
    out = {}
    for name, v in pre._asdict().items():
        if v is None:
            continue
        if hasattr(v, "_asdict"):
            out.update(_flatten(v, f"{prefix}{name}."))
        else:
            out[prefix + name] = v
    return out


def _compare_pre(tp, jp, tick):
    tf, jf = _flatten(tp), _flatten(jp)
    assert set(tf) == set(jf)
    for name in jf:
        want = np.asarray(jf[name])
        got = t2n(tf[name])
        if want.dtype == np.bool_:
            assert np.array_equal(got, want), f"tick {tick} {name}"
        else:
            assert_close(got, want, TOL, f"tick {tick} {name}")


def _advance(carry, pre, planner_cls):
    return carry._replace(
        standing=pre.standing, gait_time=pre.gait_time,
        planner=planner_cls(prev_in_stance=pre.plan.prev_in_stance,
                            initialized=pre.plan.initialized, traj=pre.traj),
        ref_pose=pre.ref_pose, pose_cmd=pre.pose_cmd)


@pytest.mark.parametrize("option", list(OPTIONS))
def test_commander_precursors(option):
    jkw, tkw = (dict(o) for o in OPTIONS[option])
    c = commander_carry_walk(7, B, TCFG)
    jc, tc = jax_commander_carry(c), torch_commander_carry(c)
    if "foothold_trim" in jkw:
        rng = np.random.default_rng(8)
        ref = rng.normal(size=(B, 3)) * 0.1
        jc = jc._replace(ref_pose=jnp.asarray(ref))
        tc = tc._replace(ref_pose=torch.as_tensor(ref))
    if "stance_pose" in jkw:
        jc = jc._replace(pose_cmd=jnp.zeros((B, 4)))
        tc = tc._replace(pose_cmd=torch.zeros((B, 4), dtype=torch.float64))
    seen = dict(latch=0, start=0, swing=0, replan=0)
    for tick in range(3):
        d = whole_body_walk_states(20 + tick, B, TCFG)
        jcom, jj = jax_com_joints(d)
        tcom, tj = torch_com_joints(d)
        if option == "swing_accel_ff":
            jm = jmodel.mit_cheetah_whole_body_model(JCFG, dtype=jnp.float64)
            tm = tmodel.mit_cheetah_whole_body_model(
                TCFG, dtype=torch.float64, device="cpu")
            jkw["swing_mass"] = jdyn.leg_mass_matrices(jm, jj.q)
            tkw["swing_mass"] = tdyn.leg_mass_matrices(tm, tj.q)
        cmd = d["cmd"]
        jp = jcmd.commander_precursors(jcom, jj, jc, jnp.asarray(cmd), DT,
                                       JCFG, **jkw)
        tp = tcmd.commander_precursors(tcom, tj, tc, torch.as_tensor(cmd),
                                       DT, TCFG, **tkw)
        _compare_pre(tp, jp, tick)
        seen["latch"] += int((t2n(tp.standing) & ~t2n(tc.standing)).sum())
        seen["start"] += int(((t2n(tp.gait_time) >= 0)
                              & (t2n(tc.gait_time) < 0)).sum())
        seen["swing"] += int((~t2n(tp.gait.in_stance)).sum())
        seen["replan"] += int(t2n(tp.plan.replan).sum())
        jc = _advance(jc, jp, JPlannerState)
        tc = _advance(tc, tp, PlannerState)
    assert seen["latch"] > 0
    if option != "stance_pose":      # that mode never starts the gait clock
        assert seen["start"] > 0
    assert seen["swing"] > 0 and seen["replan"] > 0


def test_options_that_need_a_carry_field_raise():
    c = commander_carry_walk(7, 4, TCFG)
    tc = torch_commander_carry(c)
    d = whole_body_walk_states(20, 4, TCFG)
    com, j = torch_com_joints(d)
    cmd = torch.as_tensor(d["cmd"])
    with pytest.raises(ValueError, match="ref_pose"):
        tcmd.commander_precursors(
            com, j, tc, cmd, DT, TCFG,
            foothold_trim=tconfig.FootholdTrimConfig())
    with pytest.raises(ValueError, match="pose_cmd"):
        tcmd.commander_precursors(com, j, tc, cmd, DT, TCFG, stance_pose=True)
    with pytest.raises(ValueError, match="swing_mass"):
        tcmd.commander_precursors(com, j, tc, cmd, DT, TCFG,
                                  swing_accel_ff=True)


def test_init_commander_carry_matches():
    jc = jcmd.init_commander_carry((3,), dtype=jnp.float64, ref_pose=True,
                                   pose_cmd=True)
    tc = tcmd.init_commander_carry((3,), dtype=torch.float64, ref_pose=True,
                                   pose_cmd=True, device="cpu")
    for a, b in zip(_flatten(tc).items(), _flatten(jc).items()):
        assert a[0] == b[0]
        assert np.array_equal(t2n(a[1]), np.asarray(b[1])), a[0]
    assert tcmd.init_commander_carry((2,), device="cpu").ref_pose is None


def _step_inputs(seed):
    c = commander_carry_walk(seed, B, TCFG)
    d = whole_body_walk_states(seed + 1, B, TCFG)
    return c, d


def test_commander_step_with_given_forces_is_tight():
    """forces_override takes the QP out: torques, body forces, carry and
    gait agree to 1e-10; gravity compensation and the clamp included."""
    c, d = _step_inputs(30)
    rng = np.random.default_rng(31)
    fw = rng.uniform(-20.0, 20.0, (B, 12))
    fw[:, 2::3] = rng.uniform(10.0, 80.0, (B, 4))
    jm = jmodel.mit_cheetah_whole_body_model(JCFG, dtype=jnp.float64)
    tm = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float64,
                                             device="cpu")
    jcom, jj = jax_com_joints(d)
    tcom, tj = torch_com_joints(d)
    jout, jnew = jcmd.commander_step(
        jcom, jj, jax_commander_carry(c), jnp.asarray(d["cmd"]), DT, JCFG,
        forces_override=jnp.asarray(fw), contact_gate=0.01,
        gravity_comp_tau=jdyn.leg_gravity_torques(jm, jj.q, jcom.R))
    tout, tnew = tcmd.commander_step(
        tcom, tj, torch_commander_carry(c), torch.as_tensor(d["cmd"]), DT,
        TCFG, forces_override=torch.as_tensor(fw), contact_gate=0.01,
        gravity_comp_tau=tdyn.leg_gravity_torques(tm, tj.q, tcom.R))
    for name in ("torques", "forces_body", "forces_world", "foot_refs_world",
                 "swing_q_ref"):
        assert_close(getattr(tout, name), getattr(jout, name), TOL, name)
    assert np.array_equal(t2n(tout.gait.in_stance),
                          np.asarray(jout.gait.in_stance))
    assert t2n(tout.qp_converged).all()
    lim = TCFG.balance.torque_max
    assert np.abs(t2n(tout.torques)).max() <= lim
    assert (np.abs(t2n(tout.torques)) == lim).any()     # the clamp acted
    _compare_pre(_as_pre(tnew), _as_pre(jnew), 0)


def _as_pre(carry):
    """A carry's comparable fields as a NamedTuple-like for _compare_pre."""
    import collections

    Flat = collections.namedtuple(
        "Flat", "standing gait_time prev initialized coeffs valid")
    p = carry.planner
    return Flat(carry.standing, carry.gait_time, p.prev_in_stance,
                p.initialized, p.traj.coeffs, p.traj.valid)


@pytest.mark.parametrize("backend", ["jnp", "fused"])
def test_commander_step_qp_backends(backend):
    """With a QP in the loop the two packages run two implementations of the
    same solver. "jnp" (the dense IPM, float64 here): the regularized QP has
    one optimum and both reach it to 1e-6 N. "fused" (float32 inside): the
    4-stance family is flat along its near-nullspace, so forces are compared
    through the objective (1e-6 relative, the repo's bar) and the torques
    loosely (0.05 N m of up to 18)."""
    from quadruped_control_tpu.ops import dynamics as jd

    c, d = _step_inputs(40)
    n = 8
    c = {k: v[:n] for k, v in c.items()}
    d = {k: v[:n] for k, v in d.items()}
    jcom, jj = jax_com_joints(d)
    tcom, tj = torch_com_joints(d)
    kw = dict(qp_iterations=20, qp_polish=True)
    if backend == "jnp":
        kw["qp_warm_start"] = True
    # The JAX package's fused back end is a TPU kernel without an interpret
    # switch on this entry point: its dense IPM is the reference for both.
    jout, jnew = jcmd.commander_step(jcom, jj, jax_commander_carry(c),
                                     jnp.asarray(d["cmd"]), DT, JCFG,
                                     qp_backend="jnp", **kw)
    tout, tnew = tcmd.commander_step(tcom, tj, torch_commander_carry(c),
                                     torch.as_tensor(d["cmd"]), DT, TCFG,
                                     qp_backend=backend, **kw)
    assert np.array_equal(t2n(tout.gait.in_stance),
                          np.asarray(jout.gait.in_stance))
    # One of these 8 wild synthetic states stays uncertified in float32.
    assert t2n(tout.qp_converged).mean() >= np.asarray(
        jout.qp_converged).mean() - 0.15
    if backend == "jnp":
        assert_close(tout.forces_world, jout.forces_world, 1e-6)
        assert_close(tout.torques, jout.torques, 1e-6)
        assert_close(tnew.qp_x, jnew.qp_x, 1e-6)
        return
    pre = jcmd.commander_precursors(jcom, jj, jax_commander_carry(c),
                                    jnp.asarray(d["cmd"]), DT, JCFG)
    qp = jd.build_balance_qp(jcom.R, pre.R_d, jcom.x, jcom.xdot, jcom.w,
                             pre.x_d, pre.xdot_d, pre.w_d, pre.feet_body,
                             pre.eff_stance, JCFG.balance)
    Q, cvec = np.asarray(qp.Q), np.asarray(qp.c)

    def obj(x):
        x = np.asarray(x, np.float64)
        return 0.5 * np.einsum("bi,bij,bj->b", x, Q, x) + np.einsum(
            "bi,bi->b", cvec, x)

    oj, ot = obj(np.asarray(jout.forces_world)), obj(t2n(tout.forces_world))
    both = np.asarray(jout.qp_converged) & t2n(tout.qp_converged)
    assert both.mean() > 0.7
    rel = np.abs(oj - ot) / (1.0 + np.abs(oj))
    assert np.median(rel[both]) < 1e-6 and rel[both].max() < 1e-4
    assert np.abs(t2n(tout.torques) - np.asarray(jout.torques))[both].max() \
        < 0.05


def test_mpc_is_the_third_slice():
    """controller="mpc" runs (tests/test_torch_commander_mpc.py holds it
    against the JAX package); arguments the step does not know raise."""
    c, d = _step_inputs(50)
    tcom, tj = torch_com_joints(d)
    args = (tcom, tj, torch_commander_carry(c), torch.as_tensor(d["cmd"]), DT,
            TCFG)
    out, new = tcmd.commander_step(*args, controller="mpc", mpc_horizon=3,
                                   mpc_iterations=6)
    assert out.forces_horizon.shape == (B, 3, 12)
    assert torch.equal(out.forces_world, out.forces_horizon[:, 0])
    assert torch.equal(new.qp_x, out.forces_world)
    assert bool(torch.isfinite(out.torques).all())
    balance, _ = tcmd.commander_step(*args)
    assert balance.forces_horizon is None
    with pytest.raises(ValueError, match="mpc_backend"):
        tcmd.commander_step(*args, controller="mpc", mpc_backend="osqp")
    with pytest.raises(ValueError):
        tcmd.commander_step(*args, controller="lqr")
    with pytest.raises(TypeError):
        tcmd.commander_step(*args, horizon=3)


@pytest.mark.parametrize("ramp", [0.0, 0.5])
def test_piecewise_command(ramp):
    seg = [(1.5, [0, 0, 0, 0, 0, 0]), (2.0, [0.2, 0, 0, 0, 0, 0.1]),
           (0.01, [-0.2, 0, 0, 0, 0, 0])]
    want = jroll.piecewise_command(seg, 300.0, dtype=jnp.float64, ramp=ramp)
    got = troll.piecewise_command(seg, 300.0, dtype=torch.float64, ramp=ramp,
                                  device="cpu")
    assert got.shape == want.shape
    assert np.array_equal(t2n(got), np.asarray(want))
    assert troll.RolloutTrace._fields == jroll.RolloutTrace._fields
