"""PyTorch port: types, ops/gait, ops/foot_planner, ops/trajectory and
ops/joint_control against their JAX functions on the same NumPy-made inputs
(float64; tolerance 1e-12 relative to the largest value unless stated: the
same formulas in the same order, differences are last-bit). Stance-boundary
cases are compared exactly."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu import types as jtypes
from quadruped_control_tpu.config import GaitConfig as JGaitConfig
from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.ops import foot_planner as jfp
from quadruped_control_tpu.ops import gait as jgait
from quadruped_control_tpu.ops import joint_control as jjc
from quadruped_control_tpu.ops import trajectory as jtraj
from quadruped_control_tpu_torch import types as ttypes
from quadruped_control_tpu_torch.config import GaitConfig, mit_cheetah_physical_config
from quadruped_control_tpu_torch.ops import foot_planner as tfp
from quadruped_control_tpu_torch.ops import gait as tgait
from quadruped_control_tpu_torch.ops import joint_control as tjc
from quadruped_control_tpu_torch.ops import trajectory as ttraj
from torch_port_helpers import assert_close, rpy_to_matrix_np, t2n

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
B = 64
TOL = 1e-12


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def J(a):
    return jnp.asarray(a, jnp.float64)


def test_init_containers_match():
    jp = jtypes.init_planner_state((3, 2), dtype=jnp.float64)
    tp = ttypes.init_planner_state((3, 2), dtype=torch.float64, device="cpu")
    assert np.array_equal(t2n(tp.prev_in_stance), np.asarray(jp.prev_in_stance))
    assert np.array_equal(t2n(tp.initialized), np.asarray(jp.initialized))
    assert np.array_equal(t2n(tp.traj.coeffs), np.asarray(jp.traj.coeffs))
    assert np.array_equal(t2n(tp.traj.valid), np.asarray(jp.traj.valid))
    jg = jtypes.make_stance_gait((5,), dtype=jnp.float64)
    tg = ttypes.make_stance_gait((5,), dtype=torch.float64, device="cpu")
    assert np.array_equal(t2n(tg.in_stance), np.asarray(jg.in_stance))
    assert np.array_equal(t2n(tg.phase), np.asarray(jg.phase))
    assert tp.traj.coeffs.dtype == torch.float64


def test_gait_phases_and_stance_mask():
    t = np.random.default_rng(0).uniform(0.0, 5.0, (B, 3))
    for jc, tc in ((JCFG.gait, TCFG.gait),
                   (JGaitConfig(t_stance=0.3, t_swing=0.15),
                    GaitConfig(t_stance=0.3, t_swing=0.15))):
        jg = jgait.gait_at_time(J(t), jc, dtype=jnp.float64)
        tg = tgait.gait_at_time(T(t), tc)
        assert_close(tg.phase, jg.phase, TOL, "phase")
        assert np.array_equal(t2n(tg.in_stance), np.asarray(jg.in_stance))
    # A Python scalar takes the device argument.
    tg0 = tgait.gait_at_time(0.37, TCFG.gait, dtype=torch.float64,
                             device="cpu")
    jg0 = jgait.gait_at_time(0.37, JCFG.gait, dtype=jnp.float64)
    assert_close(tg0.phase, jg0.phase, TOL)


@pytest.mark.parametrize("dtype", ["f32", "f64"])
def test_stance_boundary_is_inclusive_and_exact(dtype):
    """Phases at, one ulp below and one ulp above stance_phase: the masks of
    the two packages are equal bit for bit in both types."""
    npd = np.float32 if dtype == "f32" else np.float64
    sp = npd(TCFG.gait.stance_phase)
    ph = np.array([0.0, np.nextafter(sp, npd(0)), sp,
                   np.nextafter(sp, npd(1)), sp + npd(1e-12),
                   np.nextafter(npd(1), npd(0))], dtype=npd)
    ph = np.broadcast_to(ph[:, None], (6, 4)).copy()
    got = tgait.leg_states(torch.as_tensor(ph), TCFG.gait)
    want = jgait.leg_states(jnp.asarray(ph), JCFG.gait)
    assert np.array_equal(t2n(got), np.asarray(want))
    assert t2n(got)[2].all() and not t2n(got)[5].any()


def _com(seed):
    rng = np.random.default_rng(seed)
    R = rpy_to_matrix_np(rng.uniform(-0.3, 0.3, (B, 3)))
    x = np.stack([rng.normal(size=B), rng.normal(size=B),
                  rng.uniform(-0.05, 0.3, B)], -1)   # some bases below ground
    return (R, x, rng.normal(size=(B, 3)), rng.normal(size=(B, 3)),
            0.3 * rng.normal(size=(B, 3)),
            rng.normal(size=(B, 4, 3)) * 0.2, rng)


@pytest.mark.parametrize("variant", ["reference", "symmetric", "capture"])
def test_raibert_footholds_and_plan(variant):
    R, x, xdot, w, xdot_d, feet, rng = _com(1)
    kw_j, kw_t = {}, {}
    if variant == "symmetric":
        kw_j = dict(symmetric_velocity=J(xdot_d), symmetric_omega=J(0.5 * w))
        kw_t = dict(symmetric_velocity=T(xdot_d), symmetric_omega=T(0.5 * w))
    if variant == "capture":
        cap = rng.uniform(0.4, 1.0, B)
        kw_j, kw_t = dict(capture_scale=J(cap)), dict(capture_scale=T(cap))
    want = jfp.raibert_footholds(0.8, J(R), J(x), J(xdot), J(w), J(xdot_d),
                                 J(feet), JCFG.foot_planner, **kw_j)
    got = tfp.raibert_footholds(0.8, T(R), T(x), T(xdot), T(w), T(xdot_d),
                                T(feet), TCFG.foot_planner, **kw_t)
    assert_close(got, want, TOL, "footholds")
    assert np.isfinite(t2n(got)).all() and (t2n(got)[..., 2] == 0).all()

    prev = rng.uniform(size=(B, 4)) < 0.5
    init = rng.uniform(size=B) < 0.5
    stance = rng.uniform(size=(B, 4)) < 0.5
    phase = rng.uniform(size=(B, 4))
    jplan = jfp.plan_footholds(
        jnp.asarray(prev), jnp.asarray(init),
        jtypes.Gait(jnp.asarray(stance), J(phase)), 0.8, J(R), J(x), J(xdot),
        J(w), J(xdot_d), J(feet), JCFG.foot_planner, **kw_j)
    tplan = tfp.plan_footholds(
        torch.as_tensor(prev), torch.as_tensor(init),
        ttypes.Gait(torch.as_tensor(stance), T(phase)), 0.8, T(R), T(x),
        T(xdot), T(w), T(xdot_d), T(feet), TCFG.foot_planner, **kw_t)
    assert np.array_equal(t2n(tplan.replan), np.asarray(jplan.replan))
    assert np.array_equal(t2n(tplan.prev_in_stance),
                          np.asarray(jplan.prev_in_stance))
    assert t2n(tplan.initialized).all()
    assert_close(tplan.footholds, jplan.footholds, TOL)


def test_sextic_family():
    rng = np.random.default_rng(2)
    p0, pc, pf = (rng.normal(size=(B, 4, 3)) for _ in range(3))
    assert np.array_equal(ttraj._A_INV, jtraj._A_INV)
    jc = jtraj.sextic_coefficients(J(p0), J(pc), J(pf))
    tc = ttraj.sextic_coefficients(T(p0), T(pc), T(pf))
    assert_close(tc, jc, TOL, "coefficients")
    t = rng.uniform(size=(B, 4))
    js, ts = jtraj.sextic_track(jc, J(t)), ttraj.sextic_track(tc, T(t))
    assert_close(ts.position, js.position, TOL)
    assert_close(ts.velocity, js.velocity, TOL)
    assert_close(ttraj.sextic_accel(tc, T(t)), jtraj.sextic_accel(jc, J(t)),
                 TOL)
    # Boundary conditions of the polynomial itself.
    end = ttraj.sextic_track(tc, torch.ones(B, 4, dtype=torch.float64))
    assert_close(end.position, pf, 1e-10)
    assert_close(end.velocity, np.zeros_like(pf), 1e-9)
    ph = rng.uniform(size=(B, 4))
    assert_close(ttraj.swing_time_of_phase(T(ph), TCFG.gait),
                 jtraj.swing_time_of_phase(J(ph), JCFG.gait), TOL)


def test_plan_and_reference_foot_states():
    rng = np.random.default_rng(3)
    coeffs = rng.normal(size=(B, 4, 7, 3))
    valid = rng.uniform(size=(B, 4)) < 0.5
    replan = rng.uniform(size=(B, 4)) < 0.5
    p0, pf = rng.normal(size=(B, 4, 3)), rng.normal(size=(B, 4, 3))
    jt = jtraj.plan_swing_trajectories(
        jtypes.FootTrajCoeffs(J(coeffs), jnp.asarray(valid)), J(p0), J(pf),
        jnp.asarray(replan), JCFG.gait)
    tt = ttraj.plan_swing_trajectories(
        ttypes.FootTrajCoeffs(T(coeffs), torch.as_tensor(valid)), T(p0),
        T(pf), torch.as_tensor(replan), TCFG.gait)
    assert_close(tt.coeffs, jt.coeffs, TOL)
    assert np.array_equal(t2n(tt.valid), np.asarray(jt.valid))
    stance = rng.uniform(size=(B, 4)) < 0.5
    phase = rng.uniform(size=(B, 4))
    jr = jtraj.reference_foot_states(
        jt, jtypes.Gait(jnp.asarray(stance), J(phase)), JCFG.gait)
    tr = ttraj.reference_foot_states(
        tt, ttypes.Gait(torch.as_tensor(stance), T(phase)), TCFG.gait)
    assert_close(tr.position, jr.position, TOL)
    assert_close(tr.velocity, jr.velocity, TOL)


def test_integrate_twist_yaw():
    rng = np.random.default_rng(4)
    R = rpy_to_matrix_np(rng.uniform(-0.5, 0.5, (B, 3)))
    x = rng.normal(size=(B, 3))
    twist = rng.normal(size=(B, 6))
    twist[:4, 3:] = 0.0          # the Taylor branch of so3_exp
    for dt in (0.001, 0.5):
        jR, jx = jtraj.integrate_twist_yaw(J(R), J(x), J(twist), dt)
        tR, tx = ttraj.integrate_twist_yaw(T(R), T(x), T(twist), dt)
        assert_close(tR, jR, TOL)
        assert_close(tx, jx, TOL)


def test_support_polygon_position():
    rng = np.random.default_rng(5)
    win = [rng.uniform(0.1, 0.4, (B, 4)) for _ in range(4)]
    feet = rng.normal(size=(B, 4, 3))
    stance = rng.uniform(size=(B, 4)) < 0.5
    phase = rng.uniform(size=(B, 4))
    want = jtraj.support_polygon_position(
        *[J(a) for a in win], J(feet),
        jtypes.Gait(jnp.asarray(stance), J(phase)))
    got = ttraj.support_polygon_position(
        *[T(a) for a in win], T(feet),
        ttypes.Gait(torch.as_tensor(stance), T(phase)))
    # erf of two libraries: 1e-12 is still met, stated separately.
    assert_close(got, want, 1e-12)


def test_joint_pd_control_wrap_chain():
    rng = np.random.default_rng(6)
    q_ref = rng.uniform(-7.0, 7.0, (B, 4, 3))     # beyond +-2 pi: wraps
    q = rng.uniform(-7.0, 7.0, (B, 4, 3))
    q[0] = q_ref[0]                               # zero error
    q[1] = q_ref[1] + np.pi                       # the wrap boundary
    qd_ref, qd = rng.normal(size=(B, 4, 3)), rng.normal(size=(B, 4, 3))
    want = jjc.joint_pd_control(J(q_ref), J(qd_ref), J(q), J(qd),
                                JCFG.joint_control)
    got = tjc.joint_pd_control(T(q_ref), T(qd_ref), T(q), T(qd),
                               TCFG.joint_control)
    assert_close(got, want, TOL)
