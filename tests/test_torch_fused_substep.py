"""PyTorch port: sim/fused_substep.py, the module of the substep kernel (K5),
on the CPU through the kernel's plain PyTorch version, float64 unless stated.

Held against the JAX package on the same NumPy-made states:

  - the stepper with the streamed factor against ``whole_body_step(m_update=
    "tick")``: 1e-11 relative after one substep (same arithmetic, the 6x6
    inverse included), 1e-9 after four (the contact stiffness amplifies the
    last bits from substep to substep);
  - the stepper with the in-kernel factor against the same reference: 1e-8
    (composite inertias + Cholesky inverse against unit-acceleration RNEA
    columns + LU inverse);
  - ``build_factor`` against ``prefactor_mass_matrix`` and against the JAX
    kernel's own factor arithmetic (``build_factor_sym`` called eagerly on
    jnp arrays);
  - the ``qp`` torque map against ``forces_to_body_frame`` +
    ``jacobian_transpose_control`` + ``leg_gravity_torques`` + clip.

The JAX substep kernel itself is not run here: in interpret mode one call
takes minutes on a CPU. The CUDA kernel is held to this plain version on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.ops.dynamics import (
    forces_to_body_frame as j_forces_to_body_frame,
)
from quadruped_control_tpu.ops.kinematics import (
    jacobian_transpose_control as j_jt_control,
)
from quadruped_control_tpu.sim import dynamics as jdyn
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu.sim import pallas_substep as jsub
from quadruped_control_tpu.sim import plant as jplant
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.sim import dynamics as tdyn
from quadruped_control_tpu_torch.sim import fused_substep as fsub
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.sim import plant as tplant
from quadruped_control_tpu_torch.utils.scenarios import whole_body_walk_states
from torch_port_helpers import (
    assert_close,
    jax_whole_body_state,
    state_comps_np,
    t2n,
    torch_whole_body_state,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
DT = 1.0 / TCFG.frequency
B = 16
PRESETS = {
    "physical": (jmodel.mit_cheetah_whole_body_model,
                 tmodel.mit_cheetah_whole_body_model),
    "urdf": (jmodel.mit_cheetah_urdf_model, tmodel.mit_cheetah_urdf_model),
}


def models(name):
    jfn, tfn = PRESETS[name]
    return (jfn(JCFG, dtype=jnp.float64),
            tfn(TCFG, dtype=torch.float64, device="cpu"))


def _inputs(seed, batch=B):
    rng = np.random.default_rng(seed)
    d = whole_body_walk_states(seed, batch, TCFG, on_ground=True)
    tau = rng.uniform(-8.0, 8.0, (batch, 4, 3))
    fw = rng.uniform(-5.0, 5.0, (batch, 12))
    fw[:, 2::3] = rng.uniform(10.0, 40.0, (batch, 4))
    tau_sw = rng.uniform(-3.0, 3.0, (batch, 4, 3))
    st = rng.uniform(size=(batch, 4)) < 0.7
    return d, tau, fw, tau_sw, st


def _compare(ts, js, tol):
    for field in js._fields:
        assert_close(getattr(ts, field), getattr(js, field), tol, field)


def _jax_torques(jm, d, fw, tau_sw, st, gravity_comp):
    """The commander's torque-mapping stage as the JAX package composes it
    (control/commander.py steps 9b-10)."""
    R, q = jnp.asarray(d["R"]), jnp.asarray(d["q"])
    f_b = j_forces_to_body_frame(jnp.asarray(fw), R,
                                 jnp.ones(st.shape, bool))
    tau = jnp.where(jnp.asarray(st)[..., None],
                    j_jt_control(q, f_b, JCFG.kinematics),
                    jnp.asarray(tau_sw))
    if gravity_comp:
        tau = tau + jdyn.leg_gravity_torques(jm, q, R)
    return jnp.clip(tau, JCFG.balance.torque_min, JCFG.balance.torque_max)


@pytest.mark.parametrize("name", list(PRESETS))
@pytest.mark.parametrize("n_substeps,tol", [(1, 1e-11), (4, 1e-9)])
def test_streamed_factor_stepper_matches_whole_body_step(name, n_substeps,
                                                         tol):
    jm, tm = models(name)
    d, tau, *_ = _inputs(11)
    dt = DT * n_substeps / 10
    js = jplant.whole_body_step(jax_whole_body_state(d), jnp.asarray(tau), dt,
                                jm, JCFG, n_substeps=n_substeps,
                                m_update="tick")
    stepper = fsub.make_fused_stepper(tm, TCFG, prefactor="xla",
                                      torque_input="tau")
    ts = stepper(torch_whole_body_state(d), torch.as_tensor(tau), dt,
                 n_substeps)
    _compare(ts, js, tol)
    # The same functions in the same order as the port's own plant step.
    own = tplant.whole_body_step(torch_whole_body_state(d),
                                 torch.as_tensor(tau), dt, tm, TCFG,
                                 n_substeps=n_substeps, m_update="tick")
    for field in own._fields:
        assert_close(getattr(ts, field), t2n(getattr(own, field)), 1e-13,
                     field)


@pytest.mark.parametrize("tangential", ["anchor", "coulomb"])
def test_kernel_factor_stepper_matches_whole_body_step(tangential):
    jm, tm = models("physical")
    d, tau, *_ = _inputs(12)
    js = jplant.whole_body_step(
        jax_whole_body_state(d), jnp.asarray(tau), DT * 0.4, jm, JCFG,
        jplant.ContactConfig(tangential=tangential), n_substeps=4,
        m_update="tick")
    stepper = fsub.make_fused_stepper(
        tm, TCFG, tplant.ContactConfig(tangential=tangential),
        prefactor="kernel", torque_input="tau")
    ts = stepper(torch_whole_body_state(d), torch.as_tensor(tau), DT * 0.4, 4)
    _compare(ts, js, 1e-8)
    assert (t2n(ts.u) != d["u"]).any()


@pytest.mark.parametrize("name", list(PRESETS))
def test_build_factor(name):
    jm, tm = models(name)
    d, *_ = _inputs(13)
    stepper = fsub.make_fused_stepper(tm, TCFG)
    fac = stepper.build_factor(torch.as_tensor(d["q"]))
    # Against the unit-acceleration RNEA columns + LU of both packages:
    # equal in exact arithmetic, 1e-10 relative in float64.
    q = jnp.asarray(d["q"])
    jfac = jdyn.prefactor_mass_matrix(jdyn.mass_matrix(
        jm, jdyn.precompute_leg_kinematics(jm, q), (B,), jnp.float64))
    tq = torch.as_tensor(d["q"])
    tfac = tdyn.prefactor_mass_matrix(tdyn.mass_matrix(
        tm, tdyn.precompute_leg_kinematics(tm, tq), (B,), torch.float64))
    for field in jfac._fields:
        assert_close(getattr(fac, field), getattr(jfac, field), 1e-10, field)
        assert_close(getattr(fac, field), t2n(getattr(tfac, field)), 1e-10,
                     field)
    # Against the JAX kernel's own factor arithmetic, called eagerly: the
    # same composite-inertia recursion and Cholesky inverse, 1e-12.
    jstep = jsub.make_pallas_stepper(jm, JCFG)
    qf = q.reshape(B, 12)
    sin = [jnp.sin(qf[:, i]) for i in range(12)]
    cos = [jnp.cos(qf[:, i]) for i in range(12)]
    Dinv, Bl, BDinv, Sinv = jstep.build_factor_sym(sin, cos, jnp.zeros(B))

    def dense(block, shape):
        out = np.zeros((B,) + shape)
        for idx in np.ndindex(*shape):
            v = block
            for i in idx:
                v = v[i]
            out[(slice(None),) + idx] = 0.0 if v is None else np.asarray(v)
        return out

    assert_close(fac.Dinv, dense(Dinv, (4, 3, 3)), 1e-12, "Dinv")
    assert_close(fac.Bl, dense(Bl, (4, 6, 3)), 1e-12, "Bl")
    assert_close(fac.BDinv, dense(BDinv, (4, 6, 3)), 1e-12, "BDinv")
    assert_close(fac.Sinv, dense(Sinv, (6, 6)), 1e-12, "Sinv")
    # The factor solves M x = rhs.
    rhs = np.random.default_rng(0).standard_normal((B, 18))
    M = tdyn.mass_matrix(tm, tdyn.precompute_leg_kinematics(tm, tq), (B,),
                         torch.float64)
    x = tdyn.solve_prefactored(fac, torch.as_tensor(rhs))
    assert_close((M @ x[..., None])[..., 0], rhs, 1e-10, "M x = rhs")
    # Layout round trip of the streamed factor.
    back = fsub.comps_to_factor(fsub.factor_to_comps(fac))
    assert fsub.factor_to_comps(fac).shape == (fsub.N_FACTOR, B)
    assert all(torch.equal(a, b) for a, b in zip(back, fac))


@pytest.mark.parametrize("gravity_comp", [False, True])
def test_qp_torque_map(gravity_comp):
    jm, tm = models("physical")
    d, _, fw, tau_sw, st = _inputs(14)
    fw[0] *= 40.0       # a lane that hits the torque limits
    want = _jax_torques(jm, d, fw, tau_sw, st, gravity_comp)
    stepper = fsub.make_fused_stepper(tm, TCFG, torque_input="qp",
                                      gravity_comp=gravity_comp)
    got = stepper.torque_map(
        torch.as_tensor(d["R"]), torch.as_tensor(d["q"]),
        torch.as_tensor(fw), torch.as_tensor(tau_sw), torch.as_tensor(st))
    assert_close(got, want, 1e-13, "tau")
    assert (np.abs(t2n(got)[0]) == TCFG.balance.torque_max).any()
    # A float stance mask (the kernels' layout) selects the same legs.
    got_f = stepper.torque_map(
        torch.as_tensor(d["R"]), torch.as_tensor(d["q"]),
        torch.as_tensor(fw), torch.as_tensor(tau_sw),
        torch.as_tensor(st.astype(np.float64)))
    assert torch.equal(got, got_f)


@pytest.mark.parametrize("prefactor,tol", [("xla", 1e-9), ("kernel", 1e-8)])
def test_qp_stepper_matches_jax_torque_map_then_whole_body_step(prefactor,
                                                                tol):
    jm, tm = models("physical")
    d, _, fw, tau_sw, st = _inputs(15)
    tau = _jax_torques(jm, d, fw, tau_sw, st, True)
    js = jplant.whole_body_step(jax_whole_body_state(d), tau, DT * 0.4, jm,
                                JCFG, n_substeps=4, m_update="tick")
    stepper = fsub.make_fused_stepper(tm, TCFG, prefactor=prefactor,
                                      torque_input="qp", gravity_comp=True)
    ts = stepper(torch_whole_body_state(d), torch.as_tensor(fw),
                 torch.as_tensor(tau_sw), torch.as_tensor(st), DT * 0.4, 4)
    _compare(ts, js, tol)


def test_packed_equals_unpacked_and_batch_shapes():
    _, tm = models("physical")
    d, _, fw, tau_sw, st = _inputs(16, batch=6)
    stepper = fsub.make_fused_stepper(tm, TCFG, torque_input="qp",
                                      gravity_comp=True, rows=8)
    state = torch_whole_body_state(d)
    flat = stepper(state, torch.as_tensor(fw), torch.as_tensor(tau_sw),
                   torch.as_tensor(st), DT, 3)
    state_p = torch.as_tensor(state_comps_np(d))
    assert torch.equal(fsub.state_to_comps(state), state_p)
    out_p = stepper.packed(
        state_p, torch.as_tensor(fw.T.copy()),
        torch.as_tensor(tau_sw.reshape(6, 12).T.copy()),
        torch.as_tensor(st.T.astype(np.float64)), DT, 3)
    assert out_p.shape == (fsub.N_STATE, 6)
    assert all(torch.equal(a, b)
               for a, b in zip(fsub.comps_to_state(out_p), flat))
    # A (2, 3) batch of the same lanes, forces broadcast from one lane.
    shaped = type(state)(*(a.reshape((2, 3) + a.shape[1:]) for a in state))
    out = stepper(shaped, torch.as_tensor(fw[0]),
                  torch.as_tensor(tau_sw).reshape(2, 3, 4, 3),
                  torch.as_tensor(st).reshape(2, 3, 4), DT, 3)
    assert out.x.shape == (2, 3, 3) and out.anchor.shape == (2, 3, 8, 2)
    assert torch.equal(out.q.reshape(6, 4, 3)[0], flat.q[0])


def test_guard_lanes_freeze_and_clamp():
    """A NaN joint velocity freezes its lane for the substep (pose kept,
    velocity zeroed), a 1e6 one is clamped to 200; the other lanes are
    unchanged; ten substeps on every lane is finite."""
    _, tm = models("physical")
    d, _, fw, tau_sw, st = _inputs(17)
    stepper = fsub.make_fused_stepper(tm, TCFG, torque_input="qp")
    extras = (torch.as_tensor(fw.T.copy()),
              torch.as_tensor(tau_sw.reshape(B, 12).T.copy()),
              torch.as_tensor(st.T.astype(np.float64)))
    clean = torch.as_tensor(state_comps_np(d))
    bad = clean.clone()
    bad[18, 0] = float("nan")
    bad[19, 1] = 1.0e6
    out = stepper.packed(bad, *extras, DT / 10, 1)
    ref = stepper.packed(clean, *extras, DT / 10, 1)
    pose = list(range(0, 12)) + list(range(30, 58))
    assert torch.equal(out[pose, 0], bad[pose, 0])
    assert bool((out[12:30, 0] == 0).all())
    assert bool(torch.isfinite(out).all())
    assert out[12:30, 1].abs().max().item() <= 200.0
    assert out[19, 1].item() == 200.0
    assert torch.equal(out[:, 2:], ref[:, 2:])
    assert bool(torch.isfinite(stepper.packed(bad, *extras, DT, 10)).all())


def test_float32_plain_version_is_close_to_float64():
    """The card runs float32: four substeps in float32 stay within 2e-4
    (poses) and 5e-3 (velocities, up to 200) relative to the largest value of
    the float64 run; the contact stiffness amplifies float32 round-off."""
    _, tm = models("physical")
    tm32 = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float32,
                                               device="cpu")
    d, _, fw, tau_sw, st = _inputs(18)
    args = (state_comps_np(d), fw.T.copy(), tau_sw.reshape(B, 12).T.copy(),
            st.T.astype(np.float64))
    o64 = fsub.make_fused_stepper(tm, TCFG, torque_input="qp").packed(
        *(torch.as_tensor(a) for a in args), DT * 0.4, 4)
    o32 = fsub.make_fused_stepper(tm32, TCFG, torque_input="qp").packed(
        *(torch.as_tensor(a, dtype=torch.float32) for a in args), DT * 0.4, 4)
    assert o32.dtype == torch.float32
    pose = list(range(0, 12)) + list(range(30, 58))
    assert_close(o32[pose].double(), t2n(o64[pose]), 2e-4, "poses")
    assert_close(o32[12:30].double(), t2n(o64[12:30]), 5e-3, "velocities")


def test_contract_errors_and_model_asserts():
    _, tm = models("physical")
    with pytest.raises(ValueError, match="prefactor"):
        fsub.make_fused_stepper(tm, TCFG, prefactor="never")
    with pytest.raises(ValueError, match="torque_input"):
        fsub.make_fused_stepper(tm, TCFG, torque_input="forces")
    with pytest.raises(ValueError, match="gravity_comp"):
        fsub.make_fused_stepper(tm, TCFG, gravity_comp=True)
    with pytest.raises(ValueError, match="tangential"):
        fsub.make_fused_stepper(tm, TCFG,
                                tplant.ContactConfig(tangential="glue"))
    skewed = tm.trunk_inertia.clone()
    skewed[0, 1] = skewed[1, 0] = 1e-3
    with pytest.raises(ValueError, match="diagonal trunk"):
        fsub.make_fused_stepper(tm._replace(trunk_inertia=skewed), TCFG)
    link = tm.link_inertia.clone()
    link[1, 2, 0, 2] = link[1, 2, 2, 0] = 1e-4
    with pytest.raises(ValueError, match="diagonal link"):
        fsub.make_fused_stepper(tm._replace(link_inertia=link), TCFG)
    axes = tm.joint_axes.clone()
    axes[0, 2] = torch.tensor([1.0, 0.0, 0.0], dtype=axes.dtype)
    with pytest.raises(ValueError, match="joint axes"):
        fsub.make_fused_stepper(tm._replace(joint_axes=axes), TCFG)
    stepper = fsub.make_fused_stepper(tm, TCFG)
    with pytest.raises(ValueError, match="state"):
        stepper.packed(torch.zeros(57, 4), torch.zeros(12, 4), DT, 2)
    # The snapshot is what the kernel's parameter struct is filled from.
    c = stepper.consts
    assert c.use_anchor and c.prefactor_kernel and not c.torque_qp
    assert c.k_n == tplant.ContactConfig().stiffness
    assert c.tau_max == TCFG.balance.torque_max
