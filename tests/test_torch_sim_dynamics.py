"""PyTorch port: sim/model and sim/dynamics against the JAX package on the
same NumPy-made inputs (float64, 1e-12 relative to the largest value: the
same recursions in the same order; the 6x6 inverse inside the prefactor goes
through two different LU libraries, stated at 1e-10)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.sim import dynamics as jdyn
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.sim import dynamics as tdyn
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.utils.scenarios import whole_body_walk_states
from torch_port_helpers import assert_close, t2n

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
B = 16
PRESETS = {
    "synthesized": (jmodel.mit_cheetah_whole_body_model,
                    tmodel.mit_cheetah_whole_body_model),
    "published": (jmodel.mit_cheetah_urdf_model,
                  tmodel.mit_cheetah_urdf_model),
}


def T(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def J(a):
    return jnp.asarray(a, jnp.float64)


def models(name):
    jf, tf = PRESETS[name]
    return (jf(JCFG, dtype=jnp.float64),
            tf(TCFG, dtype=torch.float64, device="cpu"))


@pytest.mark.parametrize("name", list(PRESETS))
def test_model_presets_field_for_field(name):
    jm, tm = models(name)
    for field in jm._fields:
        want = np.asarray(getattr(jm, field))
        got = t2n(getattr(tm, field))
        assert got.shape == want.shape, field
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-18,
                                   err_msg=field)
    assert_close(tdyn.total_mass(tm), jdyn.total_mass(jm), 1e-14)
    # Carried across as NumPy arrays in both directions.
    back = convert.whole_body_model_from_numpy(
        {k: np.asarray(v) for k, v in jm._asdict().items()},
        dtype=torch.float64, device="cpu")
    for field in jm._fields:
        assert torch.equal(getattr(back, field), getattr(tm, field)) or \
            torch.allclose(getattr(back, field), getattr(tm, field),
                           rtol=1e-14, atol=0)
    again = convert.to_numpy(tm)
    assert set(again) == set(jm._fields)


def test_published_model_options():
    jm = jmodel.mit_cheetah_urdf_model(JCFG, dtype=jnp.float64,
                                       total_mass=8.252, joint_damping=0.02)
    tm = tmodel.mit_cheetah_urdf_model(TCFG, dtype=torch.float64,
                                       total_mass=8.252, joint_damping=0.02,
                                       device="cpu")
    assert_close(tm.trunk_mass, jm.trunk_mass, 1e-14)
    assert_close(tm.joint_damping, jm.joint_damping, 1e-14)


def _motion(seed):
    d = whole_body_walk_states(seed, B, TCFG)
    rng = np.random.default_rng(seed + 1)
    return d, rng.normal(size=(B, 6)), rng.normal(size=(B, 4, 3))


@pytest.mark.parametrize("name", list(PRESETS))
@pytest.mark.parametrize("gravity", [True, False])
def test_rnea(name, gravity):
    jm, tm = models(name)
    d, base_a, qdd = _motion(10)
    qd = d["u"][:, 6:].reshape(B, 4, 3)
    want = jdyn.rnea(jm, jdyn.precompute_leg_kinematics(jm, J(d["q"])),
                     J(d["R"]), J(d["u"][:, :6]), J(qd), J(base_a), J(qdd),
                     gravity=gravity)
    got = tdyn.rnea(tm, tdyn.precompute_leg_kinematics(tm, T(d["q"])),
                    T(d["R"]), T(d["u"][:, :6]), T(qd), T(base_a), T(qdd),
                    gravity=gravity)
    assert_close(got, want, 1e-12)
    if gravity:
        wantb = jdyn.rnea_bias(
            jm, jdyn.precompute_leg_kinematics(jm, J(d["q"])), J(d["R"]),
            J(d["u"][:, :6]), J(qd))
        gotb = tdyn.rnea_bias(
            tm, tdyn.precompute_leg_kinematics(tm, T(d["q"])), T(d["R"]),
            T(d["u"][:, :6]), T(qd))
        assert_close(gotb, wantb, 1e-12)


@pytest.mark.parametrize("name", list(PRESETS))
def test_mass_matrix_prefactor_and_solve(name):
    jm, tm = models(name)
    d, _, _ = _motion(11)
    jM = jdyn.mass_matrix(jm, jdyn.precompute_leg_kinematics(jm, J(d["q"])),
                          (B,), jnp.float64)
    tM = tdyn.mass_matrix(tm, tdyn.precompute_leg_kinematics(tm, T(d["q"])),
                          (B,), torch.float64)
    assert_close(tM, jM, 1e-12, "M")
    # Symmetric positive definite, total mass on the linear block.
    assert np.linalg.eigvalsh(t2n(tM)).min() > 0
    assert_close(tM[:, 3, 3], np.full(B, float(tdyn.total_mass(tm))), 1e-12)
    jf, tf = jdyn.prefactor_mass_matrix(jM), tdyn.prefactor_mass_matrix(tM)
    for field in jf._fields:
        assert_close(getattr(tf, field), getattr(jf, field), 1e-10, field)
    rhs = np.random.default_rng(12).normal(size=(B, 18))
    want = jdyn.solve_prefactored(jf, J(rhs))
    got = tdyn.solve_prefactored(tf, T(rhs))
    assert_close(got, want, 1e-10)
    assert_close(tdyn.solve_mass_matrix(tM, T(rhs)),
                 np.linalg.solve(t2n(tM), rhs[..., None])[..., 0], 1e-9)


@pytest.mark.parametrize("name", list(PRESETS))
def test_leg_gravity_torques_mass_matrices_and_coms(name):
    jm, tm = models(name)
    d, _, _ = _motion(13)
    assert_close(tdyn.leg_gravity_torques(tm, T(d["q"]), T(d["R"])),
                 jdyn.leg_gravity_torques(jm, J(d["q"]), J(d["R"])), 1e-12)
    assert_close(tdyn.leg_mass_matrices(tm, T(d["q"])),
                 jdyn.leg_mass_matrices(jm, J(d["q"])), 1e-12)
    jt, jl = jdyn.body_coms_world(jm, J(d["q"]), J(d["R"]), J(d["x"]))
    tt, tl = tdyn.body_coms_world(tm, T(d["q"]), T(d["R"]), T(d["x"]))
    assert_close(tt, jt, 1e-14)
    assert_close(tl, jl, 1e-12)


def test_batch_shapes_broadcast():
    _, tm = models("synthesized")
    d, _, _ = _motion(14)
    q = T(d["q"]).reshape(4, 4, 4, 3)
    M = tdyn.mass_matrix(tm, tdyn.precompute_leg_kinematics(tm, q), (4, 4),
                         torch.float64)
    flat = tdyn.mass_matrix(
        tm, tdyn.precompute_leg_kinematics(tm, T(d["q"])), (B,),
        torch.float64)
    assert M.shape == (4, 4, 18, 18)
    assert torch.equal(M.reshape(B, 18, 18), flat)
