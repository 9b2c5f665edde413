"""PyTorch port: math/ and ops/ against the JAX functions on the same
NumPy-made inputs. Tolerances: float64 1e-12 (same closed forms, only the
summation order of a few matrix products differs), float32 1e-5 relative to
the magnitude of the result."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_config as jax_config
from quadruped_control_tpu.math import numerics as jnum
from quadruped_control_tpu.math import rotations as jrot
from quadruped_control_tpu.ops import dynamics as jdyn
from quadruped_control_tpu.ops import kinematics as jkin
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.math import numerics as tnum
from quadruped_control_tpu_torch.math import rotations as trot
from quadruped_control_tpu_torch.ops import dynamics as tdyn
from quadruped_control_tpu_torch.ops import kinematics as tkin
from torch_port_helpers import (NP_DTYPES, TORCH_DTYPES, numpy_scenarios,
                                rpy_to_matrix_np, t2n)

torch.set_num_threads(1)

DT = ["f32", "f64"]


def close(a, b, dt):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    tol = 1e-12 if dt == "f64" else 1e-5
    scale = max(1.0, float(np.max(np.abs(a)))) if a.size else 1.0
    np.testing.assert_allclose(b, a, rtol=tol, atol=tol * scale)


def both(x, dt):
    x = np.asarray(x).astype(NP_DTYPES[dt])
    return jnp.asarray(x), torch.from_numpy(x.copy())


@pytest.mark.parametrize("dt", DT)
def test_numerics(dt):
    a = np.linspace(-20.0, 20.0, 401)
    ja, ta = both(a, dt)
    close(jnum.normalize_angle_2pi(ja), t2n(tnum.normalize_angle_2pi(ta)), dt)
    close(jnum.normalize_angle_pi(ja), t2n(tnum.normalize_angle_pi(ta)), dt)
    assert np.array_equal(np.asarray(jnum.almost_equal(ja, ja + 1e-13)),
                          t2n(tnum.almost_equal(ta, ta + 1e-13)))


@pytest.mark.parametrize("dt", DT)
def test_quaternions_and_skew(dt):
    rng = np.random.default_rng(0)
    jq1, tq1 = both(rng.standard_normal((64, 4)), dt)
    jq2, tq2 = both(rng.standard_normal((64, 4)), dt)
    jv, tv = both(rng.standard_normal((64, 3)), dt)
    close(jrot.skew(jv), t2n(trot.skew(tv)), dt)
    close(jrot.unskew(jrot.skew(jv)), t2n(trot.unskew(trot.skew(tv))), dt)
    jn1, tn1 = jrot.quat_normalize(jq1), trot.quat_normalize(tq1)
    close(jn1, t2n(tn1), dt)
    close(jrot.quat_multiply(jq1, jq2), t2n(trot.quat_multiply(tq1, tq2)), dt)
    close(jrot.quat_rotate(jn1, jv), t2n(trot.quat_rotate(tn1, tv)), dt)
    close(jrot.quat_to_matrix(jn1), t2n(trot.quat_to_matrix(tn1)), dt)
    close(jrot.quat_to_rpy(jn1), t2n(trot.quat_to_rpy(tn1)), dt)
    close(jrot.quat_identity(jq1.dtype),
          t2n(trot.quat_identity(tq1.dtype, device="cpu")), dt)
    ja, ta = both(rng.uniform(-3, 3, 64), dt)
    jax_ = jv / jnp.linalg.norm(jv, axis=-1, keepdims=True)
    tax = tv / torch.linalg.norm(tv, dim=-1, keepdim=True)
    close(jrot.quat_from_axis_angle(jax_, ja),
          t2n(trot.quat_from_axis_angle(tax, ta)), dt)
    close(jrot.matrix_from_axis_angle(jax_, ja),
          t2n(trot.matrix_from_axis_angle(tax, ta)), dt)


@pytest.mark.parametrize("dt", DT)
def test_matrix_to_quat_all_branches(dt):
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-np.pi, np.pi, (256, 3))
    rpy[:, 1] *= 0.49
    jR, tR = both(rpy_to_matrix_np(rpy), dt)
    close(jrot.matrix_to_quat(jR), t2n(trot.matrix_to_quat(tR)), dt)
    close(jrot.matrix_to_rpy(jR), t2n(trot.matrix_to_rpy(tR)), dt)
    jr, tr = both(rpy, dt)
    close(jrot.rpy_to_matrix(jr), t2n(trot.rpy_to_matrix(tr)), dt)


@pytest.mark.parametrize("dt", DT)
def test_so3_exp_log(dt):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((128, 3))
    w[:8] *= 1e-9                      # Taylor branch
    w[8:16] = 0.0
    jw, tw = both(w, dt)
    jR, tR = jrot.so3_exp(jw), trot.so3_exp(tw)
    close(jR, t2n(tR), dt)
    close(jrot.so3_log(jR), t2n(trot.so3_log(tR)), dt)
    close(jrot.angle_axis_total(jR), t2n(trot.angle_axis_total(tR)), dt)


@pytest.mark.parametrize("dt", DT)
def test_so3_log_near_pi(dt):
    """The past bug site: angles pi - 1e-3 ... pi, float32 included. Both
    packages see the SAME rotation matrices (made in float64, rounded once);
    the result must also be the right rotation vector."""
    rng = np.random.default_rng(3)
    axis = rng.standard_normal((40, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.concatenate([np.pi - np.logspace(-3, -9, 39), [np.pi]])
    K = np.zeros((40, 3, 3))
    K[:, 0, 1], K[:, 0, 2] = -axis[:, 2], axis[:, 1]
    K[:, 1, 0], K[:, 1, 2] = axis[:, 2], -axis[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -axis[:, 1], axis[:, 0]
    R = (np.eye(3) + np.sin(ang)[:, None, None] * K
         + (1 - np.cos(ang))[:, None, None] * (K @ K))
    jR, tR = both(R, dt)
    jl, tl = np.asarray(jrot.so3_log(jR)), t2n(trot.so3_log(tR))
    assert np.all(np.isfinite(tl))
    # At pi the sign of the axis is arbitrary: compare up to a common sign.
    sign = np.sign(np.sum(jl * tl, axis=-1, keepdims=True))
    close(jl, tl * sign, dt)
    truth = axis * ang[:, None]
    sign_t = np.sign(np.sum(truth * tl, axis=-1, keepdims=True))
    np.testing.assert_allclose(tl * sign_t, truth,
                               atol=1e-9 if dt == "f64" else 2e-3)


@pytest.mark.parametrize("dt", DT)
def test_transforms(dt):
    rng = np.random.default_rng(4)
    jR1, tR1 = both(rpy_to_matrix_np(rng.uniform(-1, 1, (32, 3))), dt)
    jR2, tR2 = both(rpy_to_matrix_np(rng.uniform(-1, 1, (32, 3))), dt)
    jp1, tp1 = both(rng.standard_normal((32, 3)), dt)
    jp2, tp2 = both(rng.standard_normal((32, 3)), dt)
    for a, b in zip(jrot.transform_compose(jR1, jp1, jR2, jp2),
                    trot.transform_compose(tR1, tp1, tR2, tp2)):
        close(a, t2n(b), dt)
    close(jrot.transform_apply(jR1, jp1, jp2),
          t2n(trot.transform_apply(tR1, tp1, tp2)), dt)
    for a, b in zip(jrot.transform_inverse(jR1, jp1),
                    trot.transform_inverse(tR1, tp1)):
        close(a, t2n(b), dt)
    close(jrot.transform_adjoint(jR1, jp1),
          t2n(trot.transform_adjoint(tR1, tp1)), dt)


@pytest.mark.parametrize("dt", DT)
def test_kinematics(dt):
    rng = np.random.default_rng(5)
    q = np.array([0.0, 1.61, -2.78]) + 0.4 * rng.standard_normal((64, 4, 3))
    jq, tq = both(q, dt)
    jfk, tfk = jkin.forward_kinematics(jq), tkin.forward_kinematics(tq)
    close(jfk, t2n(tfk), dt)
    close(jkin.inverse_kinematics(jfk), t2n(tkin.inverse_kinematics(tfk)), dt)
    # Unreachable targets must stay finite (saturating IK).
    far = np.asarray(jfk) * 10.0
    jf, tf = both(far, dt)
    tik = t2n(tkin.inverse_kinematics(tf))
    assert np.all(np.isfinite(tik))
    close(jkin.inverse_kinematics(jf), tik, dt)
    close(jkin.leg_jacobian(jq), t2n(tkin.leg_jacobian(tq)), dt)
    jf3, tf3 = both(rng.standard_normal((64, 4, 3)), dt)
    close(jkin.jacobian_transpose_control(jq, jf3),
          t2n(tkin.jacobian_transpose_control(tq, tf3)), dt)


@pytest.mark.parametrize("dt", DT)
def test_jacobian_inverse_with_singular_fallback(dt):
    rng = np.random.default_rng(6)
    q = np.array([0.0, 1.61, -2.78]) + 0.2 * rng.standard_normal((32, 4, 3))
    q[:4, :, 2] = 0.0                  # straight knee: singular Jacobian
    jq, tq = both(q, dt)
    a = np.asarray(jkin.leg_jacobian_inverse(jq), np.float64)
    b = t2n(tkin.leg_jacobian_inverse(tq)).astype(np.float64)
    assert np.all(np.isfinite(b))
    # The regular lanes to the usual tolerance; the singular ones (damped
    # pseudo-inverse of a rank-deficient matrix, entries ~1e5) relative to
    # their own size.
    close(a[4:], b[4:], dt)
    # (In float32 the near-singular inverse amplifies the last-bit
    # differences of sin/cos between the two libraries to a few percent.)
    np.testing.assert_allclose(
        b[:4], a[:4], rtol=1e-6 if dt == "f64" else 5e-2,
        atol=(1e-6 if dt == "f64" else 5e-2) * np.abs(a[:4]).max())


def _scen(dt, randomize):
    d = numpy_scenarios(11, 96, randomize=randomize, dtype=NP_DTYPES[dt])
    j = {k: jnp.asarray(v) for k, v in d.items()}
    t = {k: torch.from_numpy(v.copy()) for k, v in d.items()}
    return j, t


@pytest.mark.parametrize("dt", DT)
def test_pd_accelerations(dt):
    j, t = _scen(dt, False)
    jb, tb = jax_config().balance, mit_cheetah_config().balance
    # A kff with every entry set, so the preserved index typo is exercised.
    import dataclasses
    kff = (0.1, 0.2, 0.15, 0.3, 0.4, 0.5)
    jb, tb = dataclasses.replace(jb, kff=kff), dataclasses.replace(tb, kff=kff)
    ja = jdyn.pd_accelerations(j["R"], j["R_d"], j["x"], j["xdot"], j["w"],
                               j["x_d"], j["xdot_d"], j["w_d"], jb)
    ta = tdyn.pd_accelerations(t["R"], t["R_d"], t["x"], t["xdot"], t["w"],
                               t["x_d"], t["xdot_d"], t["w_d"], tb)
    for a, b in zip(ja, ta):
        close(a, t2n(b), dt)


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("dt", DT)
def test_srb_dynamics_and_assembly(dt, randomize):
    j, t = _scen(dt, randomize)
    jb, tb = jax_config().balance, mit_cheetah_config().balance
    rng = np.random.default_rng(7)
    jxd, txd = both(rng.standard_normal((96, 3)), dt)
    jwd, twd = both(rng.standard_normal((96, 3)), dt)
    jA, jbv = jdyn.srb_dynamics(j["feet"], j["R"], jxd, j["w_d"], jwd, jb,
                                stance_mask=j["stance"], mass=j.get("mass"),
                                inertia_diag=j.get("inertia_diag"))
    tA, tbv = tdyn.srb_dynamics(t["feet"], t["R"], txd, t["w_d"], twd, tb,
                                stance_mask=t["stance"], mass=t.get("mass"),
                                inertia_diag=t.get("inertia_diag"))
    close(jA, t2n(tA), dt)
    close(jbv, t2n(tbv), dt)
    jQ, jc = jdyn.assemble_qp(jA, jbv, jb)
    tQ, tc = tdyn.assemble_qp(tA, tbv, tb)
    close(jQ, t2n(tQ), dt)
    close(jc, t2n(tc), dt)
    # Unmasked variant.
    jA2, _ = jdyn.srb_dynamics(j["feet"], j["R"], jxd, j["w_d"], jwd, jb)
    tA2, _ = tdyn.srb_dynamics(t["feet"], t["R"], txd, t["w_d"], twd, tb)
    close(jA2, t2n(tA2), dt)


@pytest.mark.parametrize("dt", DT)
def test_cone_constraints(dt):
    j, t = _scen(dt, True)
    jd = jnp.float32 if dt == "f32" else jnp.float64
    jG, jh = jdyn.cone_constraints(j["stance"], mu=j["mu"], dtype=jd)
    tG, th = tdyn.cone_constraints(t["stance"], mu=t["mu"],
                                   dtype=TORCH_DTYPES[dt])
    close(jG, t2n(tG), dt)
    close(jh, t2n(th), dt)
    jG, jh = jdyn.cone_constraints(j["stance"], dtype=jd)   # preset scalars
    tG, th = tdyn.cone_constraints(t["stance"], dtype=TORCH_DTYPES[dt])
    close(jG, t2n(tG), dt)
    close(jh, t2n(th), dt)
    close(jdyn.friction_cone_rows(j["mu"], dtype=jd),
          t2n(tdyn.friction_cone_rows(t["mu"], dtype=TORCH_DTYPES[dt])), dt)
    assert jdyn.SWING_ROW_RELAX == tdyn.SWING_ROW_RELAX


@pytest.mark.parametrize("randomize", [False, True])
@pytest.mark.parametrize("dt", DT)
def test_build_balance_qp(dt, randomize):
    j, t = _scen(dt, randomize)
    jb, tb = jax_config().balance, mit_cheetah_config().balance
    order = ("R", "R_d", "x", "xdot", "w", "x_d", "xdot_d", "w_d", "feet",
             "stance")
    jqp = jdyn.build_balance_qp(*(j[k] for k in order), jb,
                                mass=j.get("mass"),
                                inertia_diag=j.get("inertia_diag"),
                                mu=j.get("mu"))
    tqp = tdyn.build_balance_qp(*(t[k] for k in order), tb,
                                mass=t.get("mass"),
                                inertia_diag=t.get("inertia_diag"),
                                mu=t.get("mu"))
    for a, b in zip(jqp, tqp):
        close(a, t2n(b), dt)


@pytest.mark.parametrize("dt", DT)
def test_forces_to_body_frame(dt):
    j, t = _scen(dt, False)
    rng = np.random.default_rng(8)
    jf, tf = both(rng.standard_normal((96, 12)), dt)
    close(jdyn.forces_to_body_frame(jf, j["R"], j["stance"]),
          t2n(tdyn.forces_to_body_frame(tf, t["R"], t["stance"])), dt)
