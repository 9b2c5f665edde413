"""PyTorch port: control/plant.py (the SRB plant surrogate) against the JAX
package, float64, on the same NumPy-made states.

``init_plant_state`` is exact. ``plant_step`` agrees within 1e-10 (relative
to each field's largest value, plus 1e-10): random mid-walk states with
random stance masks; states whose forces saturate every clip (the pulls and
pushes of tests/test_rollout.py::test_plant_saturates_unphysical_forces,
chained five steps); tumbling bodies (rates at the 100 rad/s clip, any
orientation, feet far out of reach); and a NaN force on a stance leg, which
both packages pass into the same fields.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.control import plant as jplant
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import plant as tplant
from torch_port_helpers import rpy_to_matrix_np

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
DT = 1.0 / TCFG.frequency
TOL = 1e-10


def _plant_np(seed, batch, tumbling=False):
    """Nested dict of a PlantState (com, feet_world, joints), float64."""
    rng = np.random.default_rng(seed)
    ang = np.pi if tumbling else 0.3
    R = rpy_to_matrix_np(rng.uniform(-ang, ang, (batch, 3)))
    x = np.stack([rng.normal(0, 0.1, batch), rng.normal(0, 0.1, batch),
                  rng.uniform(0.05, 0.35, batch)], -1)
    w = rng.uniform(-120, 120, (batch, 3)) if tumbling else \
        0.5 * rng.standard_normal((batch, 3))
    feet = (np.array([[-0.2, 0.13, 0], [0.2, 0.13, 0], [-0.2, -0.13, 0],
                      [0.2, -0.13, 0]]) + x[:, None, :] * [1, 1, 0]
            + 0.02 * rng.standard_normal((batch, 4, 3)))
    if tumbling:
        feet = feet + rng.uniform(-1.0, 1.0, (batch, 4, 3))
    return dict(
        com=dict(R=R, x=x, xdot=0.4 * rng.standard_normal((batch, 3)), w=w),
        feet_world=feet,
        joints=dict(q=np.tile([0.0, 0.8, -1.6], (batch, 4, 1))
                    + 0.2 * rng.standard_normal((batch, 4, 3)),
                    qdot=rng.standard_normal((batch, 4, 3))))


def _inputs_np(seed, batch, saturating=False):
    rng = np.random.default_rng(seed + 1000)
    f = rng.normal(0.0, 10.0, (batch, 4, 3))
    f[..., 2] = rng.uniform(-20.0, 140.0, (batch, 4))
    if saturating:
        f = rng.choice([-1.0e9, 1.0e9], (batch, 4, 3))
        f[:, 0] = [1.0e9, 1.0e9, -1.0e9]
    stance = rng.random((batch, 4)) < 0.7
    refs = (np.array([[-0.2, 0.13, 0.05], [0.2, 0.13, 0.05],
                      [-0.2, -0.13, 0.05], [0.2, -0.13, 0.05]])
            + rng.normal(0.0, 0.03, (batch, 4, 3)))
    return f.reshape(batch, 12), stance, refs


def _jax_plant(d):
    from quadruped_control_tpu.types import ComState, JointState

    return jplant.PlantState(
        com=ComState(**{k: jnp.asarray(v) for k, v in d["com"].items()}),
        feet_world=jnp.asarray(d["feet_world"]),
        joints=JointState(**{k: jnp.asarray(v)
                             for k, v in d["joints"].items()}))


def _fields(p):
    return {"R": p.com.R, "x": p.com.x, "xdot": p.com.xdot, "w": p.com.w,
            "feet_world": p.feet_world, "q": p.joints.q,
            "qdot": p.joints.qdot}


def _assert_plants(tp, jp, tol=TOL):
    for k, want in _fields(jp).items():
        got = _fields(tp)[k].detach().numpy()
        want = np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                      err_msg=k)
        scale = 1.0 + np.nanmax(np.abs(want))
        np.testing.assert_allclose(got, want, rtol=0.0, atol=tol * scale,
                                   equal_nan=True, err_msg=k)


@pytest.mark.parametrize("batch_shape", [(), (5,), (2, 3)])
def test_init_plant_state_is_exact(batch_shape):
    for height in (None, 0.3):
        jp = jplant.init_plant_state(JCFG, batch_shape, dtype=jnp.float64,
                                     height=height)
        tp = tplant.init_plant_state(TCFG, batch_shape, dtype=torch.float64,
                                     height=height, device="cpu")
        _assert_plants(tp, jp, tol=0.0)
    tp32 = tplant.init_plant_state(TCFG, (3,), device="cpu")
    assert tp32.com.x.dtype == torch.float32


def test_init_plant_state_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="cuda"):
        tplant.init_plant_state(TCFG, (2,))


@pytest.mark.parametrize("case", ["walk", "tumbling", "saturating"])
def test_plant_step_matches_jax(case):
    B = 64
    d = _plant_np(7, B, tumbling=case == "tumbling")
    f, stance, refs = _inputs_np(7, B, saturating=case == "saturating")
    jp = jplant.plant_step(_jax_plant(d), jnp.asarray(f), jnp.asarray(stance),
                           jnp.asarray(refs), DT, JCFG)
    tp = tplant.plant_step(
        convert.plant_state_from_numpy(d, dtype=torch.float64, device="cpu"),
        torch.as_tensor(f), torch.as_tensor(stance), torch.as_tensor(refs),
        DT, TCFG)
    _assert_plants(tp, jp)
    assert np.all(np.abs(np.asarray(jp.com.w)) <= 100.0)
    assert np.all(np.asarray(jp.feet_world)[..., 2] >= 0.0)


def test_plant_saturates_unphysical_forces_chained():
    """The setting of tests/test_rollout.py::test_plant_saturates_unphysical
    _forces: five chained steps of 1e9 N pulls and pushes, all four legs in
    stance, from the laying pose; every step's state held."""
    jp = jplant.init_plant_state(JCFG, (), dtype=jnp.float64)
    tp = tplant.init_plant_state(TCFG, (), dtype=torch.float64, device="cpu")
    bad = np.full((12,), 1.0e9)
    bad[2] = -1.0e9
    for _ in range(5):
        jp = jplant.plant_step(jp, jnp.asarray(bad), jnp.ones(4, bool),
                               jp.feet_world, 0.01, JCFG)
        tp = tplant.plant_step(tp, torch.as_tensor(bad),
                               torch.ones(4, dtype=torch.bool),
                               tp.feet_world, 0.01, TCFG)
        _assert_plants(tp, jp)
    assert torch.all(torch.isfinite(tp.com.x))
    assert torch.all(torch.abs(tp.com.x) < 10.0)


def test_plant_step_propagates_nan_like_jax():
    B = 8
    d = _plant_np(3, B)
    f, _, refs = _inputs_np(3, B)
    stance = np.ones((B, 4), bool)
    f[2, 5] = np.nan   # a stance leg's fz: its tangential clips go NaN too
    f[5, 0] = np.nan   # a stance leg's fx
    jp = jplant.plant_step(_jax_plant(d), jnp.asarray(f), jnp.asarray(stance),
                           jnp.asarray(refs), DT, JCFG)
    tp = tplant.plant_step(
        convert.plant_state_from_numpy(d, dtype=torch.float64, device="cpu"),
        torch.as_tensor(f), torch.as_tensor(stance), torch.as_tensor(refs),
        DT, TCFG)
    assert np.isnan(np.asarray(jp.com.x)[2]).any()
    _assert_plants(tp, jp)
