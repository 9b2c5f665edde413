"""PyTorch port: sim/plant against the JAX package on the same NumPy-made
states (float64). One substep is the same arithmetic in the same order
(1e-11 relative, the prefactor's 6x6 inverse included); several substeps of
stiff contact amplify last-bit differences, stated per test."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.sim import model as jmodel
from quadruped_control_tpu.sim import plant as jplant
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.sim import plant as tplant
from quadruped_control_tpu_torch.utils.scenarios import whole_body_walk_states
from torch_port_helpers import (
    assert_close,
    jax_whole_body_state,
    t2n,
    torch_whole_body_state,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
JM = jmodel.mit_cheetah_whole_body_model(JCFG, dtype=jnp.float64)
TM = tmodel.mit_cheetah_whole_body_model(TCFG, dtype=torch.float64,
                                         device="cpu")
B = 16
DT = 1.0 / TCFG.frequency


def _inputs(seed):
    d = whole_body_walk_states(seed, B, TCFG, on_ground=True)
    tau = np.random.default_rng(seed).uniform(-8.0, 8.0, (B, 4, 3))
    return d, tau


def _compare(ts, js, tol):
    for field in js._fields:
        assert_close(getattr(ts, field), getattr(js, field), tol, field)


def test_contact_config_and_init_state():
    jc, tc = jplant.ContactConfig(), tplant.ContactConfig()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert convert.contact_config_from_dict(dataclasses.asdict(
        jplant.ContactConfig(tangential="coulomb", mu=0.6))) == \
        tplant.ContactConfig(tangential="coulomb", mu=0.6)
    for kw in ({}, {"height": 0.2}, {"q0": (0.1, 1.2, -2.0)}):
        js = jplant.init_whole_body_state(JCFG, (3,), dtype=jnp.float64, **kw)
        ts = tplant.init_whole_body_state(TCFG, (3,), dtype=torch.float64,
                                          device="cpu", **kw)
        _compare(ts, js, 1e-14)
    d, _ = _inputs(0)
    jcom, jj = jplant.whole_body_com_state(jax_whole_body_state(d), JCFG)
    tcom, tj = tplant.whole_body_com_state(torch_whole_body_state(d), TCFG)
    for a, b in zip(tuple(tcom) + tuple(tj), tuple(jcom) + tuple(jj)):
        assert_close(a, b, 1e-14)
    back = convert.to_numpy(torch_whole_body_state(d))
    for k in ("R", "x", "u", "q", "anchor"):
        assert np.array_equal(back[k], d[k])


@pytest.mark.parametrize("tangential", ["anchor", "coulomb"])
@pytest.mark.parametrize("m_update", ["substep", "tick"])
def test_whole_body_step_one_substep(m_update, tangential):
    d, tau = _inputs(1)
    jc = jplant.ContactConfig(tangential=tangential)
    tc = tplant.ContactConfig(tangential=tangential)
    js = jplant.whole_body_step(jax_whole_body_state(d), jnp.asarray(tau),
                                DT / 10, JM, JCFG, jc, n_substeps=1,
                                m_update=m_update)
    ts = tplant.whole_body_step(torch_whole_body_state(d),
                                torch.as_tensor(tau), DT / 10, TM, TCFG, tc,
                                n_substeps=1, m_update=m_update)
    _compare(ts, js, 1e-11)
    # Contact acted: some feet are on the ground in these states.
    assert (t2n(ts.u) != d["u"]).any()


@pytest.mark.parametrize("m_update", ["substep", "tick"])
def test_whole_body_step_four_substeps(m_update):
    """Four substeps: the contact stiffness (3e4 N/m) amplifies the last-bit
    differences of one substep; 1e-9 relative holds with margin."""
    d, tau = _inputs(2)
    js = jplant.whole_body_step(jax_whole_body_state(d), jnp.asarray(tau),
                                DT, JM, JCFG, n_substeps=4,
                                m_update=m_update)
    ts = tplant.whole_body_step(torch_whole_body_state(d),
                                torch.as_tensor(tau), DT, TM, TCFG,
                                n_substeps=4, m_update=m_update)
    _compare(ts, js, 1e-9)


def test_default_substep_count_and_bad_mode():
    d, tau = _inputs(3)
    c = tplant.ContactConfig(substep_dt=DT / 2)
    a = tplant.whole_body_step(torch_whole_body_state(d),
                               torch.as_tensor(tau), DT, TM, TCFG, c)
    b = tplant.whole_body_step(torch_whole_body_state(d),
                               torch.as_tensor(tau), DT, TM, TCFG, c,
                               n_substeps=2)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        tplant.whole_body_step(torch_whole_body_state(d),
                               torch.as_tensor(tau), DT, TM, TCFG,
                               m_update="never")


def test_guard_lanes_freeze_and_clamp():
    """A NaN joint velocity freezes its lane for the substep (pose kept,
    velocity zeroed), a 1e6 one is clamped to 200; neither leaks into the
    other lanes. Same in both packages."""
    d, tau = _inputs(4)
    d["u"][0, 6] = np.nan
    d["u"][1, 7] = 1.0e6
    clean, _ = _inputs(4)
    js = jplant.whole_body_step(jax_whole_body_state(d), jnp.asarray(tau),
                                DT / 10, JM, JCFG, n_substeps=1,
                                m_update="tick")
    ts = tplant.whole_body_step(torch_whole_body_state(d),
                                torch.as_tensor(tau), DT / 10, TM, TCFG,
                                n_substeps=1, m_update="tick")
    ref = tplant.whole_body_step(torch_whole_body_state(clean),
                                 torch.as_tensor(tau), DT / 10, TM, TCFG,
                                 n_substeps=1, m_update="tick")
    for field in ("R", "x", "q", "anchor"):
        assert np.array_equal(t2n(getattr(ts, field))[0], d[field][0])
        assert np.array_equal(np.asarray(getattr(js, field))[0], d[field][0])
    assert (t2n(ts.u)[0] == 0).all() and (np.asarray(js.u)[0] == 0).all()
    assert np.isfinite(t2n(ts.u)).all()
    assert np.abs(t2n(ts.u)[1]).max() <= 200.0 and t2n(ts.u)[1, 7] == 200.0
    _compare(ts, js, 1e-9)
    for a, b in zip(ts, ref):
        assert torch.equal(a[2:], b[2:])
    # Ten substeps on: every lane is still finite.
    ts10 = tplant.whole_body_step(torch_whole_body_state(d),
                                  torch.as_tensor(tau), DT, TM, TCFG,
                                  n_substeps=10, m_update="tick")
    assert all(bool(torch.isfinite(a).all()) for a in ts10)
