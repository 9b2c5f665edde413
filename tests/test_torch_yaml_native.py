"""PyTorch port: yaml_config.py and native.py against the JAX package.

The YAML loader gives the JAX loader's configuration field by field (the
reference schema of tests/test_yaml_config.py, overrides, the empty dict).
The native loader reads the library in the repository in place, through the
same C ABI (version 1): its batch solve equals the JAX ``native.py``'s on
the same 64 GRF QPs bit for bit (one library, one input), certifies every
one (status 0, KKT < 1e-8) and meets the float64 oracle within 1e-8
(tests/test_native.py:23-64). Without a library it falls back to the port's
NumPy oracle, equal to it bit for bit. Where the library is missing and a
build is asked for, ``g++`` builds it into the port's ``_build/`` and
nothing under ``native/`` is written.
"""

import dataclasses
import shutil
import textwrap

import numpy as np
import pytest

from quadruped_control_tpu import native as jnative
from quadruped_control_tpu import yaml_config as jyaml
from quadruped_control_tpu.config import mit_cheetah_config as jcfg_fn
from quadruped_control_tpu.utils import scenarios as jscen
from quadruped_control_tpu_torch import native as tnative
from quadruped_control_tpu_torch import yaml_config as tyaml
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver.reference import (
    grf_feasible_point,
    solve_qp_active_set,
    solve_qp_batch_oracle,
)
from torch_port_helpers import jax_scenarios, numpy_scenarios

REFERENCE_YAML = textwrap.dedent("""
    frequency: 300.0
    gait:
      t_stance: 0.8
      t_swing: 0.18
      height: 0.08
      gait_offset_phases: [0.0, 0.5, 0.5, 0.0]
    joint_control:
      kff: [0.0, 0.0, 0.0]
      kp: [40.0, 40.0, 50.0]
      kd: [1.0, 1.0, 1.0]
    balance_control:
      torque_min: -20.0
      torque_max: 20.0
      s_diagonal: [1.0, 1.0, 1.0, 10.0, 10.0, 5.0]
      w_diagonal: [0.00001]
      kff: [0.0, 0.0, 0.15, 0.0, 0.0, 0.0]
      kp_p: [100.0, 100.0, 100.0]
      kp_w: [5000.0, 5000.0, 5000.0]
      kd_p: [50.0, 50.0, 50.0]
      kd_w: [500.0, 500.0, 500.0]
    dynamics:
      Ib: [0.011253, 0.036203, 0.042673]
      mass: 11.0
      mu: 0.8
      fzmin: 10.0
      fzmax: 120.0
""")

OVERRIDES = [
    {},
    {"dynamics": {"mass": 9.0, "mu": 0.6}, "gait": {"t_swing": 0.25}},
    {"frequency": 500, "balance_control": {"w_diagonal": 2e-5,
                                           "kp_p": [1, 2, 3]},
     "joint_control": {"kd": [2, 2, 2]}, "unknown": {"x": 1}},
    {"gait": {"gait_offset_phases": [0.0, 0.25, 0.5, 0.75],
              "height": 0.1}, "dynamics": {"Ib": [0.02, 0.04, 0.05],
                                           "fzmin": 5, "fzmax": 150}},
]


def _same_config(tcfg, jcfg):
    t, j = dataclasses.asdict(tcfg), dataclasses.asdict(jcfg)
    assert sorted(t) == sorted(j)
    for k in j:
        assert t[k] == j[k], (k, t[k], j[k])


def test_load_config_matches_jax(tmp_path):
    p = tmp_path / "cfg.yaml"
    p.write_text(REFERENCE_YAML)
    cfg = tyaml.load_config(str(p))
    _same_config(cfg, jyaml.load_config(str(p)))
    assert cfg == mit_cheetah_config()
    empty = tmp_path / "empty.yaml"
    empty.write_text("")
    assert tyaml.load_config(str(empty)) == mit_cheetah_config()


@pytest.mark.parametrize("case", range(len(OVERRIDES)))
def test_config_from_dict_matches_jax(case):
    params = OVERRIDES[case]
    cfg = tyaml.config_from_dict(params)
    _same_config(cfg, jyaml.config_from_dict(params))
    if case == 1:
        assert cfg.balance.mass == 9.0 and cfg.gait.t_swing == 0.25
        assert cfg.balance.fz_max == 120.0


@pytest.fixture(scope="module")
def qp_batch():
    cfg = jcfg_fn()
    d = numpy_scenarios(11, 64)
    qp = jscen.assemble_qp_batch(jax_scenarios(d), cfg)
    x0 = np.stack([grf_feasible_point(st, cfg.balance.fz_min,
                                      cfg.balance.fz_max)
                   for st in d["stance"]])
    return tuple(np.asarray(a) for a in (qp.Q, qp.c, qp.G, qp.h)), x0, \
        d["stance"]


def _native_snapshot():
    return sorted((p.name, p.stat().st_size, p.stat().st_mtime_ns)
                  for p in tnative._NATIVE_DIR.iterdir())


def test_native_in_place_matches_jax(qp_batch):
    (Q, c, G, h), x0, stance = qp_batch
    before = _native_snapshot()
    lib = tnative.load_native(build_if_missing=False)
    assert lib is not None and lib.qp_native_abi_version() == 1
    got = tnative.solve_qp_batch_native(Q, c, G, h, x0)
    want = jnative.solve_qp_batch_native(Q, c, G, h, x0)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    x, lam, kkt, status = got
    assert np.all(status == 0) and kkt.max() < 1e-8
    xs, _, _ = solve_qp_batch_oracle(Q[:8], c[:8], G[:8], h[:8], stance[:8])
    np.testing.assert_allclose(x[:8], xs, atol=1e-8)
    assert _native_snapshot() == before
    with pytest.raises(ValueError, match="shapes"):
        tnative.solve_qp_batch_native(Q, c, G[:, :20], h, x0)


def test_fallback_is_the_oracle(qp_batch, tmp_path, monkeypatch):
    (Q, c, G, h), x0, _ = qp_batch
    monkeypatch.setattr(tnative, "_NATIVE_DIR", tmp_path / "none")
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    assert tnative.load_native() is None
    x, lam, kkt, status = tnative.solve_qp_batch_native(Q[:6], c[:6], G[:6],
                                                        h[:6], x0[:6])
    for b in range(6):
        sol = solve_qp_active_set(Q[b], c[b], G[b], h[b], x0=x0[b])
        np.testing.assert_array_equal(x[b], sol.x)
        np.testing.assert_array_equal(lam[b], sol.lam)
        assert kkt[b] == sol.kkt_error
        assert status[b] == (0 if sol.status == "optimal" else 1)
    assert not (tmp_path / "build").exists()


def test_build_goes_to_the_port_build_dir(qp_batch, tmp_path, monkeypatch):
    """A missing library is compiled into the port's _build/, never beside
    its source; the result equals the in-repo library's."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on this machine")
    (Q, c, G, h), x0, _ = qp_batch
    src_dir = tmp_path / "native"
    src_dir.mkdir()
    shutil.copy(tnative._NATIVE_DIR / "active_set_qp.cc", src_dir)
    before = _native_snapshot()
    monkeypatch.setattr(tnative, "_NATIVE_DIR", src_dir)
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path / "build")
    assert tnative.load_native(build_if_missing=False) is None
    lib = tnative.load_native()
    assert lib is not None
    assert [p.name for p in src_dir.iterdir()] == ["active_set_qp.cc"]
    assert [p.name for p in (tmp_path / "build").iterdir()] == [
        tnative._LIB_NAME]
    got = tnative.solve_qp_batch_native(Q[:16], c[:16], G[:16], h[:16],
                                        x0[:16])
    monkeypatch.undo()
    want = tnative.solve_qp_batch_native(Q[:16], c[:16], G[:16], h[:16],
                                         x0[:16])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-10)
    assert _native_snapshot() == before
