"""PyTorch port: mpc/horizon.py (the condensed horizon QP) and
mpc/structured.py (the O(N) Riccati IPM) against their JAX twins, float64,
on the same NumPy-made problems (tests/torch_port_helpers.mpc_problem_np).

Closed-form pieces — the SRB dynamics (A, B), the condensed (H, c, G, h), the
reference trajectory, the structured forward / adjoint maps, the H-vector
product, the linear cost and one Riccati solve — to 1e-12 relative to the
largest value. Solver outputs at the 1e-6 oracle bar on the objective (the
same iterations on both sides): cold, warm-started, and with per-instance
state weights and robot constants.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.mpc import horizon as jh
from quadruped_control_tpu.mpc import structured as js
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.mpc import horizon as th
from quadruped_control_tpu_torch.mpc import structured as ts
from torch_port_helpers import (
    assert_close,
    mpc_args_jax,
    mpc_args_torch,
    mpc_problem_np,
    t2n,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
B, N, DT = 16, 4, 0.03


def _robot_kw(d, lib):
    keys = ("mass", "inertia_diag", "mu")
    if lib == "jax":
        return {k: jnp.asarray(d[k]) for k in keys if k in d}
    return {k: torch.as_tensor(d[k]) for k in keys if k in d}


@pytest.mark.parametrize("randomize", [False, True],
                         ids=["preset", "per-instance-robot"])
def test_dynamics_and_condensed_qp_match_jax(randomize):
    d = mpc_problem_np(1, B, N, DT, TCFG, randomize=randomize)
    ja, ta = mpc_args_jax(d), mpc_args_torch(d)
    jk, tk = _robot_kw(d, "jax"), _robot_kw(d, "torch")
    dyn_kw = ("mass", "inertia_diag")
    A_j, B_j = jh.srb_discrete_dynamics(
        ja[2], ja[3], ja[4], DT, JCFG, **{k: jk[k] for k in dyn_kw if k in jk})
    A_t, B_t = th.srb_discrete_dynamics(
        ta[2], ta[3], ta[4], DT, TCFG, **{k: tk[k] for k in dyn_kw if k in tk})
    assert_close(A_t, np.asarray(A_j), 1e-12, "A")
    assert_close(B_t, np.asarray(B_j), 1e-12, "B")
    qj = jh.build_mpc_qp(*ja, N, DT, JCFG, **jk)
    qt = th.build_mpc_qp(*ta, N, DT, TCFG, **tk)
    for name, a, b in zip(th.MPCProblem._fields, qt, qj):
        assert tuple(a.shape) == np.asarray(b).shape, name
        assert_close(a, np.asarray(b), 1e-12, name)


def test_reference_trajectory_matches_jax():
    rng = np.random.default_rng(3)
    xi0 = rng.standard_normal((5, 13))
    cmd = rng.standard_normal((5, 6))
    want = jh.make_reference_trajectory(jnp.asarray(xi0), jnp.asarray(cmd),
                                        6, 0.02, target_height=0.3)
    got = th.make_reference_trajectory(torch.as_tensor(xi0),
                                       torch.as_tensor(cmd), 6, 0.02,
                                       target_height=0.3)
    assert_close(got, np.asarray(want), 1e-14)


def test_structured_pieces_match_jax():
    d = mpc_problem_np(2, B, N, DT, TCFG)
    dj = js.build_mpc_structured(*mpc_args_jax(d), N, DT, JCFG)
    dt_ = ts.build_mpc_structured(*mpc_args_torch(d), N, DT, TCFG)
    for name in ("A", "B", "G", "h", "err0", "L"):
        assert_close(getattr(dt_, name), np.asarray(getattr(dj, name)), 1e-12,
                     name)
    rng = np.random.default_rng(4)
    F = rng.standard_normal((B, N, 12))
    Y = rng.standard_normal((B, N, 13))
    Ft, Yt = torch.as_tensor(F), torch.as_tensor(Y)
    assert_close(ts._forward_map(dt_.A, dt_.B, Ft),
                 np.asarray(js._forward_map(dj.A, dj.B, jnp.asarray(F))),
                 1e-12, "forward map")
    assert_close(ts._adjoint_map(dt_.A, dt_.B, Yt),
                 np.asarray(js._adjoint_map(dj.A, dj.B, jnp.asarray(Y))),
                 1e-12, "adjoint map")
    assert_close(ts._hvp(dt_, Ft), np.asarray(js._hvp(dj, jnp.asarray(F))),
                 1e-12, "H F")
    assert_close(ts._linear_cost(dt_), np.asarray(js._linear_cost(dj)),
                 1e-12, "c")
    Rts = np.eye(12) * rng.uniform(1.0, 2.0, (B, N, 1, 1))
    reg = rng.uniform(1e-6, 1e-5, B)
    got = ts._riccati_solve(dt_, torch.as_tensor(Rts), Ft,
                            torch.as_tensor(reg))
    want = js._riccati_solve(dj, jnp.asarray(Rts), jnp.asarray(F),
                             jnp.asarray(reg))
    assert_close(got, np.asarray(want), 1e-12, "Riccati solve")


def _objective(data_t, F):
    """1/2 F^T H F + c^T F through the structured operators (float64)."""
    Ft = torch.as_tensor(np.array(F))
    hf = ts._hvp(data_t, Ft)
    c = ts._linear_cost(data_t)
    return t2n((0.5 * hf * Ft + c * Ft).sum((-2, -1)))


@pytest.mark.parametrize("case", ["cold", "warm", "per-instance-weights"])
def test_structured_solve_matches_jax(case):
    d = mpc_problem_np(5, B, N, DT, TCFG, randomize=(case != "cold"))
    ja, ta = mpc_args_jax(d), mpc_args_torch(d)
    jk, tk = _robot_kw(d, "jax"), _robot_kw(d, "torch")
    w = None
    if case == "per-instance-weights":
        w = np.asarray(th.DEFAULT_STATE_WEIGHTS) * np.random.default_rng(
            6).uniform(0.5, 2.0, (B, 13))
    dj = js.build_mpc_structured(*ja, N, DT, JCFG, state_weights=(
        None if w is None else jnp.asarray(w)), **jk)
    dt_ = ts.build_mpc_structured(*ta, N, DT, TCFG, state_weights=(
        None if w is None else torch.as_tensor(w)), **tk)
    warm_j = warm_t = None
    if case == "warm":
        F0, s0 = js.solve_mpc_qp_structured(dj, iterations=6, tol=1e-6)
        warm_j = (F0, s0.s, s0.z)
        warm_t = tuple(torch.as_tensor(np.array(a)) for a in warm_j)
    Fj, sj = js.solve_mpc_qp_structured(dj, iterations=25, tol=1e-6,
                                        warm_start=warm_j)
    Ft, st = ts.solve_mpc_qp_structured(dt_, iterations=25, tol=1e-6,
                                        warm_start=warm_t)
    oj, ot = _objective(dt_, Fj), _objective(dt_, t2n(Ft))
    rel = np.abs(ot - oj) / (1.0 + np.abs(oj))
    assert rel.max() < 1e-6, rel
    assert np.array_equal(t2n(st.converged), np.asarray(sj.converged))
    assert np.asarray(sj.converged).mean() > 0.9
    assert_close(st.x, np.asarray(sj.x), 1e-6, "F")
    assert tuple(st.z.shape) == (B, N * 24)
    assert tuple(st.s.shape) == (B, N * 24)


def test_condensed_solve_matches_jax():
    d = mpc_problem_np(7, B, N, DT, TCFG)
    Fj, sj = jh.solve_mpc(*mpc_args_jax(d), N, DT, JCFG, iterations=25)
    Ft, st = th.solve_mpc(*mpc_args_torch(d), N, DT, TCFG, iterations=25)
    qp = th.build_mpc_qp(*mpc_args_torch(d), N, DT, TCFG)
    H, c = t2n(qp.H), t2n(qp.c)

    def obj(F):
        x = np.asarray(F).reshape(B, -1)
        return 0.5 * np.einsum("bi,bij,bj->b", x, H, x) + (c * x).sum(-1)

    oj, ot = obj(Fj), obj(t2n(Ft))
    assert (np.abs(ot - oj) / (1.0 + np.abs(oj))).max() < 1e-6
    assert np.array_equal(t2n(st.converged), np.asarray(sj.converged))
    assert Ft.shape == (B, N, 12)
