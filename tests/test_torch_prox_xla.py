"""PyTorch port: ``solve_balance_qp_fused(prox_tail=True,
prox_backend="xla")`` — the dense proximal-restart stage of the JAX
package's ``pallas_fused.py:1686-1747`` — and the dense polish (K3b, plain
version) against the float64 oracle.

The JAX package runs that stage's restarts in its dense IPM kernels only on
a TPU (``Bt % 1024 == 0 and not interpret``); on the CPU its branch is
``solver/ipm.solve_qp_prox``. The port runs the same branch rule without
the interpret condition, so on the CPU its restarts go through the plain
versions of K3a + K3b (``solve_qp_prox_fused``): held here against the JAX
package's ``solve_qp_prox`` on the same compacted slice.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_config as jcfg_fn
from quadruped_control_tpu.math.rotations import skew as jskew
from quadruped_control_tpu.ops.dynamics import assemble_qp as jassemble_qp
from quadruped_control_tpu.ops.dynamics import (
    cone_constraints as jcone_constraints,
)
from quadruped_control_tpu.solver import ipm as jipm
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused as pf
from quadruped_control_tpu_torch.solver import fused_ipm as fi
from quadruped_control_tpu_torch.solver.reference import solve_qp_batch_oracle
from torch_port_helpers import (
    dense_objective,
    dense_problem,
    numpy_scenarios,
    objective_np,
    t2n,
    torch_scenarios,
)

torch.set_num_threads(1)
BAL = mit_cheetah_config().balance
JBAL = jcfg_fn().balance
KW = dict(s_diag=tuple(BAL.s_diag), w_diag=float(BAL.w_diag))


def _scenario_args(seed, batch):
    d = numpy_scenarios(seed, batch, randomize=True, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag)
    args = (rm, b, s.stance.to(torch.float32), s.mu,
            torch.tensor(BAL.fz_min), torch.tensor(BAL.fz_max))
    return s, args


def _jax_dense_slice(args, idx):
    """The JAX package's dense assembly of the slice (pallas_fused.py:
    1687-1699) on the same arrays."""
    rm = jnp.asarray(t2n(args[0][idx]))
    bb = jnp.asarray(t2n(args[1][idx]))
    stl = jnp.asarray(t2n(args[2][idx])) > 0.5
    eye3 = jnp.eye(3, dtype=rm.dtype)
    top = jnp.concatenate(
        [eye3 * stl[:, l, None, None] for l in range(4)], axis=-1)
    bot = jnp.concatenate([jskew(rm[:, l]) for l in range(4)], axis=-1)
    A = jnp.concatenate([top, bot], axis=-2)
    Qd, cd = jassemble_qp(A, bb, JBAL)
    Gd, hd = jcone_constraints(stl, mu=jnp.asarray(t2n(args[3][idx])),
                               fz_min=float(args[4]), fz_max=float(args[5]),
                               cfg=JBAL, dtype=rm.dtype)
    return Qd, cd, Gd, hd


def test_dense_prox_stage_matches_the_jax_branch():
    """On a compacted slice (the 96 worst of 384 after a cheap 8-iteration
    solve) the port's dense stage (assembly + 3 restarts of K3a + K3b, plain
    versions) and the JAX package's branch (its assembly +
    ``solve_qp_prox``) on the same x0: converged flags agree on >= 0.98 of
    the lanes (1.0 measured), objective gap on the lanes both certify median
    < 1e-7, max < 1e-5 (float32 solves of the same subproblems by two
    factorizations)."""
    _, args = _scenario_args(13, 384)
    sol = pf.solve_grf_qp_fused(*args, iterations=8, polish_sweeps=2, **KW)
    idx = pf._worst_first(sol.converged, 96)
    assert int((~sol.converged[idx]).sum()) > 48
    x0 = sol.x[idx]
    got = pf._prox_stage_dense(args, idx, x0, BAL, True, prox_rho=1e-2,
                               prox_steps=3, prox_iterations=16)
    Qd, cd, Gd, hd = _jax_dense_slice(args, idx)
    ref = jipm.solve_qp_prox(Qd, cd, Gd, hd, x0=jnp.asarray(t2n(x0)),
                             rho_rel=1e-2, prox_steps=3, iterations=16,
                             tol=3e-5)
    cj = np.asarray(ref.converged)
    cp = t2n(got.converged)
    assert (cj == cp).mean() >= 0.98, (cj == cp).mean()
    assert cp.mean() > 0.5
    Q, c = np.asarray(Qd, np.float64), np.asarray(cd, np.float64)
    oj, op = objective_np(Q, c, np.asarray(ref.x)), objective_np(Q, c,
                                                                 t2n(got.x))
    both = cj & cp
    rel = (np.abs(op - oj) / (1.0 + np.abs(oj)))[both]
    assert np.median(rel) < 1e-7 and rel.max() < 1e-5, (np.median(rel),
                                                        rel.max())
    # The assembled slice is the JAX package's, to float32 round-off.
    for got_a, want_a in zip(pf._dense_slice(args, idx, BAL),
                             (Qd, cd, Gd, hd)):
        np.testing.assert_allclose(t2n(got_a), np.asarray(want_a),
                                   rtol=2e-6, atol=1e-6)


def test_xla_backend_against_the_kernel_backend(monkeypatch):
    """Both prox backends on one batch (B = 256, randomized robots, 12
    barrier iterations, prox 4 x 20): the xla stage runs its restarts
    through the dense kernels' plain versions (the JAX slice, 1024, is a
    multiple of 1024) and re-solves the same slice. Neither loses a
    converged lane; the kernel stage certifies more at this schedule (its
    restarts are warm and re-equilibrated; the xla stage's are cold), and
    the two converged sets agree on >= 0.9 of the instances (0.94
    measured), the xla set inside the kernel's on >= 0.99 of its lanes."""
    s, _ = _scenario_args(17, 256)
    calls = []
    orig = fi.solve_qp_prox_fused

    def spy(Q, *a, **kw):
        calls.append(Q.shape[0])
        return orig(Q, *a, **kw)

    monkeypatch.setattr(fi, "solve_qp_prox_fused", spy)
    sched = dict(mass=s.mass, inertia_diag=s.inertia_diag, mu=s.mu,
                 iterations=12, polish_sweeps=2, prox_steps=4,
                 prox_iterations=20, prox_sweeps=6)
    base = pf.solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, **sched)
    out = {}
    for backend in ("xla", "kernel"):
        out[backend] = pf.solve_balance_qp_fused(
            s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
            s.stance, BAL, prox_tail=True, prox_backend=backend, **sched)
    assert calls == [256]
    cx, ck = out["xla"].converged, out["kernel"].converged
    for c in (cx, ck):
        assert not bool((base.converged & ~c).any())
        assert float(c.float().mean()) > float(base.converged.float().mean())
    assert float((cx == ck).float().mean()) >= 0.9
    assert float((cx & ck).sum()) >= 0.99 * float(cx.sum())
    for f in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
        assert bool(torch.isfinite(getattr(out["xla"], f)).all()), f


def test_xla_backend_off_1024_takes_solve_qp_prox(monkeypatch):
    """A JAX slice size that is not a multiple of 1024 (rows = 1, B = 100:
    2 instances) runs ``solver/ipm.solve_qp_prox``, as in the JAX package."""
    s, _ = _scenario_args(19, 100)
    assert pf.prox_slice_size(100, 1, False, 8, 64, "xla") == 2
    seen = []

    def no_dense(*a, **kw):
        raise AssertionError("the dense kernels' stage ran")

    def spy(Q, *a, **kw):
        seen.append(Q.shape[0])
        return orig(Q, *a, **kw)

    orig = pf.solve_qp_prox
    monkeypatch.setattr(fi, "solve_qp_prox_fused", no_dense)
    monkeypatch.setattr(pf, "solve_qp_prox", spy)
    sol = pf.solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag, mu=s.mu,
        iterations=8, polish_sweeps=2, prox_tail=True, prox_backend="xla",
        rows=1, prox_steps=2, prox_iterations=10)
    assert seen == [2]
    assert sol.x.shape == (100, 12)


@pytest.fixture(scope="module")
def polished():
    problem = dense_problem(5, 256)
    bar = fi._dense_barrier_plain(*problem["soa"], iterations=20, tau=0.995)
    return problem, bar, fi._dense_polish_plain(*problem["soa"], *bar)


def test_polish_certified_lanes_meet_the_oracle(polished):
    """Where K3b's plain version certifies, the point is the float64
    optimum: objective gap median < 1e-7, max < 1e-4 (a certified float32
    point of an ill-conditioned instance can sit a few 1e-6 above it: its
    objective is a difference of ~1e4-sized terms); s and z are >= 0
    there; and the polish certifies > 0.95 of the lanes."""
    problem, _, (x, s, z, cert) = polished
    Q, c, G, h = problem["orig"]
    _, obj_star, _ = solve_qp_batch_oracle(Q, c, G, h, problem["stance"],
                                           10.0, 120.0)
    obj = dense_objective(problem, x)
    rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
    ok = t2n(cert) > 0.5
    assert ok.mean() > 0.95
    assert np.median(rel[ok]) < 1e-7 and rel[ok].max() < 1e-4, (
        np.median(rel[ok]), rel[ok].max())
    assert bool((s[:, ok] >= 0).all() and (z[:, ok] >= 0).all())


def test_polish_never_certifies_a_poisoned_lane(polished):
    """NaN / inf in one lane's data: that lane's certificate stays 0, the
    others are bitwise unchanged (per-lane arithmetic only)."""
    problem, bar, plain = polished
    n = 64
    soa = [a[:, :n].clone() for a in problem["soa"]]
    pt = [a[:, :n].contiguous() for a in bar]
    clean = fi._dense_polish_plain(*soa, *pt)
    soa[0][5, 3] = float("nan")   # Q[0, 5] of lane 3
    soa[3][2, 9] = float("inf")   # h[2] of lane 9
    bad = fi._dense_polish_plain(*soa, *pt)
    assert float(bad[3][3]) == 0.0 and float(bad[3][9]) == 0.0
    keep = [i for i in range(n) if i not in (3, 9)]
    for g, w in zip(bad, clean):
        assert torch.equal(g[..., keep], w[..., keep])
    assert torch.equal(clean[3], plain[3][:n])
