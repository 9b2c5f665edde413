"""PyTorch port: the plain dense solver (solver/ipm.py, smallalg, utils/ff)
against the JAX functions in float64 on NumPy-made scenarios covering the
three stance patterns, and against the port's own float64 oracle."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.solver import ipm as jipm
from quadruped_control_tpu.solver import smallalg as jsm
from quadruped_control_tpu.utils import ff as jff
from quadruped_control_tpu.utils.scenarios import assemble_qp_batch as jax_assemble
from quadruped_control_tpu_torch.solver import ipm as tipm
from quadruped_control_tpu_torch.solver import smallalg as tsm
from quadruped_control_tpu_torch.solver.reference import solve_qp_batch_oracle
from quadruped_control_tpu_torch.utils import ff as tff
from quadruped_control_tpu_torch.utils.scenarios import assemble_qp_batch
from torch_port_helpers import (jax_scenarios, numpy_scenarios, objective_np,
                                t2n, torch_scenarios)

torch.set_num_threads(1)

B = 64


@pytest.fixture(scope="module")
def problems():
    d = numpy_scenarios(21, B, randomize=True, dtype=np.float64)
    jqp = jax_assemble(jax_scenarios(d))
    tqp = assemble_qp_batch(torch_scenarios(d, torch.float64))
    oracle = solve_qp_batch_oracle(t2n(tqp.Q), t2n(tqp.c), t2n(tqp.G),
                                   t2n(tqp.h), d["stance"])
    return d, jqp, tqp, oracle


def rel_gap(qp, xa, xb):
    oa = objective_np(t2n(qp.Q), t2n(qp.c), xa)
    ob = objective_np(t2n(qp.Q), t2n(qp.c), xb)
    return np.abs(oa - ob) / (1.0 + np.abs(ob))


def test_equilibrate(problems):
    _, jqp, tqp, _ = problems
    js = jipm.equilibrate(jqp.Q, jqp.c, jqp.G, jqp.h)
    ts = tipm.equilibrate(tqp.Q, tqp.c, tqp.G, tqp.h)
    for a, b in zip(js, ts):
        # Same elementwise formulas in float64.
        np.testing.assert_allclose(t2n(b), np.asarray(a), rtol=1e-12,
                                   atol=1e-12)


CASES = {
    "cold": dict(),
    "cold_unrolled": dict(unrolled_linalg=True),
    "no_polish": dict(polish=False),
    "short": dict(iterations=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_solve_qp_ipm_matches_jax(problems, case):
    _, jqp, tqp, _ = problems
    kw = CASES[case]
    js = jipm.solve_qp_ipm(jqp.Q, jqp.c, jqp.G, jqp.h, **kw)
    ts = tipm.solve_qp_ipm(tqp.Q, tqp.c, tqp.G, tqp.h, **kw)
    # Same algorithm in float64; only LAPACK vs XLA factorization rounding
    # differs: objectives to 1e-9 relative, masks equal.
    assert rel_gap(tqp, t2n(ts.x), np.asarray(js.x)).max() <= 1e-9
    np.testing.assert_array_equal(t2n(ts.converged), np.asarray(js.converged))
    assert int(ts.iterations) == int(js.iterations)


def test_solve_qp_ipm_warm_and_reset_mask(problems):
    d, jqp, tqp, _ = problems
    jc = jipm.solve_qp_ipm(jqp.Q, jqp.c, jqp.G, jqp.h)
    tc = tipm.solve_qp_ipm(tqp.Q, tqp.c, tqp.G, tqp.h)
    jw = jipm.solve_qp_ipm(jqp.Q, jqp.c, jqp.G, jqp.h, iterations=6,
                           warm_start=(jc.x, jc.s, jc.z))
    tw = tipm.solve_qp_ipm(tqp.Q, tqp.c, tqp.G, tqp.h, iterations=6,
                           warm_start=(tc.x, tc.s, tc.z))
    assert rel_gap(tqp, t2n(tw.x), np.asarray(jw.x)).max() <= 1e-9
    np.testing.assert_array_equal(t2n(tw.converged), np.asarray(jw.converged))
    # Stale rows: every third instance had another stance before.
    reset = np.zeros((B, 24), bool)
    reset[::3, :6] = True
    reset[::3, 18:] = True
    jr = jipm.solve_qp_ipm(jqp.Q, jqp.c, jqp.G, jqp.h, iterations=10,
                           warm_start=(jc.x, jc.s, jc.z),
                           warm_reset_mask=jnp.asarray(reset))
    tr = tipm.solve_qp_ipm(tqp.Q, tqp.c, tqp.G, tqp.h, iterations=10,
                           warm_start=(tc.x, tc.s, tc.z),
                           warm_reset_mask=torch.from_numpy(reset))
    assert rel_gap(tqp, t2n(tr.x), np.asarray(jr.x)).max() <= 1e-9
    np.testing.assert_array_equal(t2n(tr.converged), np.asarray(jr.converged))


def test_solve_qp_prox_matches_jax(problems):
    _, jqp, tqp, _ = problems
    kw = dict(prox_steps=2, iterations=15, unrolled_linalg=False)
    jp = jipm.solve_qp_prox(jqp.Q, jqp.c, jqp.G, jqp.h, **kw)
    tp = tipm.solve_qp_prox(tqp.Q, tqp.c, tqp.G, tqp.h, **kw)
    assert rel_gap(tqp, t2n(tp.x), np.asarray(jp.x)).max() <= 1e-9
    np.testing.assert_array_equal(t2n(tp.converged), np.asarray(jp.converged))
    assert int(tp.iterations) == int(jp.iterations) == 30


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solve_qp_ipm_meets_oracle(problems, dtype):
    _, _, tqp, (x_star, obj_star, kkt) = problems
    assert kkt.max() < 1e-8           # the oracle certifies itself
    sol = tipm.solve_qp_ipm(tqp.Q.to(dtype), tqp.c.to(dtype),
                            tqp.G.to(dtype), tqp.h.to(dtype),
                            tol=1e-7 if dtype == torch.float64 else 3e-5)
    obj = objective_np(t2n(tqp.Q), t2n(tqp.c), t2n(sol.x))
    rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
    assert float(sol.converged.float().mean()) > 0.97
    if dtype == torch.float64:
        assert rel.max() < 1e-6       # the repo's objective bar
    else:
        # float32: the bar holds on the median; single ill-conditioned
        # instances sit a few 1e-6 above (objective = difference of ~1e4
        # terms evaluated at a float32 x).
        assert np.median(rel) < 1e-6 and rel.max() < 1e-4


def test_qp_objective(problems):
    _, jqp, tqp, (x_star, _, _) = problems
    a = jipm.qp_objective(jqp.Q, jqp.c, jnp.asarray(x_star))
    b = tipm.qp_objective(tqp.Q, tqp.c, torch.from_numpy(x_star))
    np.testing.assert_allclose(t2n(b), np.asarray(a), rtol=1e-12)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_error_free_transformations(dt):
    npd = np.float32 if dt == "f32" else np.float64
    rng = np.random.default_rng(5)
    a = (rng.standard_normal(512) * 10.0 ** rng.integers(-6, 6, 512)).astype(npd)
    b = (rng.standard_normal(512) * 10.0 ** rng.integers(-6, 6, 512)).astype(npd)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    # Error-free transformations are exact: bitwise equality across the
    # libraries, and s + e == a + b in higher precision.
    for jf, tf in ((jff.two_sum, tff.two_sum), (jff.two_prod, tff.two_prod),):
        for x, y in zip(jf(ja, jb), tf(ta, tb)):
            np.testing.assert_array_equal(np.asarray(x), t2n(y))
    for x, y in zip(jff.split(ja), tff.split(ta)):
        np.testing.assert_array_equal(np.asarray(x), t2n(y))
    if dt == "f32":
        p, e = tff.two_prod(ta, tb)
        np.testing.assert_array_equal(t2n(p).astype(np.float64) + t2n(e),
                                      a.astype(np.float64) * b)


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_compensated_residual_and_refined_solve(dt):
    npd = np.float32 if dt == "f32" else np.float64
    rng = np.random.default_rng(6)
    # Ill-conditioned systems (kappa ~ 1e5), the regime the polish lives in.
    U = np.linalg.qr(rng.standard_normal((16, 9, 9)))[0]
    sv = np.logspace(0, -5, 9)
    A = (U * sv) @ np.swapaxes(U, -1, -2)
    x_true = rng.standard_normal((16, 9))
    A32, x32 = A.astype(npd), x_true.astype(npd)
    b32 = (A32.astype(np.float64) @ x32.astype(np.float64)[..., None])[..., 0].astype(npd)
    jr = jff.residual_compensated(jnp.asarray(A32), jnp.asarray(x32), jnp.asarray(b32))
    tr = tff.residual_compensated(torch.from_numpy(A32), torch.from_numpy(x32),
                                  torch.from_numpy(b32))
    wide = np.longdouble
    exact = (b32.astype(wide) - (A32.astype(wide) @ x32.astype(wide)[..., None])[..., 0]).astype(np.float64)
    eps = np.finfo(npd).eps
    # Both capture the (tiny, rounding-sized) residual to a few percent of
    # its own scale, where a plain evaluation would return noise of the
    # size of eps * |A||x|.
    atol = 0.05 * np.abs(exact).max()
    np.testing.assert_allclose(t2n(tr), exact, atol=atol)
    np.testing.assert_allclose(t2n(tr), np.asarray(jr), atol=atol)
    js = jff.solve_refined(jnp.asarray(A32), jnp.asarray(b32))
    ts = tff.solve_refined(torch.from_numpy(A32), torch.from_numpy(b32))
    # The two LU factorizations pivot alike but round differently; both
    # recover x to kappa * eps.
    tol = 1e5 * eps * 20
    np.testing.assert_allclose(t2n(ts), x32, atol=tol)
    np.testing.assert_allclose(t2n(ts), np.asarray(js), atol=tol)
    cs = tff.compensated_sum(torch.from_numpy(np.array([[1.0, 1e-9, -1.0, 3e-9, 0.5]], npd)))
    js_ = jff.compensated_sum(jnp.asarray(np.array([[1.0, 1e-9, -1.0, 3e-9, 0.5]], npd)))
    np.testing.assert_array_equal(t2n(cs), np.asarray(js_))


def test_unrolled_cholesky(problems):
    _, jqp, tqp, _ = problems
    jL = jsm.cholesky_unrolled(jqp.Q, 12)
    tL = tsm.cholesky_unrolled(tqp.Q, 12)
    for i in range(12):
        for k in range(i + 1):
            # lax.rsqrt vs 1/sqrt differ in the last bit; the recurrence
            # carries that through kappa ~ 1e6.
            np.testing.assert_allclose(t2n(tL[i][k]), np.asarray(jL[i][k]),
                                       rtol=1e-9, atol=1e-12)
    jx = jsm.cholesky_factor_solve(jqp.Q, jqp.c, 12)
    tx = tsm.cholesky_factor_solve(tqp.Q, tqp.c, 12)
    # kappa(Q) ~ 1e6 amplifies the last-bit rsqrt difference.
    np.testing.assert_allclose(t2n(tx), np.asarray(jx), rtol=1e-8, atol=1e-8)
    # A non-PD matrix poisons its instance with NaN, like the JAX version.
    bad = tqp.Q.clone()
    bad[0] = -bad[0]
    out = tsm.cholesky_factor_solve(bad, tqp.c, 12)
    assert torch.isnan(out[0]).all() and torch.isfinite(out[1:]).all()
