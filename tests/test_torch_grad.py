"""PyTorch port: gradients through the QP solves (solver/ipm.py,
solver/diff.py) and the kinematics, and solver/admm.py's forward.
``torch.autograd`` against ``jax.grad`` in float64 on the same inputs:

- forward kinematics (tests/test_differentiability.py:25): 1e-12;
- the unrolled barrier IPM, d(total fz)/d(mass) through assembly and a
  15-iteration solve (test_differentiability.py:41), and d(x . w)/d(Q, c)
  through 40 iterations: 1e-9 relative to the largest entry (both sides run
  the same arithmetic, so the gap is round-off through 40 Newton steps);
- ``solver/diff.solve_qp_implicit`` against the JAX custom VJP, gradients
  with respect to (Q, c, G, h), a batch, one QP, and G and h shared by a
  batch (tests/test_diff_implicit.py): 1e-8 relative to the largest entry;
  and against the port's own unrolled autodiff with the JAX test's
  tolerances on the JAX test's problems (c: rtol 2e-3, atol 1e-6;
  symmetrized Q: rtol 5e-3, atol 2e-2).

``solve_qp_admm``'s forward against JAX: 1e-9 relative; the converged mask
exactly. The MPC, gravity-bias and closed-loop gradients are in
test_torch_grad_mpc.py and test_torch_grad_loop.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_config as jcfg_fn
from quadruped_control_tpu.ops import dynamics as jdyn
from quadruped_control_tpu.ops.kinematics import forward_kinematics as jfk
from quadruped_control_tpu.solver.admm import solve_qp_admm as jadmm
from quadruped_control_tpu.solver.diff import solve_qp_implicit as jimp
from quadruped_control_tpu.solver.ipm import solve_qp_ipm as jipm
from quadruped_control_tpu.utils import scenarios as jscen
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.ops import dynamics as tdyn
from quadruped_control_tpu_torch.ops.kinematics import forward_kinematics
from quadruped_control_tpu_torch.solver.admm import solve_qp_admm
from quadruped_control_tpu_torch.solver.diff import solve_qp_implicit
from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm
from torch_port_helpers import t2n

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_config()
F64 = torch.float64


def _close(got, want, tol, what=""):
    """|got - want| <= tol * (1 + max|want|)."""
    got = np.asarray(t2n(got) if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0.0,
                               atol=tol * (1.0 + np.abs(want).max()),
                               err_msg=what)


def _leaf(a):
    return torch.tensor(np.asarray(a), dtype=F64, requires_grad=True)


@pytest.fixture(scope="module")
def qps():
    """The GRF QPs of tests/test_diff_implicit.py (``grf_scenarios`` of the
    JAX package, key 5, float64), the first four of eight, as NumPy
    arrays: Q, c, G, h. Its tolerances for implicit against unrolled
    gradients were set on these problems."""
    s = jscen.grf_scenarios(jax.random.key(5), 8, JCFG, dtype=jnp.float64)
    qp = jscen.assemble_qp_batch(s, JCFG)
    return tuple(np.array(a) for a in (qp.Q, qp.c, qp.G, qp.h))


def _first(qps, B=4):
    return tuple(a[:B] for a in qps)


def test_grad_through_kinematics():
    rng = np.random.default_rng(0)
    for q in (np.tile([0.1, 1.2, -2.0], (4, 1)),
              rng.uniform(-1.5, 1.5, (3, 4, 3))):
        w = rng.standard_normal(q.shape)

        def jloss(qq):
            return jnp.sum(jfk(qq, JCFG.kinematics) * w)

        g_j = jax.grad(jloss)(jnp.asarray(q))
        qt = _leaf(q)
        torch.sum(forward_kinematics(qt, TCFG.kinematics)
                  * torch.as_tensor(w)).backward()
        _close(qt.grad, g_j, 1e-12, "dFK")


def _standing_qp(lib, mass):
    """The standing scenario of tests/test_differentiability.py:41."""
    if lib == "jax":
        q0 = jnp.asarray(np.tile([0.0, 1.61, -2.78], (4, 1)))
        feet = jfk(q0, JCFG.kinematics)
        eye, z3 = jnp.eye(3), jnp.zeros(3)
        x = jnp.array([0.0, 0.0, 0.26])
        return jdyn.build_balance_qp(eye, eye, x, z3, z3, x, z3, z3, feet,
                                     jnp.ones(4, bool), JCFG.balance,
                                     mass=mass)
    q0 = torch.tensor(np.tile([0.0, 1.61, -2.78], (4, 1)), dtype=F64)
    feet = forward_kinematics(q0, TCFG.kinematics)
    eye, z3 = torch.eye(3, dtype=F64), torch.zeros(3, dtype=F64)
    x = torch.tensor([0.0, 0.0, 0.26], dtype=F64)
    return tdyn.build_balance_qp(eye, eye, x, z3, z3, x, z3, z3, feet,
                                 torch.ones(4, dtype=torch.bool),
                                 TCFG.balance, mass=mass)


def test_grad_through_unrolled_qp_solve_wrt_mass():
    def jloss(mass):
        qp = _standing_qp("jax", mass)
        sol = jipm(qp.Q, qp.c, qp.G, qp.h, iterations=15, polish=False)
        return jnp.sum(sol.x[2::3])

    g_j = jax.grad(jloss)(jnp.asarray(11.0))
    m = torch.tensor(11.0, dtype=F64, requires_grad=True)
    qp = _standing_qp("torch", m)
    sol = solve_qp_ipm(qp.Q, qp.c, qp.G, qp.h, iterations=15, polish=False)
    torch.sum(sol.x[2::3]).backward()
    assert np.isfinite(float(m.grad))
    _close(m.grad, g_j, 1e-9, "d total fz / d mass")


def test_grad_through_unrolled_ipm_wrt_problem(qps):
    Q, c, G, h = _first(qps)
    w = np.random.default_rng(3).normal(size=12)

    def jloss(Q_, c_):
        sol = jipm(Q_, c_, jnp.asarray(G), jnp.asarray(h), iterations=40,
                   polish=False)
        return jnp.sum(sol.x * w)

    gQ_j, gc_j = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(Q),
                                                   jnp.asarray(c))
    Qt, ct = _leaf(Q), _leaf(c)
    sol = solve_qp_ipm(Qt, ct, torch.as_tensor(G), torch.as_tensor(h),
                       iterations=40, polish=False)
    torch.sum(sol.x * torch.as_tensor(w)).backward()
    _close(ct.grad, gc_j, 1e-9, "dc")
    _close(Qt.grad, gQ_j, 1e-9, "dQ")


def _implicit_grads_torch(Q, c, G, h, w, its=40):
    leaves = [_leaf(a) for a in (Q, c, G, h)]
    x = solve_qp_implicit(*leaves, its, True)
    torch.sum(x * torch.as_tensor(w)).backward()
    return x.detach(), [a.grad for a in leaves]


def test_implicit_gradient_matches_jax_custom_vjp(qps):
    Q, c, G, h = _first(qps)
    w = np.random.default_rng(1).normal(size=12)

    def jloss(*args):
        return jnp.sum(jimp(*args, 40, True) * w)

    g_j = jax.grad(jloss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (Q, c, G, h)))
    x, g_t = _implicit_grads_torch(Q, c, G, h, w)
    _close(x, jimp(*(jnp.asarray(a) for a in (Q, c, G, h)), 40, True), 1e-9,
           "x*")
    for name, gt, gj in zip("QcGh", g_t, g_j):
        _close(gt, gj, 1e-8, f"d{name}")
    # One unbatched instance, squared loss: the 30-iteration default.
    g1_j = jax.grad(lambda cc: jnp.sum(jimp(jnp.asarray(Q[2]), cc,
                                            jnp.asarray(G[2]),
                                            jnp.asarray(h[2])) ** 2))(
        jnp.asarray(c[2]))
    c1 = _leaf(c[2])
    torch.sum(solve_qp_implicit(torch.as_tensor(Q[2]), c1,
                                torch.as_tensor(G[2]),
                                torch.as_tensor(h[2])) ** 2).backward()
    _close(c1.grad, g1_j, 1e-8, "dc, one QP")


def test_implicit_matches_unrolled_autodiff(qps):
    """tests/test_diff_implicit.py:59, in the port alone."""
    Q, c, G, h = _first(qps)
    w = np.random.default_rng(3).normal(size=12)
    _, (gQ_i, gc_i, _, _) = _implicit_grads_torch(Q, c, G, h, w)
    Qt, ct = _leaf(Q), _leaf(c)
    sol = solve_qp_ipm(Qt, ct, torch.as_tensor(G), torch.as_tensor(h),
                       iterations=40, polish=False)
    torch.sum(sol.x * torch.as_tensor(w)).backward()
    np.testing.assert_allclose(t2n(gc_i), t2n(ct.grad), rtol=2e-3,
                               atol=1e-6)
    gQ_u = t2n(Qt.grad)
    np.testing.assert_allclose(t2n(gQ_i),
                               0.5 * (gQ_u + np.swapaxes(gQ_u, -1, -2)),
                               rtol=5e-3, atol=2e-2)


def test_implicit_gradient_broadcast_inputs(qps):
    """An unbatched G and h shared by the batch get their gradient summed
    over it (the shape torch asks of a backward)."""
    Q, c, G, h = qps
    Gt, ht = _leaf(G[0]), _leaf(h[0])
    x = solve_qp_implicit(torch.as_tensor(Q), torch.as_tensor(c), Gt, ht)
    torch.sum(x ** 2).backward()
    g_j = jax.grad(lambda G_, h_: jnp.sum(jimp(
        jnp.asarray(Q), jnp.asarray(c), jnp.broadcast_to(G_, G.shape),
        jnp.broadcast_to(h_, h.shape)) ** 2), argnums=(0, 1))(
        jnp.asarray(G[0]), jnp.asarray(h[0]))
    assert Gt.grad.shape == (24, 12) and ht.grad.shape == (24,)
    _close(Gt.grad, g_j[0], 1e-8, "dG shared")
    _close(ht.grad, g_j[1], 1e-8, "dh shared")


@pytest.mark.parametrize("polish", [False, True])
def test_admm_forward_matches_jax(qps, polish):
    Q, c, G, h = qps
    want = jadmm(*(jnp.asarray(a) for a in (Q, c, G, h)), polish=polish)
    got = solve_qp_admm(*(torch.as_tensor(a) for a in (Q, c, G, h)),
                        polish=polish)
    for k in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
        _close(getattr(got, k), getattr(want, k), 1e-9, k)
    np.testing.assert_array_equal(t2n(got.converged),
                                  np.asarray(want.converged))
    assert int(got.iterations) == int(want.iterations) == 120
