"""PyTorch port: the dense QP solve (solver/fused_ipm.py), K3a — the dense
barrier, plain version — against the JAX package's ``pallas_ipm._kernel``,
and ``solve_qp_ipm_fused`` against the float64 oracle.

The JAX kernel runs on the CPU in two ways. Its body, called eagerly on
(8, 128) tiles with ``jax.disable_jit()`` (every jnp operation its own XLA
computation, so nothing is contracted into FMAs): the kernel's own
arithmetic without Pallas, ~5 s for 3 iterations and ~22 s for 20 at B =
1024. And the only way the package itself has, a ``pl.pallas_call(...,
interpret=True)`` built here as ``solve_qp_ipm_pallas`` builds it
(pallas_ipm.py:574-649): ~2 min per barrier call and ~10 min for the polish
on this CPU, so it runs only with ``QCT_HEAVY=1`` (both tests passed: 248 s
and 631 s).

Inputs: ``numpy_scenarios`` (NumPy, from a seed) through each package's
``assemble_qp_batch`` and ``equilibrate``, float32.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl

from quadruped_control_tpu.solver import pallas_ipm as jpi
from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused_ipm as fi
from quadruped_control_tpu_torch.solver.reference import solve_qp_batch_oracle
from quadruped_control_tpu_torch.utils.scenarios import assemble_qp_batch
from torch_port_helpers import (
    dense_objective,
    dense_problem,
    numpy_scenarios,
    objective_np,
    t2n,
    tiles_to_torch,
    torch_scenarios,
)

torch.set_num_threads(1)
CFG = mit_cheetah_config()
B = 1024
HEAVY = pytest.mark.skipif(
    os.environ.get("QCT_HEAVY") != "1",
    reason="JAX kernels in Pallas interpret mode: ~2 min per barrier call, "
           "~10 min for the polish; set QCT_HEAVY=1")


@pytest.fixture(scope="module")
def problem():
    """The same randomized GRF batch in both packages (JAX equilibrates)."""
    return dense_problem(3, B)


def jax_barrier_eager(tiles, iterations):
    x, s, z = [None] * 12, [None] * 24, [None] * 24
    with jax.disable_jit():
        jpi._kernel(*tiles, x, s, z, iterations=iterations, tau=0.995)
    return tiles_to_torch(x), tiles_to_torch(s), tiles_to_torch(z)


@pytest.fixture(scope="module")
def jax_barrier_3(problem):
    return jax_barrier_eager(problem["tiles"], 3)


def test_plain_barrier_is_the_jax_kernel_but_for_rsqrt(problem,
                                                       jax_barrier_3,
                                                       monkeypatch):
    """With the JAX kernel's ``lax.rsqrt`` in place of the port's ``1 /
    sqrt`` (the kernel's operation on the card), the plain barrier is
    bitwise the JAX kernel's arithmetic after 3 iterations: the same
    statements in the same order."""
    def jax_rsqrt(x):
        return torch.from_numpy(np.array(lax.rsqrt(jnp.asarray(t2n(x)))))

    monkeypatch.setattr(fi, "_rsqrt", jax_rsqrt)
    got = fi._dense_barrier_plain(*problem["soa"], iterations=3, tau=0.995)
    for g, w, name in zip(got, jax_barrier_3, "xsz"):
        assert torch.equal(g, w), name


def test_plain_barrier_matches_the_jax_kernel_3_iterations(problem,
                                                           jax_barrier_3):
    """Unmodified, after 3 iterations: elementwise within 2e-3 * (1 + |x|)
    (``lax.rsqrt`` and a correctly rounded ``1 / sqrt`` differ in the last
    bit on a share of the pivots; an early Mehrotra step amplifies it), and
    exactly equal on most lanes."""
    got = fi._dense_barrier_plain(*problem["soa"], iterations=3, tau=0.995)
    same = torch.ones(B, dtype=torch.bool)
    for g, w, name in zip(got, jax_barrier_3, "xsz"):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3, msg=name)
        same &= (g == w).all(0)
    assert float(same.float().mean()) > 0.9


def test_plain_barrier_matches_the_jax_kernel_20_iterations(problem):
    """After 20 iterations the rsqrt bit has moved most lanes' iterates:
    held by the original problem's objective at the returned point (median
    relative gap < 1e-6, p95 < 1e-4) and by the loose KKT flag of the
    equilibrated problem (agreement >= 0.97)."""
    jx, js, jz = jax_barrier_eager(problem["tiles"], 20)
    px, ps, pz = fi._dense_barrier_plain(*problem["soa"], iterations=20,
                                         tau=0.995)
    oj, op = dense_objective(problem, jx), dense_objective(problem, px)
    rel = np.abs(op - oj) / (1.0 + np.abs(oj))
    assert np.median(rel) < 1e-6 and np.percentile(rel, 95) < 1e-4, (
        np.median(rel), np.percentile(rel, 95))
    Qp, cp, Gp, hp = problem["soa"]

    def loose(x, s, z):
        Q, G = Qp.reshape(12, 12, B), Gp.reshape(24, 12, B)
        rd = torch.einsum("ijb,jb->ib", Q, x) + cp + torch.einsum(
            "rib,rb->ib", G, z)
        rp = torch.einsum("rjb,jb->rb", G, x) + s - hp
        gap = (s * z).sum(0).abs() / 24
        sc = 1 + cp.abs().amax(0)
        return ((rp.abs().amax(0) < 3e-5 * (1 + hp.abs().amax(0)))
                & (rd.abs().amax(0) < 3e-5 * sc) & (gap < 3e-5 * sc))

    agree = (loose(jx, js, jz) == loose(px, ps, pz)).float().mean()
    assert float(agree) >= 0.97, float(agree)


def _pallas_barrier(tiles_soa, iterations):
    """``pallas_ipm._kernel`` in a ``pallas_call(interpret=True)`` laid out
    as solve_qp_ipm_pallas lays it out (one 1024-instance grid step)."""
    Q, c, G, h = (jnp.asarray(t2n(a)).reshape(a.shape[0], 8, 128)[None]
                  for a in tiles_soa)
    spec = [pl.BlockSpec((1, k, 8, 128), lambda i: (i, 0, 0, 0))
            for k in (144, 12, 288, 24, 12, 24, 24)]

    def kernel(Q_ref, c_ref, G_ref, h_ref, x_ref, s_ref, z_ref):
        jpi._kernel(Q_ref[0], c_ref[0], G_ref[0], h_ref[0],
                    x_ref.at[0], s_ref.at[0], z_ref.at[0],
                    iterations=iterations, tau=0.995)

    out = pl.pallas_call(
        kernel, grid=(1,), in_specs=spec[:4], out_specs=spec[4:],
        out_shape=[jax.ShapeDtypeStruct((1, k, 8, 128), jnp.float32)
                   for k in (12, 24, 24)],
        interpret=True)(Q, c, G, h)
    return tuple(torch.from_numpy(np.asarray(o).reshape(o.shape[1], B))
                 for o in out)


def _pallas_polish(tiles_soa, x, s, z):
    """``pallas_ipm._polish_kernel`` in a ``pallas_call(interpret=True)``
    (pallas_ipm.py:613-649)."""
    from jax.experimental.pallas import tpu as pltpu

    args = [jnp.asarray(t2n(a)).reshape(a.shape[0], 8, 128)[None]
            for a in (*tiles_soa, x, s, z)]
    ks = (144, 12, 288, 24, 12, 24, 24)
    spec = [pl.BlockSpec((1, k, 8, 128), lambda i: (i, 0, 0, 0))
            for k in ks + (12, 24, 24, 1)]

    def kernel(Q_ref, c_ref, G_ref, h_ref, xi, si, zi, x_ref, s_ref, z_ref,
               cert_ref, Ksc, Dsc, usc):
        jpi._polish_kernel(Q_ref[0], c_ref[0], G_ref[0], h_ref[0], xi[0],
                           si[0], zi[0], x_ref.at[0], s_ref.at[0],
                           z_ref.at[0], cert_ref.at[0], Ksc, Dsc, usc)

    out = pl.pallas_call(
        kernel, grid=(1,), in_specs=spec[:7], out_specs=spec[7:],
        out_shape=[jax.ShapeDtypeStruct((1, k, 8, 128), jnp.float32)
                   for k in (12, 24, 24, 1)],
        scratch_shapes=[pltpu.VMEM((36 * 36, 8, 128), jnp.float32),
                        pltpu.VMEM((36, 8, 128), jnp.float32),
                        pltpu.VMEM((36, 8, 128), jnp.float32)],
        interpret=True)(*args)
    return tuple(torch.from_numpy(np.asarray(o).reshape(o.shape[1], B))
                 for o in out)


@HEAVY
def test_plain_barrier_matches_the_jax_kernel_interpret(problem,
                                                        jax_barrier_3):
    """The Pallas kernel in interpret mode: 3 iterations elementwise (2e-3
    as above; its FMA contraction moves a few more lanes), 20 iterations by
    the original objective (median < 1e-6, p95 < 1e-4)."""
    jx, js, jz = _pallas_barrier(problem["soa"], 3)
    px, ps, pz = fi._dense_barrier_plain(*problem["soa"], iterations=3,
                                         tau=0.995)
    for g, w, name in ((px, jx, "x"), (ps, js, "s"), (pz, jz, "z")):
        torch.testing.assert_close(g, w, rtol=2e-3, atol=2e-3, msg=name)
    jx = _pallas_barrier(problem["soa"], 20)[0]
    px = fi._dense_barrier_plain(*problem["soa"], iterations=20, tau=0.995)[0]
    oj, op = dense_objective(problem, jx), dense_objective(problem, px)
    rel = np.abs(op - oj) / (1.0 + np.abs(oj))
    assert np.median(rel) < 1e-6 and np.percentile(rel, 95) < 1e-4


@HEAVY
def test_plain_polish_matches_the_jax_polish_kernel_interpret(problem):
    """The polish from one barrier point (the plain barrier's, 20
    iterations) in the Pallas kernel in interpret mode and in the plain
    version: certificates agree on >= 0.99 of the lanes, objective gap on
    the lanes both certify median < 1e-7, max < 1e-5."""
    bar = fi._dense_barrier_plain(*problem["soa"], iterations=20, tau=0.995)
    jx, _, _, jc = _pallas_polish(problem["soa"], *bar)
    px, _, _, pc = fi._dense_polish_plain(*problem["soa"], *bar)
    jc = jc[0]
    assert float((jc == pc).float().mean()) >= 0.99
    both = t2n((jc > 0.5) & (pc > 0.5))
    oj, op = dense_objective(problem, jx), dense_objective(problem, px)
    rel = (np.abs(op - oj) / (1.0 + np.abs(oj)))[both]
    assert np.median(rel) < 1e-7 and rel.max() < 1e-5


def _oracle_gap(qp, stance, x):
    Q, c, G, h = (t2n(a).astype(np.float64) for a in qp)
    _, obj_star, _ = solve_qp_batch_oracle(Q, c, G, h, stance, 10.0, 120.0)
    obj = objective_np(Q, c, t2n(x))
    return np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))


@pytest.fixture(scope="module")
def grf_batch():
    Bn = B + 37   # a ragged batch: the JAX entry needs a multiple of 1024
    d = numpy_scenarios(5, Bn, randomize=False, dtype=np.float32)
    qp = assemble_qp_batch(torch_scenarios(d, torch.float32), CFG)
    return qp, d["stance"]


def test_solve_qp_ipm_fused_meets_the_oracle(grf_batch):
    """The split pipeline's dense solve (20 iterations, polish) at a ragged
    B = 1061 against the float64 active-set oracle, at the bars of the JAX
    package's tests/test_pallas.py:56,68-69: converged > 0.98, relative
    objective gap median < 1e-7, p95 < 1e-6. Instances are independent:
    the first 1024 lanes solved alone are bitwise the same."""
    qp, stance = grf_batch
    sol = fi.solve_qp_ipm_fused(qp.Q, qp.c, qp.G, qp.h, device="cpu")
    assert sol.x.shape == (B + 37, 12) and sol.converged.shape == (B + 37,)
    for f in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
        assert bool(torch.isfinite(getattr(sol, f)).all()), f
    assert float(sol.converged.float().mean()) > 0.98
    rel = _oracle_gap((qp.Q, qp.c, qp.G, qp.h), stance, sol.x)
    assert np.median(rel) < 1e-7 and np.percentile(rel, 95) < 1e-6, (
        np.median(rel), np.percentile(rel, 95))
    head = fi.solve_qp_ipm_fused(qp.Q[:B], qp.c[:B], qp.G[:B], qp.h[:B],
                                 device="cpu")
    assert torch.equal(head.x, sol.x[:B])
    assert torch.equal(head.converged, sol.converged[:B])


def test_a_poisoned_lane_leaves_the_others_unchanged(grf_batch):
    """NaN in one lane's Q: that lane is not converged; every other lane is
    bitwise what it is without the poison."""
    qp, _ = grf_batch
    n = 96
    Q, c, G, h = qp.Q[:n], qp.c[:n], qp.G[:n], qp.h[:n]
    clean = fi.solve_qp_ipm_fused(Q, c, G, h, device="cpu")
    Qn = Q.clone()
    Qn[7, 3, 5] = float("nan")
    Qn[40, 0, 0] = float("inf")
    bad = fi.solve_qp_ipm_fused(Qn, c, G, h, device="cpu")
    keep = [i for i in range(n) if i not in (7, 40)]
    assert torch.equal(bad.x[keep], clean.x[keep])
    assert torch.equal(bad.converged[keep], clean.converged[keep])
    assert not bool(bad.converged[7]) and not bool(bad.converged[40])


def test_batch_shapes_and_barrier_only(grf_batch):
    qp, _ = grf_batch
    Q, c, G, h = (a[:24] for a in (qp.Q, qp.c, qp.G, qp.h))
    flat = fi.solve_qp_ipm_fused(Q, c, G, h, polish=False, iterations=12,
                                 device="cpu")
    nd = fi.solve_qp_ipm_fused(Q.reshape(4, 6, 12, 12), c.reshape(4, 6, 12),
                               G.reshape(4, 6, 24, 12), h.reshape(4, 6, 24),
                               polish=False, iterations=12, device="cpu")
    assert nd.x.shape == (4, 6, 12) and nd.converged.shape == (4, 6)
    assert torch.equal(nd.x.reshape(24, 12), flat.x)
    assert int(nd.iterations) == 12


def test_wrapper_contract():
    """The kernel launchers take CUDA tensors only; the entry runs on the
    card unless the caller asks for the CPU."""
    Qp, cp = torch.zeros(144, 4), torch.zeros(12, 4)
    Gp, hp = torch.zeros(288, 4), torch.zeros(24, 4)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dense_barrier(Qp, cp, Gp, hp, iterations=3, tau=0.995)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.dense_polish(Qp, cp, Gp, hp, torch.zeros(12, 4),
                             torch.zeros(24, 4), torch.zeros(24, 4))
    with pytest.raises(TypeError, match="float32"):
        fi.dense_barrier(Qp.double(), cp, Gp, hp)
    with pytest.raises(ValueError, match="G"):
        fi.dense_barrier(Qp, cp, Gp[:100], hp)
    assert {"qct_dense_barrier", "qct_dense_polish"} <= set(
        kernels.launch_counts)
    assert kernels.launch_counts["qct_dense_barrier"] == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            fi.solve_qp_ipm_fused(torch.eye(12)[None], torch.zeros(1, 12),
                                  torch.zeros(1, 24, 12), torch.ones(1, 24))
