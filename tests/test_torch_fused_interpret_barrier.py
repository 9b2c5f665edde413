"""PyTorch port: the plain version of the fused CUDA kernel against the JAX
package's Pallas kernel itself in interpret mode, barrier-only, few
iterations, B = 1024 — the one interpret-mode call of the fused kernel (see
test_torch_fused_interpret.py for why the polish is not run this way)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.solver import pallas_fused as jpf
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused as pf
from torch_port_helpers import (numpy_scenarios, objective_np, t2n,
                                torch_scenarios)

torch.set_num_threads(1)

B = 1024
BAL = mit_cheetah_config().balance
KW = dict(s_diag=tuple(BAL.s_diag), w_diag=float(BAL.w_diag))


@pytest.fixture(scope="module")
def raw():
    d = numpy_scenarios(51, B, randomize=True, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag)
    t = (rm, b, s.stance, s.mu, BAL.fz_min, BAL.fz_max)
    # The very same float32 kernel inputs go to the JAX kernel.
    j = (jnp.asarray(t2n(rm)), jnp.asarray(t2n(b)), jnp.asarray(d["stance"]),
         jnp.asarray(d["mu"]), BAL.fz_min, BAL.fz_max)
    return t, j


def test_plain_barrier_matches_pallas_kernel(raw):
    t, j = raw
    got = pf.solve_grf_qp_fused(*t, iterations=6, polish=False, **KW)
    ref = jpf.solve_grf_qp_fused(*j, iterations=6, polish=False,
                                 interpret=True, **KW)
    x, xr = t2n(got.x), np.asarray(ref.x)
    assert np.all(np.isfinite(x))
    # Six barrier iterations of the same statements, stopped MID-TRAJECTORY
    # (almost no lane has converged yet, so nothing pulls the two runs to a
    # common fixed point). XLA's CPU backend contracts a*b+c into FMAs and
    # lax.rsqrt differs from 1/sqrt in the last bit; through six Cholesky
    # factorizations of a kappa ~ 1e6 system that grows to ~1e-5 of the
    # ~100 N force scale. Measured at these settings: |dx| median 1.5e-3 /
    # p95 3.5e-2 N, objective gap median 4e-6 / p95 6e-5, diagnostics median
    # 6e-6 relative; the bounds below leave a factor ~3-5.
    err = np.abs(x - xr).max(axis=-1)
    assert np.median(err) < 5e-3, np.median(err)
    assert np.percentile(err, 95) < 0.15, np.percentile(err, 95)
    Q, c, _, _ = pf.assemble_qp_fused_debug(*t, **KW)
    of = objective_np(t2n(Q), t2n(c), x)
    orf = objective_np(t2n(Q), t2n(c), xr)
    rel = np.abs(of - orf) / (1.0 + np.abs(orf))
    assert np.median(rel) < 2e-5 and np.percentile(rel, 95) < 3e-4
    agree = np.mean(t2n(got.converged) == np.asarray(ref.converged))
    assert agree > 0.98, agree
    for f in ("gap", "primal_residual", "dual_residual"):
        a, b = t2n(getattr(got, f)), np.asarray(getattr(ref, f))
        assert np.median(np.abs(a - b) / (1e-6 + np.abs(b))) < 1e-4, f
