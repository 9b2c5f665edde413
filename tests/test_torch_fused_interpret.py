"""PyTorch port: the plain versions of the two CUDA kernels against the JAX
package's Pallas kernels themselves, run the way the JAX package's own tests
run them on the CPU (interpret mode), at B = 1024 (the TPU tile).

Interpret mode is slow, so there are exactly three such calls: the assembly
kernel with and without equilibration (here), and the fused kernel
barrier-only with few iterations (test_torch_fused_interpret_barrier.py).
The polish and prox stages are NOT run in
interpret mode (minutes per call; the JAX package's own tests avoid it):
they are held against solve_qp_ipm / the float64 oracle in
test_torch_fused.py instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.solver import pallas_fused as jpf
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused as pf
from torch_port_helpers import numpy_scenarios, t2n, torch_scenarios

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


@pytest.mark.parametrize("equilibrated", [False, True])
def test_plain_assembly_matches_pallas_kernel(raw, equilibrated):
    t, j = raw
    got = pf.assemble_qp_fused_debug(*t, equilibrated=equilibrated, **KW)
    ref = jpf.assemble_qp_fused_debug(*j, equilibrated=equilibrated,
                                      interpret=True, **KW)
    for name, a, b in zip("QcGh", got, ref):
        b = np.asarray(b)
        # Same statements on the same float32 inputs; XLA's CPU backend
        # contracts a*b+c into FMAs (0.8% of the entries differ by one ulp)
        # and lax.rsqrt differs from 1/sqrt in the last bit, which the
        # equilibration spreads over its products: a few ulp of the scale.
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(t2n(a), b, rtol=2e-6, atol=2e-6 * scale,
                                   err_msg=name)
