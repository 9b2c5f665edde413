"""PyTorch port: K3b, the dense certified polish (solver/fused_ipm.py,
plain version), against the JAX package's ``pallas_ipm._polish_kernel``.

The JAX kernel body runs eagerly on (8, 128) tiles with
``jax.disable_jit()`` (its ``lax.fori_loop`` steps in Python, its scratch
refs are Python lists, every jnp operation its own XLA computation: nothing
is contracted into FMAs), ~5 s a sweep at B = 1024 on this CPU. The same kernel in
a ``pallas_call(interpret=True)`` is
``tests/test_torch_dense_ipm.py::test_plain_polish_matches_the_jax_polish_kernel_interpret``
(``QCT_HEAVY=1``); the polish against the float64 oracle and on poisoned
lanes is in ``tests/test_torch_prox_xla.py``.
"""

import pytest
import torch

import jax

from quadruped_control_tpu.solver import pallas_ipm as jpi
from quadruped_control_tpu_torch.solver import fused_ipm as fi
from torch_port_helpers import dense_problem, tiles_to_torch

torch.set_num_threads(1)
B = 1024


SWEEPS = 4


@pytest.fixture(scope="module")
def polished():
    """One barrier point (the plain barrier's, 20 iterations) polished by
    the JAX kernel body and by the plain version, with ``SWEEPS`` sweeps:
    the JAX kernel reads its sweep count from the module constant
    ``_POLISH_SWEEPS_PALLAS`` when it runs, set here for the call (8 sweeps
    cost ~40 s eagerly; the interpret-mode test runs all 8)."""
    problem = dense_problem(11, B)
    bar = fi._dense_barrier_plain(*problem["soa"], iterations=20, tau=0.995)
    tiles = [list(jax.numpy.asarray(a.numpy()).reshape(-1, 8, 128))
             for a in bar]
    xo, so, zo, co = [None] * 12, [None] * 24, [None] * 24, [None]
    K, D, u = [None] * (36 * 36), [None] * 36, [None] * 36
    mp = pytest.MonkeyPatch()
    mp.setattr(jpi, "_POLISH_SWEEPS_PALLAS", SWEEPS)
    try:
        with jax.disable_jit():
            jpi._polish_kernel(*problem["tiles"], *tiles, xo, so, zo, co, K,
                               D, u)
    finally:
        mp.undo()
    jax_out = tuple(tiles_to_torch(v) for v in (xo, so, zo)) + (
        tiles_to_torch(co)[0],)
    plain = fi._dense_polish_plain(*problem["soa"], *bar, sweeps=SWEEPS)
    return jax_out, plain


@pytest.mark.parametrize("k,name", list(enumerate(("x", "s", "z", "cert"))))
def test_plain_polish_is_the_jax_polish_kernel(polished, k, name):
    """Bitwise: the same statements in the same order, the Dekker two_prod
    / two_sum exact on both sides (no FMA contraction), the same tie and
    NaN rules in the swap, the certificate latched on the same sweep."""
    jax_out, plain = polished
    assert torch.equal(plain[k], jax_out[k]), name
    assert float(plain[3].mean()) > 0.95
