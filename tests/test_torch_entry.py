"""PyTorch port: the entry points (quadruped_control_tpu_torch/
entry.py) against the JAX package's (__graft_entry__.py).

The forward step runs on the 256 scenarios the JAX entry draws from its
key, handed to the port as NumPy arrays; the dry run drives the four sharded
loops on a mesh of eight CPU entries.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as jax_entry
from quadruped_control_tpu.config import mit_cheetah_config as jax_config
from quadruped_control_tpu.utils.scenarios import grf_scenarios as jax_grf
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.entry import (
    ENTRY_BATCH,
    dryrun_multichip,
    entry,
)

CPU8 = [torch.device("cpu")] * 8


def _port_batch(s_j, dtype):
    return convert.scenarios_from_numpy(
        {k: np.asarray(v) for k, v in s_j._asdict().items()
         if v is not None}, dtype=dtype, device="cpu")


def _objective(qp, x):
    Q, c = np.asarray(qp.Q, np.float64), np.asarray(qp.c, np.float64)
    x = np.asarray(x, np.float64)
    return (0.5 * np.einsum("bi,bij,bj->b", x, Q, x)
            + np.einsum("bi,bi->b", c, x))


def test_forward_matches_jax_entry():
    """entry(device="cpu")'s forward on the JAX entry's own 256 float32
    scenarios: the converged flags equal to the JAX forward's, and on the
    certified instances the float64 objective of x within a relative 1e-6
    (median) and 1e-5 (max) of the JAX x's. x itself is not held in float32:
    the four-stance balance QP has flat internal-force directions, along
    which float32 rounding moves a solution by up to ~1 N at an unchanged
    objective (two JAX evaluations of this forward, jitted whole and jitted
    in two parts, differ by 0.97 N); the same forward in float64 is held on
    x to 1e-8."""
    from quadruped_control_tpu.solver.ipm import solve_qp_ipm as jax_ipm
    from quadruped_control_tpu.utils.scenarios import (
        assemble_qp_batch as jax_assemble,
    )

    fwd_j, (key,) = jax_entry.entry()
    xj, cj = jax.jit(fwd_j)(key)
    s_j = jax.jit(lambda k: jax_grf(k, ENTRY_BATCH, jax_config(),
                                    dtype=jnp.float32))(key)
    forward, example = entry(device="cpu")
    x, conv = forward(_port_batch(s_j, torch.float32))
    assert x.dtype == torch.float32 and x.shape == (ENTRY_BATCH, 12)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(cj))
    qp = jax_assemble(s_j, jax_config())
    cert = np.asarray(cj)
    oj, op = _objective(qp, xj), _objective(qp, x.numpy())
    rel = (np.abs(op - oj) / (1.0 + np.abs(oj)))[cert]
    assert cert.mean() > 0.9
    assert np.median(rel) < 1e-6 and rel.max() < 1e-5, rel.max()

    s64 = jax.tree.map(lambda a: a.astype(jnp.float64)
                       if a.dtype == jnp.float32 else a, s_j)
    qp64 = jax_assemble(s64, jax_config())
    sj64 = jax_ipm(qp64.Q, qp64.c, qp64.G, qp64.h, iterations=12,
                   polish=True, tol=3e-5)
    x64, conv64 = forward(_port_batch(s64, torch.float64))
    np.testing.assert_allclose(x64.numpy(), np.asarray(sj64.x), rtol=0,
                               atol=1e-8)
    np.testing.assert_array_equal(conv64.numpy(), np.asarray(sj64.converged))

    x2, conv2 = forward(*example)  # the port's own draw
    assert x2.shape == (ENTRY_BATCH, 12) and bool(torch.isfinite(x2).all())
    assert conv2.float().mean().item() > 0.8


def test_entry_points_default_to_the_card():
    """Without a card the default device raises; nothing runs on the CPU
    unless asked."""
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun_multichip(1)


def test_dryrun_multichip_on_eight_cpu_entries(capsys):
    """dryrun_multichip(8) over [cpu] * 8 prints its four ok lines: the SRB
    step, the whole-body rollout, the fused balance tick and the warm
    decimated MPC tick."""
    dryrun_multichip(8, devices=CPU8)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("dryrun_multichip(8): ")]
    assert len(lines) == 4, lines
    for ln, what in zip(lines, ("ok — SRB step", "whole-body ok",
                                "fused ok", "mpc ok")):
        assert what in ln, ln


def test_dryrun_multichip_needs_enough_entries():
    with pytest.raises(ValueError, match="need 4 devices"):
        dryrun_multichip(4, devices=CPU8[:2])
