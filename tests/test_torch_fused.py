"""PyTorch port: solver/fused.py — the module that holds the two CUDA
kernels — on the CPU, through the kernels' plain PyTorch versions, float32.

Held against the JAX package's plain functions (assemble_qp_batch,
equilibrate, solve_qp_ipm) on the same NumPy-made inputs and against the
port's float64 oracle. The kernels themselves are compared with these plain
versions on the card by chip_smoke.py; the JAX Pallas kernel in interpret
mode is compared in test_torch_fused_interpret.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.solver import ipm as jipm
from quadruped_control_tpu.utils.scenarios import assemble_qp_batch as jax_assemble
from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused as pf
from quadruped_control_tpu_torch.solver.reference import solve_qp_batch_oracle
from torch_port_helpers import (jax_scenarios, numpy_scenarios, objective_np,
                                t2n, torch_scenarios)

torch.set_num_threads(1)

B = 192
CFG = mit_cheetah_config()
BAL = CFG.balance
KW = dict(s_diag=tuple(BAL.s_diag), w_diag=float(BAL.w_diag))


def kernel_inputs(s):
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag)
    mu = BAL.mu if s.mu is None else s.mu
    return rm, b, s.stance, mu, BAL.fz_min, BAL.fz_max


@pytest.fixture(scope="module", params=[False, True],
                ids=["preset", "randomized"])
def case(request):
    d = numpy_scenarios(31, B, randomize=request.param, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    jqp = jax_assemble(jax_scenarios(d))
    Q, c, G, h = (np.asarray(a, np.float64) for a in jqp)
    oracle = solve_qp_batch_oracle(Q, c, G, h, d["stance"])
    return d, s, kernel_inputs(s), jqp, oracle


def rel_to_oracle(case, x):
    _, _, _, jqp, (_, obj_star, _) = case
    obj = objective_np(jqp.Q, jqp.c, t2n(x))
    return np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))


def test_plain_assembly_matches_jax(case):
    _, _, raw, jqp, _ = case
    Q, c, G, h = pf.assemble_qp_fused_debug(*raw, **KW)
    # Tolerances of the JAX package's own kernel-vs-XLA test: same math,
    # different factorization of the einsums, float32.
    np.testing.assert_allclose(t2n(Q), np.asarray(jqp.Q), rtol=2e-5, atol=1e-4)
    np.testing.assert_allclose(t2n(c), np.asarray(jqp.c), rtol=2e-5, atol=2e-2)
    np.testing.assert_allclose(t2n(G), np.asarray(jqp.G), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(t2n(h), np.asarray(jqp.h), rtol=1e-6, atol=1e-6)


def test_plain_equilibration_matches_jax(case):
    _, _, raw, jqp, _ = case
    Qk, ck, Gk, hk = pf.assemble_qp_fused_debug(*raw, equilibrated=True, **KW)
    Qs, cs, Gs, hs, _, _, _ = jipm.equilibrate(jqp.Q, jqp.c, jqp.G, jqp.h)
    for a, b in ((Qk, Qs), (ck, cs), (Gk, Gs), (hk, hs)):
        np.testing.assert_allclose(t2n(a), np.asarray(b), rtol=3e-5, atol=3e-5)


def test_plain_barrier_matches_jax_ipm(case):
    _, _, raw, jqp, _ = case
    sol = pf.solve_grf_qp_fused(*raw, iterations=18, polish=False, **KW)
    f32 = jnp.float32
    ref = jipm.solve_qp_ipm(jqp.Q.astype(f32), jqp.c.astype(f32),
                            jqp.G.astype(f32), jqp.h.astype(f32),
                            iterations=18, polish=False)
    obj_f = objective_np(jqp.Q, jqp.c, t2n(sol.x))
    obj_r = objective_np(jqp.Q, jqp.c, np.asarray(ref.x))
    rel = np.abs(obj_f - obj_r) / (1.0 + np.abs(obj_r))
    # Same algorithm, different summation order (criteria of the JAX
    # package's kernel-vs-jnp barrier test).
    assert np.median(rel) < 1e-6
    assert np.percentile(rel, 95) < 1e-4
    viol = np.einsum("bij,bj->bi", np.asarray(jqp.G, np.float64),
                     t2n(sol.x).astype(np.float64)) - np.asarray(jqp.h)
    assert np.percentile(viol.max(axis=-1), 95) < 1e-3


def _check_certified(case, x, diag):
    cert = t2n(diag[0]) > 0.5
    conv = t2n(diag[1]) > 0.5
    assert not np.any(cert & ~conv)             # cert => conv
    rel = rel_to_oracle(case, x.t())
    # The oracle's 1e-6 objective bar on the certified instances: median and
    # 95th percentile; a single ill-conditioned float32 instance may sit a
    # few 1e-6 above it (see CHANGES.md), so the maximum is held to 1e-4.
    assert np.median(rel[cert]) < 1e-7
    assert np.percentile(rel[cert], 95) < 1e-6
    assert rel[cert].max() < 1e-4
    return cert, conv


def test_plain_full_mode_meets_oracle(case):
    _, _, raw, _, _ = case
    inp = pf._prep_inputs(*raw)
    x, s, z, diag = pf.solve_grf_qp_fused_packed(*inp, iterations=20, **KW)
    cert, conv = _check_certified(case, x, diag)
    assert cert.mean() > 0.97
    assert bool(torch.isfinite(x).all())


def test_plain_polish_only_and_split(case):
    _, _, raw, _, _ = case
    bar = pf.solve_grf_qp_fused(*raw, iterations=20, polish=False, **KW)
    inp = pf._prep_inputs(*raw)
    warm = tuple(pf._soa(a, k, B) for a, k in ((bar.x, 12), (bar.s, 24), (bar.z, 24)))
    x, s, z, diag = pf.solve_grf_qp_fused_packed(
        *inp, *warm, iterations=0, polish_sweeps=4, **KW)
    cert, _ = _check_certified(case, x, diag)
    assert cert.mean() > 0.9
    # The split entry is exactly barrier-only + polish-only.
    sp = pf.solve_grf_qp_fused_split(*raw, iterations=20, polish_sweeps=4, **KW)
    assert torch.equal(sp.x, x.t())
    # ... and the fused full mode does the same arithmetic in one call.
    full = pf.solve_grf_qp_fused(*raw, iterations=20, polish_sweeps=4, **KW)
    assert torch.equal(sp.x, full.x) and torch.equal(sp.converged, full.converged)


def test_plain_zero_warm_is_bitwise_cold(case):
    _, _, raw, _, _ = case
    cold = pf.solve_grf_qp_fused(*raw, iterations=12, polish=False, **KW)
    warm0 = (torch.zeros(B, 12), torch.zeros(B, 24), torch.zeros(B, 24))
    coldish = pf.solve_grf_qp_fused(*raw, iterations=12, polish=False,
                                    warm=warm0,
                                    warm_stance_prev=-torch.ones(B, 4), **KW)
    for f in ("x", "z", "s", "converged", "gap"):
        assert torch.equal(getattr(cold, f), getattr(coldish, f)), f
    # With the polish too (the -1 rows fall back to the barrier heuristic).
    coldp = pf.solve_grf_qp_fused(*raw, iterations=12, polish_sweeps=2, **KW)
    coldishp = pf.solve_grf_qp_fused(*raw, iterations=12, polish_sweeps=2,
                                     warm=warm0,
                                     warm_stance_prev=-torch.ones(B, 4), **KW)
    assert torch.equal(coldp.x, coldishp.x)


def test_plain_warm_barrier(case):
    d, _, raw, jqp, _ = case
    cold = pf.solve_grf_qp_fused(*raw, iterations=12, polish=False, **KW)
    warm4 = pf.solve_grf_qp_fused(*raw, iterations=4, polish=False,
                                  warm=(cold.x, cold.s, cold.z), **KW)
    cold4 = pf.solve_grf_qp_fused(*raw, iterations=4, polish=False, **KW)
    assert float(warm4.converged.float().mean()) >= float(
        cold4.converged.float().mean())
    obj_seed = objective_np(jqp.Q, jqp.c, t2n(cold.x))
    obj_warm = objective_np(jqp.Q, jqp.c, t2n(warm4.x))
    # The warm restart may only refine (or hold) the seed's objective.
    assert np.percentile(obj_warm - obj_seed, 99) < 1e-4 * (
        1.0 + np.abs(obj_seed).max())
    # Stance flips: the rows of the flipped legs reset cold, the previous
    # active set seeds the polish; certified instances still meet the oracle.
    prev = torch.from_numpy(d["stance"]).float()
    prev[::2] = 1.0 - prev[::2]
    inp = pf._prep_inputs(*raw)
    warm = tuple(pf._soa(a, k, B) for a, k in (
        (cold.x, 12), (cold.s, 24), (cold.z, 24), (prev, 4)))
    x, s, z, diag = pf.solve_grf_qp_fused_packed(
        *inp, *warm, iterations=14, polish_sweeps=6, **KW)
    cert, _ = _check_certified(case, x, diag)
    assert cert.mean() > 0.8


def test_plain_prox_mode(case):
    """Prox never loses a certified instance and lifts a starved schedule."""
    _, _, raw, _, _ = case
    starved = dict(iterations=4, polish_sweeps=1, polish_refine=1)
    inp = pf._prep_inputs(*raw)
    xb, sb, zb, db = pf.solve_grf_qp_fused_packed(*inp, **starved, **KW)
    xp, sp, zp, dp = pf.solve_grf_qp_fused_packed(
        *inp, **starved, prox_steps=2, prox_iterations=20, **KW)
    c0, c1 = float(db[1].mean()), float(dp[1].mean())
    assert c1 > c0, (c0, c1)
    assert not bool(((db[1] > 0.5) & ~(dp[1] > 0.5)).any())
    # The strict certificate is the main polish's: prox acceptance is loose.
    assert torch.equal(db[0], dp[0])
    assert bool(torch.isfinite(xp).all())
    rel = rel_to_oracle(case, xp.t())
    acc = t2n(dp[1]) > 0.5
    # Loose-accepted points satisfy the ORIGINAL KKT to 3e-5 only: their
    # objectives are near the oracle's, not at the certified 1e-6 bar.
    assert np.median(rel[acc]) < 1e-5 and np.percentile(rel[acc], 95) < 1e-3
    # prox_cold runs too and is also monotone.
    xc, _, _, dc = pf.solve_grf_qp_fused_packed(
        *inp, **starved, prox_steps=1, prox_iterations=12, prox_cold=True, **KW)
    assert not bool(((db[1] > 0.5) & ~(dc[1] > 0.5)).any())


def test_plain_options_multi_swap_and_no_ff(case):
    _, _, raw, _, _ = case
    inp = pf._prep_inputs(*raw)
    x, _, _, diag = pf.solve_grf_qp_fused_packed(
        *inp, iterations=16, polish_sweeps=4, polish_multi_swap=True,
        ff_refine=False, **KW)
    _check_certified(case, x, diag)


@pytest.mark.parametrize("batch", [256, 200])
def test_slice_as_a_whole_matches_jax(batch):
    """solve_balance_qp_fused (two_phase, split, prox_tail) on the CPU vs JAX
    assemble_qp_batch + solve_qp_ipm; a non-aligned B is accepted."""
    d = numpy_scenarios(41, batch, randomize=False, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    sol = pf.solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, iterations=20, polish_sweeps=2, two_phase=True,
        split=True, tail_iterations=24, tail_sweeps=8, prox_tail=True,
        prox_steps=2, prox_iterations=16, prox_sweeps=4, rows=16)
    jqp = jax_assemble(jax_scenarios(d))
    f32 = jnp.float32
    ref = jipm.solve_qp_ipm(jqp.Q.astype(f32), jqp.c.astype(f32),
                            jqp.G.astype(f32), jqp.h.astype(f32),
                            iterations=20, tol=3e-5)
    assert sol.x.shape == (batch, 12) and sol.converged.shape == (batch,)
    for f in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
        assert bool(torch.isfinite(getattr(sol, f)).all()), f
    obj_f = objective_np(jqp.Q, jqp.c, t2n(sol.x))
    obj_r = objective_np(jqp.Q, jqp.c, np.asarray(ref.x))
    rel = np.abs(obj_f - obj_r) / (1.0 + np.abs(obj_r))
    assert np.median(rel) < 1e-6 and np.percentile(rel, 95) < 1e-4
    cf = float(sol.converged.float().mean())
    cr = float(np.mean(np.asarray(ref.converged)))
    assert abs(cf - cr) <= 0.01, (cf, cr)
    assert int(sol.iterations) == 44


def test_batch_shapes_and_scalar_params():
    d = numpy_scenarios(43, 24, randomize=True, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    flat = pf.solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag, mu=s.mu,
        iterations=12, polish_sweeps=2)

    def r(a):
        return a.reshape((4, 6) + a.shape[1:])

    nd = pf.solve_balance_qp_fused(
        r(s.R), r(s.R_d), r(s.x), r(s.xdot), r(s.w), r(s.x_d), r(s.xdot_d),
        r(s.w_d), r(s.feet), r(s.stance), BAL, mass=r(s.mass),
        inertia_diag=r(s.inertia_diag), mu=r(s.mu), iterations=12,
        polish_sweeps=2)
    assert nd.x.shape == (4, 6, 12) and nd.converged.shape == (4, 6)
    assert torch.equal(nd.x.reshape(24, 12), flat.x)


def test_two_phase_never_loses_and_tail_packed_keeps_strict_bit(case):
    _, _, raw, _, _ = case
    one = pf.solve_grf_qp_fused(*raw, iterations=8, polish_sweeps=1, **KW)
    two = pf.solve_grf_qp_fused_two_phase(
        *raw, iterations=8, polish_sweeps=1, tail_divisor=4,
        tail_iterations=16, tail_sweeps=6, **KW)
    assert not bool((one.converged & ~two.converged).any())
    assert float(two.converged.float().mean()) > float(one.converged.float().mean())
    # In-loop certification tail on the kernel layout.
    inp = pf._prep_inputs(*raw)
    x, s, z, diag = pf.solve_grf_qp_fused_packed(*inp, iterations=8,
                                                 polish=False, **KW)
    x2, s2, z2, d2 = pf.solve_grf_qp_tail_packed(
        *inp, x, s, z, diag, tail_divisor=2, tail_sweeps=4,
        tail_prox_steps=1, tail_prox_iterations=8, tail_rows=8, **KW)
    assert float(d2[1].mean()) > float(diag[1].mean())
    assert not bool(((diag[1] > 0.5) & ~(d2[1] > 0.5)).any())
    # A lane merged on the loose flag alone carries no strict-cert bit, and
    # every strict bit belongs to a converged lane.
    assert not bool(((d2[0] > 0.5) & ~(d2[1] > 0.5)).any())
    changed = (x2 != x).any(0)
    assert bool(((diag[1] < 0.5) | ~changed).all())  # only unconverged lanes move


def test_wrapper_contract_errors():
    d = numpy_scenarios(47, 8, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    raw = kernel_inputs(s)
    inp = pf._prep_inputs(*raw)
    z12, z24 = torch.zeros(12, 8), torch.zeros(24, 8)
    with pytest.raises(ValueError, match="polish-only"):
        pf.solve_grf_qp_fused_packed(*inp, z12, z24, z24, iterations=5, **KW)
    with pytest.raises(ValueError, match="iterations > 0"):
        pf.solve_grf_qp_fused_packed(*inp, z12, z24, z24, torch.zeros(4, 8),
                                     iterations=0, **KW)
    with pytest.raises(ValueError, match="warm start"):
        pf.solve_grf_qp_fused_packed(*inp, iterations=0, **KW)
    with pytest.raises(ValueError, match="shape"):
        pf.solve_grf_qp_fused_packed(inp[0].t().contiguous(), *inp[1:], **KW)
    with pytest.raises(TypeError, match="float32"):
        pf.solve_grf_qp_fused_packed(inp[0].double(), *inp[1:], **KW)
    with pytest.raises(ValueError, match="requires polish"):
        pf.solve_grf_qp_fused_packed(*inp, polish=False, prox_steps=1, **KW)
    with pytest.raises(ValueError, match="prox_backend"):
        pf.solve_balance_qp_fused(
            s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
            s.stance, BAL, prox_tail=True, prox_backend="dense")
    # The kernel launchers take CUDA tensors only: a CPU tensor never reaches
    # a kernel, and the launchers do not fall back.
    sched = pf.FusedSchedule(**KW)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.fused_solve(*inp, (), sched)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.assemble(*inp, swing_relax=1e4, equilibrated=False, **KW)
    assert set(kernels.launch_counts) >= {"qct_fused_solve", "qct_assemble"}
    assert not any(kernels.launch_counts.values())


def test_scenario_generator_distributions():
    """The port's own generator (explicit torch.Generator) draws from the
    reference's distributions and is reproducible from its seed."""
    from quadruped_control_tpu_torch.utils.scenarios import (
        assemble_qp_batch, grf_scenarios, standing_feet)

    g = torch.Generator(device="cpu")
    g.manual_seed(5)
    s = grf_scenarios(g, 4096, CFG, device="cpu", randomize_params=True)
    g.manual_seed(5)
    s2 = grf_scenarios(g, 4096, CFG, device="cpu", randomize_params=True)
    assert torch.equal(s.feet, s2.feet) and torch.equal(s.stance, s2.stance)
    assert s.stance.dtype == torch.bool
    assert 0.08 <= float(s.x[:, 2].min()) and float(s.x[:, 2].max()) <= 0.32
    assert abs(float(s.xdot.std()) - 0.3) < 0.02
    assert abs(float(s.w.std()) - 0.25) < 0.02
    assert 0.5 <= float(s.mu.min()) and float(s.mu.max()) <= 1.0
    assert 0.8 * 11 <= float(s.mass.min()) and float(s.mass.max()) <= 1.2 * 11
    pats = {tuple(r) for r in s.stance.tolist()}
    assert pats == {(True,) * 4, (True, False, False, True),
                    (False, True, True, False)}
    feet = standing_feet(CFG, device="cpu")
    np.testing.assert_allclose(np.abs(t2n(feet)[:, 0]), 0.196, atol=5e-3)
    qp = assemble_qp_batch(s, CFG)
    assert qp.Q.shape == (4096, 12, 12) and qp.G.shape == (4096, 24, 12)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            grf_scenarios(g, 4, CFG)      # default device is the card
