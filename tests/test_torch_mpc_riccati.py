"""PyTorch port: mpc/fused_riccati.py — the plain version of the MPC kernel
(K6) and its three entries, on the CPU.

  - Against the JAX package, with the bars of tests/test_mpc_riccati.py (the
    JAX kernel there, the port's plain version here) on the same
    NumPy-made problems, B = 1024, N = 4, float32: converged mean > 0.97,
    swing forces exactly 0 (0 < 1e-2 there), objective relative to JAX
    ``solve_mpc_structured`` through the float64 condensed ``build_mpc_qp``
    median < 5e-5, max < 5e-4; cold, and warm after a shifted horizon with
    changed schedule bits.
  - The entries against each other: packed = unpacked bitwise, a ragged
    (3, 37) batch = the same lanes of the full batch, per-instance robot
    constants, the warm carry (zero with a -1 schedule = cold bitwise; final
    iterate, s and z > 0), N = 24 keeps the final iterate (no best-iterate
    tracking above N = 16), poisoned lanes (NaN, 1e6) stay in their lanes.

The JAX kernel itself runs in interpret mode only with QCT_HEAVY=1 (one call
compiles for over a minute on a CPU).
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import mit_cheetah_physical_config as jcfg_fn
from quadruped_control_tpu.mpc import structured as js
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.mpc import fused_riccati as fr
from quadruped_control_tpu_torch.sim.fused_tick import init_mpc_warm_packed
from torch_port_helpers import (
    mpc_args_jax,
    mpc_args_torch,
    mpc_objective_np,
    mpc_problem_np,
    t2n,
)

torch.set_num_threads(1)
JCFG, TCFG = jcfg_fn(), mit_cheetah_physical_config()
B, N, DT = 1024, 4, 0.03
BAL = TCFG.balance
ROBOT = dict(mass=BAL.mass, inertia_diag=BAL.inertia_diag, mu=BAL.mu,
             fz_min=BAL.fz_min, fz_max=BAL.fz_max)


def _problem(seed=0, batch=B, horizon=N, yaw_from_xi0=False):
    d = mpc_problem_np(seed, batch, horizon, DT, TCFG)
    if yaw_from_xi0:  # the packed entry linearizes at xi0[2]
        d["xi0"][:, 2] = d["yaw"]
    return d


def _block(d, horizon=N):
    Bn = d["xi0"].shape[0]
    flat = np.concatenate(
        [d["xi0"], (d["feet_world"] - d["x_com"][:, None]).reshape(Bn, 12),
         d["stance_schedule"].reshape(Bn, -1).astype(np.float64),
         d["xi_ref"].reshape(Bn, -1)], -1)
    return torch.as_tensor(flat.T.copy(), dtype=torch.float32)


def _hold_to_jax(d, F, conv, lanes=64):
    """The bars of tests/test_mpc_riccati.py (JAX solve_mpc_structured on a
    sample of ``lanes`` instances)."""
    st = d["stance_schedule"]
    assert conv.mean() > 0.97, conv.mean()
    F = np.asarray(F, np.float64).reshape(-1, N, 4, 3)
    assert np.isfinite(F).all()
    assert np.abs(F[~st]).max() == 0.0
    idx = np.arange(lanes) * (F.shape[0] // lanes)
    sub = {k: v[idx] for k, v in d.items()}
    Fj, _ = js.solve_mpc_structured(*mpc_args_jax(sub, jnp.float32), N, DT,
                                    JCFG, iterations=40)
    o = mpc_objective_np(d, F, N, DT, JCFG, idx)
    oj = mpc_objective_np(sub, np.asarray(Fj), N, DT, JCFG,
                          np.arange(lanes))
    rel = np.abs(o - oj) / (1.0 + np.abs(oj))
    assert np.median(rel) < 5e-5 and rel.max() < 5e-4, (np.median(rel),
                                                        rel.max())


def test_plain_kernel_meets_the_jax_bars():
    d = _problem()
    F, sol = fr.solve_mpc_fused(*mpc_args_torch(d, torch.float32), N, DT,
                                TCFG, iterations=30)
    assert F.shape == (B, N, 12) and F.dtype == torch.float32
    _hold_to_jax(d, t2n(F), t2n(sol.converged))


def test_warm_start_after_a_shift():
    """Solve, shift the horizon by one step (the receding-horizon use) with
    the trot schedule one step on, re-solve warm: the bars hold on the new
    problem at 20 iterations, and at 15 the warm start certifies more lanes
    than the cold one (0.61 against 0.03 when this was written); a stale
    carry (every schedule bit changed) is exactly the cold start."""
    Bw = 256
    d = _problem(1, batch=Bw, yaw_from_xi0=True)
    kw = dict(n_steps=N, dt=DT, state_weights=None, **ROBOT)
    F0, dg0, szf0 = fr.solve_mpc_qp_riccati_packed(
        _block(d), init_mpc_warm_packed(Bw, horizon=N, device="cpu"),
        iterations=30, **kw)
    cold0, dgc = fr.solve_mpc_qp_riccati_packed(_block(d), iterations=30, **kw)
    assert torch.equal(F0, cold0) and torch.equal(dg0, dgc)
    s0, z0 = szf0[:24 * N], szf0[24 * N:48 * N]
    assert bool((s0 > 0).all() and (z0 > 0).all())
    assert bool(torch.isfinite(szf0).all())

    # Shift: the next tick's problem is the same robot a step later with
    # the trot schedule one step on.
    d1 = _problem(1, batch=Bw, yaw_from_xi0=True)
    d1["stance_schedule"] = np.roll(d["stance_schedule"], -1, axis=1)
    sched_prev = torch.as_tensor(
        d["stance_schedule"].reshape(Bw, -1).T.astype(np.float32).copy())

    def shift(a, per_step):
        a = a.reshape(N, per_step, Bw)
        return torch.cat([a[1:], a[-1:]]).reshape(N * per_step, Bw)

    warm = (shift(szf0[48 * N:], 12),
            torch.cat([shift(s0, 24), shift(z0, 24)]), shift(sched_prev, 4))
    F1, dg1, szf1 = fr.solve_mpc_qp_riccati_packed(_block(d1), warm,
                                                   iterations=20, **kw)
    _hold_to_jax(d1, t2n(F1.t()), t2n(dg1[0]) > 0.5, lanes=32)
    _, dgw15, _ = fr.solve_mpc_qp_riccati_packed(_block(d1), warm,
                                                 iterations=15, **kw)
    _, dgc15 = fr.solve_mpc_qp_riccati_packed(_block(d1), iterations=15, **kw)
    assert dgw15[0].mean() > dgc15[0].mean() + 0.2
    # A stale carry (a -1 schedule: every bit changed) is the cold start.
    flipped = (warm[0], warm[1], -torch.ones_like(warm[2]))
    Fc, dgc1, _ = fr.solve_mpc_qp_riccati_packed(_block(d1), flipped,
                                                 iterations=20, **kw)
    Fcold, dgcold = fr.solve_mpc_qp_riccati_packed(_block(d1), iterations=20,
                                                   **kw)
    assert torch.equal(Fc, Fcold) and torch.equal(dgc1, dgcold)
    assert not torch.equal(F1, Fcold)
    assert bool((szf1[:48 * N] > 0).all())


def test_entries_agree():
    d = _problem(2, batch=128, yaw_from_xi0=True)
    kw = dict(n_steps=N, dt=DT, state_weights=None, iterations=20)
    Fp, dp = fr.solve_mpc_qp_riccati_packed(_block(d), **ROBOT, **kw)
    r = d["feet_world"] - d["x_com"][:, None]
    Fu, su = fr.solve_mpc_qp_riccati(
        torch.as_tensor(d["yaw"]), torch.as_tensor(r), BAL.mass,
        BAL.inertia_diag, BAL.mu, BAL.fz_min, BAL.fz_max,
        torch.as_tensor(d["xi0"]), torch.as_tensor(d["xi_ref"]),
        torch.as_tensor(d["stance_schedule"]), **kw)
    assert torch.equal(Fp.t().reshape(-1, N, 12), Fu)
    assert torch.equal(dp[0] > 0.5, su.converged)
    assert torch.equal(dp[1], su.primal_residual)

    # Ragged batch shape: the same lanes as in the full batch.
    nb = (3, 37)
    n = nb[0] * nb[1]
    args = [a[:n].reshape(nb + a.shape[1:])
            for a in mpc_args_torch(d, torch.float32)]
    Fr, sr = fr.solve_mpc_fused(*args, N, DT, TCFG, iterations=20)
    Ff, sf = fr.solve_mpc_fused(*mpc_args_torch(d, torch.float32), N, DT,
                                TCFG, iterations=20)
    assert Fr.shape == nb + (N, 12) and sr.converged.shape == nb
    np.testing.assert_allclose(t2n(Fr).reshape(n, N, 12), t2n(Ff)[:n],
                               atol=1e-5)

    # Per-instance robot constants reach the solve.
    dr = mpc_problem_np(3, 64, N, DT, TCFG, randomize=True)
    args = mpc_args_torch(dr, torch.float32)
    Fa, sa = fr.solve_mpc_fused(*args, N, DT, TCFG, iterations=30,
                                mass=torch.as_tensor(dr["mass"]),
                                inertia_diag=torch.as_tensor(
                                    dr["inertia_diag"]),
                                mu=torch.as_tensor(dr["mu"]))
    Fb, _ = fr.solve_mpc_fused(*args, N, DT, TCFG, iterations=30)
    assert not torch.allclose(Fa, Fb)
    o = mpc_objective_np(dr, t2n(Fa), N, DT, JCFG, np.arange(64))
    Fj, _ = js.solve_mpc_structured(
        *mpc_args_jax(dr, jnp.float32), N, DT, JCFG, iterations=40,
        mass=jnp.asarray(dr["mass"], jnp.float32),
        inertia_diag=jnp.asarray(dr["inertia_diag"], jnp.float32),
        mu=jnp.asarray(dr["mu"], jnp.float32))
    oj = mpc_objective_np(dr, np.asarray(Fj), N, DT, JCFG, np.arange(64))
    conv = t2n(sa.converged)
    assert conv.mean() > 0.9
    rel = (np.abs(o - oj) / (1.0 + np.abs(oj)))[conv]
    assert np.median(rel) < 5e-5 and rel.max() < 5e-4
    with pytest.raises(ValueError, match="one state-weight diagonal"):
        fr.solve_mpc_fused(*args, N, DT, TCFG,
                           state_weights=torch.ones(64, 13))
    with pytest.raises(ValueError, match="expected"):
        fr.solve_mpc_qp_riccati_packed(_block(d)[:-1], **ROBOT, **kw)


def test_long_horizon_keeps_the_final_iterate():
    """Above N = 16 the kernel tracks no best iterate (the TPU kernel's VMEM
    budget; kept so that the two agree): the control output IS the final
    iterate, which the warm output also carries."""
    Nl = 24
    d = _problem(4, batch=32, horizon=Nl, yaw_from_xi0=True)
    kw = dict(n_steps=Nl, dt=0.02, state_weights=None, iterations=25, **ROBOT)
    assert not fr.MpcSettings(n_steps=Nl, dt=0.02).track_best
    assert fr.MpcSettings(n_steps=16, dt=0.02).track_best
    F, dg, szf = fr.solve_mpc_qp_riccati_packed(
        _block(d, Nl), init_mpc_warm_packed(32, horizon=Nl, device="cpu"),
        **kw)
    assert torch.equal(F, szf[48 * Nl:])
    assert bool(torch.isfinite(F).all()) and dg[0].mean().item() > 0.5


def test_poisoned_lanes_stay_in_their_lanes():
    d = _problem(5, batch=64, yaw_from_xi0=True)
    blk = _block(d)
    bad = blk.clone()
    bad[0, 0] = float("nan")     # roll of lane 0
    bad[9, 1] = 1.0e6            # forward velocity of lane 1
    kw = dict(n_steps=N, dt=DT, state_weights=None, iterations=15, **ROBOT)
    F, dg = fr.solve_mpc_qp_riccati_packed(blk, **kw)
    Fb, dgb = fr.solve_mpc_qp_riccati_packed(bad, **kw)
    assert torch.equal(Fb[:, 2:], F[:, 2:]) and torch.equal(dgb[:, 2:],
                                                            dg[:, 2:])
    assert dgb[0, 0] == 0.0 and dgb[0, 1] == 0.0
    # The NaN lane never improves its merit: it answers its start point (zero
    # forces) with a NaN nu and dual residual, as the TPU kernel does.
    assert bool((Fb[:, 0] == 0).all())
    assert not bool(torch.isfinite(dgb[:5, 0]).all())


@pytest.mark.skipif(not os.environ.get("QCT_HEAVY"),
                    reason="the JAX kernel in interpret mode compiles for "
                           "over a minute; set QCT_HEAVY=1")
def test_plain_kernel_matches_the_jax_kernel_interpret():
    from quadruped_control_tpu.mpc.pallas_riccati import solve_mpc_fused

    d = _problem(0)
    Fj, sj = solve_mpc_fused(*mpc_args_jax(d, jnp.float32), N, DT, JCFG,
                             iterations=30, interpret=True)
    Ft, st = fr.solve_mpc_fused(*mpc_args_torch(d, torch.float32), N, DT,
                                TCFG, iterations=30)
    assert (t2n(st.converged) == np.asarray(sj.converged)).mean() > 0.95
    idx = np.arange(64) * 16
    o = mpc_objective_np(d, t2n(Ft), N, DT, JCFG, idx)
    oj = mpc_objective_np(d, np.asarray(Fj), N, DT, JCFG, idx)
    rel = np.abs(o - oj) / (1.0 + np.abs(oj))
    assert np.median(rel) < 1e-6 and rel.max() < 1e-4


def _gait_problems(seed, batch, horizon, solves, advance):
    """A chain of ``solves`` receding-horizon problems for a warm start: each
    lane trots on its own gait clock (period 0.3 s, diagonal pairs half a
    period apart), and every problem is the previous one ``advance`` seconds
    later, so some schedule bits change between solves and most do not."""
    rng = np.random.default_rng(seed)
    phase0 = rng.uniform(0.0, 1.0, batch)
    base = _problem(seed, batch=batch, horizon=horizon, yaw_from_xi0=True)
    offs = np.array([0.0, 0.5, 0.5, 0.0])
    out = []
    for k in range(solves):
        d = {key: v.copy() for key, v in base.items()}
        t = k * advance + np.arange(horizon) * DT
        ph = (phase0[:, None, None] + t[None, :, None] / 0.3
              + offs[None, None, :]) % 1.0
        d["stance_schedule"] = ph < 0.5
        d["xi0"][:, 3] += 0.2 * k * advance
        d["xi_ref"][..., 3] += 0.2 * k * advance
        out.append(d)
    return out


@pytest.mark.skipif(not os.environ.get("QCT_HEAVY"),
                    reason="the JAX kernel in interpret mode compiles for "
                           "over a minute; set QCT_HEAVY=1")
def test_plain_warm_chain_matches_the_jax_kernel_interpret():
    """The warm mode against the JAX kernel's packed warm entry (interpret
    mode), as the fused tick uses it: N = 8, 8 iterations, a first solve
    from the -1 schedule (the cold start), then four warm re-solves, each
    side threading its own carry ([s | z/nu | F] of the final iterate and
    the schedule it was solved against) while schedule bits change between
    solves. This holds the carry rules (s >= 1e-2, s z >= 1e-2, z rescaled
    by this solve's nu, changed rows reset cold, F warm only on unchanged
    stance) and the recycled final iterate to the JAX package's.

    Measured when this was written (float32 both; XLA on the CPU contracts
    and orders differently): converged flags agree on >= 0.997 of the
    lanes, objective gap median <= 2.6e-5 (the unfinished cold first solve;
    <= 1.1e-7 once warm), max <= 8e-4; carry relative difference median
    <= 4.9e-6, p99 <= 6.1e-3. An absolute z floor of 1e-2 in place of the
    s z floor gives a gap median of 0.51 on the first warm solve, a carry
    without the nu rescale 1.4e-2."""
    import jax
    from functools import partial

    from quadruped_control_tpu.mpc.pallas_riccati import (
        solve_mpc_qp_riccati_packed,
    )
    from quadruped_control_tpu.sim.pallas_tick import (
        init_mpc_warm_packed as jax_init_warm,
    )
    from quadruped_control_tpu_torch.convert import (
        comps_to_tiles,
        tiles_to_comps,
    )

    Nw, it, Bw = 8, 8, 1024
    nmc = 2 * 24 * Nw
    kw = dict(n_steps=Nw, dt=DT, state_weights=fr.DEFAULT_STATE_WEIGHTS,
              **ROBOT)
    problems = _gait_problems(7, Bw, Nw, 5, advance=0.01)
    # One compile for the chain (an eager call retraces the kernel).
    jax_packed = jax.jit(partial(solve_mpc_qp_riccati_packed,
                                 iterations=it, interpret=True, **kw))
    warm_t = init_mpc_warm_packed(Bw, horizon=Nw, device="cpu")
    warm_j = jax_init_warm(1, horizon=Nw, rows=8)
    idx = np.arange(64) * 16
    for k, d in enumerate(problems):
        blk = _block(d, Nw)
        Ft, dgt, szt = fr.solve_mpc_qp_riccati_packed(blk, warm_t,
                                                      iterations=it, **kw)
        blk_j = jnp.asarray(comps_to_tiles(blk.numpy()))
        Fj, dgj, szj = jax_packed(blk_j, warm_j)
        Fj, dgj, szj = (tiles_to_comps(a, device="cpu")
                         for a in (Fj, dgj, szj))
        if k > 0:  # schedule bits changed since the previous solve
            changed = (blk[25:25 + 4 * Nw] != warm_t[2]).float().mean()
            assert 0.05 < changed.item() < 0.5, changed
        agree = (dgt[0] == dgj[0]).float().mean().item()
        o = mpc_objective_np(d, t2n(Ft.t()), Nw, DT, JCFG, idx)
        oj = mpc_objective_np(d, t2n(Fj.t()), Nw, DT, JCFG, idx)
        gap = np.abs(o - oj) / (1.0 + np.abs(oj))
        # The carry itself ([s | z/nu | F] of the final iterate), relative.
        rel = ((szt - szj).abs() / (szj.abs() + 1e-3)).flatten()
        carry = (rel.median().item(), torch.quantile(rel, 0.99).item())
        print(f"solve {k}: conv port {dgt[0].mean():.4f} jax "
              f"{dgj[0].mean():.4f}, agreement {agree:.4f}; objective gap "
              f"median {np.median(gap):.2e} max {gap.max():.2e}; carry "
              f"relative difference median {carry[0]:.2e} p99 "
              f"{carry[1]:.2e}")
        assert agree >= 0.99
        assert np.median(gap) < 1e-4 and gap.max() < 5e-3
        assert carry[0] < 1e-4 and carry[1] < 5e-2
        assert bool((szt[:nmc] > 0).all())
        warm_t = (szt[nmc:], szt[:nmc], blk[25:25 + 4 * Nw].clone())
        warm_j = (jnp.asarray(comps_to_tiles(szj[nmc:].numpy())),
                  jnp.asarray(comps_to_tiles(szj[:nmc].numpy())),
                  jnp.asarray(comps_to_tiles(blk[25:25 + 4 * Nw].numpy())))
