"""PyTorch port: the sizes of the compacted re-solve slices (two-phase tail,
``prox_tail`` stage, the tick's ``qp_tail``) follow the JAX package's
arithmetic (quadruped_control_tpu/solver/pallas_fused.py), computed from the
batch it pads to and capped at the real B.

The table's expected values were worked out by hand from the JAX lines:
two-phase tail ``Bp // tail_divisor`` with ``Bp`` padded to ``rows * 128 *
tail_divisor`` (:1580-1582, :1439); prox slice ``max(Bp // prox_divisor,
1)``, rounded up to 1024 once ``Bp >= 1024`` (:1632-1634), the kernel
backend re-rounded to ``min(rows, 8) * 128`` and capped at ``Bp``
(:1652-1655); the tick's tail ``max(Bp // tail_divisor, tail_rows * 128)``
rounded up to ``tail_rows * 128`` and capped at ``Bp`` (:1812-1815).
"""

import numpy as np
import pytest
import torch

from quadruped_control_tpu_torch.config import (
    mit_cheetah_config,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.sim import fused_tick as ft
from quadruped_control_tpu_torch.sim import model as tmodel
from quadruped_control_tpu_torch.solver import fused as pf
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import (
    carry_comps_np,
    numpy_scenarios,
    state_comps_np,
    torch_scenarios,
)

torch.set_num_threads(1)
BAL = mit_cheetah_config().balance

# (B, rows, tail_divisor) -> (JAX slice, the port's slice)
TWO_PHASE = [
    ((32768, 16, 8), 4096, 4096),
    ((2048, 8, 8), 1024, 1024),
    ((2, 8, 8), 1024, 2),
    ((10000, 8, 8), 2048, 2048),
    ((4096, 4, 4), 1024, 1024),
    ((1000, 16, 8), 2048, 1000),
]
# (B, rows, two_phase, tail_divisor, prox_divisor, backend) -> (JAX, port)
PROX = [
    ((32768, 16, True, 8, 64, "kernel"), 1024, 1024),
    ((32768, 16, True, 8, 64, "xla"), 1024, 1024),
    ((2048, 8, True, 8, 64, "kernel"), 1024, 1024),
    ((2048, 8, False, 8, 64, "xla"), 1024, 1024),
    ((100, 1, False, 8, 64, "xla"), 2, 2),
    ((100, 1, False, 8, 64, "kernel"), 128, 100),
    ((200000, 8, False, 8, 64, "xla"), 4096, 4096),
    ((200000, 16, False, 8, 64, "kernel"), 4096, 4096),
    ((5000, 2, False, 8, 16, "kernel"), 1024, 1024),
    ((256, 16, True, 8, 64, "kernel"), 1024, 256),
    ((1536, 4, False, 8, 1, "xla"), 2048, 1536),
]
# (B, rows, tail_rows, tail_divisor) -> (JAX, port)
QP_TAIL = [
    ((2, 8, 8, 4), 1024, 2),
    ((4096, 8, 8, 4), 1024, 1024),
    ((10000, 8, 8, 4), 3072, 3072),
    ((4096, 16, 8, 8), 1024, 1024),
    ((300, 2, 1, 4), 128, 128),
    ((24, 8, 1, 4), 256, 24),
]


@pytest.mark.parametrize("args,jax_size,port_size", TWO_PHASE)
def test_two_phase_tail_size_table(args, jax_size, port_size):
    B, rows, td = args
    Bp = pf.padded_batch(B, rows, td)
    assert Bp // td == jax_size
    assert pf.two_phase_tail_size(B, rows, td) == port_size == min(jax_size, B)


@pytest.mark.parametrize("args,jax_size,port_size", PROX)
def test_prox_slice_size_table(args, jax_size, port_size):
    assert pf.prox_slice_size(*args) == jax_size
    assert min(jax_size, args[0]) == port_size


@pytest.mark.parametrize("args,jax_size,port_size", QP_TAIL)
def test_qp_tail_size_table(args, jax_size, port_size):
    B, rows, tail_rows, td = args
    assert pf.qp_tail_size(B, rows, tail_rows, td) == port_size
    assert min(jax_size, B) == port_size


def test_default_rows_is_the_jax_default():
    """``rows=None`` is the JAX default tile height, 8."""
    assert pf.prox_slice_size(2048, None, True) == pf.prox_slice_size(
        2048, 8, True)
    assert pf.qp_tail_size(2, None, None) == pf.qp_tail_size(2, 8, 8) == 2
    assert pf.two_phase_tail_size(2048) == pf.two_phase_tail_size(2048, 8, 8)


def test_prox_stage_resolves_the_jax_slice(monkeypatch):
    """B = 2048 with a cheap schedule (6 iterations, tail 6 / 2 sweeps), so
    that far more instances are uncertified after phase 2 than B // 64:
    the two-phase tail and the prox stage re-solve the JAX package's 1024
    instances each, and the converged set after the prox stage is exactly
    the pre-prox set with that slice's re-solve merged in. The earlier
    rule (B // 64 = 32 instances) could certify at most 32."""
    B = 2048
    d = numpy_scenarios(7, B, randomize=True, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    merges = []
    orig = pf._merge_solution

    def spy(sol, idx, sol2):
        merges.append((sol, idx))
        return orig(sol, idx, sol2)

    prox = dict(prox_steps=2, prox_iterations=6, prox_sweeps=2)
    monkeypatch.setattr(pf, "_merge_solution", spy)
    out = pf.solve_balance_qp_fused(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag, mu=s.mu,
        iterations=6, polish_sweeps=2, two_phase=True, tail_iterations=6,
        tail_sweeps=2, prox_tail=True, **prox)
    assert len(merges) == 2
    (_, idx_tail), (pre, idx) = merges
    assert (idx_tail.numel(), idx.numel()) == (1024, 1024)
    assert pf.two_phase_tail_size(B, None, 8) == 1024
    assert pf.prox_slice_size(B, None, True, 8, 64) == 1024
    uncert = int((~pre.converged).sum())
    assert uncert > B // 64, uncert

    # Re-solve that slice by hand and merge.
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag)
    want_idx = pf._worst_first(pre.converged, 1024)
    assert torch.equal(idx, want_idx)
    psol = pf.solve_grf_qp_fused(
        rm[idx], b[idx], s.stance[idx], s.mu[idx], BAL.fz_min, BAL.fz_max,
        s_diag=tuple(BAL.s_diag), w_diag=float(BAL.w_diag), iterations=0,
        polish=True, polish_sweeps=2, warm=(pre.x[idx], pre.s[idx],
                                            pre.z[idx]), **prox)
    want = pre.converged.clone()
    want[idx] = want[idx] | psol.converged
    assert torch.equal(out.converged, want)
    newly = int((out.converged & ~pre.converged).sum())
    assert newly > B // 64, newly
    assert out.converged.float().mean() == want.float().mean()


def test_tick_tail_takes_every_lane_at_b2(monkeypatch):
    """The tick's qp_tail at B = 2: the JAX package pads to 1024 and
    re-solves every instance; so does the port (both lanes reach the
    tail's launch)."""
    cfg = mit_cheetah_physical_config()
    model = tmodel.mit_cheetah_whole_body_model(cfg, dtype=torch.float32,
                                                device="cpu")
    B = 2
    d = whole_body_walk_states(31, B, cfg, on_ground=True)
    state = torch.as_tensor(state_comps_np(d), dtype=torch.float32)
    carry = torch.as_tensor(carry_comps_np(commander_carry_walk(32, B, cfg)),
                            dtype=torch.float32)
    cmd = torch.as_tensor(d["cmd"].T.copy(), dtype=torch.float32)
    tick = ft.make_fused_tick(model, cfg, qp_tail=True, qp_polish=False,
                              qp_iterations=6, qp_tail_sweeps=2,
                              qp_tail_prox_steps=1, gravity_comp=True)
    seen = []
    orig = pf.solve_grf_qp_fused_packed

    def spy(rp, *a, **kw):
        seen.append(rp.shape[1])
        return orig(rp, *a, **kw)

    monkeypatch.setattr(pf, "solve_grf_qp_fused_packed", spy)
    tick(state, carry, ft.init_qp_warm_packed(B, device="cpu"), cmd,
         1.0 / cfg.frequency, 2)
    assert seen == [2]
