"""PyTorch port: the SOURCES of the commander-pre (K4), substep (K5), MPC
(K6) and dense IPM (K3a, K3b) CUDA kernels, compiled for the host and held
against the plain PyTorch versions.

A CUDA kernel cannot run without a card, but the per-instance bodies of K4,
K5, K6, K3a and K3b (csrc/qct_commander.cuh, csrc/qct_substep.cuh,
csrc/qct_mpc.cuh, csrc/qct_dense_ipm.cuh) are plain C++ behind a macro: tests/torch_port_host_shim.cpp loops them over the batch, ``g++
-ffp-contract=off`` builds it, and the same ctypes parameter structs the CUDA
launchers fill are handed to it. Float32 on both sides. This is a rehearsal
of the kernels' arithmetic, not of the kernels: host ``sinf``/``atan2f`` and
torch's CPU ones differ in the last bits, so the tolerances are those of
float32 round-off carried through the chain (on the card too K4 is held to
its plain version within tolerances, and bitwise to its serial body,
chip_smoke.py). K6 is held as on the card: by the
objective of its horizon forces and by its convergence statistics (a near-tie
of the merit can flip the best-iterate pick on a lane). K3a and K3b follow
their plain versions statement for statement: bitwise, once the plain
version's reciprocal square root is correctly rounded as the kernel's ``1.0f
/ sqrtf`` is (``torch.sqrt`` on the CPU is not, in a few lanes in 1e3).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control import fused_commander as fc
from quadruped_control_tpu_torch.sim import (
    ContactConfig,
    mit_cheetah_urdf_model,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim import fused_substep as fsub
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    whole_body_walk_states,
)
from torch_port_helpers import carry_comps_np, mpc_problem_np, state_comps_np

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
CFG = mit_cheetah_physical_config()
DT = 1.0 / CFG.frequency
DISCRETE_CARRY = [0, 2, 3, 4, 5, 6, 91, 92, 93, 94]
CONTINUOUS_CARRY = [1] + list(range(7, 91))
POSE_ROWS = list(range(0, 12)) + list(range(30, 58))
VEL_ROWS = list(range(12, 30))

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="needs a host C++ compiler (g++)")


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    out = tmp_path_factory.mktemp("host_kernels") / "libqct_host.so"
    cmd = ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-fPIC",
           "-shared", "-x", "c++", f"-I{CSRC}",
           str(ROOT / "tests" / "torch_port_host_shim.cpp"), "-o", str(out)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_commander_pre.argtypes = [vp] * 13 + [
        ci, ctypes.POINTER(kernels.CommanderParams)]
    lib.host_commander_pre.restype = None
    lib.host_substep.argtypes = [vp] * 6 + [
        ci, ci, ctypes.c_float, ctypes.POINTER(kernels.SubstepParams)]
    lib.host_substep.restype = None
    lib.host_mpc_riccati.argtypes = [vp] * 10 + [
        ci, ctypes.POINTER(kernels.MpcParams)]
    lib.host_mpc_riccati.restype = None
    lib.host_dense_barrier.argtypes = [vp] * 7 + [ci, ci, ctypes.c_float]
    lib.host_dense_barrier.restype = None
    lib.host_dense_polish.argtypes = [vp] * 11 + [ci]
    lib.host_dense_polish.restype = None
    return lib


def f32(a):
    return torch.as_tensor(np.ascontiguousarray(a),
                           dtype=torch.float32).contiguous()


@pytest.mark.parametrize("gate,sym,nh", [(0.0, False, 0), (0.01, True, 8)],
                         ids=["reference", "gate+symmetric"])
def test_commander_source_matches_plain_version(host, gate, sym, nh):
    """Four chained ticks, B = 256. Continuous outputs, (rtol, atol): levers,
    joint targets and the carry (1e-5, 2e-5); the right-hand side (1e-5,
    2e-4: gains of 1e2..1e3 on pose errors); the swing torques (5e-3, 1e-2:
    the Jacobian inverse of a leg near full extension amplifies the last
    bits of its joint-velocity target). Discrete outputs exactly, but for at
    most 2 lanes per tick within an ulp of a threshold (none seen)."""
    B = 256
    consts = fc.CommanderConsts(CFG, DT)
    params = consts.params(gate, sym, nh, 0.03)
    carry = f32(carry_comps_np(commander_carry_walk(11, B, CFG)))
    crossed = 0
    for tick in range(4):
        d = whole_body_walk_states(300 + tick, B, CFG)
        state, cmd = f32(state_comps_np(d)), f32(d["cmd"].T)
        plain = fc.commander_pre_plain(consts, state, carry, cmd,
                                       contact_gate=gate,
                                       raibert_cmd_symmetric=sym,
                                       mpc_horizon=nh, mpc_dt=0.03)
        rows = kernels._CMD_OUT_ROWS + ((fc.mpc_block_size(nh),) if nh else ())
        outs = torch.split(torch.empty((sum(rows), B)), rows)
        ptrs = [o.data_ptr() for o in outs] + [None] * (10 - len(outs))
        host.host_commander_pre(
            state.data_ptr(), carry.data_ptr(), cmd.data_ptr(), *ptrs, B,
            ctypes.byref(params))
        r, b, st, mu, fmin, fmax, tau, new, q_ref = outs[:9]
        pr, pb, pst, pmu, pfmin, pfmax, ptau, pnew, pq_ref = plain[:9]
        bad = (st != pst).any(0) | (
            new[DISCRETE_CARRY] != pnew[DISCRETE_CARRY]).any(0)
        assert int(bad.sum()) <= 2, torch.nonzero(bad).flatten().tolist()
        good = ~bad
        for name, a, p, rtol, atol in (
                ("r", r, pr, 1e-5, 2e-5), ("b", b, pb, 1e-5, 2e-4),
                ("tau_swing", tau, ptau, 5e-3, 1e-2),
                ("q_ref", q_ref, pq_ref, 1e-5, 2e-5),
                ("carry", new[CONTINUOUS_CARRY], pnew[CONTINUOUS_CARRY],
                 1e-5, 2e-5)):
            torch.testing.assert_close(
                a[:, good], p[:, good], rtol=rtol, atol=atol,
                msg=lambda m: f"tick {tick} {name}: {m}")
        assert torch.equal(mu, pmu) and torch.equal(fmin, pfmin)
        assert torch.equal(fmax, pfmax)
        if nh:
            # The MPC block: schedule exactly, the rest to float32 round-off.
            sched = slice(25, 25 + 4 * nh)
            assert torch.equal(outs[9][sched][:, good],
                               plain[9][sched][:, good])
            torch.testing.assert_close(outs[9][:, good], plain[9][:, good],
                                       rtol=1e-5, atol=2e-5)
        crossed += int(((pnew[2:6] < 0.5) & (carry[2:6] > 0.5)).sum())
        carry = pnew.contiguous()
    assert crossed > 0


@pytest.mark.parametrize(
    "model_fn,contact,prefactor,torque_input,gravity_comp",
    [(mit_cheetah_whole_body_model, ContactConfig(), "kernel", "qp", True),
     (mit_cheetah_urdf_model, ContactConfig(), "xla", "tau", False),
     (mit_cheetah_whole_body_model, ContactConfig(tangential="coulomb"),
      "kernel", "qp", False)],
    ids=["qp-kernel-gravity", "tau-streamed-urdf", "qp-kernel-coulomb"])
def test_substep_source_matches_plain_version(host, model_fn, contact,
                                              prefactor, torque_input,
                                              gravity_comp):
    """Ten substeps, B = 128, with a NaN lane and a 1e6 lane. Poses to 1e-4,
    velocities to 2e-3 relative + 2e-2 absolute (values up to the clamp of
    200): the contact stiffness amplifies float32 round-off from substep to
    substep. The NaN lane freezes and recovers, the 1e6 lane is clamped, on
    both sides alike (the 1e6 lane's first substeps are violent: it is held
    to finiteness and the clamp, not to the tolerances)."""
    B = 128
    rng = np.random.default_rng(21)
    model = model_fn(CFG, device="cpu")
    stepper = fsub.make_fused_stepper(model, CFG, contact,
                                      prefactor=prefactor,
                                      torque_input=torque_input,
                                      gravity_comp=gravity_comp)
    state = f32(state_comps_np(
        whole_body_walk_states(22, B, CFG, on_ground=True)))
    state[18, 0] = float("nan")
    state[19, 1] = 1.0e6
    if torque_input == "qp":
        fw = rng.uniform(-5.0, 5.0, (12, B))
        fw[2::3] = rng.uniform(10.0, 40.0, (4, B))
        extras = (f32(fw), f32(rng.uniform(-3.0, 3.0, (12, B))),
                  f32(rng.uniform(size=(4, B)) < 0.7))
    else:
        extras = (f32(rng.uniform(-8.0, 8.0, (12, B))),)
    factor = None
    if prefactor == "xla":
        from quadruped_control_tpu_torch.sim.dynamics import (
            mass_matrix, precompute_leg_kinematics, prefactor_mass_matrix)
        q = state[30:42].t().reshape(B, 4, 3)
        factor = fsub.factor_to_comps(prefactor_mass_matrix(mass_matrix(
            model, precompute_leg_kinematics(model, q), (B,), torch.float32)))

    def run_host(n_substeps, h):
        out = torch.empty((fsub.N_STATE, B))
        ptrs = [e.data_ptr() for e in extras] + [None] * (3 - len(extras))
        host.host_substep(
            state.data_ptr(), *ptrs,
            None if factor is None else factor.data_ptr(), out.data_ptr(),
            B, n_substeps, h,
            ctypes.byref(kernels.substep_params(stepper.consts)))
        return out

    one = run_host(1, DT / 10)
    assert torch.equal(one[POSE_ROWS, 0], state[POSE_ROWS, 0])
    assert bool((one[VEL_ROWS, 0] == 0).all())
    assert bool(torch.isfinite(one).all())
    assert one[VEL_ROWS, 1].abs().max().item() <= 200.0
    assert abs(one[19, 1].item()) == 200.0

    got = run_host(10, DT / 10)
    want = stepper.plain(state, *extras, DT, 10)
    assert bool(torch.isfinite(got).all() and torch.isfinite(want).all())
    assert got[VEL_ROWS].abs().max().item() <= 200.0
    keep = [i for i in range(B) if i != 1]
    torch.testing.assert_close(got[POSE_ROWS][:, keep],
                               want[POSE_ROWS][:, keep], rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got[VEL_ROWS][:, keep],
                               want[VEL_ROWS][:, keep], rtol=2e-3, atol=2e-2)


def _mpc_blocks(B, N, mdt):
    """(25 + 17N, B) float32 MPC blocks of the JAX MPC tests' problem family
    (tests/torch_port_helpers.mpc_problem_np), linearized at xi0's yaw."""
    d = mpc_problem_np(40, B, N, mdt, CFG)
    d["xi0"][:, 2] = d["yaw"]
    flat = np.concatenate(
        [d["xi0"], (d["feet_world"] - d["x_com"][:, None]).reshape(B, 12),
         d["stance_schedule"].reshape(B, -1).astype(np.float64),
         d["xi_ref"].reshape(B, -1)], -1)
    return f32(flat.T)


@pytest.mark.parametrize("N,mdt,iterations", [(8, 0.03, 25), (24, 0.02, 40)],
                         ids=["N8", "N24-no-best"])
def test_mpc_source_matches_plain_version(host, N, mdt, iterations):
    """B = 256 lanes, cold, then warm from the cold solve with a
    third of the schedule bits flipped (N = 8). Held like the chip smoke
    test holds the kernel: objective of the horizon forces (float64, on each
    lane's own condensed problem) median < 1e-5 and p99 < 5e-4 relative on
    the lanes both versions certify (an uncertified lane's iterate is
    where rounding left it), converged flags agreeing on >= 0.99 of the
    lanes, swing forces exactly 0, the warm output's s and z finite and >
    0."""
    from quadruped_control_tpu_torch.mpc import fused_riccati as fr
    from quadruped_control_tpu_torch.mpc import horizon as th
    from quadruped_control_tpu_torch.sim.fused_tick import (
        init_mpc_warm_packed)

    B = 256
    bal = CFG.balance
    st = fr.MpcSettings(n_steps=N, dt=mdt, iterations=iterations,
                        mass=bal.mass, inertia_diag=bal.inertia_diag,
                        mu=bal.mu, fz_min=bal.fz_min, fz_max=bal.fz_max)
    block = _mpc_blocks(B, N, mdt)
    blk = block.double().t()
    xi0, r = blk[:, :13], blk[:, 13:25].reshape(B, 4, 3)
    sched = blk[:, 25:25 + 4 * N].reshape(B, N, 4) > 0.5
    ref = blk[:, 25 + 4 * N:].reshape(B, N, 13)
    qp = th.build_mpc_qp(xi0, ref, xi0[:, 2], r, torch.zeros(B, 3), sched,
                         N, mdt, CFG)

    def objective(F):
        x = F.t().double()
        return 0.5 * torch.einsum("bi,bij,bj->b", x, qp.H, x) + (
            qp.c * x).sum(-1)

    def run_host(warm):
        F = torch.empty((12 * N, B))
        diag = torch.empty((6, B))
        wout = torch.empty((60 * N, B))
        scratch = torch.empty((kernels.MPC_WORDS_PER_STEP * N, B))
        wp = [None] * 3 if warm is None else [a.data_ptr() for a in warm]
        host.host_mpc_riccati(block.data_ptr(), None, None, *wp, F.data_ptr(),
                              diag.data_ptr(), wout.data_ptr(),
                              scratch.data_ptr(), B, ctypes.byref(st.params()))
        return F, diag, wout

    cold = init_mpc_warm_packed(B, horizon=N, device="cpu")
    flipped = block[25:25 + 4 * N].clone()
    flipped[:, ::3] = 1.0 - flipped[:, ::3]
    warm = None
    for name, w in (("cold", cold), ("warm", None)):
        if name == "warm":
            if N != 8:
                break
            w = (wout[48 * N:], wout[:48 * N], flipped)
        F, diag, wout = run_host(w)
        Fp, dp, szp = fr.packed_plain(block, w, st)
        o, op = objective(F), objective(Fp)
        both = ((diag[0] > 0.5) & (dp[0] > 0.5)).numpy()
        assert both.mean() > 0.5, (name, both.mean())
        rel = ((o - op).abs() / (1.0 + op.abs())).numpy()[both]
        agree = (diag[0] == dp[0]).float().mean().item()
        assert np.median(rel) < 1e-5 and np.percentile(rel, 99) < 5e-4, (
            name, np.median(rel), np.percentile(rel, 99))
        assert agree >= 0.99, (name, agree)
        swing = (block[25:25 + 4 * N].repeat_interleave(3, 0) < 0.5)
        assert bool((F[swing] == 0).all())
        assert bool(torch.isfinite(wout).all())
        assert bool((wout[:48 * N] > 0).all())
        warm = w
    assert warm is not None


def _exact_rsqrt(x):
    # sqrt of a float32 in float64, rounded once to float32: correctly
    # rounded, as the kernel's sqrtf.
    return 1.0 / torch.sqrt(x.double()).float()


@pytest.fixture(scope="module")
def dense():
    from torch_port_helpers import dense_problem

    return dense_problem(23, 256)["soa"]


def _host_barrier(host, prob, iterations):
    B = prob[1].shape[1]
    out = (torch.empty(12, B), torch.empty(24, B), torch.empty(24, B))
    host.host_dense_barrier(*[a.data_ptr() for a in prob],
                            *[o.data_ptr() for o in out], B, iterations,
                            0.995)
    return out


@pytest.mark.parametrize("iterations", [3, 20])
def test_dense_barrier_source_matches_plain_version(host, dense, iterations,
                                                    monkeypatch):
    """K3a's body (B = 256, randomized GRF QPs equilibrated by the JAX
    package) is bitwise its plain version with a correctly rounded
    reciprocal square root; with torch's CPU sqrt the two stay within the
    objective of each other (the rounding moves a few lanes' iterates)."""
    from quadruped_control_tpu_torch.solver import fused_ipm as fi

    got = _host_barrier(host, dense, iterations)
    approx = fi._dense_barrier_plain(*dense, iterations=iterations,
                                     tau=0.995)
    monkeypatch.setattr(fi, "_rsqrt", _exact_rsqrt)
    want = fi._dense_barrier_plain(*dense, iterations=iterations, tau=0.995)
    for g, w, name in zip(got, want, "xsz"):
        assert torch.equal(g, w), name
    assert bool(torch.isfinite(approx[0]).all())
    same = (approx[0] == got[0]).all(0).float().mean()
    assert float(same) > 0.5


def test_dense_polish_source_matches_plain_version(host, dense):
    """K3b's body from one barrier point, with two poisoned lanes (NaN in Q,
    inf in h): bitwise its plain version in all four outputs (no square
    root in it; the Dekker products are exact on both sides under
    -ffp-contract=off), the poisoned lanes uncertified."""
    from quadruped_control_tpu_torch.solver import fused_ipm as fi

    prob = [a.clone() for a in dense]
    bar = fi._dense_barrier_plain(*prob, iterations=20, tau=0.995)
    prob[0][7, 4] = float("nan")
    prob[3][3, 11] = float("inf")
    B = prob[1].shape[1]
    out = (torch.empty(12, B), torch.empty(24, B), torch.empty(24, B),
           torch.empty(B))
    host.host_dense_polish(*[a.data_ptr() for a in prob],
                           *[a.data_ptr() for a in bar],
                           *[o.data_ptr() for o in out], B)
    want = fi._dense_polish_plain(*prob, *bar)
    for g, w, name in zip(out, want, ("x", "s", "z", "cert")):
        assert torch.equal(g, w), name
    assert float(out[3][4]) == 0.0 and float(out[3][11]) == 0.0
    assert float(out[3].mean()) > 0.9
