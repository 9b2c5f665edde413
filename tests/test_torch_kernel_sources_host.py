"""PyTorch port: the SOURCES of the commander-pre (K4) and substep (K5) CUDA
kernels, compiled for the host and held against the plain PyTorch versions.

A CUDA kernel cannot run without a card, but the per-instance bodies of K4
and K5 (csrc/qct_commander.cuh, csrc/qct_substep.cuh) are plain C++ behind a
macro: tests/torch_port_host_shim.cpp loops them over the batch, ``g++
-ffp-contract=off`` builds it, and the same ctypes parameter structs the CUDA
launchers fill are handed to it. Float32 on both sides. This is a rehearsal
of the kernels' arithmetic, not of the kernels: host ``sinf``/``atan2f`` and
torch's CPU ones differ in the last bits, so the tolerances are those of
float32 round-off carried through the chain (on the card K4 is bitwise equal
to its plain version, chip_smoke.py).
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
from torch_port_helpers import carry_comps_np, state_comps_np

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
    lib.host_commander_pre.argtypes = [vp] * 12 + [
        ci, ctypes.POINTER(kernels.CommanderParams)]
    lib.host_commander_pre.restype = None
    lib.host_substep.argtypes = [vp] * 6 + [
        ci, ci, ctypes.c_float, ctypes.POINTER(kernels.SubstepParams)]
    lib.host_substep.restype = None
    return lib


def f32(a):
    return torch.as_tensor(np.ascontiguousarray(a),
                           dtype=torch.float32).contiguous()


@pytest.mark.parametrize("gate,sym", [(0.0, False), (0.01, True)],
                         ids=["reference", "gate+symmetric"])
def test_commander_source_matches_plain_version(host, gate, sym):
    """Four chained ticks, B = 256. Continuous outputs, (rtol, atol): levers,
    joint targets and the carry (1e-5, 2e-5); the right-hand side (1e-5,
    2e-4: gains of 1e2..1e3 on pose errors); the swing torques (5e-3, 1e-2:
    the Jacobian inverse of a leg near full extension amplifies the last
    bits of its joint-velocity target). Discrete outputs exactly, but for at
    most 2 lanes per tick within an ulp of a threshold (none seen)."""
    B = 256
    consts = fc.CommanderConsts(CFG, DT)
    params = consts.params(gate, sym)
    carry = f32(carry_comps_np(commander_carry_walk(11, B, CFG)))
    crossed = 0
    for tick in range(4):
        d = whole_body_walk_states(300 + tick, B, CFG)
        state, cmd = f32(state_comps_np(d)), f32(d["cmd"].T)
        plain = fc.commander_pre_plain(consts, state, carry, cmd,
                                       contact_gate=gate,
                                       raibert_cmd_symmetric=sym)
        slab = torch.empty((sum(kernels._CMD_OUT_ROWS), B))
        outs = torch.split(slab, kernels._CMD_OUT_ROWS)
        host.host_commander_pre(
            state.data_ptr(), carry.data_ptr(), cmd.data_ptr(),
            *(o.data_ptr() for o in outs), B, ctypes.byref(params))
        r, b, st, mu, fmin, fmax, tau, new, q_ref = outs
        pr, pb, pst, pmu, pfmin, pfmax, ptau, pnew, pq_ref = plain
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
