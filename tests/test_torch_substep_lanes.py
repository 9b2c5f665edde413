"""PyTorch port: the lane split of the whole-body substep kernel (K5) and its
launch geometry, on the CPU.

K5 runs one robot on a group of QS_G lanes (csrc/qct_substep.cuh
``substep_lanes``): each section of the body runs in every lane for the legs,
contact points, rows or state words that lane owns, and the lanes meet at a
sync. The block stages its robots' states and torque inputs (and a streamed
factor) into shared memory first and writes the new states from there.
tests/torch_port_host_shim.cpp builds the body for the host in three forms:
serial, the lanes of each section in a loop, ascending and descending
(-DQCT_REVERSE_LANES: a lane reading, inside one section, what another lane
of it writes gives other bits); and the lane program (-DQCT_LANE_PROGRAM),
where a warp's 32 lanes (32 / QS_G robot slots, staged and written back by
the warp's 32 threads) are coroutines, each running the card's form of the
body alone from one sync to the next, first to last and last to first (a
missing sync shows, and so do lanes of a warp that do not wait at the same
sync). Every form is held BITWISE to the kernel's serial body
(``substep_instance_serial``, one robot per thread), which
tests/test_torch_kernel_sources_host.py holds to the plain PyTorch version.
The launch geometry (kernels.substep_launch_geometry) is plain Python on the
build's layout.
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
from quadruped_control_tpu_torch.sim import (
    ContactConfig,
    mit_cheetah_urdf_model,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim import fused_substep as fsub
from quadruped_control_tpu_torch.sim.dynamics import (
    mass_matrix,
    precompute_leg_kinematics,
    prefactor_mass_matrix,
)
from quadruped_control_tpu_torch.utils.scenarios import (
    walk_state_comps,
    whole_body_walk_states,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
CFG = mit_cheetah_physical_config()
DT = 1.0 / CFG.frequency
# The shim's builds: defines of each.
BUILDS = {"ascending": (), "reversed": ("QCT_REVERSE_LANES",),
          "warp": ("QCT_LANE_PROGRAM",),
          "warp_reversed": ("QCT_LANE_PROGRAM", "QCT_REVERSE_LANES")}
# 37 robots: with 8 lanes a robot, 10 warps of 4 robot slots, the last three
# slots of the last warp past the batch.
B = 37
NAN_LANE, BIG_LANE = 5, 30  # a NaN joint velocity, a 1e6 one
VEL_ROWS = list(range(12, 30))
POSE_ROWS = list(range(0, 12)) + list(range(30, 58))
MODELS = {"whole_body": mit_cheetah_whole_body_model,
          "urdf": mit_cheetah_urdf_model}
# (torque_input, gravity_comp)
TORQUES = {"qp-gravity": ("qp", True), "qp": ("qp", False),
           "tau": ("tau", False)}


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> (K5 lane entry, library) of each build, compiled side by
    side."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("substep_lanes")
    procs = {name: (d / f"libqct_host_{name}.so", defines, subprocess.Popen(
        _build_cmd(d / f"libqct_host_{name}.so", defines),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, defines in BUILDS.items()}
    out = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    args = [vp] * 6 + [ci, ci, ctypes.c_float,
                       ctypes.POINTER(kernels.SubstepParams)]
    for name, (so, defines, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        lib = ctypes.CDLL(str(so))
        warp = "QCT_LANE_PROGRAM" in defines
        fn = lib.host_substep_warps if warp else lib.host_substep
        fn.argtypes = args
        fn.restype = ci if warp else None
        lib.host_substep_serial.argtypes = args
        lib.host_substep_serial.restype = None
        lib.host_substep_layout.argtypes = [vp]
        lib.host_substep_layout.restype = None
        out[name] = (fn, lib)
    return out


def _f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _inputs(model, torque_input, streamed, seed=41):
    """Mid-walk states with the feet on the ground, one lane with a NaN
    joint velocity and one with a 1e6 one; random torque inputs; the
    streamed factor of the states' q where asked for."""
    rng = np.random.default_rng(seed)
    state = _f32(walk_state_comps(
        whole_body_walk_states(seed, B, CFG, on_ground=True)))
    state[18, NAN_LANE] = float("nan")
    state[19, BIG_LANE] = 1.0e6
    if torque_input == "qp":
        fw = rng.uniform(-5.0, 5.0, (12, B))
        fw[2::3] = rng.uniform(10.0, 40.0, (4, B))
        extras = (_f32(fw), _f32(rng.uniform(-3.0, 3.0, (12, B))),
                  _f32(rng.uniform(size=(4, B)) < 0.7))
    else:
        extras = (_f32(rng.uniform(-8.0, 8.0, (12, B))),)
    factor = None
    if streamed:
        q = state[30:42].t().reshape(B, 4, 3)
        factor = fsub.factor_to_comps(prefactor_mass_matrix(mass_matrix(
            model, precompute_leg_kinematics(model, q), (B,),
            torch.float32))).contiguous()
    return state, extras, factor


def _run(fn, state, extras, factor, params, n_substeps):
    """One entry of the shim: the new states, which start NaN."""
    out = torch.full((fsub.N_STATE, B), float("nan"))
    ptrs = [e.data_ptr() for e in extras] + [None] * (3 - len(extras))
    rc = fn(state.data_ptr(), *ptrs,
            None if factor is None else factor.data_ptr(), out.data_ptr(),
            B, n_substeps, DT / 10, ctypes.byref(params))
    assert rc in (None, 0), "the lanes of a warp did not wait at one sync"
    return out


def _bits(a, b):
    """Bit for bit (NaN payloads and signs of zero included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("tangential", ["anchor", "coulomb"])
@pytest.mark.parametrize("torque", list(TORQUES))
@pytest.mark.parametrize("prefactor", ["kernel", "xla"])
@pytest.mark.parametrize("model_name", list(MODELS))
def test_substep_lanes_match_serial_body(hosts, model_name, prefactor,
                                         torque, tangential):
    """1 and 10 substeps at B = 37 with a NaN-velocity lane, a 1e6 lane and
    slots past the batch: the new states of all four builds equal the serial
    body's bit for bit. The NaN lane freezes in its first substep (pose
    kept, velocities zeroed) and then runs on; the 1e6 lane is clamped to
    200."""
    torque_input, gravity_comp = TORQUES[torque]
    model = MODELS[model_name](CFG, device="cpu")
    stepper = fsub.make_fused_stepper(
        model, CFG, ContactConfig(tangential=tangential), prefactor=prefactor,
        torque_input=torque_input, gravity_comp=gravity_comp)
    params = kernels.substep_params(stepper.consts)
    state, extras, factor = _inputs(model, torque_input, prefactor == "xla")
    serial = hosts["ascending"][1].host_substep_serial
    for n in (1, 10):
        want = _run(serial, state, extras, factor, params, n)
        assert bool(torch.isfinite(want).all())
        assert want[VEL_ROWS].abs().max().item() <= 200.0
        if n == 1:
            assert torch.equal(want[POSE_ROWS, NAN_LANE],
                               state[POSE_ROWS, NAN_LANE])
            assert bool((want[VEL_ROWS, NAN_LANE] == 0).all())
            assert abs(want[19, BIG_LANE].item()) == 200.0
        else:
            assert bool((want[VEL_ROWS, NAN_LANE] != 0).any())
        for name, (fn, _) in hosts.items():
            got = _run(fn, state, extras, factor, params, n)
            assert _bits(got, want), f"{name}, {n} substeps"


def _layout(hosts):
    a = (ctypes.c_int * 3)()
    hosts["ascending"][1].host_substep_layout(a)
    return kernels.MpcLayout(*a)


@pytest.mark.parametrize("Bn", [1, 37, 1024, 4096, 4099])
def test_substep_geometry_covers_every_robot_once(hosts, Bn):
    """Robot slot blockIdx.x * robots_per_block + threadIdx.x // lanes (the
    kernel's own index) over the whole grid, on the build's layout: every
    robot of the batch once, the rest of the slots past B, fewer than a
    block of them; the block's threads within the launch bounds and whole
    warps, its shared memory (every robot's state, and the model's
    parameters) within a Hopper block's."""
    layout = _layout(hosts)
    geo = kernels.substep_launch_geometry(Bn, layout)
    assert layout.lanes == 8 and 32 % layout.lanes == 0
    assert geo.threads == geo.robots_per_block * layout.lanes
    assert geo.threads <= layout.max_threads and geo.threads % 32 == 0
    assert geo.shared_bytes == geo.robots_per_block * layout.shared_words * 4
    assert (geo.shared_bytes + ctypes.sizeof(kernels.SubstepParams)
            <= kernels.SHARED_BYTES_MAX)
    slots = (np.arange(geo.blocks)[:, None] * geo.robots_per_block
             + np.arange(geo.threads)[None, :] // layout.lanes)
    lanes = np.bincount(slots.ravel(), minlength=Bn)
    assert (lanes[:Bn] == layout.lanes).all()
    assert 0 <= slots.max() + 1 - Bn < geo.robots_per_block
