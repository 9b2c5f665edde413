"""PyTorch port: the lane split of the MPC kernel (K6) and its launch
geometry, on the CPU.

K6 runs one robot on a group of 16 lanes (csrc/qct_mpc.cuh): each section
of the body runs in every lane for the elements that lane owns, and the
lanes meet at a sync. A lane that reads what another lane writes, with no
sync between the two, would make the result depend on the lanes' timing.
The serial host build (tests/torch_port_host_shim.cpp) runs the lanes of a
section one after the other; built with the lanes ascending and descending
(-DQCT_REVERSE_LANES) it must give the same bits, which holds a read across
lanes inside one section. The serial build's lanes must also give the bits
of K6's serial body (csrc/qct_mpc_serial.cuh, one robot per thread, the
arithmetic the lane split keeps element by element), which the card holds
the lane kernel to as well. The lane-program build (-DQCT_LANE_PROGRAM) runs
a warp's 32 lanes as the card does, each from sync to sync on its own, in
both orders: a missing sync shows there too, and so do lanes that do not
wait at the same sync. The launch geometry (kernels.mpc_launch_geometry) is
plain Python on the build's layout: it must cover every robot once and keep
a block within what the build and a Hopper block allow.
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
from quadruped_control_tpu_torch.mpc import fused_riccati as fr
from quadruped_control_tpu_torch.sim.fused_tick import init_mpc_warm_packed
from torch_port_helpers import mpc_problem_np

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
CFG = mit_cheetah_physical_config()
# The shim's builds: defines of each.
BUILDS = {"ascending": (), "reversed": ("QCT_REVERSE_LANES",),
          "warp": ("QCT_LANE_PROGRAM",),
          "warp_reversed": ("QCT_LANE_PROGRAM", "QCT_REVERSE_LANES")}


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


def _load(out, defines):
    lib = ctypes.CDLL(str(out))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    warp = "QCT_LANE_PROGRAM" in defines
    fn = lib.host_mpc_riccati_warps if warp else lib.host_mpc_riccati
    fn.argtypes = [vp] * 10 + [ci, ctypes.POINTER(kernels.MpcParams)]
    fn.restype = ci if warp else None
    lib.host_mpc_layout.argtypes = [vp]
    lib.host_mpc_layout.restype = None
    return fn, lib


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> (K6 entry, library) of each build, compiled side by side."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("mpc_lanes")
    procs = {name: (d / f"libqct_host_{name}.so", defines, subprocess.Popen(
        _build_cmd(d / f"libqct_host_{name}.so", defines),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, defines in BUILDS.items()}
    out = {}
    for name, (so, defines, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        out[name] = _load(so, defines)
    return out


def _layout(hosts):
    a = (ctypes.c_int * 3)()
    hosts["ascending"][1].host_mpc_layout(a)
    return kernels.MpcLayout(*a)


def _block(seed, B, N, mdt):
    d = mpc_problem_np(seed, B, N, mdt, CFG)
    d["xi0"][:, 2] = d["yaw"]
    flat = np.concatenate(
        [d["xi0"], (d["feet_world"] - d["x_com"][:, None]).reshape(B, 12),
         d["stance_schedule"].reshape(B, -1).astype(np.float64),
         d["xi_ref"].reshape(B, -1)], -1)
    block = torch.as_tensor(flat.T, dtype=torch.float32).contiguous()
    block[0, 3] = float("nan")  # a poisoned robot among the others
    return block


def _run(host, block, warm, st, B, yaw=None, phys=None):
    """K6 through one build: (F, diag, warm_out). The scratch has a slot
    for every robot slot of the build's warps (an even count), NaN where
    nothing has written yet, so that an early read shows."""
    N = st.n_steps
    F = torch.empty((12 * N, B))
    diag = torch.empty((6, B))
    wout = torch.empty((60 * N, B))
    scratch = torch.full((B + B % 2, kernels.MPC_WORDS_PER_STEP * N),
                         float("nan"))
    wp = [None] * 3 if warm is None else [a.data_ptr() for a in warm]
    rc = host[0](block.data_ptr(), None if yaw is None else yaw.data_ptr(),
                 None if phys is None else phys.data_ptr(), *wp,
                 F.data_ptr(), diag.data_ptr(), wout.data_ptr(),
                 scratch.data_ptr(), B, ctypes.byref(st.params()))
    assert rc in (None, 0), "the lanes of a warp did not wait at one sync"
    return F, diag, wout


def _run_serial(host, block, warm, st, B, yaw=None, phys=None):
    """K6's serial body (host_mpc_serial) on the arguments of :func:`_run`;
    its scratch is (324 N, B), NaN where nothing has written yet."""
    N = st.n_steps
    lib = host[1]
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.host_mpc_serial.argtypes = [vp] * 10 + [
        ci, ctypes.POINTER(kernels.MpcParams)]
    lib.host_mpc_serial.restype = None
    F = torch.empty((12 * N, B))
    diag = torch.empty((6, B))
    wout = torch.empty((60 * N, B))
    scratch = torch.full((kernels.MPC_WORDS_PER_STEP * N, B), float("nan"))
    wp = [None] * 3 if warm is None else [a.data_ptr() for a in warm]
    lib.host_mpc_serial(block.data_ptr(),
                        None if yaw is None else yaw.data_ptr(),
                        None if phys is None else phys.data_ptr(), *wp,
                        F.data_ptr(), diag.data_ptr(), wout.data_ptr(),
                        scratch.data_ptr(), B, ctypes.byref(st.params()))
    return F, diag, wout


def _unpacked_args(B):
    """Per-robot yaw and constants (the unpacked entry's inputs)."""
    rng = np.random.default_rng(5)
    bal = CFG.balance
    yaw = torch.as_tensor(0.3 * rng.standard_normal(B), dtype=torch.float32)
    phys = torch.as_tensor(np.stack(
        [bal.mass * rng.uniform(0.8, 1.2, B),
         *(np.asarray(bal.inertia_diag)[:, None]
           * rng.uniform(0.8, 1.2, (3, B))),
         rng.uniform(0.5, 1.0, B), np.full(B, bal.fz_min),
         np.full(B, bal.fz_max)]), dtype=torch.float32).contiguous()
    return yaw, phys


def _settings(N, mdt, iterations):
    bal = CFG.balance
    return fr.MpcSettings(n_steps=N, dt=mdt, iterations=iterations,
                          mass=bal.mass, inertia_diag=bal.inertia_diag,
                          mu=bal.mu, fz_min=bal.fz_min, fz_max=bal.fz_max)


def _warm(host, block, st, B):
    """A cold solve's carry, a third of the schedule bits flipped (those
    rows restart cold)."""
    N = st.n_steps
    cold = _run(host, block, init_mpc_warm_packed(B, horizon=N, device="cpu"),
                st, B)
    flipped = block[25:25 + 4 * N].clone()
    flipped[:, ::3] = 1.0 - flipped[:, ::3]
    return (cold[2][48 * N:].contiguous(), cold[2][:48 * N].contiguous(),
            flipped)


def _assert_bitwise(a3, b3, what):
    for name, a, b in zip(("F", "diag", "warm_out"), a3, b3):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            f"{what}: {name}"


@pytest.mark.parametrize("N,mdt,iterations,warm",
                         [(8, 0.03, 8, True), (24, 0.02, 25, False)],
                         ids=["N8-warm", "N24-cold"])
def test_mpc_lanes_are_free_of_races(hosts, N, mdt, iterations, warm):
    """B = 64 robots (one poisoned with a NaN): K6's outputs (forces, diag,
    warm carry) are bitwise the same with the lanes of every section run
    ascending and descending. N = 8 warm starts from a cold solve's carry
    with a third of the schedule bits flipped (those rows restart cold)."""
    B = 64
    st = _settings(N, mdt, iterations)
    block = _block(41, B, N, mdt)
    w = _warm(hosts["ascending"], block, st, B) if warm else None
    up = _run(hosts["ascending"], block, w, st, B)
    down = _run(hosts["reversed"], block, w, st, B)
    _assert_bitwise(up, down, "lanes reversed")
    assert bool(torch.isfinite(up[0][:, 1:]).all())
    assert float(up[1][0, 0]) == 0.0  # the poisoned robot is not certified


@pytest.mark.parametrize(
    "N,mdt,iterations,warm,unpacked",
    [(8, 0.03, 8, True, False), (24, 0.02, 4, False, False),
     (16, 0.03, 4, False, False), (3, 0.03, 6, False, True)],
    ids=["N8-warm", "N24-cold", "N16-cold", "N3-unpacked"])
def test_mpc_warp_lanes_meet_and_agree(hosts, N, mdt, iterations, warm,
                                       unpacked):
    """K6's lanes as coroutines of a warp, each run from sync to sync on
    its own, first to last and last to first: they wait at the same syncs,
    and the outputs are bitwise those of the serial build. B = 5: robot 3
    (a NaN) shares its warp with robot 2, and slot 5 of the last warp runs
    along past the batch. Best-iterate tracking (N <= 16) and not (N = 24),
    warm with flipped schedule bits, and the unpacked entry with per-robot
    yaw and constants."""
    B = 5
    st = _settings(N, mdt, iterations)
    block = _block(43, B, N, mdt)
    yaw, phys = _unpacked_args(B) if unpacked else (None, None)
    w = _warm(hosts["ascending"], block, st, B) if warm else None
    serial = _run(hosts["ascending"], block, w, st, B, yaw, phys)
    for name in ("warp", "warp_reversed"):
        _assert_bitwise(serial, _run(hosts[name], block, w, st, B, yaw, phys),
                        name)
    assert bool(torch.isfinite(serial[0][:, [0, 1, 2, 4]]).all())
    assert float(serial[1][0, 3]) == 0.0  # the poisoned robot


@pytest.mark.parametrize(
    "N,mdt,iterations,warm,unpacked",
    [(8, 0.03, 8, True, False), (8, 0.03, 15, False, False),
     (24, 0.02, 25, False, False), (3, 0.03, 6, False, True)],
    ids=["N8-warm", "N8-cold15", "N24-cold", "N3-unpacked"])
def test_mpc_lane_body_is_its_serial_body(hosts, N, mdt, iterations, warm,
                                          unpacked):
    """B = 37 robots (robot 3 poisoned with a NaN): the lane body's forces, diag
    and warm carry are bitwise those of K6's serial body, one robot per
    thread (qct_mpc_serial): warm-8 from a cold carry with a third of the
    schedule bits flipped, cold-15, N = 24 without best-iterate tracking,
    and the unpacked entry with per-robot yaw and constants. The card holds
    the two kernels the same way (chip_smoke.py phases 10, 11 and 17)."""
    B = 37
    st = _settings(N, mdt, iterations)
    block = _block(47, B, N, mdt)
    yaw, phys = _unpacked_args(B) if unpacked else (None, None)
    w = _warm(hosts["ascending"], block, st, B) if warm else None
    lanes = _run(hosts["ascending"], block, w, st, B, yaw, phys)
    serial = _run_serial(hosts["ascending"], block, w, st, B, yaw, phys)
    _assert_bitwise(lanes, serial, "serial body")
    assert float(lanes[1][0, 3]) == 0.0  # the poisoned robot
    others = [i for i in range(B) if i != 3]
    assert bool(torch.isfinite(lanes[0][:, others]).all())


@pytest.mark.parametrize("B", [1, 3, 37, 4095, 4096, 4097])
def test_mpc_geometry_covers_every_robot_once(hosts, B):
    """Robot blockIdx.x * robots_per_block + threadIdx.x // lanes (the
    kernel's own index) over the whole grid, on the build's layout: every
    robot of the batch once, the rest of the slots past B, fewer than a
    block of them."""
    layout = _layout(hosts)
    geo = kernels.mpc_launch_geometry(B, layout)
    assert geo.threads == geo.robots_per_block * layout.lanes
    threads = np.arange(geo.threads)
    slots = (np.arange(geo.blocks)[:, None] * geo.robots_per_block
             + threads[None, :] // layout.lanes)
    lanes = np.bincount(slots.ravel(), minlength=B)
    assert (lanes[:B] == layout.lanes).all()
    assert 0 <= slots.max() + 1 - B < geo.robots_per_block


def test_mpc_block_fits_build_and_card(hosts):
    """The build's block: its threads within the kernel's launch bounds,
    its shared memory (each robot's sweep state, whatever the horizon)
    within the 227 KB of a Hopper block, and an even number of 16-byte
    rows a robot."""
    layout = _layout(hosts)
    geo = kernels.mpc_launch_geometry(4096, layout)
    assert geo.threads <= layout.max_threads
    assert geo.threads % 32 == 0  # whole warps
    assert geo.shared_bytes == geo.robots_per_block * layout.shared_words * 4
    assert geo.shared_bytes <= kernels.SHARED_BYTES_MAX
    assert layout.shared_words % 8 == 0


def test_mpc_geometry_beyond_the_card_raises(hosts):
    """A build whose robot state would overflow a Hopper block's 227 KB, or
    whose block would exceed its launch bounds, is refused, not
    launched."""
    layout = _layout(hosts)
    words = kernels.SHARED_BYTES_MAX // (4 * kernels.MPC_ROBOTS_PER_BLOCK)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.mpc_launch_geometry(
            4096, layout._replace(shared_words=words + 1))
    kernels.mpc_launch_geometry(4096, layout._replace(shared_words=words))
    with pytest.raises(ValueError, match="threads"):
        kernels.mpc_launch_geometry(
            4096, layout._replace(lanes=2 * layout.lanes))
