"""PyTorch port: the lane split of the commander-pre kernel (K4) and its
launch geometry, on the CPU.

K4 runs one control instance on a group of QC_G lanes (csrc/
qct_commander.cuh ``commander_lanes``): every lane computes the
leg-independent prefix itself, then the steps of its own legs, then its
share of the suffix; no lane reads what another writes (no shared memory,
no shuffle, no sync). tests/torch_port_host_shim.cpp builds the body for the
host and runs it over the threads of the card's launch (each thread's slot
and lane from ``qc_slot``, slots past the batch skipped), in thread order or
last thread first (-DQCT_REVERSE_LANES), at 4 lanes an instance and at 2,
in blocks of 64 threads and of 32. Every build is held
BITWISE to K4's serial body (``commander_instance_serial``, one instance per
thread, which tests/test_torch_kernel_sources_host.py holds to the plain
PyTorch version), and the shim counts the stores into the output slab: each
output word has exactly one writer. The launch geometry
(kernels.commander_geometry) is plain Python on the build's layout.
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
from quadruped_control_tpu_torch.utils.scenarios import (
    commander_carry_walk,
    walk_carry_comps,
    walk_state_comps,
    whole_body_walk_states,
)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
CFG = mit_cheetah_physical_config()
DT = 1.0 / CFG.frequency
# The shim's builds: defines of each.
BUILDS = {"4 lanes": ("QC_G=4",),
          "4 lanes reversed": ("QC_G=4", "QCT_REVERSE_LANES"),
          "2 lanes": ("QC_G=2",),
          "2 lanes reversed": ("QC_G=2", "QCT_REVERSE_LANES"),
          "4 lanes, 32 threads": ("QC_G=4", "QC_THREADS=32")}
# (contact_gate, raibert_cmd_symmetric, mpc_horizon)
OPTIONS = {"reference": (0.0, False, 0), "gate+symmetric N=8": (0.01, True, 8),
           "N=24": (0.0, False, 24)}
# 37 instances: the last block's slots past the batch. Lane NAN_LANE has a
# NaN body rate and a NaN thigh angle, INF_LANE an infinite forward command,
# SINGULAR_LANE a base 3 m up with straight knees (every target out of
# reach: the IK straightens the knee, and the Jacobian at q_ref is singular).
B = 37
NAN_LANE, INF_LANE, SINGULAR_LANE = 3, 17, 29
TICKS = 3


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> library of each build, compiled side by side."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("commander_lanes")
    procs = {name: (d / f"libqct_host_{k}.so", subprocess.Popen(
        _build_cmd(d / f"libqct_host_{k}.so", defines),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for k, (name, defines) in enumerate(BUILDS.items())}
    out = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    prm = ctypes.POINTER(kernels.CommanderParams)
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        lib = ctypes.CDLL(str(so))
        lib.host_commander_pre.argtypes = [vp] * 13 + [ci, prm]
        lib.host_commander_pre.restype = None
        lib.host_commander_lanes.argtypes = [vp] * 13 + [
            ci, prm, vp, ctypes.c_long, vp]
        lib.host_commander_lanes.restype = None
        lib.host_commander_layout.argtypes = [vp]
        lib.host_commander_layout.restype = None
        out[name] = lib
    return out


def _f32(a):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32)


def _tick_inputs(tick):
    """Mid-walk states and commands of one tick, with the poisoned lanes."""
    d = whole_body_walk_states(300 + tick, B, CFG)
    state, cmd = _f32(walk_state_comps(d)), _f32(d["cmd"].T)
    state[13, NAN_LANE] = float("nan")
    state[34, NAN_LANE] = float("nan")
    cmd[0, INF_LANE] = float("inf")
    state[11, SINGULAR_LANE] = 3.0
    state[[32, 35, 38, 41], SINGULAR_LANE] = 0.0
    return state, cmd


def _run(lib, lanes, state, carry, cmd, params, nh):
    """One entry of the shim on outputs that start NaN: the output blocks
    and, for the lane body, the stores counted per slab word (the last
    entry: stores outside the slab)."""
    rows = kernels._CMD_OUT_ROWS + ((fc.mpc_block_size(nh),) if nh else ())
    slab = torch.full((sum(rows), B), float("nan"))
    outs = torch.split(slab, rows)
    ptrs = [o.data_ptr() for o in outs] + [None] * (10 - len(outs))
    args = (state.data_ptr(), carry.data_ptr(), cmd.data_ptr(), *ptrs, B,
            ctypes.byref(params))
    writes = None
    if lanes:
        writes = torch.zeros(slab.numel() + 1, dtype=torch.int32)
        lib.host_commander_lanes(*args, slab.data_ptr(), slab.numel(),
                                 writes.data_ptr())
    else:
        lib.host_commander_pre(*args)
    return outs, writes


def _bits(a, b):
    """Bit for bit (NaN payloads and signs of zero included)."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("build", list(BUILDS))
@pytest.mark.parametrize("option", list(OPTIONS))
def test_commander_lanes_match_serial_body(hosts, option, build):
    """Three chained ticks at B = 37 (the carry fed back) with a NaN-state
    lane, an inf-command lane and a singular-Jacobian lane: every output of
    the build's lane body equals the serial body's bit for bit, and every
    output word is stored exactly once (none outside the outputs)."""
    gate, sym, nh = OPTIONS[option]
    params = fc.CommanderConsts(CFG, DT).params(gate, sym, nh, 0.03)
    serial = hosts["4 lanes"]
    carry = _f32(walk_carry_comps(commander_carry_walk(11, B, CFG)))
    for tick in range(TICKS):
        state, cmd = _tick_inputs(tick)
        want, _ = _run(serial, False, state, carry, cmd, params, nh)
        # The poisoned lanes do what they are there for.
        assert bool(want[1][3:, NAN_LANE].isnan().all())
        assert bool(want[6][4, NAN_LANE].isnan())
        assert bool(torch.isfinite(want[1][:, B - 1]).all())
        assert not bool(torch.isfinite(want[1][:, INF_LANE]).all())
        assert bool((want[8][2::3, SINGULAR_LANE] == 0).any())
        got, writes = _run(hosts[build], True, state, carry, cmd, params, nh)
        for k, (g, w) in enumerate(zip(got, want)):
            assert _bits(g, w), f"tick {tick}: output block {k} differs"
        assert int(writes[-1]) == 0, "stores outside the outputs"
        once = writes[:-1] == 1
        assert bool(once.all()), (
            f"tick {tick}: words stored {writes[:-1][~once].unique().tolist()}"
            f" times")
        carry = want[7].clone()


@pytest.mark.parametrize("build", list(BUILDS))
def test_commander_geometry_covers_every_instance(hosts, build):
    """kernels.commander_geometry on each build's layout, at the tick's B
    and around it: whole warps, the build's block, every instance in a
    slot, fewer than a block's slots past B."""
    a = (ctypes.c_int * 2)()
    hosts[build].host_commander_layout(a)
    layout = kernels.CommanderLayout(*a)
    defines = dict(d.split("=") for d in BUILDS[build] if "=" in d)
    assert layout.lanes == int(defines["QC_G"])
    assert layout.threads == int(defines.get("QC_THREADS", 64))
    for Bn in (1, B, 1061, 4096):
        geo = kernels.commander_geometry(Bn, layout)
        assert geo.threads == layout.threads and geo.threads % 32 == 0
        assert geo.robots_per_block * layout.lanes == geo.threads
        assert geo.shared_bytes == 0
        slots = geo.blocks * geo.robots_per_block
        assert 0 <= slots - Bn < geo.robots_per_block
