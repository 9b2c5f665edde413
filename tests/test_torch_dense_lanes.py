"""PyTorch port: the lane split of the dense certified-polish kernel (K3b)
and its launch geometry, on the CPU.

K3b runs one QP on a group of 16 lanes (csrc/qct_dense_ipm.cuh
``dense_polish_lanes``, with the lane machinery and the LDL^T of
csrc/qct_lanes.cuh): each section of the body runs in every lane for the
elements that lane owns, and the lanes meet at a sync. The block stages its
QPs' problems into shared memory first and writes the outputs from there.
tests/torch_port_host_shim.cpp builds the body for the host in three forms:
serial, the lanes of each section in a loop, ascending and descending
(-DQCT_REVERSE_LANES: a lane reading, inside one section, what another lane
of it writes gives other bits); and the lane program (-DQCT_LANE_PROGRAM),
where a warp's 32 lanes (two QP slots, staged and written back by the
warp's 32 threads) are coroutines, each running the card's form of the
body alone from one sync to the next, first to last and last to first (a
missing sync shows, and so do lanes of a QP that do not wait at the same
sync). Every form is held BITWISE to the plain version
``solver/fused_ipm.py::_dense_polish_plain`` (8 sweeps, 4 refinements; it
has no square root): equal values, as ``torch.equal`` compares them (the
plain version's ``_fmax(a z, 0)`` may keep a -0 where the kernel's ``qmax``
gives +0), and a NaN equal to any NaN. The four builds are held to each
other bit for bit, NaN payloads and signs of zero included. The launch
geometry (kernels.dense_launch_geometry) is plain Python on the build's
layout.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.solver import fused_ipm as fi
from torch_port_helpers import dense_problem

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
# The shim's builds: defines of each.
BUILDS = {"ascending": (), "reversed": ("QCT_REVERSE_LANES",),
          "warp": ("QCT_LANE_PROGRAM",),
          "warp_reversed": ("QCT_LANE_PROGRAM", "QCT_REVERSE_LANES")}
# 37 QPs: 19 warps of two QP slots, slot 37 of the last one past the batch.
B = 37
NAN_LANE, INF_LANE = 5, 30  # a NaN in Q, an infinite h


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> (K3b entry, library) of each build, compiled side by side."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("dense_lanes")
    procs = {name: (d / f"libqct_host_{name}.so", defines, subprocess.Popen(
        _build_cmd(d / f"libqct_host_{name}.so", defines),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name, defines in BUILDS.items()}
    out = {}
    vp, ci = ctypes.c_void_p, ctypes.c_int
    for name, (so, defines, proc) in procs.items():
        log, _ = proc.communicate()
        assert proc.returncode == 0, f"{name}:\n{log}"
        lib = ctypes.CDLL(str(so))
        warp = "QCT_LANE_PROGRAM" in defines
        fn = lib.host_dense_polish_warps if warp else lib.host_dense_polish
        fn.argtypes = [vp] * 11 + [ci]
        fn.restype = ci if warp else None
        lib.host_dense_layout.argtypes = [vp]
        lib.host_dense_layout.restype = None
        out[name] = (fn, lib)
    return out


@pytest.fixture(scope="module")
def problem():
    """The kernel's (k, B) inputs: randomized GRF QPs equilibrated by the
    JAX package, one lane poisoned with a NaN in Q and one with an infinite
    h, and the plain barrier's point after 20 and after 3 iterations (the
    poisoned lanes' too)."""
    prob = [a.clone() for a in dense_problem(23, B)["soa"]]
    prob[0][7, NAN_LANE] = float("nan")
    prob[3][3, INF_LANE] = float("inf")
    points = {it: fi._dense_barrier_plain(*prob, iterations=it, tau=0.995)
              for it in (20, 3)}
    return tuple(prob), points


def _run(host, prob, point):
    """K3b through one build: (x, s, z, cert). Outputs start NaN."""
    out = (torch.full((12, B), float("nan")), torch.full((24, B), float("nan")),
           torch.full((24, B), float("nan")), torch.full((B,), float("nan")))
    rc = host[0](*[a.data_ptr() for a in prob],
                 *[a.data_ptr() for a in point],
                 *[o.data_ptr() for o in out], B)
    assert rc in (None, 0), "the lanes of a QP did not wait at one sync"
    return out


def _same(a, b):
    """Equal values (+0 == -0), a NaN equal to any NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _bits(a, b):
    """Bit for bit."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _sweeps_to_certify(prob, point):
    """The sweep at which each QP's certificate is latched (0: never in 8),
    from the plain version run with 1 .. 8 sweeps."""
    first = torch.zeros(B, dtype=torch.int64)
    for k in range(1, fi._POLISH_SWEEPS_PALLAS + 1):
        cert = fi._dense_polish_plain(*prob, *point, sweeps=k)[3]
        first = torch.where((first == 0) & (cert > 0.5), k, first)
    return first


@pytest.mark.parametrize("iterations", [20, 3])
def test_dense_lanes_match_plain_version(hosts, problem, iterations):
    """K3b from the barrier's point (20 or 3 iterations), B = 37 with a NaN
    lane and an inf lane and a QP slot past the batch: x, s, z and cert of
    all four builds equal the plain version's, the builds agree bit for
    bit, and the poisoned lanes are not certified."""
    prob, points = problem
    want = fi._dense_polish_plain(*prob, *points[iterations])
    first = None
    for name in BUILDS:
        got = _run(hosts[name], prob, points[iterations])
        for out, g, w in zip(("x", "s", "z", "cert"), got, want):
            assert _same(g, w), f"{iterations} {name}: {out}"
        if first is None:
            first = got
        for out, g, f in zip(("x", "s", "z", "cert"), got, first):
            assert _bits(g, f), f"{iterations} {name}: {out} vs ascending"
    cert = want[3]
    assert float(cert[NAN_LANE]) == 0.0 and float(cert[INF_LANE]) == 0.0
    # The polish certifies most QPs (fewer from the rough 3-iteration point).
    assert float(cert.mean()) > (0.8 if iterations == 20 else 0.5)


def test_dense_lanes_two_qps_of_a_warp_leave_at_different_sweeps(
        hosts, problem):
    """From the 3-iteration barrier point: in some warp both QPs certify,
    after different numbers of sweeps (the first group runs along while the
    second sweeps on, and must not change its point, certificate or active
    set), and the lane program still equals the plain version and the
    serial build bitwise."""
    prob, points = problem
    first = _sweeps_to_certify(prob, points[3])
    pairs = [(2 * w, 2 * w + 1) for w in range(B // 2)]
    split = [(a, b) for a, b in pairs
             if first[a] > 0 and first[b] > 0 and first[a] != first[b]]
    assert split, "no warp whose two QPs certify at different sweeps"
    want = fi._dense_polish_plain(*prob, *points[3])
    serial = _run(hosts["ascending"], prob, points[3])
    for name in ("warp", "warp_reversed"):
        got = _run(hosts[name], prob, points[3])
        for g, w, s in zip(got, want, serial):
            idx = [i for ab in split for i in ab]
            assert _same(g[..., idx], w[..., idx]), name
            assert _bits(g, s), name


def _layout(hosts):
    a = (ctypes.c_int * 3)()
    hosts["ascending"][1].host_dense_layout(a)
    return kernels.FusedLayout(*a)


@pytest.mark.parametrize("Bn", [1, 37, 1024, 1061, 32768])
def test_dense_geometry_covers_every_qp_once(hosts, Bn):
    """QP slot blockIdx.x * qps_per_block + threadIdx.x // lanes (the
    kernel's own index) over the whole grid, on the build's layout: every
    QP of the batch once, the rest of the slots past B, fewer than a block
    of them; the block's threads within the launch bounds and whole warps,
    its shared memory (every QP's state) within a Hopper block's."""
    layout = _layout(hosts)
    geo = kernels.dense_launch_geometry(Bn, layout)
    assert geo.threads == geo.qps_per_block * layout.lanes
    assert geo.threads <= layout.max_threads and geo.threads % 32 == 0
    assert geo.shared_bytes == geo.qps_per_block * layout.shared_words * 4
    assert geo.shared_bytes <= kernels.SHARED_BYTES_MAX
    slots = (np.arange(geo.blocks)[:, None] * geo.qps_per_block
             + np.arange(geo.threads)[None, :] // layout.lanes)
    lanes = np.bincount(slots.ravel(), minlength=Bn)
    assert (lanes[:Bn] == layout.lanes).all()
    assert 0 <= slots.max() + 1 - Bn < geo.qps_per_block
