"""PyTorch port: the lane split of the dense barrier kernel (K3a) and its
launch geometry, on the CPU.

K3a runs one QP on a group of 16 lanes (csrc/qct_dense_ipm.cuh
``dense_barrier_lanes``, with the lane machinery of csrc/qct_lanes.cuh):
each section of the body runs in every lane for the elements that lane owns
(cone rows, entries of ``M = Q + G^T D G``, rows of the 12 x 12 Cholesky and
of the forward solves), and the lanes meet at a sync. The block stages its
QPs' problems into shared memory first and writes the outputs from there.
tests/torch_port_host_shim.cpp builds the body for the host in three forms:
serial, the lanes of each section in a loop, ascending and descending
(-DQCT_REVERSE_LANES: a lane reading, inside one section, what another lane
of it writes gives other bits); and the lane program (-DQCT_LANE_PROGRAM),
where a warp's 32 lanes (two QP slots, staged and written back by the
warp's 32 threads) are coroutines, each running the card's form of the
body alone from one sync to the next, first to last and last to first (a
missing sync shows, and so do lanes of a QP that do not wait at the same
sync). Every build is held BITWISE to K3a's serial body
(``dense_barrier_instance``, one QP per thread, ``host_dense_barrier``),
NaN payloads and signs of zero included, and to the plain version
``solver/fused_ipm.py::_dense_barrier_plain`` with a correctly rounded
reciprocal square root (equal values, a NaN equal to any NaN); the builds
are held to each other bit for bit. The launch geometry
(kernels.fused_launch_geometry) is plain Python on the build's layout.
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
# A NaN in Q, an infinite h, and a Q whose 2 x 2 leading block is
# indefinite (the Cholesky's second pivot goes non-positive).
NAN_LANE, INF_LANE, PIVOT_LANE = 5, 30, 12
TAU = 0.995


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> (K3a lane entry, library) of each build, compiled side by
    side; the serial body is the ascending build's host_dense_barrier."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("dense_barrier_lanes")
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
        fn = (lib.host_dense_barrier_warps if warp
              else lib.host_dense_barrier_lanes)
        for f in (fn, lib.host_dense_barrier):
            f.argtypes = [vp] * 7 + [ci, ci, ctypes.c_float]
        fn.restype = ci if warp else None
        lib.host_dense_barrier.restype = None
        lib.host_dense_barrier_layout.argtypes = [vp]
        lib.host_dense_barrier_layout.restype = None
        out[name] = (fn, lib)
    return out


def _exact_rsqrt(x):
    # sqrt of a float32 in float64, rounded once to float32: correctly
    # rounded, as the kernel's sqrtf.
    return 1.0 / torch.sqrt(x.double()).float()


def _plain(prob, iterations):
    """The plain version with the kernel's correctly rounded 1 / sqrt."""
    rsqrt, fi._rsqrt = fi._rsqrt, _exact_rsqrt
    try:
        return fi._dense_barrier_plain(*prob, iterations=iterations, tau=TAU)
    finally:
        fi._rsqrt = rsqrt


@pytest.fixture(scope="module")
def problem():
    """The kernel's (k, B) inputs: randomized GRF QPs equilibrated by the
    JAX package, one lane poisoned with a NaN in Q, one with an infinite h,
    and one whose Q has Q_01 = Q_10 = 50 (unit diagonal after
    equilibration)."""
    prob = [a.clone() for a in dense_problem(23, B)["soa"]]
    prob[0][7, NAN_LANE] = float("nan")
    prob[3][3, INF_LANE] = float("inf")
    prob[0][1, PIVOT_LANE] = 50.0
    prob[0][12, PIVOT_LANE] = 50.0
    return tuple(prob)


def _run(fn, prob, iterations):
    """K3a through one entry: (x, s, z). Outputs start NaN."""
    out = tuple(torch.full((k, B), float("nan")) for k in (12, 24, 24))
    rc = fn(*[a.data_ptr() for a in prob], *[o.data_ptr() for o in out], B,
            iterations, TAU)
    assert rc in (None, 0), "the lanes of a QP did not wait at one sync"
    return out


ITERATIONS = (1, 3, 20)


@pytest.fixture(scope="module")
def outputs(hosts, problem):
    """iterations -> (serial body, plain version, {build: (x, s, z)})."""
    out = {}
    for it in ITERATIONS:
        serial = _run(hosts["ascending"][1].host_dense_barrier, problem, it)
        out[it] = (serial, _plain(problem, it),
                   {name: _run(hosts[name][0], problem, it)
                    for name in BUILDS})
    return out


def _same(a, b):
    """Equal values (+0 == -0), a NaN equal to any NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _bits(a, b):
    """Bit for bit."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("iterations", ITERATIONS)
def test_dense_barrier_lanes_match_serial_body_and_plain_version(
        outputs, iterations):
    """B = 37 (a QP slot past the batch) with a NaN lane, an inf lane and a
    lane whose Cholesky pivot goes non-positive: x, s, z of all four builds
    are bitwise the serial body's and each other's, and equal the plain
    version's; the serial body equals the plain version too."""
    serial, want, builds = outputs[iterations]
    for out, g, w in zip("xsz", serial, want):
        assert _same(g, w), f"serial body vs plain version: {out}"
    for name, got in builds.items():
        for out, g, s, w in zip("xsz", got, serial, want):
            assert _bits(g, s), f"{iterations} {name}: {out} vs serial body"
            assert _same(g, w), f"{iterations} {name}: {out} vs plain"
    # The poisoned lanes keep their start point (the first iterate is the
    # best one whose x is finite); every other lane is finite.
    x = serial[0]
    for lane in (NAN_LANE, PIVOT_LANE):
        assert bool((x[:, lane] == 0).all()), lane
    rest = [i for i in range(B) if i not in (NAN_LANE, INF_LANE, PIVOT_LANE)]
    for a in serial:
        assert bool(torch.isfinite(a[:, rest]).all())


def test_the_pivot_lane_has_a_nonpositive_pivot(problem):
    """At the start point (x = 0, s = max(h, 1), z = 1 / s) the poisoned
    lane's M + delta I has a non-positive second Cholesky pivot, and the
    other lanes none: the factor's NaN path runs in one lane only."""
    Q, c, G, h = (a.double().numpy() for a in problem)
    Q, G = Q.reshape(12, 12, B), G.reshape(24, 12, B)
    s = np.maximum(h, 1.0)
    d = np.minimum((1.0 / s) / s, 1.0 / np.finfo(np.float32).eps)
    piv = []
    for b in range(B):
        if b in (NAN_LANE, INF_LANE):
            continue
        M = Q[:, :, b] + G[:, :, b].T @ (d[:, b, None] * G[:, :, b])
        M = M + 100 * np.finfo(np.float32).eps * M.diagonal().max() * np.eye(12)
        piv.append((b, M[1, 1] - M[0, 1] ** 2 / M[0, 0]))
    assert [b for b, p in piv if p <= 0] == [PIVOT_LANE]


def test_a_warp_whose_qps_freeze_at_different_iterations(outputs, problem):
    """Some warp holds a QP whose iterate stops moving by iteration 12 (its
    freeze test holds: it takes zero steps from then on, so its best point
    after 12 and after 20 iterations are the same bits) and a QP whose best
    point still moves after iteration 12; K3a has no early exit, so the
    frozen QP runs along, and both QPs of the warp are bitwise the serial
    body in every build."""
    serial, late, builds = outputs[20]
    early = _plain(problem, 12)
    frozen = [all(_bits(a[:, i], b[:, i]) for a, b in zip(early, late))
              for i in range(B)]
    pairs = [(2 * w, 2 * w + 1) for w in range(B // 2)]
    split = [(a, b) for a, b in pairs
             if frozen[a] != frozen[b]
             and not {a, b} & {NAN_LANE, INF_LANE, PIVOT_LANE}]
    assert split, "no warp whose two QPs freeze at different iterations"
    idx = [i for ab in split for i in ab]
    for name in ("warp", "warp_reversed"):
        for g, s in zip(builds[name], serial):
            assert _bits(g[:, idx], s[:, idx]), name


def _layout(hosts):
    a = (ctypes.c_int * 3)()
    hosts["ascending"][1].host_dense_barrier_layout(a)
    return kernels.FusedLayout(*a)


@pytest.mark.parametrize("Bn", [1, 37, 1024, 1061, 32768])
def test_dense_barrier_geometry_covers_every_qp_once(hosts, Bn):
    """QP slot blockIdx.x * qps_per_block + threadIdx.x // lanes (the
    kernel's own index) over the whole grid, on the build's layout: every
    QP of the batch once, the rest of the slots past B, fewer than a block
    of them; the block's threads within the launch bounds and whole warps,
    its shared memory (every QP's state) within a Hopper block's."""
    layout = _layout(hosts)
    assert layout.lanes == 16 and layout.shared_words % 32 == 16
    geo = kernels.fused_launch_geometry(Bn, layout)
    assert geo.threads == geo.qps_per_block * layout.lanes
    assert geo.threads <= layout.max_threads and geo.threads % 32 == 0
    assert geo.shared_bytes == geo.qps_per_block * layout.shared_words * 4
    assert geo.shared_bytes <= kernels.SHARED_BYTES_MAX
    slots = (np.arange(geo.blocks)[:, None] * geo.qps_per_block
             + np.arange(geo.threads)[None, :] // layout.lanes)
    lanes = np.bincount(slots.ravel(), minlength=Bn)
    assert (lanes[:Bn] == layout.lanes).all()
    assert 0 <= slots.max() + 1 - Bn < geo.qps_per_block
