"""PyTorch port: the lane split of the fused GRF-QP kernel (K1) and its
launch geometry, on the CPU.

K1 runs one QP on a group of 16 lanes (csrc/qct_fused.cuh): each section of
the body runs in every lane for the elements that lane owns, and the lanes
meet at a sync. tests/torch_port_host_shim.cpp builds the body for the host
in three forms: serial, the lanes of each section in a loop, ascending and
descending (-DQCT_REVERSE_LANES: a lane reading, inside one section, what
another lane of it writes gives other bits); and the lane program
(-DQCT_LANE_PROGRAM), where a warp's 32 lanes (two QP slots) are coroutines,
each running the card's form of the body alone from one sync to the next,
first to last and last to first (a missing sync shows, and so do lanes of a
QP that do not wait at the same sync). Every form is held BITWISE to the
plain version ``solver/fused.py::_fused_plain`` in every mode of the kernel,
with the plain version's reciprocal square root correctly rounded as the
kernel's ``1.0f / sqrtf`` is (``torch.sqrt`` on the CPU is not, in a few
lanes in 1e3): equal values, as ``torch.equal`` compares them (the plain
version's ``clamp(a z, min=0)`` keeps a -0 where the kernel's ``qmax``
gives +0), and a NaN equal to any NaN (the poisoned lanes' residuals). The
four builds are held to each other bit for bit, NaN payloads and signs of
zero included. The launch geometry (kernels.fused_launch_geometry)
is plain Python on the build's layout.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from quadruped_control_tpu_torch import kernels
from quadruped_control_tpu_torch.config import mit_cheetah_config
from quadruped_control_tpu_torch.solver import fused as pf
from torch_port_helpers import numpy_scenarios, torch_scenarios

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "quadruped_control_tpu_torch" / "csrc"
BAL = mit_cheetah_config().balance
KW = dict(s_diag=tuple(BAL.s_diag), w_diag=float(BAL.w_diag))
# The shim's builds: defines of each.
BUILDS = {"ascending": (), "reversed": ("QCT_REVERSE_LANES",),
          "warp": ("QCT_LANE_PROGRAM",),
          "warp_reversed": ("QCT_LANE_PROGRAM", "QCT_REVERSE_LANES")}
# 37 QPs: 19 warps of two QP slots, slot 37 of the last one past the batch.
B = 37
NAN_LANE, INF_LANE = 5, 9  # a NaN lever, an infinite SRB right-hand side


def _build_cmd(out, defines):
    return (["g++", *(f"-D{d}" for d in defines), "-std=c++17", "-O2",
             "-ffp-contract=off", "-fPIC", "-shared", "-x", "c++",
             f"-I{CSRC}", str(ROOT / "tests" / "torch_port_host_shim.cpp"),
             "-o", str(out)])


@pytest.fixture(scope="module")
def hosts(tmp_path_factory):
    """name -> (K1 entry, library) of each build, compiled side by side."""
    if shutil.which("g++") is None:
        pytest.skip("needs a host C++ compiler (g++)")
    d = tmp_path_factory.mktemp("fused_lanes")
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
        fn = lib.host_fused_solve_warps if warp else lib.host_fused_solve
        fn.argtypes = [vp] * 15 + [ci, ctypes.POINTER(kernels.FusedParams)]
        fn.restype = ci if warp else None
        lib.host_fused_layout.argtypes = [vp]
        lib.host_fused_layout.restype = None
        out[name] = (fn, lib)
    return out


@pytest.fixture(scope="module")
def problem():
    """The kernel's (k, B) inputs from randomized scenarios (mass, inertia
    and friction per QP), one lane poisoned with a NaN lever and one with
    an infinite right-hand side."""
    d = numpy_scenarios(31, B, randomize=True, dtype=np.float32)
    s = torch_scenarios(d, torch.float32)
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, BAL, mass=s.mass, inertia_diag=s.inertia_diag)
    inp = [a.contiguous() for a in pf._prep_inputs(
        rm, b, s.stance, s.mu, BAL.fz_min, BAL.fz_max)]
    inp[0][0, NAN_LANE] = float("nan")
    inp[1][2, INF_LANE] = float("inf")
    return tuple(inp)


def _exact_rsqrt(x):
    # sqrt of a float32 in float64, rounded once to float32: correctly
    # rounded, as the kernel's sqrtf.
    return 1.0 / torch.sqrt(x.double()).float()


def _run(host, inp, warm, sched):
    """K1 through one build: (x, s, z, diag, work). Outputs start NaN."""
    x, s, z, diag = (torch.full((k, B), float("nan")) for k in (12, 24, 24, 6))
    work = torch.full((2, B), -1, dtype=torch.int32)
    psw = (sched.polish_sweeps if sched.prox_sweeps is None
           else sched.prox_sweeps)
    p = kernels._params(
        sched.s_diag, sched.w_diag, sched.swing_relax, tau=sched.tau,
        tol=sched.tol, prox_rho=sched.prox_rho, iterations=sched.iterations,
        polish=int(sched.polish), sweeps=sched.polish_sweeps,
        refine=sched.polish_refine, multi_swap=int(sched.polish_multi_swap),
        warm_mode=len(warm), prox_steps=sched.prox_steps,
        prox_iterations=sched.prox_iterations, prox_sweeps=psw,
        prox_cold=int(sched.prox_cold), ff_refine=int(sched.ff_refine))
    wp = [a.data_ptr() for a in warm] + [None] * (4 - len(warm))
    rc = host[0](*[a.data_ptr() for a in inp], *wp, x.data_ptr(),
                 s.data_ptr(), z.data_ptr(), diag.data_ptr(),
                 work.data_ptr(), B, ctypes.byref(p))
    assert rc in (None, 0), "the lanes of a QP did not wait at one sync"
    return x, s, z, diag, work


def _same(a, b):
    """Equal values (+0 == -0), a NaN equal to any NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _bits(a, b):
    """Bit for bit."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


# name -> (warm start, schedule). "bar" is the barrier-only solve's point;
# "flip" adds st_prev with a third of the stance bits flipped (those legs'
# cone rows restart cold).
MODES = {
    "barrier-only": (None, dict(iterations=20, polish=False)),
    "full": (None, dict(iterations=20, polish_sweeps=2)),
    "polish-only": ("bar", dict(iterations=0, polish_sweeps=4)),
    "warm-barrier": ("flip", dict(iterations=6, polish_sweeps=8)),
    "prox": ("bar", dict(iterations=0, polish_sweeps=2, prox_steps=2,
                         prox_iterations=10, prox_sweeps=3)),
    "prox-cold": ("bar", dict(iterations=0, polish_sweeps=1, prox_steps=1,
                              prox_iterations=8, prox_sweeps=2,
                              prox_cold=True)),
    "ff-refine-off": (None, dict(iterations=10, polish_sweeps=4,
                                 ff_refine=False)),
    "multi-swap": (None, dict(iterations=10, polish_sweeps=4,
                              polish_multi_swap=True)),
}


@pytest.fixture(scope="module")
def warm_points(hosts, problem):
    bar = _run(hosts["ascending"], problem, (),
               pf.FusedSchedule(**KW, iterations=20, polish=False))
    st_prev = problem[2].clone()
    st_prev[:, ::3] = 1.0 - st_prev[:, ::3]
    return {"bar": bar[:3], "flip": (*bar[:3], st_prev)}


@pytest.mark.parametrize("mode", list(MODES))
def test_fused_lanes_match_plain_version(hosts, problem, warm_points, mode,
                                         monkeypatch):
    """Each of K1's modes, B = 37 with a NaN lane and an inf lane and a QP
    slot past the batch: x, s, z and diag of all four builds equal the
    plain version's (correctly rounded rsqrt), the builds agree bit for bit
    (with the work counters: barrier iterations and polish sweeps run), and
    the poisoned lanes are not certified."""
    warm_key, kw = MODES[mode]
    warm = () if warm_key is None else warm_points[warm_key]
    sched = pf.FusedSchedule(**KW, **kw)
    monkeypatch.setattr(pf, "_rsqrt", _exact_rsqrt)
    want = pf._fused_plain(*problem, warm if warm else None, sched)
    first = None
    for name in BUILDS:
        got = _run(hosts[name], problem, warm, sched)
        for out, g, w in zip(("x", "s", "z", "diag"), got, want):
            assert _same(g, w), f"{mode} {name}: {out}"
        if first is None:
            first = got
        for out, g, f in zip(("x", "s", "z", "diag", "work"), got, first):
            assert _bits(g, f), f"{mode} {name}: {out} vs ascending"
    diag = want[3]
    assert float(diag[0, NAN_LANE]) == 0.0 and float(diag[0, INF_LANE]) == 0.0
    assert bool(torch.isfinite(want[0][:, [0, 1, 2, 3]]).all())
    if kw.get("polish", True):
        assert float(diag[0].mean()) > 0.5  # the polish certifies most QPs


def test_fused_lanes_two_qps_of_a_warp_leave_at_different_sweeps(
        hosts, problem, warm_points):
    """The warm barrier's polish: in some warp both QPs certify, after
    different numbers of sweeps (the first group leaves the sweep loop while
    the second sweeps on), and the lane program still agrees with the
    serial build bitwise."""
    warm_key, kw = MODES["warm-barrier"]
    sched = pf.FusedSchedule(**KW, **kw)
    serial = _run(hosts["ascending"], problem, warm_points[warm_key], sched)
    cert, sweeps = serial[3][0], serial[4][1]
    pairs = [(2 * w, 2 * w + 1) for w in range(B // 2)]
    split = [(a, b) for a, b in pairs
             if cert[a] == 1.0 and cert[b] == 1.0 and sweeps[a] != sweeps[b]]
    assert split, "no warp whose two QPs certify at different sweeps"
    for name in ("warp", "warp_reversed"):
        got = _run(hosts[name], problem, warm_points[warm_key], sched)
        for g, w in zip(got, serial):
            assert _bits(g, w), name


def _layout(hosts):
    a = (ctypes.c_int * 3)()
    hosts["ascending"][1].host_fused_layout(a)
    return kernels.FusedLayout(*a)


@pytest.mark.parametrize("Bn", [1, 37, 1024, 4095, 4096, 32768])
def test_fused_geometry_covers_every_qp_once(hosts, Bn):
    """QP slot blockIdx.x * qps_per_block + threadIdx.x // lanes (the
    kernel's own index) over the whole grid, on the build's layout: every
    QP of the batch once, the rest of the slots past B, fewer than a block
    of them."""
    layout = _layout(hosts)
    geo = kernels.fused_launch_geometry(Bn, layout)
    assert geo.threads == geo.qps_per_block * layout.lanes
    slots = (np.arange(geo.blocks)[:, None] * geo.qps_per_block
             + np.arange(geo.threads)[None, :] // layout.lanes)
    lanes = np.bincount(slots.ravel(), minlength=Bn)
    assert (lanes[:Bn] == layout.lanes).all()
    assert 0 <= slots.max() + 1 - Bn < geo.qps_per_block


def test_fused_block_fits_build_and_card(hosts):
    """The build's block: its threads within the kernels' launch bounds and
    whole warps, its shared memory (every QP's state) within the 227 KB of
    a Hopper block; a build whose QP state would overflow it is refused,
    not launched."""
    layout = _layout(hosts)
    geo = kernels.fused_launch_geometry(4096, layout)
    assert geo.threads <= layout.max_threads and geo.threads % 32 == 0
    assert geo.shared_bytes == geo.qps_per_block * layout.shared_words * 4
    assert geo.shared_bytes <= kernels.SHARED_BYTES_MAX
    words = kernels.SHARED_BYTES_MAX // (4 * geo.qps_per_block)
    with pytest.raises(ValueError, match="shared memory"):
        kernels.fused_launch_geometry(
            4096, layout._replace(shared_words=words + 1))
    kernels.fused_launch_geometry(4096, layout._replace(shared_words=words))
