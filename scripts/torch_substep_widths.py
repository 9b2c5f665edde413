#!/usr/bin/env python3
"""Time K5, the whole-body substep kernel of the PyTorch port, at three lane
group widths on one NVIDIA Hopper card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_substep_widths.py

K5 runs one robot on a group of QS_G lanes; the width is a build-time choice
(``QS_G`` in ``quadruped_control_tpu_torch/csrc/qct_substep.cuh``, 8 in the
port's build). For 4, 8 and 16 lanes this compiles the kernel's sources into
a library of its own (under ``quadruped_control_tpu_torch/_build/widths/``,
with the port's flags), launches its K5 on the balance tick's configuration
(``mit_cheetah_physical_config``, the articulated-leg model, the torque map
with gravity compensation, the factor built in the kernel, anchor stiction)
at B = 4096 on seeded mid-walk states with the feet on the ground, 10
substeps, fails unless every width's new states are bitwise those of the
serial body (``qct_substep_serial``, one robot per thread; also with a
NaN-velocity lane and a 1e6 one, and at a ragged B = 1061), and prints the
CUDA-event time per launch (20 launches after a warm-up), the serial body's
time, the blocks resident per SM, registers and stack, and the card's name
and power limit. The widths run in turns (serial, 4, 8, 16, 16, 8, 4,
serial), in one process; then the port's width and the serial body at 0
(the torque map and factor alone), 1, 5, 10 and 20 substeps. Every timed
launch has its arguments made ahead, so that the host's share of a launch
(a few microseconds) stays below its device time. Last, a fourth build at 8
lanes with -DQCT_CLOCKS prints the cycles of each lane section of one robot
(thread 0 of block 0) over a 10-substep launch: where the kernel's time
goes.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import (  # noqa: E402
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.sim import (  # noqa: E402
    ContactConfig,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim import fused_substep as fsub  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    walk_state_comps,
    whole_body_walk_states,
)

WIDTHS = (4, 8, 16)
B = 4096
N_SUBSTEPS = 10
REPS = 20
SEED = 50


def build(width, out_dir, clocks=False):
    """Start nvcc on K5's sources (and the occupancy and error entries) for
    one width (with the per-section clocks: -DQCT_CLOCKS); returns (library
    path, process)."""
    lib = out_dir / f"libqct_substep_{width}{'_clocks' if clocks else ''}.so"
    cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared",
           f"-DQS_G={width}", "-Xptxas", "-v", "-o", str(lib)] + (
               ["-DQCT_CLOCKS"] if clocks else []) + [
               str(kernels._CSRC / f) for f in (
                   "qct_substep.cu", "qct_mpc.cu", "qct_assemble.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    prm = ctypes.POINTER(kernels.SubstepParams)
    lib.qct_substep.argtypes = [vp] * 6 + [ci, ci, ctypes.c_float, prm, ci,
                                           ci, ci, vp]
    lib.qct_substep.restype = ci
    lib.qct_substep_serial.argtypes = [vp] * 6 + [ci, ci, ctypes.c_float,
                                                  prm, vp]
    lib.qct_substep_serial.restype = ci
    lib.qct_substep_layout.argtypes = [vp]
    lib.qct_substep_layout.restype = ci
    lib.qct_substep_fn.argtypes = []
    lib.qct_substep_fn.restype = vp
    lib.qct_occupancy.argtypes = [vp, ci, ci, vp]
    lib.qct_occupancy.restype = ci
    return lib


def launch(lib, state, extras, params, h, serial=False):
    """One K5 launch of this library (or of its serial body): the new
    states, and the launch geometry (None for the serial body)."""
    Bn = state.shape[1]
    out = torch.empty((58, Bn), device="cuda")
    ptrs = [state.data_ptr()] + [a.data_ptr() for a in extras] + [None]
    stream = torch.cuda.current_stream().cuda_stream
    if serial:
        rc = lib.qct_substep_serial(*ptrs, out.data_ptr(), Bn, N_SUBSTEPS, h,
                                    ctypes.byref(params), stream)
        geo = None
    else:
        lay = (ctypes.c_int * 3)()
        lib.qct_substep_layout(lay)
        geo = kernels.substep_launch_geometry(Bn, kernels.MpcLayout(*lay))
        rc = lib.qct_substep(*ptrs, out.data_ptr(), Bn, N_SUBSTEPS, h,
                             ctypes.byref(params), geo.blocks, geo.threads,
                             geo.shared_bytes, stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return out, geo


def lean(lib, state, extras, params, h, n=N_SUBSTEPS, serial=False):
    """The same launch with every argument made ahead, for timing: a
    callable that makes only the library call (a few microseconds of the
    host's time, below a launch's device time)."""
    Bn = state.shape[1]
    out = torch.empty((58, Bn), device="cuda")
    ptrs = ([state.data_ptr()] + [a.data_ptr() for a in extras]
            + [None, out.data_ptr()])
    stream = torch.cuda.current_stream().cuda_stream
    prm = ctypes.byref(params)
    if serial:
        return lambda: lib.qct_substep_serial(*ptrs, Bn, n, h, prm, stream)
    lay = (ctypes.c_int * 3)()
    lib.qct_substep_layout(lay)
    geo = kernels.substep_launch_geometry(Bn, kernels.MpcLayout(*lay))
    return lambda: lib.qct_substep(*ptrs, Bn, n, h, prm, geo.blocks,
                                   geo.threads, geo.shared_bytes, stream)


def inputs(cfg):
    """Mid-walk states with the feet on the ground and random GRFs, swing
    torques and stance flags (chip_smoke.py's phase 6 inputs)."""
    rng = np.random.default_rng(SEED)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).cuda()

    state = dev(walk_state_comps(
        whole_body_walk_states(SEED, B, cfg, on_ground=True)))
    fw = rng.uniform(-5.0, 5.0, (12, B))
    fw[2::3] = rng.uniform(10.0, 40.0, (4, B))
    extras = (dev(fw), dev(rng.uniform(-3.0, 3.0, (12, B))),
              dev(rng.uniform(size=(4, B)) < 0.7))
    return state, extras


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    out_dir = kernels._BUILD_ROOT / "widths"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {w: build(w, out_dir) for w in WIDTHS}
    procs["clocks"] = build(8, out_dir, clocks=True)
    libs = {}
    for w, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {w} lanes:\n{log}")
        for line in log.splitlines():
            if "qct_substep" in line or "registers" in line:
                print(f"  [{w} lanes] {line.strip()}")
        libs[w] = load(path)
    clk = libs.pop("clocks")
    clk.qct_substep_clocks.argtypes = [ctypes.c_void_p]
    clk.qct_substep_clocks.restype = ctypes.c_int

    cfg = mit_cheetah_physical_config()
    model = mit_cheetah_whole_body_model(cfg)
    stepper = fsub.make_fused_stepper(model, cfg, ContactConfig(),
                                      prefactor="kernel", torque_input="qp",
                                      gravity_comp=True)
    params = kernels.substep_params(stepper.consts)
    h = 1.0 / cfg.frequency / N_SUBSTEPS
    state, extras = inputs(cfg)
    bad = state.clone()
    bad[18, 0] = float("nan")
    bad[19, 1] = 1.0e6
    ragged = (bad[:, :1061].contiguous(),
              tuple(a[:, :1061].contiguous() for a in extras))
    cases = {"B = 4096": (state, extras), "poisoned lanes": (bad, extras),
             "ragged B = 1061": ragged}
    ref = libs[8]
    for w, lib in libs.items():
        for what, (st, ex) in cases.items():
            got, _ = launch(lib, st, ex, params, h)
            want, _ = launch(ref, st, ex, params, h, serial=True)
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                raise SystemExit(f"{w} lanes, {what}: not bitwise the serial "
                                 f"body")
    print("every width bitwise the serial body (B = 4096, poisoned lanes, "
          "ragged B = 1061)")

    def timed(fn):
        fn()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(REPS):
            fn()
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / REPS

    order = ["serial"] + list(WIDTHS) + list(WIDTHS)[::-1] + ["serial"]
    for w in order:
        if w == "serial":
            ms = timed(lean(ref, state, extras, params, h, serial=True))
            print(f"serial body (one robot per thread), B = {B}: {ms:.4f} "
                  f"ms per launch")
            continue
        lib = libs[w]
        _, geo = launch(lib, state, extras, params, h)
        ms = timed(lean(lib, state, extras, params, h))
        occ = (ctypes.c_int * 3)()
        rc = lib.qct_occupancy(lib.qct_substep_fn(), geo.threads,
                               geo.shared_bytes, occ)
        if rc != 0:
            raise SystemExit(f"occupancy query failed: {rc}")
        print(f"{w:2d} lanes a robot ({geo.robots_per_block} robots, "
              f"{geo.threads} threads, {geo.shared_bytes} B a block), B = "
              f"{B}: {ms:.4f} ms per launch; {occ[0]} blocks per SM, "
              f"{occ[1]} registers, {occ[2]} B of stack")
    # Where the time goes at the port's width: the prologue (torque map and
    # factor) alone, then per substep.
    for n in (0, 1, 5, N_SUBSTEPS, 2 * N_SUBSTEPS):
        ms = timed(lean(ref, state, extras, params, h, n))
        ser = timed(lean(ref, state, extras, params, h, n, serial=True))
        print(f" 8 lanes, {n:2d} substeps: {ms:.4f} ms per launch (serial "
              f"body {ser:.4f} ms)")
    # The sections' cycles (thread 0 of block 0, -DQCT_CLOCKS): each
    # section's line in the header, its first statement, its share.
    cyc = (ctypes.c_ulonglong * 2048)()
    launch(clk, state, extras, params, h)
    torch.cuda.synchronize()
    clk.qct_substep_clocks(cyc)
    launch(clk, state, extras, params, h)
    torch.cuda.synchronize()
    if clk.qct_substep_clocks(cyc) != 0:
        raise SystemExit("reading the section clocks failed")
    src = (kernels._CSRC / "qct_substep.cuh").read_text().splitlines()
    total = sum(cyc)
    print(f" 8 lanes, {N_SUBSTEPS} substeps, sections of one robot (thread 0 "
          f"of block 0, -DQCT_CLOCKS): {total} cycles in all")
    for line in range(2048):
        if cyc[line]:
            print(f"   line {line:4d} {src[line].strip()[:48]:48s} "
                  f"{cyc[line]:7d} cycles {100.0 * cyc[line] / total:5.1f} %")
    print(smi)


if __name__ == "__main__":
    main()
