#!/usr/bin/env python3
"""Time K4, the commander-pre kernel of the PyTorch port, at two lane group
widths and three block sizes on one NVIDIA Hopper card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_commander_widths.py

K4 runs one control instance on a group of QC_G lanes, one leg a lane
(``commander_lanes`` in ``quadruped_control_tpu_torch/csrc/
qct_commander.cuh``); the width and the block size are build-time choices
(QC_G, QC_THREADS). For 4 and 2 lanes an instance at blocks of 32, 64 and
128 threads, this compiles the kernel's source into a library of its own
(under ``quadruped_control_tpu_torch/_build/commander_widths/``, with the
port's flags), and launches it on seeded mid-walk states and commander carries
(``whole_body_walk_states``, ``commander_carry_walk``; the balance tick's
``mit_cheetah_physical_config``) with contact_gate 0 and 0.01, without and
with the MPC block (N = 8, 0.03 s), at B = 4096 and at a ragged B = 1061
whose lanes include a NaN state, an inf command and a singular Jacobian. It
fails unless every variant's outputs are bitwise those of the serial body
(``qct_commander_serial``, one instance per thread; a NaN equal to any NaN),
and prints each one's device time per launch through a CUDA graph (50
launches captured, replayed), the serial body's, the blocks resident per SM,
registers and stack of each build, and the card's name and power limit. The
variants run in turns (serial, each variant, each in reverse order, serial)
in one process. Last, a build of the port's choice with -DQCT_CLOCKS prints
the cycles of each section of one instance's lane 0 (thread 0 of block 0):
the prefix, the steps of its leg, the right-hand side, the MPC block.
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
from quadruped_control_tpu_torch.control import (  # noqa: E402
    fused_commander as fcmd,
)
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    commander_carry_walk,
    walk_carry_comps,
    walk_state_comps,
    whole_body_walk_states,
)

# (lanes per instance, threads a block)
VARIANTS = [(g, t) for g in (4, 2) for t in (32, 64, 128)]
CLOCKS = (4, 64)
# (contact_gate, mpc_horizon)
OPTIONS = [(0.0, 0), (0.01, 0), (0.0, 8), (0.01, 8)]
MPC_DT = 0.03
BATCHES = (4096, 1061)
REPS = 50
SEED = 20


def _name(v):
    return f"{v[0]} lanes, {v[1]:3d} threads"


def build(out_dir):
    """nvcc: the shared objects once (the occupancy query and the error
    string), K4 for each variant and the clocks build; then one library per
    variant. Returns {variant or "clocks": library path}; prints each
    build's resource report of the K4 kernels."""
    nvcc = kernels._nvcc()
    flags = [*kernels._NVCC_FLAGS, "-Xptxas", "-v", "-c"]
    procs = {}
    for src in ("qct_mpc.cu", "qct_assemble.cu"):
        procs[src] = (out_dir / (Path(src).stem + ".o"), [
            nvcc, *flags, str(kernels._CSRC / src)])
    jobs = {v: [f"-DQC_G={v[0]}", f"-DQC_THREADS={v[1]}"]
            for v in VARIANTS}
    jobs["clocks"] = [f"-DQC_G={CLOCKS[0]}", f"-DQC_THREADS={CLOCKS[1]}",
                      "-DQCT_CLOCKS"]
    for k, (key, defs) in enumerate(jobs.items()):
        procs[key] = (out_dir / f"qct_commander_{k}.o", [
            nvcc, *flags, *defs, str(kernels._CSRC / "qct_commander.cu")])
    running = {key: (obj, subprocess.Popen(
        cmd + ["-o", str(obj)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True))
        for key, (obj, cmd) in procs.items()}
    objs = {}
    for key, (obj, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        objs[key] = obj
        if key in jobs:
            keep = False
            for line in log.splitlines():
                if "Compiling entry function" in line:
                    keep = "commander" in line
                if keep and ("registers" in line or "stack frame" in line):
                    label = key if key == "clocks" else _name(key)
                    print(f"  [{label}] {line.strip()}")
    libs = {}
    for key in jobs:
        lib = out_dir / f"libqct_commander_{list(jobs).index(key)}.so"
        link = subprocess.run(
            [nvcc, "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
             str(objs[key]), str(objs["qct_mpc.cu"]),
             str(objs["qct_assemble.cu"])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise SystemExit(f"link failed for {key}:\n{link.stdout}")
        libs[key] = lib
    return libs


def load(path, clocks=False):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    prm = ctypes.POINTER(kernels.CommanderParams)
    lib.qct_commander_pre.argtypes = [vp] * 13 + [ci, prm, ci, ci, vp]
    lib.qct_commander_pre.restype = ci
    lib.qct_commander_serial.argtypes = [vp] * 13 + [ci, prm, vp]
    lib.qct_commander_serial.restype = ci
    lib.qct_commander_serial_block.argtypes = [ci]
    lib.qct_commander_serial_block.restype = ci
    lib.qct_commander_layout.argtypes = [vp]
    lib.qct_commander_layout.restype = ci
    for fn in ("qct_commander_fn", "qct_commander_serial_fn"):
        getattr(lib, fn).argtypes = []
        getattr(lib, fn).restype = vp
    lib.qct_occupancy.argtypes = [vp, ci, ci, vp]
    lib.qct_occupancy.restype = ci
    if clocks:
        lib.qct_commander_clocks.argtypes = [vp]
        lib.qct_commander_clocks.restype = ci
    return lib


def geometry(lib, B):
    lay = (ctypes.c_int * 2)()
    lib.qct_commander_layout(lay)
    return kernels.commander_geometry(B, kernels.CommanderLayout(*lay))


def launch(lib, inp, params, serial=False):
    """One K4 launch of this library (or of its serial body) on inp =
    (state, carry, cmd): the output slab."""
    state, carry, cmd = inp
    B = state.shape[1]
    rows = kernels._CMD_OUT_ROWS + (
        (25 + 17 * params.mpc_horizon,) if params.mpc_horizon else ())
    slab = torch.empty((sum(rows), B), device="cuda")
    ptrs = [o.data_ptr() for o in torch.split(slab, rows)]
    ptrs += [None] * (10 - len(ptrs))
    args = (state.data_ptr(), carry.data_ptr(), cmd.data_ptr(), *ptrs, B,
            ctypes.byref(params))
    stream = torch.cuda.current_stream().cuda_stream
    if serial:
        rc = lib.qct_commander_serial(*args, stream)
    else:
        geo = geometry(lib, B)
        rc = lib.qct_commander_pre(*args, geo.blocks, geo.threads, stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return slab


def graph_ms(fn):
    """Device time of one call of ``fn``: REPS calls captured in one CUDA
    graph, the graph replayed once to warm up and once timed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / REPS


def inputs(cfg):
    """(state, carry, cmd) at each batch size: seeded mid-walk states and
    carries; at the ragged batch, lane 3 has a NaN body rate and thigh
    angle, lane 17 an infinite command, lane 29 a base 3 m up with straight
    knees (its Jacobian at q_ref singular)."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).cuda()

    out = {}
    for B in BATCHES:
        d = whole_body_walk_states(SEED + B, B, cfg)
        state, cmd = dev(walk_state_comps(d)), dev(d["cmd"].T)
        carry = dev(walk_carry_comps(commander_carry_walk(SEED, B, cfg)))
        if B != 4096:
            state[13, 3] = float("nan")
            state[34, 3] = float("nan")
            cmd[0, 17] = float("inf")
            state[11, 29] = 3.0
            state[[32, 35, 38, 41], 29] = 0.0
        out[B] = (state, carry, cmd)
    return out


def bitwise(a, b):
    return bool(((a.view(torch.int32) == b.view(torch.int32))
                 | (a.isnan() & b.isnan())).all())


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    out_dir = kernels._BUILD_ROOT / "commander_widths"
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = build(out_dir)
    libs = {v: load(paths[v]) for v in VARIANTS}
    clk = load(paths["clocks"], clocks=True)
    ref = libs[VARIANTS[0]]

    cfg = mit_cheetah_physical_config()
    consts = fcmd.CommanderConsts(cfg, 1.0 / cfg.frequency)
    params = {o: consts.params(o[0], False, o[1], MPC_DT if o[1] else 0.0)
              for o in OPTIONS}
    inp = inputs(cfg)
    for v, lib in libs.items():
        for o in OPTIONS:
            for B in BATCHES:
                got = launch(lib, inp[B], params[o])
                want = launch(ref, inp[B], params[o], serial=True)
                if not bitwise(got, want):
                    raise SystemExit(f"{_name(v)}, gate {o[0]}, N {o[1]}, B "
                                     f"{B}: not bitwise the serial body")
    print("every variant bitwise the serial body (gate 0 / 0.01, N 0 / 8, "
          "B = 4096 and the ragged poisoned B = 1061)")

    times = {}
    order = ["serial"] + VARIANTS + VARIANTS[::-1] + ["serial"]
    for v in order:
        for o in OPTIONS:
            for B in BATCHES:
                ms = graph_ms(lambda: launch(
                    ref if v == "serial" else libs[v], inp[B], params[o],
                    serial=v == "serial"))
                times.setdefault((v, o, B), []).append(ms)
    cols = [f"g{o[0]:g} N{o[1]} B{B}" for o in OPTIONS for B in BATCHES]
    print(f"ms per launch through a CUDA graph ({REPS} launches), two turns:")
    print(f"  {'':32s}" + "".join(f"{c:>22s}" for c in cols))
    for v in ["serial"] + VARIANTS:
        label = "serial body" if v == "serial" else _name(v)
        cells = []
        for o in OPTIONS:
            for B in BATCHES:
                a, b = times[(v, o, B)]
                cells.append(f"{a:.4f} / {b:.4f}")
        print(f"  {label:32s}" + "".join(f"{c:>22s}" for c in cells))
    for v in [None] + VARIANTS:
        lib = ref if v is None else libs[v]
        for B in BATCHES:
            occ = (ctypes.c_int * 3)()
            if v is None:
                threads = lib.qct_commander_serial_block(B)
                fn = lib.qct_commander_serial_fn()
                blocks = -(-B // threads)
            else:
                geo = geometry(lib, B)
                threads, blocks, fn = geo.threads, geo.blocks, \
                    lib.qct_commander_fn()
            if lib.qct_occupancy(fn, threads, 0, occ) != 0:
                raise SystemExit("occupancy query failed")
            label = "serial body" if v is None else _name(v)
            print(f"  {label:32s} B {B}: {blocks} blocks of {threads} "
                  f"threads; {occ[0]} blocks per SM, {occ[1]} registers, "
                  f"{occ[2]} B of stack")

    # The sections' cycles (thread 0 of block 0, -DQCT_CLOCKS).
    src = (kernels._CSRC / "qct_commander.cuh").read_text().splitlines()
    cyc = (ctypes.c_ulonglong * 2048)()
    for o in ((0.0, 0), (0.01, 8)):
        launch(clk, inp[4096], params[o])
        torch.cuda.synchronize()
        clk.qct_commander_clocks(cyc)
        launch(clk, inp[4096], params[o])
        torch.cuda.synchronize()
        if clk.qct_commander_clocks(cyc) != 0:
            raise SystemExit("reading the section clocks failed")
        total = sum(cyc)
        print(f" {_name(CLOCKS)}, gate {o[0]}, N {o[1]}, B 4096: sections "
              f"of lane 0 of instance 0 (thread 0 of block 0, "
              f"-DQCT_CLOCKS), {total} cycles in all")
        for line in range(2048):
            if cyc[line]:
                print(f"   line {line:4d} {src[line - 1].strip()[:48]:48s} "
                      f"{cyc[line]:7d} cycles "
                      f"{100.0 * cyc[line] / total:5.1f} %")
    print(smi)


if __name__ == "__main__":
    main()
