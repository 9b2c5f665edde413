#!/usr/bin/env python3
"""Time K3a, the dense barrier kernel of the PyTorch port, at three block
sizes on one NVIDIA Hopper card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_dense_barrier_blocks.py

K3a runs one QP on 16 lanes, two QPs a warp; its block size is a
build-time choice (``QDB_MAX_THREADS`` / ``QDB_MIN_BLOCKS`` in
``quadruped_control_tpu_torch/csrc/qct_dense_ipm.cuh``). For blocks of 1, 2
and 4 warps this compiles the kernel's sources into a library of its own
(under ``quadruped_control_tpu_torch/_build/barrier_blocks/``, with the
port's flags), launches its K3a on the split pipeline's dense problems as
``chip_smoke.py`` makes them (``grf_scenarios`` -> ``assemble_qp_batch`` ->
``equilibrate``, 20 iterations) at B = 32768 and at the xla prox stage's
1024, fails unless every output is bitwise the plain version's, and prints
the CUDA-event time per launch (10 launches after a warm-up), the blocks
resident per SM, the registers and the stack of each, and the card's name
and power limit. The variants run in turns (the list, then the list
reversed), in one process. Then a build of the port's variant with
``-DQCT_CLOCKS`` prints, at both sizes, the cycles of each section of the
kernel's iteration loop as thread 0 of block 0 sees them (the line of the
section's end in ``qct_dense_ipm.cuh`` and the section's name there, its
cycles per iteration, its share).
"""

import ctypes
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_config  # noqa: E402
from quadruped_control_tpu_torch.solver import fused as pf  # noqa: E402
from quadruped_control_tpu_torch.solver import fused_ipm as fi  # noqa: E402
from quadruped_control_tpu_torch.solver.ipm import equilibrate  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    assemble_qp_batch,
    grf_scenarios,
)

# Threads a block -> blocks per SM in __launch_bounds__ (<= 128 registers
# a thread).
VARIANTS = {32: 16, 64: 8, 128: 4}
REPS = 10
ITERS = 20


CLOCKS = 128  # the port's variant, built again with -DQCT_CLOCKS


def build(threads, min_blocks, out_dir, clocks=False):
    """Start nvcc on K3a's sources (and the occupancy and error entries) for
    one variant; returns (library path, process)."""
    tag = "_clocks" if clocks else ""
    lib = out_dir / f"libqct_dense_barrier_{threads}{tag}.so"
    cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared",
           f"-DQDB_MAX_THREADS={threads}", f"-DQDB_MIN_BLOCKS={min_blocks}",
           "-o", str(lib)] + (["-DQCT_CLOCKS"] if clocks else []) + [
               str(kernels._CSRC / f) for f in (
                   "qct_dense_ipm.cu", "qct_mpc.cu", "qct_assemble.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qct_dense_barrier.argtypes = [vp] * 7 + [
        ci, ci, ctypes.c_float, ci, ci, ci, vp]
    lib.qct_dense_barrier.restype = ci
    lib.qct_dense_barrier_layout.argtypes = [vp]
    lib.qct_dense_barrier_layout.restype = ci
    lib.qct_dense_barrier_fn.argtypes = []
    lib.qct_dense_barrier_fn.restype = vp
    lib.qct_occupancy.argtypes = [vp, ci, ci, vp]
    lib.qct_occupancy.restype = ci
    return lib


def launch(lib, prob):
    """One K3a launch of this library: ((x, s, z), geometry)."""
    B = prob[1].shape[1]
    lay = (ctypes.c_int * 3)()
    lib.qct_dense_barrier_layout(lay)
    geo = kernels.fused_launch_geometry(B, kernels.FusedLayout(*lay))
    out = [torch.empty((k, B), device="cuda") for k in (12, 24, 24)]
    rc = lib.qct_dense_barrier(
        *[a.data_ptr() for a in (*prob, *out)], B, ITERS, 0.995, geo.blocks,
        geo.threads, geo.shared_bytes,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return out, geo


def event_ms(fn):
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


def same_values(got, want):
    return all(bool(((a == b) | (a.isnan() & b.isnan())).all())
               for a, b in zip(got, want))


def problems():
    """{B: (Q, c, G, h)} at 32768 and its first 1024 QPs (chip_smoke.py's
    dense problems, seed 4)."""
    cfg = mit_cheetah_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    Bm = 32768
    s = grf_scenarios(gen, Bm, cfg, device="cuda")
    qp = assemble_qp_batch(s, cfg)
    Qs, cs, Gs, hs, _, _, _ = equilibrate(qp.Q, qp.c, qp.G, qp.h)
    prob = (pf._soa(Qs, 144, Bm), pf._soa(cs, 12, Bm), pf._soa(Gs, 288, Bm),
            pf._soa(hs, 24, Bm))
    return {Bm: prob, 1024: [a[:, :1024].contiguous() for a in prob]}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    out_dir = kernels._BUILD_ROOT / "barrier_blocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {v: build(v, m, out_dir) for v, m in VARIANTS.items()}
    procs["clocks"] = build(CLOCKS, VARIANTS[CLOCKS], out_dir, clocks=True)
    cases = problems()
    plain = {B: fi._dense_barrier_plain(*pr, iterations=ITERS, tau=0.995)
             for B, pr in cases.items()}
    libs = {}
    for v, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {v}:\n{log}")
        libs[v] = load(path)
    clk = libs.pop("clocks")
    clk.qct_dense_barrier_clocks.argtypes = [ctypes.c_void_p]
    clk.qct_dense_barrier_clocks.restype = ctypes.c_int
    for v, lib in libs.items():
        for B, pr in cases.items():
            if not same_values(launch(lib, pr)[0], plain[B]):
                raise SystemExit(f"{v}, B = {B}: not bitwise the plain "
                                 f"version")
    print(f"every variant bitwise the plain version at B = 32768 and 1024, "
          f"{ITERS} iterations")

    order = list(VARIANTS) + list(VARIANTS)[::-1]
    for v in order:
        lib = libs[v]
        for B, pr in cases.items():
            geo = launch(lib, pr)[1]
            ms = event_ms(lambda: launch(lib, pr))
            occ = (ctypes.c_int * 3)()
            rc = lib.qct_occupancy(lib.qct_dense_barrier_fn(), geo.threads,
                                   geo.shared_bytes, occ)
            if rc != 0:
                raise SystemExit(f"occupancy query failed: {rc}")
            print(f"{v:4d} threads ({geo.qps_per_block} QPs) a block, "
                  f"B = {B:5d}: {ms:.4f} ms per launch; {occ[0]} blocks "
                  f"per SM, {occ[1]} registers, {occ[2]} B of stack")
    print_sections(clk, cases)
    print(smi)


def print_sections(clk, cases):
    """The cycles of each section of the iteration loop (thread 0 of block
    0, the -DQCT_CLOCKS build of the port's variant), per iteration."""
    src = (kernels._CSRC / "qct_dense_ipm.cuh").read_text().splitlines()
    cyc = (ctypes.c_ulonglong * 2048)()
    for B, pr in cases.items():
        if not same_values(launch(clk, pr)[0], fi._dense_barrier_plain(
                *pr, iterations=ITERS, tau=0.995)):
            raise SystemExit("the -DQCT_CLOCKS build is not bitwise the "
                             "plain version")
        torch.cuda.synchronize()
        clk.qct_dense_barrier_clocks(cyc)
        launch(clk, pr)
        torch.cuda.synchronize()
        if clk.qct_dense_barrier_clocks(cyc) != 0:
            raise SystemExit("reading the section clocks failed")
        total = sum(cyc)
        print(f"{CLOCKS} threads, B = {B}, sections of one QP's iteration "
              f"(thread 0 of block 0, -DQCT_CLOCKS): {total / ITERS:.0f} "
              f"cycles an iteration")
        for line in range(2048):
            if cyc[line]:
                name = src[line - 1].split("//")[-1].strip()
                print(f"   line {line:4d} {name[:30]:30s} "
                      f"{cyc[line] / ITERS:7.0f} cycles "
                      f"{100.0 * cyc[line] / total:5.1f} %")


if __name__ == "__main__":
    main()
