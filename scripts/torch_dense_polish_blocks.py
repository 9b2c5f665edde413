#!/usr/bin/env python3
"""Time K3b, the dense certified-polish kernel of the PyTorch port, at three
block sizes on one NVIDIA Hopper card.

Run from the repository root on a machine with the card and ``nvcc``:

    python3 scripts/torch_dense_polish_blocks.py

K3b runs one QP on 16 lanes, two QPs a warp; its block size is a build-time
choice (``QD_MAX_THREADS`` / ``QD_MIN_BLOCKS`` in
``quadruped_control_tpu_torch/csrc/qct_dense_ipm.cuh``). For blocks of 1, 2
and 4 warps this compiles the kernel's sources into a library of its own
(under ``quadruped_control_tpu_torch/_build/blocks/``, with the port's
flags), launches its K3b on the split pipeline's dense problems as
``chip_smoke.py`` makes them (``grf_scenarios`` -> ``assemble_qp_batch`` ->
``equilibrate``, K3a's point after 20 iterations) at B = 32768 and at the
xla prox stage's 1024, fails unless every output is bitwise the plain
version's, and prints the CUDA-event time per launch (10 launches after a
warm-up), the blocks resident per SM, and the card's name and power limit.
The sizes run in turns (1, 2, 4, 4, 2, 1 warps), in one process.
"""

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_config  # noqa: E402
from quadruped_control_tpu_torch.solver import fused as pf  # noqa: E402
from quadruped_control_tpu_torch.solver import fused_ipm as fi  # noqa: E402
from quadruped_control_tpu_torch.solver.ipm import equilibrate  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    assemble_qp_batch,
    grf_scenarios,
)

# threads a block -> its blocks per SM in __launch_bounds__ (<= 128
# registers a thread).
SIZES = {32: 16, 64: 8, 128: 4}
REPS = 10


def build(threads, min_blocks, out_dir):
    """Start nvcc on K3b's sources (and the occupancy and error entries) for
    one block size; returns (library path, process)."""
    lib = out_dir / f"libqct_dense_{threads}.so"
    cmd = [kernels._nvcc(), *kernels._NVCC_FLAGS, "-shared",
           f"-DQD_MAX_THREADS={threads}", f"-DQD_MIN_BLOCKS={min_blocks}",
           "-o", str(lib)] + [str(kernels._CSRC / f) for f in (
               "qct_dense_ipm.cu", "qct_mpc.cu", "qct_assemble.cu")]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def load(path):
    lib = ctypes.CDLL(str(path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.qct_dense_polish.argtypes = [vp] * 11 + [ci, ci, ci, ci, vp]
    lib.qct_dense_polish.restype = ci
    lib.qct_dense_polish_layout.argtypes = [vp]
    lib.qct_dense_polish_layout.restype = ci
    lib.qct_dense_polish_fn.argtypes = []
    lib.qct_dense_polish_fn.restype = vp
    lib.qct_occupancy.argtypes = [vp, ci, ci, vp]
    lib.qct_occupancy.restype = ci
    return lib


def launch(lib, prob, point):
    """One K3b launch of this library: (x, s, z, cert)."""
    B = prob[1].shape[1]
    lay = (ctypes.c_int * 3)()
    lib.qct_dense_polish_layout(lay)
    geo = kernels.dense_launch_geometry(B, kernels.FusedLayout(*lay))
    out = [torch.empty((k, B), device="cuda") for k in (12, 24, 24)]
    out.append(torch.empty((B,), device="cuda"))
    rc = lib.qct_dense_polish(
        *[a.data_ptr() for a in (*prob, *point, *out)], B, geo.blocks,
        geo.threads, geo.shared_bytes,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"launch failed: CUDA error {rc}")
    return out, geo


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    out_dir = kernels._BUILD_ROOT / "blocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {t: build(t, m, out_dir) for t, m in SIZES.items()}
    libs = {}
    for t, (path, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {t} threads:\n{log}")
        libs[t] = load(path)

    cfg = mit_cheetah_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    Bm = 32768
    s = grf_scenarios(gen, Bm, cfg, device="cuda")
    qp = assemble_qp_batch(s, cfg)
    Qs, cs, Gs, hs, _, _, _ = equilibrate(qp.Q, qp.c, qp.G, qp.h)
    prob = (pf._soa(Qs, 144, Bm), pf._soa(cs, 12, Bm), pf._soa(Gs, 288, Bm),
            pf._soa(hs, 24, Bm))
    point = kernels.dense_barrier(*prob, iterations=20, tau=0.995)
    cases = {Bm: (prob, point),
             1024: ([a[:, :1024].contiguous() for a in prob],
                    [a[:, :1024].contiguous() for a in point])}
    plain = {B: fi._dense_polish_plain(*pr, *pt) for B, (pr, pt) in
             cases.items()}
    for t, lib in libs.items():
        for B, (pr, pt) in cases.items():
            got, _ = launch(lib, pr, pt)
            same = all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                       for a, b in zip(got, plain[B]))
            if not same:
                raise SystemExit(f"{t} threads, B = {B}: not bitwise the "
                                 f"plain version")
    print(f"every size bitwise the plain version at B = {Bm} and 1024")

    order = list(SIZES) + list(SIZES)[::-1]
    for t in order:
        lib = libs[t]
        for B, (pr, pt) in cases.items():
            _, geo = launch(lib, pr, pt)
            torch.cuda.synchronize()
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                launch(lib, pr, pt)
            e1.record()
            torch.cuda.synchronize()
            occ = (ctypes.c_int * 3)()
            rc = lib.qct_occupancy(lib.qct_dense_polish_fn(), geo.threads,
                                   geo.shared_bytes, occ)
            if rc != 0:
                raise SystemExit(f"occupancy query failed: {rc}")
            print(f"{t:4d} threads ({geo.qps_per_block} QPs) a block, "
                  f"B = {B:5d}: {e0.elapsed_time(e1) / REPS:.4f} ms per "
                  f"launch; {occ[0]} blocks per SM, {occ[1]} registers, "
                  f"{occ[2]} B of stack")
    print(smi)


if __name__ == "__main__":
    main()
