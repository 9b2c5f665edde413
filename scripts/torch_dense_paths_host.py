#!/usr/bin/env python3
"""Time the two dense solve paths of the PyTorch port on one card, the
host's share apart from the device's, and K3a (the dense barrier kernel)
alone.

    python3 scripts/torch_dense_paths_host.py [TREE]

TREE (default: this script's repository) is the root of a checkout whose
``quadruped_control_tpu_torch`` package is timed, with its own sources
built into its own ``_build/``: the same timing code on two commits
(``git archive`` of each into a directory, then this script on each, in the
order parent, change, change, parent, in one call to the card).

At B = 32768, on problems made as ``chip_smoke.py`` makes them
(``grf_scenarios`` from a generator seeded 4, ``assemble_qp_batch``), in
ROUNDS rounds of REPS solves on fresh inputs (chip_smoke.py's count):

- the split pipeline, ``solve_qp_ipm_fused`` (20 iterations, the polish):
  ``host_ms``, the host's time per solve from the first call to the return
  of the last; ``ms``, per solve from a CUDA event before the first call to
  one after the last (what ``chip_smoke.py`` reports); ``device_ms``, the
  same solves enqueued behind a ``torch.cuda._sleep`` that holds the stream
  until the host has enqueued all of them, so that the device runs them
  back to back and the events time the device alone (``host_ahead``: the
  event after the sleep had not been reached when the host returned; where
  it had, a solve waited on the device and ``device_ms`` is not the
  device's alone);
- ``solve_balance_qp_fused`` with the bench schedule and
  ``prox_backend="xla"``: ``host_ms`` and ``ms`` as above (its compactions
  wait on the device, so the host cannot run ahead and no ``device_ms`` is
  taken);
- K3a alone through ``kernels.dense_barrier`` at B = 32768 and at the xla
  prox slice's 1024: CUDA-event ms per launch (10 launches after a
  warm-up), after a check that its outputs are bitwise the plain version's.

Prints one line per round and, last, the card's name and power limit and a
JSON object of every number.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = (Path(sys.argv[1]) if sys.argv[1:] else
        Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

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

B = 32768
B_SLICE = 1024
REPS = 5
ROUNDS = 5
ITERS = 20
# chip_smoke.py's bench schedule, with the xla prox backend.
SCHEDULE = dict(
    iterations=20, polish=True, polish_sweeps=2, two_phase=True, split=True,
    tail_iterations=24, tail_sweeps=16, prox_tail=True,
    prox_backend="xla", prox_steps=6, prox_iterations=24, prox_sweeps=6,
    rows=16)
SLEEP_CYCLES = 1_000_000_000  # ~0.5 s at the card's clock


def events():
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def timed(solve, inputs):
    """(host ms, event ms) per solve of one round."""
    torch.cuda.synchronize()
    e0, e1 = events()
    e0.record()
    h0 = time.perf_counter()
    for a in inputs:
        solve(a)
    host = (time.perf_counter() - h0) * 1e3 / len(inputs)
    e1.record()
    torch.cuda.synchronize()
    return host, e0.elapsed_time(e1) / len(inputs)


def device_only(solve, inputs):
    """(event ms per solve with the host ahead of the device, whether the
    host stayed ahead)."""
    torch.cuda.synchronize()
    e0, e1 = events()
    torch.cuda._sleep(SLEEP_CYCLES)
    e0.record()
    for a in inputs:
        solve(a)
    e1.record()
    ahead = not e0.query()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / len(inputs), ahead


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    if not Path(kernels.__file__).resolve().is_relative_to(ROOT):
        raise SystemExit(f"imported {kernels.__file__}, not {ROOT}'s package")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    t_build = time.time()
    kernels.load()
    print(f"tree {ROOT}: kernels built and loaded in "
          f"{time.time() - t_build:.1f} s", flush=True)
    cfg = mit_cheetah_config()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    out = {"tree": str(ROOT)}

    def split(qp):
        return fi.solve_qp_ipm_fused(qp.Q, qp.c, qp.G, qp.h,
                                     iterations=ITERS, polish=True)

    qps = [assemble_qp_batch(grf_scenarios(gen, B, cfg, device="cuda"), cfg)
           for _ in range(REPS)]
    split(qps[0])
    rows = []
    for r in range(ROUNDS):
        host, ms = timed(split, qps)
        dev, ahead = device_only(split, qps)
        rows.append(dict(host_ms=host, ms=ms, device_ms=dev,
                         host_ahead=ahead))
        print(f"split pipeline, round {r}: host {host:.3f} ms per solve, "
              f"events {ms:.3f} ms, device alone {dev:.3f} ms (host "
              f"{'ahead' if ahead else 'NOT ahead'})", flush=True)
    out["split"] = rows

    def prox(s):
        return pf.solve_balance_qp_fused(
            s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
            s.stance, cfg.balance, **SCHEDULE)

    scen = [grf_scenarios(gen, B, cfg, device="cuda") for _ in range(REPS)]
    prox(scen[0])
    rows = []
    for r in range(ROUNDS):
        host, ms = timed(prox, scen)
        rows.append(dict(host_ms=host, ms=ms))
        print(f"xla prox solve, round {r}: host {host:.3f} ms per solve, "
              f"events {ms:.3f} ms", flush=True)
    out["prox_xla"] = rows

    qp = qps[0]
    Qs, cs, Gs, hs, _, _, _ = equilibrate(qp.Q, qp.c, qp.G, qp.h)
    prob = (pf._soa(Qs, 144, B), pf._soa(cs, 12, B), pf._soa(Gs, 288, B),
            pf._soa(hs, 24, B))
    out["k3a_ms"] = {}
    for n, pr in ((B, prob),
                  (B_SLICE, [a[:, :B_SLICE].contiguous() for a in prob])):
        def k3a():
            return kernels.dense_barrier(*pr, iterations=ITERS, tau=0.995)
        want = fi._dense_barrier_plain(*pr, iterations=ITERS, tau=0.995)
        if not all(bool(((a == b) | (a.isnan() & b.isnan())).all())
                   for a, b in zip(k3a(), want)):
            raise SystemExit(f"B = {n}: K3a is not bitwise the plain version")
        k3a()
        torch.cuda.synchronize()
        e0, e1 = events()
        e0.record()
        for _ in range(10):
            k3a()
        e1.record()
        torch.cuda.synchronize()
        out["k3a_ms"][n] = e0.elapsed_time(e1) / 10
        print(f"K3a, B = {n:5d}: {out['k3a_ms'][n]:.4f} ms per launch "
              f"(bitwise the plain version)", flush=True)
    print(smi)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
