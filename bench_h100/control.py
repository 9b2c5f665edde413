#!/usr/bin/env python3
"""Readings from which a cell's limits are set, on the card at the cell's
own size, many seeds in one process:

    python3 bench_h100/control.py --workload <cell> --seconds 2 \
        --seeds 1 2 3 ...

For each seed: the cell's set-up, a short window at the cell's own load,
then the numbers the run compares, read twice: once of the program's
answers (the lower readings) and once of the control's, the reference
computed in TF32 and put in the program's place on the same judged sample
(the upper readings). One JSON line per seed. The benchmark's own runs do
not run the control."""

import argparse
import json
import sys

import run


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    run.caches_in_checkout()
    import importlib

    import torch

    from tracing import Tracer

    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(run.ROOT))
    spec = run.load_spec()
    _, cfg, wl = run.cell_files(spec, args.workload)
    mod = importlib.import_module(f"drivers.{wl['driver']}")
    dev = torch.device("cuda")
    for seed in args.seeds:
        drv = mod.Driver(cfg, wl, seed, dev)
        drv.window(args.seconds, Tracer(False))
        drv.free()
        torch.cuda.empty_cache()
        program = {n: v for n, v, _ in drv.check()}
        control = {n: v for n, v, _ in drv.check(drv.control_answers())}
        print(json.dumps({"seed": seed, "program": program,
                          "control": control}), flush=True)
        del drv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
