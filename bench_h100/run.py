#!/usr/bin/env python3
"""One run of one cell of the benchmark of quadruped_control_tpu_torch on
NVIDIA GPUs.

    python3 bench_h100/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. The cell is an entry of BENCHMARK.json's
``workloads``; its configuration file (configs/), its traffic file
(workloads/, naming its driver in drivers/) and, with ``--trace 1``, its
per-layer metrics' readers (metrics/) are found by name. Set-up makes the
inputs on the card from the seed and warms every shape; the window then
measures for ``--seconds``; after it the outputs are judged against the
plain reference (reference/), and the last line of standard output is one
JSON object. Earlier lines name the card, its power limit, the kernels'
occupancy and the launch counts; the last lines of standard error give
each number compared beside its limit."""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "quadruped_control_tpu")


def caches_in_checkout():
    """Every build and kernel cache inside the checkout, at fixed paths (the
    port builds its kernels under quadruped_control_tpu_torch/_build/)."""
    base = ROOT / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def load_spec():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return spec


def cell_files(spec, name):
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / conf["file"]).read_text())
    wl = json.loads((HERE / "workloads" / f"{cell['traffic']}.json")
                    .read_text())
    return cell, cfg, wl


def applies(metric, cell_name):
    return "workloads" not in metric or cell_name in metric["workloads"]


def load_reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class LayerContext:
    """What a per-layer metric's reader may read."""

    def __init__(self, driver, result, trace):
        self.unit = driver.unit
        self.result = result
        self.trace = trace
        self.traced_units = result["traced_units"]
        self.bounds = driver.bounds()

    def roofline(self, family):
        """100 x the least time of one unit's launches of ``family`` over
        their device time per unit in the trace; None where the trace holds
        none of them."""
        if family not in self.bounds or self.trace is None \
                or not self.traced_units:
            return None
        bound, names = self.bounds[family]
        t = self.trace.kernel_s(names)
        if t <= 0:
            return None
        return 100.0 * bound * self.traced_units / t


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(spec, name, seed, seconds, trace, device, overrides=None,
             wrap_call=None, log=print):
    """Set up, measure and judge one cell on ``device``. ``overrides``
    replaces workload keys (a small size for the CPU tests); ``wrap_call``
    wraps the program's timed call (the tests' planted faults). Returns the
    result's fields, with the compared numbers under ``checks``."""
    import torch

    from tracing import Tracer

    cell, cfg, wl = cell_files(spec, name)
    wl = dict(wl, **(overrides or {}))
    driver_mod = importlib.import_module(f"drivers.{wl['driver']}")
    driver = driver_mod.Driver(cfg, wl, seed, device)
    if wrap_call is not None:
        driver.solve = wrap_call(driver.solve)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_PROCESS

    from quadruped_control_tpu_torch import kernels

    if cuda:
        log(f"occupancy: {json.dumps(driver.occupancy())}")
    kernels.reset_launch_counts()
    tracer = Tracer(bool(trace))
    result = driver.window(seconds, tracer)
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    log(f"launch counts in the window ({result['units']} {driver.unit}s): "
        f"{json.dumps(launches)}")
    driver.expect_launches(launches, result["units"])
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = tracer.summary()

    metrics = {}
    if trace:
        ctx = LayerContext(driver, result, summary)
        for m in spec["per_layer"]:
            if applies(m, name):
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = driver.end_to_end(result)
        e2e["setup_s"] = (setup_s, "s")
        for m in spec["end_to_end"]:
            if applies(m, name):
                v, unit = e2e[m["name"]]
                if unit != m["unit"]:
                    raise SystemExit(f"{m['name']}: unit {unit} vs "
                                     f"{m['unit']}")
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    driver.free()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    checks = driver.check()
    log(f"reference check: {time.perf_counter() - t0:.1f} s over "
        f"{driver.judged} judged answers; the reference converged on "
        f"{driver.ref_converged:.4f} of its lanes")
    correct = all(v <= lim for _, v, lim in checks)   # a NaN fails
    out = {"correct": correct, "attempted": result["attempted"],
           "failed": result["failed"], "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda
                      else "cpu",
                      "count": int(cell["chips"]),
                      "memory_peak_bytes": int(peak)}}
    if trace and summary is not None:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = summary.breakdown()
    out["checks"] = {n: {"value": v if math.isfinite(v) else None,
                         "limit": lim} for n, v, lim in checks}
    return out


def card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    caches_in_checkout()
    spec = load_spec()
    cell, _, _ = cell_files(spec, args.workload)
    import torch

    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr)
        return 3
    for p in (str(HERE), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    print(f"card: {card_line()}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    out = run_cell(spec, args.workload, args.seed, args.seconds, args.trace,
                   torch.device("cuda"), log=lambda m: print(m, flush=True))
    bad = forbidden_modules()
    if bad:
        print(f"run.py: modules loaded in this process that the benchmark "
              f"must not load: {bad}", file=sys.stderr)
        return 4
    for n, c in out["checks"].items():
        ok = ("ok" if c["value"] is not None and c["value"] <= c["limit"]
              else "FAILS")
        print(f"check {n}: {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    print(json.dumps(out, allow_nan=True), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
