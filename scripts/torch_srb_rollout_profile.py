#!/usr/bin/env python3
"""Where a tick of the port's SRB rollouts spends its time, on the card.

    python3 scripts/torch_srb_rollout_profile.py

The balance rollout (K1, B = 4096) and the MPC rollout (K6 every tick,
B = 1024) of chip_smoke.py phases 16-17, from the stood-up state: for each,
the ticks' wall time, the operators and CUDA runtime calls per tick and
their host time (``torch.profiler``, CPU and CUDA activities, over 10 ticks),
the device's busy time per tick from the profiler's kernel records (or
"not measured" if it reports none), and the calls that made the host wait
for the card (``torch.cuda.set_sync_debug_mode``), by source line. Needs one
card; writes nothing but its output.
"""

import collections
import sys
import time
import traceback
import warnings
from pathlib import Path

import torch

if not torch.cuda.is_available():
    sys.exit("torch_srb_rollout_profile: needs a CUDA device")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from quadruped_control_tpu_torch.config import (  # noqa: E402
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control import rollout as srb  # noqa: E402

CFG = mit_cheetah_physical_config()
DEV = torch.device("cuda")
TICKS = 10
CASES = (
    ("balance, K1, B = 4096", 4096,
     dict(qp_backend="fused", qp_iterations=12, qp_polish=False)),
    ("MPC every tick, K6, B = 1024", 1024,
     dict(controller="mpc", mpc_horizon=8, mpc_dt=0.05, mpc_iterations=25,
          mpc_backend="riccati-pallas")),
)


def sync_sites(run):
    """Source lines in the package whose calls made the host wait, with
    their counts over one tick."""
    sites = collections.Counter()

    def hook(message, category, filename, lineno, file=None, line=None):
        for frame in reversed(traceback.extract_stack()[:-1]):
            if "quadruped_control_tpu_torch" in frame.filename:
                path = frame.filename.split("quadruped_control_tpu_torch")[-1]
                sites[f"{path}:{frame.lineno}"] += 1
                return
        sites[f"{filename}:{lineno}"] += 1

    old = warnings.showwarning
    warnings.showwarning = hook
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            run(1)
    finally:
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = old
    return sites


def main():
    print(torch.cuda.get_device_name(0), flush=True)
    for name, B, kw in CASES:
        cmd = torch.zeros(B, 6, device=DEV)
        cmd[:, 0] = 0.2
        seconds = 2.0 if "controller" not in kw else 1.5
        stand = srb.stand_up_rollout(CFG, seconds=seconds, batch_shape=(B,),
                                     device=DEV, **kw)

        def run(n):
            return srb.rollout(stand.plant, stand.carry, cmd, n, CFG,
                               record=False, **kw)

        run(3)
        torch.cuda.synchronize()
        t0 = time.time()
        run(TICKS)
        torch.cuda.synchronize()
        wall = (time.time() - t0) * 1e3 / TICKS
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(TICKS)
            torch.cuda.synchronize()
        events = prof.key_averages()
        on_card = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        device_us = sum(e.self_device_time_total for e in on_card)
        ops = [e for e in events if e.key.startswith("aten::")]
        runtime = [e for e in events if e.key.startswith("cuda")]
        print(f"== {name}: {wall:.3f} ms a tick (host clock, {TICKS} ticks, "
              f"unprofiled)", flush=True)
        n_ops = sum(e.count for e in ops) / TICKS
        host_ms = sum(e.self_cpu_time_total for e in ops) / TICKS / 1e3
        print(f"  operators: {n_ops:.0f} calls a tick, {host_ms:.3f} ms of "
              f"host time a tick (self, profiled)")
        for e in sorted(runtime, key=lambda e: -e.self_cpu_time_total)[:6]:
            print(f"  {e.key}: {e.count / TICKS:.0f} a tick, "
                  f"{e.self_cpu_time_total / TICKS / 1e3:.3f} ms a tick")
        if device_us > 0:
            print(f"  device busy {device_us / TICKS / 1e3:.3f} ms a tick "
                  f"(kernel records)")
            for e in sorted(on_card,
                            key=lambda e: -e.self_device_time_total)[:5]:
                ms = e.self_device_time_total / TICKS / 1e3
                print(f"    {e.key[:70]}: {ms:.4f} ms a tick, "
                      f"{e.count / TICKS:.0f} a tick")
        else:
            print("  device busy: not measured (the profiler reported no "
                  "device time)")
        print("  top operators by host time:")
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:10]:
            print(f"    {e.key}: {e.count / TICKS:.0f} a tick, "
                  f"{e.self_cpu_time_total / TICKS / 1e3:.3f} ms a tick")
        sites = sync_sites(run)
        print(f"  host waits for the card: {sum(sites.values())} a tick")
        for site, n in sites.most_common(12):
            print(f"    {site}: {n}")


if __name__ == "__main__":
    main()
