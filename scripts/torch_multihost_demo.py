#!/usr/bin/env python
"""Multi-process sharded solve of the PyTorch port (twin of
scripts/multihost_demo.py).

One process per "host", joined with ``torch.distributed``
(parallel/distributed.py). Every process builds the same global scenario
batch from one seed, takes its own contiguous slice, shards that slice over
its local mesh (``--local-devices`` entries of ``--device``), solves it, and
reads the GLOBAL convergence fraction, summed over the processes with one
``all_reduce``. It checks that fraction against a solve of the whole batch
in this process alone (1e-6), made before joining.

Two "hosts" on the CPU over gloo, 4 mesh entries each:

  for i in 0 1; do
    PYTHONPATH=. python scripts/torch_multihost_demo.py --device cpu \\
      --coordinator localhost:12357 --num-processes 2 --process-id $i &
  done; wait

On machines with cards, ``--device cuda`` (the default) joins over NCCL and
uses ``--local-devices`` cards of each.
"""

import argparse
import sys

import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:12357")
    ap.add_argument("--num-processes", type=int, default=2)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--global-batch", type=int, default=1024)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from quadruped_control_tpu_torch.config import mit_cheetah_config
    from quadruped_control_tpu_torch.parallel import distributed
    from quadruped_control_tpu_torch.parallel.mesh import (
        BatchSharding,
        scenario_mesh,
        shard_scenarios,
        solve_scenarios_sharded,
    )
    from quadruped_control_tpu_torch.utils.scenarios import grf_scenarios

    device = torch.device(args.device)
    if device.type == "cuda":
        mesh = scenario_mesh([torch.device("cuda", i)
                              for i in range(args.local_devices)])
    else:
        mesh = scenario_mesh([device] * args.local_devices)
    cfg = mit_cheetah_config()
    # Every process draws the identical full batch (cheap, determinate).
    gen = torch.Generator(device=mesh[0])
    gen.manual_seed(7)
    full = grf_scenarios(gen, args.global_batch, cfg, dtype=torch.float32,
                         device=mesh[0])
    # Local oracle: the same batch in this process alone, before joining.
    _x1, _c1, frac_local = solve_scenarios_sharded(full, cfg)
    frac_local = float(frac_local)

    distributed.initialize(args.coordinator, args.num_processes,
                           args.process_id, device=mesh[0])
    try:
        pid = distributed.process_index()
        n_proc = distributed.process_count()
        assert n_proc == args.num_processes, n_proc
        print(f"proc {pid}: {n_proc * len(mesh)} global / {len(mesh)} "
              f"local devices", flush=True)
        procs = BatchSharding(tuple([mesh[0]] * n_proc))
        mine = procs.split(full)[pid]
        _x, _conv, frac = solve_scenarios_sharded(
            shard_scenarios(mine, mesh), cfg)
        frac = float(frac)
    finally:
        torch.distributed.destroy_process_group()
    print(f"proc {pid}: sharded conv_frac={frac:.6f} local={frac_local:.6f}",
          flush=True)
    assert abs(frac - frac_local) < 1e-6, (frac, frac_local)
    print(f"proc {pid}: OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
