#!/usr/bin/env python3
"""Time K4 (the commander-pre kernel) and K2 (the assembly kernel) of the
PyTorch port on one card, each through a CUDA graph, K2 also by CUDA events
around back-to-back calls.

    python3 scripts/torch_commander_assembly_tree.py [TREE]

TREE (default: this script's repository) is the root of a checkout whose
``quadruped_control_tpu_torch`` package is timed, with its own sources
built into its own ``_build/``: the same timing code on two commits
(``git archive`` of each into a directory, then this script on each, in the
order parent, change, change, parent, in one call to the card).

- K4 through ``control.fused_commander.commander_pre_packed`` at B = 4096 on
  seeded mid-walk states and commander carries (``whole_body_walk_states``,
  ``commander_carry_walk``; ``mit_cheetah_physical_config``), without the
  MPC block (the balance tick's launch) and with it (N = 8, 0.03 s, the MPC
  tick's); and K4's serial body (``kernels.commander_serial``) where TREE
  has it.
- K2 through ``kernels.assemble`` at B = 32768 on ``grf_scenarios`` from a
  generator seeded 0 (``chip_smoke.py``'s phase 4a inputs), without and
  with equilibration.

A graph holds REPS launches and is replayed once to warm up and once timed
(the wrappers' host work, allocations and checks, is longer than these
launches: back-to-back calls time the host). ROUNDS rounds; prints one line
per round and, last, the card's name and power limit and a JSON object of
every number.
"""

import json
import subprocess
import sys
from pathlib import Path

ROOT = (Path(sys.argv[1]) if sys.argv[1:] else
        Path(__file__).resolve().parent.parent).resolve()
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import (  # noqa: E402
    mit_cheetah_config,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control import (  # noqa: E402
    fused_commander as fcmd,
)
from quadruped_control_tpu_torch.ops.dynamics import (  # noqa: E402
    SWING_ROW_RELAX,
)
from quadruped_control_tpu_torch.solver import fused as pf  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    commander_carry_walk,
    grf_scenarios,
    walk_carry_comps,
    walk_state_comps,
    whole_body_walk_states,
)

B_TICK = 4096
B_MAIN = 32768
REPS = 50
ROUNDS = 3


def graph_ms(fn):
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


def event_ms(fn, reps=10):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main():
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    smi = subprocess.run("nvidia-smi --query-gpu=name,power.limit "
                         "--format=csv,noheader", shell=True,
                         capture_output=True, text=True).stdout.strip()
    kernels.load()
    dev = torch.device("cuda")

    def to_dev(a):
        return torch.as_tensor(np.ascontiguousarray(a),
                               dtype=torch.float32).to(dev)

    cfg = mit_cheetah_physical_config()
    consts = fcmd.CommanderConsts(cfg, 1.0 / cfg.frequency)
    d = whole_body_walk_states(30, B_TICK, cfg)
    state, cmd = to_dev(walk_state_comps(d)), to_dev(d["cmd"].T)
    carry = to_dev(walk_carry_comps(commander_carry_walk(20, B_TICK, cfg)))
    k4 = {"k4": {}, "k4_mpc": dict(mpc_horizon=8, mpc_dt=0.03)}
    serial = hasattr(kernels, "commander_serial")

    bal = mit_cheetah_config().balance
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    s = grf_scenarios(gen, B_MAIN, mit_cheetah_config(), device=dev)
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, bal, mass=s.mass, inertia_diag=s.inertia_diag)
    inp = pf._prep_inputs(rm, b, s.stance, bal.mu if s.mu is None else s.mu,
                          bal.fz_min, bal.fz_max)
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag),
                swing_relax=SWING_ROW_RELAX)

    out = {}
    for r in range(ROUNDS):
        row = {}
        for name, kw in k4.items():
            row[name] = graph_ms(lambda: fcmd.commander_pre_packed(
                state, carry, cmd, consts=consts, **kw))
            if serial:
                prm = consts.params(0.0, False, kw.get("mpc_horizon", 0),
                                    kw.get("mpc_dt", 0.0))
                row[name + "_serial"] = graph_ms(
                    lambda: kernels.commander_serial(state, carry, cmd, prm))
        for eq in (False, True):
            tag = "k2_equilibrated" if eq else "k2"
            row[tag] = graph_ms(
                lambda: kernels.assemble(*inp, equilibrated=eq, **base))
            row[tag + "_event"] = event_ms(
                lambda: kernels.assemble(*inp, equilibrated=eq, **base))
        print(f"round {r}: " + ", ".join(f"{k} {v:.5f}"
                                         for k, v in row.items()), flush=True)
        for k, v in row.items():
            out.setdefault(k, []).append(v)
    print(smi)
    print(json.dumps({"tree": str(ROOT), "ms": out}))


if __name__ == "__main__":
    main()
