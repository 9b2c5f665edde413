#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (quadruped_control_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``quadruped_control_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card (every mode of the
fused kernel, bitwise, at B = 4096 with a NaN lane and an inf lane, and at
the shapes the main path launches, with each launch's geometry, resident
blocks, registers and stack), drives
the port's main path — ``solve_balance_qp_fused`` with the reference bench's
schedule at B = 32768, fresh seeded inputs per repetition — checks the result
(finite, converged fraction, float64 active-set oracle parity) and that the
path went through the kernels (launch counters), and prints the kernels'
times beside their bounds.

Then the second main path, the closed-loop whole-body tick (commander-pre K4
-> GRF QP K1 -> physics substeps K5, sim/fused_tick.py): K4 and K5 against
their plain versions at B = 4096 on synthetic mid-walk states (K4 over 8
chained ticks with and without its options; K5 in three configurations with
two poisoned lanes), and bitwise their serial bodies (qct_commander_serial,
qct_substep_serial) there, on a ragged batch with poisoned lanes and on
every whole tick's own inputs of both loops; K4's and K5's geometry,
resident blocks, registers and stack; 600 ticks of stand-up from
the laying pose and 600 ticks
of a 0.2 m/s trot at B = 4096 with behaviour limits and exactly 3 launches
per tick (4 with the certification tail), the first ticks also through the
plain versions, and ms per tick and per launch beside the bounds.

Then the third main path, the receding-horizon MPC tick (commander-pre K4
with its MPC block -> MPC kernel K6 -> substeps K5) in its recommended
configuration (mit_cheetah_whole_body_config, N = 8, mpc_dt = 0.03, warm
start, 8 iterations, B = 4096 robots whose start poses differ by 1e-4 m):
K4's MPC block against its plain version and bitwise its serial body over
8 chained ticks and a ragged poisoned batch, 600 ticks of
stand-up and 900 of a 0.2 m/s trot (chunked, the warm carry threaded
through) with exactly 3 launches per tick, the stand-up limits held and the
trot reported; the same with 15 cold iterations, held to the stand-up and
trot limits; whole ticks through the plain versions, the decimated rollout's
launch counts; K6 against its plain version at every shape and mode the path
uses (cold-15, warm-8 with flipped schedule bits, N = 24 without
best-iterate tracking, the unpacked entry at a ragged batch, poisoned
lanes), K6's launch geometry and resident blocks per SM; ms per tick and per
launch beside the bound (K6 also at N = 24).

Then the fourth main path, the dense QP solve (solver/fused_ipm.py: the
dense barrier K3a, then the certified polish K3b) at B = 32768: both kernels
against their plain versions (20 and 3 iterations, the polish on the
barrier's point, a ragged batch with two poisoned lanes; both bitwise, a
hold, there, on every lane of the ragged batch and on the xla prox stage's
slices), both kernels' launch geometry, resident blocks, registers and
stack, the split pipeline
(grf_scenarios -> assemble_qp_batch -> solve_qp_ipm_fused) with its
converged fraction, float64 oracle parity and exactly one launch of each
kernel per solve, and solve_balance_qp_fused with the bench schedule and
prox_backend="xla" (3 K1 launches + 6 x (K3a + K3b) per solve), with times
beside the bounds (K3a and K3b also at the xla prox slice's 1024 QPs).

Then the fifth main path, the SRB closed loop (control/rollout.py: the
plain commander x the SRB plant, one kernel a tick) in the configurations of
the JAX package's scripts/rollout_bench.py: (f) the balance QP in K1 (barrier
only, 12 iterations) at B = 4096, stand_up_rollout (600 ticks) then a
0.2 m/s trot through rollout (600 ticks), exactly one K1 launch a tick and
no other launch, the behaviour limits of tests/test_rollout.py, K1 bitwise
its plain version on the loop's inputs, and teacher-forced ticks from three
recorded states on the card against the plain path on the CPU; (g) the
N = 8 MPC in K6 (cold, 25 iterations) at B = 1024, every tick (450 stand-up
+ 450 trot ticks, exactly one K6 launch a tick) and every 10th tick
(rollout_mpc_decimated, one launch a group), the limits of
tests/test_mpc_commander.py, K6 against its plain version on the loop's
inputs, the same teacher-forced ticks; (h) gradients on the card:
solve_qp_implicit's against the CPU's, the decimated MPC walking loop's
(float64, structured MPC) against its central difference, and a gradient
through K1 raising; and ms per tick of the three rollouts (marginal, the
lengths of rollout_bench.py) with the host's enqueue time and the kernel's
share of the tick.

Then scenario sharding (phase 20, parallel/mesh.py): scenario_mesh(), the
balance tick and the warm-8 MPC tick decimated every 2nd tick over meshes of
1 and [cuda:0] * 4 entries at B = 4096, bitwise the unsharded loops with
exactly shards x the launches; shard_rollout_whole_body with K5 against its
unsharded run; solve_scenarios_sharded at B = 32768 (each shard bitwise its
slice's own solve, x against the whole batch in float64), then with the
fraction through an NCCL all_reduce; entry() and dryrun_multichip; ms per
tick at 1 and 4 shards. And checkpoints (phase 21): a run_checkpointed
rollout interrupted and resumed, bitwise the uninterrupted one, and
profiling.benchmark of the fused solve. K6 is held bitwise to its serial
body (qct_mpc_serial) in phases 10, 11 and 17.

Any failed phase ends the run with a non-zero exit code; nothing is caught and
carried on. Without a CUDA device it exits with code 2 and prints no result.

Output: progress lines, then the card's ``nvidia-smi`` name and power limit,
one JSON line ``{"kernels": [...]}``, and as the LAST line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script needs one CUDA device\n")
    sys.exit(2)

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import (  # noqa: E402
    mit_cheetah_config,
    mit_cheetah_physical_config,
    mit_cheetah_whole_body_config,
)
from quadruped_control_tpu_torch.control import fused_commander as fcmd  # noqa: E402
from quadruped_control_tpu_torch.control import rollout as srb  # noqa: E402
from quadruped_control_tpu_torch.control.commander import (  # noqa: E402
    commander_precursors,
    commander_step,
    init_commander_carry,
    mpc_precursors,
)
from quadruped_control_tpu_torch.control.plant import (  # noqa: E402
    init_plant_state,
    plant_step,
)
from quadruped_control_tpu_torch.entry import (  # noqa: E402
    dryrun_multichip,
    entry,
)
from quadruped_control_tpu_torch.mpc import fused_riccati as fr  # noqa: E402
from quadruped_control_tpu_torch.mpc import structured as mst  # noqa: E402
from quadruped_control_tpu_torch.ops.dynamics import SWING_ROW_RELAX  # noqa: E402
from quadruped_control_tpu_torch.parallel import distributed as pdist  # noqa: E402
from quadruped_control_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from quadruped_control_tpu_torch.sim import (  # noqa: E402
    ContactConfig,
    init_whole_body_state,
    mit_cheetah_urdf_model,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim import fused_substep as fsub  # noqa: E402
from quadruped_control_tpu_torch.sim import fused_tick as ftick  # noqa: E402
from quadruped_control_tpu_torch.solver import fused as pf  # noqa: E402
from quadruped_control_tpu_torch.solver import fused_ipm as fi  # noqa: E402
from quadruped_control_tpu_torch.solver.diff import (  # noqa: E402
    solve_qp_implicit,
)
from quadruped_control_tpu_torch.solver.ipm import equilibrate  # noqa: E402
from quadruped_control_tpu_torch.solver.reference import (  # noqa: E402
    solve_qp_batch_oracle,
)
from quadruped_control_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from quadruped_control_tpu_torch.utils import profiling  # noqa: E402
from quadruped_control_tpu_torch.utils.scenarios import (  # noqa: E402
    assemble_qp_batch,
    commander_carry_walk,
    grf_scenarios,
    walk_carry_comps,
    walk_state_comps,
    whole_body_walk_states,
)

DEV = torch.device("cuda")
SEED = 0
B_CHECK = 4096
POISON = (101, 202)  # phase 3's lanes with a NaN and an inf input
B_MAIN = 32768
REPS = 5
B_TICK = 4096
N_SUBSTEPS = 10
# The MPC tick's main configuration (scripts/verify_mpc_warm_tick.py of the
# JAX package): mit_cheetah_whole_body_config (the fast trot with the swing PD
# stiffened for the articulated legs), horizon 8 at 0.03 s, warm start, 8 IPM
# iterations.
MPC_N, MPC_DT, MPC_ITERS = 8, 0.03, 8
MPC_STAND, MPC_TROT = 600, 900
# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The reference bench's schedule (bench.py of the JAX package).
MAIN_SCHEDULE = dict(
    iterations=20, polish=True, polish_sweeps=2, two_phase=True, split=True,
    tail_iterations=24, tail_sweeps=16, prox_tail=True,
    prox_backend="kernel", prox_steps=6, prox_iterations=24, prox_sweeps=6,
    rows=16)
# The dense QP solve of the split pipeline (scripts/fused_bench.py:48-54 of
# the JAX package): grf_scenarios -> assemble_qp_batch -> the dense solve.
DENSE_ITERS = 20
# The SRB closed loop (control/rollout.py: commander x SRB plant) in the
# configurations of scripts/rollout_bench.py:23-77 of the JAX package:
# mit_cheetah_physical_config, a 0.2 m/s trot, the balance QP in K1
# (barrier only, 12 iterations) at B = 4096; the N = 8 MPC in K6 (cold, 25
# iterations) at B = 1024, every tick and every 10th tick.
B_SRB, B_SRB_MPC = 4096, 1024
SRB_QP = dict(qp_backend="fused", qp_iterations=12, qp_polish=False)
SRB_MPC = dict(controller="mpc", mpc_horizon=8, mpc_dt=0.05,
               mpc_iterations=25, mpc_backend="riccati-pallas")
SRB_EVERY = 10


def log(msg):
    print(msg, flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(cond, msg):
    if not cond:
        fail(msg)
    log(f"  ok: {msg}")


def run_text(cmd):
    return subprocess.run(cmd, shell=True, capture_output=True, text=True,
                          timeout=60).stdout.strip()


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------

def raw_inputs(s, bal):
    """ScenarioBatch -> (r_masked, b, stance, mu, fz_min, fz_max), the
    arguments of solve_grf_qp_fused / assemble_qp_fused_debug."""
    rm, b = pf.balance_precursors(
        s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
        s.stance, bal, mass=s.mass, inertia_diag=s.inertia_diag)
    mu = bal.mu if s.mu is None else s.mu
    return rm, b, s.stance, mu, bal.fz_min, bal.fz_max


def kernel_inputs(s, bal):
    """ScenarioBatch -> the kernels' (k, B) inputs."""
    return pf._prep_inputs(*raw_inputs(s, bal))


def objective64(Q, c, x):
    """1/2 x^T Q x + c^T x in float64; Q (144, B), c (12, B), x (12, B)."""
    Bn = x.shape[1]
    Qd = Q.t().reshape(Bn, 12, 12).double()
    xd = x.t().double()
    return (0.5 * torch.einsum("bi,bij,bj->b", xd, Qd, xd)
            + (c.t().double() * xd).sum(-1))


def event_ms(fn, reps):
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls captured in one CUDA
    graph and replayed, after one warm-up call: for a launch shorter than
    its wrapper's host work (K4, K5 at B = 4096; K2), where back-to-back calls
    would time the host. The calls made while capturing add to the launch
    counts; the replay does not."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# Operation counts (float32 operations: one per multiply, add, subtract,
# divide, square root, compare/select of the loops in csrc/qct_common.cuh).
# ---------------------------------------------------------------------------

_GX = 16 * 3 + 8 * 1            # (G x) over the 24 sparse rows
_GTY = 8 * 3 + 4 * 11           # (G^T z) over the 12 sparse columns
_CHOL_SOLVE = 2 * (2 * 66 + 12)  # forward + backward 12x12 triangular solves
_KKT_FLAGS = 24 * 6 + _GX + 12 * 25 + _GTY + 80
_ASSEMBLE = 10 * 9 * 4 + 78 * 2 + 4 * 30 + 24
_EQUIL = 12 * 3 + 78 * 3 + 24 * 8 + 12 * 3


def ops_barrier_iteration():
    newton = (24 * 3 + 12 * 2 + _GTY + 2 * _CHOL_SOLVE + 12 * 25 + 12
              + _GX + 24 * 2 + 24 * 4)
    chol = sum(2 * j + 3 + (11 - j) * (2 * j + 1) for j in range(12))
    return (_GX + 48 + 12 * 24 + _GTY + 12      # residuals
            + 48 + 16 * 8 + 8 * 3 + 24          # d, G^T D G, shift
            + chol + 48                          # Cholesky, mu
            + 2 * newton + 4 * (24 * 4 + 2)      # two directions, step rules
            + 24 * 5 + 6 + 24 * 4                # mu_aff, sigma, corrector rc
            + 72 + 5 + 72 + 60 * 3)              # merit, guards, update


def ops_polish_sweep(refine, ff):
    ldl = sum(3 * j + 2 + (35 - j) * (3 * j + 1) for j in range(36))
    solve = 4 * 630 + 36
    plain_res = 12 * 24 + 40 * 3 + 24 * 8
    ff_term = 25                                  # two_prod 17, two_sum 6, 2
    ff_dual = 4 * 49 * ff_term + 4 * 49
    ff_primal = (24 * 2 + 40) * ff_term + 24 * 6
    passes = 0
    for k in range(refine):
        if not ff or (k == 0 and refine > 1):
            passes += plain_res
        else:
            passes += ff_dual + ff_primal
    return (100 + ldl + (1 + refine) * solve + passes + 36 * refine
            + ff_dual + _GX + 24 + 72 + 36 + 24 * 6)


def ops_fused(sched, iters_run, sweeps_run_main, sweeps_run_prox, B):
    """Operations of one launch from what THIS run's data needed:
    ``iters_run`` / ``sweeps_run_*`` are totals over the batch as counted by
    the kernel (a certified lane leaves the sweep loop early)."""
    per_lane = _ASSEMBLE + _EQUIL + 2 * _KKT_FLAGS + 60 * 3
    if sched["prox_steps"] > 0:
        per_lane += sched["prox_steps"] * (_EQUIL + 60 * 8 + _KKT_FLAGS)
    total = B * per_lane + iters_run * ops_barrier_iteration()
    total += sweeps_run_main * ops_polish_sweep(sched["polish_refine"],
                                                sched["ff_refine"])
    total += sweeps_run_prox * ops_polish_sweep(sched["polish_refine"], False)
    return total


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    log("== phase 1: device")
    smi = run_text("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader")
    log(f"nvidia-smi: {smi}")
    if not smi:
        fail("nvidia-smi gave no name and power limit for the card")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch.version.cuda {torch.version.cuda}")
    log("nvcc: " + run_text("nvcc --version | tail -n 2 | head -n 1"))
    return smi


def phase_build():
    log("== phase 2: build the kernels (nvcc, sm_90a)")
    t0 = time.time()
    kernels.load()
    secs = time.time() - t0
    for line in kernels.last_build_log.splitlines():
        if "registers" in line or "stack frame" in line or line.startswith("=="):
            log("  " + line.strip())
    log(f"build + load: {secs:.1f} s (set-up time)")
    return secs


# Tolerances of K2 against its plain version per output (Q, c, G, h): (rtol,
# atol), those of the CPU tests of the plain version against the reference.
_K2_TOLS = {False: ((2e-5, 1e-4), (2e-5, 2e-2), (1e-6, 1e-6), (1e-6, 1e-6)),
            True: ((3e-5, 3e-5),) * 4}


def hold_assembly_to_plain(K, P, equilibrated):
    """Fail unless K2's outputs ``K`` agree with its plain version's ``P``
    within the stated tolerances. Returns the largest absolute error."""
    worst = 0.0
    for nm, a, b_, (rtol, atol) in zip("QcGh", K, P, _K2_TOLS[equilibrated]):
        err = (a - b_).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b_, rtol=rtol, atol=atol):
            fail(f"kernel K2 equilibrated={equilibrated}: {nm} max abs err "
                 f"{err:.3e} beyond rtol {rtol} atol {atol}")
    return worst


def same_values(a, b):
    """Equal values (+0 == -0, as torch.equal compares), a NaN equal to any
    NaN (a poisoned lane's residuals)."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def hold_fused_to_plain(name, kern, plain, dense):
    """Fail unless K1's outputs ``kern`` = (x, s, z, diag) equal its plain
    version's ``plain`` on the same inputs, bit for bit in every value (a
    NaN equal to any NaN): the same algorithm in the same operation order
    (``-fmad=false``, ``1.0f / sqrtf``, ``__fmul_rn`` / ``__fadd_rn`` in the
    Dekker helpers). Also reported: the objective gap (float64, on the dense
    ``(Q, c)`` of these inputs), the converged fractions and the
    certificate agreement. Returns (max |dx|, certificate agreement)."""
    xk, _, _, dk = kern
    xp, _, _, dp = plain
    Q, c = dense
    ok_ = objective64(Q, c, xk)
    op_ = objective64(Q, c, xp)
    both = torch.isfinite(ok_) & torch.isfinite(op_)
    rel = (torch.abs(ok_ - op_) / (1.0 + torch.abs(op_)))[both].cpu().numpy()
    conv_k, conv_p = dk[1].mean().item(), dp[1].mean().item()
    cert_agree = (dk[0] == dp[0]).float().mean().item()
    max_abs = (xk - xp)[:, both].abs().max().item()
    bitwise = all(same_values(a, b) for a, b in zip(kern, plain))
    log(f"  {name}: objective gap median {np.median(rel):.2e} p95 "
        f"{np.percentile(rel, 95):.2e}; conv kernel {conv_k:.4f} plain "
        f"{conv_p:.4f}; cert agreement {cert_agree:.4f}; max|dx| "
        f"{max_abs:.2e}; bitwise {bitwise}")
    if not bitwise:
        fail(f"kernel K1 {name} is not bitwise equal to its plain version")
    return max_abs, cert_agree


def compare_fused(name, inp, dense, warm, **kw):
    """Launch K1 and its plain version on the same inputs; hold the kernel
    to the plain version. Returns the kernel's outputs."""
    bal = mit_cheetah_config().balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    sched = pf.FusedSchedule(**base, **kw)
    kern = pf.solve_grf_qp_fused_packed(*inp, *warm, **base, **kw)
    plain = pf._fused_plain(*inp, warm if warm else None, sched)
    torch.cuda.synchronize()
    max_abs, _ = hold_fused_to_plain(f"mode {name}", kern, plain, dense)
    return kern, max_abs


def phase_kernels_vs_plain(cfg):
    log(f"== phase 3: kernels vs plain PyTorch versions on the card, "
        f"B = {B_CHECK}")
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    worst = {"qct_fused_solve": 0.0, "qct_assemble": 0.0}
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 1)
    for randomize in (False, True):
        log(f" randomize_params={randomize}")
        s = grf_scenarios(gen, B_CHECK, cfg, device=DEV,
                          randomize_params=randomize)
        inp = kernel_inputs(s, bal)
        dense = None
        for eq in (False, True):
            K = kernels.assemble(*inp, swing_relax=SWING_ROW_RELAX,
                                 equilibrated=eq, **base)
            P = pf._assembly_plain(*inp, swing_relax=SWING_ROW_RELAX,
                                   equilibrated=eq, **base)
            torch.cuda.synchronize()
            worst["qct_assemble"] = max(worst["qct_assemble"],
                                        hold_assembly_to_plain(K, P, eq))
            log(f"  K2 equilibrated={eq}: within tolerance "
                f"(max abs err {worst['qct_assemble']:.2e})")
            if not eq:
                dense = (K[0], K[1])
                dense_all = K

        # K1's inputs with a NaN lever on one lane and an infinite SRB
        # right-hand side on another (past the 64 lanes of the oracle
        # check): each stays uncertified, in its own lane.
        inp1 = tuple(a.clone() for a in inp)
        inp1[0][0, POISON[0]] = float("nan")
        inp1[1][2, POISON[1]] = float("inf")

        def run(name, warm=(), **kw):
            out, err = compare_fused(name, inp1, dense, warm, **kw)
            worst["qct_fused_solve"] = max(worst["qct_fused_solve"], err)
            if kw.get("polish", True):
                check(bool((out[3][0, list(POISON)] == 0.0).all()),
                      f"mode {name}: the poisoned lanes are not certified")
            return out

        bar = run("barrier-only", iterations=20, polish=False)
        run("full", iterations=20, polish_sweeps=2)
        run("polish-only", warm=bar[:3], iterations=0, polish_sweeps=4)
        zero = (torch.zeros(12, B_CHECK, device=DEV),
                torch.zeros(24, B_CHECK, device=DEV),
                torch.zeros(24, B_CHECK, device=DEV),
                -torch.ones(4, B_CHECK, device=DEV))
        zw = pf.solve_grf_qp_fused_packed(*inp1, *zero, iterations=20,
                                          polish=False, **base)
        check(all(same_values(a, b_) for a, b_ in zip(zw, bar)),
              "zero warm start with st_prev = -1 is bitwise the cold start "
              "(kernel vs kernel)")
        st_prev = inp1[2].clone()
        st_prev[:, ::3] = 1.0 - st_prev[:, ::3]   # a third of the lanes flip
        run("warm-barrier", warm=(*bar[:3], st_prev), iterations=6,
            polish_sweeps=2)
        run("prox", warm=bar[:3], iterations=0, polish_sweeps=2,
            prox_steps=2, prox_iterations=10, prox_sweeps=3)

        # float64 oracle parity of the full mode on 64 instances.
        full8 = pf.solve_grf_qp_fused_packed(*inp, iterations=20,
                                             polish_sweeps=8, **base)
        n = 64
        Qn, cn, Gn, hn = (a[:, :n].t().double().cpu().numpy()
                          for a in dense_all)
        _, obj_star, kkt = solve_qp_batch_oracle(
            Qn.reshape(n, 12, 12), cn, Gn.reshape(n, 24, 12), hn,
            s.stance[:n].cpu().numpy(), bal.fz_min, bal.fz_max)
        obj = objective64(dense[0][:, :n], dense[1][:, :n],
                          full8[0][:, :n]).cpu().numpy()
        cert = full8[3][0, :n].cpu().numpy() > 0.5
        rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
        log(f"  oracle parity (full mode, n={n}, certified {cert.sum()}): "
            f"objective rel gap median {np.median(rel[cert]):.2e} max "
            f"{rel[cert].max():.2e}; oracle KKT error max {kkt.max():.1e}")
        # The repo's 1e-6 objective bar on the median; the float32 answer of
        # an ill-conditioned instance can sit a few 1e-6 above the float64
        # optimum (its objective is a difference of ~1e4-sized terms).
        check(np.median(rel[cert]) < 1e-6 and rel[cert].max() < 1e-4
              and cert.mean() > 0.9,
              "certified instances meet the float64 oracle's objective")
    return worst


def fused_geometry(B, polish):
    """K1's launch for B QPs as the card makes it (kernels.fused_occupancy),
    logged: blocks, threads, shared bytes a block, resident blocks per SM,
    registers and local (stack) bytes per thread."""
    occ = kernels.fused_occupancy(B, polish)
    log(f"    launch: {occ['blocks']} blocks of {occ['threads']} threads "
        f"({occ['qps_per_block']} QPs x {occ['lanes']} lanes), "
        f"{occ['shared_bytes']} B of shared memory a block, "
        f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
        f"registers and {occ['local_bytes']} B of stack a thread "
        f"({'polish' if polish else 'barrier-only'} kernel)")
    return occ


def phase_main_shapes(cfg, gen):
    """Time K1 in the four launches of the main path at the shapes the main
    path gives them (and K2 at the full batch), against the plain versions
    on the same inputs; count the work each launch's data needed."""
    log(f"== phase 4a: the main path's launches one by one (B = {B_MAIN})")
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    s = grf_scenarios(gen, B_MAIN, cfg, device=DEV)
    inp = kernel_inputs(s, bal)

    def sched(**kw):
        d = dict(iterations=20, polish=True, polish_sweeps=8, polish_refine=4,
                 prox_steps=0, prox_iterations=10, prox_sweeps=None,
                 ff_refine=True)
        d.update(kw)
        return d

    def subset(tensors, idx):
        return tuple(a[:, idx].contiguous() for a in tensors)

    modes = []
    # 1. barrier-only, everyone.
    k1 = sched(iterations=20, polish=False)
    bar = pf.solve_grf_qp_fused_packed(*inp, **base, **k1)
    modes.append(("barrier", inp, (), k1))
    # 2. polish-only, everyone.
    k2 = sched(iterations=0, polish_sweeps=2)
    pol = pf.solve_grf_qp_fused_packed(*inp, *bar[:3], **base, **k2)
    modes.append(("polish", inp, bar[:3], k2))
    # 3. the two-phase tail: the JAX package's slice (B/8 here), long
    #    schedule.
    idx = pf._worst_first(pol[3][1] > 0.5,
                          pf.two_phase_tail_size(B_MAIN, 16, 8))
    inp_t = subset(inp, idx)
    k3 = sched(iterations=24, polish_sweeps=16, polish_refine=4)
    tail = pf.solve_grf_qp_fused_packed(*inp_t, **base, **k3)
    modes.append(("tail", inp_t, (), k3))
    # 4. the prox stage: the JAX package's slice (1024 instances at this B
    #    and rows 16) after the merge.
    conv = pol[3][1] > 0.5
    conv[idx] = conv[idx] | (tail[3][1] > 0.5)
    idx_p = pf._worst_first(conv, min(B_MAIN, pf.prox_slice_size(
        B_MAIN, 16, True, 8, 64, "kernel")))
    inp_p = subset(inp, idx_p)
    warm_p = subset(pol[:3], idx_p)
    k4 = sched(iterations=0, polish_sweeps=6, prox_steps=6,
               prox_iterations=24, prox_sweeps=6)
    modes.append(("prox", inp_p, warm_p, k4))

    akw = dict(swing_relax=SWING_ROW_RELAX, equilibrated=False, **base)
    out = []
    for name, inp_m, warm, kw in modes:
        Bm = inp_m[0].shape[1]
        fs = pf.FusedSchedule(**base, **kw)
        work = torch.zeros((2, Bm), dtype=torch.int32, device=DEV)
        kern = kernels.fused_solve(*inp_m, warm, fs, work=work)
        t0 = time.time()
        plain = pf._fused_plain(*inp_m, warm if warm else None, fs)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        dense = kernels.assemble(*inp_m, **akw)[:2]
        err, agree = hold_fused_to_plain(f"launch {name}", kern, plain, dense)
        ms = event_ms(lambda: pf.solve_grf_qp_fused_packed(
            *inp_m, *warm, **base, **kw), 10)
        iters_run = int(work[0].sum().item())
        sweeps_run = int(work[1].sum().item())
        # Split the counted sweeps between the main polish (float-float
        # refinement) and the prox-internal polish (plain refinement).
        if kw["prox_steps"] > 0:
            w1 = torch.zeros_like(work)
            kernels.fused_solve(*inp_m, warm, fs._replace(prox_steps=0),
                                work=w1)
            main_sweeps = int(w1[1].sum().item())
        else:
            main_sweeps = sweeps_run
        ops = ops_fused(kw, iters_run, main_sweeps, sweeps_run - main_sweeps,
                        Bm)
        nbytes = 4 * Bm * (26 + 66 + sum(a.shape[0] for a in warm))
        bound_ops = ops / PEAK_F32_FLOPS * 1e3
        bound_bytes = nbytes / PEAK_BYTES * 1e3
        geo = fused_geometry(Bm, kw["polish"])
        out.append(dict(
            mode=name, batch=Bm, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            operations=ops, bytes=nbytes, max_abs_err=err,
            mean_sweeps_run=sweeps_run / Bm, cert_agreement=agree,
            geometry=geo))
        log(f"  K1 {name}: B {Bm}, kernel {ms:.3f} ms, plain {plain_ms:.0f} "
            f"ms, bound {max(bound_ops, bound_bytes):.4f} ms "
            f"({ops / Bm:.0f} operations/instance, {sweeps_run / Bm:.2f} "
            f"sweeps/instance run)")

    # K2 at the full batch: its device time through a CUDA graph (the
    # wrapper's four allocations and checks take longer than the launch),
    # and the CUDA-event time of back-to-back calls beside it; without and
    # with equilibration.
    akw_eq = dict(akw, equilibrated=True)
    g2 = graph_ms(lambda: kernels.assemble(*inp, **akw), 20)
    ms2 = event_ms(lambda: kernels.assemble(*inp, **akw), 10)
    g2e = graph_ms(lambda: kernels.assemble(*inp, **akw_eq), 20)
    ms2e = event_ms(lambda: kernels.assemble(*inp, **akw_eq), 10)
    t0 = time.time()
    P = pf._assembly_plain(*inp, **akw)
    torch.cuda.synchronize()
    plain2 = (time.time() - t0) * 1e3
    err2 = hold_assembly_to_plain(kernels.assemble(*inp, **akw), P, False)
    nbytes2 = 4 * B_MAIN * (26 + 468)
    ops2 = B_MAIN * _ASSEMBLE
    b2 = max(nbytes2 / PEAK_BYTES, ops2 / PEAK_F32_FLOPS) * 1e3
    log(f"  K2: B {B_MAIN}, kernel {g2:.4f} ms through a CUDA graph "
        f"({b2 / g2:.3f} of its bound; {ms2:.4f} ms event-timed), "
        f"equilibrated {g2e:.4f} ms ({ms2e:.4f} event-timed); plain "
        f"{plain2:.0f} ms, bound {b2:.4f} ms (bytes), max abs err vs plain "
        f"{err2:.2e}")
    k2 = dict(ms=g2, plain_ms=plain2, bound_ms=b2, bound_by="bytes",
              max_abs_err=err2, bytes=nbytes2, event_ms=ms2,
              ms_equilibrated=g2e, event_ms_equilibrated=ms2e)
    return out, k2


def phase_main_path(cfg, gen):
    log(f"== phase 4b: main path, solve_balance_qp_fused with the bench "
        f"schedule, B = {B_MAIN}, {REPS} repetitions on fresh inputs")
    bal = cfg.balance

    def solve(s):
        return pf.solve_balance_qp_fused(
            s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
            s.stance, bal, **MAIN_SCHEDULE)

    solve(grf_scenarios(gen, B_MAIN, cfg, device=DEV))   # warm-up
    scen = [grf_scenarios(gen, B_MAIN, cfg, device=DEV) for _ in range(REPS)]
    torch.cuda.synchronize()

    kernels.reset_launch_counts()                          # counts set to 0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    sols = [solve(s) for s in scen]
    t1.record()
    torch.cuda.synchronize()
    ms = t0.elapsed_time(t1) / REPS
    # The run's own check of what came out: dense problem data from the
    # assembly kernel, the float64 oracle on a subsample.
    s0, sol0 = scen[0], sols[0]
    Q, c, G, h = pf.assemble_qp_fused_debug(
        *raw_inputs(s0, bal), s_diag=tuple(bal.s_diag),
        w_diag=float(bal.w_diag))
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)                   # counts read

    conv = float(np.mean([sol.converged.float().mean().item()
                          for sol in sols]))
    log(f"  {ms:.3f} ms/solve-batch, {B_MAIN / ms * 1e3:,.0f} QPs/s, "
        f"converged fraction {conv:.5f}")
    log(f"  launch counts in the main-path run: {counts}")
    for sol in sols:
        for nm in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
            if not bool(torch.isfinite(getattr(sol, nm)).all()):
                fail(f"main path: non-finite values in {nm}")
        if tuple(sol.x.shape) != (B_MAIN, 12):
            fail(f"main path: x has shape {tuple(sol.x.shape)}")
    check(True, "every output finite, x of shape (B, 12)")
    check(conv >= 0.99, f"converged fraction {conv:.5f} >= 0.99")
    check(counts["qct_fused_solve"] == 4 * REPS,
          f"K1 launched 4 times per solve (barrier, polish, tail, prox): "
          f"{counts['qct_fused_solve']} in {REPS} solves")
    check(counts["qct_assemble"] >= 1,
          f"K2 launched {counts['qct_assemble']} time(s)")
    check(counts["qct_dense_barrier"] == counts["qct_dense_polish"] == 0,
          "the kernel prox backend launches no dense IPM kernel")

    n = 64
    _, obj_star, _ = solve_qp_batch_oracle(
        Q[:n].double().cpu().numpy(), c[:n].double().cpu().numpy(),
        G[:n].double().cpu().numpy(), h[:n].double().cpu().numpy(),
        s0.stance[:n].cpu().numpy(), bal.fz_min, bal.fz_max)
    xd = sol0.x[:n].double()
    obj = (0.5 * torch.einsum("bi,bij,bj->b", xd, Q[:n].double(), xd)
           + (c[:n].double() * xd).sum(-1)).cpu().numpy()
    rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
    log(f"  oracle parity (n={n}): objective rel gap median "
        f"{np.median(rel):.2e} max {rel.max():.2e}")
    check(np.median(rel) < 1e-6 and rel.max() < 1e-4,
          "main path meets the float64 oracle's objective (median < 1e-6)")
    return dict(ms_per_solve=ms, qps=B_MAIN / ms * 1e3, converged=conv,
                launches=counts)


# ---------------------------------------------------------------------------
# The closed-loop tick: K4 -> K1 -> K5
# ---------------------------------------------------------------------------

def to_dev(a):
    return torch.as_tensor(np.ascontiguousarray(a),
                           dtype=torch.float32).to(DEV).contiguous()


def state_comps(d):
    """whole_body_walk_states dict -> float32 (58, B) tensor on the card."""
    return to_dev(walk_state_comps(d))


def carry_comps(c):
    """commander_carry_walk dict -> float32 (95, B) tensor on the card."""
    return to_dev(walk_carry_comps(c))


# Operation counts of K4 and K5 (one per add, subtract, multiply, divide,
# square root, compare/select and sinf/cosf/atan2f call), counted from the
# loops of csrc/qct_commander.cuh and csrc/qct_substep.cuh.
def ops_commander(contact_gate):
    per_leg = (126 + 7          # sextic replan (21 x 3 products) + validity
               + 49 + 60 + 6    # position, velocity on the sextic, masks
               + 30 + 6 + 32    # R^T p, R^T v, hip-relative, IK
               + 30 + 60 + 48   # Jacobian (6 trig), two adjugates, J J^T
               + 96 + 72)       # J^-1 v with damped fallback, PD wrap chain
    if contact_gate:
        per_leg += 21 + 21 + 32 + 11   # end-of-swing target, its IK, gating
    return (30 + 128 + 10       # world twist, FK (24 trig), latch and clock
            + 220 + 24 + 220    # desired pose, gait schedule, footholds
            + 4 * per_leg
            + 280 + 30)         # PD accelerations, so3_log, SRB rhs, outputs


_OPS_SUBSTEP = (24 + 30         # sinf/cosf of q, trunk bias
                + 4 * 735       # per-leg RNEA sweep (3 joints out and back)
                + 4 * 190 + 4 * 120   # foot and trunk-corner contact points
                + 500 + 440)    # Schur solve; integration, Rodrigues, guard
_OPS_FACTOR = 4 * 1240 + 900 + 320    # per-leg CRBA + D^-1, S, Cholesky inverse
_OPS_TORQUE_MAP = 24 + 4 * 67


def ops_substep(consts, n_substeps):
    ops = n_substeps * _OPS_SUBSTEP
    if consts.prefactor_kernel:
        ops += _OPS_FACTOR
    if consts.torque_qp:
        ops += _OPS_TORQUE_MAP + (4 * 735 if consts.gravity_comp else 0)
    return ops


def bound_ms(nbytes, ops):
    b_bytes = nbytes / PEAK_BYTES * 1e3
    b_ops = ops / PEAK_F32_FLOPS * 1e3
    return max(b_bytes, b_ops), "operations" if b_ops >= b_bytes else "bytes"


_K4_NAMES = ("r", "b", "st", "mu", "fz_min", "fz_max", "tau_swing", "carry",
             "q_ref")
# K4 against its plain version, (rtol, atol) per continuous output. The same
# statements in the same order on both sides; they differ where CUDA's
# sinf/cosf/atan2f differ from PyTorch's in the last bits and where PyTorch
# divides by a constant (a multiplication by the reciprocal on CUDA). b is
# ~1e3 N (gains of 1e2..1e3 on pose errors), torques ~kp * angle error.
_K4_TOLS = {"r": (1e-5, 1e-6), "b": (1e-4, 2e-3), "tau_swing": (1e-4, 2e-3),
            "q_ref": (1e-5, 2e-5), "carry": (1e-5, 1e-5)}
_K4_DISCRETE_CARRY = [0, 2, 3, 4, 5, 6, 91, 92, 93, 94]
_K4_CONTINUOUS_CARRY = [1] + list(range(7, 91))
# Lanes whose discrete outputs may differ (a lane within one ulp of the
# phase / latch-window / gate threshold), per tick of 4096 lanes.
_K4_DISCRETE_BUDGET = 4


def hold_commander_to_plain(name, kern, plain):
    """Fail unless K4's outputs agree with its plain version's: continuous
    outputs within _K4_TOLS, discrete outputs (stance mask, standing latch,
    prev_in_stance, initialized, valid) exactly, up to _K4_DISCRETE_BUDGET
    listed lanes. Lanes with a discrete mismatch are left out of the
    continuous comparison (their branches differ). Returns the largest
    absolute error of a continuous output."""
    k = dict(zip(_K4_NAMES, kern))
    p = dict(zip(_K4_NAMES, plain))
    bad = (k["st"] != p["st"]).any(0) | (
        k["carry"][_K4_DISCRETE_CARRY] != p["carry"][_K4_DISCRETE_CARRY]
    ).any(0)
    lanes = torch.nonzero(bad).flatten().tolist()
    if lanes:
        log(f"  {name}: discrete outputs differ on lanes {lanes}")
    if len(lanes) > _K4_DISCRETE_BUDGET:
        fail(f"K4 {name}: {len(lanes)} lanes with different discrete outputs")
    for nm in ("mu", "fz_min", "fz_max"):
        if not torch.equal(k[nm], p[nm]):
            fail(f"K4 {name}: {nm} differs")
    good = ~bad
    worst = 0.0
    for nm, (rtol, atol) in _K4_TOLS.items():
        a, b_ = k[nm], p[nm]
        if nm == "carry":
            a, b_ = a[_K4_CONTINUOUS_CARRY], b_[_K4_CONTINUOUS_CARRY]
        a, b_ = a[:, good], b_[:, good]
        err = (a - b_).abs().max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b_, rtol=rtol, atol=atol):
            fail(f"K4 {name}: {nm} max abs err {err:.3e} beyond rtol {rtol} "
                 f"atol {atol}")
    return worst


def commander_serial(consts, state, carry, cmd, **kw):
    """K4's serial body (one instance per thread, the kernel's first form;
    ``kernels.commander_serial``) with commander_pre_packed's options: the
    reference K4 is held to bit for bit."""
    return kernels.commander_serial(state, carry, cmd, consts.params(
        kw.get("contact_gate", 0.0), kw.get("raibert_cmd_symmetric", False),
        kw.get("mpc_horizon", 0), kw.get("mpc_dt", 0.0)))


def hold_commander_to_serial(name, kern, serial):
    """Fail unless every output of K4 (the MPC block too) is bitwise its
    serial body's, a NaN equal to any NaN."""
    if len(kern) != len(serial):
        fail(f"K4 {name}: {len(kern)} outputs, its serial body {len(serial)}")
    for nm, a, b_ in zip(_K4_NAMES + ("mpc block",), kern, serial):
        same = ((a.view(torch.int32) == b_.view(torch.int32))
                | (a.isnan() & b_.isnan()))
        if not bool(same.all()):
            lanes = torch.nonzero(~same.all(0)).flatten().tolist()
            fail(f"K4 {name}: {nm} not bitwise its serial body on "
                 f"{len(lanes)} lanes (first {lanes[:8]})")


# The ragged batch of the K4 holds: lane 3 has a NaN body rate and a NaN
# thigh angle, lane 17 an infinite forward command, lane 29 a base 3 m up
# with straight knees (every swing target out of reach: the IK straightens
# the knee, and the Jacobian at q_ref is singular).
B_RAGGED = 1061


def hold_commander_poisoned(name, consts, state, carry, cmd, **kw):
    """K4 on the first B_RAGGED lanes of (state, carry, cmd) with the
    poisoned lanes, bitwise its serial body."""
    st, ca, cm = (a[:, :B_RAGGED].contiguous() for a in (state, carry, cmd))
    st[13, 3] = float("nan")
    st[34, 3] = float("nan")
    cm[0, 17] = float("inf")
    st[11, 29] = 3.0
    st[[32, 35, 38, 41], 29] = 0.0
    kern = fcmd.commander_pre_packed(st, ca, cm, consts=consts, **kw)
    serial = commander_serial(consts, st, ca, cm, **kw)
    torch.cuda.synchronize()
    hold_commander_to_serial(f"{name} (ragged B = {B_RAGGED}, poisoned "
                             f"lanes)", kern, serial)
    check(bool(kern[1][3:, 3].isnan().all())
          and not bool(torch.isfinite(kern[1][:, 17]).all())
          and bool((kern[8][2::3, 29] == 0).any()),
          f"K4 {name}: the poisoned lanes (a NaN rhs, a non-finite rhs, a "
          f"straight knee at q_ref)")


def commander_geometry(B):
    """K4's launch for B instances on the card, and its serial body's:
    geometry, resident blocks per SM, registers, stack."""
    occ = kernels.commander_occupancy(B)
    ser = occ["serial"]
    log(f"  K4 at B = {B}: {occ['blocks']} blocks of {occ['threads']} "
        f"threads ({occ['robots_per_block']} instances, {occ['lanes']} "
        f"lanes each); "
        f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
        f"registers, {occ['local_bytes']} B of stack. Its serial body: "
        f"{ser['blocks']} blocks of {ser['threads']} threads, "
        f"{ser['blocks_per_sm']} blocks per SM, {ser['registers']} "
        f"registers, {ser['local_bytes']} B of stack")
    check(occ["blocks_per_sm"] >= 1, "K4's block fits an SM")
    return occ


def phase_commander_vs_plain(cfg):
    log(f"== phase 5: K4 (commander-pre) vs its serial body (bitwise) and "
        f"its plain version on the card, "
        f"B = {B_TICK}, 8 chained ticks per option set")
    consts = fcmd.CommanderConsts(cfg, 1.0 / cfg.frequency)
    worst = 0.0
    for gate, sym in ((0.0, False), (0.01, True)):
        carry = carry_comps(commander_carry_walk(SEED + 20, B_TICK, cfg))
        crossed = dict(latch=0, gait_start=0, swing_edges=0, replans=0)
        for t in range(8):
            d = whole_body_walk_states(SEED + 30 + t, B_TICK, cfg)
            state, cmd = state_comps(d), to_dev(d["cmd"].T)
            kw = dict(contact_gate=gate, raibert_cmd_symmetric=sym)
            kern = fcmd.commander_pre_packed(state, carry, cmd,
                                             consts=consts, **kw)
            serial = commander_serial(consts, state, carry, cmd, **kw)
            plain = fcmd.commander_pre_plain(consts, state, carry, cmd, **kw)
            torch.cuda.synchronize()
            hold_commander_to_serial(f"gate={gate} sym={sym} tick {t}", kern,
                                     serial)
            worst = max(worst, hold_commander_to_plain(
                f"gate={gate} sym={sym} tick {t}", kern, plain))
            new = kern[7]
            crossed["latch"] += int(((new[0] > 0.5) & (carry[0] < 0.5)).sum())
            crossed["gait_start"] += int(((new[1] >= 0) & (carry[1] < 0)).sum())
            crossed["swing_edges"] += int(
                ((new[2:6] < 0.5) & (carry[2:6] > 0.5)).sum())
            crossed["replans"] += int((new[7:91] != carry[7:91]).any(0).sum())
            carry = new   # both sides continue from the kernel's carry
        hold_commander_poisoned(f"gate={gate} sym={sym}", consts, state,
                                carry, cmd, **kw)
        log(f"  contact_gate={gate} raibert_cmd_symmetric={sym}: bitwise its "
            f"serial body and within tolerance of the plain version over 8 "
            f"ticks, bitwise its serial body on the ragged poisoned batch; "
            f"crossed {crossed}")
        check(all(v > 0 for v in crossed.values()),
              "the ticks crossed the standing latch, the gait start, "
              "stance->swing edges and replans")
    log(f"  K4 worst abs err of a continuous output: {worst:.3e}")
    return worst, commander_geometry(B_TICK)


# K5 against its plain version after N_SUBSTEPS substeps: the plain version
# runs the same physics as batched tensor operations in another order, and
# the contact stiffness (3e4 N/m at h = 3.3e-4 s) amplifies round-off from
# substep to substep. Poses (R, x, q, anchor): (rtol, atol); velocities:
# (rtol, atol), per contact model. With anchor stiction (the main path's
# model, and every whole tick) the largest velocity error seen is 3.3e-4, so
# a term of the size of gravity's 0.03 per tick cannot hide. Regularized
# Coulomb friction is a steep viscous term below the stiction velocity, which
# amplifies round-off in a foot's slip velocity: the worst lane seen is off
# by 1.9e-2 on a joint velocity of 5.3 after 10 substeps (35 of 4096 lanes
# beyond 1e-3), and hold_substep_to_plain names it.
_K5_POSE_TOL = (1e-4, 5e-5)
_K5_VEL_TOL = {"anchor": (2e-4, 1e-3), "coulomb": (2e-3, 2e-2)}
_POSE_ROWS = list(range(0, 12)) + list(range(30, 58))
_VEL_ROWS = list(range(12, 30))


def hold_substep_to_plain(name, kern, plain, tangential="anchor"):
    worst = 0.0
    for what, rows, (rtol, atol) in (
            ("poses", _POSE_ROWS, _K5_POSE_TOL),
            ("velocities", _VEL_ROWS, _K5_VEL_TOL[tangential])):
        a, b_ = kern[rows], plain[rows]
        diff = (a - b_).abs()
        err = diff.max().item()
        worst = max(worst, err)
        if not torch.allclose(a, b_, rtol=rtol, atol=atol):
            fail(f"K5 {name}: {what} max abs err {err:.3e} beyond rtol "
                 f"{rtol} atol {atol}")
        if what == "velocities" and tangential == "coulomb":
            row, lane = divmod(int(diff.argmax().item()), diff.shape[1])
            log(f"    {name}: worst velocity, row {_VEL_ROWS[row]} of lane "
                f"{lane}: kernel {a[row, lane].item():.5f} plain "
                f"{b_[row, lane].item():.5f}; lanes beyond the anchor "
                f"model's atol of {_K5_VEL_TOL['anchor'][1]}: "
                f"{int((diff.max(0).values > _K5_VEL_TOL['anchor'][1]).sum())}"
                f" of {diff.shape[1]}")
    return worst


def substep_serial(stepper, state, extras, dt, n_substeps):
    """K5's serial body (one robot per thread, the kernel's first form;
    ``kernels.substep_serial``) on the stepper's inputs: the reference K5
    is held to bit for bit."""
    return kernels.substep_serial(
        state, extras, stepper.streamed(state),
        kernels.substep_params(stepper.consts), int(n_substeps),
        float(dt) / int(n_substeps))


def hold_substep_to_serial(name, kern, serial):
    """Fail unless K5's new states are bitwise those of its serial body."""
    if not torch.equal(kern.view(torch.int32), serial.view(torch.int32)):
        diff = (kern != serial) & ~(kern.isnan() & serial.isnan())
        lanes = torch.nonzero(diff.any(0)).flatten().tolist()
        fail(f"K5 {name}: not bitwise its serial body on {len(lanes)} lanes "
             f"(first {lanes[:8]})")


def substep_geometry(B):
    """K5's launch for B robots on the card: geometry, resident blocks per
    SM, registers, stack."""
    occ = kernels.substep_occupancy(B)
    log(f"  K5 at B = {B}: {occ['blocks']} blocks of {occ['threads']} "
        f"threads ({occ['robots_per_block']} robots, {occ['lanes']} lanes "
        f"each), {occ['shared_bytes']} B of shared memory a block; "
        f"{occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
        f"registers, {occ['local_bytes']} B of stack")
    check(occ["blocks_per_sm"] >= 1, "K5's block fits an SM")
    return occ


def substep_inputs(cfg, seed, torque_input):
    rng = np.random.default_rng(seed)
    B = B_TICK
    state = state_comps(whole_body_walk_states(seed, B, cfg, on_ground=True))
    if torque_input == "qp":
        fw = rng.uniform(-5.0, 5.0, (12, B))
        fw[2::3] = rng.uniform(10.0, 40.0, (4, B))
        extras = (to_dev(fw), to_dev(rng.uniform(-3.0, 3.0, (12, B))),
                  to_dev(rng.uniform(size=(4, B)) < 0.7))
    else:
        extras = (to_dev(rng.uniform(-8.0, 8.0, (12, B))),)
    return state, extras


def phase_substep_vs_plain(cfg):
    log(f"== phase 6: K5 (substeps) vs its serial body (bitwise) and its "
        f"plain version on the card, B = {B_TICK}, {N_SUBSTEPS} substeps")
    dt = 1.0 / cfg.frequency
    worst = 0.0
    stats = {}
    for name, model_fn, contact, prefactor, torque_input, gc in (
            ("qp + kernel factor + gravity_comp", mit_cheetah_whole_body_model,
             ContactConfig(), "kernel", "qp", True),
            ("tau + streamed factor, published-inertia model",
             mit_cheetah_urdf_model, ContactConfig(), "xla", "tau", False),
            ("qp + kernel factor, Coulomb contact",
             mit_cheetah_whole_body_model,
             ContactConfig(tangential="coulomb"), "kernel", "qp", False)):
        model = model_fn(cfg)
        stepper = fsub.make_fused_stepper(
            model, cfg, contact, prefactor=prefactor,
            torque_input=torque_input, gravity_comp=gc)
        state, extras = substep_inputs(cfg, SEED + 50, torque_input)
        kern = stepper.packed(state, *extras, dt, N_SUBSTEPS)
        serial = substep_serial(stepper, state, extras, dt, N_SUBSTEPS)
        torch.cuda.synchronize()
        hold_substep_to_serial(name, kern, serial)
        t0 = time.time()
        plain = stepper.plain(state, *extras, dt, N_SUBSTEPS)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        err = hold_substep_to_plain(name, kern, plain, contact.tangential)
        worst = max(worst, err)
        log(f"  {name}: bitwise its serial body; within tolerance of the "
            f"plain version (max abs err {err:.3e}), every value finite: "
            f"{bool(torch.isfinite(kern).all())}")
        if not bool(torch.isfinite(kern).all()):
            fail(f"K5 {name}: non-finite output")
        stats[name] = dict(plain_ms=plain_ms)

        # The guard: a NaN joint velocity freezes the lane for that substep
        # (pose kept, velocity zeroed); a 1e6 one is clamped to 200. Neither
        # leaks into a neighbouring lane.
        bad = state.clone()
        bad[18, 0] = float("nan")
        bad[19, 1] = 1.0e6
        k1 = stepper.packed(bad, *extras, dt / N_SUBSTEPS, 1)
        p1 = stepper.plain(bad, *extras, dt / N_SUBSTEPS, 1)
        ref1 = stepper.packed(state, *extras, dt / N_SUBSTEPS, 1)
        s1 = substep_serial(stepper, bad, extras, dt / N_SUBSTEPS, 1)
        torch.cuda.synchronize()
        hold_substep_to_serial(name + " (poisoned lanes, 1 substep)", k1, s1)
        for nm, out in (("kernel", k1), ("plain", p1)):
            frozen = (torch.equal(out[_POSE_ROWS, 0], bad[_POSE_ROWS, 0])
                      and bool((out[_VEL_ROWS, 0] == 0).all()))
            clamped = (bool(torch.isfinite(out[:, 1]).all())
                       and out[_VEL_ROWS, 1].abs().max().item() <= 200.0
                       and out[19, 1].item() > 100.0)
            if not (frozen and clamped and bool(torch.isfinite(out).all())):
                fail(f"K5 {name}: guard failed in the {nm} version (frozen "
                     f"{frozen}, clamped {clamped})")
        if not torch.equal(k1[:, 2:], ref1[:, 2:]):
            fail(f"K5 {name}: a poisoned lane changed its neighbours")
        kn = stepper.packed(bad, *extras, dt, N_SUBSTEPS)
        pn = stepper.plain(bad, *extras, dt, N_SUBSTEPS)
        sn = substep_serial(stepper, bad, extras, dt, N_SUBSTEPS)
        torch.cuda.synchronize()
        hold_substep_to_serial(name + f" (poisoned lanes, {N_SUBSTEPS} "
                               f"substeps)", kn, sn)
        if not (bool(torch.isfinite(kn).all()) and torch.equal(
                kn[:, 2:], kern[:, 2:])):
            fail(f"K5 {name}: poisoned lanes after {N_SUBSTEPS} substeps")
        hold_substep_to_plain(name + " (poisoned lanes)", kn[:, :1],
                              pn[:, :1], contact.tangential)
        log("    guard: the NaN lane froze for its substep, the 1e6 lane was "
            "clamped to 200, the other lanes are bitwise unchanged; bitwise "
            "the serial body with the poisoned lanes")
        # A ragged batch: the last block's robot slots past B.
        Br = 1061
        cut = tuple(a[:, :Br].contiguous() for a in (bad, *extras))
        hold_substep_to_serial(
            name + f" (ragged B = {Br})",
            stepper.packed(cut[0], *cut[1:], dt, N_SUBSTEPS),
            substep_serial(stepper, cut[0], cut[1:], dt, N_SUBSTEPS))
    stats["geometry"] = substep_geometry(B_TICK)
    return worst, stats


def tick_vs_plain(name, tick, model, cfg, contact, state_p, carry_p, warm_p,
                  cmd_p):
    """One tick through the kernels and, on the same inputs, through the
    plain versions: K4 outputs (levers, rhs, stance, ...), the QP at the
    objective level, and the state after the substeps. Returns the kernels'
    (state, carry, warm) and the QP launch's max |dx| against its plain
    version."""
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    dt = tick.consts.dt
    kern4 = tick.pre(state_p, carry_p, cmd_p)
    serial4 = commander_serial(tick.consts, state_p, carry_p, cmd_p)
    plain4 = fcmd.commander_pre_plain(tick.consts, state_p, carry_p, cmd_p)
    torch.cuda.synchronize()
    hold_commander_to_serial(name, kern4, serial4)
    e4 = hold_commander_to_plain(name, kern4, plain4)
    qp_in = tuple(kern4[:6])
    sched = dict(iterations=6, polish=True, polish_sweeps=8, polish_refine=4)
    kern1 = pf.solve_grf_qp_fused_packed(*qp_in, *warm_p, **base, **sched)
    plain1 = pf._fused_plain(*qp_in, warm_p, pf.FusedSchedule(**base, **sched))
    dense = kernels.assemble(*qp_in, swing_relax=SWING_ROW_RELAX,
                             equilibrated=False, **base)[:2]
    torch.cuda.synchronize()
    e1, _ = hold_fused_to_plain(name + " QP (warm-6)", kern1, plain1, dense)
    extras = (kern1[0], kern4[6], kern4[2])
    kern5 = tick.stepper.packed(state_p, *extras, dt, N_SUBSTEPS)
    plain5 = tick.stepper.plain(state_p, *extras, dt, N_SUBSTEPS)
    serial5 = substep_serial(tick.stepper, state_p, extras, dt, N_SUBSTEPS)
    torch.cuda.synchronize()
    hold_substep_to_serial(name, kern5, serial5)
    e5 = hold_substep_to_plain(name, kern5, plain5)
    log(f"  {name}: K4 bitwise its serial body and within tolerance of the "
        f"plain version (max {e4:.2e}), QP objective within "
        f"the 1e-6 bar (max|dx| {e1:.2e}), state after the tick bitwise K5's "
        f"serial body and within tolerance of the plain version (max "
        f"{e5:.2e})")
    return kern5, kern4[7], (kern1[0], kern1[1], kern1[2], kern4[2]), e1


def tail_vs_plain(cfg, tick_tail, res, cmd_p):
    """The tail's launch of K1 (the second of a ``qp_tail`` tick) at the
    tick's shape, on the state ``res`` of a tail run: the barrier-only solve,
    the compaction of its worst quarter, then the warm-seeded polish + prox
    launch against its plain version on the same B / 4 inputs, and
    solve_grf_qp_tail_packed's merge against the same launch's result.
    Returns the launch's max |dx|."""
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    state_p, B = ftick.pack_whole_body_state(res.plant)
    carry_p = fcmd.pack_commander_carry(res.carry)
    qp_in = tuple(tick_tail.pre(state_p, carry_p, cmd_p)[:6])
    first = pf.solve_grf_qp_fused_packed(*qp_in, *res.warm, **base,
                                         iterations=6, polish=False)
    conv = first[3][1] > 0.5
    check(int((~conv).sum()) > 0, "the barrier-only solve leaves lanes to the "
          "tail on this state")
    idx = pf._worst_first(conv, B // 4)
    taken = tuple(a[:, idx].contiguous() for a in qp_in)
    warm3 = tuple(a[:, idx].contiguous() for a in first[:3])
    # make_fused_tick's tail defaults (qp_tail_sweeps, qp_tail_prox_*).
    sched = dict(iterations=0, polish=True, polish_sweeps=24, polish_refine=4,
                 prox_steps=2, prox_iterations=8, ff_refine=False)
    kern = pf.solve_grf_qp_fused_packed(*taken, *warm3, **base, **sched)
    plain = pf._fused_plain(*taken, warm3, pf.FusedSchedule(**base, **sched))
    dense = kernels.assemble(*taken, swing_relax=SWING_ROW_RELAX,
                             equilibrated=False, **base)[:2]
    torch.cuda.synchronize()
    err, _ = hold_fused_to_plain(
        f"tail launch, B / 4 = {B // 4} ({int((~conv).sum())} uncertified "
        f"of {B})", kern, plain, dense)
    fused_geometry(B // 4, True)
    merged = pf.solve_grf_qp_tail_packed(*qp_in, *first, **base)
    better = (kern[3][1] > 0.5) & ~conv[idx]
    for nm, m, a2, a1 in zip(("x", "s", "z", "diag"), merged, kern, first):
        want = a1.clone()
        want[:, idx] = torch.where(better[None, :], a2, a1[:, idx])
        check(torch.equal(m, want), f"solve_grf_qp_tail_packed merges the "
              f"same launch's {nm} into the lanes it newly certifies")
    log(f"  tail: converged {conv.float().mean().item():.4f} before, "
        f"{(merged[3][1] > 0.5).float().mean().item():.4f} after")
    check((merged[3][1] > 0.5).sum() >= conv.sum(),
          "the tail loses no certified lane")
    return err


def phase_tick(cfg):
    log(f"== phase 7: the closed-loop tick, B = {B_TICK}, n_substeps = "
        f"{N_SUBSTEPS}: make_fused_tick(gravity_comp=True) with its "
        f"defaults (warm start, 6 barrier iterations, polish on)")
    B = B_TICK
    model = mit_cheetah_whole_body_model(cfg)
    contact = ContactConfig()
    tick = ftick.make_fused_tick(model, cfg, contact, gravity_comp=True)
    plant = init_whole_body_state(cfg, (B,))
    carry = init_commander_carry((B,))
    cmd0 = torch.zeros(6, device=DEV)

    # The first 3 ticks through the plain versions as well.
    state_p, _ = ftick.pack_whole_body_state(plant)
    carry_p = fcmd.pack_commander_carry(carry)
    warm_p = ftick.init_qp_warm_packed(B)
    cmd_p = torch.zeros((6, B), device=DEV)
    k1_errs = []
    for t in range(3):
        state_p, carry_p, warm_p, e1 = tick_vs_plain(
            f"stand-up tick {t + 1}", tick, model, cfg, contact, state_p,
            carry_p, warm_p, cmd_p)
        k1_errs.append(e1)

    def drive(plant, carry, cmd, steps, tck, warm=None):
        kernels.reset_launch_counts()              # counts set to 0
        t0 = time.time()
        res = ftick.rollout_whole_body_fused(
            plant, carry, cmd, steps, tck, n_substeps=N_SUBSTEPS,
            record=True, warm=warm)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)       # counts read
        for nm, a in (("R", res.plant.R), ("x", res.plant.x),
                      ("u", res.plant.u), ("q", res.plant.q),
                      ("anchor", res.plant.anchor), ("trace x", res.trace.x)):
            if not bool(torch.isfinite(a).all()):
                fail(f"tick: non-finite values in {nm}")
        return res, counts, time.time() - t0

    # Stand-up from the laying pose.
    res, counts, secs = drive(plant, carry, cmd0, 600, tick)
    z = res.plant.x[:, 2]
    up = res.plant.R[:, 2, 2]
    conv = res.trace.qp_converged.float().mean().item()
    standing = res.carry.standing.float().mean().item()
    log(f"  stand-up 600 ticks in {secs:.2f} s: z mean {z.mean().item():.4f} "
        f"(min {z.min().item():.4f}), R22 min {up.min().item():.4f}, "
        f"standing {standing:.3f}, QP converged {conv:.4f}")
    log(f"  launch counts in the stand-up run: {counts}")
    check(abs(z.mean().item() - cfg.stand.height) < 0.015,
          "stand-up: |mean z - 0.26| < 0.015")
    check(up.min().item() > 0.98, "stand-up: min R22 > 0.98")
    check(standing > 0.9, "stand-up: standing fraction > 0.9")
    check(conv > 0.98, "stand-up: QP converged fraction > 0.98")
    check(counts["qct_commander_pre"] == 600
          and counts["qct_fused_solve"] == 600
          and counts["qct_substep"] == 600 and counts["qct_assemble"] == 0
          and counts["qct_substep_serial"] == 0
          and counts["qct_commander_serial"] == 0,
          "exactly 3 launches per tick (K4, K1, K5)")
    launches = dict(counts)

    # A 0.2 m/s trot (+-10 % by lane, seeded).
    rng = np.random.default_rng(SEED + 40)
    cmd_np = np.zeros((B, 6))
    cmd_np[:, 0] = 0.2 + 0.02 * rng.uniform(-1.0, 1.0, B)
    cmd = to_dev(cmd_np)
    x0 = res.plant.x[:, 0].clone()
    res2, counts2, secs2 = drive(res.plant, res.carry, cmd, 600, tick,
                                 warm=res.warm)
    up2 = res2.plant.R[:, 2, 2]
    upright = (up2 > 0.9).float().mean().item()
    xtrav = (res2.plant.x[:, 0] - x0).mean().item()
    conv2 = res2.trace.qp_converged.float().mean().item()
    swing = 1.0 - res2.trace.in_stance.float().mean().item()
    log(f"  trot 600 ticks in {secs2:.2f} s: x travel mean {xtrav:.3f} m, z "
        f"mean {res2.plant.x[:, 2].mean().item():.4f}, upright fraction "
        f"{upright:.4f}, QP converged {conv2:.4f}, swing share {swing:.3f}")
    log(f"  launch counts in the trot run: {counts2}")
    check(upright > 0.95, "trot: upright fraction (R22 > 0.9) > 0.95")
    check(xtrav > 0.15, "trot: mean x travel > 0.15 m")
    check(swing > 0.02, "trot: legs swing")
    check(counts2["qct_commander_pre"] == 600
          and counts2["qct_fused_solve"] == 600
          and counts2["qct_substep"] == 600
          and counts2["qct_substep_serial"] == 0
          and counts2["qct_commander_serial"] == 0,
          "exactly 3 launches per tick in the trot")
    for k_ in launches:
        launches[k_] += counts2[k_]

    # One mid-trot tick through the plain versions as well (lanes differ).
    state_p, _ = ftick.pack_whole_body_state(res2.plant)
    carry_p = fcmd.pack_commander_carry(res2.carry)
    cmd_p = cmd.t().contiguous()
    k1_errs.append(tick_vs_plain("mid-trot tick", tick, model, cfg, contact,
                                 state_p, carry_p, res2.warm, cmd_p)[3])

    # The certification tail: 4 launches per tick.
    tick_tail = ftick.make_fused_tick(model, cfg, contact, gravity_comp=True,
                                      qp_polish=False, qp_tail=True)
    res3, counts3, secs3 = drive(res.plant, res.carry, cmd, 100, tick_tail)
    conv3 = res3.trace.qp_converged.float().mean().item()
    log(f"  qp_polish=False, qp_tail=True, 100 ticks in {secs3:.2f} s: "
        f"launch counts {counts3}, QP converged {conv3:.4f}, upright "
        f"{(res3.plant.R[:, 2, 2] > 0.9).float().mean().item():.4f}")
    check(counts3["qct_commander_pre"] == 100
          and counts3["qct_fused_solve"] == 200
          and counts3["qct_substep"] == 100
          and counts3["qct_substep_serial"] == 0
          and counts3["qct_commander_serial"] == 0,
          "exactly 4 launches per tick with the tail (K4, K1, K1, K5)")
    check(conv3 > 0.93, "tail run: QP converged fraction > 0.93 (a 6-iteration "
          "barrier with no polish, then the tail on the worst quarter)")
    # The tail's own launch, on the inputs of the run's hardest tick.
    hardest = int(res3.trace.qp_converged.float().mean(1).argmin().item())
    before = ftick.rollout_whole_body_fused(
        res.plant, res.carry, cmd, hardest, tick_tail, n_substeps=N_SUBSTEPS)
    log(f"  the tail run's hardest tick is tick {hardest + 1} (converged "
        f"{res3.trace.qp_converged[hardest].float().mean().item():.4f})")
    k1_errs.append(tail_vs_plain(cfg, tick_tail, before, cmd_p))

    times = phase_tick_times(cfg, tick, model, contact, res, res2, cmd)
    times["k1_tick"]["max_abs_err"] = max(k1_errs)
    times.update(launches=launches, stand=dict(
        z_mean=z.mean().item(), standing=standing, converged=conv),
        trot=dict(x_travel=xtrav, upright=upright, converged=conv2),
        objects=dict(tick=tick, model=model, res=res, cmd=cmd))
    return times


def phase_tick_times(cfg, tick, model, contact, res, res2, cmd):
    log("== phase 8: times of the tick and of its three launches")
    B = B_TICK
    dt = tick.consts.dt
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))

    # ms per tick, marginal: (450 ticks - 50 ticks) / 400, trot from the
    # stood-up state, nothing recorded.
    def run(steps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        h0 = time.time()
        t0.record()
        ftick.rollout_whole_body_fused(
            res.plant, res.carry, cmd, steps, tick, n_substeps=N_SUBSTEPS,
            warm=res.warm)
        h1 = time.time()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1), (h1 - h0) * 1e3

    run(50)
    best = {50: (1e30, 0.0), 450: (1e30, 0.0)}
    for _ in range(2):
        for steps in (50, 450):
            best[steps] = min(best[steps], run(steps))
    ms_tick = (best[450][0] - best[50][0]) / 400.0
    host_ms_tick = (best[450][1] - best[50][1]) / 400.0
    log(f"  tick: {ms_tick:.4f} ms/tick (CUDA events, marginal 450 - 50 "
        f"ticks), {B / ms_tick * 1e3:,.0f} scenario-ticks/s at B = {B}; the "
        f"host enqueues a tick in {host_ms_tick:.4f} ms")

    # The three launches on a mid-trot state.
    state_p, _ = ftick.pack_whole_body_state(res2.plant)
    carry_p = fcmd.pack_commander_carry(res2.carry)
    cmd_p = cmd.t().contiguous()
    warm_p = res2.warm
    out = {}

    k4 = tick.pre(state_p, carry_p, cmd_p)
    ms4 = graph_ms(lambda: tick.pre(state_p, carry_p, cmd_p), 50)
    ms4s = graph_ms(lambda: commander_serial(tick.consts, state_p, carry_p,
                                             cmd_p), 50)
    t0 = time.time()
    fcmd.commander_pre_plain(tick.consts, state_p, carry_p, cmd_p)
    torch.cuda.synchronize()
    plain4 = (time.time() - t0) * 1e3
    b4, by4 = bound_ms(4 * B * (42 + 95 + 6 + 144), B * ops_commander(0.0))
    out["k4"] = dict(ms=ms4, plain_ms=plain4, bound_ms=b4, bound_by=by4,
                     serial_ms=ms4s)

    qp_in = tuple(k4[:6])
    sched = dict(iterations=6, polish=True, polish_sweeps=8, polish_refine=4)
    fs_ = pf.FusedSchedule(**base, **sched)
    work = torch.zeros((2, B), dtype=torch.int32, device=DEV)
    k1 = kernels.fused_solve(*qp_in, warm_p, fs_, work=work)
    ms1 = event_ms(lambda: pf.solve_grf_qp_fused_packed(
        *qp_in, *warm_p, **base, **sched), 20)
    t0 = time.time()
    pf._fused_plain(*qp_in, warm_p, fs_)
    torch.cuda.synchronize()
    plain1 = (time.time() - t0) * 1e3
    full = dict(sched, prox_steps=0, prox_iterations=10, prox_sweeps=None,
                ff_refine=True)
    ops1 = ops_fused(full, int(work[0].sum().item()),
                     int(work[1].sum().item()), 0, B)
    b1, by1 = bound_ms(4 * B * (26 + 66 + 64), ops1)
    out["k1_tick"] = dict(
        mode="tick warm-6 + polish", batch=B, ms=ms1, plain_ms=plain1,
        bound_ms=b1, bound_by=by1, operations=ops1,
        mean_sweeps_run=work[1].float().mean().item(),
        max_sweeps_run=int(work[1].max().item()),
        geometry=fused_geometry(B, True))

    extras = (k1[0], k4[6], k4[2])
    ms5 = graph_ms(lambda: tick.stepper.packed(state_p, *extras, dt,
                                               N_SUBSTEPS), 20)
    ms5s = graph_ms(lambda: substep_serial(tick.stepper, state_p, extras, dt,
                                           N_SUBSTEPS), 20)
    t0 = time.time()
    tick.stepper.plain(state_p, *extras, dt, N_SUBSTEPS)
    torch.cuda.synchronize()
    plain5 = (time.time() - t0) * 1e3
    b5, by5 = bound_ms(4 * B * (58 + 28 + 58),
                       B * ops_substep(tick.stepper.consts, N_SUBSTEPS))
    out["k5"] = dict(ms=ms5, plain_ms=plain5, bound_ms=b5, bound_by=by5,
                     serial_ms=ms5s)

    in_kernels = ms4 + ms1 + ms5
    log(f"  K4: {ms4:.4f} ms (its serial body {ms4s:.4f} ms, plain "
        f"{plain4:.0f} ms, bound {b4:.5f} ms, {by4})")
    log(f"  K1 warm-6 + polish: {ms1:.4f} ms (plain {plain1:.0f} ms, bound "
        f"{b1:.5f} ms, {by1}; sweeps run mean "
        f"{out['k1_tick']['mean_sweeps_run']:.2f} max "
        f"{out['k1_tick']['max_sweeps_run']})")
    log(f"  K5: {ms5:.4f} ms (its serial body {ms5s:.4f} ms, plain "
        f"{plain5:.0f} ms, bound {b5:.5f} ms, {by5})")
    log(f"  the three launches sum to {in_kernels:.4f} ms on the mid-trot "
        f"state; share of the tick not inside a kernel: "
        f"{(ms_tick - in_kernels) / ms_tick:.3f}")
    out.update(ms_per_tick=ms_tick, ticks_per_s=B / ms_tick * 1e3,
               host_ms_per_tick=host_ms_tick, in_kernels_ms=in_kernels,
               share_outside_kernels=(ms_tick - in_kernels) / ms_tick)
    return out


# ---------------------------------------------------------------------------
# The MPC tick: K4 (+ MPC block) -> K6 -> K5
# ---------------------------------------------------------------------------

def ops_mpc(N, iterations, warm):
    """Float32 operations of one K6 instance, counted from the loops of
    csrc/qct_mpc.cuh (one per add, subtract, multiply, divide, compare /
    select; the update is counted on every iteration, so a frozen lane is
    overcounted by ~3 % of an iteration). Per IPM iteration and horizon
    step: residuals 620 (one H-vector product 320), right-hand side 200,
    the Riccati sweep 14,200 (P B 1,248, Luu 1,038, LDL^T 962, Lux 1,404,
    13 gain columns 3,744, the P update 4,342, the rest 1,460), the forward
    rollout 453, the step rule 396, the update 408."""
    per_step_iteration = 620 + 200 + 14200 + 453 + 396 + 408
    setup = 900 * N + (24 * 8 + 12 * 5) * N * int(warm)
    return iterations * N * per_step_iteration + setup


def mpc_bytes(N, warm):
    words_in = 25 + 17 * N + (64 * N if warm else 0)
    words_out = 12 * N + 6 + (60 * N if warm else 0)
    return 4 * (words_in + words_out)


def _mpc_settings(cfg, N, dt, iterations):
    bal = cfg.balance
    return fr.MpcSettings(n_steps=N, dt=dt, iterations=iterations,
                          mass=bal.mass, inertia_diag=bal.inertia_diag,
                          mu=bal.mu, fz_min=bal.fz_min, fz_max=bal.fz_max)


def _mpc_solve(block, warm, st):
    out = fr.solve_mpc_qp_riccati_packed(
        block, warm, settings=st, n_steps=st.n_steps, dt=st.dt,
        mass=st.mass, inertia_diag=st.inertia_diag, mu=st.mu,
        fz_min=st.fz_min, fz_max=st.fz_max, state_weights=st.state_weights,
        iterations=st.iterations)
    return out if warm is not None else out + (None,)


def mpc_objective(cfg, block, F, N, dt):
    """Float64 horizon objective 1/2 F^T H F + c^T F of each lane on its own
    problem (the MPC block's data), through the structured operators (no
    dense H)."""
    blk = block.double().t()
    Bn = blk.shape[0]
    xi0, r = blk[:, :13], blk[:, 13:25].reshape(Bn, 4, 3)
    sched = blk[:, 25:25 + 4 * N].reshape(Bn, N, 4) > 0.5
    ref = blk[:, 25 + 4 * N:].reshape(Bn, N, 13)
    data = mst.build_mpc_structured(xi0, ref, xi0[:, 2], r,
                                    torch.zeros_like(xi0[:, :3]), sched, N,
                                    dt, cfg)
    Fd = F.t().double().reshape(Bn, N, 12)
    return (0.5 * mst._hvp(data, Fd) * Fd
            + mst._linear_cost(data) * Fd).sum((-2, -1))


def hold_mpc_to_plain(name, cfg, block, kern, plain, N, dt):
    """K6 against its plain version on the same inputs: float64 objective
    gap over all lanes median < 1e-5 and p99 < 5e-4, converged flags
    agreeing on >= 0.99 of the lanes, swing forces exactly 0, the warm
    output's s and z finite and > 0. Both run the same algorithm in another
    operation order (cuBLAS products with FMA in the plain version, none in
    the kernel), which the iterations amplify, and a near-tie of the merit
    can flip the best-iterate pick. The gap on the lanes both certify is
    reported beside it. Returns (max |dF| over the certified lanes,
    stats)."""
    Fk, dk, wk = kern
    Fp, dp, _ = plain
    both = (dk[0] > 0.5) & (dp[0] > 0.5)
    ok_, op_ = mpc_objective(cfg, block, Fk, N, dt), mpc_objective(
        cfg, block, Fp, N, dt)
    rel_all = (ok_ - op_).abs() / (1.0 + op_.abs())
    rel = rel_all[both].cpu().numpy()
    agree = (dk[0] == dp[0]).float().mean().item()
    conv_k, conv_p = dk[0].mean().item(), dp[0].mean().item()
    swing = block[25:25 + 4 * N].repeat_interleave(3, 0) < 0.5
    swing_max = Fk[swing].abs().max().item() if bool(swing.any()) else 0.0
    max_abs = (Fk - Fp)[:, both].abs().max().item() if bool(both.any()) \
        else 0.0
    stats = dict(conv_kernel=conv_k, conv_plain=conv_p, agreement=agree,
                 both_certified=both.float().mean().item(),
                 gap_median=float(np.median(rel)) if rel.size else None,
                 gap_p99=float(np.percentile(rel, 99)) if rel.size else None,
                 gap_all_median=rel_all.median().item(),
                 gap_all_p99=torch.quantile(rel_all.float(), 0.99).item(),
                 max_abs_dF=max_abs, swing_max=swing_max,
                 bitwise=bool(torch.equal(Fk, Fp) and torch.equal(dk, dp)))
    cert = (f"median {stats['gap_median']:.2e} p99 {stats['gap_p99']:.2e}"
            if rel.size else "none")
    log(f"  K6 {name}: conv kernel {conv_k:.4f} plain {conv_p:.4f}, "
        f"agreement {agree:.4f}; objective gap over all lanes: median "
        f"{stats['gap_all_median']:.2e} p99 {stats['gap_all_p99']:.2e}; on "
        f"the {both.sum().item()} lanes both certify: {cert}; max|dF| "
        f"{max_abs:.3e} N; swing max {swing_max}; bitwise "
        f"{stats['bitwise']}")
    if not (stats["gap_all_median"] < 1e-5 and stats["gap_all_p99"] < 5e-4
            and agree >= 0.99 and swing_max == 0.0
            and bool(torch.isfinite(Fk).all())):
        fail(f"kernel K6 {name} disagrees with its plain version")
    if wk is not None:
        sz = wk[:48 * N]
        if not (bool(torch.isfinite(wk).all()) and bool((sz > 0).all())):
            fail(f"K6 {name}: warm output not finite and positive")
    return max_abs, stats


def mpc_serial(block, warm, st, yaw=None, phys=None):
    """K6's serial body (``qct_mpc_serial``: one robot per thread, the
    kernel's arithmetic before its lane split) on the packed entry's inputs
    (``yaw`` / ``phys`` as the unpacked entry passes them)."""
    out = kernels.mpc_serial(
        block.float().contiguous(), yaw, phys,
        None if warm is None else tuple(a.float().contiguous() for a in warm),
        st.params(), st.n_steps)
    return out


def hold_mpc_to_serial(name, kern, serial):
    """Fail unless every output of K6 (forces, diag and, warm, the [s | z |
    F] carry) is bitwise its serial body's, a NaN equal to any NaN; name
    the first output that differs and its first lanes."""
    for nm, a, b_ in zip(("F", "diag", "warm_out"), kern, serial):
        if a is None and b_ is None:
            continue
        if a is None or b_ is None or a.shape != b_.shape:
            fail(f"K6 {name}: {nm} missing or of another shape than its "
                 f"serial body's")
        same = ((a.view(torch.int32) == b_.view(torch.int32))
                | (a.isnan() & b_.isnan()))
        if not bool(same.all()):
            lanes = torch.nonzero(~same.all(0)).flatten().tolist()
            row = int(torch.nonzero(~same[:, lanes[0]]).flatten()[0])
            fail(f"K6 {name}: {nm} not bitwise its serial body on "
                 f"{len(lanes)} lanes (first {lanes[:8]}; lane {lanes[0]} "
                 f"first differs at row {row}: "
                 f"{a[row, lanes[0]].item()!r} vs "
                 f"{b_[row, lanes[0]].item()!r})")
    log(f"  K6 {name}: bitwise its serial body (qct_mpc_serial), every "
        f"output")


def phase_commander_mpc_vs_plain(cfg):
    log(f"== phase 9: K4 with the MPC block (N = {MPC_N}) vs its plain "
        f"version, B = {B_TICK}, 8 chained ticks")
    consts = fcmd.CommanderConsts(cfg, 1.0 / cfg.frequency)
    carry = carry_comps(commander_carry_walk(SEED + 60, B_TICK, cfg))
    worst = 0.0
    for t in range(8):
        d = whole_body_walk_states(SEED + 70 + t, B_TICK, cfg)
        state, cmd = state_comps(d), to_dev(d["cmd"].T)
        kw = dict(mpc_horizon=MPC_N, mpc_dt=MPC_DT)
        kern = fcmd.commander_pre_packed(state, carry, cmd, consts=consts,
                                         **kw)
        serial = commander_serial(consts, state, carry, cmd, **kw)
        plain = fcmd.commander_pre_plain(consts, state, carry, cmd, **kw)
        torch.cuda.synchronize()
        hold_commander_to_serial(f"MPC tick {t}", kern, serial)
        worst = max(worst, hold_commander_to_plain(f"MPC tick {t}", kern[:9],
                                                   plain[:9]))
        sched = slice(25, 25 + 4 * MPC_N)
        if not torch.equal(kern[9][sched], plain[9][sched]):
            fail(f"K4 MPC tick {t}: the stance schedule differs")
        err = (kern[9] - plain[9]).abs().max().item()
        if not torch.allclose(kern[9], plain[9], rtol=1e-5, atol=1e-5):
            fail(f"K4 MPC tick {t}: MPC block max abs err {err:.3e}")
        worst = max(worst, err)
        carry = kern[7]
    hold_commander_poisoned(f"MPC block N = {MPC_N}", consts, state, carry,
                            cmd, mpc_horizon=MPC_N, mpc_dt=MPC_DT)
    log(f"  K4 with the MPC block bitwise its serial body over 8 ticks and on "
        f"the ragged poisoned batch, within tolerance of the plain version "
        f"(block rtol 1e-5 atol 1e-5, schedule exact); worst abs err "
        f"{worst:.3e}")
    return worst


def _finite_plant(res, what):
    for nm, a in (("R", res.plant.R), ("x", res.plant.x), ("u", res.plant.u),
                  ("q", res.plant.q), ("anchor", res.plant.anchor)):
        if not bool(torch.isfinite(a).all()):
            fail(f"{what}: non-finite values in {nm}")


def mpc_tick_vs_plain(name, cfg, tick, state_p, carry_p, warm_p, cmd_p,
                      k6_iterations=None):
    """One MPC tick through the kernels and, on the same inputs, through the
    plain versions (K4 plain -> K6 plain -> K5 plain). ``k6_iterations``
    holds K6 to its plain version at that many iterations on the tick's MPC
    block and carry (for a tick where the tick's own iterations certify no
    lane: there the objective gap measures two unfinished iterates); K5 takes
    the tick's own forces either way."""
    dt = tick.consts.dt
    k4 = tick.pre(state_p, carry_p, cmd_p)
    s4 = commander_serial(tick.consts, state_p, carry_p, cmd_p,
                          mpc_horizon=tick.mpc_horizon, mpc_dt=tick.mpc_dt)
    p4 = fcmd.commander_pre_plain(
        tick.consts, state_p, carry_p, cmd_p, mpc_horizon=tick.mpc_horizon,
        mpc_dt=tick.mpc_dt)
    torch.cuda.synchronize()
    hold_commander_to_serial(name, k4, s4)
    e4 = hold_commander_to_plain(name, k4[:9], p4[:9])
    if not torch.equal(k4[9], p4[9]):
        fail(f"{name}: K4's MPC block differs from its plain version")
    k6 = _mpc_solve(k4[9], warm_p, tick.settings)
    hold_mpc_to_serial(name, k6, mpc_serial(k4[9], warm_p, tick.settings))
    st6, k6c, what = tick.settings, k6, name
    if k6_iterations is not None:
        st6 = _mpc_settings(cfg, tick.mpc_horizon, tick.mpc_dt, k6_iterations)
        k6c = _mpc_solve(k4[9], warm_p, st6)
        what = f"{name} at {k6_iterations} iterations"
        hold_mpc_to_serial(what, k6c, mpc_serial(k4[9], warm_p, st6))
    p6 = fr.packed_plain(k4[9], warm_p, st6)
    p6 = p6 if warm_p is not None else p6 + (None,)
    torch.cuda.synchronize()
    e6, _ = hold_mpc_to_plain(what, cfg, k4[9], k6c, p6, tick.mpc_horizon,
                              tick.mpc_dt)
    extras = (k6[0][0:12], k4[6], k4[2])
    k5 = tick.stepper.packed(state_p, *extras, dt, N_SUBSTEPS)
    p5 = tick.stepper.plain(state_p, *extras, dt, N_SUBSTEPS)
    s5 = substep_serial(tick.stepper, state_p, extras, dt, N_SUBSTEPS)
    torch.cuda.synchronize()
    hold_substep_to_serial(name, k5, s5)
    e5 = hold_substep_to_plain(name, k5, p5)
    log(f"  {name}: K4 + MPC block bitwise its serial body and equal to "
        f"plain, K6 bitwise its serial body and within tolerance of plain "
        f"(max|dF| {e6:.2e}), state after the tick bitwise K5's serial body "
        f"and within tolerance of the plain version (max {e5:.2e})")
    return max(e4, e5), e6


def phase_mpc_tick(cfg):
    """The MPC loop on B robots whose start poses differ by 1e-4 m (seeded),
    so that the fractions below are over distinct trajectories: the warm-8
    trot of this configuration is a marginal limit cycle (PARITY.md
    "stability anatomy"; the JAX package's own tick drops a share of such a
    population too, scripts/mpc_warm_trot_population.py), and one trajectory
    copied B times says survive or fall for all of them at once. Warm-8 (the
    measured configuration) is gated on the stand-up limits and reports its
    trot; the trot limits of scripts/verify_mpc_warm_tick.py:65-66 are gated
    on cold-15, the configuration that holds them on every robot."""
    log(f"== phase 10: the MPC tick, B = {B_TICK}, mit_cheetah_whole_body_"
        f"config: make_fused_tick(controller='mpc', mpc_horizon={MPC_N}, "
        f"mpc_dt={MPC_DT}, mpc_iterations={MPC_ITERS}, mpc_warm_start=True, "
        f"gravity_comp=True); start poses differ by 1e-4 m")
    B = B_TICK
    model = mit_cheetah_whole_body_model(cfg)
    kw = dict(controller="mpc", mpc_horizon=MPC_N, mpc_dt=MPC_DT,
              gravity_comp=True)
    tick = ftick.make_fused_tick(model, cfg, ContactConfig(),
                                 mpc_iterations=MPC_ITERS,
                                 mpc_warm_start=True, **kw)
    cold = ftick.make_fused_tick(model, cfg, ContactConfig(),
                                 mpc_iterations=15, **kw)
    plant0 = init_whole_body_state(cfg, (B,))
    shift = np.zeros((B, 3))
    shift[:, :2] = 1e-4 * np.random.default_rng(SEED + 80).standard_normal(
        (B, 2))
    plant = plant0._replace(x=plant0.x + to_dev(shift))
    carry = init_commander_carry((B,))
    cmd = torch.zeros((B, 6), device=DEV)
    cmd[:, 0] = 0.2   # the command of scripts/verify_mpc_warm_tick.py
    zero = torch.zeros(6, device=DEV)

    def drive(plant, carry, cmd, steps, tck, warm=None):
        kernels.reset_launch_counts()              # counts set to 0
        t0 = time.time()
        res = ftick.rollout_whole_body_fused_chunked(
            plant, carry, cmd, steps, tck, chunk=300, n_substeps=N_SUBSTEPS,
            record=True, warm=warm)
        torch.cuda.synchronize()
        counts = dict(kernels.launch_counts)       # counts read
        _finite_plant(res, "MPC tick")
        if not bool(torch.isfinite(res.trace.x).all()):
            fail("MPC tick: non-finite trace")
        return res, counts, time.time() - t0

    def three_launches(counts, steps, what):
        check(counts["qct_commander_pre"] == steps
              and counts["qct_mpc_riccati"] == steps
              and counts["qct_substep"] == steps
              and counts["qct_fused_solve"] == 0
              and counts["qct_assemble"] == 0
              and counts["qct_substep_serial"] == 0
              and counts["qct_commander_serial"] == 0
              and counts["qct_mpc_serial"] == 0,
              f"{what}: exactly 3 launches per tick (K4, K6, K5), no K1: "
              f"{counts}")

    def stand_stats(res, what, secs):
        z = res.plant.x[:, 2]
        st = dict(z_mean=z.mean().item(),
                  standing=res.carry.standing.float().mean().item(),
                  upright=(res.plant.R[:, 2, 2] > 0.9).float().mean().item(),
                  mpc_converged=res.trace.qp_converged.float().mean().item())
        log(f"  {what}: stand-up {MPC_STAND} ticks in {secs:.2f} s: z mean "
            f"{st['z_mean']:.4f}, standing {st['standing']:.3f}, upright "
            f"{st['upright']:.4f}, MPC converged {st['mpc_converged']:.4f}")
        return st

    def trot_stats(res, x0, steps, what, secs):
        st = dict(speed=(res.plant.x[:, 0] - x0).mean().item()
                  / (steps * tick.consts.dt),
                  z_mean=res.plant.x[:, 2].mean().item(),
                  upright=(res.plant.R[:, 2, 2] > 0.9).float().mean().item(),
                  mpc_converged=res.trace.qp_converged.float().mean().item(),
                  upright_by_100=[
                      (res.trace.x[k, :, 2] > 0.15).float().mean().item()
                      for k in range(99, steps, 100)])
        log(f"  {what}: trot {steps} ticks in {secs:.2f} s: mean x speed "
            f"{st['speed']:.4f} m/s, z mean {st['z_mean']:.4f}, upright "
            f"{st['upright']:.4f}, MPC converged {st['mpc_converged']:.4f}; "
            f"share with z > 0.15 m every 100 ticks "
            f"{[round(v, 3) for v in st['upright_by_100']]}")
        return st

    def hold_limits(st_s, st_t, what):
        check(abs(st_s["z_mean"] - cfg.stand.height) < 0.02,
              f"{what} stand-up: |mean z - stand height| < 0.02")
        check(st_s["standing"] > 0.9, f"{what} stand-up: standing > 0.9")
        check(st_s["upright"] > 0.95, f"{what} stand-up: upright fraction "
              f"(R22 > 0.9) > 0.95")
        if st_t is not None:
            check(st_t["upright"] > 0.95, f"{what} trot: upright fraction "
                  f"(R22 > 0.9) > 0.95")
            check(0.10 < st_t["speed"] < 0.25,
                  f"{what} trot: 0.10 < mean x speed < 0.25 m/s")

    # warm-8: the main configuration, whose launches are counted.
    res, counts, secs = drive(plant, carry, zero, MPC_STAND, tick)
    stand = stand_stats(res, "warm-8", secs)
    hold_limits(stand, None, "warm-8")
    three_launches(counts, MPC_STAND, "warm-8 stand-up")
    launches = dict(counts)
    x0 = res.plant.x[:, 0].clone()
    mid = MPC_TROT // 3
    res_mid, counts_a, secs_a = drive(res.plant, res.carry, cmd, mid, tick,
                                      warm=res.warm)
    res2, counts_b, secs_b = drive(res_mid.plant, res_mid.carry, cmd,
                                   MPC_TROT - mid, tick, warm=res_mid.warm)
    res2 = res2._replace(trace=ftick.FusedRolloutTrace(*(
        torch.cat(p) for p in zip(res_mid.trace, res2.trace))))
    counts2 = {k: counts_a[k] + counts_b[k] for k in counts_a}
    trot = trot_stats(res2, x0, MPC_TROT, "warm-8", secs_a + secs_b)
    three_launches(counts2, MPC_TROT, "warm-8 trot")
    for k_ in launches:
        launches[k_] += counts2[k_]
    log("  warm-8's trot is reported, not gated (see the docstring); the "
        "limits are held on cold-15 below")

    # cold-15: the trot limits.
    res_c, counts_c, secs_c = drive(plant, carry, zero, MPC_STAND, cold)
    stand_c = stand_stats(res_c, "cold-15", secs_c)
    three_launches(counts_c, MPC_STAND, "cold-15 stand-up")
    x0c = res_c.plant.x[:, 0].clone()
    res_c2, counts_c2, secs_c2 = drive(res_c.plant, res_c.carry, cmd,
                                       MPC_TROT, cold)
    trot_c = trot_stats(res_c2, x0c, MPC_TROT, "cold-15", secs_c2)
    three_launches(counts_c2, MPC_TROT, "cold-15 trot")
    hold_limits(stand_c, trot_c, "cold-15")

    # Whole ticks through the plain versions: the first stand-up tick and a
    # trot tick (a third into the warm-8 trot, every robot still upright).
    state_p, _ = ftick.pack_whole_body_state(plant)
    carry_p = fcmd.pack_commander_carry(carry)
    errs, errs6 = [], []
    # Tick 1 starts cold from the laying pose, where 8 iterations certify no
    # lane: K6 is held to its plain version at 25 on that tick's block.
    e, e6 = mpc_tick_vs_plain("MPC tick 1", cfg, tick, state_p, carry_p,
                              tick.init_warm(B), torch.zeros((6, B),
                                                             device=DEV),
                              k6_iterations=25)
    errs.append(e)
    errs6.append(e6)
    state_m, _ = ftick.pack_whole_body_state(res_mid.plant)
    carry_m = fcmd.pack_commander_carry(res_mid.carry)
    cmd_p = cmd.t().contiguous()
    e, e6 = mpc_tick_vs_plain("mid-trot MPC tick", cfg, tick, state_m,
                              carry_m, res_mid.warm, cmd_p)
    errs.append(e)
    errs6.append(e6)

    # The decimated rollout: K6 every 4 ticks.
    kernels.reset_launch_counts()
    t0 = time.time()
    dec = ftick.rollout_whole_body_fused_decimated(
        res.plant, res.carry, cmd, 200, tick, mpc_every=4,
        n_substeps=N_SUBSTEPS, record=True)
    torch.cuda.synchronize()
    cdec = dict(kernels.launch_counts)
    _finite_plant(dec, "decimated MPC rollout")
    log(f"  decimated, mpc_every=4, 200 ticks in {time.time() - t0:.2f} s: "
        f"launches {cdec}, MPC converged "
        f"{dec.trace.qp_converged.float().mean().item():.4f}")
    check(cdec["qct_mpc_riccati"] == 50 and cdec["qct_commander_pre"] == 200
          and cdec["qct_substep"] == 200 and cdec["qct_fused_solve"] == 0
          and cdec["qct_substep_serial"] == 0
          and cdec["qct_commander_serial"] == 0,
          "decimated: K6 launched steps / 4 times, K4 and K5 every tick")
    return dict(tick=tick, cold_tick=cold, model=model, res=res,
                res_mid=res_mid, cmd=cmd, launches=launches,
                k4_max=max(errs), k6_tick_max=max(errs6), stand=stand,
                trot=trot, cold=dict(stand=stand_c, trot=trot_c),
                decimated=dict(launches=cdec, mpc_converged=dec.trace
                               .qp_converged.float().mean().item()))


def phase_mpc_kernel_vs_plain(cfg, mpc):
    log(f"== phase 11: K6 vs its plain version on the card, B = {B_TICK}, "
        f"on MPC blocks K4 emits from trot states (a third into the warm-8 "
        f"trot)")
    B = B_TICK
    occ = kernels.mpc_occupancy(B)
    log(f"  K6 launch at B = {B}: {occ['blocks']} blocks of "
        f"{occ['threads']} threads ({occ['robots_per_block']} robots of "
        f"{occ['lanes']} lanes), {occ['shared_bytes']} bytes of dynamic "
        f"shared memory a block ({occ['shared_words']} words a robot); "
        f"{occ['blocks_per_sm']} blocks resident per SM, "
        f"{occ['registers']} registers and {occ['local_bytes']} bytes of "
        f"stack a thread")
    tick = mpc["tick"]
    res2 = mpc["res_mid"]
    state_m, _ = ftick.pack_whole_body_state(res2.plant)
    carry_m = fcmd.pack_commander_carry(res2.carry)
    cmd_p = mpc["cmd"].t().contiguous()
    consts = tick.consts
    modes = {}
    worst = mpc["k6_tick_max"]

    def run(name, block, warm, st):
        nonlocal worst
        kern = _mpc_solve(block, warm, st)
        hold_mpc_to_serial(name, kern, mpc_serial(block, warm, st))
        t0 = time.time()
        plain = fr.packed_plain(block, warm, st)
        torch.cuda.synchronize()
        plain_ms = (time.time() - t0) * 1e3
        plain = plain if warm is not None else plain + (None,)
        err, stats = hold_mpc_to_plain(name, cfg, block, kern, plain,
                                       st.n_steps, st.dt)
        worst = max(worst, err)
        modes[name] = dict(stats, plain_ms=plain_ms)
        return kern

    blk8 = fcmd.commander_pre_packed(state_m, carry_m, cmd_p, consts=consts,
                                     mpc_horizon=MPC_N, mpc_dt=MPC_DT)[9]
    # cold-15, N = 8.
    st15 = _mpc_settings(cfg, MPC_N, MPC_DT, 15)
    cold = run("cold-15 N=8", blk8, None, st15)
    # warm-8 from the run's carry, a third of the lanes' schedule bits
    # flipped (those rows restart cold).
    F_w, sz_w, sched_w = res2.warm
    sched_f = sched_w.clone()
    sched_f[:, ::3] = 1.0 - sched_f[:, ::3]
    run("warm-8 N=8", blk8, (F_w, sz_w, sched_f), tick.settings)
    zero = tick.init_warm(B)
    zw = _mpc_solve(blk8, zero, st15)
    check(torch.equal(zw[0], cold[0]) and torch.equal(zw[1], cold[1]),
          "K6: a zero warm carry with a -1 schedule is bitwise the cold "
          "start (kernel vs kernel)")
    # N = 24, 25 iterations: the branch without best-iterate tracking.
    blk24 = fcmd.commander_pre_packed(state_m, carry_m, cmd_p, consts=consts,
                                      mpc_horizon=24, mpc_dt=0.02)[9]
    st24 = _mpc_settings(cfg, 24, 0.02, 25)
    k24 = run("N=24 25 it (no best tracking)", blk24, None, st24)
    w24 = _mpc_solve(blk24, ftick.init_mpc_warm_packed(B, horizon=24), st24)
    check(torch.equal(w24[0], w24[2][48 * 24:]) and torch.equal(w24[0],
                                                                 k24[0]),
          "K6 N=24: the control output is the final iterate")

    # The unpacked entry (solve_mpc_fused) at a ragged batch, against the
    # same lanes in the full batch and against the plain version.
    blk = blk8.t()
    xi0, r = blk[:, :13], blk[:, 13:25].reshape(B, 4, 3)
    sched = blk[:, 25:25 + 4 * MPC_N].reshape(B, MPC_N, 4) > 0.5
    ref = blk[:, 25 + 4 * MPC_N:].reshape(B, MPC_N, 13)
    x_com = torch.zeros((B, 3), device=DEV)
    nb = (3, 37)
    n = nb[0] * nb[1]

    def cut(a):
        return a[:n].reshape(nb + a.shape[1:])

    Fr, sr = fr.solve_mpc_fused(cut(xi0), cut(ref), cut(xi0[:, 2]), cut(r),
                                cut(x_com), cut(sched), MPC_N, MPC_DT, cfg,
                                iterations=15)
    Ff, sf = fr.solve_mpc_fused(xi0, ref, xi0[:, 2], r, x_com, sched, MPC_N,
                                MPC_DT, cfg, iterations=15)
    torch.cuda.synchronize()
    check(torch.equal(Fr.reshape(n, MPC_N, 12), Ff[:n])
          and torch.equal(sr.converged.reshape(n), sf.converged[:n]),
          "K6 unpacked entry at a ragged (3, 37) batch: the same lanes as "
          "in the full batch, bitwise")
    check(torch.equal(Ff.reshape(B, -1).t(), cold[0]),
          "K6: the unpacked entry (per-lane constants) equals the packed one "
          "on the same lanes, bitwise")
    # The unpacked entry's own arguments (per-robot yaw and constants) through
    # both bodies, on the ragged batch.
    bal = cfg.balance
    phys = torch.tensor([bal.mass, *bal.inertia_diag, bal.mu, bal.fz_min,
                         bal.fz_max], device=DEV)[:, None].expand(7, n)
    phys = phys.contiguous()
    yaw_n = blk8[2, :n].contiguous()
    blk_n = blk8[:, :n].contiguous()
    hold_mpc_to_serial(
        f"unpacked entry's arguments (per-robot yaw, constants), B = {n}",
        kernels.mpc_riccati(blk_n, yaw_n, phys, None, st15.params(), MPC_N),
        mpc_serial(blk_n, None, st15, yaw_n, phys))
    kern_u = (Ff.reshape(B, -1).t().contiguous(),
              torch.stack([sf.converged.float(), sf.primal_residual,
                           sf.dual_residual, sf.gap]), None)
    plain_u = fr.packed_plain(blk8, None, st15) + (None,)
    torch.cuda.synchronize()
    hold_mpc_to_plain("unpacked entry", cfg, blk8, kern_u, plain_u, MPC_N,
                      MPC_DT)

    # Poisoned lanes: NaN and 1e6 in xi0 stay in their lanes.
    bad = blk8.clone()
    bad[0, 0] = float("nan")
    bad[9, 1] = 1.0e6
    kb = _mpc_solve(bad, None, st15)
    hold_mpc_to_serial("poisoned lanes", kb, mpc_serial(bad, None, st15))
    torch.cuda.synchronize()
    check(torch.equal(kb[0][:, 2:], cold[0][:, 2:])
          and torch.equal(kb[1][:, 2:], cold[1][:, 2:]),
          "K6: NaN and 1e6 lanes leave every other lane bitwise unchanged")
    check(kb[1][0, 0].item() == 0.0 and kb[1][0, 1].item() == 0.0
          and bool(torch.isfinite(kb[0][:, 1]).all()),
          "K6: the poisoned lanes are not certified; the 1e6 lane stays "
          "finite")
    log(f"  K6 worst max|dF| on certified lanes over all modes: {worst:.3e}")
    return dict(max_abs_err=worst, modes=modes, geometry=occ)


def phase_mpc_times(cfg, mpc):
    log("== phase 12: times of the MPC tick and of its three launches")
    B = B_TICK
    res, res2, cmd = mpc["res"], mpc["res_mid"], mpc["cmd"]
    out = {"summary": {}}
    for name, tck, warm in (("warm-8", mpc["tick"], res.warm),
                            ("cold-15", mpc["cold_tick"], None)):
        def run(steps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.time()
            t0.record()
            ftick.rollout_whole_body_fused(res.plant, res.carry, cmd, steps,
                                           tck, n_substeps=N_SUBSTEPS,
                                           warm=warm)
            h1 = time.time()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1), (h1 - h0) * 1e3

        run(20)
        best = {20: (1e30, 0.0), 120: (1e30, 0.0)}
        for _ in range(2):
            for steps in (20, 120):
                best[steps] = min(best[steps], run(steps))
        ms_tick = (best[120][0] - best[20][0]) / 100.0
        host = (best[120][1] - best[20][1]) / 100.0
        log(f"  MPC tick {name}: {ms_tick:.4f} ms/tick (CUDA events, "
            f"marginal 120 - 20 ticks), {B / ms_tick * 1e3:,.0f} "
            f"scenario-ticks/s at B = {B}; the host enqueues a tick in "
            f"{host:.4f} ms")
        out["summary"][name] = dict(ms_per_tick=ms_tick,
                                    ticks_per_s=B / ms_tick * 1e3,
                                    host_ms_per_tick=host)

    # The three launches on a mid-trot state, warm-8.
    tick = mpc["tick"]
    state_p, _ = ftick.pack_whole_body_state(res2.plant)
    carry_p = fcmd.pack_commander_carry(res2.carry)
    cmd_p = cmd.t().contiguous()
    k4 = tick.pre(state_p, carry_p, cmd_p)
    ms4 = graph_ms(lambda: tick.pre(state_p, carry_p, cmd_p), 50)
    ms4s = graph_ms(lambda: commander_serial(
        tick.consts, state_p, carry_p, cmd_p, mpc_horizon=MPC_N,
        mpc_dt=MPC_DT), 50)
    t0 = time.time()
    fcmd.commander_pre_plain(tick.consts, state_p, carry_p, cmd_p,
                             mpc_horizon=MPC_N, mpc_dt=MPC_DT)
    torch.cuda.synchronize()
    plain4 = (time.time() - t0) * 1e3
    kb = 4 * B * (42 + 95 + 6 + 144 + 25 + 17 * MPC_N)
    b4, by4 = bound_ms(kb, B * (ops_commander(0.0) + 20 + 60 + 26 * MPC_N))
    out["k4"] = dict(ms=ms4, plain_ms=plain4, bound_ms=b4, bound_by=by4,
                     serial_ms=ms4s)

    ms6 = event_ms(lambda: tick.solve(k4[9], res2.warm), 10)
    ms6s = event_ms(lambda: mpc_serial(k4[9], res2.warm, tick.settings), 3)
    t0 = time.time()
    fr.packed_plain(k4[9], res2.warm, tick.settings)
    torch.cuda.synchronize()
    plain6 = (time.time() - t0) * 1e3
    ops6 = ops_mpc(MPC_N, MPC_ITERS, True)
    b6, by6 = bound_ms(B * mpc_bytes(MPC_N, True), B * ops6)
    st15 = mpc["cold_tick"].settings
    ms6c = event_ms(lambda: mpc["cold_tick"].solve(k4[9]), 5)
    b6c, by6c = bound_ms(B * mpc_bytes(MPC_N, False),
                         B * ops_mpc(MPC_N, st15.iterations, False))
    blk24 = fcmd.commander_pre_packed(state_p, carry_p, cmd_p,
                                      consts=tick.consts, mpc_horizon=24,
                                      mpc_dt=0.02)[9]
    st24 = _mpc_settings(cfg, 24, 0.02, 25)
    ms6n = event_ms(lambda: _mpc_solve(blk24, None, st24), 5)
    b6n, by6n = bound_ms(B * mpc_bytes(24, False),
                         B * ops_mpc(24, st24.iterations, False))
    out["k6"] = dict(ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6,
                     serial_ms=ms6s, operations_per_lane=ops6,
                     cold15=dict(ms=ms6c, bound_ms=b6c, bound_by=by6c),
                     n24_cold25=dict(ms=ms6n, bound_ms=b6n, bound_by=by6n))
    F_p = tick.solve(k4[9], res2.warm)[0]
    extras = (F_p[0:12], k4[6], k4[2])
    ms5 = graph_ms(lambda: tick.stepper.packed(state_p, *extras,
                                               tick.consts.dt, N_SUBSTEPS), 20)
    in_k = ms4 + ms6 + ms5
    ms_tick = out["summary"]["warm-8"]["ms_per_tick"]
    log(f"  K4 + MPC block: {ms4:.4f} ms (its serial body {ms4s:.4f} ms, "
        f"plain {plain4:.0f} ms, bound {b4:.5f} ms, {by4})")
    log(f"  K6 warm-8: {ms6:.4f} ms (its serial body {ms6s:.4f} ms, plain "
        f"{plain6:.0f} ms, bound {b6:.5f} "
        f"ms, {by6}, {ops6} operations per lane); cold-15 {ms6c:.4f} ms "
        f"(bound {b6c:.5f} ms); N = 24 cold, 25 iterations {ms6n:.4f} ms "
        f"(bound {b6n:.5f} ms)")
    log(f"  K5: {ms5:.4f} ms; the three launches sum to {in_k:.4f} ms; share "
        f"of the warm-8 tick not inside a kernel: "
        f"{(ms_tick - in_k) / ms_tick:.3f}")
    out["summary"].update(in_kernels_ms=in_k, k4_ms=ms4, k6_ms=ms6,
                          k5_ms=ms5,
                          share_outside_kernels=(ms_tick - in_k) / ms_tick)
    return out


# ---------------------------------------------------------------------------
# The dense QP solve: K3a (barrier) -> K3b (polish)
# ---------------------------------------------------------------------------

def dense_problem(gen, B, cfg):
    """grf_scenarios -> assemble_qp_batch -> equilibrate -> the dense
    kernels' (k, B) inputs. Returns (qp, stance, (Q, c, G, h) equilibrated
    (k, B), Dv)."""
    s = grf_scenarios(gen, B, cfg, device=DEV)
    qp = assemble_qp_batch(s, cfg)
    Qs, cs, Gs, hs, Dv, _, _ = equilibrate(qp.Q, qp.c, qp.G, qp.h)
    prob = (pf._soa(Qs, 144, B), pf._soa(cs, 12, B), pf._soa(Gs, 288, B),
            pf._soa(hs, 24, B))
    return qp, s.stance, prob, Dv


def dense_objective64(Q, c, Dv, x_eq):
    """Objective of the ORIGINAL problem (Q, c) at the mapped-back
    equilibrated (12, B) iterate, float64."""
    x = x_eq.t().double() * Dv.double()
    return (0.5 * torch.einsum("bi,bij,bj->b", x, Q.double(), x)
            + (c.double() * x).sum(-1))


# Operation counts of K3a and K3b (one per add, subtract, multiply, divide,
# square root, compare/select), counted from the loops of
# csrc/qct_dense_ipm.cuh and the helpers of qct_common.cuh it calls.
def ops_dense_barrier_iteration():
    chol = sum(2 * j + 3 + (11 - j) * (2 * j + 1) for j in range(12))
    kkt = 2 * _CHOL_SOLVE + 12 * 24 + 12 + 12
    newton = 24 * 3 + 12 * 49 + kkt + 24 * 23 + 24 * 2 + 24 * 4
    return (24 * 25 + 12 * 72 + 24 * 2        # residuals, d
            + 78 * 24 * 3 + 24                # M = Q + G^T D G, shift
            + chol + 48                       # Cholesky, mu
            + 24 + 2 * newton + 4 * (24 * 4 + 2)  # rc, directions, steps
            + 24 * 5 + 6 + 24 * 4             # mu_aff, sigma, corrector rc
            + 72 + 5 + 72 + 60 * 3)           # merit, guards, update


def ops_dense_polish_sweep():
    ldl = sum(3 * j + 2 + (35 - j) * (3 * j + 1) for j in range(36))
    solve = 4 * 630 + 36
    refine = 12 * 96 + 24 * 39 + 36
    ff = 12 * (37 * 25 + 2) + 12 * 2          # 37 compensated terms a row
    return (24 * 12 + 24 * 4 + ldl + 5 * solve + 4 * refine + ff
            + 24 * 24 + 24 * 3 + 36 + 24 * 6 + 24 * 6)


def dense_polish_sweeps_run(prob, bar):
    """Sweeps K3b runs over the batch on these inputs: a lane leaves the
    loop after its first certified sweep. Counted with the plain version,
    whose certificate after k sweeps is the kernel's (bitwise equal)."""
    B = bar[0].shape[1]
    total = B
    for k in range(1, 8):
        cert = fi._dense_polish_plain(*prob, *bar, sweeps=k)[3]
        total += int((cert < 0.5).sum().item())
    return total


def hold_dense_to_plain(name, kern, plain, Q, c, Dv, cert=False):
    """Fail unless a dense kernel's (x, s, z[, cert]) agree with its plain
    version's on the same inputs: objective gap (float64, original units)
    median < 1e-6, p95 < 1e-4 over the finite lanes, certificate agreement
    >= 0.99. Returns (max |dx|, bitwise)."""
    ok_ = dense_objective64(Q, c, Dv, kern[0])
    op_ = dense_objective64(Q, c, Dv, plain[0])
    both = torch.isfinite(ok_) & torch.isfinite(op_)
    rel = (torch.abs(ok_ - op_) / (1.0 + torch.abs(op_)))[both].cpu().numpy()
    bitwise = all(torch.equal(a, b) for a, b in zip(kern, plain))
    max_abs = (kern[0] - plain[0])[:, both].abs().max().item()
    agree = 1.0
    if cert:
        agree = (kern[3] == plain[3]).float().mean().item()
    log(f"  {name}: objective gap median {np.median(rel):.2e} p95 "
        f"{np.percentile(rel, 95):.2e}; max|dx| {max_abs:.2e}; cert "
        f"agreement {agree:.4f}; bitwise {bitwise}")
    if not (both.float().mean().item() > 0.99 and np.median(rel) < 1e-6
            and np.percentile(rel, 95) < 1e-4 and agree >= 0.99):
        fail(f"{name} disagrees with its plain version")
    return max_abs, bitwise


def hold_dense_polish_bitwise(name, kern, plain):
    """Fail unless K3b's outputs ``kern`` = (x, s, z, cert) equal its plain
    version's on the same inputs, bit for bit in every value (a NaN equal
    to any NaN): the same statements in the same order (``-fmad=false``,
    ``__fmul_rn`` / ``__fadd_rn`` in the Dekker helpers; no square root)."""
    if not all(same_values(a, b) for a, b in zip(kern, plain)):
        fail(f"kernel K3b {name} is not bitwise equal to its plain version")
    log(f"  ok: K3b {name}: bitwise its plain version in every value "
        f"({kern[3].numel()} QPs)")


def hold_dense_barrier_bitwise(name, kern, plain):
    """Fail unless K3a's outputs ``kern`` = (x, s, z) equal its plain
    version's on the same inputs, bit for bit in every value (a NaN equal
    to any NaN): the same statements in the same order (``-fmad=false``;
    the card's ``1.0f / sqrtf`` and ``torch.sqrt`` on the card are both
    correctly rounded)."""
    if not all(same_values(a, b) for a, b in zip(kern, plain)):
        fail(f"kernel K3a {name} is not bitwise equal to its plain version")
    log(f"  ok: K3a {name}: bitwise its plain version in every value "
        f"({kern[0].shape[1]} QPs)")


def dense_geometry(B, barrier=False):
    """K3b's (or K3a's) launch for B QPs as the card makes it
    (kernels.dense_occupancy, kernels.dense_barrier_occupancy), logged:
    blocks, threads, shared bytes a block, resident blocks per SM,
    registers and local (stack) bytes per thread."""
    occ = (kernels.dense_barrier_occupancy(B) if barrier
           else kernels.dense_occupancy(B))
    log(f"    {'K3a' if barrier else 'K3b'} launch, B = {B}: "
        f"{occ['blocks']} blocks of "
        f"{occ['threads']} threads ({occ['qps_per_block']} QPs x "
        f"{occ['lanes']} lanes), {occ['shared_bytes']} B of shared memory a "
        f"block, {occ['blocks_per_sm']} blocks per SM, {occ['registers']} "
        f"registers and {occ['local_bytes']} B of stack a thread")
    return occ


def phase_dense_vs_plain(cfg, gen):
    log(f"== phase 13: K3a (dense barrier) and K3b (dense polish) vs their "
        f"plain versions on the card, B = {B_MAIN}")
    qp, _, prob, Dv = dense_problem(gen, B_MAIN, cfg)
    worst = {"qct_dense_barrier": 0.0, "qct_dense_polish": 0.0}
    bitwise = {}
    for it in (DENSE_ITERS, 3):
        k = kernels.dense_barrier(*prob, iterations=it, tau=0.995)
        p = fi._dense_barrier_plain(*prob, iterations=it, tau=0.995)
        torch.cuda.synchronize()
        err, bw = hold_dense_to_plain(f"K3a {it} iterations", k, p, qp.Q,
                                      qp.c, Dv)
        hold_dense_barrier_bitwise(f"{it} iterations, B = {B_MAIN}", k, p)
        worst["qct_dense_barrier"] = max(worst["qct_dense_barrier"], err)
        bitwise[f"K3a_{it}"] = bw
        if it == DENSE_ITERS:
            bar = k
    kp = kernels.dense_polish(*prob, *bar)
    pp = fi._dense_polish_plain(*prob, *bar)
    torch.cuda.synchronize()
    err, bitwise["K3b"] = hold_dense_to_plain("K3b on K3a's point", kp, pp,
                                              qp.Q, qp.c, Dv, cert=True)
    hold_dense_polish_bitwise(f"on K3a's point, B = {B_MAIN}", kp, pp)
    worst["qct_dense_polish"] = err
    log(f"  K3b certified {kp[3].mean().item():.5f} of the lanes")

    # A ragged batch and two poisoned lanes (NaN in Q, inf in h).
    Br = 1024 + 37
    sub = [a[:, :Br].clone() for a in prob]
    sub[0][7, 5] = float("nan")
    sub[3][3, 1000] = float("inf")
    kb = kernels.dense_barrier(*sub, iterations=DENSE_ITERS, tau=0.995)
    pb = fi._dense_barrier_plain(*sub, iterations=DENSE_ITERS, tau=0.995)
    kq = kernels.dense_polish(*sub, *kb)
    pq = fi._dense_polish_plain(*sub, *kb)   # K3b's inputs: K3a's point
    torch.cuda.synchronize()
    keep = torch.ones(Br, dtype=torch.bool, device=DEV)
    keep[[5, 1000]] = False
    Qk, ck, Dk = qp.Q[:Br][keep], qp.c[:Br][keep], Dv[:Br][keep]
    hold_dense_to_plain("K3a ragged B = 1061, two poisoned lanes",
                        [a[..., keep] for a in kb], [a[..., keep] for a in pb],
                        Qk, ck, Dk)
    hold_dense_to_plain("K3b ragged B = 1061, two poisoned lanes",
                        [a[..., keep] for a in kq], [a[..., keep] for a in pq],
                        Qk, ck, Dk, cert=True)
    check(all(torch.equal(a[..., keep], b[..., :Br][..., keep])
              for a, b in zip(kb + kq, bar + kp)),
          "ragged launch: every unpoisoned lane is bitwise its lane of the "
          "full batch's launches")
    hold_dense_barrier_bitwise(f"ragged B = {Br}, two poisoned lanes, every "
                               f"lane", kb, pb)
    hold_dense_polish_bitwise(f"ragged B = {Br}, two poisoned lanes, every "
                              f"lane", kq, pq)
    check(float(kq[3][5]) == 0.0 and float(kq[3][1000]) == 0.0,
          "the poisoned lanes are not certified")
    geometry = {str(b): dense_geometry(b) for b in (B_MAIN, 1024, Br)}
    geometry_k3a = {str(b): dense_geometry(b, barrier=True)
                    for b in (B_MAIN, 1024, Br)}
    return dict(worst=worst, bitwise=bitwise, geometry=geometry,
                geometry_k3a=geometry_k3a)


def phase_split_pipeline(cfg, gen):
    log(f"== phase 14: the split pipeline, solve_qp_ipm_fused(iterations="
        f"{DENSE_ITERS}, polish=True), B = {B_MAIN}, {REPS} solves on fresh "
        f"inputs")
    probs = [dense_problem(gen, B_MAIN, cfg) for _ in range(REPS + 1)]

    def solve(qp):
        return fi.solve_qp_ipm_fused(qp.Q, qp.c, qp.G, qp.h,
                                     iterations=DENSE_ITERS, polish=True)

    solve(probs[-1][0])                                   # warm-up
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                         # counts set to 0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.time()
    sols = [solve(p[0]) for p in probs[:REPS]]
    host_ms = (time.time() - h0) * 1e3 / REPS   # the host's enqueue
    t1.record()
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)                  # counts read
    ms = t0.elapsed_time(t1) / REPS
    conv = float(np.mean([s_.converged.float().mean().item() for s_ in sols]))
    log(f"  {ms:.3f} ms/solve, {B_MAIN / ms * 1e3:,.0f} QPs/s, converged "
        f"fraction {conv:.5f}; the host enqueues a solve in {host_ms:.3f} "
        f"ms")
    log(f"  launch counts in the run: {counts}")
    for s_ in sols:
        for nm in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
            if not bool(torch.isfinite(getattr(s_, nm)).all()):
                fail(f"split pipeline: non-finite values in {nm}")
    check(conv >= 0.98, f"converged fraction {conv:.5f} >= 0.98")
    check(counts["qct_dense_barrier"] == REPS
          and counts["qct_dense_polish"] == REPS
          and counts["qct_fused_solve"] == 0,
          f"exactly one K3a and one K3b launch per solve ({REPS} solves)")

    qp0, stance0 = probs[0][0], probs[0][1]
    n = 64
    _, obj_star, _ = solve_qp_batch_oracle(
        *(a[:n].double().cpu().numpy() for a in (qp0.Q, qp0.c, qp0.G,
                                                 qp0.h)),
        stance0[:n].cpu().numpy(), cfg.balance.fz_min, cfg.balance.fz_max)
    xd = sols[0].x[:n].double()
    obj = (0.5 * torch.einsum("bi,bij,bj->b", xd, qp0.Q[:n].double(), xd)
           + (qp0.c[:n].double() * xd).sum(-1)).cpu().numpy()
    rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
    log(f"  oracle parity (n={n}): objective rel gap median "
        f"{np.median(rel):.2e} p95 {np.percentile(rel, 95):.2e} max "
        f"{rel.max():.2e}")
    check(np.median(rel) < 1e-7 and np.percentile(rel, 95) < 1e-6,
          "split pipeline meets the float64 oracle (median < 1e-7, p95 < "
          "1e-6: tests/test_pallas.py's bars)")

    # Per launch, fresh inputs each repetition.
    probs_k = [p[2] for p in probs]
    bars = [kernels.dense_barrier(*pr, iterations=DENSE_ITERS, tau=0.995)
            for pr in probs_k]

    def per_launch(fn):
        fn(0)
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for r in range(REPS):
            fn(r)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / REPS

    ms_a = per_launch(lambda r: kernels.dense_barrier(
        *probs_k[r], iterations=DENSE_ITERS, tau=0.995))
    ms_b = per_launch(lambda r: kernels.dense_polish(*probs_k[r], *bars[r]))
    # K3a and K3b on the xla prox stage's slice size (1024 QPs).
    n_s = 1024
    probs_s = [[a[:, :n_s].contiguous() for a in pr] for pr in probs_k]
    bars_s = [[a[:, :n_s].contiguous() for a in b_] for b_ in bars]
    ms_a_s = per_launch(lambda r: kernels.dense_barrier(
        *probs_s[r], iterations=DENSE_ITERS, tau=0.995))
    ms_b_s = per_launch(lambda r: kernels.dense_polish(*probs_s[r],
                                                       *bars_s[r]))
    t0h = time.time()
    fi._dense_barrier_plain(*probs_k[0], iterations=DENSE_ITERS, tau=0.995)
    torch.cuda.synchronize()
    plain_a = (time.time() - t0h) * 1e3
    t0h = time.time()
    fi._dense_polish_plain(*probs_k[0], *bars[0])
    torch.cuda.synchronize()
    plain_b = (time.time() - t0h) * 1e3
    sweeps = dense_polish_sweeps_run(probs_k[0], bars[0])
    ops_a = B_MAIN * DENSE_ITERS * ops_dense_barrier_iteration()
    ops_b = sweeps * ops_dense_polish_sweep()
    b_a, by_a = bound_ms(4 * B_MAIN * (468 + 60), ops_a)
    b_a_s, _ = bound_ms(4 * n_s * (468 + 60), ops_a // B_MAIN * n_s)
    b_b, by_b = bound_ms(4 * B_MAIN * (468 + 60 + 61), ops_b)
    log(f"  K3a: {ms_a:.4f} ms per launch (plain {plain_a:.0f} ms, bound "
        f"{b_a:.5f} ms, {by_a}, {ops_a // B_MAIN} operations per instance)")
    log(f"  K3b: {ms_b:.4f} ms per launch (plain {plain_b:.0f} ms, bound "
        f"{b_b:.5f} ms, {by_b}; {sweeps / B_MAIN:.3f} sweeps per instance "
        f"run); the two launches sum to {ms_a + ms_b:.4f} of the "
        f"{ms:.4f} ms solve")
    log(f"  at B = {n_s} (the xla prox slice): K3a {ms_a_s:.4f} ms per "
        f"launch (bound {b_a_s:.5f} ms), K3b {ms_b_s:.4f} ms per launch")
    return dict(
        ms_per_solve=ms, host_ms_per_solve=host_ms, qps=B_MAIN / ms * 1e3,
        converged=conv, launches=counts, oracle_median=float(np.median(rel)),
        k3a=dict(ms=ms_a, plain_ms=plain_a, bound_ms=b_a, bound_by=by_a,
                 operations=ops_a, ms_b1024=ms_a_s, bound_ms_b1024=b_a_s),
        k3b=dict(ms=ms_b, plain_ms=plain_b, bound_ms=b_b, bound_by=by_b,
                 operations=ops_b, mean_sweeps_run=sweeps / B_MAIN,
                 ms_b1024=ms_b_s))


def phase_prox_xla(cfg, gen, main_res):
    log(f"== phase 15: solve_balance_qp_fused with the bench schedule and "
        f"prox_backend=\"xla\", B = {B_MAIN}, {REPS} solves on fresh inputs")
    bal = cfg.balance
    sched = dict(MAIN_SCHEDULE, prox_backend="xla")
    Bt = pf.prox_slice_size(B_MAIN, sched["rows"], True, 8, 64, "xla")
    check(Bt == 1024, f"the JAX package's xla prox slice at this B is {Bt} "
          f"instances (a multiple of 1024: the dense kernels' branch)")

    def solve(s):
        return pf.solve_balance_qp_fused(
            s.R, s.R_d, s.x, s.xdot, s.w, s.x_d, s.xdot_d, s.w_d, s.feet,
            s.stance, bal, **sched)

    solve(grf_scenarios(gen, B_MAIN, cfg, device=DEV))   # warm-up
    scen = [grf_scenarios(gen, B_MAIN, cfg, device=DEV) for _ in range(REPS)]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()                          # counts set to 0
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    h0 = time.time()
    sols = [solve(s) for s in scen]
    host_ms = (time.time() - h0) * 1e3 / REPS   # waits on the compactions too
    t1.record()
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)                   # counts read
    ms = t0.elapsed_time(t1) / REPS
    conv = float(np.mean([s_.converged.float().mean().item() for s_ in sols]))
    log(f"  {ms:.3f} ms/solve-batch, {B_MAIN / ms * 1e3:,.0f} QPs/s, "
        f"converged fraction {conv:.5f} (the kernel backend, phase 4b: "
        f"{main_res['ms_per_solve']:.3f} ms, {main_res['converged']:.5f}); "
        f"the host returns from a solve in {host_ms:.3f} ms")
    log(f"  launch counts in the run: {counts}")
    for s_ in sols:
        for nm in ("x", "z", "s", "gap", "primal_residual", "dual_residual"):
            if not bool(torch.isfinite(getattr(s_, nm)).all()):
                fail(f"xla prox path: non-finite values in {nm}")
    check(conv >= 0.99, f"converged fraction {conv:.5f} >= 0.99")
    steps = sched["prox_steps"]
    check(counts["qct_fused_solve"] == 3 * REPS
          and counts["qct_dense_barrier"] == steps * REPS
          and counts["qct_dense_polish"] == steps * REPS,
          f"per solve: phase 4b's 4 K1 launches minus the prox launch, plus "
          f"{steps} x (K3a + K3b) on the {Bt}-instance slice")

    # K3a and K3b on the prox slices of one more solve (after the counts
    # were read; these launches are not the run's): each launch's inputs and
    # outputs recorded, each held bitwise to the plain version on those
    # inputs.
    launches = {"K3a": [], "K3b": []}
    launch = {"K3a": kernels.dense_barrier, "K3b": kernels.dense_polish}

    def recorder(nm):
        def run(*args, **kw):
            out = launch[nm](*args, **kw)
            launches[nm].append((args, kw, out))
            return out
        return run

    kernels.dense_barrier, kernels.dense_polish = (recorder("K3a"),
                                                   recorder("K3b"))
    try:
        solve(scen[0])
    finally:
        kernels.dense_barrier, kernels.dense_polish = (launch["K3a"],
                                                       launch["K3b"])
    for nm, plain, hold in (
            ("K3a", fi._dense_barrier_plain, hold_dense_barrier_bitwise),
            ("K3b", fi._dense_polish_plain, hold_dense_polish_bitwise)):
        check(len(launches[nm]) == steps, f"{steps} {nm} launches in a solve")
        for k, (args, kw, out) in enumerate(launches[nm]):
            hold(f"prox restart {k + 1} of {steps}, slice of {Bt}", out,
                 plain(*args, **kw))

    s0, sol0 = scen[0], sols[0]
    Q, c, G, h = pf.assemble_qp_fused_debug(
        *raw_inputs(s0, bal), s_diag=tuple(bal.s_diag),
        w_diag=float(bal.w_diag))
    n = 64
    _, obj_star, _ = solve_qp_batch_oracle(
        Q[:n].double().cpu().numpy(), c[:n].double().cpu().numpy(),
        G[:n].double().cpu().numpy(), h[:n].double().cpu().numpy(),
        s0.stance[:n].cpu().numpy(), bal.fz_min, bal.fz_max)
    xd = sol0.x[:n].double()
    obj = (0.5 * torch.einsum("bi,bij,bj->b", xd, Q[:n].double(), xd)
           + (c[:n].double() * xd).sum(-1)).cpu().numpy()
    rel = np.abs(obj - obj_star) / (1.0 + np.abs(obj_star))
    log(f"  oracle parity (n={n}): objective rel gap median "
        f"{np.median(rel):.2e} max {rel.max():.2e}")
    check(np.median(rel) < 1e-6 and rel.max() < 1e-4,
          "xla prox path meets the float64 oracle's objective (median < "
          "1e-6)")
    return dict(ms_per_solve=ms, host_ms_per_solve=host_ms,
                qps=B_MAIN / ms * 1e3, converged=conv, launches=counts,
                slice=Bt)


# ---------------------------------------------------------------------------
# The SRB closed loop: commander x SRB plant (control/rollout.py), the
# balance QP in K1 or the MPC in K6
# ---------------------------------------------------------------------------

def to_device(obj, device):
    """A NamedTuple of tensors (nested), a tensor or None, on ``device``."""
    if obj is None:
        return None
    if torch.is_tensor(obj):
        return obj.to(device)
    return type(obj)(*(to_device(v, device) for v in obj))


def srb_cmd(B, vx=0.2):
    cmd = torch.zeros(B, 6, device=DEV)
    cmd[:, 0] = vx
    return cmd


def srb_stand_checks(name, trace, z_tol, conv_min):
    """The stand-up limits of tests/test_rollout.py:30-45 (z_tol 0.01,
    converged > 0.99) and tests/test_mpc_commander.py:31-44 (0.01, 0.95;
    0.012 for the decimated stand-up, :72)."""
    z_err = (trace.x[-1, :, 2] - 0.26).abs().max().item()
    tmax = trace.torque_max.max().item()
    conv = trace.qp_converged.float().mean().item()
    check(bool(torch.isfinite(trace.x).all()), f"{name}: finite")
    check(z_err < z_tol, f"{name}: every robot at 0.26 m within {z_tol} "
          f"(worst {z_err:.5f})")
    check(bool(trace.standing[-1].all()), f"{name}: every robot standing")
    check(tmax <= 20.0 + 1e-9, f"{name}: torques within the 20 N m clamp "
          f"(max {tmax:.4f})")
    check(conv > conv_min, f"{name}: converged fraction {conv:.4f} > "
          f"{conv_min}")
    return dict(z_err=z_err, torque_max=tmax, converged=conv)


def srb_walk_checks(name, trace, seconds, stance_check=True):
    """The trot limits of tests/test_rollout.py:58-70 and
    tests/test_mpc_commander.py:47-58: mean forward speed > 0.1 m/s for
    every robot, height within 0.04 m of 0.26 at every recorded tick,
    finite, a trot's stance fraction."""
    x = trace.x
    v = (x[-1, :, 0] - x[0, :, 0]) / seconds
    hdev = (x[..., 2] - 0.26).abs().max().item()
    stance = trace.in_stance.float().mean().item()
    check(bool(torch.isfinite(x).all()), f"{name}: finite")
    check(v.min().item() > 0.1, f"{name}: every robot trots forward, mean "
          f"speed {v.min().item():.4f} .. {v.max().item():.4f} m/s > 0.1")
    check(hdev < 0.04, f"{name}: height within 0.04 m (worst {hdev:.5f})")
    if stance_check:
        check(0.7 < stance < 0.95, f"{name}: stance fraction {stance:.4f} "
              f"in (0.7, 0.95)")
    return dict(v_min=v.min().item(), v_max=v.max().item(),
                height_dev=hdev, stance=stance)


# Teacher-forced ticks, the card against the plain path on the CPU (the
# same tick from the same recorded state): absolute tolerance per output,
# masks exactly. The float32 arithmetic of the commander and the plant
# differs between the two devices in the last bits (sin / cos / atan2,
# reductions), and K6's plain version orders its products otherwise. The
# floor is scripts/torch_srb_tick_sensitivity.py (CPU, plain versions): 1-ulp
# noise on the state moves the forces by up to 0.58 N (balance) and 1.19 N
# (MPC) along the QPs' flat internal-force directions (1e-5 curvature:
# squeezing between stance feet, which cancels in the net wrench), the
# torques by 0.10 / 0.31 N m, but the next state, which integrates only the
# net wrench, by x 6e-8 / 6e-7 m, xdot 4.5e-8 / 1.8e-4 m/s, w 4.7e-6 /
# 4.0e-6 rad/s, R 3.6e-7 / 3.6e-7, q 8.3e-7 / 3.8e-6 rad, qdot 3.9e-4 /
# 1.1e-3 rad/s (= dq / dt), the feet not at all. The tolerances are 4-15x
# the forces' and torques' floor and 25-130x the state's: the forces are
# held loosely, their wrench tightly through the state.
SRB_TF_TOLS = {
    "balance": dict(forces=5.0, torques=1.5, x=5e-6, xdot=5e-6, w=5e-4,
                    R=2e-5, feet=1e-5, q=5e-5, qdot=2e-2),
    "mpc": dict(forces=5.0, torques=1.5, x=2e-5, xdot=5e-3, w=5e-4,
                R=2e-5, feet=1e-5, q=1e-4, qdot=5e-2),
}


def srb_teacher_forced(name, cfg, plant, carry, cmd, tols, **kw):
    """One tick (commander_step + plant_step) from a recorded state on the
    card (through the kernel) and on the CPU (its plain version)."""
    dt = 1.0 / cfg.frequency

    def tick(p, c, u):
        out, _ = commander_step(p.com, p.joints, c, u, dt, cfg, **kw)
        return out, plant_step(p, out.forces_world, out.gait.in_stance,
                               out.foot_refs_world, dt, cfg)

    ok_, pk = tick(plant, carry, cmd)
    op_, pp = tick(to_device(plant, "cpu"), to_device(carry, "cpu"),
                   cmd.cpu())
    for what, a, b in (("in_stance", ok_.gait.in_stance, op_.gait.in_stance),
                       ("converged", ok_.qp_converged, op_.qp_converged)):
        check(torch.equal(a.cpu(), b), f"{name}: {what} exactly the plain "
              f"path's ({a.float().mean().item():.4f} set)")
    pairs = {"forces": (ok_.forces_world, op_.forces_world),
             "torques": (ok_.torques, op_.torques),
             "x": (pk.com.x, pp.com.x), "xdot": (pk.com.xdot, pp.com.xdot),
             "w": (pk.com.w, pp.com.w), "R": (pk.com.R, pp.com.R),
             "feet": (pk.feet_world, pp.feet_world),
             "q": (pk.joints.q, pp.joints.q),
             "qdot": (pk.joints.qdot, pp.joints.qdot)}
    errs = {k: (a.cpu() - b).abs().max().item() for k, (a, b) in
            pairs.items()}
    log(f"  {name}: max |card - plain| " + ", ".join(
        f"{k} {v:.2e}" for k, v in errs.items()))
    bad = [k for k, v in errs.items() if not v <= tols[k]]
    if bad:
        fail(f"{name}: {bad} beyond {[tols[k] for k in bad]}")
    return errs


def srb_k1_inputs(cfg, plant, carry, cmd):
    """K1's packed inputs for one SRB tick from a recorded state: what
    solve_balance_qp_fused hands the kernel."""
    dt = 1.0 / cfg.frequency
    com, bal = plant.com, cfg.balance
    pre = commander_precursors(com, plant.joints, carry, cmd, dt, cfg)
    r_masked, b = pf.balance_precursors(
        com.R, pre.R_d, com.x, com.xdot, com.w, pre.x_d, pre.xdot_d,
        pre.w_d, pre.feet_body, pre.eff_stance, bal)
    return pf._prep_inputs(r_masked, b, pre.eff_stance, bal.mu, bal.fz_min,
                           bal.fz_max)


def srb_k6_block(cfg, plant, carry, cmd):
    """K6's packed (25 + 17N, B) block for one SRB MPC tick from a recorded
    state: what solve_mpc_fused hands the kernel."""
    dt = 1.0 / cfg.frequency
    com = plant.com
    N, mdt = SRB_MPC["mpc_horizon"], SRB_MPC["mpc_dt"]
    pre = commander_precursors(com, plant.joints, carry, cmd, dt, cfg)
    xi0, xi_ref, _, sched = mpc_precursors(
        com, pre.gait_time, pre.walking, pre.eff_stance, cmd, cfg, N, mdt)
    B = xi0.shape[0]
    r = pre.p_start - com.x[:, None, :]
    return torch.cat([xi0, r.reshape(B, 12), sched.float().reshape(B, -1),
                      xi_ref.reshape(B, -1)], -1).t().contiguous()


def phase_srb_balance(cfg):
    log(f"== phase 16 (f): the SRB balance rollout, B = {B_SRB}, K1 barrier "
        f"only ({SRB_QP['qp_iterations']} iterations): stand_up_rollout "
        f"600 ticks, then a 0.2 m/s trot through rollout, 2 x 300 ticks")
    cmd = srb_cmd(B_SRB)
    kernels.reset_launch_counts()
    t0 = time.time()
    stand = srb.stand_up_rollout(cfg, seconds=2.0, batch_shape=(B_SRB,),
                                 **SRB_QP)
    mid = srb.rollout(stand.plant, stand.carry, cmd, 300, cfg, **SRB_QP)
    trot = srb.rollout(mid.plant, mid.carry, cmd, 300, cfg, **SRB_QP)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launch_counts)
    ticks = 1200
    log(f"  1200 ticks in {wall:.1f} s; launches {launches}")
    check(launches["qct_fused_solve"] == ticks,
          f"K1 launched once a tick ({launches['qct_fused_solve']} for "
          f"{ticks} ticks)")
    check(all(v == 0 for k, v in launches.items()
              if k != "qct_fused_solve"), "no launch of K2-K6")
    out = dict(launches=launches, wall_s=wall)
    out["stand"] = srb_stand_checks("stand-up", stand.trace, 0.01, 0.99)
    walk = srb.RolloutTrace(*(torch.cat([a, b]) for a, b in
                              zip(mid.trace, trot.trace)))
    out["trot"] = srb_walk_checks("trot", walk, 2.0)

    # K1 at the loop's shape on the trot's last state, against its plain
    # version (bitwise), its launch and time.
    bal = cfg.balance
    base = dict(s_diag=tuple(bal.s_diag), w_diag=float(bal.w_diag))
    inp = srb_k1_inputs(cfg, trot.plant, trot.carry, cmd)
    dense = kernels.assemble(*inp, swing_relax=SWING_ROW_RELAX,
                             equilibrated=False, **base)[:2]
    mode = dict(iterations=SRB_QP["qp_iterations"], polish=False)
    kern, max_abs = compare_fused(f"SRB barrier-{mode['iterations']}", inp,
                                  dense, (), **mode)
    fs_ = pf.FusedSchedule(**base, **mode)
    work = torch.zeros((2, B_SRB), dtype=torch.int32, device=DEV)
    kernels.fused_solve(*inp, (), fs_, work=work)
    ms1 = graph_ms(lambda: pf.solve_grf_qp_fused_packed(*inp, **base,
                                                        **mode), 20)
    t0 = time.time()
    pf._fused_plain(*inp, None, fs_)
    torch.cuda.synchronize()
    plain1 = (time.time() - t0) * 1e3
    ops1 = ops_fused(dict(prox_steps=0, polish_refine=0, ff_refine=False),
                     int(work[0].sum().item()), 0, 0, B_SRB)
    b1, by1 = bound_ms(4 * B_SRB * (25 + 66), ops1)
    log(f"  K1 barrier-{mode['iterations']} at B = {B_SRB}: {ms1:.4f} ms "
        f"through a CUDA graph (plain {plain1:.0f} ms, bound {b1:.5f} ms, "
        f"{by1})")
    out["k1"] = dict(mode=f"SRB rollout barrier-{mode['iterations']}",
                     batch=B_SRB, ms=ms1, plain_ms=plain1, bound_ms=b1,
                     bound_by=by1, operations=ops1, max_abs_err=max_abs,
                     geometry=fused_geometry(B_SRB, False))

    # Teacher-forced ticks from three recorded states.
    errs = {}
    for nm, res in (("stood up (tick 600)", stand), ("trot (tick 900)", mid),
                    ("trot (tick 1200)", trot)):
        e = srb_teacher_forced(f"teacher-forced tick from {nm}", cfg,
                               res.plant, res.carry, cmd,
                               SRB_TF_TOLS["balance"], **SRB_QP)
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
    out["teacher_forced_max_err"] = errs
    return out


def phase_srb_mpc(cfg):
    N, every = SRB_MPC["mpc_horizon"], SRB_EVERY
    log(f"== phase 17 (g): the SRB MPC rollouts, B = {B_SRB_MPC}, K6 (N = "
        f"{N}, mpc_dt = {SRB_MPC['mpc_dt']}, cold, "
        f"{SRB_MPC['mpc_iterations']} iterations): every tick (450 stand-up "
        f"+ 450 trot), and every {every}th tick (rollout_mpc_decimated, "
        f"zoh, the same)")
    cmd = srb_cmd(B_SRB_MPC)
    dec_kw = dict(mpc_every=every, hold_mode="zoh",
                  **{k: v for k, v in SRB_MPC.items() if k != "controller"})
    out = {}

    kernels.reset_launch_counts()
    t0 = time.time()
    stand = srb.stand_up_rollout(cfg, seconds=1.5, batch_shape=(B_SRB_MPC,),
                                 **SRB_MPC)
    walk = srb.rollout(stand.plant, stand.carry, cmd, 450, cfg, **SRB_MPC)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launch_counts)
    log(f"  every tick: 900 ticks in {wall:.1f} s; launches {launches}")
    check(launches["qct_mpc_riccati"] == 900,
          f"K6 launched once a tick ({launches['qct_mpc_riccati']} for 900 "
          f"ticks)")
    check(all(v == 0 for k, v in launches.items()
              if k != "qct_mpc_riccati"), "no launch of K1-K5")
    out["per_tick"] = dict(
        launches=launches, wall_s=wall,
        stand=srb_stand_checks("MPC stand-up", stand.trace, 0.01, 0.95),
        trot=srb_walk_checks("MPC trot", walk.trace, 1.5))

    kernels.reset_launch_counts()
    t0 = time.time()
    plant = init_plant_state(cfg, (B_SRB_MPC,))
    carry = init_commander_carry((B_SRB_MPC,))
    dstand = srb.rollout_mpc_decimated(plant, carry, 0.0 * cmd, 450, cfg,
                                       **dec_kw)
    dwalk = srb.rollout_mpc_decimated(dstand.plant, dstand.carry, cmd, 450,
                                      cfg, **dec_kw)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(kernels.launch_counts)
    log(f"  every {every}th tick: 900 ticks in {wall:.1f} s; launches "
        f"{launches}")
    check(launches["qct_mpc_riccati"] == 900 // every,
          f"K6 launched once a group ({launches['qct_mpc_riccati']} for "
          f"900 ticks / {every})")
    check(all(v == 0 for k, v in launches.items()
              if k != "qct_mpc_riccati"), "no launch of K1-K5")
    z_err = (dstand.trace.x[-1, :, 2] - 0.26).abs().max().item()
    check(bool(torch.isfinite(dstand.trace.x).all()) and z_err < 0.012,
          f"decimated stand-up: finite, every robot at 0.26 m within 0.012 "
          f"(worst {z_err:.5f}; tests/test_mpc_commander.py:72)")
    out["decimated"] = dict(
        launches=launches, wall_s=wall, stand_z_err=z_err,
        trot=srb_walk_checks("decimated trot", dwalk.trace, 1.5,
                             stance_check=False))

    # K6 at the loop's shape on the per-tick trot's last state, against its
    # plain version, and its time.
    st = _mpc_settings(cfg, N, SRB_MPC["mpc_dt"], SRB_MPC["mpc_iterations"])
    block = srb_k6_block(cfg, walk.plant, walk.carry, cmd)
    kern = _mpc_solve(block, None, st)
    hold_mpc_to_serial(f"SRB loop's block, B = {B_SRB_MPC}", kern,
                       mpc_serial(block, None, st))
    bal = cfg.balance
    phys = torch.tensor([bal.mass, *bal.inertia_diag, bal.mu, bal.fz_min,
                         bal.fz_max], device=DEV)[:, None].expand(
        7, B_SRB_MPC).contiguous()
    yaw = block[2].contiguous()
    hold_mpc_to_serial(
        "SRB loop's block with solve_mpc_fused's per-robot yaw and "
        "constants", kernels.mpc_riccati(block, yaw, phys, None, st.params(),
                                         N),
        mpc_serial(block, None, st, yaw, phys))
    plain = fr.packed_plain(block, None, st) + (None,)
    torch.cuda.synchronize()
    max_abs, stats = hold_mpc_to_plain(
        f"SRB N={N} cold-{st.iterations} B={B_SRB_MPC}", cfg, block, kern,
        plain, N, st.dt)
    ms6 = event_ms(lambda: _mpc_solve(block, None, st), 10)
    t0 = time.time()
    fr.packed_plain(block, None, st)
    torch.cuda.synchronize()
    plain6 = (time.time() - t0) * 1e3
    b6, by6 = bound_ms(B_SRB_MPC * mpc_bytes(N, False),
                       B_SRB_MPC * ops_mpc(N, st.iterations, False))
    log(f"  K6 N = {N} cold-{st.iterations} at B = {B_SRB_MPC}: {ms6:.4f} ms "
        f"(plain {plain6:.0f} ms, bound {b6:.5f} ms, {by6})")
    out["k6"] = dict(ms=ms6, plain_ms=plain6, bound_ms=b6, bound_by=by6,
                     max_abs_err=max_abs, stats=stats)

    errs = {}
    for nm, res in (("MPC stood up (tick 450)", stand),
                    ("MPC trot (tick 900)", walk),
                    ("decimated trot (tick 900)", dwalk)):
        e = srb_teacher_forced(f"teacher-forced tick from {nm}", cfg,
                               res.plant, res.carry, cmd, SRB_TF_TOLS["mpc"],
                               qp_iterations=12, qp_polish=False, **SRB_MPC)
        errs = {k: max(errs.get(k, 0.0), v) for k, v in e.items()}
    out["teacher_forced_max_err"] = errs
    return out


def phase_srb_gradients(cfg):
    log("== phase 18 (h): gradients on the card (float64)")
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED + 18)
    s = grf_scenarios(gen, 64, mit_cheetah_config(), device=DEV)
    qp = assemble_qp_batch(s, mit_cheetah_config())
    w = torch.randn(12, generator=gen, device=DEV, dtype=torch.float64)
    def grads(dev):
        leaves = [a.double().to(dev).requires_grad_(True)
                  for a in (qp.Q, qp.c, qp.G, qp.h)]
        x = solve_qp_implicit(*leaves, 40, True)
        torch.sum(x * w.to(dev)).backward()
        return [a.grad.cpu() for a in leaves] + [x.detach().cpu()]

    errs = {nm: ((a - b).abs().max() / (1.0 + b.abs().max())).item()
            for nm, a, b in zip(("Q", "c", "G", "h", "x"), grads(DEV),
                                grads("cpu"))}
    log("  solve_qp_implicit, 64 QPs, d(x . w)/d(Q, c, G, h): max |cuda - "
        "cpu| / (1 + max|cpu|): " + ", ".join(f"{k} {v:.2e}" for k, v in
                                              errs.items()))
    check(all(v < 1e-8 for v in errs.values()),
          "implicit gradients on the card equal the CPU's within 1e-8")

    # tests/test_mpc_commander.py:91: d loss / d vx through 30 ticks of the
    # decimated MPC walking loop (structured backend, float64).
    t0 = time.time()
    stand = srb.stand_up_rollout(cfg, seconds=2.0, dtype=torch.float64)
    check(bool(stand.carry.standing), "float64 stand-up (600 ticks, B = 1) "
          "standing")
    kw = dict(mpc_every=5, mpc_horizon=4, mpc_dt=0.04, mpc_iterations=12,
              mpc_backend="structured", record=False)

    def loss(vx):
        cmd = torch.cat([vx.reshape(1),
                         torch.zeros(5, dtype=torch.float64, device=DEV)])
        res = srb.rollout_mpc_decimated(stand.plant, stand.carry, cmd, 30,
                                        cfg, **kw)
        return (res.plant.com.xdot[0] - 0.2) ** 2

    vx = torch.tensor(0.1, dtype=torch.float64, device=DEV,
                      requires_grad=True)
    loss(vx).backward()
    g = vx.grad.item()
    with torch.no_grad():
        e = 1e-6
        fd = (loss(torch.tensor(0.1 + e, dtype=torch.float64, device=DEV))
              - loss(torch.tensor(0.1 - e, dtype=torch.float64, device=DEV))
              ).item() / (2 * e)
    rel = abs(g - fd) / (1.0 + abs(fd))
    log(f"  walking-loop gradient {g:.10f}, central difference {fd:.10f}, "
        f"rel {rel:.2e} ({time.time() - t0:.1f} s with the stand-up)")
    check(np.isfinite(g) and rel < 1e-7, "the MPC walking-loop gradient "
          "meets its central difference within 1e-7")
    # A gradient asked for through a kernel backend raises.
    plant = init_plant_state(cfg, (4,))
    com = plant.com._replace(x=plant.com.x.clone().requires_grad_(True))
    try:
        commander_step(com, plant.joints, init_commander_carry((4,)),
                       srb_cmd(4), 1.0 / cfg.frequency, cfg, **SRB_QP)
    except RuntimeError as err:
        check("no backward" in str(err),
              "a gradient through K1 raises on the card")
    else:
        fail("a gradient through K1 did not raise")
    return dict(implicit_rel_err=errs, loop_grad=g, loop_fd=fd, loop_rel=rel)


def phase_srb_times(cfg, bal_res, mpc_res):
    log("== phase 19: ms per tick of the SRB rollouts (marginal, "
        "scripts/rollout_bench.py's lengths), host enqueue, kernel share")
    out = {}

    def marginal(name, fn, short, long_, kernel_ms, launches_per_tick):
        def run(steps):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            h0 = time.time()
            t0.record()
            fn(steps)
            h1 = time.time()
            t1.record()
            torch.cuda.synchronize()
            return t0.elapsed_time(t1), (h1 - h0) * 1e3

        run(short)
        best = {short: (1e30, 0.0), long_: (1e30, 0.0)}
        for _ in range(2):
            for steps in (short, long_):
                best[steps] = min(best[steps], run(steps))
        n = long_ - short
        ms = (best[long_][0] - best[short][0]) / n
        host = (best[long_][1] - best[short][1]) / n
        share = kernel_ms * launches_per_tick / ms
        log(f"  {name}: {ms:.4f} ms/tick (CUDA events, marginal {long_} - "
            f"{short} ticks); the host enqueues a tick in {host:.4f} ms; "
            f"the kernel's device time is {share:.3f} of a tick "
            f"({kernel_ms:.4f} ms x {launches_per_tick} a tick)")
        return dict(ms_per_tick=ms, host_ms_per_tick=host,
                    kernel_share=share, ticks=(short, long_))

    B, Bm = B_SRB, B_SRB_MPC
    st0 = (init_plant_state(cfg, (B,)), init_commander_carry((B,)))
    cmd = srb_cmd(B)
    out["balance"] = marginal(
        f"balance, K1, B = {B}", lambda n: srb.rollout(
            *st0, cmd, n, cfg, record=False, **SRB_QP),
        40, 120, bal_res["k1"]["ms"], 1)
    stm = (init_plant_state(cfg, (Bm,)), init_commander_carry((Bm,)))
    cmdm = srb_cmd(Bm)
    k6 = mpc_res["k6"]["ms"]
    out["mpc"] = marginal(
        f"MPC every tick, K6, B = {Bm}", lambda n: srb.rollout(
            *stm, cmdm, n, cfg, record=False, **SRB_MPC),
        10, 30, k6, 1)
    dec_kw = dict(mpc_every=SRB_EVERY,
                  **{k: v for k, v in SRB_MPC.items() if k != "controller"})
    out["mpc_decimated"] = marginal(
        f"MPC every {SRB_EVERY}th tick, K6, B = {Bm}",
        lambda n: srb.rollout_mpc_decimated(*stm, cmdm, n, cfg, record=False,
                                            **dec_kw),
        40, 120, k6, 1.0 / SRB_EVERY)
    return out


# ---------------------------------------------------------------------------
# Scenario sharding (parallel/mesh.py) and checkpoints (utils/checkpoint.py)
# ---------------------------------------------------------------------------

SHARD_TICKS = 60
SHARD_MPC_EVERY = 2
B_SOLVE = 32768


def _counted(fn):
    """(fn(), the launch counts of that call alone)."""
    kernels.reset_launch_counts()                  # counts set to 0
    out = fn()
    torch.cuda.synchronize()
    return out, dict(kernels.launch_counts)        # counts read


def _bitwise_trees(a, b):
    """Every tensor leaf of two trees has the same bytes."""
    la, lb = pmesh.tree_leaves(a), pmesh.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(x.contiguous().view(torch.uint8),
                        y.contiguous().view(torch.uint8))
        for x, y in zip(la, lb))


def _only(counts, expected, what):
    """Fail unless the counts are exactly ``expected`` (zero elsewhere)."""
    want = {k: expected.get(k, 0) for k in counts}
    check(counts == want, f"{what}: launches exactly {expected}, nothing "
          f"else ({ {k: v for k, v in counts.items() if v} })")


def _marginal_ms(fn, lo, hi):
    """ms per tick of ``fn(steps)``: CUDA events around runs of ``lo`` and
    ``hi`` ticks (best of two each, after a warm-up), (hi - lo) marginal."""
    def once(steps):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        fn(steps)
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1)

    once(lo)
    best = {lo: 1e30, hi: 1e30}
    for _ in range(2):
        for steps in (lo, hi):
            best[steps] = min(best[steps], once(steps))
    return (best[hi] - best[lo]) / (hi - lo)


def _free_port():
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def phase_sharding(tick_cfg, tick_res, mpc_res, mpc_times, gen):
    log(f"== phase 20: scenario sharding on the card (parallel/mesh.py), B = "
        f"{B_TICK}, {N_SUBSTEPS} substeps, meshes of 1 and 4 entries")
    everything = pmesh.scenario_mesh()
    log(f"  scenario_mesh(): {len(everything)} entries {everything}")
    check(len(everything) == torch.cuda.device_count(),
          "scenario_mesh() has one entry per card")
    dev0 = everything[0]
    meshes = ((1, pmesh.scenario_mesh([dev0])),
              (4, pmesh.scenario_mesh([dev0] * 4)))
    out = {"mesh_len": len(everything), "ms_per_tick": {}}

    # The balance tick of phase 7 (K4 -> K1 -> K5) from its stood-up state.
    obj = tick_res["objects"]
    tick, res, cmd = obj["tick"], obj["res"], obj["cmd"]
    T = SHARD_TICKS
    whole, cw = _counted(lambda: ftick.rollout_whole_body_fused(
        res.plant, res.carry, cmd, T, tick, n_substeps=N_SUBSTEPS))
    _only(cw, {"qct_commander_pre": T, "qct_fused_solve": T,
               "qct_substep": T}, f"unsharded balance tick, {T} ticks")
    for n, mesh in meshes:
        run = pmesh.shard_rollout_whole_body_fused(mesh, tick,
                                                   n_substeps=N_SUBSTEPS)
        got, c = _counted(lambda: run(res.plant, res.carry, cmd, T))
        check(_bitwise_trees((got.plant, got.carry),
                             (whole.plant, whole.carry)),
              f"balance tick over {n} shard(s), {T} ticks: plant and carry "
              f"bitwise the unsharded loop's")
        _only(c, {"qct_commander_pre": n * T, "qct_fused_solve": n * T,
                  "qct_substep": n * T},
              f"balance tick over {n} shard(s): {n} x 3 launches a tick")

    # The warm-8 MPC tick of phase 10, decimated (K6 every 2nd tick).
    mtick, mres, mcmd = mpc_res["tick"], mpc_res["res"], mpc_res["cmd"]
    E = SHARD_MPC_EVERY
    mwhole, cw = _counted(lambda: ftick.rollout_whole_body_fused_decimated(
        mres.plant, mres.carry, mcmd, T, mtick, mpc_every=E,
        n_substeps=N_SUBSTEPS))
    _only(cw, {"qct_commander_pre": T, "qct_mpc_riccati": T // E,
               "qct_substep": T}, f"unsharded decimated MPC tick, {T} ticks")
    for n, mesh in meshes:
        run = pmesh.shard_rollout_whole_body_fused(
            mesh, mtick, n_substeps=N_SUBSTEPS, mpc_every=E)
        got, c = _counted(lambda: run(mres.plant, mres.carry, mcmd, T))
        check(_bitwise_trees((got.plant, got.carry),
                             (mwhole.plant, mwhole.carry)),
              f"decimated warm-8 MPC tick over {n} shard(s), {T} ticks: "
              f"plant and carry bitwise the unsharded loop's")
        _only(c, {"qct_commander_pre": n * T, "qct_mpc_riccati": n * T // E,
                  "qct_substep": n * T},
              f"decimated MPC tick over {n} shard(s): {n} x (K4, K6, K5) a "
              f"solving group, {n} x (K4, K5) a held tick")

    # ms per tick, marginal (60 - 10 ticks), unsharded and sharded.
    for name, tck, r_, c_, every in (("balance", tick, res, cmd, None),
                                     ("mpc_decimated", mtick, mres, mcmd, E)):
        def unsharded(steps, tck=tck, r_=r_, c_=c_, every=every):
            if every is None:
                return ftick.rollout_whole_body_fused(
                    r_.plant, r_.carry, c_, steps, tck,
                    n_substeps=N_SUBSTEPS)
            return ftick.rollout_whole_body_fused_decimated(
                r_.plant, r_.carry, c_, steps, tck, mpc_every=every,
                n_substeps=N_SUBSTEPS)

        row = {"unsharded": _marginal_ms(unsharded, 10, T)}
        for n, mesh in meshes:
            run = pmesh.shard_rollout_whole_body_fused(
                mesh, tck, n_substeps=N_SUBSTEPS, mpc_every=every)
            row[f"shards_{n}"] = _marginal_ms(
                lambda steps, run=run, r_=r_, c_=c_: run(r_.plant, r_.carry,
                                                         c_, steps), 10, T)
        out["ms_per_tick"][name] = row
    ref8 = tick_res["ms_per_tick"]
    ref12 = mpc_times["summary"]["warm-8"]["ms_per_tick"]
    log(f"  balance tick ms/tick: unsharded "
        f"{out['ms_per_tick']['balance']['unsharded']:.4f}, 1 shard "
        f"{out['ms_per_tick']['balance']['shards_1']:.4f}, 4 shards "
        f"{out['ms_per_tick']['balance']['shards_4']:.4f} (phase 8's warm "
        f"tick: {ref8:.4f})")
    log(f"  decimated MPC tick (every {E}) ms/tick: unsharded "
        f"{out['ms_per_tick']['mpc_decimated']['unsharded']:.4f}, 1 shard "
        f"{out['ms_per_tick']['mpc_decimated']['shards_1']:.4f}, 4 shards "
        f"{out['ms_per_tick']['mpc_decimated']['shards_4']:.4f} (phase 12's "
        f"warm-8 tick, K6 every tick: {ref12:.4f})")

    # shard_rollout_whole_body with the fused stepper (K5), 3 ticks.
    model = obj["model"]
    contact = ContactConfig()
    stepper = fsub.make_fused_stepper(model, tick_cfg, contact)
    kw = dict(n_substeps=N_SUBSTEPS, qp_iterations=8)
    plant0 = init_whole_body_state(tick_cfg, (B_TICK,))
    carry0 = init_commander_carry((B_TICK,))
    zero = torch.zeros((B_TICK, 6), device=DEV)
    from quadruped_control_tpu_torch.sim.rollout import rollout_whole_body
    ref, cw = _counted(lambda: rollout_whole_body(
        plant0, carry0, zero, 3, tick_cfg, model, contact, record=False,
        stepper=stepper, **kw))
    _only(cw, {"qct_substep": 3}, "unsharded rollout_whole_body with the "
          "fused stepper")
    gaps = {}
    for n, mesh in meshes:
        run = pmesh.shard_rollout_whole_body(mesh, tick_cfg, model, contact,
                                             stepper=stepper, **kw)
        got, c = _counted(lambda: run(plant0, carry0, zero, 3))
        _only(c, {"qct_substep": 3 * n},
              f"rollout_whole_body over {n} shard(s): K5 once a tick a shard")
        gx = (got.plant.x - ref.plant.x).abs().max().item()
        gu = (got.plant.u - ref.plant.u).abs().max().item()
        gaps[n] = dict(x=gx, u=gu)
        check(gx <= 1e-8 and gu <= 1e-6 and torch.equal(
            got.carry.standing, ref.carry.standing),
            f"rollout_whole_body over {n} shard(s), 3 ticks: max|dx| "
            f"{gx:.3e} <= 1e-8, max|du| {gu:.3e} <= 1e-6, standing equal")
    out["whole_body_gap"] = gaps

    # solve_scenarios_sharded at B = 32768 (the plain batched IPM). The
    # shards must be the per-instance solve of their slices: bitwise the
    # unsharded solve of each slice on its own (the same calls at the same
    # batch), flags and fraction included. Against the whole batch solved at
    # once, float32 differs: the batched cuBLAS / cuSOLVER calls of the plain
    # IPM round otherwise at another batch size, and the balance QP's flat
    # internal-force directions carry that to newtons on some lanes (55.7 N
    # on one lane over 4 shards, NVIDIA H100 80GB HBM3; PERF.md §6). That
    # gap, the flags' agreement and the objective gap are printed; x against
    # the whole batch is held in float64 (1e-5).
    cfg = mit_cheetah_config()
    s = grf_scenarios(gen, B_SOLVE, cfg, device=DEV)
    qp = assemble_qp_batch(s, cfg)
    Qd, cd = qp.Q.double(), qp.c.double()

    def objective(x):
        xd = x.double()
        return (0.5 * torch.einsum("bi,bij,bj->b", xd, Qd, xd)
                + (cd * xd).sum(-1))

    (x1, c1, f1), cw = _counted(lambda: pmesh.solve_scenarios_sharded(s, cfg))
    _only(cw, {}, "solve_scenarios_sharded (no kernel)")
    o1 = objective(x1)
    s64 = pmesh.tree_map(lambda a: a.double() if a.is_floating_point()
                         else a, s)
    x64, c64, f64 = pmesh.solve_scenarios_sharded(s64, cfg)
    solve = {"unsharded_fraction": float(f1),
             "unsharded_fraction_f64": float(f64)}
    for n, mesh in meshes:
        sharded = pmesh.shard_scenarios(s, mesh)
        x, c, f = pmesh.solve_scenarios_sharded(sharded, cfg)
        parts = [pmesh.solve_scenarios_sharded(sh, cfg)
                 for sh in sharded.shards]
        xp = torch.cat([p_[0] for p_ in parts])
        cp = torch.cat([p_[1] for p_ in parts])
        check(_bitwise_trees((x, c), (xp, cp))
              and float(f) == float(cp.double().mean().to(f.dtype)),
              f"solve_scenarios_sharded over {n} shard(s), B = {B_SOLVE}: "
              f"x and flags bitwise each slice's own solve, fraction "
              f"{float(f):.5f} their mean")
        dx = (x - x1).abs().amax(-1)
        both = c & c1
        rel = ((objective(x) - o1).abs() / (1.0 + o1.abs()))[both]
        xs, cs, fs = pmesh.solve_scenarios_sharded(
            pmesh.shard_scenarios(s64, mesh), cfg)
        gap64 = (xs - x64).abs().max().item()
        row = dict(x_gap=dx.max().item(),
                   x_gap_certified=dx[both].max().item(),
                   lanes_above_1e5=int((dx > 1e-5).sum().item()),
                   flags_differ=int((c != c1).sum().item()),
                   objective_gap_median=rel.median().item(),
                   objective_gap_max=rel.max().item(), fraction=float(f),
                   x_gap_f64=gap64, flags_differ_f64=int(
                       (cs != c64).sum().item()), fraction_f64=float(fs))
        solve[f"shards_{n}"] = row
        log(f"  against the whole batch at once, float32: max|dx| "
            f"{row['x_gap']:.3e} ({row['lanes_above_1e5']} lanes above "
            f"1e-5; {row['x_gap_certified']:.3e} on lanes both certify), "
            f"flags differ on {row['flags_differ']} lanes, fraction "
            f"{float(f):.5f} vs {float(f1):.5f}, objective gap on lanes both "
            f"certify median {row['objective_gap_median']:.2e} max "
            f"{row['objective_gap_max']:.2e}; float64: max|dx| {gap64:.3e}, "
            f"flags differ on {row['flags_differ_f64']} lanes")
        check(gap64 <= 1e-5 and float(f) >= 0.95 and float(fs) >= 0.95,
              f"solve_scenarios_sharded over {n} shard(s), float64: max|dx| "
              f"{gap64:.3e} <= 1e-5 against the whole batch at once; "
              f"fractions >= 0.95")
    # The same solve with the fraction through an NCCL all_reduce.
    pdist.initialize(f"localhost:{_free_port()}", 1, 0)
    try:
        check(pdist._is_initialized() and pdist.is_primary()
              and torch.distributed.get_backend() == "nccl",
              "initialize('localhost:<port>', 1, 0): joined over NCCL")
        _, c_d, f_d = pmesh.solve_scenarios_sharded(
            pmesh.shard_scenarios(s, meshes[1][1]), cfg)
        local = c_d.double().mean().to(f_d.dtype)
        check(float(f_d) == float(local),
              f"the fraction through the NCCL all_reduce equals the local "
              f"mean exactly ({float(f_d):.6f})")
    finally:
        torch.distributed.destroy_process_group()
    solve["nccl_fraction"] = float(f_d)
    out["solve"] = solve

    # The entry points.
    forward, args = entry()
    xe, ce = forward(*args)
    torch.cuda.synchronize()
    check(tuple(xe.shape) == (256, 12) and xe.device.type == "cuda"
          and bool(torch.isfinite(xe).all())
          and ce.float().mean().item() > 0.8,
          f"entry(): forward on the card, x (256, 12) finite, converged "
          f"{ce.float().mean().item():.4f} > 0.8")
    dryrun_multichip(torch.cuda.device_count())
    check(True, f"dryrun_multichip({torch.cuda.device_count()}) ran its four "
          f"stages")
    return out


CKPT_CHUNKS, CKPT_TICKS = 4, 50


def phase_checkpoint(tick_res, main_res, gen):
    log(f"== phase 21: checkpoints on the card: run_checkpointed over "
        f"{CKPT_CHUNKS} chunks of {CKPT_TICKS} fused balance ticks, B = "
        f"{B_TICK}")
    obj = tick_res["objects"]
    tick, res, cmd = obj["tick"], obj["res"], obj["cmd"]

    def chunk(state, _i):
        plant, carry, warm = state
        r = ftick.rollout_whole_body_fused(plant, carry, cmd, CKPT_TICKS,
                                           tick, n_substeps=N_SUBSTEPS,
                                           warm=warm)
        return (r.plant, r.carry, r.warm)

    init = (res.plant, res.carry, res.warm)
    ref = init
    for i in range(CKPT_CHUNKS):
        ref = chunk(ref, i)
    with tempfile.TemporaryDirectory() as d:
        ckpt.run_checkpointed(chunk, init, n_chunks=2, directory=d)
        check(ckpt.latest_step(d) == 2, "the interrupted run left step 2")
        restored, _ = ckpt.restore_checkpoint(d, init)
        leaves = pmesh.tree_leaves(restored)
        check(all(a.device.type == "cuda" for a in leaves)
              and len(leaves) == len(pmesh.tree_leaves(init)),
              f"restored leaves on the card ({len(leaves)} of them)")
        done = []

        def counted(state, i):
            done.append(i)
            return chunk(state, i)

        out = ckpt.run_checkpointed(counted, init, n_chunks=CKPT_CHUNKS,
                                    directory=d)
        torch.cuda.synchronize()
        check(done == list(range(2, CKPT_CHUNKS)),
              f"the resumed run ran chunks {done} only")
        check(_bitwise_trees(out, ref),
              "the resumed run is bitwise the uninterrupted one (plant, "
              "carry, QP warm carry)")

    # profiling.benchmark of phase 4b's solve on one batch of B = 32768.
    cfg = mit_cheetah_config()
    bal = cfg.balance
    s = grf_scenarios(gen, B_MAIN, cfg, device=DEV)
    br = profiling.benchmark(
        pf.solve_balance_qp_fused, s.R, s.R_d, s.x, s.xdot, s.w, s.x_d,
        s.xdot_d, s.w_d, s.feet, s.stance, bal, name="solve_balance_qp_fused",
        reps=REPS, items=B_MAIN, **MAIN_SCHEDULE)
    log(f"  profiling.benchmark: {br} (phase 4b, CUDA events over fresh "
        f"inputs: {main_res['ms_per_solve']:.4f} ms)")
    check(br.device == torch.cuda.get_device_name(0) and br.steady_seconds > 0,
          "benchmark timed on the card")
    return dict(benchmark_steady_ms=br.steady_seconds * 1e3,
                benchmark_first_s=br.compile_seconds,
                phase4b_ms=main_res["ms_per_solve"])


def main():
    t_start = time.time()
    smi = phase_device()
    build_s = phase_build()
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}")
    cfg = mit_cheetah_config()
    worst = phase_kernels_vs_plain(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    modes, k2 = phase_main_shapes(cfg, gen)
    main_res = phase_main_path(cfg, gen)

    tick_cfg = mit_cheetah_physical_config()
    err4, k4_occ = phase_commander_vs_plain(tick_cfg)
    err5, k5_stats = phase_substep_vs_plain(tick_cfg)
    tick_res = phase_tick(tick_cfg)
    tick_launches = tick_res["launches"]
    modes = modes + [tick_res["k1_tick"]]
    mpc_cfg = mit_cheetah_whole_body_config()
    err4m = phase_commander_mpc_vs_plain(mpc_cfg)
    mpc_res = phase_mpc_tick(mpc_cfg)
    k6 = phase_mpc_kernel_vs_plain(mpc_cfg, mpc_res)
    mpc_times = phase_mpc_times(mpc_cfg, mpc_res)
    mpc_launches = mpc_res["launches"]
    gen_d = torch.Generator(device=DEV)
    gen_d.manual_seed(SEED + 4)
    dense_chk = phase_dense_vs_plain(cfg, gen_d)
    split = phase_split_pipeline(cfg, gen_d)
    xla = phase_prox_xla(cfg, gen_d, main_res)
    srb_cfg = mit_cheetah_physical_config()
    srb_bal = phase_srb_balance(srb_cfg)
    srb_mpc = phase_srb_mpc(srb_cfg)
    srb_grad = phase_srb_gradients(srb_cfg)
    srb_times = phase_srb_times(srb_cfg, srb_bal, srb_mpc)
    gen_s = torch.Generator(device=DEV)
    gen_s.manual_seed(SEED + 20)
    sharding = phase_sharding(tick_cfg, tick_res, mpc_res, mpc_times, gen_s)
    checkpoint = phase_checkpoint(tick_res, main_res, gen_s)
    srb_k1 = srb_bal["launches"]["qct_fused_solve"]
    srb_k6 = (srb_mpc["per_tick"]["launches"]["qct_mpc_riccati"],
              srb_mpc["decimated"]["launches"]["qct_mpc_riccati"])
    modes = modes + [srb_bal["k1"]]

    k1 = {
        "name": "qct_fused_solve", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_fused_polish.cu",
        "replaces": "quadruped_control_tpu/solver/pallas_fused.py:769",
        "launches": (main_res["launches"]["qct_fused_solve"]
                     + tick_launches["qct_fused_solve"] + srb_k1),
        "launches_by_path": {
            "solve": main_res["launches"]["qct_fused_solve"],
            "tick": tick_launches["qct_fused_solve"],
            "srb_rollout": srb_k1},
        "max_abs_err": max(worst["qct_fused_solve"],
                           max(m["max_abs_err"] for m in modes)),
        "ms": sum(m["ms"] for m in modes[:4]),
        "plain_ms": sum(m["plain_ms"] for m in modes[:4]),
        "bound_ms": sum(m["bound_ms"] for m in modes[:4]),
        "bound_by": max(modes[:4], key=lambda m: m["bound_ms"])["bound_by"],
        "library_ms": None,
        "shape": f"4 launches per solve of B={B_MAIN}: "
                 + ", ".join(f"{m['mode']} B={m['batch']}" for m in modes[:4])
                 + f"; 1 launch per tick of B={B_TICK} (modes[4]); 1 "
                 f"launch per SRB rollout tick of B={B_SRB} (modes[5])",
        "modes": modes,
    }
    k2_entry = {
        "name": "qct_assemble", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_assemble.cu",
        "replaces": "quadruped_control_tpu/solver/pallas_fused.py:1075",
        "launches": main_res["launches"]["qct_assemble"],
        "max_abs_err": max(worst["qct_assemble"], k2["max_abs_err"]),
        "ms": k2["ms"], "plain_ms": k2["plain_ms"],
        "bound_ms": k2["bound_ms"], "bound_by": "bytes", "library_ms": None,
        "event_ms": k2["event_ms"], "ms_equilibrated": k2["ms_equilibrated"],
        "event_ms_equilibrated": k2["event_ms_equilibrated"],
        "shape": f"B={B_MAIN}; ms through a CUDA graph, event_ms of "
                 f"back-to-back calls",
    }
    k4_entry = {
        "name": "qct_commander_pre", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_commander.cu",
        "replaces": "quadruped_control_tpu/control/pallas_commander.py:665",
        "launches": (tick_launches["qct_commander_pre"]
                     + mpc_launches["qct_commander_pre"]),
        "launches_by_path": {
            "tick": tick_launches["qct_commander_pre"],
            "mpc_tick": mpc_launches["qct_commander_pre"]},
        "max_abs_err": max(err4, err4m), "library_ms": None,
        "shape": f"B={B_TICK}, 1 launch per tick; with the MPC block "
                 f"(N={MPC_N}) on the MPC tick ({mpc_times['k4']['ms']:.4f} "
                 f"ms there); serial_ms: its serial body (one instance per "
                 f"thread)", **tick_res["k4"],
        "mpc_tick": {k: mpc_times["k4"][k] for k in (
            "ms", "serial_ms", "bound_ms", "plain_ms")},
        "geometry": {k: k4_occ[k] for k in (
            "blocks", "threads", "robots_per_block", "lanes")},
        "occupancy": {k: k4_occ[k] for k in (
            "blocks_per_sm", "registers", "local_bytes", "serial")},
    }
    k5_entry = {
        "name": "qct_substep", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_substep.cu",
        "replaces": "quadruped_control_tpu/sim/pallas_substep.py:526",
        "launches": (tick_launches["qct_substep"]
                     + mpc_launches["qct_substep"]),
        "launches_by_path": {"tick": tick_launches["qct_substep"],
                             "mpc_tick": mpc_launches["qct_substep"]},
        "max_abs_err": err5, "library_ms": None,
        "shape": f"B={B_TICK}, {N_SUBSTEPS} substeps, 1 launch per tick; "
                 f"serial_ms: its serial body (one robot per thread)",
        **tick_res["k5"], "geometry": k5_stats["geometry"],
    }
    k6_entry = {
        "name": "qct_mpc_riccati", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_mpc.cu",
        "replaces": "quadruped_control_tpu/mpc/pallas_riccati.py:79",
        "launches": mpc_launches["qct_mpc_riccati"] + sum(srb_k6),
        "launches_by_path": {"mpc_tick": mpc_launches["qct_mpc_riccati"],
                             "srb_mpc_rollout": srb_k6[0],
                             "srb_mpc_decimated": srb_k6[1]},
        "max_abs_err": max(k6["max_abs_err"],
                           srb_mpc["k6"]["max_abs_err"]),
        "library_ms": None,
        "shape": f"B={B_TICK}, N={MPC_N}, warm, {MPC_ITERS} iterations, "
                 f"1 launch per MPC tick (modes: {list(k6['modes'])}); "
                 f"srb: B={B_SRB_MPC}, N={SRB_MPC['mpc_horizon']}, cold, "
                 f"{SRB_MPC['mpc_iterations']} iterations, 1 launch per "
                 f"SRB MPC tick or per group of {SRB_EVERY}; serial_ms: "
                 f"its serial body (one robot per thread, qct_mpc_serial), "
                 f"the bitwise hold of phases 10, 11 and 17",
        **mpc_times["k6"], "modes": k6["modes"], "geometry": k6["geometry"],
        "srb": {k: srb_mpc["k6"][k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by")},
    }
    dense_entries = []
    for key, nm, line, k3 in (
            ("qct_dense_barrier", "K3a", 44, split["k3a"]),
            ("qct_dense_polish", "K3b", 301, split["k3b"])):
        dense_entries.append({
            "name": key, "route": "cuda",
            "source": "quadruped_control_tpu_torch/csrc/qct_dense_ipm.cu",
            "replaces": f"quadruped_control_tpu/solver/pallas_ipm.py:{line}",
            "launches": split["launches"][key] + xla["launches"][key],
            "launches_by_path": {"split_pipeline": split["launches"][key],
                                 "prox_xla": xla["launches"][key]},
            "max_abs_err": dense_chk["worst"][key],
            "ms": k3["ms"], "plain_ms": k3["plain_ms"],
            "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
            "library_ms": None,
            "shape": f"B={B_MAIN}, {DENSE_ITERS} iterations, 1 launch per "
                     f"dense solve; prox xla: {xla['slice']} instances, 6 "
                     f"per solve",
            "bitwise": dense_chk["bitwise"]})
    dense_entries[0].update(ms_b1024=split["k3a"]["ms_b1024"],
                            bound_ms_b1024=split["k3a"]["bound_ms_b1024"],
                            geometry=dense_chk["geometry_k3a"])
    dense_entries[1].update(ms_b1024=split["k3b"]["ms_b1024"],
                            geometry=dense_chk["geometry"])
    for entry in (k1, k4_entry, k5_entry, k6_entry, *dense_entries):
        if entry["launches"] <= 0:
            fail(f"{entry['name']} was launched no time on its main path")
    tick_summary = {k: tick_res[k] for k in (
        "ms_per_tick", "ticks_per_s", "host_ms_per_tick", "in_kernels_ms",
        "share_outside_kernels", "launches", "stand", "trot")}
    mpc_summary = dict(mpc_times["summary"], launches=mpc_launches,
                       stand=mpc_res["stand"], trot=mpc_res["trot"],
                       decimated=mpc_res["decimated"], cold=mpc_res["cold"])
    log(json.dumps({"main_path": main_res, "tick_path": tick_summary,
                    "mpc_tick_path": mpc_summary,
                    "split_pipeline": {k: split[k] for k in (
                        "ms_per_solve", "host_ms_per_solve", "qps",
                        "converged", "launches", "oracle_median")},
                    "prox_xla_path": xla,
                    "srb_path": {
                        "balance": {k: srb_bal[k] for k in (
                            "launches", "wall_s", "stand", "trot",
                            "teacher_forced_max_err")},
                        "mpc": {k: srb_mpc[k] for k in (
                            "per_tick", "decimated",
                            "teacher_forced_max_err")},
                        "gradients": srb_grad, "times": srb_times},
                    "sharding": sharding, "checkpoint": checkpoint,
                    "build_seconds": build_s,
                    "wall_seconds": time.time() - t_start}))
    log(smi)
    log(json.dumps({"kernels": [k1, k2_entry, dense_entries[0],
                                dense_entries[1], k4_entry, k5_entry,
                                k6_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
