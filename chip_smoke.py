#!/usr/bin/env python3
"""Chip smoke test of the PyTorch / CUDA port (quadruped_control_tpu_torch).

Run from the repository root on a machine with one NVIDIA Hopper card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``quadruped_control_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version on the card (every mode of the
fused kernel, at B = 4096 and at the shapes the main path launches), drives
the port's main path — ``solve_balance_qp_fused`` with the reference bench's
schedule at B = 32768, fresh seeded inputs per repetition — checks the result
(finite, converged fraction, float64 active-set oracle parity) and that the
path went through the kernels (launch counters), and prints the kernels'
times beside their bounds. Any failed phase ends the run with a non-zero exit
code; nothing is caught and carried on. Without a CUDA device it exits with
code 2 and prints no result.

Output: progress lines, then the card's ``nvidia-smi`` name and power limit,
one JSON line ``{"kernels": [...]}``, and as the LAST line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.stderr.write("chip_smoke: torch.cuda.is_available() is False; this "
                     "script needs one CUDA device\n")
    sys.exit(2)

from quadruped_control_tpu_torch import kernels  # noqa: E402
from quadruped_control_tpu_torch.config import mit_cheetah_config  # noqa: E402
from quadruped_control_tpu_torch.ops.dynamics import SWING_ROW_RELAX  # noqa: E402
from quadruped_control_tpu_torch.solver import fused as pf  # noqa: E402
from quadruped_control_tpu_torch.solver.reference import (  # noqa: E402
    solve_qp_batch_oracle,
)
from quadruped_control_tpu_torch.utils.scenarios import grf_scenarios  # noqa: E402

DEV = torch.device("cuda")
SEED = 0
B_CHECK = 4096
B_MAIN = 32768
REPS = 5
# Published peaks of one H100 SXM (NVIDIA data sheet): float32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The reference bench's schedule (bench.py of the JAX package).
MAIN_SCHEDULE = dict(
    iterations=20, polish=True, polish_sweeps=2, two_phase=True, split=True,
    tail_iterations=24, tail_sweeps=16, prox_tail=True,
    prox_backend="kernel", prox_steps=6, prox_iterations=24, prox_sweeps=6)


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


def hold_fused_to_plain(name, kern, plain, dense):
    """Fail unless K1's outputs ``kern`` = (x, s, z, diag) agree with its
    plain version's ``plain`` on the same inputs: objective gap (float64, on
    the dense ``(Q, c)`` of these inputs) median < 1e-6 and p95 < 1e-4,
    converged fraction within 0.005, certificate agreement >= 0.99.

    Same algorithm, same operation order: the tolerances leave room for
    last-bit differences of sqrt/divide between the kernel and PyTorch's
    elementwise kernels, which can move an active-set decision on a few
    ill-conditioned instances. Returns (max |dx|, certificate agreement)."""
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
    bitwise = bool(torch.equal(xk, xp) and torch.equal(dk, dp))
    log(f"  {name}: objective gap median {np.median(rel):.2e} p95 "
        f"{np.percentile(rel, 95):.2e}; conv kernel {conv_k:.4f} plain "
        f"{conv_p:.4f}; cert agreement {cert_agree:.4f}; max|dx| "
        f"{max_abs:.2e}; bitwise {bitwise}")
    if not (both.float().mean().item() > 0.999
            and np.median(rel) < 1e-6 and np.percentile(rel, 95) < 1e-4
            and abs(conv_k - conv_p) <= 0.005 and cert_agree >= 0.99):
        fail(f"kernel K1 {name} disagrees with its plain version")
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

        def run(name, warm=(), **kw):
            out, err = compare_fused(name, inp, dense, warm, **kw)
            worst["qct_fused_solve"] = max(worst["qct_fused_solve"], err)
            return out

        bar = run("barrier-only", iterations=20, polish=False)
        run("full", iterations=20, polish_sweeps=2)
        run("polish-only", warm=bar[:3], iterations=0, polish_sweeps=4)
        zero = (torch.zeros(12, B_CHECK, device=DEV),
                torch.zeros(24, B_CHECK, device=DEV),
                torch.zeros(24, B_CHECK, device=DEV),
                -torch.ones(4, B_CHECK, device=DEV))
        zw = pf.solve_grf_qp_fused_packed(*inp, *zero, iterations=20,
                                          polish=False, **base)
        check(all(torch.equal(a, b_) for a, b_ in zip(zw, bar)),
              "zero warm start with st_prev = -1 is bitwise the cold start "
              "(kernel vs kernel)")
        st_prev = inp[2].clone()
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
    # 3. the two-phase tail: B/8 worst instances, long schedule.
    idx = pf._worst_first(pol[3][1] > 0.5, B_MAIN // 8)
    inp_t = subset(inp, idx)
    k3 = sched(iterations=24, polish_sweeps=16, polish_refine=4)
    tail = pf.solve_grf_qp_fused_packed(*inp_t, **base, **k3)
    modes.append(("tail", inp_t, (), k3))
    # 4. the prox stage: B/64 worst instances after the merge.
    conv = pol[3][1] > 0.5
    conv[idx] = conv[idx] | (tail[3][1] > 0.5)
    idx_p = pf._worst_first(conv, B_MAIN // 64)
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
        out.append(dict(
            mode=name, batch=Bm, ms=ms, plain_ms=plain_ms,
            bound_ms=max(bound_ops, bound_bytes),
            bound_by="operations" if bound_ops >= bound_bytes else "bytes",
            operations=ops, bytes=nbytes, max_abs_err=err,
            mean_sweeps_run=sweeps_run / Bm, cert_agreement=agree))
        log(f"  K1 {name}: B {Bm}, kernel {ms:.3f} ms, plain {plain_ms:.0f} "
            f"ms, bound {max(bound_ops, bound_bytes):.4f} ms "
            f"({ops / Bm:.0f} operations/instance, {sweeps_run / Bm:.2f} "
            f"sweeps/instance run)")

    # K2 at the full batch.
    ms2 = event_ms(lambda: kernels.assemble(*inp, **akw), 10)
    t0 = time.time()
    P = pf._assembly_plain(*inp, **akw)
    torch.cuda.synchronize()
    plain2 = (time.time() - t0) * 1e3
    err2 = hold_assembly_to_plain(kernels.assemble(*inp, **akw), P, False)
    nbytes2 = 4 * B_MAIN * (26 + 468)
    ops2 = B_MAIN * _ASSEMBLE
    b2 = max(nbytes2 / PEAK_BYTES, ops2 / PEAK_F32_FLOPS) * 1e3
    log(f"  K2: B {B_MAIN}, kernel {ms2:.3f} ms, plain {plain2:.0f} ms, "
        f"bound {b2:.4f} ms (bytes), max abs err vs plain {err2:.2e}")
    k2 = dict(ms=ms2, plain_ms=plain2, bound_ms=b2, bound_by="bytes",
              max_abs_err=err2, bytes=nbytes2)
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


def main():
    t_start = time.time()
    smi = phase_device()
    build_s = phase_build()
    cfg = mit_cheetah_config()
    worst = phase_kernels_vs_plain(cfg)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(SEED)
    modes, k2 = phase_main_shapes(cfg, gen)
    main_res = phase_main_path(cfg, gen)

    k1 = {
        "name": "qct_fused_solve", "route": "cuda",
        "source": "quadruped_control_tpu_torch/csrc/qct_fused_polish.cu",
        "replaces": "quadruped_control_tpu/solver/pallas_fused.py:769",
        "launches": main_res["launches"]["qct_fused_solve"],
        "max_abs_err": max(worst["qct_fused_solve"],
                           max(m["max_abs_err"] for m in modes)),
        "ms": sum(m["ms"] for m in modes),
        "plain_ms": sum(m["plain_ms"] for m in modes),
        "bound_ms": sum(m["bound_ms"] for m in modes),
        "bound_by": max(modes, key=lambda m: m["bound_ms"])["bound_by"],
        "library_ms": None,
        "shape": f"4 launches per solve of B={B_MAIN}: "
                 + ", ".join(f"{m['mode']} B={m['batch']}" for m in modes),
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
        "shape": f"B={B_MAIN}",
    }
    log(json.dumps({"main_path": main_res, "build_seconds": build_s,
                    "wall_seconds": time.time() - t_start}))
    log(smi)
    log(json.dumps({"kernels": [k1, k2_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
