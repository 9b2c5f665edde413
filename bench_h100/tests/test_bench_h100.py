"""CPU tests of the benchmark (bench_h100/): the specification's names and
files, the frozen operation counts, the generator and the reference against
the port's own, the imports, and that the comparison deciding ``correct``
passes the program while it fails the control and each planted fault. Run:

    python -m pytest bench_h100/tests -q
"""

import ast
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent.parent
ROOT = HERE.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SMALL = dict(batch=128, pool=2, sample_per_batch=64)
SEED = 2**31 + 4321


def test_names_and_units():
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += [w["name"] for w in SPEC["workloads"]]
    names += [c["name"] for c in SPEC["configs"]]
    names += [w[k] for w in SPEC["workloads"] for k in ("config", "traffic")]
    for n in names:
        assert NAME.match(n), n
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
        for cell in m.get("workloads", []):
            assert cell in moved.get("workloads", [cell]), (m["name"], cell)


def test_files_resolve_by_name():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert w["config"] in configs
        wl = json.loads((HERE / "workloads" / f"{w['traffic']}.json")
                        .read_text())
        assert (HERE / "drivers" / f"{wl['driver']}.py").is_file()
    for path in (HERE / "workloads").glob("*.json"):
        wl = json.loads(path.read_text())
        assert (HERE / "drivers" / f"{wl['driver']}.py").is_file(), path
    import run

    for m in SPEC["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def _chip_smoke_counts():
    """chip_smoke.py's counting functions and their constants, taken from
    its source (the script itself exits on a machine without a card)."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    keep = [n for n in tree.body
            if (isinstance(n, ast.FunctionDef) and n.name.startswith("ops_"))
            or (isinstance(n, ast.Assign) and all(
                isinstance(t, ast.Name) and t.id.startswith("_")
                and t.id.isupper() for t in n.targets))]
    ns = {}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "chip_smoke",
                 "exec"), ns)
    return type("ChipSmoke", (), ns)


def test_counts_match_chip_smoke():
    chip_smoke = _chip_smoke_counts()
    from counts import k1
    from quadruped_control_tpu_torch.solver import fused as pf

    assert k1.barrier_iteration() == chip_smoke.ops_barrier_iteration()
    for refine in (1, 4):
        for ff in (False, True):
            assert k1.polish_sweep(refine, ff) == \
                chip_smoke.ops_polish_sweep(refine, ff)
    S = json.loads((HERE / "workloads" / "grf_fused.b32768.json")
                   .read_text())["schedule"]
    B = 32768
    got = {st: (b, o) for st, b, o, _ in k1.fused_solve(B, S)}
    assert got["tail"][0] == pf.two_phase_tail_size(B, 16, 8)
    assert got["prox"][0] == min(B, pf.prox_slice_size(B, 16, True, 8, 64,
                                                       "kernel"))
    # The same launch counted by chip_smoke.py with the schedule's fixed
    # iterations and one sweep an instance per polish call.
    for stage, kw in (("barrier", dict(iterations=20, polish=False)),
                      ("tail", dict(iterations=24, polish=True))):
        b, ops = got[stage]
        sched = dict(prox_steps=0, polish_refine=4, ff_refine=True)
        want = chip_smoke.ops_fused(sched, b * kw["iterations"],
                                    b if kw["polish"] else 0, 0, b)
        assert ops == want, stage
    b, ops = got["prox"]
    sched = dict(prox_steps=6, polish_refine=4, ff_refine=True)
    assert ops == chip_smoke.ops_fused(sched, b * 6 * 24, b, 6 * b, b)


def _scenarios(batch, seed):
    import traffic

    wl = json.loads((HERE / "workloads" / "grf_fused.b32768.json")
                    .read_text())
    cfg = json.loads((HERE / "configs" / "mini_cheetah_balance.json")
                     .read_text())
    gen = torch.Generator().manual_seed(seed)
    return traffic.grf_scenarios(wl["traffic"], cfg, batch, gen, "cpu"), \
        cfg, wl


def test_generator_matches_the_port():
    from quadruped_control_tpu_torch.config import mit_cheetah_config
    from quadruped_control_tpu_torch.utils.scenarios import grf_scenarios

    s, _, _ = _scenarios(64, SEED)
    p = grf_scenarios(torch.Generator().manual_seed(SEED), 64,
                      mit_cheetah_config(), device="cpu")
    for k, v in s.items():
        assert torch.equal(v, getattr(p, k)), k


def test_reference_against_the_ports_plain_versions():
    from reference import grf_qp
    from reference.precision import Arith
    from quadruped_control_tpu_torch.config import mit_cheetah_config
    from quadruped_control_tpu_torch.ops.dynamics import build_balance_qp
    from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm

    s, cfg, _ = _scenarios(96, SEED + 1)
    d = {k: (v.double() if v.is_floating_point() else v) for k, v in
         s.items()}
    keys = ("R", "R_d", "x", "xdot", "w", "x_d", "xdot_d", "w_d", "feet",
            "stance")
    qp = build_balance_qp(*[d[k] for k in keys], mit_cheetah_config().balance)
    ref = grf_qp.balance_qp(s, cfg["balance"], Arith("float64"))
    for a, b in zip(ref, qp):
        assert torch.allclose(a, b, rtol=1e-14, atol=1e-12)
    x, _ = grf_qp.solve(*ref, Arith("float64"))
    sol = solve_qp_ipm(qp.Q, qp.c, qp.G, qp.h, iterations=60)
    f = grf_qp.objective(ref[0], ref[1], x)
    fp = grf_qp.objective(ref[0], ref[1], sol.x)
    assert ((f - fp).abs() / (1 + fp.abs())).max() < 1e-8


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_imports():
    bad = {"jax", "jaxlib", "flax", "quadruped_control_tpu"}
    for path in HERE.rglob("*.py"):
        if "tests" in path.relative_to(HERE).parts:
            continue
        tops = set(_imports(path))
        assert not tops & bad, (path, tops & bad)
        if "reference" in path.relative_to(HERE).parts:
            assert "quadruped_control_tpu_torch" not in tops, path
    # What a run loads, in a process of its own.
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r]; import run; "
        "run.run_cell(%r, 'grf_fused.b32768', 5, 0.1, 0, "
        "torch.device('cpu'), overrides=%r, log=lambda m: None); "
        "print(run.forbidden_modules())" % (str(HERE), str(ROOT), SPEC,
                                            SMALL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# The cells at a small size: on the CPU the port runs its plain versions.
CELLS = [w["name"] for w in SPEC["workloads"]]


def _run(cell, wrap=None, seed=SEED):
    import run

    return run.run_cell(SPEC, cell, seed, 0.1, 0, torch.device("cpu"),
                        overrides=SMALL, wrap_call=wrap, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell):
    import importlib

    import run
    from tracing import Tracer

    _, cfg, wl = run.cell_files(SPEC, cell)
    wl = dict(wl, **SMALL)
    drv = importlib.import_module(f"drivers.{wl['driver']}").Driver(
        cfg, wl, SEED, torch.device("cpu"))
    drv.window(0.1, Tracer(False))
    drv.free()
    program = drv.check()
    assert all(v <= lim for _, v, lim in program), program
    control = drv.check(drv.control_answers())
    assert not all(v <= lim for _, v, lim in control), control


def _altered(call):
    def f(*a):
        x, conv = call(*a)
        x = x.clone()
        x[::7, 2] += 2.0                             # a QP's fz, every 7th
        return x, conv
    return f


def _half_left_out(call):
    def f(*a):
        x, conv = call(*a)
        x = x.clone()
        x[x.shape[0] // 2:] = 0.0                    # never solved
        return x, conv
    return f


def _unchanged(call):
    last = {}

    def f(*a):
        x, conv = call(*a)
        prev = last.get("x", torch.zeros_like(x))
        last["x"] = x                                # a stale answer
        return prev, conv
    return f


@pytest.mark.parametrize("cell", CELLS)
def test_program_run_is_correct(cell):
    assert _run(cell)["correct"]


@pytest.mark.parametrize("fault", [_altered, _half_left_out, _unchanged])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_fail(cell, fault):
    assert not _run(cell, wrap=fault)["correct"]


@pytest.mark.card
def test_a_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "grf_fused.b32768", "--seed", str(SEED), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=600,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
