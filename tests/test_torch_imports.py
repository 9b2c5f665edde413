"""PyTorch port: the package, its scripts (scripts/torch_*.py) and
chip_smoke.py import neither jax nor the JAX package (checked on the syntax
tree, so lazy imports count too)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(
    str(p.relative_to(ROOT))
    for p in (ROOT / "quadruped_control_tpu_torch").rglob("*.py")
) + sorted(str(p.relative_to(ROOT))
           for p in (ROOT / "scripts").glob("torch_*.py")) + ["chip_smoke.py"]

FORBIDDEN = ("jax", "jaxlib", "flax", "quadruped_control_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module, node.lineno
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value), node.lineno


@pytest.mark.parametrize("rel", FILES)
def test_no_jax_import(rel):
    bad = [(m, ln) for m, ln in _imported_modules(ROOT / rel)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{rel} imports {bad}"


def test_port_has_the_expected_modules():
    have = set(FILES)
    for rel in ("config.py", "convert.py", "kernels.py", "math/rotations.py",
                "math/numerics.py", "ops/kinematics.py", "ops/dynamics.py",
                "solver/ipm.py", "solver/fused.py", "solver/reference.py",
                "solver/smallalg.py", "utils/ff.py", "utils/scenarios.py",
                # the closed-loop whole-body tick
                "types.py", "ops/gait.py", "ops/foot_planner.py",
                "ops/trajectory.py", "ops/joint_control.py",
                "control/commander.py", "control/rollout.py",
                "control/fused_commander.py", "sim/__init__.py",
                "sim/model.py", "sim/dynamics.py", "sim/plant.py",
                "sim/rollout.py", "sim/fused_substep.py",
                "sim/fused_tick.py",
                # the receding-horizon MPC tick
                "mpc/__init__.py", "mpc/horizon.py", "mpc/structured.py",
                "mpc/fused_riccati.py",
                # the dense QP solve
                "solver/fused_ipm.py",
                # the SRB plant and rollouts, loaders, gradients
                "control/plant.py", "yaml_config.py", "native.py",
                "solver/admm.py", "solver/diff.py",
                # sharding, the entry points, checkpoint / profiling / viz
                "parallel/__init__.py", "parallel/mesh.py",
                "parallel/distributed.py", "entry.py",
                "utils/checkpoint.py", "utils/profiling.py", "utils/viz.py"):
        assert f"quadruped_control_tpu_torch/{rel}" in have
    csrc = ROOT / "quadruped_control_tpu_torch" / "csrc"
    assert sorted(p.name for p in csrc.glob("*.cu")) == [
        "qct_assemble.cu", "qct_commander.cu", "qct_dense_ipm.cu",
        "qct_fused_barrier.cu", "qct_fused_polish.cu", "qct_mpc.cu",
        "qct_substep.cu"]


def test_every_kernel_source_is_built_and_counted():
    """kernels.py builds every .cu under csrc/ and keeps one launch counter
    per kernel wrapper; importing it builds nothing."""
    from quadruped_control_tpu_torch import kernels

    csrc = ROOT / "quadruped_control_tpu_torch" / "csrc"
    assert sorted(kernels._SOURCES) == sorted(
        p.name for p in csrc.glob("*.cu"))
    assert set(kernels.launch_counts) == {
        "qct_fused_solve", "qct_assemble", "qct_commander_pre",
        "qct_commander_serial", "qct_substep", "qct_substep_serial",
        "qct_mpc_riccati", "qct_mpc_serial",
        "qct_dense_barrier", "qct_dense_polish"}
    kernels.reset_launch_counts()
    assert not any(kernels.launch_counts.values())


def test_kernels_use_nan_propagating_min_max():
    """CUDA fminf/fmaxf drop a NaN; the barrier's poison and the plant's
    freeze-on-nonfinite guard need it kept (qmin/qmax of qct_common.cuh)."""
    csrc = ROOT / "quadruped_control_tpu_torch" / "csrc"
    for path in sorted(csrc.glob("*.cu*")):
        code = "\n".join(line.split("//")[0]
                         for line in path.read_text().splitlines())
        for name in ("fminf(", "fmaxf(", "fmin(", "fmax("):
            assert name not in code, f"{path.name} calls {name[:-1]}"


def test_kernel_sources_never_use_fast_math():
    text = (ROOT / "quadruped_control_tpu_torch" / "kernels.py").read_text()
    flags = text.split("_NVCC_FLAGS = (")[1].split(")")[0]
    assert "fast_math" not in flags and "-fmad=false" in flags
    assert "sm_90a" in flags
