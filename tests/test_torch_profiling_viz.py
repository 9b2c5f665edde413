"""PyTorch port: profiling helpers (utils/profiling.py) on the CPU, and the
offline plots (utils/viz.py) against the JAX package's on the same trace.

The trace is a short SRB rollout of the port from the laying pose (float64,
one robot), handed to both packages' plotting functions; the swing
coefficients are drawn with NumPy from a seed.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.control.rollout import (
    RolloutTrace as JaxRolloutTrace,
)
from quadruped_control_tpu.utils import viz as jviz
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.control.plant import init_plant_state
from quadruped_control_tpu_torch.control.rollout import rollout
from quadruped_control_tpu_torch.utils import profiling, viz

CFG = mit_cheetah_physical_config()
DT = 1.0 / CFG.frequency


@pytest.fixture(scope="module")
def traces():
    """(port trace, the same arrays as the JAX package's RolloutTrace)."""
    f64 = dict(dtype=torch.float64, device="cpu")
    cmd = torch.zeros(6, **f64)
    cmd[0] = 0.2
    res = rollout(init_plant_state(CFG, (), **f64),
                  init_commander_carry((), **f64), cmd, 24, CFG)
    d = convert.rollout_trace_to_numpy(res.trace)
    return res.trace, JaxRolloutTrace(**{k: jnp.asarray(v)
                                         for k, v in d.items()})


def _artists(fig):
    """Every line's data (3-D lines with their z) and every filled
    region's vertices, axis by axis."""
    out = []
    for ax in fig.axes:
        for ln in ax.get_lines():
            data = (np.asarray(ln.get_data_3d()).T
                    if hasattr(ln, "get_data_3d")
                    else np.asarray(ln.get_xydata()))
            out.append(data.astype(np.float64))
        for coll in ax.collections:
            for path in coll.get_paths():
                out.append(np.asarray(path.vertices, np.float64))
    return out


def _assert_same_figure(fig, fig_j):
    a, b = _artists(fig), _artists(fig_j)
    assert len(a) == len(b) and len(a) > 0
    for x, y in zip(a, b):
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-12)
    assert ([ax.get_title() for ax in fig.axes]
            == [ax.get_title() for ax in fig_j.axes])


def test_benchmark_and_stage_timer():
    """benchmark times the first call apart from the steady state and names
    the device (the CPU here); StageTimer sums stages and reports each."""
    x = torch.randn(64, 12, 12, dtype=torch.float64)
    res = profiling.benchmark(torch.linalg.cholesky, x @ x.mT + 12 *
                              torch.eye(12, dtype=torch.float64),
                              name="chol", reps=5, items=64)
    assert res.reps == 5 and res.device == "cpu"
    assert res.compile_seconds > 0 and res.steady_seconds > 0
    assert res.items_per_second == pytest.approx(64 / res.steady_seconds)
    assert str(res).startswith("chol: first call")

    timer = profiling.StageTimer()
    for _ in range(2):
        with timer.stage("assembly"):
            torch.ones(10).sum()
        with timer.stage("solve"):
            torch.linalg.solve(torch.eye(3), torch.ones(3))
    assert set(timer.stages) == {"assembly", "solve"}
    lines = timer.report().splitlines()
    assert lines[0].startswith("total ") and len(lines) == 3
    assert all("%" in ln for ln in lines[1:])


def test_trace_writes_a_chrome_trace(tmp_path):
    """The profiler trace of a block lands in log_dir as a Chrome trace,
    and its key_averages name the operations run inside."""
    with profiling.trace(str(tmp_path)) as prof:
        torch.matmul(torch.ones(32, 32), torch.ones(32, 32))
    files = glob.glob(os.path.join(str(tmp_path), "trace_*.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    assert any("matmul" in e.key for e in prof.key_averages())


def test_plot_rollout_matches_jax(traces, tmp_path):
    """plot_rollout draws the same lines and gait regions as the JAX
    package's on the same trace (1e-12), and saves a PNG."""
    trace, trace_j = traces
    path = str(tmp_path / "rollout.png")
    fig = viz.plot_rollout(trace, DT, path=path)
    fig_j = jviz.plot_rollout(trace_j, DT)
    _assert_same_figure(fig, fig_j)
    assert os.path.getsize(path) > 0


def test_plot_swing_trajectory_matches_jax():
    """plot_swing_trajectory samples each leg's sextic through the port's
    sextic_track: the same 3-D points as the JAX package's (1e-12)."""
    coeffs = np.random.default_rng(8).standard_normal((4, 7, 3)) * 0.1
    fig = viz.plot_swing_trajectory(torch.as_tensor(coeffs), n_points=17)
    fig_j = jviz.plot_swing_trajectory(coeffs, n_points=17)
    _assert_same_figure(fig, fig_j)


def test_animate_rollout_writes_a_gif(traces, tmp_path):
    """A few frames of the animation to a GIF."""
    trace, _ = traces
    path = str(tmp_path / "rollout.gif")
    viz.animate_rollout(trace, DT, path, cfg=CFG, stride=8, dpi=30)
    with open(path, "rb") as f:
        assert f.read(6) in (b"GIF87a", b"GIF89a")
