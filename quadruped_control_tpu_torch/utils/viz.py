"""Offline visualization: the rviz / MarkerArray equivalent (counterpart of
``quadruped_control_tpu/utils/viz.py``).

The reference draws foot trajectories and TF frames live in rviz
(commander_node.cpp:75-126, gait_visualizer_node.cpp:51-101). The port runs
headless; this module renders the same artifacts — swing-foot trajectories,
CoM track, gait diagram, an animation — from the port's rollout traces
(``control.rollout.RolloutTrace``, on any device) to matplotlib figures.

matplotlib is imported inside each function, so the package never depends
on it. The machine with the card has no matplotlib: no path that runs there
imports this module's functions; render traces copied to a host that has it.
"""

from __future__ import annotations

import numpy as np
import torch

from quadruped_control_tpu_torch.config import LEG_NAMES, KinematicsConfig
from quadruped_control_tpu_torch.ops.trajectory import sextic_track

_LEG_COLORS = ("tab:blue", "tab:red", "tab:red", "tab:blue")  # diag pairs


def _np(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_rollout(trace, dt, path=None):
    """CoM track + height + gait diagram from a RolloutTrace (single
    scenario). Returns the figure; saves to ``path`` if given."""
    plt = _pyplot()
    x = _np(trace.x)
    stance = _np(trace.in_stance)
    t = np.arange(x.shape[0]) * dt

    fig, axes = plt.subplots(3, 1, figsize=(9, 9), sharex=False)
    ax = axes[0]
    ax.plot(x[:, 0], x[:, 1], lw=1.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title("CoM ground track")
    ax.axis("equal")

    ax = axes[1]
    ax.plot(t, x[:, 2], lw=1.2)
    ax.axhline(0.26, color="gray", ls="--", lw=0.8, label="stand target")
    ax.set_xlabel("t [s]")
    ax.set_ylabel("z [m]")
    ax.set_title("CoM height")
    ax.legend()

    ax = axes[2]
    for leg in range(4):
        in_st = stance[:, leg].astype(float)
        ax.fill_between(t, leg + 0.1, leg + 0.9, where=in_st > 0.5,
                        color=_LEG_COLORS[leg], alpha=0.6, linewidth=0)
    ax.set_yticks([l + 0.5 for l in range(4)], LEG_NAMES)
    ax.set_xlabel("t [s]")
    ax.set_title("gait diagram (filled = stance)")

    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig


def animate_rollout(trace, dt, path, cfg=None, stride: int = 3,
                    trail: int = 150, elev: float = 18.0,
                    azim: float = -65.0, dpi: int = 80):
    """Animated closed-loop rollout (single scenario), the headless
    equivalent of the reference's rviz demo GIFs.

    Draws per frame: the base rectangle (hip positions under the traced
    orientation), hip->foot leg segments, feet colored by stance (filled =
    stance, hollow = swing), the CoM ground trail and the clock. Needs
    ``trace.feet`` and ``trace.R`` (recorded by control/rollout.rollout and
    sim/rollout.rollout_whole_body).

    Args:
      trace: RolloutTrace with feet / R populated (batch-free).
      dt: control period (1 / cfg.frequency).
      path: output file; .gif uses the pillow writer.
      stride: animate every ``stride``-th tick (fps = 1 / (dt * stride)).
    Returns the matplotlib animation object (already saved to ``path``).
    """
    plt = _pyplot()
    import matplotlib.animation as manim

    kin = cfg.kinematics if cfg is not None else KinematicsConfig()
    hips = kin.hip_offsets_np()  # (4, 3) [RL, FL, RR, FR]
    # Base outline in drawing order FL -> FR -> RL -> RR -> FL.
    order = [1, 3, 0, 2, 1]

    x = _np(trace.x)
    feet = _np(trace.feet)
    R = _np(trace.R)
    stance = _np(trace.in_stance)
    T = x.shape[0]
    frames = range(0, T, max(int(stride), 1))

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.view_init(elev=elev, azim=azim)

    span = 0.45
    body_ln, = ax.plot([], [], [], "-", color="k", lw=2)
    legs = [ax.plot([], [], [], "-", color=_LEG_COLORS[leg], lw=1.5)[0]
            for leg in range(4)]
    feet_st = ax.plot([], [], [], "o", color="k", ms=5)[0]
    feet_sw = ax.plot([], [], [], "o", mfc="none", mec="gray", ms=5)[0]
    trail_ln, = ax.plot([], [], [], "-", color="tab:green", lw=1.0,
                        alpha=0.8)
    title = ax.set_title("")

    def draw(t):
        hips_w = (R[t] @ hips.T).T + x[t]  # (4, 3)
        body_ln.set_data(hips_w[order, 0], hips_w[order, 1])
        body_ln.set_3d_properties(hips_w[order, 2])
        for leg in range(4):
            seg = np.stack([hips_w[leg], feet[t, leg]])
            legs[leg].set_data(seg[:, 0], seg[:, 1])
            legs[leg].set_3d_properties(seg[:, 2])
        st = stance[t] > 0.5
        feet_st.set_data(feet[t, st, 0], feet[t, st, 1])
        feet_st.set_3d_properties(feet[t, st, 2])
        feet_sw.set_data(feet[t, ~st, 0], feet[t, ~st, 1])
        feet_sw.set_3d_properties(feet[t, ~st, 2])
        lo = max(0, t - trail)
        trail_ln.set_data(x[lo:t + 1, 0], x[lo:t + 1, 1])
        trail_ln.set_3d_properties(np.zeros(t + 1 - lo))
        cx, cy = x[t, 0], x[t, 1]
        ax.set_xlim(cx - span, cx + span)
        ax.set_ylim(cy - span, cy + span)
        ax.set_zlim(0.0, 2 * span * 0.75)
        title.set_text(f"t = {t * dt:.2f} s")
        return [body_ln, *legs, feet_st, feet_sw, trail_ln]

    anim = manim.FuncAnimation(fig, draw, frames=frames, blit=False)
    fps = max(int(round(1.0 / (dt * max(int(stride), 1)))), 1)
    anim.save(path, writer=manim.PillowWriter(fps=fps), dpi=dpi)
    plt.close(fig)
    return anim


def plot_swing_trajectory(coeffs, n_points: int = 30, path=None):
    """Sample a (4, 7, 3) coefficient set like footTrajViz
    (commander_node.cpp:75-126): ``n_points`` spheres along each swing,
    through the port's ``ops.trajectory.sextic_track`` in float64 on the
    CPU."""
    plt = _pyplot()
    coeffs = torch.as_tensor(_np(coeffs), dtype=torch.float64)
    ts = torch.as_tensor(np.linspace(0.0, 1.0, n_points))
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    for leg in range(4):
        pts = sextic_track(coeffs[leg], ts).position.numpy()
        ax.plot(pts[:, 0], pts[:, 1], pts[:, 2], "o-", ms=2,
                color=_LEG_COLORS[leg], label=LEG_NAMES[leg])
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlabel("z [m]")
    ax.legend()
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=110)
    return fig
