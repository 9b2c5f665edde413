"""Shared inputs for the PyTorch port's parity tests (tests/test_torch_*.py).

The two packages cannot share a random stream (a ``torch.Generator`` and a
JAX key give different numbers from one seed), so every parity test makes
its inputs HERE, with NumPy from a seed, and hands the same arrays to the JAX
function and to its counterpart in the port. The distributions are those of
``utils/scenarios.py::grf_scenarios``.
"""

import numpy as np

import jax.numpy as jnp
import torch

from quadruped_control_tpu.utils import scenarios as jscen
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.utils.scenarios import (
    walk_carry_comps,
    walk_state_comps,
)

STANCE_PATTERNS = np.array(
    [[True, True, True, True],
     [True, False, False, True],
     [False, True, True, False]])

# Reference init pose feet (forward kinematics of q0 = [0, 1.61, -2.78] per
# leg with the preset link lengths), float64.
_Q0 = np.array([0.0, 1.61, -2.78])


def _standing_feet():
    l1, l2, l3 = 0.077, 0.211, 0.230
    hx, hy = 0.196, 0.050
    t1, t2, t3 = _Q0
    feet = []
    for sx, sy, sl in ((-1, 1, 1), (1, 1, 1), (-1, -1, -1), (1, -1, -1)):
        a1, a2, a3 = sl * l1, -l2, -l3
        x = a2 * np.sin(t2) + a3 * np.sin(t2 + t3) + sx * hx
        y = (a1 * np.cos(t1) - a2 * np.sin(t1) * np.cos(t2)
             - a3 * np.sin(t1) * np.cos(t2 + t3) + sy * hy)
        z = (a1 * np.sin(t1) + a2 * np.cos(t1) * np.cos(t2)
             + a3 * np.cos(t1) * np.cos(t2 + t3))
        feet.append([x, y, z])
    return np.array(feet)


def rpy_to_matrix_np(rpy):
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    return np.stack([
        np.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], -1),
        np.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], -1),
        np.stack([-sp, cp * sr, cp * cr], -1)], -2)


def numpy_scenarios(seed, batch, randomize=False, dtype=np.float64):
    """Dict of NumPy arrays with the ScenarioBatch field names; the three
    stance patterns cycle so each is covered at any batch size."""
    rng = np.random.default_rng(seed)
    d = {}
    d["R"] = rpy_to_matrix_np(rng.uniform(-0.25, 0.25, (batch, 3)))
    d["R_d"] = np.broadcast_to(np.eye(3), (batch, 3, 3)).copy()
    x = np.zeros((batch, 3))
    x[:, 2] = rng.uniform(0.08, 0.32, batch)
    d["x"] = x
    d["xdot"] = 0.3 * rng.standard_normal((batch, 3))
    d["w"] = 0.25 * rng.standard_normal((batch, 3))
    d["xdot_d"] = 0.2 * rng.standard_normal((batch, 3))
    d["w_d"] = 0.1 * rng.standard_normal((batch, 3))
    x_d = np.zeros((batch, 3))
    x_d[:, 2] = 0.26
    d["x_d"] = x_d
    d["feet"] = _standing_feet() + 0.01 * rng.standard_normal((batch, 4, 3))
    d["stance"] = STANCE_PATTERNS[np.arange(batch) % 3]
    if randomize:
        d["mass"] = 11.0 * rng.uniform(0.8, 1.2, batch)
        d["inertia_diag"] = (np.array([0.011253, 0.036203, 0.042673])
                             * rng.uniform(0.8, 1.2, (batch, 3)))
        d["mu"] = rng.uniform(0.5, 1.0, batch)
    return {k: (v if v.dtype == np.bool_ else v.astype(dtype))
            for k, v in d.items()}


def jax_scenarios(d):
    """The same arrays as a JAX ScenarioBatch."""
    return jscen.ScenarioBatch(**{
        k: (None if d.get(k) is None else jnp.asarray(d[k]))
        for k in jscen.ScenarioBatch._fields})


def torch_scenarios(d, dtype):
    """The same arrays as the port's ScenarioBatch, on the CPU."""
    return convert.scenarios_from_numpy(d, dtype=dtype, device="cpu")


def objective_np(Q, c, x):
    Q, c, x = (np.asarray(a, np.float64) for a in (Q, c, x))
    return 0.5 * np.einsum("bi,bij,bj->b", x, Q, x) + np.einsum(
        "bi,bi->b", c, x)


def t2n(a):
    return a.detach().cpu().numpy()


TORCH_DTYPES = {"f32": torch.float32, "f64": torch.float64}
NP_DTYPES = {"f32": np.float32, "f64": np.float64}


# ---------------------------------------------------------------------------
# Whole-body states and commander carries (second slice of the port): drawn
# with NumPy by the port's own generators and handed to both packages.
# ---------------------------------------------------------------------------

def jax_whole_body_state(d, dtype=jnp.float64):
    from quadruped_control_tpu.sim.plant import WholeBodyState

    return WholeBodyState(**{k: jnp.asarray(d[k], dtype)
                             for k in WholeBodyState._fields})


def torch_whole_body_state(d, dtype=torch.float64):
    return convert.whole_body_state_from_numpy(d, dtype=dtype, device="cpu")


def jax_commander_carry(c, dtype=jnp.float64):
    """commander_carry_walk dict -> the JAX package's CommanderCarry."""
    from quadruped_control_tpu.control.commander import CommanderCarry
    from quadruped_control_tpu.types import FootTrajCoeffs, PlannerState

    B = c["gait_time"].shape[0]
    return CommanderCarry(
        standing=jnp.asarray(c["standing"]),
        gait_time=jnp.asarray(c["gait_time"], dtype),
        planner=PlannerState(
            prev_in_stance=jnp.asarray(c["prev_in_stance"]),
            initialized=jnp.asarray(c["initialized"]),
            traj=FootTrajCoeffs(coeffs=jnp.asarray(c["coeffs"], dtype),
                                valid=jnp.asarray(c["valid"]))),
        qp_x=jnp.zeros((B, 12), dtype), qp_s=jnp.ones((B, 24), dtype),
        qp_z=jnp.ones((B, 24), dtype))


def torch_commander_carry(c, dtype=torch.float64):
    return convert.commander_carry_from_numpy(c, dtype=dtype, device="cpu")


def jax_com_joints(d, dtype=jnp.float64):
    """ComState / JointState of the JAX package from a walk-state dict."""
    from quadruped_control_tpu.types import ComState, JointState

    R = jnp.asarray(d["R"], dtype)
    u = jnp.asarray(d["u"], dtype)
    com = ComState(R=R, x=jnp.asarray(d["x"], dtype),
                   xdot=(R @ u[:, 3:6, None])[..., 0],
                   w=(R @ u[:, :3, None])[..., 0])
    return com, JointState(q=jnp.asarray(d["q"], dtype),
                           qdot=u[:, 6:].reshape(-1, 4, 3))


def torch_com_joints(d, dtype=torch.float64):
    from quadruped_control_tpu_torch.types import ComState, JointState

    R = torch.as_tensor(d["R"], dtype=dtype)
    u = torch.as_tensor(d["u"], dtype=dtype)
    com = ComState(R=R, x=torch.as_tensor(d["x"], dtype=dtype),
                   xdot=(R @ u[:, 3:6, None])[..., 0],
                   w=(R @ u[:, :3, None])[..., 0])
    return com, JointState(q=torch.as_tensor(d["q"], dtype=dtype),
                           qdot=u[:, 6:].reshape(-1, 4, 3))


# The kernels' (k, B) layouts of those dicts (float64 arrays).
state_comps_np = walk_state_comps
carry_comps_np = walk_carry_comps


def assert_close(got, want, tol, name="", rel_to_max=True):
    """|got - want| <= tol * (1 + max|want|) (the JAX package's own parity
    criterion, tests/test_pallas_tick.py)."""
    got = np.asarray(t2n(got) if torch.is_tensor(got) else got, np.float64)
    want = np.asarray(want, np.float64)
    scale = 1.0 + (np.abs(want).max() if want.size else 0.0)
    np.testing.assert_allclose(got, want, rtol=0.0, atol=tol * scale,
                               err_msg=name)


# ---------------------------------------------------------------------------
# MPC horizon problems (third slice of the port), float64 NumPy arrays: the
# distribution of tests/test_mpc_riccati.py (standing feet, 0.2 m/s forward
# reference, a trot schedule), optionally with per-instance robot constants.
# ---------------------------------------------------------------------------

TROT_SCHEDULE = np.array([[1, 0, 0, 1], [0, 1, 1, 0]], bool)


def mpc_problem_np(seed, batch, horizon, dt, cfg, randomize=False):
    """dict(xi0 (B, 13), xi_ref (B, N, 13), yaw (B,), feet_world (B, 4, 3),
    x_com (B, 3), stance_schedule (B, N, 4) bool[, mass, inertia_diag, mu])."""
    from quadruped_control_tpu_torch.utils.scenarios import standing_feet

    rng = np.random.default_rng(seed)
    B, N = batch, horizon
    xi0 = np.zeros((B, 13))
    xi0[:, 5] = rng.uniform(0.20, 0.30, B)
    xi0[:, 9] = 0.2 * rng.standard_normal(B)
    xi0[:, 12] = 1.0
    t = np.arange(1, N + 1) * dt
    ref = np.zeros((B, N, 13))
    ref[..., 3] = xi0[:, 3:4] + 0.2 * t
    ref[..., 5] = 0.26
    ref[..., 9] = 0.2
    ref[..., 12] = 1.0
    feet = (t2n(standing_feet(cfg, dtype=torch.float64, device="cpu"))
            + np.array([0.0, 0.0, 0.26]))
    d = dict(xi0=xi0, xi_ref=ref, yaw=0.1 * rng.standard_normal(B),
             feet_world=np.broadcast_to(feet, (B, 4, 3)).copy()
             + 0.005 * rng.standard_normal((B, 4, 3)),
             x_com=np.tile([0.0, 0.0, 0.26], (B, 1)),
             stance_schedule=np.tile(
                 TROT_SCHEDULE[np.arange(N) % 2][None], (B, 1, 1)))
    if randomize:
        d["mass"] = cfg.balance.mass * rng.uniform(0.8, 1.2, B)
        d["inertia_diag"] = (np.asarray(cfg.balance.inertia_diag)
                             * rng.uniform(0.8, 1.2, (B, 3)))
        d["mu"] = rng.uniform(0.5, 1.0, B)
    return d


MPC_ARGS = ("xi0", "xi_ref", "yaw", "feet_world", "x_com", "stance_schedule")


def mpc_args_jax(d, dtype=jnp.float64):
    return tuple(jnp.asarray(d[k]) if d[k].dtype == np.bool_
                 else jnp.asarray(d[k], dtype) for k in MPC_ARGS)


def mpc_args_torch(d, dtype=torch.float64):
    return tuple(torch.as_tensor(d[k]) if d[k].dtype == np.bool_
                 else torch.as_tensor(d[k], dtype=dtype) for k in MPC_ARGS)


def mpc_objective_np(d, F, horizon, dt, cfg_jax, lanes):
    """The condensed horizon objective 1/2 F^T H F + c^T F of each listed
    lane, float64, through the JAX package's build_mpc_qp."""
    from quadruped_control_tpu.mpc.horizon import build_mpc_qp

    sel = {k: d[k][lanes] for k in d}
    kw = {k: jnp.asarray(sel[k], jnp.float64)
          for k in ("mass", "inertia_diag", "mu") if k in sel}
    qp = build_mpc_qp(*mpc_args_jax(sel), horizon, dt, cfg_jax, **kw)
    H, c = np.asarray(qp.H), np.asarray(qp.c)
    x = np.asarray(F, np.float64)[lanes].reshape(len(lanes), -1)
    return 0.5 * np.einsum("bi,bij,bj->b", x, H, x) + np.einsum("bi,bi->b",
                                                                 c, x)


# ---------------------------------------------------------------------------
# Dense GRF QPs (fourth slice of the port: solver/fused_ipm.py), equilibrated
# by the JAX package, in both packages' layouts.
# ---------------------------------------------------------------------------

def dense_problem(seed, batch, randomize=True):
    """dict(tiles: JAX (8, 128) tiles [Q 144, c 12, G 288, h 24] (None
    unless batch is 1024), soa: the port's (k, B) float32 tensors of the same
    equilibrated problem, orig: (Q, c, G, h) float64, scale: (Dv, Er, nu)
    float64, stance)."""
    from quadruped_control_tpu.config import mit_cheetah_config
    from quadruped_control_tpu.solver.ipm import equilibrate

    d = numpy_scenarios(seed, batch, randomize=randomize, dtype=np.float32)
    qp = jscen.assemble_qp_batch(jax_scenarios(d), mit_cheetah_config())
    eq = equilibrate(qp.Q, qp.c, qp.G, qp.h)
    flat = [np.asarray(a, np.float32).reshape(batch, -1) for a in eq[:4]]
    return dict(
        tiles=([list(jnp.asarray(a.T).reshape(-1, 8, 128)) for a in flat]
               if batch == 1024 else None),
        soa=tuple(torch.from_numpy(np.ascontiguousarray(a.T)) for a in flat),
        orig=tuple(np.asarray(a, np.float64) for a in (qp.Q, qp.c, qp.G,
                                                        qp.h)),
        scale=tuple(np.asarray(a, np.float64) for a in eq[4:]),
        stance=d["stance"])


def tiles_to_torch(lst):
    """List of (8, 128) JAX tiles -> (k, 1024) torch tensor."""
    return torch.from_numpy(np.stack([np.asarray(v).reshape(-1)
                                      for v in lst]))


def dense_objective(problem, x_eq):
    """Objective of the ORIGINAL problem of ``dense_problem`` at the
    mapped-back point of an equilibrated (12, B) iterate."""
    Q, c = problem["orig"][:2]
    return objective_np(Q, c, t2n(x_eq).T.astype(np.float64)
                        * problem["scale"][0])


# ---------------------------------------------------------------------------
# SRB rollouts (fifth slice of the port): states of either package as flat
# {path: float64 array} dicts, for per-field comparison.
# ---------------------------------------------------------------------------

def tree_items(obj, prefix=""):
    """Leaves of nested NamedTuples or dicts (either package's PlantState,
    CommanderCarry, RolloutTrace, ...) as {"a.b.c": np.ndarray}; None
    leaves are left out."""
    if obj is None:
        return {}
    if hasattr(obj, "_asdict") or isinstance(obj, dict):
        out = {}
        for k, v in (obj if isinstance(obj, dict) else obj._asdict()).items():
            out.update(tree_items(v, f"{prefix}{k}."))
        return out
    a = t2n(obj) if torch.is_tensor(obj) else np.asarray(obj)
    return {prefix[:-1]: a}


def assert_trees_close(got, want, tol, what=""):
    """Every leaf of ``want`` (JAX) present in ``got`` (port) with the same
    shape; bool leaves exactly, float leaves within tol * (1 + max|want|),
    NaN where the other has NaN."""
    g, w = tree_items(got), tree_items(want)
    assert sorted(g) == sorted(w), (what, sorted(g), sorted(w))
    for k, wv in w.items():
        gv = g[k]
        assert gv.shape == wv.shape, (what, k, gv.shape, wv.shape)
        if wv.dtype == np.bool_:
            np.testing.assert_array_equal(gv, wv, err_msg=f"{what} {k}")
            continue
        wv = wv.astype(np.float64)
        scale = 1.0 + (np.nanmax(np.abs(wv)) if wv.size else 0.0)
        np.testing.assert_allclose(gv.astype(np.float64), wv, rtol=0.0,
                                   atol=tol * scale, equal_nan=True,
                                   err_msg=f"{what} {k}")
