"""State carried across from the JAX package, as NumPy arrays and plain dicts.

The system has no learned weights; what both packages must share is
configuration and state. Everything here takes and gives NumPy arrays /
plain Python containers (a caller holding JAX objects converts them with
``dataclasses.asdict`` / ``np.asarray`` first — this package never sees a JAX
type). Layouts are the JAX package's: ``(B, 4, 3)`` levers and feet, leg
order ``[RL, FL, RR, FR]``, solution fields ``(B, 12)`` / ``(B, 24)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from quadruped_control_tpu_torch import config as _config
from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.control.commander import CommanderCarry
from quadruped_control_tpu_torch.control.plant import PlantState
from quadruped_control_tpu_torch.sim.model import WholeBodyModel
from quadruped_control_tpu_torch.sim.plant import ContactConfig, WholeBodyState
from quadruped_control_tpu_torch.solver.ipm import IPMSolution
from quadruped_control_tpu_torch.types import (
    ComState,
    FootTrajCoeffs,
    JointState,
    PlannerState,
)
from quadruped_control_tpu_torch.utils.scenarios import ScenarioBatch


def _dataclass_from_dict(cls, d):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        sub = getattr(_config, type(f.default).__name__, None) \
            if dataclasses.is_dataclass(f.default) else None
        if sub is not None and isinstance(v, dict):
            v = _dataclass_from_dict(sub, v)
        elif isinstance(v, (list, tuple, np.ndarray)):
            v = tuple(float(e) for e in v)
        kwargs[f.name] = v
    unknown = set(d) - {f.name for f in dataclasses.fields(cls)}
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    return cls(**kwargs)


def config_from_dict(d: dict) -> _config.ControlConfig:
    """``dataclasses.asdict(cfg)`` of either package -> ControlConfig."""
    return _dataclass_from_dict(_config.ControlConfig, d)


def config_to_dict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def _flag(a, device):
    """A bool array of any rank, 0-d included (``np.ascontiguousarray``
    would make a 0-d array 1-d)."""
    return torch.from_numpy(np.array(a, dtype=np.bool_)).to(device)


def _tensor(a, dtype, device):
    if a is None:
        return None
    a = np.asarray(a)
    if a.dtype == np.bool_:
        return _flag(a, device)
    return torch.as_tensor(np.array(a), dtype=dtype).to(device)


def scenarios_from_numpy(d: dict, dtype=torch.float32,
                         device=None) -> ScenarioBatch:
    """Dict of NumPy arrays (the ScenarioBatch field names; ``mass``,
    ``inertia_diag``, ``mu`` optional) -> ScenarioBatch on ``device``."""
    device = resolve_device(device)
    required = ScenarioBatch._fields[:10]
    missing = [k for k in required if k not in d]
    if missing:
        raise ValueError(f"scenarios_from_numpy: missing fields {missing}")
    vals = {k: _tensor(d.get(k), dtype, device)
            for k in ScenarioBatch._fields}
    vals["stance"] = vals["stance"].bool()
    return ScenarioBatch(**vals)


def solution_from_numpy(d: dict, dtype=torch.float32,
                        device=None) -> IPMSolution:
    """Dict of NumPy arrays (the IPMSolution field names) -> IPMSolution."""
    device = resolve_device(device)
    vals = {k: _tensor(d[k], dtype, device) for k in IPMSolution._fields
            if k not in ("iterations", "converged")}
    return IPMSolution(
        iterations=torch.as_tensor(int(np.asarray(d["iterations"]))),
        converged=_flag(d["converged"], device),
        **vals)


def warm_carry_from_numpy(x, s, z, st_prev: Optional[np.ndarray] = None,
                          dtype=torch.float32, device=None):
    """The warm carry of the fused solve, ``(x (B,12), s (B,24), z (B,24))``
    in original units plus the stance mask ``st_prev (B,4)`` it was solved
    under (float; -1 marks "no previous tick": every row resets cold).
    Returns tensors ``(x, s, z, st_prev)`` on ``device``; pass the first
    three as ``warm=`` and the last as ``warm_stance_prev=``."""
    device = resolve_device(device)
    x, s, z = (_tensor(a, dtype, device) for a in (x, s, z))
    if st_prev is None:
        st = -torch.ones((x.shape[0], 4), dtype=dtype, device=device)
    else:
        st = torch.as_tensor(np.asarray(st_prev, dtype=np.float64),
                             dtype=dtype).to(device)
    return x, s, z, st


def _as_dict(obj):
    """A dict, or anything with ``_asdict`` (a NamedTuple of either package,
    converted leaf by leaf with ``np.asarray`` by the caller or here)."""
    return dict(obj) if isinstance(obj, dict) else obj._asdict()


def whole_body_model_from_numpy(d, dtype=torch.float32,
                                device=None) -> WholeBodyModel:
    """The WholeBodyModel field names as NumPy arrays (a dict, or the JAX
    package's model itself: its leaves go through ``np.asarray``) ->
    WholeBodyModel on ``device``."""
    device = resolve_device(device)
    d = _as_dict(d)
    missing = [k for k in WholeBodyModel._fields if k not in d]
    if missing:
        raise ValueError(f"whole_body_model_from_numpy: missing {missing}")
    return WholeBodyModel(**{k: _tensor(d[k], dtype, device)
                             for k in WholeBodyModel._fields})


def whole_body_state_from_numpy(d, dtype=torch.float32,
                                device=None) -> WholeBodyState:
    """The WholeBodyState field names (R, x, u, q, anchor) as NumPy arrays
    -> WholeBodyState on ``device``."""
    device = resolve_device(device)
    d = _as_dict(d)
    missing = [k for k in WholeBodyState._fields if k not in d]
    if missing:
        raise ValueError(f"whole_body_state_from_numpy: missing {missing}")
    return WholeBodyState(**{k: _tensor(d[k], dtype, device)
                             for k in WholeBodyState._fields})


def commander_carry_from_numpy(d, dtype=torch.float32,
                               device=None) -> CommanderCarry:
    """A commander carry as NumPy arrays -> CommanderCarry on ``device``.
    ``d`` is nested like the NamedTuples (``planner`` -> ``traj``) or flat
    (``prev_in_stance``, ``initialized``, ``coeffs``, ``valid`` at the top).
    The QP warm-start triple defaults to the cold carry (0, 1, 1);
    ``ref_pose`` / ``pose_cmd`` default to None."""
    device = resolve_device(device)
    d = _as_dict(d)
    if "planner" in d:
        pl = _as_dict(d["planner"])
        traj = _as_dict(pl["traj"])
    else:
        pl, traj = d, d

    gait_time = _tensor(d["gait_time"], dtype, device)
    batch = tuple(gait_time.shape)
    kw = dict(dtype=dtype, device=device)

    def opt(name, default):
        return default if d.get(name) is None else _tensor(d[name], dtype,
                                                           device)

    return CommanderCarry(
        standing=_flag(d["standing"], device), gait_time=gait_time,
        planner=PlannerState(
            prev_in_stance=_flag(pl["prev_in_stance"], device),
            initialized=_flag(pl["initialized"], device),
            traj=FootTrajCoeffs(coeffs=_tensor(traj["coeffs"], dtype, device),
                                valid=_flag(traj["valid"], device))),
        qp_x=opt("qp_x", torch.zeros(batch + (12,), **kw)),
        qp_s=opt("qp_s", torch.ones(batch + (24,), **kw)),
        qp_z=opt("qp_z", torch.ones(batch + (24,), **kw)),
        ref_pose=opt("ref_pose", None), pose_cmd=opt("pose_cmd", None))


def plant_state_from_numpy(d, dtype=torch.float32,
                           device=None) -> PlantState:
    """An SRB plant state as NumPy arrays -> PlantState on ``device``.
    ``d`` is nested like the NamedTuples (``com`` -> R, x, xdot, w;
    ``feet_world``; ``joints`` -> q, qdot): a dict, or the JAX package's
    PlantState itself (its leaves go through ``np.asarray``)."""
    device = resolve_device(device)
    d = _as_dict(d)
    com, joints = _as_dict(d["com"]), _as_dict(d["joints"])
    return PlantState(
        com=ComState(**{k: _tensor(com[k], dtype, device)
                        for k in ComState._fields}),
        feet_world=_tensor(d["feet_world"], dtype, device),
        joints=JointState(**{k: _tensor(joints[k], dtype, device)
                             for k in JointState._fields}))


def rollout_trace_to_numpy(trace) -> dict:
    """A RolloutTrace of either package (time on the leading axis) -> dict
    of NumPy arrays by field name; a field that is None stays None."""
    return {k: None if v is None else np.asarray(to_numpy(v))
            for k, v in _as_dict(trace).items()}


def contact_config_from_dict(d: dict) -> ContactConfig:
    """``dataclasses.asdict(contact)`` of either package -> ContactConfig."""
    return _dataclass_from_dict(ContactConfig, d)


def to_numpy(obj):
    """Inverse direction: a tensor, a NamedTuple of tensors (ScenarioBatch,
    IPMSolution, QPData, WholeBodyModel, WholeBodyState, CommanderCarry with
    its nested planner state), a tuple/list/dict of them, or a config
    dataclass (ControlConfig, ContactConfig) -> NumPy arrays / plain dicts
    (None stays None)."""
    if obj is None:
        return None
    if torch.is_tensor(obj):
        return obj.detach().cpu().numpy()
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.asdict(obj)
    if hasattr(obj, "_asdict"):
        return {k: to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return type(obj)(to_numpy(v) for v in obj)
    return obj


# ---------------------------------------------------------------------------
# MPC inputs, warm carry and precursor block. The JAX package keeps per-
# instance arrays (B, N, 13) / (B, N, 4) / (B, N, 12) and, inside its fused
# tick, tiles (nb, k, rows, 128); the port keeps (k, B).
# ---------------------------------------------------------------------------

def tiles_to_comps(a, dtype=torch.float32, device=None) -> torch.Tensor:
    """The JAX package's packed tiles (nb, k, rows, 128) -> (k, nb*rows*128)
    on ``device`` (a padded batch stays padded)."""
    a = np.asarray(a)
    nb, k, rows, lane = a.shape
    flat = a.transpose(1, 0, 2, 3).reshape(k, nb * rows * lane)
    return _tensor(np.ascontiguousarray(flat), dtype, resolve_device(device))


def comps_to_tiles(a, rows: int = 8) -> np.ndarray:
    """(k, B) -> the JAX package's tiles (nb, k, rows, 128); B is padded with
    zeros to a multiple of rows*128."""
    a = np.asarray(to_numpy(a) if torch.is_tensor(a) else a)
    k, B = a.shape
    tile = rows * 128
    Bp = -(-B // tile) * tile
    if Bp != B:
        a = np.concatenate([a, np.zeros((k, Bp - B), a.dtype)], axis=1)
    return np.ascontiguousarray(
        a.reshape(k, Bp // tile, rows, 128).transpose(1, 0, 2, 3))


def mpc_block_from_numpy(xi0, r_levers, stance_schedule, xi_ref,
                         dtype=torch.float32, device=None) -> torch.Tensor:
    """Per-instance MPC inputs — xi0 (B, 13), levers (B, 4, 3), stance
    schedule (B, N, 4), reference (B, N, 13) — -> the (25 + 17N, B) MPC
    precursor block (the commander-pre kernel's output, the MPC kernel's
    packed input)."""
    xi0 = np.asarray(xi0)
    B = xi0.shape[0]
    flat = np.concatenate(
        [xi0, np.asarray(r_levers).reshape(B, 12),
         np.asarray(stance_schedule, np.float64).reshape(B, -1),
         np.asarray(xi_ref).reshape(B, -1)], axis=-1)
    return _tensor(np.ascontiguousarray(flat.T), dtype,
                   resolve_device(device))


def mpc_block_to_numpy(block, horizon: int) -> dict:
    """(25 + 17N, B) MPC block -> dict(xi0 (B, 13), r_levers (B, 4, 3),
    stance_schedule (B, N, 4) bool, xi_ref (B, N, 13))."""
    a = np.asarray(to_numpy(block)).T
    B, N = a.shape[0], int(horizon)
    return dict(xi0=a[:, 0:13], r_levers=a[:, 13:25].reshape(B, 4, 3),
                stance_schedule=a[:, 25:25 + 4 * N].reshape(B, N, 4) > 0.5,
                xi_ref=a[:, 25 + 4 * N:].reshape(B, N, 13))


def mpc_warm_from_numpy(F, s, z, stance_schedule=None, dtype=torch.float32,
                        device=None):
    """The MPC warm carry in the JAX package's per-instance layout — F (B,
    N, 12) Newtons, s and z (B, 24N) or (B, N, 24) in original units, the
    schedule (B, N, 4) they were solved against (None: -1, every row resets
    cold) — -> the fused tick's ``(F_p (12N, B), sz_p (48N, B), sched_p
    (4N, B))``."""
    F = np.asarray(F, np.float64)
    B = F.shape[0]
    s = np.asarray(s, np.float64).reshape(B, -1)
    z = np.asarray(z, np.float64).reshape(B, -1)
    if stance_schedule is None:
        sched = -np.ones((B, F.reshape(B, -1).shape[1] // 3))
    else:
        sched = np.asarray(stance_schedule, np.float64).reshape(B, -1)
    device = resolve_device(device)
    return tuple(_tensor(np.ascontiguousarray(a.T), dtype, device)
                 for a in (F.reshape(B, -1), np.concatenate([s, z], -1),
                           sched))


def mpc_warm_to_numpy(warm_p, horizon: int) -> dict:
    """Inverse of :func:`mpc_warm_from_numpy`: dict(F (B, N, 12), s (B,
    24N), z (B, 24N), stance_schedule (B, N, 4) float, -1 = none)."""
    F, sz, sched = (np.asarray(to_numpy(a)).T for a in warm_p)
    B, N = F.shape[0], int(horizon)
    return dict(F=F.reshape(B, N, 12), s=sz[:, :24 * N], z=sz[:, 24 * N:],
                stance_schedule=sched.reshape(B, N, 4))
