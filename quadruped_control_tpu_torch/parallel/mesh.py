"""Scenario-axis data parallelism over devices (counterpart of
``quadruped_control_tpu/parallel/mesh.py``).

The only parallel dimension of this system is the batch of independent
scenarios (robots, QP instances): every kernel treats each instance on its
own, and no computation crosses instances. The JAX package splits that axis
over a 1-D device mesh with GSPMD and ``shard_map``. PyTorch has neither,
so here:

  - a mesh is an ordered list of ``torch.device`` (:func:`scenario_mesh`;
    by default ``cuda:0 ... cuda:{device_count - 1}``). A mesh may name one
    device several times (``[cuda:0] * 4``, ``[cpu] * 8``): each entry is
    one shard all the same, which lets one card, or the CPU, exercise the
    split and the concatenation;
  - a sharding (:class:`BatchSharding`) splits the leading axis of every
    tensor of a tree (NamedTuples, tuples, lists, dicts; ``None`` and
    non-tensor leaves pass through) into contiguous chunks, one per mesh
    entry, each placed on its entry's device;
  - :func:`map_shards` is ``shard_map``: it runs a function on each shard
    under ``torch.cuda.device(d)``, one shard after the other from this
    thread (CUDA launches are asynchronous, so the cards of a mesh overlap
    as far as the host keeps ahead of them), and concatenates the results
    in mesh order on the mesh's first device. Every ``shard_*`` function
    here is built on it;
  - the one cross-scenario quantity, the global convergence fraction, is a
    count: (converged, instances) summed over the shards and, when
    ``torch.distributed`` is initialised (parallel/distributed.py), over
    every process with one ``all_reduce``.

A mesh that names ``cuda`` on a machine without a card raises; nothing runs
elsewhere instead.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch

from quadruped_control_tpu_torch import resolve_device
from quadruped_control_tpu_torch.config import ControlConfig, mit_cheetah_config
from quadruped_control_tpu_torch.parallel.distributed import _is_initialized
from quadruped_control_tpu_torch.solver.ipm import solve_qp_ipm
from quadruped_control_tpu_torch.utils.scenarios import (
    ScenarioBatch,
    assemble_qp_batch,
)

# ---------------------------------------------------------------------------
# Trees of tensors
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, *trees):
    """``fn`` over the tensor leaves of matching trees (NamedTuples, tuples,
    lists, dicts). A leaf that is not a tensor in the first tree (``None``,
    a number) is taken from the first tree as it is."""
    first = trees[0]
    if torch.is_tensor(first):
        return fn(*trees)
    if _is_namedtuple(first):
        return type(first)(*(tree_map(fn, *parts) for parts in zip(*trees)))
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *parts) for parts in zip(*trees))
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    return first


def tree_leaves(tree) -> List[torch.Tensor]:
    """The tensor leaves of ``tree`` in :func:`tree_map`'s order."""
    out = []
    tree_map(lambda a: out.append(a), tree)
    return out


def to_device(tree, device):
    """``tree`` with every tensor on ``device`` (the rest as it is)."""
    device = torch.device(device)
    return tree_map(lambda a: a.to(device), tree)


# ---------------------------------------------------------------------------
# Mesh and sharding
# ---------------------------------------------------------------------------

def _mesh_device(d) -> torch.device:
    dev = resolve_device(d)
    if dev.type == "cuda":
        index = torch.cuda.current_device() if dev.index is None else dev.index
        if not 0 <= index < torch.cuda.device_count():
            raise ValueError(f"mesh names {dev}, but this machine has "
                             f"{torch.cuda.device_count()} CUDA device(s)")
        dev = torch.device("cuda", index)
    return dev


def scenario_mesh(devices: Optional[Sequence] = None) -> List[torch.device]:
    """1-D mesh over every CUDA device (``None``) or the given devices, in
    order. Entries may repeat a device. Raises when it names ``cuda`` on a
    machine without a card."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = [_mesh_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


class BatchSharding(NamedTuple):
    """Shard the leading (scenario) axis over ``devices``; everything
    trailing stays whole (JAX's ``NamedSharding(mesh, P("scenario"))``)."""

    devices: tuple

    def bounds(self, batch: int) -> List[tuple]:
        """Contiguous [start, stop) of each shard over ``batch`` instances:
        sizes differ by at most one, the larger first."""
        n = len(self.devices)
        if batch < n:
            raise ValueError(f"batch of {batch} instances over a mesh of {n}")
        q, r = divmod(batch, n)
        out, start = [], 0
        for k in range(n):
            stop = start + q + (1 if k < r else 0)
            out.append((start, stop))
            start = stop
        return out

    def split(self, tree) -> List[Any]:
        """``tree`` cut into one tree per device (the leading axis of every
        tensor leaf, which must be the same for all of them)."""
        leaves = tree_leaves(tree)
        sizes = {int(a.shape[0]) if a.dim() else None for a in leaves}
        if len(sizes) != 1 or None in sizes:
            raise ValueError("every tensor of a sharded tree needs the same "
                             f"leading (scenario) axis; got sizes {sizes}")
        bounds = self.bounds(sizes.pop())
        return [tree_map(lambda a, lo=lo, hi=hi, d=d: a[lo:hi].to(d), tree)
                for (lo, hi), d in zip(bounds, self.devices)]


class Sharded(NamedTuple):
    """A tree split by a :class:`BatchSharding`: ``shards[k]`` lives on
    ``sharding.devices[k]``."""

    shards: list
    sharding: BatchSharding


def batch_sharding(mesh: Sequence) -> BatchSharding:
    """Shard the leading (scenario) axis; replicate everything trailing."""
    return BatchSharding(tuple(scenario_mesh(mesh)))


def shard_scenarios(s: ScenarioBatch, mesh: Sequence) -> Sharded:
    """Place a scenario batch with its leading axis split over the mesh."""
    sharding = batch_sharding(mesh)
    return Sharded(sharding.split(s), sharding)


def _on(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _concat_shards(outs: Sequence, device, axis: int = 0):
    """Concatenate per-shard result trees along ``axis`` on ``device``."""
    device = torch.device(device)
    return tree_map(lambda *parts: torch.cat([p.to(device) for p in parts],
                                             dim=axis), *outs)


def map_shards(mesh: Sequence, fn: Callable, *args, out_axis: int = 0):
    """``shard_map`` over the scenario axis: split every argument tree
    (or take the shards of a :class:`Sharded` one), run ``fn`` on each
    shard under its device, concatenate the results along ``out_axis``
    (the batch axis of the outputs: 1 for a trace with time leading) in mesh
    order on the mesh's first device. ``fn`` sees only its shard, as a
    ``shard_map``'d function does; no collective runs here."""
    sharding = batch_sharding(mesh)
    per_arg = []
    for a in args:
        if isinstance(a, Sharded):
            if a.sharding != sharding:
                raise ValueError("argument sharded over another mesh")
            per_arg.append(a.shards)
        else:
            per_arg.append(sharding.split(a))
    outs = []
    for k, dev in enumerate(sharding.devices):
        with _on(dev):
            outs.append(fn(*(shards[k] for shards in per_arg)))
    return _concat_shards(outs, sharding.devices[0], axis=out_axis)


def convergence_fraction(converged: torch.Tensor, dtype=torch.float32):
    """Mean of a converged mask over every instance of the job: (count,
    instances) of this process, summed over all processes with one
    ``all_reduce`` when ``torch.distributed`` is initialised. The division
    is made in float64 and cast to ``dtype``, so that a sharded and an
    unsharded count give the same bits."""
    counts = torch.stack([
        converged.sum(dtype=torch.float64),
        torch.tensor(float(converged.numel()), dtype=torch.float64,
                     device=converged.device)])
    if _is_initialized():
        torch.distributed.all_reduce(counts)
    return (counts[0] / counts[1]).to(dtype)


# ---------------------------------------------------------------------------
# Sharded solves and rollouts
# ---------------------------------------------------------------------------

def solve_scenarios_sharded(s, cfg: ControlConfig = None,
                            iterations: int = 15, polish: bool = True,
                            tol: float = 3e-5):
    """Assemble + solve a scenario batch, sharded (``s`` from
    :func:`shard_scenarios`: each shard on its device) or not (a
    ScenarioBatch, solved where it lies).

    The solve is the plain batched IPM (solver/ipm.py::solve_qp_ipm), as in
    the JAX function; no kernel. Returns (x, converged, fraction): x and
    converged of every instance in mesh order on the mesh's first device;
    the fraction is the global mean of converged (:func:`convergence_
    fraction`: over every process when ``torch.distributed`` is
    initialised), in the problem's dtype."""
    cfg = cfg or mit_cheetah_config()

    def solve(shard):
        qp = assemble_qp_batch(shard, cfg)
        sol = solve_qp_ipm(qp.Q, qp.c, qp.G, qp.h, iterations=iterations,
                           polish=polish, tol=tol)
        return sol.x, sol.converged

    if isinstance(s, Sharded):
        x, conv = map_shards(s.sharding.devices, solve, s)
    else:
        x, conv = solve(s)
    return x, conv, convergence_fraction(conv, x.dtype)


def shard_rollout_whole_body(mesh: Sequence, cfg, model, contact=None,
                             stepper=None, **static_kw):
    """Scenario-sharded full-physics closed loop.

    Returns ``run(plant, carry, cmd_twist, steps)`` that executes
    ``sim.rollout.rollout_whole_body`` on each shard of the batch (every
    argument carries the full batch; ``cmd_twist`` too). ``stepper``:
    ``None`` (the plain substeps) or ``make_fused_stepper(model, cfg,
    contact)`` (the substep kernel K5 on CUDA shards); the stepper holds its
    constants as host floats and serves every device. The model's tensors
    are copied once per distinct device of the mesh, here. ``record`` is
    forced off, as in the JAX function; any other rollout keyword goes in
    ``static_kw``.
    """
    from quadruped_control_tpu_torch.sim.plant import ContactConfig
    from quadruped_control_tpu_torch.sim.rollout import rollout_whole_body

    contact = contact or ContactConfig()
    mesh = scenario_mesh(mesh)
    models = {d: to_device(model, d) for d in dict.fromkeys(mesh)}

    def run(plant, carry, cmd_twist, steps: int):
        def local(p, c, cmd):
            return rollout_whole_body(
                p, c, cmd, steps, cfg, models[p.x.device], contact,
                record=False, stepper=stepper, **static_kw)

        return map_shards(mesh, local, plant, carry, cmd_twist)

    return run


def shard_rollout_whole_body_fused(mesh: Sequence, tick, n_substeps: int = 10,
                                   mpc_every: int | None = None):
    """Scenario-sharded fused closed loop (sim/fused_tick.py).

    Returns ``run(plant, carry, cmd_twist, steps)``. Each shard runs the
    three-kernel tick on its device: K4 -> K1 -> K5 for the balance tick,
    K4 -> K6 -> K5 for the MPC tick; with ``mpc_every`` and a
    ``controller="mpc"`` tick, the DECIMATED rollout
    (``rollout_whole_body_fused_decimated``: K6 every ``mpc_every`` ticks,
    its forces held between). Every instance is independent in every
    kernel, so a shard's result is bitwise that instance's unsharded
    result, and a tick launches ``len(mesh)`` times what it launches
    unsharded. The tick holds its constants as host floats (the kernels
    take them by value), so one tick serves every device; nothing is
    copied per tick. ``cmd_twist`` carries the full batch shape (it is
    sharded too). ``record`` is off; the result's ``warm`` is None.
    """
    from quadruped_control_tpu_torch.sim.fused_tick import (
        rollout_whole_body_fused,
        rollout_whole_body_fused_decimated,
    )

    mesh = scenario_mesh(mesh)

    def run(plant, carry, cmd_twist, steps: int):
        def local(p, c, cmd):
            if mpc_every is not None:
                res = rollout_whole_body_fused_decimated(
                    p, c, cmd, steps, tick, mpc_every=mpc_every,
                    n_substeps=n_substeps, record=False)
            else:
                res = rollout_whole_body_fused(p, c, cmd, steps, tick,
                                               n_substeps=n_substeps,
                                               record=False)
            return res._replace(warm=None)

        return map_shards(mesh, local, plant, carry, cmd_twist)

    return run
