"""Multi-process bring-up (counterpart of
``quadruped_control_tpu/parallel/distributed.py``).

One process per host (or per group of cards), joined with
``torch.distributed``. The scenario batch needs no communication: each
process solves its own slice on its own mesh (parallel/mesh.py), and the one
global quantity, the convergence fraction, is summed over the processes with
one ``all_reduce`` (``mesh.convergence_fraction``).

Usage (one process each):

    from quadruped_control_tpu_torch.parallel.distributed import initialize
    initialize("host0:29500", num_processes, process_id)   # explicit
    initialize()        # from MASTER_ADDR / MASTER_PORT / WORLD_SIZE / RANK

Nothing on the machine tells a process of a cluster: without arguments and
without those variables, ``initialize()`` is a no-op and the process runs
alone.
"""

from __future__ import annotations

import os
from typing import Optional

import torch.distributed as dist

from quadruped_control_tpu_torch import resolve_device

_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the multi-process job (idempotent).

    With explicit arguments, ``init_process_group(init_method=
    "tcp://<coordinator_address>", world_size=num_processes,
    rank=process_id)``; failures raise (a half-joined job must not limp
    on). With none, joins through ``env://`` when ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` are set (``MASTER_PORT`` too, or it raises),
    and is a no-op when they are not: the single-process run.

    The backend follows the device the collectives will see: ``nccl`` for
    CUDA tensors (``device=None`` means ``cuda``, as everywhere in the port),
    ``gloo`` for ``device="cpu"``.
    """
    if _is_initialized():
        return
    explicit = (coordinator_address, num_processes, process_id)
    if all(a is None for a in explicit):
        if not all(k in os.environ for k in _ENV):
            return
        dist.init_process_group(backend=_backend(device), init_method="env://")
        return
    if any(a is None for a in explicit):
        raise ValueError("initialize: give coordinator_address, "
                         "num_processes and process_id together")
    dist.init_process_group(backend=_backend(device),
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def _backend(device) -> str:
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def _is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def is_primary() -> bool:
    """True on the process that should write checkpoints / logs."""
    return not _is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    """Processes in the job (1 when not initialised)."""
    return dist.get_world_size() if _is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 when not initialised)."""
    return dist.get_rank() if _is_initialized() else 0
