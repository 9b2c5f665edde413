"""Checkpoint / resume for long batched sweeps and rollouts (counterpart of
``quadruped_control_tpu/utils/checkpoint.py``).

The reference has no checkpointing: all state is in RAM and recovery is
"relaunch + call the /start_position reset service" (SURVEY.md §5). A sweep
of hours must resume mid-way instead. This module saves the state trees of
the port (NamedTuple carries, plant states, warm carries: any tree of
tensors, see ``parallel.mesh.tree_map``) at a step, finds the latest
complete step, restores it shaped like a given tree, and drives a chunked
loop that resumes from it.

Format: one file ``step_{step:012d}.pt`` per step, a dict ``leaf_0000,
leaf_0001, ...`` of the tree's tensor leaves on the CPU written with
``torch.save``. It is written to a temporary name and ``os.replace``d into
place, so a file with the final name is complete. The tree's structure is
not stored: restore takes it from the caller's ``like`` tree, and casts each
leaf to the dtype, shape AND device of ``like``'s leaf. Loading uses
``torch.load(weights_only=True)``: tensors only, no arbitrary objects.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch

from quadruped_control_tpu_torch.parallel.mesh import tree_leaves, tree_map

_PREFIX = "step_"
_SUFFIX = ".pt"


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"{_PREFIX}{step:012d}{_SUFFIX}")


def save_checkpoint(directory: str, state: Any, step: int) -> str:
    """Save ``state`` (any tree of tensors) at ``step``. Returns the path."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    named = {f"leaf_{i:04d}": leaf.detach().cpu()
             for i, leaf in enumerate(tree_leaves(state))}
    path = _path(directory, step)
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(named, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> int | None:
    """Largest complete checkpoint step in ``directory`` (None if none)."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if not (name.startswith(_PREFIX) and name.endswith(_SUFFIX)):
            continue  # other files, and saves not yet renamed into place
        try:
            steps.append(int(name[len(_PREFIX):-len(_SUFFIX)]))
        except ValueError:
            continue
    return max(steps) if steps else None


def restore_checkpoint(directory: str, like: Any, step: int | None = None):
    """Restore the checkpoint at ``step`` (default: latest) shaped like the
    tree ``like``: each leaf takes the dtype, shape and device of ``like``'s
    leaf. Returns (state, step)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    named = torch.load(_path(directory, step), map_location="cpu",
                       weights_only=True)
    leaves = iter(named[f"leaf_{i:04d}"]
                  for i in range(len(tree_leaves(like))))

    def restore(ref):
        return next(leaves).to(dtype=ref.dtype).reshape(ref.shape).to(
            ref.device)

    return tree_map(restore, like), step


def run_checkpointed(step_fn: Callable[[Any, int], Any], state: Any,
                     n_chunks: int, directory: str, save_every: int = 1):
    """Drive ``state = step_fn(state, chunk_index)`` for ``n_chunks``,
    checkpointing every ``save_every`` chunks (and after the last) and
    RESUMING from the latest checkpoint if ``directory`` already holds one.

    ``step_fn`` is typically a chunk of rollout (e.g. 50 control ticks).
    Returns the final state."""
    start = 0
    existing = latest_step(directory)
    if existing is not None:
        state, start = restore_checkpoint(directory, state, existing)
    for chunk in range(start, n_chunks):
        state = step_fn(state, chunk)
        if (chunk + 1) % save_every == 0 or chunk + 1 == n_chunks:
            save_checkpoint(directory, state, chunk + 1)
    return state
