"""Profiling and timing helpers (counterpart of
``quadruped_control_tpu/utils/profiling.py``).

Wall-clock benchmarking with the first call apart from the steady state,
per-stage host timing, items/s counters, and a ``torch.profiler`` trace
(:func:`trace`, the counterpart of the JAX package's ``xla_trace``) for a
look at the kernels one by one.

CUDA launches return before the card has finished. Wherever CUDA has been
used in this process, :func:`benchmark` and :func:`trace` call
``torch.cuda.synchronize()`` around what they time, so that their numbers
are the card's work and not the host's enqueue. A number taken on the CPU
is the CPU's: ``BenchResult.device`` says which.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Callable, Dict

import torch


def _sync():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _device_name() -> str:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return "cpu"


@dataclass
class BenchResult:
    name: str
    # The first call: the kernels' build (nvcc) and load on a fresh
    # process, allocator warm-up; the JAX package's compile time.
    compile_seconds: float
    steady_seconds: float
    reps: int
    items: int = 0
    device: str = "cpu"

    @property
    def items_per_second(self) -> float:
        return self.items / self.steady_seconds if self.steady_seconds else 0.0

    def __str__(self):
        s = (f"{self.name}: first call {self.compile_seconds:.2f}s, "
             f"steady {self.steady_seconds * 1e3:.4f} ms/rep on "
             f"{self.device}")
        if self.items:
            s += f", {self.items_per_second:,.0f} items/s"
        return s


def benchmark(fn: Callable, *args, name: str = "fn", reps: int = 10,
              items: int = 0, **kwargs) -> BenchResult:
    """Time ``fn(*args, **kwargs)``: the first call apart, then ``reps``
    calls back to back.

    The reps are enqueued without a wait and timed from a
    ``torch.cuda.synchronize()`` before the first to one after the last
    (when CUDA is in use; on the CPU every call ends when its work does), so
    ``steady_seconds`` is the mean time of one call on the card, host
    enqueue included where the host is the slower of the two."""
    _sync()
    t0 = time.perf_counter()
    fn(*args, **kwargs)
    _sync()
    first = time.perf_counter() - t0

    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args, **kwargs)
    _sync()
    steady = (time.perf_counter() - t0) / reps
    return BenchResult(name=name, compile_seconds=first,
                       steady_seconds=steady, reps=reps, items=items,
                       device=_device_name())


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA where
    it is available) into ``log_dir/trace_<pid>.json`` (Chrome trace format:
    chrome://tracing, Perfetto). Yields the profiler, whose
    ``key_averages()`` sums the time of each operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _sync()
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace_{os.getpid()}.json"))


@dataclass
class StageTimer:
    """Accumulates named host-side stage timings (assembly, solve, ...).
    Host time only: a stage that launches CUDA work and returns before it
    ends is timed to its enqueue unless the stage synchronises itself."""

    stages: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + (
                time.perf_counter() - t0
            )

    def report(self) -> str:
        total = sum(self.stages.values())
        lines = [f"total {total * 1e3:.2f} ms"]
        for k, v in sorted(self.stages.items(), key=lambda kv: -kv[1]):
            lines.append(f"  {k}: {v * 1e3:.2f} ms ({100 * v / total:.0f}%)")
        return "\n".join(lines)
