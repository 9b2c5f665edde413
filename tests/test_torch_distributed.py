"""PyTorch port: multi-process bring-up (parallel/distributed.py), the twin
of tests/test_multiprocess.py.

The two-process test SPAWNS two processes of scripts/torch_multihost_demo.py
joined over gloo on localhost: each solves its slice of one global batch
over a local mesh of 4 CPU entries and checks the fraction reduced over both
processes against a solve of the whole batch in one process.
"""

import os
import socket
import subprocess
import sys

import pytest

from quadruped_control_tpu_torch.parallel import distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_without_environment_is_a_noop(monkeypatch):
    """No arguments and no MASTER_ADDR / WORLD_SIZE / RANK: the
    single-process run, nothing joined, and this process is the primary."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize()
    distributed.initialize()  # idempotent
    assert not distributed._is_initialized()
    assert distributed.is_primary()
    assert distributed.process_count() == 1
    assert distributed.process_index() == 0


def test_initialize_needs_every_explicit_argument():
    """Explicit arguments come as a set: a coordinator without a world size
    and rank raises instead of guessing."""
    with pytest.raises(ValueError, match="together"):
        distributed.initialize("localhost:1", device="cpu")
    assert not distributed._is_initialized()


@pytest.mark.timeout(240)
def test_two_process_sharded_solve():
    port = _free_port()
    # One thread each: two processes whose OpenMP pools each span every core
    # spin against each other (~40 s a solve instead of ~1 s).
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable,
             os.path.join(REPO, "scripts", "torch_multihost_demo.py"),
             "--device", "cpu",
             "--coordinator", f"localhost:{port}",
             "--num-processes", "2", "--process-id", str(i),
             "--global-batch", "256"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=200)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-2000:]}"
        assert f"proc {i}: OK" in out, out[-2000:]
        assert "8 global / 4 local" in out
