"""PyTorch port: checkpoint / resume of long rollouts (utils/checkpoint.py),
the twin of tests/test_checkpoint.py."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu.config import (
    mit_cheetah_physical_config as jax_physical_config,
)
from quadruped_control_tpu.control.commander import (
    init_commander_carry as jax_carry,
)
from quadruped_control_tpu.control.plant import init_plant_state as jax_plant
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import mit_cheetah_physical_config
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.control.plant import init_plant_state
from quadruped_control_tpu_torch.control.rollout import rollout
from quadruped_control_tpu_torch.parallel.mesh import tree_leaves
from quadruped_control_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    run_checkpointed,
    save_checkpoint,
)

CFG = mit_cheetah_physical_config()
F64 = dict(dtype=torch.float64, device="cpu")


def init_rollout(batch_shape=(), **kw):
    return (init_plant_state(CFG, batch_shape, **kw),
            init_commander_carry(batch_shape, **kw))


def _assert_same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert x.device == y.device
        assert torch.equal(x, y)


def test_save_restore_roundtrip(tmp_path):
    """Every leaf comes back bitwise, in its dtype (bool flags too) and
    shape; the carry's None leaves stay None; a like tree in float32 gets
    float32 leaves."""
    state = init_rollout((8,), **F64)
    save_checkpoint(str(tmp_path), state, step=7)
    assert latest_step(str(tmp_path)) == 7
    restored, step = restore_checkpoint(str(tmp_path), state)
    assert step == 7
    _assert_same(state, restored)
    assert restored[1].ref_pose is None and restored[1].pose_cmd is None
    assert restored[1].standing.dtype == torch.bool

    like32 = init_rollout((8,), dtype=torch.float32, device="cpu")
    r32, _ = restore_checkpoint(str(tmp_path), like32)
    for a, b in zip(tree_leaves(r32), tree_leaves(state)):
        want = b.to(torch.float32) if b.is_floating_point() else b
        assert a.dtype == want.dtype and torch.equal(a, want)


def test_latest_step_and_missing_checkpoints(tmp_path):
    """Steps order numerically; a save not yet renamed into place (its
    temporary file) and other files are no checkpoint; an empty or missing
    directory has none, and restoring from it raises."""
    d = str(tmp_path / "ck")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, init_rollout((2,), **F64))
    state = init_rollout((2,), **F64)
    for step in (3, 12, 9):
        save_checkpoint(d, state, step)
    open(os.path.join(d, "step_000000000099.pt.tmp.1"), "w").close()
    open(os.path.join(d, "notes.txt"), "w").close()
    assert latest_step(d) == 12
    assert sorted(os.listdir(d))[0] == "notes.txt"


def test_resume_bitwise_matches_uninterrupted(tmp_path):
    """A rollout interrupted mid-sweep and resumed from its checkpoint gives
    the bitwise state of the uninterrupted run (the SRB rollout, float64,
    batch-less, 4 chunks of 40 ticks)."""
    cmd = torch.zeros(6, **F64)

    def chunk(state, _):
        plant, carry = state
        res = rollout(plant, carry, cmd, 40, CFG, record=False)
        return (res.plant, res.carry)

    init = init_rollout(**F64)
    ref = init
    for i in range(4):
        ref = chunk(ref, i)

    d = str(tmp_path / "ck")
    # "Preempted" run: dies after 2 of 4 chunks.
    run_checkpointed(chunk, init, n_chunks=2, directory=d)
    assert latest_step(d) == 2
    # The resumed run asks for all 4; the first 2 come from the checkpoint.
    calls = []

    def counted(state, i):
        calls.append(i)
        return chunk(state, i)

    out = run_checkpointed(counted, init, n_chunks=4, directory=d)
    assert calls == [2, 3]
    _assert_same(ref, out)
    assert latest_step(d) == 4


def test_state_converted_from_jax_survives_a_round_trip(tmp_path):
    """The JAX package's SRB plant state and commander carry, converted to
    the port (convert.plant_state_from_numpy / commander_carry_from_numpy),
    are saved and restored bitwise, and still equal the JAX arrays."""
    jcfg = jax_physical_config()
    jp = jax_plant(jcfg, (4,), dtype=jnp.float64)
    jc = jax_carry((4,), dtype=jnp.float64)
    state = (convert.plant_state_from_numpy(jp, **F64),
             convert.commander_carry_from_numpy(jc, **F64))
    save_checkpoint(str(tmp_path), state, step=1)
    restored, _ = restore_checkpoint(str(tmp_path), state)
    _assert_same(state, restored)
    np.testing.assert_array_equal(restored[0].com.x.numpy(),
                                  np.asarray(jp.com.x))
    np.testing.assert_array_equal(restored[0].joints.q.numpy(),
                                  np.asarray(jp.joints.q))
    np.testing.assert_array_equal(restored[1].planner.traj.coeffs.numpy(),
                                  np.asarray(jc.planner.traj.coeffs))
    np.testing.assert_array_equal(restored[1].standing.numpy(),
                                  np.asarray(jc.standing))
