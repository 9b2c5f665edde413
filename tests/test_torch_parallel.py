"""PyTorch port: scenario sharding (parallel/mesh.py) on meshes of
``[cpu] * 8``, against the JAX package's GSPMD sharding on its 8 virtual CPU
devices (tests/conftest.py) and against the port's own unsharded runs.

The JAX inputs are drawn by the JAX package and handed to the port as NumPy
arrays; the rollouts start from the deterministic laying pose of both
packages. The fused-tick runs go through the kernels' plain versions (CPU
tensors); the unsharded port tick is held against the JAX package by
tests/test_torch_fused_tick.py and tests/test_torch_fused_mpc_tick.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from quadruped_control_tpu.config import (
    mit_cheetah_config as jax_cheetah_config,
    mit_cheetah_physical_config as jax_physical_config,
)
from quadruped_control_tpu.parallel import mesh as jmesh
from quadruped_control_tpu.utils.scenarios import grf_scenarios as jax_grf
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.config import (
    mit_cheetah_config,
    mit_cheetah_physical_config,
)
from quadruped_control_tpu_torch.control.commander import init_commander_carry
from quadruped_control_tpu_torch.control.plant import init_plant_state
from quadruped_control_tpu_torch.control.rollout import rollout_mpc_decimated
from quadruped_control_tpu_torch.parallel import mesh
from quadruped_control_tpu_torch.sim import (
    ContactConfig,
    init_whole_body_rollout,
    make_fused_stepper,
    mit_cheetah_whole_body_model,
)
from quadruped_control_tpu_torch.sim.fused_tick import (
    make_fused_tick,
    rollout_whole_body_fused,
    rollout_whole_body_fused_decimated,
)

CPU8 = [torch.device("cpu")] * 8


def _port_scenarios(s_jax, dtype):
    d = {k: np.asarray(v) for k, v in s_jax._asdict().items()
         if v is not None}
    return convert.scenarios_from_numpy(d, dtype=dtype, device="cpu")


def _equal_trees(a, b):
    for x, y in zip(mesh.tree_leaves(a), mesh.tree_leaves(b)):
        if not torch.equal(x, y):
            return False
    return True


def _max_gap(a, b):
    return max((x.double() - y.double()).abs().max().item()
               for x, y in zip(mesh.tree_leaves(a), mesh.tree_leaves(b))
               if x.is_floating_point())


def test_mesh_entries_and_the_missing_card():
    """A mesh of [cpu] * 8 has 8 entries; a mesh that names cuda without a
    card raises, by default or by name."""
    m = mesh.scenario_mesh(CPU8)
    assert len(m) == 8 and all(d.type == "cpu" for d in m)
    assert mesh.batch_sharding(m).bounds(64) == [
        (8 * k, 8 * k + 8) for k in range(8)]
    assert [hi - lo for lo, hi in mesh.batch_sharding(m).bounds(10)] == [
        2, 2, 1, 1, 1, 1, 1, 1]
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.scenario_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.scenario_mesh(["cuda:0"])


def test_sharded_solve_matches_jax_and_unsharded():
    """grf_scenarios(key 3, B = 64, float64) solved over 8 shards: x within
    1e-8 of the JAX package's sharded solve on its 8 devices, the converged
    flags equal, the fraction within 1e-12 and > 0.95; the port's sharded
    and unsharded solves agree the same way."""
    s_j = jax_grf(jax.random.key(3), 64, jax_cheetah_config(),
                  dtype=jnp.float64)
    jm = jmesh.scenario_mesh()
    assert jm.devices.size == 8
    xj, cj, fj = jmesh.solve_scenarios_sharded(jmesh.shard_scenarios(s_j, jm),
                                               jax_cheetah_config())

    s = _port_scenarios(s_j, torch.float64)
    cfg = mit_cheetah_config()
    sharded = mesh.shard_scenarios(s, CPU8)
    assert len(sharded.shards) == 8
    assert all(sh.x.shape[0] == 8 for sh in sharded.shards)
    x, c, f = mesh.solve_scenarios_sharded(sharded, cfg)
    x1, c1, f1 = mesh.solve_scenarios_sharded(s, cfg)

    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=0, atol=1e-8)
    np.testing.assert_array_equal(c.numpy(), np.asarray(cj))
    assert abs(float(f) - float(fj)) < 1e-12
    assert float(f) > 0.95
    assert f.dtype == torch.float64
    np.testing.assert_allclose(x.numpy(), x1.numpy(), rtol=0, atol=1e-8)
    assert torch.equal(c, c1) and float(f) == float(f1)


def test_sharded_solve_with_randomized_params():
    """Config-5 shape (domain-randomized SRB parameters), sharded: finite,
    fraction > 0.9, and the JAX package's fraction within 1e-12."""
    s_j = jax_grf(jax.random.key(4), 32, jax_cheetah_config(),
                  dtype=jnp.float64, randomize_params=True)
    _, _, fj = jmesh.solve_scenarios_sharded(
        jmesh.shard_scenarios(s_j, jmesh.scenario_mesh()),
        jax_cheetah_config())
    s = _port_scenarios(s_j, torch.float64)
    x, _, f = mesh.solve_scenarios_sharded(mesh.shard_scenarios(s, CPU8),
                                           mit_cheetah_config())
    assert bool(torch.isfinite(x).all())
    assert float(f) > 0.9
    assert abs(float(f) - float(fj)) < 1e-12


def test_sharded_srb_mpc_rollout_matches_jax():
    """The decimated SRB MPC loop (B = 16, 30 ticks, mpc_every = 5, N = 4,
    mpc_dt = 0.04, 12 iterations, structured) run per shard over 8 shards:
    trace.x within 1e-9 of the JAX package's sharded run, and bitwise the
    port's unsharded run."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from quadruped_control_tpu.control.commander import (
        init_commander_carry as jax_carry,
    )
    from quadruped_control_tpu.control.plant import (
        init_plant_state as jax_plant,
    )
    from quadruped_control_tpu.control.rollout import (
        rollout_mpc_decimated as jax_decimated,
    )

    B = 16
    kw = dict(mpc_every=5, mpc_horizon=4, mpc_dt=0.04, mpc_iterations=12,
              mpc_backend="structured")
    jcfg = jax_physical_config()
    jm = jmesh.scenario_mesh()
    shard = NamedSharding(jm, P("scenario"))
    put = lambda t: jax.tree.map(lambda a: jax.device_put(a, shard), t)  # noqa: E731
    cmd_j = jnp.zeros((B, 6), jnp.float64).at[:, 0].set(0.1)
    ref = jax_decimated(put(jax_plant(jcfg, (B,), dtype=jnp.float64)),
                        put(jax_carry((B,), dtype=jnp.float64)), put(cmd_j),
                        30, jcfg, **kw)

    cfg = mit_cheetah_physical_config()
    f64 = dict(dtype=torch.float64, device="cpu")
    plant = init_plant_state(cfg, (B,), **f64)
    carry = init_commander_carry((B,), **f64)
    cmd = torch.zeros((B, 6), **f64)
    cmd[:, 0] = 0.1

    def local(p, c, u):
        return rollout_mpc_decimated(p, c, u, 30, cfg, **kw).trace

    trace = mesh.map_shards(CPU8, local, plant, carry, cmd, out_axis=1)
    np.testing.assert_allclose(trace.x.numpy(), np.asarray(ref.trace.x),
                               rtol=0, atol=1e-9)
    whole = rollout_mpc_decimated(plant, carry, cmd, 30, cfg, **kw).trace
    assert torch.equal(trace.x, whole.x)
    assert torch.equal(trace.in_stance, whole.in_stance)


@pytest.mark.parametrize("stepper", ["plain", "fused"])
def test_shard_rollout_whole_body_matches_jax(stepper):
    """shard_rollout_whole_body over 8 shards (B = 64, 3 ticks,
    n_substeps = 3, qp_iterations = 8) against the JAX package's unsharded
    rollout_whole_body, at tests/test_sharding.py's tolerances: x within
    1e-12 with the plain substeps and 1e-8 with the fused stepper (its plain
    version on the CPU), u within 100 times that, standing equal."""
    from quadruped_control_tpu.sim import (
        ContactConfig as JaxContact,
        init_whole_body_rollout as jax_init_wb,
        mit_cheetah_whole_body_model as jax_wb_model,
        rollout_whole_body as jax_rollout_wb,
    )

    B = 64
    kw = dict(n_substeps=3, qp_iterations=8)
    jcfg = jax_physical_config()
    jplant, jcarry = jax_init_wb(jcfg, (B,), dtype=jnp.float64)
    ref = jax_rollout_wb(jplant, jcarry, jnp.zeros((B, 6), jnp.float64), 3,
                         jcfg, jax_wb_model(jcfg, dtype=jnp.float64),
                         JaxContact(), record=False, **kw)

    cfg = mit_cheetah_physical_config()
    f64 = dict(dtype=torch.float64, device="cpu")
    model = mit_cheetah_whole_body_model(cfg, **f64)
    contact = ContactConfig()
    plant, carry = init_whole_body_rollout(cfg, (B,), **f64)
    st = (None if stepper == "plain"
          else make_fused_stepper(model, cfg, contact))
    run = mesh.shard_rollout_whole_body(CPU8, cfg, model, contact,
                                        stepper=st, **kw)
    out = run(plant, carry, torch.zeros((B, 6), **f64), 3)
    atol = 1e-12 if stepper == "plain" else 1e-8
    np.testing.assert_allclose(out.plant.x.numpy(), np.asarray(ref.plant.x),
                               rtol=0, atol=atol)
    np.testing.assert_allclose(out.plant.u.numpy(), np.asarray(ref.plant.u),
                               rtol=0, atol=100 * atol)
    np.testing.assert_array_equal(out.carry.standing.numpy(),
                                  np.asarray(ref.carry.standing))


@pytest.mark.parametrize("controller", ["balance", "mpc"])
def test_shard_rollout_whole_body_fused_is_the_unsharded_loop(controller):
    """The fused tick (its plain versions on the CPU) over 8 shards of B =
    16 float32 robots with spread start poses: the balance tick, barrier-only
    as in dryrun_multichip (the polish's plain version costs ~2 s a call on
    the CPU, whatever the batch), for 3 ticks; the warm MPC tick decimated
    (mpc_every = 2) for 4. Every instance is
    independent, so each shard's plant and carry are bitwise the unsharded
    loop's."""
    B = 16
    cfg = mit_cheetah_physical_config()
    f32 = dict(dtype=torch.float32, device="cpu")
    model = mit_cheetah_whole_body_model(cfg, **f32)
    plant, carry = init_whole_body_rollout(cfg, (B,), **f32)
    rng = np.random.default_rng(12)
    plant = plant._replace(x=plant.x + torch.as_tensor(
        np.c_[1e-3 * rng.standard_normal((B, 2)), np.zeros(B)], **f32))
    cmd = torch.zeros((B, 6), **f32)
    cmd[:, 0] = 0.2
    if controller == "balance":
        tick = make_fused_tick(model, cfg, ContactConfig(),
                               gravity_comp=True, qp_polish=False)
        steps, every = 3, None
        whole = rollout_whole_body_fused(plant, carry, cmd, steps, tick,
                                         n_substeps=4)
    else:
        tick = make_fused_tick(model, cfg, ContactConfig(),
                               gravity_comp=True, controller="mpc",
                               mpc_horizon=4, mpc_dt=0.02, mpc_iterations=3,
                               mpc_warm_start=True)
        steps, every = 4, 2
        whole = rollout_whole_body_fused_decimated(
            plant, carry, cmd, steps, tick, mpc_every=every, n_substeps=4)
    run = mesh.shard_rollout_whole_body_fused(CPU8, tick, n_substeps=4,
                                              mpc_every=every)
    out = run(plant, carry, cmd, steps)
    assert out.trace is None and out.warm is None
    gap = _max_gap((out.plant, out.carry), (whole.plant, whole.carry))
    assert _equal_trees((out.plant, out.carry),
                        (whole.plant, whole.carry)), f"max gap {gap:.3e}"
    assert bool(torch.isfinite(out.plant.x).all())
