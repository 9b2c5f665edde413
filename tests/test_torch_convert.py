"""PyTorch port: configuration and state carried across as NumPy / dicts."""

import dataclasses

import numpy as np
import pytest
import torch

from quadruped_control_tpu import config as jcfg
from quadruped_control_tpu_torch import config as tcfg
from quadruped_control_tpu_torch import convert
from quadruped_control_tpu_torch.solver.ipm import IPMSolution
from torch_port_helpers import jax_scenarios, numpy_scenarios

torch.set_num_threads(1)

PRESETS = ["mit_cheetah_config", "mit_cheetah_physical_config",
           "mit_cheetah_fast_trot_config", "mit_cheetah_whole_body_config"]


@pytest.mark.parametrize("preset", PRESETS)
def test_config_from_jax_dict(preset):
    d = dataclasses.asdict(getattr(jcfg, preset)())
    cfg = convert.config_from_dict(d)
    assert cfg == getattr(tcfg, preset)()
    assert isinstance(cfg, tcfg.ControlConfig)
    assert convert.config_to_dict(cfg) == d
    assert hash(cfg) == hash(getattr(tcfg, preset)())


def test_config_from_dict_rejects_unknown_field():
    d = dataclasses.asdict(tcfg.ControlConfig())
    d["no_such_field"] = 1.0
    with pytest.raises(ValueError, match="no_such_field"):
        convert.config_from_dict(d)


@pytest.mark.parametrize("randomize", [False, True])
def test_scenarios_round_trip(randomize):
    d = numpy_scenarios(3, 17, randomize=randomize, dtype=np.float32)
    s = convert.scenarios_from_numpy(d, device="cpu")
    assert s.stance.dtype == torch.bool and s.R.dtype == torch.float32
    assert (s.mass is None) == (not randomize)
    back = convert.to_numpy(s)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)  # exact: no arithmetic
    # The JAX package holds the same arrays.
    js = jax_scenarios(d)
    np.testing.assert_array_equal(np.asarray(js.feet), back["feet"])


def test_scenarios_missing_field_raises():
    d = numpy_scenarios(3, 4)
    del d["feet"]
    with pytest.raises(ValueError, match="feet"):
        convert.scenarios_from_numpy(d, device="cpu")


def test_solution_round_trip():
    rng = np.random.default_rng(0)
    d = dict(x=rng.standard_normal((5, 12)), z=rng.random((5, 24)),
             s=rng.random((5, 24)), iterations=np.asarray(20),
             gap=rng.random(5), primal_residual=rng.random(5),
             dual_residual=rng.random(5),
             converged=np.array([True, False, True, True, False]))
    sol = convert.solution_from_numpy(d, dtype=torch.float64, device="cpu")
    assert isinstance(sol, IPMSolution) and sol.converged.dtype == torch.bool
    back = convert.to_numpy(sol)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)


def test_warm_carry():
    rng = np.random.default_rng(1)
    x, s, z = rng.standard_normal((6, 12)), rng.random((6, 24)), rng.random((6, 24))
    xw, sw, zw, st = convert.warm_carry_from_numpy(x, s, z, device="cpu")
    assert st.shape == (6, 4) and bool((st == -1).all())  # first-tick init
    assert xw.dtype == torch.float32
    np.testing.assert_array_equal(xw.numpy(), x.astype(np.float32))
    stp = np.array([[1, 0, 0, 1]] * 6, dtype=bool)
    _, _, _, st2 = convert.warm_carry_from_numpy(x, s, z, stp, device="cpu")
    np.testing.assert_array_equal(st2.numpy(), stp.astype(np.float32))


def test_to_numpy_containers():
    out = convert.to_numpy({"a": (torch.ones(2), None), "b": [torch.zeros(1)],
                            "c": tcfg.StandConfig()})
    assert isinstance(out["a"][0], np.ndarray) and out["a"][1] is None
    assert out["c"] == {"height": 0.26, "height_tolerance": 0.005}


def test_default_device_without_card_raises():
    d = numpy_scenarios(3, 4)
    if torch.cuda.is_available():
        assert convert.scenarios_from_numpy(d).R.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            convert.scenarios_from_numpy(d)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_srb_state_round_trip_keeps_rank(batch):
    """A batch-less carry's flags stay 0-d (np.ascontiguousarray would make
    them 1-d, and the commander's footholds would gain a batch axis), and a
    JAX PlantState / CommanderCarry converts leaf by leaf."""
    import jax.numpy as jnp

    from quadruped_control_tpu.config import mit_cheetah_physical_config
    from quadruped_control_tpu.control.commander import init_commander_carry
    from quadruped_control_tpu.control.plant import init_plant_state

    cfg = mit_cheetah_physical_config()
    jp = init_plant_state(cfg, batch, dtype=jnp.float64)
    jc = init_commander_carry(batch, dtype=jnp.float64)
    tp = convert.plant_state_from_numpy(jp, dtype=torch.float64,
                                        device="cpu")
    tc = convert.commander_carry_from_numpy(jc, dtype=torch.float64,
                                            device="cpu")
    assert tc.standing.shape == batch and tc.standing.dtype == torch.bool
    assert tc.planner.initialized.shape == batch
    assert tc.planner.prev_in_stance.shape == batch + (4,)
    np.testing.assert_array_equal(tp.joints.q.numpy(), np.asarray(jp.joints.q))
    np.testing.assert_array_equal(tp.com.R.numpy(), np.asarray(jp.com.R))
    sol = convert.solution_from_numpy(dict(
        x=np.zeros(12), z=np.ones(24), s=np.ones(24), iterations=3,
        gap=0.0, primal_residual=0.0, dual_residual=0.0, converged=True),
        device="cpu")
    assert sol.converged.shape == () and bool(sol.converged)
