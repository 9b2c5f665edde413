"""PyTorch port: config presets field-for-field equal to the JAX package's."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from quadruped_control_tpu import config as jcfg
from quadruped_control_tpu_torch import config as tcfg

torch.set_num_threads(1)

PRESETS = ["mit_cheetah_config", "mit_cheetah_physical_config",
           "mit_cheetah_fast_trot_config", "mit_cheetah_whole_body_config"]
EXTRA = ["FootholdTrimConfig", "StancePoseConfig", "TeleopLimits",
         "StanceTeleopLimits"]


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_fields_equal(preset):
    j = dataclasses.asdict(getattr(jcfg, preset)())
    t = dataclasses.asdict(getattr(tcfg, preset)())
    assert j == t  # exact: the same Python literals


@pytest.mark.parametrize("cls", EXTRA)
def test_extra_dataclasses_equal(cls):
    assert dataclasses.asdict(getattr(jcfg, cls)()) == dataclasses.asdict(
        getattr(tcfg, cls)())


def test_constants_and_derived_properties():
    assert jcfg.LEG_NAMES == tcfg.LEG_NAMES
    assert (jcfg.NUM_LEGS, jcfg.NUM_JOINTS, jcfg.GRAVITY) == (
        tcfg.NUM_LEGS, tcfg.NUM_JOINTS, tcfg.GRAVITY)
    assert jcfg.GaitConfig().period == tcfg.GaitConfig().period
    assert jcfg.GaitConfig().stance_phase == tcfg.GaitConfig().stance_phase


def test_numpy_snapshots_equal():
    # Exact: float64 NumPy on both sides.
    np.testing.assert_array_equal(jcfg.KinematicsConfig().hip_offsets_np(),
                                  tcfg.KinematicsConfig().hip_offsets_np())
    np.testing.assert_array_equal(jcfg.KinematicsConfig().l1_signed_np(),
                                  tcfg.KinematicsConfig().l1_signed_np())
    np.testing.assert_array_equal(jcfg.FootPlannerConfig().hip_offsets_np(),
                                  tcfg.FootPlannerConfig().hip_offsets_np())
    np.testing.assert_array_equal(
        jcfg.srb_params_array(jcfg.BalanceConfig()),
        tcfg.srb_params_array(tcfg.BalanceConfig()))


@pytest.mark.parametrize("dt", ["f32", "f64"])
def test_array_helpers_equal(dt):
    jd = {"f32": jnp.float32, "f64": jnp.float64}[dt]
    td = {"f32": torch.float32, "f64": torch.float64}[dt]
    pairs = [
        (jcfg.KinematicsConfig().hip_offsets(jd),
         tcfg.KinematicsConfig().hip_offsets(td, device="cpu")),
        (jcfg.KinematicsConfig().l1_signed(jd),
         tcfg.KinematicsConfig().l1_signed(td, device="cpu")),
        (jcfg.GaitConfig().offsets_array(jd),
         tcfg.GaitConfig().offsets_array(td, device="cpu")),
        (jcfg.FootPlannerConfig().hip_offsets(jd),
         tcfg.FootPlannerConfig().hip_offsets(td, device="cpu")),
        (jcfg.BalanceConfig().inertia(jd),
         tcfg.BalanceConfig().inertia(td, device="cpu")),
        (jcfg.BalanceConfig().S(jd), tcfg.BalanceConfig().S(td, device="cpu")),
        (jcfg.BalanceConfig().W(jd), tcfg.BalanceConfig().W(td, device="cpu")),
    ]
    for a, b in pairs:
        # Exact: literals rounded once to the same dtype.
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_teleop_clamps_equal():
    tw = np.linspace(-1.0, 1.0, 12).reshape(2, 6)
    np.testing.assert_array_equal(
        np.asarray(jcfg.TeleopLimits().clamp(jnp.asarray(tw))),
        tcfg.TeleopLimits().clamp(torch.from_numpy(tw)).numpy())
    np.testing.assert_array_equal(
        np.asarray(jcfg.StanceTeleopLimits().clamp(jnp.asarray(tw))),
        tcfg.StanceTeleopLimits().clamp(torch.from_numpy(tw)).numpy())


def test_default_device_is_cuda_and_missing_card_raises():
    """An entry point called without device='cpu' on a machine without a
    card raises; it does not carry on on the CPU."""
    if torch.cuda.is_available():
        assert tcfg.KinematicsConfig().hip_offsets().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            tcfg.KinematicsConfig().hip_offsets()


def test_tf32_pinned_off_at_import():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
