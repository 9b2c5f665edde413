"""Load reference-format YAML configs into the port's typed ControlConfig
(counterpart of ``quadruped_control_tpu/yaml_config.py``).

Accepts the reference's exact rosparam schema
(quadruped_simulation/config/mit_cheetah_config.yaml — gait timing, joint
PD gains, balance weights, SRB dynamics) so existing configuration files
carry over unchanged. Unknown keys are ignored; missing keys fall back to
the in-code defaults (which ARE the MIT Mini Cheetah preset values).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

from quadruped_control_tpu_torch.config import (
    BalanceConfig,
    ControlConfig,
    GaitConfig,
    JointControlConfig,
)


def _tup(v):
    return tuple(float(x) for x in v)


def config_from_dict(params: Dict[str, Any]) -> ControlConfig:
    """Build a ControlConfig from a reference-schema parameter dict."""
    cfg = ControlConfig()

    gait_p = params.get("gait", {})
    gait = GaitConfig(
        t_stance=float(gait_p.get("t_stance", cfg.gait.t_stance)),
        t_swing=float(gait_p.get("t_swing", cfg.gait.t_swing)),
        swing_height=float(gait_p.get("height", cfg.gait.swing_height)),
        offsets=_tup(gait_p.get("gait_offset_phases", cfg.gait.offsets)),
    )

    jc_p = params.get("joint_control", {})
    joint_control = JointControlConfig(
        kff=_tup(jc_p.get("kff", cfg.joint_control.kff)),
        kp=_tup(jc_p.get("kp", cfg.joint_control.kp)),
        kd=_tup(jc_p.get("kd", cfg.joint_control.kd)),
    )

    bc_p = params.get("balance_control", {})
    dyn_p = params.get("dynamics", {})
    bal = cfg.balance
    w_diag = bc_p.get("w_diagonal", [bal.w_diag])
    balance = BalanceConfig(
        mass=float(dyn_p.get("mass", bal.mass)),
        inertia_diag=_tup(dyn_p.get("Ib", bal.inertia_diag)),
        mu=float(dyn_p.get("mu", bal.mu)),
        fz_min=float(dyn_p.get("fzmin", bal.fz_min)),
        fz_max=float(dyn_p.get("fzmax", bal.fz_max)),
        s_diag=_tup(bc_p.get("s_diagonal", bal.s_diag)),
        w_diag=float(w_diag[0] if isinstance(w_diag, (list, tuple))
                     else w_diag),
        kff=_tup(bc_p.get("kff", bal.kff)),
        kp_p=_tup(bc_p.get("kp_p", bal.kp_p)),
        kd_p=_tup(bc_p.get("kd_p", bal.kd_p)),
        kp_w=_tup(bc_p.get("kp_w", bal.kp_w)),
        kd_w=_tup(bc_p.get("kd_w", bal.kd_w)),
        torque_min=float(bc_p.get("torque_min", bal.torque_min)),
        torque_max=float(bc_p.get("torque_max", bal.torque_max)),
    )

    return dataclasses.replace(
        cfg,
        frequency=float(params.get("frequency", cfg.frequency)),
        gait=gait,
        joint_control=joint_control,
        balance=balance,
    )


def load_config(path: str) -> ControlConfig:
    """Load a reference-format YAML file (e.g. mit_cheetah_config.yaml)."""
    import yaml

    with open(path) as f:
        params = yaml.safe_load(f)
    return config_from_dict(params or {})
