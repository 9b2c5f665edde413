"""Closed-form quadruped leg kinematics as batched PyTorch ops.

Re-implementation of ``QuadrupedKinematics`` (reference
kinematics.cpp). The reference computes one leg at a time through string-keyed
maps; here all four legs are computed at once on ``(..., 4, 3)`` tensors (any
leading scenario batch shape), with the left/right branch of IK
(kinematics.cpp:147-154) expressed as a per-leg sign vector instead of
control flow.

Constants (kinematics.cpp:23-31): hip offset (0.196, 0.050, 0), links
l1=0.077, l2=0.211, l3=0.230. Left legs use signed links (l1, -l2, -l3),
right legs (-l1, -l2, -l3) (kinematics.cpp:41-42).
"""

from __future__ import annotations

import torch

from quadruped_control_tpu_torch.config import KinematicsConfig

# Per-leg signs in [RL, FL, RR, FR] order: left legs +1, right legs -1.
_LEFT_SIGN = (1.0, 1.0, -1.0, -1.0)


def _left_sign(dtype, device):
    return torch.tensor(_LEFT_SIGN, dtype=dtype, device=device)


def _signed_links(cfg: KinematicsConfig, dtype, device):
    """(4, 3) signed link lengths per leg, matching link_map_ in the ref."""
    sl1 = cfg.l1 * _left_sign(dtype, device)
    sl2 = torch.full((4,), -cfg.l2, dtype=dtype, device=device)
    sl3 = torch.full((4,), -cfg.l3, dtype=dtype, device=device)
    return torch.stack([sl1, sl2, sl3], dim=-1)


def forward_kinematics(q, cfg: KinematicsConfig = KinematicsConfig()):
    """Foot positions in the body frame (reference kinematics.cpp:81-103).

    Args:
      q: (..., 4, 3) joint angles [hip, thigh, calf] per leg.
    Returns:
      (..., 4, 3) foot positions relative to the base frame.
    """
    dtype = q.dtype
    links = _signed_links(cfg, dtype, q.device)
    l1, l2, l3 = links[..., 0], links[..., 1], links[..., 2]
    hips = cfg.hip_offsets(dtype, device=q.device)

    t1, t2, t3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(t1), torch.cos(t1)
    s2, c2 = torch.sin(t2), torch.cos(t2)
    s23, c23 = torch.sin(t2 + t3), torch.cos(t2 + t3)

    x = l2 * s2 + l3 * s23 + hips[..., 0]
    y = l1 * c1 - l2 * s1 * c2 - l3 * s1 * c23 + hips[..., 1]
    z = l1 * s1 + l2 * c1 * c2 + l3 * c1 * c23 + hips[..., 2]
    return torch.stack([x, y, z], dim=-1)


def inverse_kinematics(foot_positions, cfg: KinematicsConfig = KinematicsConfig()):
    """Analytic 3-DoF leg IK (reference kinematics.cpp:117-160).

    Branch semantics preserved as masked dataflow:
      - ``d`` clamped from above at 1 (kinematics.cpp:133-136); additionally
        clamped at -1 here — the reference would produce NaN for targets
        closer than the fully-folded leg, we saturate instead (documented
        deviation, identical on all reachable targets).
      - ``sqrt_component`` clamped at 0 (kinematics.cpp:138-142).
      - left/right hip-angle branch via the per-leg sign vector.

    Args:
      foot_positions: (..., 4, 3) foot targets in the body frame.
    Returns:
      (..., 4, 3) joint angles.
    """
    dtype = foot_positions.dtype
    hips = cfg.hip_offsets(dtype, device=foot_positions.device)
    p = foot_positions - hips
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    l1, l2, l3 = cfg.l1, cfg.l2, cfg.l3

    d = (x * x + y * y + z * z - l1 * l1 - l2 * l2 - l3 * l3) / (2.0 * l2 * l3)
    d = torch.clamp(d, -1.0, 1.0)

    sqrt_component = torch.clamp(y * y + z * z - l1 * l1, min=0.0)
    root = torch.sqrt(sqrt_component)

    left = _left_sign(dtype, foot_positions.device)  # +1 left (RL, FL), -1 right (RR, FR)
    # Right: q0 = atan2(z, y) + atan2(root, -l1)
    # Left:  q0 = -(atan2(z, -y) + atan2(root, -l1))
    neg_l1 = torch.full_like(root, -l1)
    q0_right = torch.atan2(z, y) + torch.atan2(root, neg_l1)
    q0_left = -(torch.atan2(z, -y) + torch.atan2(root, neg_l1))
    q0 = torch.where(left > 0, q0_left, q0_right)

    q2 = torch.atan2(-torch.sqrt(torch.clamp(1.0 - d * d, min=0.0)), d)
    q1 = -torch.atan2(x, root) - torch.atan2(
        l3 * torch.sin(q2), l2 + l3 * torch.cos(q2)
    )
    return torch.stack([q0, q1, q2], dim=-1)


def leg_jacobian(q, cfg: KinematicsConfig = KinematicsConfig()):
    """Geometric Jacobian d(foot)/d(q) per leg (kinematics.cpp:162-188).

    Args:
      q: (..., 4, 3) joint angles.
    Returns:
      (..., 4, 3, 3) Jacobians.
    """
    dtype = q.dtype
    links = _signed_links(cfg, dtype, q.device)
    l1, l2, l3 = links[..., 0], links[..., 1], links[..., 2]

    t1, t2, t3 = q[..., 0], q[..., 1], q[..., 2]
    s1, c1 = torch.sin(t1), torch.cos(t1)
    s2, c2 = torch.sin(t2), torch.cos(t2)
    s23, c23 = torch.sin(t2 + t3), torch.cos(t2 + t3)

    zero = torch.zeros_like(t1)
    j00 = zero
    j01 = l2 * c2 + l3 * c23
    j02 = l3 * c23
    j10 = -l1 * s1 - l2 * c1 * c2 - l3 * c1 * c23
    j11 = (l2 * s2 + l3 * s23) * s1
    j12 = l3 * s1 * s23
    j20 = l1 * c1 - l2 * s1 * c2 - l3 * s1 * c23
    j21 = -(l2 * s2 + l3 * s23) * c1
    j22 = -l3 * s23 * c1

    row0 = torch.stack([j00, j01, j02], dim=-1)
    row1 = torch.stack([j10, j11, j12], dim=-1)
    row2 = torch.stack([j20, j21, j22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _adjugate_3x3(m):
    """Closed-form adjugate of (..., 3, 3) — inverse = adj / det."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    adj = torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], dim=-1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], dim=-1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], dim=-1),
        ],
        dim=-2,
    )
    det = a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)
    return adj, det


def leg_jacobian_inverse(q, cfg: KinematicsConfig = KinematicsConfig(),
                         det_eps: float = 1e-8, damping: float = 1e-6):
    """J^-1 with a singularity fallback (kinematics.cpp:190-204).

    The reference tries ``inv`` -> ``pinv`` -> ``J.t()``. Batched version:
    closed-form adjugate inverse when |det| > det_eps, else a Tikhonov-damped
    pseudo-inverse ``J^T (J J^T + lambda I)^-1`` — identical to ``inv`` away
    from singularities (the only regime the validation scenarios visit) and
    bounded at them, with no data-dependent branching.

    Returns:
      (..., 4, 3, 3) inverse Jacobians.
    """
    J = leg_jacobian(q, cfg)
    adj, det = _adjugate_3x3(J)
    singular = torch.abs(det) <= det_eps
    safe_det = torch.where(singular, 1.0, det)
    inv = adj / safe_det[..., None, None]

    JJt = J @ J.transpose(-1, -2)
    JJt_damped = JJt + damping * torch.eye(3, dtype=q.dtype, device=q.device)
    adj_d, det_d = _adjugate_3x3(JJt_damped)
    damped_pinv = J.transpose(-1, -2) @ (adj_d / det_d[..., None, None])

    return torch.where(singular[..., None, None], damped_pinv, inv)


def jacobian_transpose_control(q, forces, cfg: KinematicsConfig = KinematicsConfig()):
    """tau = J^T f per leg — the commander's stance-torque path
    (kinematics.cpp:218-231, used at commander_node.cpp:511-512).

    Args:
      q: (..., 4, 3) joint angles.
      forces: (..., 4, 3) body-frame foot forces.
    Returns:
      (..., 4, 3) joint torques.
    """
    J = leg_jacobian(q, cfg)
    return (J.transpose(-1, -2) @ forces[..., None])[..., 0]
