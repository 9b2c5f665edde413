"""SO(3)/SE(3) primitives as pure, batched PyTorch functions.

Replacement for the reference's ``math/rigid3d.{hpp,cpp}`` (Eigen
quaternion + Drake RotationMatrix wrappers, reference rigid3d.cpp:61-321).
Rotations are plain ``(..., 3, 3)`` arrays, quaternions are ``(..., 4)`` in
``[w, x, y, z]`` order, rigid transforms are ``(R, p)`` tuples. Everything is
branch-free (``torch.where`` instead of the reference's ``if`` ladders) so every
function broadcasts over leading batch dimensions and differentiates.

Conventions mirrored from the reference:
  - Euler angles are roll-pitch-yaw with ``R = Rz(yaw) @ Ry(pitch) @ Rx(roll)``
    (Drake ``RollPitchYaw``, used by rigid3d.cpp:113-117, 181-184).
  - Twists are ``[vx, vy, vz, wx, wy, wz]`` and the 6x6 adjoint maps a body
    twist to the world frame (rigid3d.cpp:259-271 — note the reference
    actually builds the *inverse* adjoint; see :func:`transform_adjoint`).
"""

from __future__ import annotations

import math

import torch

from quadruped_control_tpu_torch import resolve_device

__all__ = [
    "skew",
    "unskew",
    "quat_identity",
    "quat_normalize",
    "quat_multiply",
    "quat_rotate",
    "quat_to_matrix",
    "matrix_to_quat",
    "quat_from_axis_angle",
    "matrix_from_axis_angle",
    "so3_exp",
    "so3_log",
    "angle_axis_total",
    "rpy_to_matrix",
    "matrix_to_rpy",
    "quat_to_rpy",
    "transform_compose",
    "transform_apply",
    "transform_inverse",
    "transform_adjoint",
]


def skew(v):
    """3-vector -> skew-symmetric matrix (reference rigid3d.cpp:61-74)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def unskew(m):
    """Inverse of :func:`skew`."""
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def quat_identity(dtype=torch.float32, device=None):
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype,
                        device=resolve_device(device))


def quat_normalize(q, eps=1e-12):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=eps)


def quat_multiply(q1, q2):
    """Hamilton product, [w,x,y,z] convention."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vector(s) ``v`` by unit quaternion ``q`` (R(q) @ v)."""
    qv = q[..., 1:]
    qw = q[..., :1]
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + qw * t + torch.linalg.cross(qv, t)


def quat_to_matrix(q):
    """Unit quaternion [w,x,y,z] -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_quat(R):
    """Rotation matrix -> unit quaternion [w,x,y,z], branch-free.

    Uses the standard four-candidate construction (one per largest of
    ``w,x,y,z``) with ``torch.where`` selection so it is safe on whole batches for
    any proper rotation, including angle ~ pi where the trace formula alone is
    unstable.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    # Four candidate 4*q*q_i vectors; pick the one with the largest pivot.
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1)

    pivots = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
                        1.0 - m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)[..., None, None]
    cand = torch.stack([qw, qx, qy, qz], dim=-2)
    q = torch.take_along_dim(cand, best.expand(best.shape[:-2] + (1, 4)),
                             dim=-2)[..., 0, :]
    q = quat_normalize(q)
    # Canonicalize sign: w >= 0.
    return q * torch.where(q[..., :1] < 0.0, -1.0, 1.0)


def quat_from_axis_angle(axis, angle):
    """Unit axis + angle -> quaternion (reference rigid3d.cpp:98-101)."""
    angle = torch.as_tensor(angle, dtype=axis.dtype, device=axis.device)
    half = 0.5 * angle
    return torch.cat(
        [torch.cos(half)[..., None], torch.sin(half)[..., None] * axis], dim=-1
    )


def matrix_from_axis_angle(axis, angle):
    """Rodrigues' formula for a unit axis."""
    angle = torch.as_tensor(angle, dtype=axis.dtype,
                            device=axis.device)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + torch.sin(angle) * K + (1.0 - torch.cos(angle)) * (K @ K)


def so3_exp(w, eps=1e-8):
    """Exponential map: rotation vector (axis*angle) -> rotation matrix.

    Branch-free small-angle handling replaces the reference's
    ``almost_equal(angle, 0)`` special case (trajectory.cpp:41-54): Taylor
    series for sin(t)/t and (1-cos t)/t^2 below ``eps``.
    """
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2)
    use_taylor = theta < eps
    # sin(t)/t and (1 - cos t)/t^2, Taylor-expanded near zero.
    safe_t2 = torch.where(use_taylor, 1.0, theta2)
    a = torch.where(use_taylor, 1.0 - theta2 / 6.0, torch.sin(theta) / torch.sqrt(safe_t2))
    b = torch.where(use_taylor, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / safe_t2)
    K = skew(w)
    eye = torch.eye(3, dtype=K.dtype, device=K.device)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def so3_log(R, eps=1e-7):
    """Logarithm map: rotation matrix -> rotation vector (axis*angle).

    Equivalent to the reference's ``Rotation3d::angleAxisTotal`` (rigid3d.cpp:
    198-203, Eigen ``AngleAxisd``): angle in [0, pi]. Handles the three
    regimes (small angle, generic, near pi) with ``torch.where`` so it stays
    valid on whole batches and yields finite gradients.
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)

    # sin(theta) taken directly from the skew part — NOT sin(arccos(c)),
    # which is catastrophically ill-conditioned near pi in float32.
    w_skew = unskew(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_theta = 0.5 * torch.linalg.norm(w_skew, dim=-1)
    theta = torch.atan2(sin_theta, cos_theta)

    small = theta < eps
    near_pi = theta > math.pi - 1e-2

    generic_scale = torch.where(
        small, 0.5 * (1.0 + theta * theta / 6.0),
        0.5 * theta / torch.where(small | near_pi, 1.0, sin_theta),
    )
    w_generic = w_skew * generic_scale[..., None]

    # Near pi: axis from the symmetric part, R + I = 2(axis axis^T - ...).
    # diag(R) = 1 - 2(1 - axis_i^2) sin^2(theta/2) ... use outer-product form.
    B = 0.5 * (R + R.transpose(-1, -2)) + \
        (0.5 * (1.0 - tr))[..., None, None] * torch.eye(
            3, dtype=R.dtype, device=R.device)
    # B ~ (1 - cos) axis axis^T at theta = pi -> 2 axis axis^T.
    diag = torch.stack([B[..., 0, 0], B[..., 1, 1], B[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    axis_pi = torch.take_along_dim(
        B, k[..., None, None].expand(k.shape + (3, 1)), dim=-1)[..., 0]
    axis_pi = axis_pi / torch.clamp(
        torch.linalg.norm(axis_pi, dim=-1, keepdim=True), min=1e-12
    )
    # Fix sign from the skew part where it is nonzero; at exactly pi the sign
    # is arbitrary (R(axis, pi) == R(-axis, pi)).
    sign = torch.where(torch.sum(axis_pi * w_skew, dim=-1) < 0.0, -1.0, 1.0)
    w_pi = axis_pi * (sign * theta)[..., None]

    return torch.where(near_pi[..., None], w_pi, w_generic)


def angle_axis_total(R):
    """Alias matching the reference API name (rigid3d.cpp:198-203)."""
    return so3_log(R)


def rpy_to_matrix(rpy):
    """Roll-pitch-yaw -> rotation matrix, R = Rz(y) Ry(p) Rx(r) (Drake)."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def matrix_to_rpy(R):
    """Rotation matrix -> roll-pitch-yaw (inverse of :func:`rpy_to_matrix`)."""
    pitch = torch.asin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_to_rpy(q):
    """Quaternion -> roll-pitch-yaw (reference rigid3d.cpp:113-117)."""
    return matrix_to_rpy(quat_to_matrix(q))


def transform_compose(R1, p1, R2, p2):
    """(R1,p1) * (R2,p2) -> (R1 R2, R1 p2 + p1)."""
    return R1 @ R2, (R1 @ p2[..., None])[..., 0] + p1


def transform_apply(R, p, x):
    """Apply rigid transform to point(s): R x + p (rigid3d.cpp:296-301)."""
    return (R @ x[..., None])[..., 0] + p


def transform_inverse(R, p):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ p[..., None])[..., 0]


def transform_adjoint(R, p):
    """6x6 adjoint exactly as the reference builds it (rigid3d.cpp:259-271).

    NOTE (behavioral parity): the reference composes the adjoint from
    ``R^T`` blocks — i.e. for ``Twb`` it returns the adjoint of the *inverse*
    transform with a sign quirk on the coupling block:

        AdT = [[R^T, -R^T [p]x], [0, R^T]]

    The commander then computes ``Vw = Ad(Twb) @ Vb`` (commander_node.cpp:
    410-412). With identity yaw-only rotations and planar twists this matches
    the true world twist; we reproduce the exact matrix so validation
    scenarios agree bit-for-bit in structure.
    """
    Rt = R.transpose(-1, -2)
    zeros = torch.zeros_like(Rt)
    top = torch.cat([Rt, -(Rt @ skew(p))], dim=-1)
    bot = torch.cat([zeros, Rt], dim=-1)
    return torch.cat([top, bot], dim=-2)
