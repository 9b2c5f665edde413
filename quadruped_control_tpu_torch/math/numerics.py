"""Scalar numeric helpers (PyTorch version of math/numerics.{hpp,cpp}).

All functions are elementwise tensor ops — they broadcast over any batch
shape, replacing the reference's scalar + vec3 overloads
(numerics.cpp:18-80).
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi

__all__ = ["almost_equal", "normalize_angle_2pi", "normalize_angle_pi"]


def almost_equal(a, b, epsilon=1e-12):
    """|a - b| < eps (reference numerics.cpp:18-21)."""
    return torch.abs(a - b) < epsilon


def normalize_angle_2pi(angle):
    """Wrap angle to [0, 2*pi) (reference numerics.cpp:23-35)."""
    wrapped = angle - torch.floor(angle / TWO_PI) * TWO_PI
    return torch.where(wrapped < 0.0, wrapped + TWO_PI, wrapped)


def normalize_angle_pi(angle):
    """Wrap angle to (-pi, pi] (reference numerics.cpp:37-49)."""
    shifted = angle + math.pi
    wrapped = shifted - torch.floor(shifted / TWO_PI) * TWO_PI
    wrapped = torch.where(wrapped < 0.0, wrapped + TWO_PI, wrapped)
    return wrapped - math.pi
