"""3-vector math over ``(..., 3)`` float32 tensors (``core/vec.py``).

Dot products are spelled out left to right so the summation order is fixed
on every device.
"""
from __future__ import annotations

import torch

PI = 3.1415926535897932385
PI_INV = 0.31830988618
DEG_TO_RAD = 0.01745329252
INFINITY = float("inf")

NEAR_ZERO_EPS = 1e-7


def v3(x, y, z):
    """Stack three broadcastable float32 tensors on a new last axis."""
    x, y, z = torch.broadcast_tensors(x, y, z)
    return torch.stack([x, y, z], dim=-1)


def dot(a, b, keepdim: bool = False):
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s.unsqueeze(-1) if keepdim else s


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by,
                        az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length_squared(a, keepdim: bool = False):
    return dot(a, a, keepdim=keepdim)


def length(a, keepdim: bool = False):
    return torch.sqrt(length_squared(a, keepdim=keepdim))


def normalize(a):
    """v / |v| with no epsilon (reference semantics)."""
    return a / length(a, keepdim=True)


def safe_normalize(a, eps: float = 1e-20):
    """v / sqrt(max(|v|^2, eps)): finite for v == 0."""
    return a / torch.sqrt(torch.clamp(length_squared(a, keepdim=True),
                                      min=eps))


def safe_sqrt(x):
    """sqrt(x) where x > 0, else 0."""
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def near_zero(a):
    """True where all components are < 1e-7 in magnitude."""
    return torch.all(torch.abs(a) < NEAR_ZERO_EPS, dim=-1)


def lerp(a, b, t):
    return (1.0 - t) * a + t * b


def degrees_to_radians(deg):
    return deg * DEG_TO_RAD
