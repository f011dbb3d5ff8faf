"""Analytic samplers over pre-drawn uniforms (``core/sampling.py``).

Only the samplers the slice runs are here; the Owen-scrambled Sobol sampler
is ROADMAP Queue 1, item 8.
"""
from __future__ import annotations

import torch

from pathtracer_tpu_torch.core import vec

TWO_PI = 2.0 * vec.PI


def uniform_on_sphere(u1, u2):
    """Uniform direction on the unit sphere: phi = 2 pi u1,
    cos(theta) = 1 - 2 u2. Returns (..., 3)."""
    phi = TWO_PI * u1
    cos_theta = 1.0 - 2.0 * u2
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=0.0))
    return vec.v3(torch.cos(phi) * sin_theta, torch.sin(phi) * sin_theta,
                  cos_theta)


def uniform_in_sphere(u1, u2, u3):
    """Uniform point in the unit ball (u3 in [0, 1), so the cube root is
    a plain power)."""
    return uniform_on_sphere(u1, u2) * torch.pow(u3, 1.0 / 3.0)[..., None]


def uniform_in_disk(u1, u2):
    """Uniform point in the unit disk, z = 0."""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return vec.v3(r * torch.cos(theta), r * torch.sin(theta),
                  torch.zeros_like(r))


def uniform_in_range(lo, hi, u):
    """u in [lo, hi); 0 when hi <= lo."""
    return torch.where(hi <= lo, torch.zeros_like(u), u * (hi - lo) + lo)
