"""Mirror reflection, Snell refraction, Schlick reflectance
(``core/optics.py``)."""
from __future__ import annotations

import torch

from pathtracer_tpu_torch.core import vec


def reflect(v, n):
    return v - 2.0 * vec.dot(v, n, keepdim=True) * n


def refract(uv, n, etai_over_etat):
    """Snell refraction; ``uv`` unit length, eta (N,) or (N, 1)."""
    eta = etai_over_etat
    if eta.dim() == uv.dim() - 1:
        eta = eta[..., None]
    cos_theta = torch.clamp(vec.dot(-uv, n, keepdim=True), max=1.0)
    r_out_perp = eta * (uv + cos_theta * n)
    a = torch.abs(1.0 - vec.length_squared(r_out_perp, keepdim=True))
    r_out_parallel = -vec.safe_sqrt(a) * n
    return r_out_perp + r_out_parallel


def reflectance(cosine, ref_idx):
    """Schlick's approximation."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * torch.pow(1.0 - cosine, 5.0)
