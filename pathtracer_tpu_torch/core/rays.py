"""Ray and hit-record containers, and the face-normal flip
(``core/rays.py``)."""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import vec


class Rays(NamedTuple):
    """A batch of N rays: origin, direction, shutter time."""
    origin: torch.Tensor     # (N, 3)
    direction: torch.Tensor  # (N, 3)
    time: torch.Tensor       # (N,)

    def at(self, t):
        """The point at parameter t along each ray."""
        return self.origin + t[..., None] * self.direction


class HitRecords(NamedTuple):
    """Closest-hit results for a batch of N rays."""
    p: torch.Tensor          # (N, 3) hit point
    normal: torch.Tensor     # (N, 3) face-forward normal
    mat_id: torch.Tensor     # (N,) int64
    t: torch.Tensor          # (N,)
    uv: torch.Tensor         # (N, 2)
    front_face: torch.Tensor  # (N,) bool
    valid: torch.Tensor      # (N,) bool
    prim_id: torch.Tensor    # (N,) int64
    prim_area: torch.Tensor  # (N,)


def set_face_normal(direction, outward_normal):
    """Returns (front_face, normal) with the normal opposing the ray."""
    front_face = vec.dot(direction, outward_normal) < 0.0
    normal = torch.where(front_face[..., None], outward_normal,
                         -outward_normal)
    return front_face, normal
