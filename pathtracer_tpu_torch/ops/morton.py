"""Morton (Z-order) codes (``ops/morton.py``).

uint32 arithmetic is emulated in int64: every intermediate here stays
below 2^32, and each multiply is masked by a constant below 2^32, so the
wrapped uint32 result of the reference equals the masked int64 result.
"""
from __future__ import annotations

import torch


def expand_bits(v):
    """10-bit -> 30-bit interleave on int64 tensors."""
    v = v.to(torch.int64)
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(center, world_min, world_max):
    """Quantize box centers to 10 bits per axis inside [world_min,
    world_max] and interleave, x highest. center: (..., 3). Returns int64
    codes below 2^30."""
    rng = world_max - world_min
    safe = rng > 1e-7
    norm = torch.where(safe, (center - world_min) / torch.where(safe, rng,
                                                                 1.0), 0.0)
    q = torch.clamp(norm * 1024.0, 0.0, 1023.0).to(torch.int64)
    xx = expand_bits(q[..., 0])
    yy = expand_bits(q[..., 1])
    zz = expand_bits(q[..., 2])
    return (xx << 2) + (yy << 1) + zz
