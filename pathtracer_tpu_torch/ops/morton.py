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


def clz32(x):
    """Count leading zeros of 32-bit values held in int64 (0 -> 32), by a
    binary search on shifts of 16, 8, 4, 2 and 1: torch has no clz, and a
    floating-point log2 rounds near powers of two."""
    x = x.to(torch.int64)
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        top_clear = x < (1 << (32 - s))
        n = torch.where(top_clear, n + s, n)
        x = torch.where(top_clear, x << s, x)
    return torch.where(x == 0, 32, n)


def clz64_pair(code_a, id_a, code_b, id_b):
    """clz of (code << 32 | id)_a XOR (code << 32 | id)_b, the 64-bit
    Morton key of the reference's LBVH, from (code, id) pairs. Codes are
    below 2^30 and ids below 2^31, so int64 xor gives the uint32 bits."""
    hi = code_a ^ code_b
    lo = id_a.to(torch.int64) ^ id_b.to(torch.int64)
    return torch.where(hi == 0, 32 + clz32(lo), clz32(hi))
