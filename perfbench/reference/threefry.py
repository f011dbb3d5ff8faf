"""Counter-based threefry2x32 streams, as ``jax.random`` draws them in its
partitionable mode (the draws the renderer under test makes).

A key is a pair of 32-bit words. Words are held in int64 tensors or Python
ints, and every sum is masked to 32 bits.

- ``key(seed) = (seed >> 32, seed & 0xFFFFFFFF)``;
- ``fold_in(k, x) = threefry(k, (0, x))``; ``split(k, n)[i] = threefry(k,
  (0, i))``;
- element ``i`` of ``uniform(k, shape)`` hashes the 64-bit counter ``(i >>
  32, i & 0xFFFFFFFF)``, xors the two output words and maps their top 23
  bits into [1, 2), minus 1;
- row ``r`` of the by-ray draws is ``uniform(fold_in(k, rid[r]), (m,))``.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """20 rounds of threefry2x32 on words that broadcast; returns (y0,
    y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int):
    seed = int(seed)
    return ((seed >> 32) & MASK, seed & MASK)


def fold_in(k, data):
    """``data``: a Python int or an int64 tensor of words."""
    if isinstance(data, int):
        data &= MASK
    return threefry2x32(k[0], k[1], 0, data)


def split(k, num: int):
    return [threefry2x32(k[0], k[1], 0, i) for i in range(num)]


def to_unit(bits):
    """uint32 words (int64) -> float32 in [0, 1)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform_at(k, index):
    """Element ``index`` (int64 tensor of flat indices) of ``uniform(k,
    shape)``, whatever the shape."""
    y0, y1 = threefry2x32(k[0], k[1], index >> 32, index & MASK)
    return to_unit(y0 ^ y1)


def uniform_rows(k, rid, m: int):
    """(R, m): row r is ``uniform(fold_in(k, rid[r]), (m,))``; the key
    words may be per-ray tensors (R,)."""
    rid = rid & MASK
    kk0, kk1 = threefry2x32(k[0], k[1], torch.zeros_like(rid), rid)
    ctr = torch.arange(m, dtype=torch.int64, device=rid.device)[None, :]
    y0, y1 = threefry2x32(kk0[:, None], kk1[:, None], torch.zeros_like(ctr),
                          ctr)
    return to_unit(y0 ^ y1)
