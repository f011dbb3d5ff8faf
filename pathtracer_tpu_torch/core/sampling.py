"""Analytic samplers over pre-drawn uniforms, and the Owen-scrambled Sobol
pixel filter (``core/sampling.py``).

The Sobol sampler is pure uint32 bit arithmetic. torch has no usable
uint32 arithmetic, so, as in ``core/random``, words live in int64 tensors
and every sum and product is masked to 32 bits; a product of two 32-bit
words is formed from 16-bit halves (:func:`_mul32`) so that it never leaves
int64. The results are bit-equal to the reference's.
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


def uniform_on_hemisphere(u1, u2, normal):
    """Uniform direction in the hemisphere around ``normal``: a sphere
    sample, flipped to the normal's side."""
    d = uniform_on_sphere(u1, u2)
    return torch.where(vec.dot(d, normal, keepdim=True) > 0.0, d, -d)


def uniform_in_disk(u1, u2):
    """Uniform point in the unit disk, z = 0."""
    r = torch.sqrt(u1)
    theta = TWO_PI * u2
    return vec.v3(r * torch.cos(theta), r * torch.sin(theta),
                  torch.zeros_like(r))


def uniform_in_range(lo, hi, u):
    """u in [lo, hi); 0 when hi <= lo."""
    return torch.where(hi <= lo, torch.zeros_like(u), u * (hi - lo) + lo)


# ---------------------------------------------------------------------------
# Owen-scrambled Sobol (pixel filter): sample s of pixel p is a point of a
# per-pixel Owen-scrambled 2-D Sobol sequence (Laine-Karras hash scrambling)

_MASK = 0xFFFFFFFF


def _sobol_dir_1():
    """The 32 direction numbers of Sobol dimension 1 (polynomial x + 1)."""
    v = [1 << 31]
    for _ in range(1, 32):
        v.append(v[-1] ^ (v[-1] >> 1))
    return v


_SOBOL_DIR_1 = _sobol_dir_1()


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 32-bit words x (int64 tensor) and c (Python
    int), from c's 16-bit halves: x * c_lo and x * c_hi stay below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _reverse_bits32(x):
    x = ((x >> 16) | (x << 16)) & _MASK
    m = 0x00FF00FF
    x = ((x >> 8) & m) | ((x & m) << 8)
    m = 0x0F0F0F0F
    x = ((x >> 4) & m) | ((x & m) << 4)
    m = 0x33333333
    x = ((x >> 2) & m) | ((x & m) << 2)
    m = 0x55555555
    x = ((x >> 1) & m) | ((x & m) << 1)
    return x


def _laine_karras(x, seed):
    """Hash-based Owen scramble in the bit-reversed domain."""
    x = (x + seed) & _MASK
    x = x ^ _mul32(x, 0x6C50B47C)
    x = x ^ _mul32(x, 0xB82F1E52)
    x = x ^ _mul32(x, 0xC7AFE638)
    x = x ^ _mul32(x, 0x8D22F6E6)
    return x


def _owen_scramble(x, seed):
    return _reverse_bits32(_laine_karras(_reverse_bits32(x), seed))


def _hash32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def sobol_owen_2d(sample_index, pixel_id, seed: int):
    """Per-pixel Owen-scrambled 2-D Sobol point for ``sample_index``.

    ``sample_index``: the global sample number (Python int, or an integer
    tensor that broadcasts against ``pixel_id``); ``pixel_id``: (R,)
    integer tensor, each lane's pixel; ``seed``: Python int. Returns (xi0,
    xi1), each (R,) float32 in [0, 1). Each pixel shuffles the sample order
    and scrambles both dimensions with keys hashed from (pixel, seed), so
    neighbouring pixels decorrelate while each keeps the sequence's
    stratification."""
    pid = pixel_id.to(torch.int64) & _MASK
    base = _hash32(pid ^ ((seed * 0x9E3779B9 + 0x632BE59B) & _MASK))
    idx = torch.as_tensor(sample_index, dtype=torch.int64,
                          device=pid.device) & _MASK
    idx = _owen_scramble(idx.expand_as(pid), _hash32(base ^ 0xA341316C))

    d0 = _reverse_bits32(idx)                # dim 0: van der Corput
    d1 = torch.zeros_like(idx)               # dim 1: direction numbers
    for j, v in enumerate(_SOBOL_DIR_1):
        d1 = d1 ^ (((idx >> j) & 1) * v)
    d0 = _owen_scramble(d0, _hash32(base ^ 0x51633E2D))
    d1 = _owen_scramble(d1, _hash32(base ^ 0x68BC21EB))
    scale = 1.0 / (1 << 24)
    return ((d0 >> 8).to(torch.float32) * scale,
            (d1 >> 8).to(torch.float32) * scale)
