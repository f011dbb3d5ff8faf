"""Counter-based threefry2x32 that reproduces ``jax.random``'s bits.

The reference draws every random number from ``jax.random`` with the
threefry2x32 generator in its partitionable mode
(``jax_threefry_partitionable=True``, the default of JAX 0.9). This module
computes the same bits in PyTorch, so a render of the port at a given seed
matches the reference render pixel for pixel. A sequential
``torch.Generator`` cannot do this: the sorted wavefront permutes lanes
every bounce, so each draw must be a pure function of (key, ray id).

Semantics, in the reference's terms:

- a key is a pair of uint32 words; ``PRNGKey(seed) = (seed >> 32, seed)``;
- ``fold_in(key, x) = threefry(key, (0, x))``;
- ``split(key, n)[i] = threefry(key, (0, i))``;
- ``uniform(key, shape)`` hashes the flat index ``i`` of every element as
  the 64-bit counter ``(i >> 32, i & 0xFFFFFFFF)``, xors the two output
  words, and maps the top 23 bits into [1, 2) minus 1.

torch has no usable uint32 arithmetic, so words live in int64 tensors (or
Python ints, for scalar keys) and every sum is masked to 32 bits. The same
``threefry2x32`` code serves both.

:func:`uniform` and :func:`uniform_by_ray` are the plain twins of the draws
kernel (``csrc/ray_uniforms.cu``). The renderer and the integrator draw
through its wrapper, ``ops/uniforms``, which launches the kernel for a
CUDA device and calls these twins for the CPU.
"""
from __future__ import annotations

from typing import Tuple

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

Key = Tuple[int, int]


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The threefry2x32 block function (20 rounds) on 32-bit words held in
    int64 tensors or Python ints; arguments broadcast. Returns (y0, y1)."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def PRNGKey(seed: int) -> Key:
    seed = int(seed)
    return ((seed >> 32) & _MASK, seed & _MASK)


def fold_in(key: Key, data: int) -> Key:
    return threefry2x32(key[0], key[1], 0, int(data) & _MASK)


def split(key: Key, num: int = 2) -> list:
    return [threefry2x32(key[0], key[1], 0, i) for i in range(num)]


def _bits_to_unit_float(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words (int64) -> float32 in [0, 1): set-exponent trick."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def uniform(key: Key, shape, device) -> torch.Tensor:
    """float32 uniforms in [0, 1), bit-equal to
    ``jax.random.uniform(key, shape, jnp.float32)``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    idx = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key[0], key[1], idx >> 32, idx & _MASK)
    return _bits_to_unit_float(y0 ^ y1).reshape(shape)


def uniform_by_ray(key: Key, rid: torch.Tensor, m: int) -> torch.Tensor:
    """(R, m) uniforms keyed by ray id: row r equals
    ``jax.random.uniform(jax.random.fold_in(key, rid[r]), (m,))`` (the
    reference's ``integrator._uniform_by_ray``)."""
    rid = rid.to(torch.int64) & _MASK
    kk0, kk1 = threefry2x32(key[0], key[1], torch.zeros_like(rid), rid)
    ctr = torch.arange(m, dtype=torch.int64, device=rid.device)[None, :]
    y0, y1 = threefry2x32(kk0[:, None], kk1[:, None], torch.zeros_like(ctr),
                          ctr)
    return _bits_to_unit_float(y0 ^ y1)
