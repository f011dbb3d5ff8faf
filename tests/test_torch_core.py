"""The port's small ``core/`` names against the JAX reference:
``rays.Rays`` (and its ``at``), ``sampling.uniform_on_hemisphere``,
``vec.lerp`` and ``vec.INFINITY``, on seeded numpy inputs.

Tolerances: ``Rays.at``, ``lerp`` and ``INFINITY`` are bit-equal (the same
float32 products and sums per element). ``uniform_on_hemisphere`` agrees
to rtol 1e-6: the sphere sample goes through ``cos``/``sin``, whose last
bit may differ between XLA's CPU kernels and PyTorch's.
"""
import math

import jax.numpy as jnp
import numpy as np
import torch

from pathtracer_tpu.core import rays as jrays
from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu.core import vec as jvec
from pathtracer_tpu_torch.core import rays as trays
from pathtracer_tpu_torch.core import sampling as tsampling
from pathtracer_tpu_torch.core import vec as tvec

torch.set_num_threads(1)


def _f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def test_rays_at():
    rng = np.random.default_rng(11)
    o, d = _f32(rng, 257, 3, lo=-50, hi=50), _f32(rng, 257, 3)
    time, t = _f32(rng, 257, lo=0, hi=1), _f32(rng, 257, lo=0, hi=100)
    j = jrays.Rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(time))
    r = trays.Rays(torch.from_numpy(o), torch.from_numpy(d),
                   torch.from_numpy(time))
    assert r._fields == j._fields
    np.testing.assert_array_equal(r.at(torch.from_numpy(t)).numpy(),
                                  np.asarray(j.at(jnp.asarray(t))))


def test_uniform_on_hemisphere():
    rng = np.random.default_rng(12)
    u1, u2 = _f32(rng, 4096, lo=0, hi=1), _f32(rng, 4096, lo=0, hi=1)
    normal = _f32(rng, 4096, 3)
    j = np.asarray(jsampling.uniform_on_hemisphere(
        jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(normal)))
    t = tsampling.uniform_on_hemisphere(
        torch.from_numpy(u1), torch.from_numpy(u2),
        torch.from_numpy(normal)).numpy()
    assert t.dtype == np.float32 and t.shape == (4096, 3)
    np.testing.assert_allclose(t, j, rtol=1e-6)
    assert ((t * normal).sum(-1) >= 0).all()


def test_lerp():
    rng = np.random.default_rng(13)
    a, b = _f32(rng, 300, 3, lo=-10, hi=10), _f32(rng, 300, 3, lo=-10, hi=10)
    t = _f32(rng, 300, 1, lo=0, hi=1)
    np.testing.assert_array_equal(
        tvec.lerp(torch.from_numpy(a), torch.from_numpy(b),
                  torch.from_numpy(t)).numpy(),
        np.asarray(jvec.lerp(jnp.asarray(a), jnp.asarray(b),
                             jnp.asarray(t))))


def test_infinity():
    assert tvec.INFINITY == jvec.INFINITY == math.inf
    assert type(tvec.INFINITY) is float
