"""The reference's RTIOW random world, bit for bit
(``scene/reference_world.py``).

The original C++ program draws the world's material randomness from a
default-seeded ``std::mt19937`` (seed 5489) through
``uniform_real_distribution<float>(0, 1)``. The sphere positions are
fixed (a 20x20 integer grid at (i, 0.2, j), the ground, three hero
spheres); only the material classes and colours take draws, 7 per grid
cell in declaration order. Reproducing the engine reproduces the scene.

``uniform_real_distribution<float>`` reduces to one 32-bit engine draw
scaled by 2^-32 in libstdc++ and MSVC, which is what :func:`_mt19937_f32`
computes.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from pathtracer_tpu_torch.config import K_ASPECT_RATIO
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder


class MT19937:
    """C++11 ``std::mt19937`` (32-bit Mersenne twister): state transition
    and tempering per the C++ standard [rand.eng.mers]."""

    N, M = 624, 397
    MATRIX_A = 0x9908B0DF
    UPPER = 0x80000000
    LOWER = 0x7FFFFFFF

    def __init__(self, seed: int = 5489):
        mt = np.empty(self.N, np.uint64)
        mt[0] = seed
        for i in range(1, self.N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30)))
                     + i) & 0xFFFFFFFF
        self._mt = mt.astype(np.uint32)
        self._idx = self.N

    def _generate(self):
        mt = self._mt.astype(np.uint32)
        for i in range(self.N):
            y = (mt[i] & self.UPPER) | (mt[(i + 1) % self.N] & self.LOWER)
            nxt = mt[(i + self.M) % self.N] ^ (y >> np.uint32(1))
            if y & 1:
                nxt ^= self.MATRIX_A
            mt[i] = nxt
        self._mt = mt
        self._idx = 0

    def next_u32(self) -> int:
        if self._idx >= self.N:
            self._generate()
        y = int(self._mt[self._idx])
        self._idx += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


def _mt19937_f32(gen: MT19937) -> np.float32:
    """``uniform_real_distribution<float>(0, 1)``: one draw scaled by
    2^-32."""
    return np.float32(np.float32(gen.next_u32()) * np.float32(2.0 ** -32))


def reference_random_world(sample_num: int = 10,
                           device="cuda") -> Tuple[Scene, Camera]:
    """The RTIOW final world of the original program, with its camera
    (0, 30, 0.1) looking at the origin, vfov 20, on ``device``."""
    gen = MT19937()

    def rnd():
        return _mt19937_f32(gen)

    b = SceneBuilder()
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, -1000, 0), 1000.0, ground)

    for i in range(-sample_num, sample_num):
        for j in range(-sample_num, sample_num):
            choose_mat = rnd()
            center = (float(i), 0.2, float(j))
            rand1 = np.array([rnd(), rnd(), rnd()], np.float32)
            rand2 = np.array([rnd(), rnd(), rnd()], np.float32)
            if choose_mat < 0.8:
                mat = b.add_lambertian(rand1 * rand2)
            elif choose_mat < 0.95:
                mat = b.add_metal(rand1 / 2 + 0.5, float(rand2[0] / 2))
            else:
                mat = b.add_dielectric(1.5)
            b.add_sphere(center, 0.2, mat)

    glass = b.add_dielectric(1.5)
    b.add_sphere((4, 1, 0), 1.0, glass)
    b.add_sphere((4, 1, 0), -0.9, glass)   # hollow inner shell
    pink = b.add_lambertian((1.0, 0.0, 0.4))
    b.add_sphere((-4, 1, 0), 1.0, pink)
    mirror = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((0, 1, 0), 1.0, mirror)

    cam = make_camera((0, 30, 0.1), (0, 0, 0), 20, K_ASPECT_RATIO,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam
