"""Scene registry (``scene/worlds.py``): the reference's test, triangle and
random worlds with their cameras, plus the Cornell, bunny and combined
scenes by name.

The triangle and random worlds draw from numpy's ``default_rng`` in the
reference's order, so both packages build bit-equal scenes from a seed.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from pathtracer_tpu_torch.config import K_ASPECT_RATIO
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder


def _rand_in_unit_sphere(rng: np.random.Generator) -> np.ndarray:
    """Rejection sampler in the unit ball."""
    while True:
        p = 2.0 * rng.random(3, dtype=np.float64) - 1.0
        if p @ p < 1.0:
            return p.astype(np.float32)


def _camera(look_from, vfov, device) -> Camera:
    return make_camera(look_from, (0, 0, 0), vfov, K_ASPECT_RATIO,
                       aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                       device=device)


def test_world(device="cuda") -> Tuple[Scene, Camera]:
    """Two mirror-image metal triangles and a blue r=1000 lambertian sphere
    at (1005, 0, 0); camera (0, 0, 15) looking at the origin, vfov 20."""
    b = SceneBuilder()
    m0 = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_triangle((0, -2, 0), (1, 0, 5), (0, 2, 0), m0)
    m1 = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_triangle((0, -2, 0), (-1, 0, 5), (0, 2, 0), m1)
    m2 = b.add_lambertian((0, 0, 1))
    b.add_sphere((1005, 0, 0), 1000.0, m2)
    return b.build(device=device), _camera((0, 0, 15), 20, device)


def triangle_world(seed: int = 1, total_count: int = 600,
                   device="cuda") -> Tuple[Scene, Camera]:
    """The reference's active scene: ``total_count`` objects, half r=0.5
    spheres and half random triangles inside an r=10 ball, materials by
    thresholds, a grey r=1000 backdrop at (0, 0, -1010); camera (0, 0, 25),
    vfov 40."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    radius = 10.0
    for _ in range(total_count):
        choose_mat = rng.random() * 2.0
        center = _rand_in_unit_sphere(rng) * radius
        rand1 = rng.random(3).astype(np.float32)
        rand2 = rng.random(3).astype(np.float32)
        if choose_mat < 1.0:
            if choose_mat < 0.6:
                mat = b.add_lambertian(rand1 * rand2)
            elif choose_mat < 0.9:
                mat = b.add_metal(rand1 / 2 + 0.5, rand2[0] / 2)
            else:
                mat = b.add_dielectric(1.5)
            b.add_sphere(center, 0.5, mat)
        else:
            v0 = _rand_in_unit_sphere(rng) + center
            v1 = _rand_in_unit_sphere(rng) + center
            v2 = _rand_in_unit_sphere(rng) + center
            if choose_mat < 1.6:
                mat = b.add_lambertian(rand1 * rand2)
            elif choose_mat < 1.9:
                mat = b.add_metal(rand1 / 2 + 0.5, rand2[0] / 2)
            else:
                mat = b.add_dielectric(1.5)
            b.add_triangle(v0, v1, v2, mat)
    grey = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -1010), 1000.0, grey)
    return b.build(device=device), _camera((0, 0, 25), 40, device)


def random_world(seed: int = 2, device="cuda") -> Tuple[Scene, Camera]:
    """The RTIOW final scene: ground r=1000 at (0, -1000, 0), a 20x20 grid
    of r=0.2 spheres (80% diffuse, 15% metal, 5% glass), three r=1 hero
    spheres including a hollow glass one (outer r=1, inner r=-0.9 sharing
    one material); camera (0, 30, 0.1), vfov 20."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, -1000, 0), 1000.0, ground)
    n = 10
    for i in range(-n, n):
        for j in range(-n, n):
            choose_mat = rng.random()
            center = (float(i), 0.2, float(j))
            rand1 = rng.random(3).astype(np.float32)
            rand2 = rng.random(3).astype(np.float32)
            if choose_mat < 0.8:
                mat = b.add_lambertian(rand1 * rand2)
            elif choose_mat < 0.95:
                mat = b.add_metal(rand1 / 2 + 0.5, rand2[0] / 2)
            else:
                mat = b.add_dielectric(1.5)
            b.add_sphere(center, 0.2, mat)
    glass = b.add_dielectric(1.5)
    b.add_sphere((4, 1, 0), 1.0, glass)
    b.add_sphere((4, 1, 0), -0.9, glass)
    red = b.add_lambertian((1, 0, 0.4))
    b.add_sphere((-4, 1, 0), 1.0, red)
    mirror = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((0, 1, 0), 1.0, mirror)
    return b.build(device=device), _camera((0, 30, 0.1), 20, device)


# pytest would otherwise collect the factory as a test
test_world.__test__ = False

WORLDS = {
    "test": test_world,
    "triangle": triangle_world,
    "random": random_world,
}


def get_world(name: str, device="cuda", **kw) -> Tuple[Scene, Camera]:
    """(scene, camera) of a named scene on ``device``: test, triangle,
    random, cornell, bunny, bunny_fine or combined. "bunny_fine" is the
    bunny world split 4:1 ``subdivide`` times (a required keyword, at
    least 1): :func:`~pathtracer_tpu_torch.scene.bunny.bunny_world` with
    that ``subdivide``."""
    if name in WORLDS:
        return WORLDS[name](device=device, **kw)
    if name == "cornell":
        from pathtracer_tpu_torch.scene.cornell import cornell_box
        return cornell_box(device=device, **kw)
    if name == "bunny":
        from pathtracer_tpu_torch.scene.bunny import bunny_world
        return bunny_world(device=device, **kw)
    if name == "bunny_fine":
        from pathtracer_tpu_torch.scene.bunny import bunny_world
        level = kw.pop("subdivide", None)
        if level is None or int(level) < 1:
            raise ValueError(f"scene 'bunny_fine' needs subdivide >= 1, got "
                             f"{level!r}")
        return bunny_world(device=device, subdivide=int(level), **kw)
    if name == "combined":
        from pathtracer_tpu_torch.presets import combined_scene
        return combined_scene(device=device, **kw)
    raise ValueError(f"unknown scene {name!r}; available: "
                     f"test/triangle/random/cornell/bunny/bunny_fine/combined")
