"""The triangle world: ``total_count`` objects inside an r = 10 ball,
drawn from numpy's ``default_rng(seed)``, each a r = 0.5 sphere or a
triangle of three points within a unit ball of its centre, its material
picked by thresholds; a grey r = 1000 backdrop at (0, 0, -1010); camera
(0, 0, 25) looking at the origin, vfov 40."""
from __future__ import annotations

import numpy as np

from perfbench.reference.scenes.plain import (DIELECTRIC, LAMBERTIAN, METAL,
                                              PlainScene, Recipe)


def _in_unit_ball(rng):
    while True:
        p = 2.0 * rng.random(3, dtype=np.float64) - 1.0
        if p @ p < 1.0:
            return p.astype(np.float32)


def build(cfg: dict, root: str) -> PlainScene:
    args = cfg["scene_args"]
    rng = np.random.default_rng(args["seed"])
    r = Recipe()
    for _ in range(args["total_count"]):
        choose = rng.random() * 2.0
        center = _in_unit_ball(rng) * 10.0
        rand1 = rng.random(3).astype(np.float32)
        rand2 = rng.random(3).astype(np.float32)
        base = 0.0 if choose < 1.0 else 1.0
        if choose < base + 0.6:
            mat = r.material(LAMBERTIAN, rand1 * rand2)
        elif choose < base + 0.9:
            mat = r.material(METAL, rand1 / 2 + 0.5, fuzz=rand2[0] / 2)
        else:
            mat = r.material(DIELECTRIC, ir=1.5)
        if choose < 1.0:
            r.sphere(center, 0.5, mat)
        else:
            a = _in_unit_ball(rng) + center
            b = _in_unit_ball(rng) + center
            c = _in_unit_ball(rng) + center
            r.triangle(a, b, c, mat)
    grey = r.material(LAMBERTIAN, (0.5, 0.5, 0.5))
    r.sphere((0, 0, -1010), 1000.0, grey)
    return r.build(dict(look_from=(0.0, 0.0, 25.0), look_at=(0.0, 0.0, 0.0),
                        aspect=16.0 / 9.0, vfov=40.0, aperture=0.0,
                        focus_dist=10.0))
