"""The combined scene of BASELINE.json config 5: the bunny mesh standing on
the floor of the Cornell room, between a mirror and a glass sphere of r =
90, lit only by the room's ceiling light (emission 15).

- The room: the floor, ceiling and back wall (white), the left (red) and
  right (green) walls and the ceiling light, the quads of
  :mod:`perfbench.reference.scenes.cornell`, without its blocks and
  spheres.
- The mesh: ``scene_args["obj_path"]`` (:func:`bunny.read_obj`), in
  float64 scaled to 250 along its longest extent about the centre of its
  box, resting on y = 0, offset by (278, 0, 280), then rounded to float32;
  albedo (0.65, 0.55, 0.45).
- The spheres: a mirror (0.8, 0.85, 0.88) at (120, 90, 150) and a glass
  one (index 1.5) at (430, 90, 150).

Camera (278, 273, -800) looking at (278, 273, 0), vfov 40, aspect 16:9.
The rows come in the order the program's scene lists them (the room as
the Cornell recipe lists it, the mesh's faces, the mirror, the glass),
which decides exact ties. The configuration must name the mesh: the
program's own fallbacks (``PT_BUNNY_OBJ``, then a procedural stand-in
where no file is found) are not followed here.
"""
from __future__ import annotations

import os

import numpy as np

from perfbench.reference.scenes.bunny import read_obj
from perfbench.reference.scenes.cornell import (BACK, CEILING, FLOOR, LEFT,
                                                LIGHT, RIGHT, _quad)
from perfbench.reference.scenes.plain import (DIELECTRIC, EMISSIVE,
                                              LAMBERTIAN, METAL, PlainScene,
                                              Recipe)

SIZE = 250.0
OFFSET = (278.0, 0.0, 280.0)


def placed(verts: np.ndarray) -> np.ndarray:
    """The mesh's vertices as the scene places them, float32."""
    v = verts.astype(np.float64)
    lo, hi = v.min(axis=0), v.max(axis=0)
    scale = SIZE / float((hi - lo).max())
    v = (v - (lo + hi) / 2.0) * scale
    v[:, 1] -= v[:, 1].min()
    v += np.array(OFFSET)
    return v.astype(np.float32)


def build(cfg: dict, root: str) -> PlainScene:
    verts, faces = read_obj(os.path.join(root, cfg["scene_args"]["obj_path"]))
    verts = placed(verts)
    r = Recipe()
    white = r.material(LAMBERTIAN, (0.73, 0.73, 0.73))
    red = r.material(LAMBERTIAN, (0.65, 0.05, 0.05))
    green = r.material(LAMBERTIAN, (0.12, 0.45, 0.15))
    light = r.material(EMISSIVE, emit=(15.0, 15.0, 15.0))
    _quad(r, FLOOR, white, fan=False)
    _quad(r, CEILING, white, fan=False)
    _quad(r, BACK, white, fan=False)
    _quad(r, LEFT, red)
    _quad(r, RIGHT, green)
    _quad(r, LIGHT, light)
    skin = r.material(LAMBERTIAN, (0.65, 0.55, 0.45))
    for a, b, c in faces:
        r.triangle(verts[a], verts[b], verts[c], skin)
    mirror = r.material(METAL, (0.8, 0.85, 0.88), fuzz=0.0)
    r.sphere((120.0, 90.0, 150.0), 90.0, mirror)
    glass = r.material(DIELECTRIC, ir=1.5)
    r.sphere((430.0, 90.0, 150.0), 90.0, glass)
    return r.build(dict(look_from=(278.0, 273.0, -800.0),
                        look_at=(278.0, 273.0, 0.0), aspect=16.0 / 9.0,
                        vfov=40.0, aperture=0.0, focus_dist=10.0))
