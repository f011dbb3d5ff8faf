"""The Cornell box, lit only by its ceiling light (emission 15), in the
published data's units (graphics.cornell.edu/online/box/data.html: a room
of about 555 on a side, the light a 130 x 105 patch just under the
ceiling at y = 548.7, a short and a tall block):

- "full": the blocks, a mirror sphere, a glass sphere, a sphere with an
  8 x 16 checker texture and one with ``assets/textures/marble.png``;
- "spheres": a red and a blue diffuse sphere instead.

Camera (278, 273, -800) looking at (278, 273, 0), vfov 40, at the open
front face. The configuration's ``scene_args`` give ``variant`` (default
"full") and ``aspect`` (default 1). The rows come in the order the
program's scene lists them (floor, ceiling and back wall; left wall;
right wall; light; the variant's objects), which decides exact ties.
"""
from __future__ import annotations

import os

import numpy as np

from perfbench.reference.scenes.plain import (DIELECTRIC, EMISSIVE,
                                              LAMBERTIAN, METAL, PlainScene,
                                              Recipe)

FLOOR = [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
         (549.6, 0.0, 559.2)]
CEILING = [(556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2),
           (0.0, 548.8, 0.0)]
BACK = [(549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
        (556.0, 548.8, 559.2)]
LEFT = [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
        (556.0, 548.8, 0.0)]
RIGHT = [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
         (0.0, 548.8, 559.2)]
LIGHT = [(343.0, 548.7, 227.0), (343.0, 548.7, 332.0),
         (213.0, 548.7, 332.0), (213.0, 548.7, 227.0)]
# the blocks' top faces; each side runs from the floor up to a top edge
SHORT_TOP = [(130.0, 165.0, 65.0), (82.0, 165.0, 225.0),
             (240.0, 165.0, 272.0), (290.0, 165.0, 114.0)]
TALL_TOP = [(423.0, 330.0, 247.0), (265.0, 330.0, 296.0),
            (314.0, 330.0, 456.0), (472.0, 330.0, 406.0)]


def _quad(r: Recipe, q, mat, fan: bool = True):
    """Two triangles of the quad ``q``: (0, 1, 2), (0, 2, 3), or with
    ``fan`` False (0, 1, 2), (2, 3, 0), the corner order of the walls of
    the published data's first part."""
    r.triangle(q[0], q[1], q[2], mat)
    if fan:
        r.triangle(q[0], q[2], q[3], mat)
    else:
        r.triangle(q[2], q[3], q[0], mat)


def _block(r: Recipe, top, mat):
    """The top quad, then a side quad under each top edge (a, b):
    (a on the floor, a, b, b on the floor)."""
    _quad(r, top, mat)
    for j in range(4):
        a, b = top[j], top[(j + 1) % 4]
        _quad(r, [(a[0], 0.0, a[2]), a, b, (b[0], 0.0, b[2])], mat)


def checker() -> np.ndarray:
    """8 x 16 texels: cream where row + column is even, blue elsewhere."""
    y, x = np.mgrid[0:8, 0:16]
    even = ((y + x) % 2 == 0)[..., None]
    return np.where(even, np.float32([0.9, 0.9, 0.85]),
                    np.float32([0.15, 0.25, 0.5])).astype(np.float32)


def read_texture(path: str) -> np.ndarray:
    """The RGB channels of an 8-bit PNG as f32 in [0, 1], row 0 at the
    top."""
    from PIL import Image
    with Image.open(path) as im:
        if im.mode not in ("RGB", "RGBA"):
            raise ValueError(f"{path}: expected an RGB(A) PNG, got "
                             f"{im.mode}")
        texels = np.asarray(im, np.uint8)
    return texels[..., :3].astype(np.float32) / np.float32(255.0)


def build(cfg: dict, root: str) -> PlainScene:
    args = cfg.get("scene_args", {})
    variant = args.get("variant", "full")
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
    if variant == "full":
        _block(r, SHORT_TOP, white)
        _block(r, TALL_TOP, white)
        metal = r.material(METAL, (0.8, 0.85, 0.88), fuzz=0.0)
        r.sphere((400.0, 240.0, 190.0), 75.0, metal)
        glass = r.material(DIELECTRIC, ir=1.5)
        r.sphere((160.0, 420.0, 360.0), 90.0, glass)
        checked = r.material(LAMBERTIAN, (1.0, 1.0, 1.0),
                             tex_id=r.texture(checker()))
        r.sphere((420.0, 90.0, 400.0), 90.0, checked)
        marble = r.texture(read_texture(
            os.path.join(root, "assets", "textures", "marble.png")))
        marbled = r.material(LAMBERTIAN, (1.0, 1.0, 1.0), tex_id=marble)
        r.sphere((120.0, 75.0, 147.0), 75.0, marbled)
    elif variant == "spheres":
        s1 = r.material(LAMBERTIAN, (0.8, 0.3, 0.3))
        s2 = r.material(LAMBERTIAN, (0.3, 0.3, 0.8))
        r.sphere((185.0, 120.0, 169.0), 120.0, s1)
        r.sphere((368.0, 90.0, 351.0), 90.0, s2)
    else:
        raise ValueError(f"unknown Cornell variant {variant!r}")
    return r.build(dict(look_from=(278.0, 273.0, -800.0),
                        look_at=(278.0, 273.0, 0.0),
                        aspect=float(args.get("aspect", 1.0)), vfov=40.0,
                        aperture=0.0, focus_dist=10.0))
