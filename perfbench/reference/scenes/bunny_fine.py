"""The bunny scene with its mesh split 4:1 ``subdivide`` times, the
configuration's ``scene_args["subdivide"]``: at 4 the 3,616 faces of
``assets/bunny.obj`` become 925,696 triangles.

- The mesh: ``scene_args["obj_path"]`` (:func:`bunny.read_obj`), scaled by
  ``scene_args["scale"]`` in float32; then, ``subdivide`` times, every
  triangle (a, b, c) is split at its edge midpoints ab = (a + b) / 2, bc
  = (b + c) / 2, ca = (c + a) / 2 (float32) into the four children (a,
  ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca); the first children of
  every triangle come first, in the triangles' order, then the second,
  the third and the fourth. Then the mesh is centred on the origin in x,
  y and z by its box, and rests on y = 0; albedo (0.65, 0.55, 0.45).
- Each triangle's row: its first corner, the edges to the other two and
  the unit normal of their cross product (the cross product in float32,
  its length and the division in float64, rounded to float32).
- The rest as :mod:`perfbench.reference.scenes.bunny` has it: a grey r =
  1000 ground sphere, a mirror and a glass sphere of r = 1.5, the camera
  (0, 3, 9) looking at (0, 1.5, 0), vfov 35.

The rows come in the order the program lists them (the mesh's
triangles, then the three spheres), which decides exact ties. The
arrays are built whole, with no loop over the triangles.
"""
from __future__ import annotations

import os

import numpy as np

from perfbench.reference.scenes.bunny import read_obj
from perfbench.reference.scenes.plain import (DIELECTRIC, LAMBERTIAN, METAL,
                                              TRIANGLE, PlainScene, Recipe)

CAMERA = dict(look_from=(0.0, 3.0, 9.0), look_at=(0.0, 1.5, 0.0),
              aspect=16.0 / 9.0, vfov=35.0, aperture=0.0, focus_dist=10.0)


def split(tris: np.ndarray) -> np.ndarray:
    """(4T, 3, 3) children of (T, 3, 3) float32 triangles, in the order
    of the module's docstring."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
    ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
    return np.concatenate([np.stack(k, axis=1) for k in
                           ((a, ab, ca), (ab, b, bc), (ca, bc, c),
                            (ab, bc, ca))])


def mesh(cfg: dict, root: str) -> np.ndarray:
    """The placed (T, 3, 3) float32 triangles of the configuration."""
    args = cfg["scene_args"]
    verts, faces = read_obj(os.path.join(root, args["obj_path"]))
    tris = (verts * np.float32(args["scale"]))[faces]
    for _ in range(int(args["subdivide"])):
        tris = split(tris)
    flat = tris.reshape(-1, 3)
    lo, hi = flat.min(axis=0), flat.max(axis=0)
    tris = tris - (lo + hi) / np.float32(2.0)
    tris[..., 1] -= tris[..., 1].min()
    return tris


def build(cfg: dict, root: str) -> PlainScene:
    tris = mesh(cfg, root)
    v0 = np.ascontiguousarray(tris[:, 0])
    e1, e2 = tris[:, 1] - v0, tris[:, 2] - v0
    n = np.cross(e1, e2).astype(np.float64)
    length = np.sqrt((n * n).sum(axis=1))[:, None]
    normal = np.where(length > 0, n / np.where(length > 0, length, 1.0),
                      n).astype(np.float32)

    r = Recipe()
    r.material(LAMBERTIAN, (0.65, 0.55, 0.45))
    ground = r.material(LAMBERTIAN, (0.5, 0.5, 0.5))
    r.sphere((0, -1000, 0), 1000.0, ground)
    mirror = r.material(METAL, (0.7, 0.6, 0.5), fuzz=0.0)
    r.sphere((-4.5, 1.5, -1.0), 1.5, mirror)
    glass = r.material(DIELECTRIC, ir=1.5)
    r.sphere((4.5, 1.5, -1.0), 1.5, glass)
    balls = r.build(CAMERA)
    count = len(v0)
    return balls._replace(
        ptype=np.concatenate([np.full(count, TRIANGLE), balls.ptype]),
        v0=np.concatenate([v0, balls.v0]), e1=np.concatenate([e1, balls.e1]),
        e2=np.concatenate([e2, balls.e2]),
        radius=np.concatenate([np.zeros(count, np.float32), balls.radius]),
        normal=np.concatenate([normal, balls.normal]),
        pmat=np.concatenate([np.zeros(count, balls.pmat.dtype),
                             balls.pmat]))
