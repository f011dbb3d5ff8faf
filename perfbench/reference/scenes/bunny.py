"""The bunny scene: the OBJ mesh scaled by 20, centred on the origin in x
and z and resting on y = 0, over a grey r = 1000 ground sphere, between a
mirror and a glass sphere of r = 1.5; camera (0, 3, 9) looking at (0, 1.5,
0), vfov 35."""
from __future__ import annotations

import os

import numpy as np

from perfbench.reference.scenes.plain import (DIELECTRIC, LAMBERTIAN, METAL,
                                              PlainScene, Recipe)


def read_obj(path: str):
    """(vertices (V, 3) f32, faces (F, 3) int) of the ``v`` and ``f``
    records; polygons fan out around their first vertex, ``a/b/c`` tokens
    count by their first index, negative indices count back."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "v" and len(tok) >= 4:
                verts.append([float(x) for x in tok[1:4]])
            elif tok[0] == "f":
                idx = []
                for t in tok[1:]:
                    i = int(t.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                faces.extend([idx[0], idx[k], idx[k + 1]]
                             for k in range(1, len(idx) - 1))
    return np.array(verts, np.float32), np.array(faces, np.int64)


def build(cfg: dict, root: str) -> PlainScene:
    args = cfg["scene_args"]
    verts, faces = read_obj(os.path.join(root, args["obj_path"]))
    verts = verts * np.float32(args["scale"])
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    verts = verts - (lo + hi) / np.float32(2.0)
    verts[:, 1] -= verts[:, 1].min()

    r = Recipe()
    skin = r.material(LAMBERTIAN, (0.65, 0.55, 0.45))
    for a, b, c in faces:
        r.triangle(verts[a], verts[b], verts[c], skin)
    ground = r.material(LAMBERTIAN, (0.5, 0.5, 0.5))
    r.sphere((0, -1000, 0), 1000.0, ground)
    mirror = r.material(METAL, (0.7, 0.6, 0.5), fuzz=0.0)
    r.sphere((-4.5, 1.5, -1.0), 1.5, mirror)
    glass = r.material(DIELECTRIC, ir=1.5)
    r.sphere((4.5, 1.5, -1.0), 1.5, glass)
    return r.build(dict(look_from=(0.0, 3.0, 9.0), look_at=(0.0, 1.5, 0.0),
                        aspect=16.0 / 9.0, vfov=35.0, aperture=0.0,
                        focus_dist=10.0))
