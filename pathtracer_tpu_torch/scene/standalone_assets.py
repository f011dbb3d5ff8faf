"""Built-in Cornell box geometry (``scene/standalone_assets.py::
cornell_mesh``).

The canonical published Cornell box data (floor/ceiling/back 552.8 x
548.8 x 559.2, light at y = 548.7 over [213, 343] x [227, 332], short and
tall blocks), so the Cornell scenes build without any external OBJ files.
Values, vertex order and face order equal the reference package's copy.
"""
from __future__ import annotations

import numpy as np

_QUAD_FACES2 = [(0, 1, 2), (0, 2, 3)]

# Each entry: (verts, faces as 0-based index triples).
_CORNELL = {
    # floor + ceiling + back wall (white)
    "floor": (
        [(552.8, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.0, 559.2),
         (549.6, 0.0, 559.2),
         (556.0, 548.8, 0.0), (556.0, 548.8, 559.2), (0.0, 548.8, 559.2),
         (0.0, 548.8, 0.0),
         (549.6, 0.0, 559.2), (0.0, 0.0, 559.2), (0.0, 548.8, 559.2),
         (556.0, 548.8, 559.2)],
        [(0, 1, 2), (2, 3, 0), (4, 5, 6), (6, 7, 4), (8, 9, 10),
         (10, 11, 8)]),
    "left": (
        [(552.8, 0.0, 0.0), (549.6, 0.0, 559.2), (556.0, 548.8, 559.2),
         (556.0, 548.8, 0.0)], _QUAD_FACES2),
    "right": (
        [(0.0, 0.0, 559.2), (0.0, 0.0, 0.0), (0.0, 548.8, 0.0),
         (0.0, 548.8, 559.2)], _QUAD_FACES2),
    "light": (
        [(343.0, 548.7, 227.0), (343.0, 548.7, 332.0),
         (213.0, 548.7, 332.0), (213.0, 548.7, 227.0)], _QUAD_FACES2),
}


def _box_block(top, base_y=0.0):
    """5 quads (top + 4 sides) from the 4 top-face corners: the layout of
    the canonical Cornell blocks."""
    verts = []
    faces = []

    def quad(a, b, c, d):
        i = len(verts)
        verts.extend([a, b, c, d])
        faces.extend([(i, i + 1, i + 2), (i, i + 2, i + 3)])

    t = [np.array(p, np.float64) for p in top]
    quad(*[tuple(p) for p in t])
    for j in range(4):
        a = t[j]
        b = t[(j + 1) % 4]
        quad((a[0], base_y, a[2]), tuple(a), tuple(b), (b[0], base_y, b[2]))
    return verts, faces


_CORNELL["shortbox"] = _box_block([(130.0, 165.0, 65.0),
                                   (82.0, 165.0, 225.0),
                                   (240.0, 165.0, 272.0),
                                   (290.0, 165.0, 114.0)])
_CORNELL["tallbox"] = _box_block([(423.0, 330.0, 247.0),
                                  (265.0, 330.0, 296.0),
                                  (314.0, 330.0, 456.0),
                                  (472.0, 330.0, 406.0)])


def cornell_mesh(name: str):
    """(verts (V, 3) f64, faces (F, 3) i64) for a canonical Cornell part:
    floor | left | right | light | shortbox | tallbox."""
    verts, faces = _CORNELL[name]
    return (np.asarray(verts, np.float64),
            np.asarray(faces, np.int64))
