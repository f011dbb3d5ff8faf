"""Built-in geometry (``scene/standalone_assets.py``), so the scenes build
without any external OBJ files.

- ``cornell_mesh``: the canonical published Cornell box data
  (floor/ceiling/back 552.8 x 548.8 x 559.2, light at y = 548.7 over
  [213, 343] x [227, 332], short and tall blocks).
- ``bunny_standin``: a procedural bunny-proportioned blob (deformed
  icospheres), the last resort of ``bunny_world`` and ``combined_scene``
  when no bunny OBJ exists. Not the Stanford bunny; renders differ.

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


def _icosphere(subdiv: int = 3):
    """Unit icosphere (verts, faces) by midpoint subdivision."""
    p = (1.0 + 5.0 ** 0.5) / 2.0
    verts = np.array([
        (-1, p, 0), (1, p, 0), (-1, -p, 0), (1, -p, 0),
        (0, -1, p), (0, 1, p), (0, -1, -p), (0, 1, -p),
        (p, 0, -1), (p, 0, 1), (-p, 0, -1), (-p, 0, 1)], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)],
        np.int64)
    for _ in range(subdiv):
        a, b, c = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate([
            np.stack([a, ab, ca], axis=1), np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1), np.stack([ab, bc, ca], axis=1)],
            axis=0)
        tris /= np.linalg.norm(tris, axis=2, keepdims=True)
        verts = tris.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces


def bunny_standin():
    """(verts (V, 3) f64, faces (F, 3) i64) of a triangle soup: a squashed
    icosphere body, head, two ears and a tail, ~2.5k triangles at roughly
    the Stanford bunny's footprint (unit-ish scale; ``bunny_world`` applies
    its scale and grounding)."""
    parts = []

    def add(scale, offset, subdiv):
        v, f = _icosphere(subdiv)
        v = v * np.asarray(scale, np.float64) + np.asarray(offset,
                                                           np.float64)
        parts.append(v[f.reshape(-1)].reshape(-1, 3))

    add((0.105, 0.090, 0.080), (-0.02, 0.09, 0.0), 3)    # body
    add((0.055, 0.055, 0.050), (0.055, 0.175, 0.0), 3)   # head
    add((0.016, 0.055, 0.012), (0.045, 0.25, 0.028), 2)  # ear
    add((0.016, 0.055, 0.012), (0.045, 0.25, -0.028), 2)  # ear
    add((0.035, 0.030, 0.035), (-0.125, 0.075, 0.0), 2)  # tail
    verts = np.concatenate(parts, axis=0)
    faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces
