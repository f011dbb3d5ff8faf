"""Stanford bunny scene (``scene/bunny.py``): the bunny mesh over a grey
ground sphere under the sky, flanked by a mirror and a glass sphere."""
from __future__ import annotations

import os
import sys
from typing import Tuple

import numpy as np

from pathtracer_tpu_torch.config import K_ASPECT_RATIO
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.io.obj import load_obj
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder
from pathtracer_tpu_torch.scene.standalone_assets import bunny_standin

# The vendored decimated scan (1,817 v / 3,616 f) under the repo's assets/.
ASSET_OBJ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "assets", "bunny.obj")


def resolve_bunny_obj() -> str | None:
    """PT_BUNNY_OBJ if set and present, else the vendored asset; None when
    neither exists."""
    for p in (os.environ.get("PT_BUNNY_OBJ"), ASSET_OBJ):
        if p and os.path.exists(p):
            return p
    return None


def subdivide_faces(verts, faces, levels: int = 1):
    """4:1 midpoint subdivision, ``levels`` times (numpy, host).

    Splits every triangle into four at its edge midpoints: the surface is
    unchanged (no smoothing), only the triangle count quadruples, so a
    level-k bunny is the same geometry at 4^k times the primitive count,
    the scaling workload of the culled closest hit
    (``tools/bench_prim_scaling.py --bunny``). Emits unshared triangle
    soup; midpoints are computed in the vertices' dtype (float32)."""
    for _ in range(levels):
        a = verts[faces[:, 0]]
        b = verts[faces[:, 1]]
        c = verts[faces[:, 2]]
        ab, bc, ca = (a + b) / 2, (b + c) / 2, (c + a) / 2
        tris = np.concatenate([
            np.stack([a, ab, ca], axis=1),
            np.stack([ab, b, bc], axis=1),
            np.stack([ca, bc, c], axis=1),
            np.stack([ab, bc, ca], axis=1),
        ], axis=0)                                  # (4F, 3, 3)
        verts = tris.reshape(-1, 3)
        faces = np.arange(verts.shape[0], dtype=np.int64).reshape(-1, 3)
    return verts, faces


def bunny_world(obj_path: str | None = None, scale: float = 20.0,
                material: str = "lambertian", subdivide: int = 0,
                device="cuda") -> Tuple[Scene, Camera]:
    """The bunny scene; ``subdivide`` k splits every mesh triangle 4:1 k
    times (after the scale, before the centring), giving 3,616 * 4^k
    triangles plus the three spheres with the vendored asset."""
    if obj_path is None:
        obj_path = resolve_bunny_obj()
    if obj_path is not None and os.path.exists(obj_path):
        verts, faces = load_obj(obj_path)
    else:
        print(f"bunny_world: {obj_path} not found - using the procedural "
              "stand-in mesh (set PT_BUNNY_OBJ for the Stanford bunny)",
              file=sys.stderr)
        verts, faces = bunny_standin()
    verts = verts * scale
    if subdivide:
        verts, faces = subdivide_faces(verts, faces, subdivide)
    # center on origin, rest on y=0
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    verts = verts - (lo + hi) / 2.0
    verts[:, 1] -= verts[:, 1].min()

    b = SceneBuilder()
    if material == "metal":
        bunny_mat = b.add_metal((0.8, 0.7, 0.55), 0.05)
    elif material == "dielectric":
        bunny_mat = b.add_dielectric(1.5)
    else:
        bunny_mat = b.add_lambertian((0.65, 0.55, 0.45))
    b.add_mesh(verts, faces, bunny_mat)

    ground = b.add_lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0, -1000, 0), 1000.0, ground)
    mirror = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_sphere((-4.5, 1.5, -1.0), 1.5, mirror)
    glass = b.add_dielectric(1.5)
    b.add_sphere((4.5, 1.5, -1.0), 1.5, glass)

    cam = make_camera((0, 3.0, 9.0), (0, 1.5, 0), 35, K_ASPECT_RATIO,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam
