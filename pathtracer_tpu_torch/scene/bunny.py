"""Stanford bunny scene (``scene/bunny.py``): the bunny mesh over a grey
ground sphere under the sky, flanked by a mirror and a glass sphere."""
from __future__ import annotations

import os
import sys
from typing import Tuple

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


def bunny_world(obj_path: str | None = None, scale: float = 20.0,
                material: str = "lambertian", subdivide: int = 0,
                device="cuda") -> Tuple[Scene, Camera]:
    if subdivide:
        raise NotImplementedError(
            "bunny subdivision is not ported yet (ROADMAP Queue 1, item 9)")
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
