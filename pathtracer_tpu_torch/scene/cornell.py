"""Cornell box scene (``scene/cornell.py``): the room lit by its emissive
ceiling light, with diffuse spheres ("spheres") or the boxes plus metal,
glass and textured spheres ("full").

Geometry comes from the OBJ files in ``PT_CORNELL_DIR`` when that is set
and holds them, else from the built-in canonical data
(``scene/standalone_assets.py``).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.io.obj import load_obj
from pathtracer_tpu_torch.io.png import read_png
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder
from pathtracer_tpu_torch.scene.standalone_assets import cornell_mesh

MARBLE_PNG = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))),
    "assets", "textures", "marble.png")


def _cornell_part(obj_dir: Optional[str], name: str):
    """(verts, faces) of a Cornell part: ``<obj_dir>/<name>.obj`` when it
    exists, else the built-in data. ``obj_dir`` None reads
    ``PT_CORNELL_DIR``."""
    if obj_dir is None:
        obj_dir = os.environ.get("PT_CORNELL_DIR")
    if obj_dir:
        path = os.path.join(obj_dir, name + ".obj")
        if os.path.exists(path):
            return load_obj(path)
    return cornell_mesh(name)


def add_cornell_room(b: SceneBuilder, obj_dir: Optional[str] = None) -> int:
    """Add the room (floor+ceiling+back white, red left, green right, the
    emissive ceiling light) to a builder; returns the white material id.
    ``obj_dir`` as in :func:`_cornell_part`."""
    white = b.add_lambertian((0.73, 0.73, 0.73))
    red = b.add_lambertian((0.65, 0.05, 0.05))
    green = b.add_lambertian((0.12, 0.45, 0.15))
    light = b.add_emissive((15.0, 15.0, 15.0))
    for name, mat in (("floor", white), ("left", red), ("right", green),
                      ("light", light)):
        verts, faces = _cornell_part(obj_dir, name)
        b.add_mesh(verts, faces, mat)
    return white


def cornell_box(obj_dir: Optional[str] = None, aspect: float = 1.0,
                variant: str = "full",
                device="cuda") -> Tuple[Scene, Camera]:
    """Cornell box on ``device``. ``variant`` "spheres": two diffuse
    spheres instead of the boxes; "full": boxes, a metal and a glass
    sphere, a checker-textured and a marble-textured sphere. ``obj_dir``
    None reads ``PT_CORNELL_DIR``."""
    b = SceneBuilder()
    white = add_cornell_room(b, obj_dir)

    def add(name, mat):
        verts, faces = _cornell_part(obj_dir, name)
        b.add_mesh(verts, faces, mat)

    if variant == "full":
        add("shortbox", white)
        add("tallbox", white)
        metal = b.add_metal((0.8, 0.85, 0.88), 0.0)
        b.add_sphere((400.0, 240.0, 190.0), 75.0, metal)
        glass = b.add_dielectric(1.5)
        b.add_sphere((160.0, 420.0, 360.0), 90.0, glass)
        checker = np.zeros((8, 16, 3), np.float32)
        checker[::2, ::2] = checker[1::2, 1::2] = (0.9, 0.9, 0.85)
        checker[::2, 1::2] = checker[1::2, ::2] = (0.15, 0.25, 0.5)
        tid = b.add_texture(checker)
        tex_mat = b.add_lambertian((1.0, 1.0, 1.0), tex_id=tid)
        b.add_sphere((420.0, 90.0, 400.0), 90.0, tex_mat)
        if os.path.exists(MARBLE_PNG):
            marble = b.add_texture(read_png(MARBLE_PNG)[..., :3])
            marble_mat = b.add_lambertian((1.0, 1.0, 1.0), tex_id=marble)
            b.add_sphere((120.0, 75.0, 147.0), 75.0, marble_mat)
    elif variant == "spheres":
        s1 = b.add_lambertian((0.8, 0.3, 0.3))
        s2 = b.add_lambertian((0.3, 0.3, 0.8))
        b.add_sphere((185.0, 120.0, 169.0), 120.0, s1)
        b.add_sphere((368.0, 90.0, 351.0), 90.0, s2)
    else:
        raise ValueError(f"unknown Cornell variant {variant!r}; "
                         f"available: full/spheres")

    # standard Cornell camera: at the open front face looking in (+z)
    cam = make_camera((278, 273, -800), (278, 273, 0), 40, aspect,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam
