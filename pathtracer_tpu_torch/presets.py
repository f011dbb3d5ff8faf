"""Named render configurations (``presets.py``).

Each preset returns ``(scene, camera, RenderConfig)`` with the reference's
sizes; ``python -m pathtracer_tpu_torch --preset <name>`` runs one.

| name             | scene and config                                      |
|------------------|-------------------------------------------------------|
| cornell-direct   | Cornell diffuse spheres, depth 2, 16 spp, 256x256     |
| cornell-full     | Cornell full materials + textures, depth 4, 64 spp    |
| bunny            | the bunny world, depth 4, 128 spp, 800x450            |
| cornell-diff     | Cornell spheres, 64x64, 8 spp, depth 2, NEE, brute:   |
|                  | the fixture of the differentiable pass (render/diff)  |
| combined-1080p   | bunny inside the Cornell room, 1080p, 512 spp         |
| bunny-l4         | the bunny world split 4:1 four times (925,699 prims), |
|                  | 640x360, 128 spp, depth 4: the two-level cull         |
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.io.obj import load_obj
from pathtracer_tpu_torch.scene.bunny import bunny_world, resolve_bunny_obj
from pathtracer_tpu_torch.scene.cornell import add_cornell_room, cornell_box
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder
from pathtracer_tpu_torch.scene.standalone_assets import bunny_standin

PRESETS = ("cornell-direct", "cornell-full", "cornell-diff", "bunny",
           "combined-1080p", "bunny-l4")


def combined_scene(aspect: float = 16.0 / 9.0, obj_path: str | None = None,
                   device="cuda") -> Tuple[Scene, Camera]:
    """The bunny mesh standing in the Cornell room (scaled to ~250 units,
    centred on the floor) with a mirror and a glass sphere. The mesh is
    ``obj_path`` where given, else :func:`resolve_bunny_obj`'s
    (``PT_BUNNY_OBJ``, then the vendored asset), else the procedural
    stand-in."""
    b = SceneBuilder()
    add_cornell_room(b)
    if obj_path is None:
        obj_path = resolve_bunny_obj()
    if obj_path is not None:
        verts, faces = load_obj(obj_path)
    else:
        verts, faces = bunny_standin()
    verts = verts.astype(np.float64)
    lo, hi = verts.min(0), verts.max(0)
    scale = 250.0 / float((hi - lo).max())
    verts = (verts - (lo + hi) / 2.0) * scale
    verts[:, 1] -= verts[:, 1].min()
    verts += np.array([278.0, 0.0, 280.0])
    grey = b.add_lambertian((0.65, 0.55, 0.45))
    b.add_mesh(verts.astype(np.float32), faces, grey)

    mirror = b.add_metal((0.8, 0.85, 0.88), 0.0)
    b.add_sphere((120.0, 90.0, 150.0), 90.0, mirror)
    glass = b.add_dielectric(1.5)
    b.add_sphere((430.0, 90.0, 150.0), 90.0, glass)

    cam = make_camera((278, 273, -800), (278, 273, 0), 40, aspect,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam


def get_preset(name: str, device="cuda"):
    """(scene, camera, RenderConfig) of a named preset, on ``device``."""
    if name == "cornell-direct":
        scene, cam = cornell_box(variant="spheres", device=device)
        return scene, cam, RenderConfig(
            width=256, height=256, spp=16, max_depth=2, sky=False,
            nee=True, stratify=True, accel="auto", scene="cornell")
    if name == "cornell-full":
        scene, cam = cornell_box(variant="full", device=device)
        return scene, cam, RenderConfig(
            width=256, height=256, spp=64, max_depth=4, sky=False,
            nee=True, stratify=True, accel="auto", scene="cornell")
    if name == "cornell-diff":
        scene, cam = cornell_box(variant="spheres", device=device)
        return scene, cam, RenderConfig(
            width=64, height=64, spp=8, max_depth=2, sky=False, nee=True,
            accel="brute", scene="cornell")
    if name == "bunny":
        scene, cam = bunny_world(device=device)
        return scene, cam, RenderConfig(
            width=800, height=450, spp=128, max_depth=4,
            stratify=True, accel="auto", scene="bunny")
    if name == "combined-1080p":
        scene, cam = combined_scene(device=device)
        return scene, cam, RenderConfig(
            width=1920, height=1080, spp=512, max_depth=4, sky=False,
            nee=True, stratify=True, accel="auto", ray_chunk=129600,
            scene="combined")
    if name == "bunny-l4":
        scene, cam = bunny_world(subdivide=4, device=device)
        return scene, cam, RenderConfig(
            width=640, height=360, spp=128, max_depth=4, accel="auto",
            scene="bunny_fine")
    raise ValueError(f"unknown preset {name!r}; available: "
                     f"{' / '.join(PRESETS)}")
