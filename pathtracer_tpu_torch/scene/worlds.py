"""Scene registry (``scene/worlds.py``). The slice ports the flagship
``bunny`` world and the deterministic ``test`` world; the others are
ROADMAP Queue 1, item 7."""
from __future__ import annotations

from typing import Tuple

from pathtracer_tpu_torch.config import K_ASPECT_RATIO
from pathtracer_tpu_torch.core.camera import Camera, make_camera
from pathtracer_tpu_torch.scene.scene import Scene, SceneBuilder


def test_world(device="cpu") -> Tuple[Scene, Camera]:
    """Two mirror-image metal triangles and a blue r=1000 lambertian sphere
    at (1005, 0, 0); camera (0, 0, 15) looking at the origin, vfov 20."""
    b = SceneBuilder()
    m0 = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_triangle((0, -2, 0), (1, 0, 5), (0, 2, 0), m0)
    m1 = b.add_metal((0.7, 0.6, 0.5), 0.0)
    b.add_triangle((0, -2, 0), (-1, 0, 5), (0, 2, 0), m1)
    m2 = b.add_lambertian((0, 0, 1))
    b.add_sphere((1005, 0, 0), 1000.0, m2)
    cam = make_camera((0, 0, 15), (0, 0, 0), 20, K_ASPECT_RATIO,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam


# pytest would otherwise collect the factory as a test
test_world.__test__ = False

PORTED_WORLDS = ("bunny", "test")


def get_world(name: str, device="cpu", **kw) -> Tuple[Scene, Camera]:
    if name == "test":
        return test_world(device=device, **kw)
    if name == "bunny":
        from pathtracer_tpu_torch.scene.bunny import bunny_world
        return bunny_world(device=device, **kw)
    if name in ("triangle", "random", "cornell", "combined"):
        raise NotImplementedError(
            f"scene {name!r} is not ported yet (ROADMAP Queue 1, item 7)")
    raise ValueError(f"unknown scene {name!r}; ported: "
                     f"{'/'.join(PORTED_WORLDS)}")
