"""Runtime configuration (counterpart of ``pathtracer_tpu/config.py``).

The same frozen dataclass, constants and ``accel="auto"`` rule as the
reference, so a config round-trips between the two packages.
"""
from __future__ import annotations

import dataclasses
import json

K_ASPECT_RATIO = 16.0 / 9.0
K_FRAME_WIDTH = 800
K_FRAME_HEIGHT = int(K_FRAME_WIDTH / K_ASPECT_RATIO)  # 450
K_SPP = 100
K_MAX_DEPTH = 50
K_CAMERA_SPEED = 2.5
K_T_MIN = 1e-3
K_SHADOW_T_MIN = 1e-7

# accel="auto" crossover, in primitives: dense sweep below, cluster march at
# or above. The value is the reference's; it has not been re-measured for
# this port (ROADMAP Queue 1, item 7).
K_AUTO_ACCEL_PRIMS = 1024


def resolve_accel(accel: str, num_prims: int) -> str:
    """Resolve accel="auto" by scene size; other values pass through."""
    if accel != "auto":
        return accel
    return "cluster" if num_prims >= K_AUTO_ACCEL_PRIMS else "tensor"


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static render configuration; field names and defaults match the
    reference's ``RenderConfig``."""

    width: int = K_FRAME_WIDTH
    height: int = K_FRAME_HEIGHT
    spp: int = K_SPP
    max_depth: int = K_MAX_DEPTH
    t_min: float = K_T_MIN
    sky: bool = True
    nee: bool = False
    stratify: bool = False
    sampler: str = "random"
    rr: bool = False
    rr_depth: int = 3
    terminate_black: bool = False
    accel: str = "auto"
    ray_chunk: int = 16384
    seed: int = 0
    scene: str = "triangle"

    def __post_init__(self):
        if self.width <= 0 or self.height <= 0:
            raise ValueError("frame size must be positive")
        if self.accel not in ("auto", "cluster", "tensor", "pallas", "bvh",
                              "brute"):
            raise ValueError(f"unknown accel {self.accel!r}")

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        return RenderConfig(**json.loads(s))

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
