"""Runtime configuration (counterpart of ``pathtracer_tpu/config.py``).

The same frozen dataclass, constants and ``accel="auto"`` rule as the
reference, so a config round-trips between the two packages; the port
resolves "auto" on a CUDA device by its own step, :func:`route_accel`.
"""
from __future__ import annotations

import dataclasses
import json

import torch

K_ASPECT_RATIO = 16.0 / 9.0
K_FRAME_WIDTH = 800
K_FRAME_HEIGHT = int(K_FRAME_WIDTH / K_ASPECT_RATIO)  # 450
K_SPP = 100
K_MAX_DEPTH = 50
K_CAMERA_SPEED = 2.5
K_T_MIN = 1e-3
K_SHADOW_T_MIN = 1e-7

# accel="auto" crossover, in primitives: a dense route below, cluster march
# at or above. The value is the reference's. On an H100 the sweep kernel
# led the tensor route at 36, 601 and 1,023 prims, so the port keeps the
# crossover and only swaps the dense route on the card (PERF.md §6).
K_AUTO_ACCEL_PRIMS = 1024


def resolve_accel(accel: str, num_prims: int) -> str:
    """Resolve accel="auto" by scene size; other values pass through."""
    if accel != "auto":
        return accel
    return "cluster" if num_prims >= K_AUTO_ACCEL_PRIMS else "tensor"


def route_accel(accel: str, num_prims: int, device) -> str:
    """The route a scene of ``num_prims`` on ``device`` takes: on a CUDA
    device "auto" below K_AUTO_ACCEL_PRIMS is "pallas" (the sweep kernel,
    one launch a query, where the tensor route is a matrix product and
    its torch epilogue); everywhere else :func:`resolve_accel`'s answer,
    the reference's rule, so the CPU keeps "tensor"."""
    route = resolve_accel(accel, num_prims)
    if route == "tensor" and accel == "auto" \
            and torch.device(device).type == "cuda":
        return "pallas"
    return route


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
