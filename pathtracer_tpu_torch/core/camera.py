"""Thin-lens look-at camera (``core/camera.py``).

Same conventions as the reference: ``front`` points backwards, the viewport
corner sits at ``pos - h/2 - v/2 - focus_dist * front``, and ray directions
are not normalized.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from pathtracer_tpu_torch.config import K_CAMERA_SPEED
from pathtracer_tpu_torch.core import sampling, vec


class Direction(enum.Enum):
    """Navigation directions of the interactive viewer."""
    FORWARD = 0
    BACKWARD = 1
    LEFT = 2
    RIGHT = 3
    UP = 4
    DOWN = 5


class Camera(NamedTuple):
    position: torch.Tensor     # (3,)
    lower_left: torch.Tensor   # (3,)
    horizontal: torch.Tensor   # (3,)
    vertical: torch.Tensor     # (3,)
    right: torch.Tensor        # (3,)
    up: torch.Tensor           # (3,)
    front: torch.Tensor        # (3,)
    lens_radius: torch.Tensor  # ()
    time0: torch.Tensor        # ()
    time1: torch.Tensor        # ()
    focus_dist: torch.Tensor   # ()

    def to(self, device) -> "Camera":
        return Camera(*(x.to(device) for x in self))


def make_camera(look_from, look_at, vfov_deg, aspect_ratio, aperture=0.0,
                focus_dist=1.0, time0=0.0, time1=0.0,
                device="cuda") -> Camera:
    """Build the camera basis and viewport on ``device``."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    look_from = f32(look_from)
    look_at = f32(look_at)
    theta = vec.degrees_to_radians(f32(vfov_deg))
    h = torch.tan(theta / 2.0)
    viewport_height = 2.0 * h
    viewport_width = aspect_ratio * viewport_height

    front = vec.normalize(look_from - look_at)
    right = vec.normalize(vec.cross(f32([0.0, 1.0, 0.0]), front))
    up = vec.cross(front, right)

    horizontal = focus_dist * viewport_width * right
    vertical = focus_dist * viewport_height * up
    lower_left = (look_from - horizontal / 2.0 - vertical / 2.0
                  - focus_dist * front)
    return Camera(position=look_from, lower_left=lower_left,
                  horizontal=horizontal, vertical=vertical, right=right,
                  up=up, front=front, lens_radius=f32(aperture / 2.0),
                  time0=f32(time0), time1=f32(time1),
                  focus_dist=f32(focus_dist))


def get_rays(cam: Camera, s, t, u_disk1, u_disk2, u_time):
    """Rays for viewport fractions (s, t) with lens defocus and shutter
    jitter; all args (N,). Returns (origin (N,3), direction (N,3),
    time (N,)); directions unnormalized."""
    rd = cam.lens_radius * sampling.uniform_in_disk(u_disk1, u_disk2)
    offset = (cam.right[None, :] * rd[..., 0:1]
              + cam.up[None, :] * rd[..., 1:2])
    origin = cam.position[None, :] + offset
    direction = (cam.lower_left[None, :]
                 + s[..., None] * cam.horizontal[None, :]
                 + t[..., None] * cam.vertical[None, :]
                 - cam.position[None, :] - offset)
    time = sampling.uniform_in_range(cam.time0, cam.time1, u_time)
    return origin, direction, time


def move_camera(cam: Camera, direction: Direction,
                delta_time: float) -> Camera:
    """WASD/QE navigation: the camera moved ``K_CAMERA_SPEED *
    delta_time`` along ``direction``, its viewport with it."""
    velocity = K_CAMERA_SPEED * delta_time
    step = {Direction.FORWARD: -cam.front, Direction.BACKWARD: cam.front,
            Direction.LEFT: -cam.right, Direction.RIGHT: cam.right,
            Direction.UP: cam.up, Direction.DOWN: -cam.up}[direction]
    pos = cam.position + step * velocity
    lower_left = (pos - cam.horizontal / 2.0 - cam.vertical / 2.0
                  - cam.focus_dist * cam.front)
    return cam._replace(position=pos, lower_left=lower_left)
