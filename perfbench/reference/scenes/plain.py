"""The plain scene the reference renders: one row per primitive (sphere or
triangle, in the recipe's order, which decides exact ties) and one per
material, as numpy arrays, the textures as one stack of texels, and the
camera's look-at parameters."""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

SPHERE, TRIANGLE = 1, 3
LAMBERTIAN, METAL, DIELECTRIC, EMISSIVE = 1, 2, 4, 8


class PlainScene(NamedTuple):
    ptype: np.ndarray     # (N,) int
    v0: np.ndarray        # (N, 3) f32: sphere centre or triangle vertex 0
    e1: np.ndarray        # (N, 3) f32: v1 - v0
    e2: np.ndarray        # (N, 3) f32: v2 - v0
    radius: np.ndarray    # (N,) f32, signed
    normal: np.ndarray    # (N, 3) f32 unit face normal of a triangle
    pmat: np.ndarray      # (N,) int
    mtype: np.ndarray     # (M,) int
    albedo: np.ndarray    # (M, 3) f32
    fuzz: np.ndarray      # (M,) f32
    ir: np.ndarray        # (M,) f32
    emit: np.ndarray      # (M, 3) f32
    tex_id: np.ndarray    # (M,) int: a texture of ``textures``, -1 for none
    textures: np.ndarray  # (K, TH, TW, 3) f32; (0, 1, 1, 3) without any
    camera: dict          # look_from, look_at, vfov, aperture, focus_dist


class Recipe:
    """Collects primitives, materials and textures in order."""

    def __init__(self):
        self.prims = []
        self.mats = []
        self.textures = []

    def material(self, mtype, albedo=(0, 0, 0), fuzz=0.0, ir=0.0,
                 emit=(0, 0, 0), tex_id: int = -1) -> int:
        self.mats.append((mtype, np.asarray(albedo, np.float32),
                          np.float32(min(float(fuzz), 1.0)), np.float32(ir),
                          np.asarray(emit, np.float32), int(tex_id)))
        return len(self.mats) - 1

    def texture(self, texels) -> int:
        """An (H, W, 3) f32 image, row 0 at the top; returns its id."""
        self.textures.append(np.asarray(texels, np.float32)[..., :3])
        return len(self.textures) - 1

    def sphere(self, center, radius, mat):
        z = np.zeros(3, np.float32)
        self.prims.append((SPHERE, np.asarray(center, np.float32), z, z,
                           np.float32(radius), z, mat))

    def triangle(self, a, b, c, mat):
        a = np.asarray(a, np.float32)
        e1 = np.asarray(b, np.float32) - a
        e2 = np.asarray(c, np.float32) - a
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n)
        n = n / norm if norm > 0 else n
        self.prims.append((TRIANGLE, a, e1, e2, np.float32(0.0),
                           n.astype(np.float32), mat))

    def texture_stack(self) -> np.ndarray:
        """The textures as one (K, TH, TW, 3) stack at the largest height
        and width, a smaller image repeating its nearest texel (texel (y,
        x) of the stack is texel (y h / TH, x w / TW) of an h x w image,
        rounded down), as the program's scene builder lays them out."""
        if not self.textures:
            return np.zeros((0, 1, 1, 3), np.float32)
        th = max(t.shape[0] for t in self.textures)
        tw = max(t.shape[1] for t in self.textures)
        stack = np.zeros((len(self.textures), th, tw, 3), np.float32)
        for i, t in enumerate(self.textures):
            ys = np.arange(th) * t.shape[0] // th
            xs = np.arange(tw) * t.shape[1] // tw
            stack[i] = t[ys][:, xs]
        return stack

    def build(self, camera: dict) -> PlainScene:
        cols = list(zip(*self.prims))
        mcols = list(zip(*self.mats))
        return PlainScene(
            ptype=np.array(cols[0]), v0=np.stack(cols[1]),
            e1=np.stack(cols[2]), e2=np.stack(cols[3]),
            radius=np.array(cols[4], np.float32), normal=np.stack(cols[5]),
            pmat=np.array(cols[6]), mtype=np.array(mcols[0]),
            albedo=np.stack(mcols[1]), fuzz=np.array(mcols[2], np.float32),
            ir=np.array(mcols[3], np.float32), emit=np.stack(mcols[4]),
            tex_id=np.array(mcols[5]), textures=self.texture_stack(),
            camera=camera)
