"""Scene container: SoA primitive + material tables (``scene/scene.py``).

One row per primitive with both sphere and triangle fields, selected by a
type tag; the same field names, dtypes and padding rules as the reference,
held as torch tensors on one device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

PRIM_SPHERE = 1
PRIM_TRIANGLE = 3

MAT_LAMBERTIAN = 1
MAT_METAL = 2
MAT_DIELECTRIC = 4
MAT_EMISSIVE = 8


class Scene(NamedTuple):
    """SoA scene, N primitives and M materials. Sphere rows: ``v0`` is the
    center and ``radius`` is signed. Triangle rows: ``v0``, edges ``e1``,
    ``e2`` and the unit face normal."""
    prim_type: torch.Tensor   # (N,) int32
    v0: torch.Tensor          # (N, 3)
    e1: torch.Tensor          # (N, 3)
    e2: torch.Tensor          # (N, 3)
    radius: torch.Tensor      # (N,)
    tri_normal: torch.Tensor  # (N, 3)
    prim_mat: torch.Tensor    # (N,) int32
    box_min: torch.Tensor     # (N, 3)
    box_max: torch.Tensor     # (N, 3)

    mat_type: torch.Tensor    # (M,) int32
    albedo: torch.Tensor      # (M, 3)
    fuzz: torch.Tensor        # (M,)
    ir: torch.Tensor          # (M,)
    emit: torch.Tensor        # (M, 3)
    tex_id: torch.Tensor      # (M,) int32, -1 = plain albedo

    world_min: torch.Tensor   # (3,)
    world_max: torch.Tensor   # (3,)
    light_idx: torch.Tensor   # (L,) int32 emissive prim ids
    textures: torch.Tensor    # (K, TH, TW, 3); empty -> (0, 1, 1, 3)

    @property
    def num_prims(self) -> int:
        return self.prim_type.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_idx.shape[0]

    @property
    def num_materials(self) -> int:
        return self.mat_type.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    def to(self, device) -> "Scene":
        return Scene(*(x.to(device) for x in self))


def scene_from_numpy(fields: dict, device="cuda") -> Scene:
    """Build a Scene from a dict of numpy arrays keyed by field name."""
    return Scene(**{name: torch.from_numpy(np.array(fields[name])).to(device)
                    for name in Scene._fields})


def triangle_rows(v0, v1, v2):
    """(e1, e2, unit face normal) of triangles given as (N, 3) float32
    corner arrays, in one numpy pass. The normal's length is each row's
    ``n.dot(n)`` (numpy's float32 dot, as ``np.linalg.norm`` of one row
    computes it: a batched matmul of (1, 3) by (3, 1) takes the same
    routine), so the rows are bit-equal to building the triangles one at
    a time; a zero-length normal stays as it is."""
    e1, e2 = v1 - v0, v2 - v0
    n = np.ascontiguousarray(np.cross(e1, e2))
    norm = np.sqrt(np.matmul(n[:, None, :], n[:, :, None])[:, 0, 0])
    with np.errstate(divide="ignore", invalid="ignore"):
        unit = n / norm[:, None]
    return e1, e2, np.where((norm > 0)[:, None], unit, n)


class SceneBuilder:
    """Host-side scene assembly in numpy, as in the reference's
    SceneBuilder, producing a Scene on ``device``. Primitives are kept as
    blocks of rows (a sphere or a triangle one row, a mesh all of its
    faces), concatenated in order by :meth:`build`."""

    def __init__(self):
        self._blocks = []     # (type, v0, e1, e2, radius, normal, mat)
        self._mats = []       # (type, albedo, fuzz, ir, emit, tex_id)
        self._textures = []

    def add_lambertian(self, albedo, tex_id: int = -1) -> int:
        return self._add_mat(MAT_LAMBERTIAN, albedo, 0.0, 0.0, (0, 0, 0),
                             tex_id)

    def add_metal(self, albedo, fuzz: float) -> int:
        return self._add_mat(MAT_METAL, albedo, min(fuzz, 1.0), 0.0,
                             (0, 0, 0), -1)

    def add_dielectric(self, ir: float) -> int:
        return self._add_mat(MAT_DIELECTRIC, (0, 0, 0), 0.0, ir, (0, 0, 0),
                             -1)

    def add_emissive(self, emit) -> int:
        return self._add_mat(MAT_EMISSIVE, (0, 0, 0), 0.0, 0.0, emit, -1)

    def _add_mat(self, mtype, albedo, fuzz, ir, emit, tex_id) -> int:
        self._mats.append((mtype, np.asarray(albedo, np.float32),
                           float(fuzz), float(ir),
                           np.asarray(emit, np.float32), int(tex_id)))
        return len(self._mats) - 1

    def add_texture(self, image) -> int:
        """Register an (H, W, >=3) image texture; returns its tex_id."""
        self._textures.append(np.asarray(image, np.float32))
        return len(self._textures) - 1

    def _add_rows(self, ptype, v0, e1, e2, normal, mat, radius=0.0):
        n = v0.shape[0]
        self._blocks.append((np.full(n, ptype, np.int32), v0, e1, e2,
                             np.broadcast_to(np.float32(radius), (n,)),
                             normal, np.full(n, int(mat), np.int32)))

    def add_sphere(self, center, radius: float, mat: int):
        """Signed radius; AABB from |radius|."""
        c = np.asarray(center, np.float32).reshape(1, 3)
        z = np.zeros((1, 3), np.float32)
        self._add_rows(PRIM_SPHERE, c, z, z, z, mat, radius)

    def add_triangle(self, v0, v1, v2, mat: int):
        """Precomputes edges and the unit face normal."""
        v0, v1, v2 = (np.asarray(v, np.float32).reshape(1, 3)
                      for v in (v0, v1, v2))
        self._add_rows(PRIM_TRIANGLE, v0, *triangle_rows(v0, v1, v2), mat)

    def add_mesh(self, vertices, faces, mat: int):
        """Expand an indexed triangle mesh into triangle rows, face by face
        in order, as :meth:`add_triangle` would one at a time."""
        vertices = np.asarray(vertices, np.float32)
        faces = np.asarray(faces, np.int64).reshape(-1, 3)
        if faces.shape[0] == 0:
            return
        v0, v1, v2 = (vertices[faces[:, k]] for k in range(3))
        self._add_rows(PRIM_TRIANGLE, v0, *triangle_rows(v0, v1, v2), mat)

    def build(self, device="cuda") -> Scene:
        if not self._blocks:
            raise ValueError("empty scene")
        (ptype, v0, e1, e2, radius, tri_n, pmat) = (
            np.concatenate(col) for col in zip(*self._blocks))

        is_sphere = (ptype == PRIM_SPHERE)[:, None]
        r_abs = np.abs(radius)[:, None]
        sph_min, sph_max = v0 - r_abs, v0 + r_abs
        tri_min = np.minimum(v0, np.minimum(v0 + e1, v0 + e2))
        tri_max = np.maximum(v0, np.maximum(v0 + e1, v0 + e2))
        box_min = np.where(is_sphere, sph_min, tri_min).astype(np.float32)
        box_max = np.where(is_sphere, sph_max, tri_max).astype(np.float32)

        world_min = box_min.min(axis=0)
        world_max = box_max.max(axis=0)

        if not self._mats:
            raise ValueError("scene has no materials")
        mtype = np.array([m[0] for m in self._mats], np.int32)
        light_idx = np.nonzero(mtype[pmat] == MAT_EMISSIVE)[0].astype(
            np.int32)
        if self._textures:
            # one (K, TH, TW, 3) atlas at the largest height and width;
            # smaller images are nearest-neighbour resampled to it
            th = max(t.shape[0] for t in self._textures)
            tw = max(t.shape[1] for t in self._textures)
            atlas = np.zeros((len(self._textures), th, tw, 3), np.float32)
            for i, t in enumerate(self._textures):
                if t.shape[:2] != (th, tw):
                    yi = np.arange(th) * t.shape[0] // th
                    xi = np.arange(tw) * t.shape[1] // tw
                    t = t[yi][:, xi]
                atlas[i] = t[..., :3]
        else:
            atlas = np.zeros((0, 1, 1, 3), np.float32)
        fields = dict(
            prim_type=ptype, v0=v0, e1=e1, e2=e2, radius=radius,
            tri_normal=tri_n, prim_mat=pmat, box_min=box_min,
            box_max=box_max, mat_type=mtype,
            albedo=np.stack([m[1] for m in self._mats]),
            fuzz=np.array([m[2] for m in self._mats], np.float32),
            ir=np.array([m[3] for m in self._mats], np.float32),
            emit=np.stack([m[4] for m in self._mats]),
            tex_id=np.array([m[5] for m in self._mats], np.int32),
            world_min=world_min, world_max=world_max, light_idx=light_idx,
            textures=atlas)
        return scene_from_numpy(fields, device)
