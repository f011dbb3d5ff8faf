"""Pair-scalar closest-hit maths (``ops/tensor_sweep.py``).

Every per-(ray, primitive) scalar the sphere and triangle tests need is an
affine function of a 12-wide per-ray feature vector

    phi(r) = [d, o, o x d, o.d, |o|^2, 1]

against four precomputed 12-wide columns per primitive, followed by an
elementwise epilogue that reproduces the reference's accept/reject rules.
The port contracts in plain float32: each pair scalar is the left-to-right
sum of the twelve products (:func:`contract`), the same order the CUDA
kernels use, so a kernel and its plain twin round alike. The reference's
bf16 split precision modes are TPU workarounds and are not ported.

:func:`tensor_closest` is the dense ``accel="tensor"`` route, which the
reference leaves to XLA: per primitive tile one float32 matrix product
(``torch.matmul``, TF32 off), the epilogue and a strict-``<`` merge. It
runs no kernel of this package.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops import intersect
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE, Scene

FEAT = 12   # phi dimension
OUTS = 4    # pair scalars per primitive
BIG = 3.0e38


class SweepTables(NamedTuple):
    """Per-primitive columns tiled for the sweep."""
    cols: torch.Tensor       # (T, FEAT, OUTS*tile) f32, output-major lanes
    is_sphere: torch.Tensor  # (T, tile) bool
    valid_row: torch.Tensor  # (T, tile) bool, False on padding rows
    tile: int
    num_prims: int


def pack_sweep_tables(scene: Scene, tile: int = 2048) -> SweepTables:
    """Build the four (FEAT,) columns per primitive, tiled so output k of
    tile t occupies columns [k*tile, (k+1)*tile) of ``cols[t]``."""
    n = scene.num_prims
    tile = min(tile, max(128, -(-n // 128) * 128))
    v0, e1, e2 = scene.v0, scene.e1, scene.e2
    radius = scene.radius
    is_sphere = scene.prim_type == PRIM_SPHERE
    dev = v0.device

    zeros = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    zcol = torch.zeros((n, 1), dtype=torch.float32, device=dev)
    one = torch.ones((n, 1), dtype=torch.float32, device=dev)

    # triangle columns
    e2xe1 = vec.cross(e2, e1)
    m = -e2xe1                        # e1 x e2
    e2xv0 = vec.cross(e2, v0)
    v0xe1 = vec.cross(v0, e1)
    col_det = torch.cat([e2xe1, zeros, zeros, zcol, zcol, zcol], dim=1)
    col_tdet = torch.cat([zeros, m, zeros, zcol, zcol,
                          -vec.dot(v0, m)[:, None]], dim=1)
    col_b1 = torch.cat([-e2xv0, zeros, e2, zcol, zcol, zcol], dim=1)
    col_b2 = torch.cat([-v0xe1, zeros, -e1, zcol, zcol, zcol], dim=1)

    # sphere columns (center = v0, signed radius)
    c = v0
    col_B = torch.cat([-c, zeros, zeros, one, zcol, zcol], dim=1)
    col_C = torch.cat([zeros, -2.0 * c, zeros, zcol, one,
                       (vec.dot(c, c) - radius * radius)[:, None]], dim=1)

    sph = is_sphere[:, None]
    k0 = torch.where(sph, col_B, col_det)
    k1 = torch.where(sph, col_C, col_tdet)
    k2 = torch.where(sph, torch.zeros_like(col_b1), col_b1)
    k3 = torch.where(sph, torch.zeros_like(col_b2), col_b2)
    cols = torch.stack([k0, k1, k2, k3], dim=1)          # (N, OUTS, FEAT)

    n_tiles = max(1, -(-n // tile))
    n_pad = n_tiles * tile
    cols = torch.cat([cols, cols.new_zeros((n_pad - n, OUTS, FEAT))])
    is_sphere_p = torch.cat([is_sphere, is_sphere.new_zeros(n_pad - n)])
    valid_row = torch.arange(n_pad, device=dev) < n

    cols = cols.reshape(n_tiles, tile, OUTS, FEAT)
    cols = cols.permute(0, 3, 2, 1).reshape(n_tiles, FEAT, OUTS * tile)
    return SweepTables(cols=cols.contiguous(),
                       is_sphere=is_sphere_p.reshape(n_tiles, tile),
                       valid_row=valid_row.reshape(n_tiles, tile),
                       tile=tile, num_prims=n)


def row_ranges(real):
    """(T, 2) int32 [lo, hi) of the True rows of each row of ``real`` (T,
    W) bool, which must be contiguous in each row (raises ValueError
    otherwise); an empty row gives [0, 0). The sweep kernels and their
    twins sweep only these rows."""
    n = real.sum(dim=1)
    lo = torch.where(n > 0, torch.argmax(real.to(torch.uint8), dim=1), 0)
    hi = lo + n
    k = torch.arange(real.shape[1], device=real.device)
    if not bool((real == ((k >= lo[:, None]) & (k < hi[:, None]))).all()):
        raise ValueError("the rows to sweep are not contiguous")
    return torch.stack([lo, hi], dim=1).to(torch.int32).contiguous()


def check_ranges(ranges, width: int) -> None:
    """Raise ValueError unless every [lo, hi) of ``ranges`` lies in
    [0, width]: what the twins check, and the kernels assert."""
    lo, hi = ranges[:, 0], ranges[:, 1]
    if bool(((lo < 0) | (lo > hi) | (hi > width)).any()):
        raise ValueError(f"a row range leaves [0, {width}]")


def ray_features(o, d):
    """phi = [d, o, o x d, o.d, |o|^2, 1] -- (R, 12)."""
    w = vec.cross(o, d)
    return torch.cat([d, o, w, vec.dot(o, d)[:, None],
                      vec.dot(o, o)[:, None],
                      torch.ones((o.shape[0], 1), dtype=torch.float32,
                                 device=o.device)], dim=1)


def contract(phi, cols):
    """Pair scalars ``sum_f phi[..., f] * cols[..., f, :]``, summed left
    to right in float32 (no fused multiply-add, no reordering).

    phi (..., R, FEAT) against cols (..., FEAT, W) -> (..., R, W)."""
    s = phi[..., :, 0, None] * cols[..., None, 0, :]
    for f in range(1, FEAT):
        s = s + phi[..., :, f, None] * cols[..., None, f, :]
    return s


def _epilogue_sphere(B, C0, a2, t_min, t_max):
    """Sphere half: quadratic with two-root selection. ``a2`` is |d|^2
    broadcast to B's orientation. Returns (t_sph, hit_sph)."""
    disc = B * B - a2 * C0
    pos = disc > 0.0
    sqrt_d = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a2
    root0 = (-B - sqrt_d) * inv_a
    root1 = (-B + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t_sph = torch.where(ok0, root0, root1)
    hit_sph = (disc >= 0.0) & (ok0 | ok1)
    return t_sph, hit_sph


def _epilogue_tri(det, tdet, b1det, b2det, t_min, t_max):
    """Triangle half: Moller-Trumbore with strict rejections (b1 > 0,
    b2 > 0, b1 + b2 < 1 imply the reference's other three). Returns
    (t_tri, hit_tri)."""
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    t_tri = tdet * inv_det
    b1 = b1det * inv_det
    b2 = b2det * inv_det
    miss = ((det == 0.0)
            | (b1 <= 0.0) | (b2 <= 0.0) | (b1 + b2 >= 1.0)
            | (t_tri <= t_min) | (t_tri >= t_max))
    return t_tri, ~miss


def _epilogue(B, C0, P2, P3, a2, is_sphere, valid_row, t_min, t_max):
    """Pair scalars x4 -> effective t: the hit t, or BIG where the pair
    misses or the row is padding. ``a2`` (|d|^2) and the bool masks are
    broadcast against the pair scalars, so one function serves every
    orientation (the reference's ``_epilogue`` with rays on axis 0 and
    ``_epilogue_T`` with rays on the last axis)."""
    t_sph, hit_sph = _epilogue_sphere(B, C0, a2, t_min, t_max)
    t_tri, hit_tri = _epilogue_tri(B, C0, P2, P3, t_min, t_max)
    t_sph_eff = torch.where(hit_sph & valid_row, t_sph, BIG)
    t_tri_eff = torch.where(hit_tri & valid_row, t_tri, BIG)
    return torch.where(is_sphere, t_sph_eff, t_tri_eff)


def merge_tile(t_eff, base: int, t_best, best):
    """Merge one tile's effective t (R, tile) into the running (t_best,
    best): the tile's first minimum replaces the running best only where
    strictly smaller, so the lowest index wins ties across tiles too."""
    j = torch.argmin(t_eff, dim=1)
    t_tile = torch.gather(t_eff, 1, j[:, None])[:, 0]
    better = t_tile < t_best
    return (torch.where(better, t_tile, t_best),
            torch.where(better, base + j.to(best.dtype), best))


def tensor_closest(tables: SweepTables, o, d, t_min, t_max):
    """Dense closest hit through float32 matrix products: (prim_idx (R,)
    int64, t (R,), valid (R,) bool); ties go to the lowest index."""
    phi = ray_features(o, d)
    a2 = vec.dot(d, d)[:, None]
    tile = tables.tile
    t_best = torch.full((o.shape[0],), intersect.BIG_T, dtype=torch.float32,
                        device=o.device)
    best = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)
    for i in range(tables.cols.shape[0]):
        S = torch.matmul(phi, tables.cols[i])
        t_eff = _epilogue(S[:, 0:tile], S[:, tile:2 * tile],
                          S[:, 2 * tile:3 * tile], S[:, 3 * tile:4 * tile],
                          a2, tables.is_sphere[i], tables.valid_row[i],
                          t_min, t_max)
        t_best, best = merge_tile(t_eff, i * tile, t_best, best)
    valid = best >= 0
    return torch.where(valid, best, 0), t_best, valid


def make_tensor_closest_hit(scene: Scene, t_min: float, tile: int = 2048):
    """Closest-hit function ``closest(o, d) -> (idx, t, valid)`` over
    ``scene`` through :func:`tensor_closest`, hits in (t_min, BIG_T)."""
    tables = pack_sweep_tables(scene, tile=tile)

    def closest(o, d):
        return tensor_closest(tables, o, d, float(t_min), intersect.BIG_T)
    return closest
