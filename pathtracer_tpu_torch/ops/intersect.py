"""Branch-free ray/primitive intersection (``ops/intersect.py``).

Sphere: quadratic with two-root selection. Triangle: Moller-Trumbore with
strict edge rejection and a ``det == 0`` parallel reject, so rays that
graze an edge exactly miss, as in the reference.
"""
from __future__ import annotations

import torch

from pathtracer_tpu_torch.core import rays as rays_mod
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE, Scene

BIG_T = 3.0e38


def ray_aabb_hit(o, d, bmin, bmax, t_min, t_max):
    """Slab test; o, d, bmin, bmax broadcastable (..., 3), t_min, t_max
    (...,) or scalars. Returns bool (...,).

    ``1 / d`` is infinite on an axis-aligned ray, and ``(bmin - o) * inf``
    is NaN where bmin == o. The running bounds take an axis's time only
    where a comparison with it holds, so a NaN falls through to the bound
    (as the reference's selects do); ``torch.maximum`` and ``clamp`` would
    propagate it instead."""
    inv = 1.0 / d
    t0 = (bmin - o) * inv
    t1 = (bmax - o) * inv
    swap = inv < 0.0
    lo = torch.where(swap, t1, t0)
    hi = torch.where(swap, t0, t1)
    tmin_r, tmax_r = t_min, t_max
    for a in range(3):
        tmin_r = torch.where(lo[..., a] > tmin_r, lo[..., a], tmin_r)
        tmax_r = torch.where(hi[..., a] < tmax_r, hi[..., a], tmax_r)
    return ~(tmax_r < tmin_r)


def intersect_sphere(o, d, center, radius, t_min, t_max):
    """Returns (hit, t); nearest root in range preferred, else the far
    root. ``radius`` is signed."""
    oc = o - center
    a = vec.dot(d, d)
    half_b = vec.dot(oc, d)
    c = vec.dot(oc, oc) - radius * radius
    disc = half_b * half_b - a * c
    hit_mask = disc > 0.0
    sqrt_d = torch.where(hit_mask, torch.sqrt(torch.where(hit_mask, disc,
                                                          1.0)), 0.0)
    inv_a = 1.0 / a
    root0 = (-half_b - sqrt_d) * inv_a
    root1 = (-half_b + sqrt_d) * inv_a
    ok0 = ~((root0 < t_min) | (t_max < root0))
    ok1 = ~((root1 < t_min) | (t_max < root1))
    t = torch.where(ok0, root0, root1)
    hit = (disc >= 0.0) & (ok0 | ok1)
    return hit, t


def intersect_triangle(o, d, v0, e1, e2, t_min, t_max):
    """Returns (hit, t, b1, b2) with the reference's strict rejections."""
    s1 = vec.cross(d, e2)
    det = vec.dot(s1, e1)
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    s = o - v0
    s2 = vec.cross(s, e1)
    t = vec.dot(s2, e2) * inv_det
    b1 = vec.dot(s1, s) * inv_det
    b2 = vec.dot(s2, d) * inv_det
    miss = ((det == 0.0)
            | (b1 >= 1.0) | (b1 <= 0.0)
            | (b2 >= 1.0) | (b2 <= 0.0)
            | (b1 + b2 <= 0.0) | (b1 + b2 >= 1.0)
            | (t <= t_min) | (t >= t_max))
    return ~miss, t, b1, b2


def intersect_prims(o, d, prim_type, v0, e1, e2, radius, t_min, t_max):
    """Both tests on broadcastable (ray, prim) arrays, selected by type.
    Returns (hit, t)."""
    s_hit, s_t = intersect_sphere(o, d, v0, radius, t_min, t_max)
    t_hit, t_t, _, _ = intersect_triangle(o, d, v0, e1, e2, t_min, t_max)
    is_sphere = prim_type == PRIM_SPHERE
    return (torch.where(is_sphere, s_hit, t_hit),
            torch.where(is_sphere, s_t, t_t))


def brute_force_closest(scene: Scene, o, d, t_min, t_max):
    """Linear scan over all primitives as a dense (R, N) sweep. Returns
    (prim_idx, t, valid); ties in t go to the lowest index."""
    hit, t = intersect_prims(
        o[:, None, :], d[:, None, :], scene.prim_type[None, :],
        scene.v0[None, :, :], scene.e1[None, :, :], scene.e2[None, :, :],
        scene.radius[None, :], t_min, t_max)
    t_eff = torch.where(hit, t, BIG_T)
    idx = torch.argmin(t_eff, dim=1)
    t_best = torch.gather(t_eff, 1, idx[:, None])[:, 0]
    return idx, t_best, t_best < BIG_T


def packed_hit_fields(scene: Scene):
    """(N, 16) f32 rows [prim_type, v0, e1, e2, radius, tri_normal,
    prim_mat, 0]: one gather by winner index fetches a hit's fields."""
    n = scene.num_prims
    return torch.cat([
        scene.prim_type.to(torch.float32)[:, None],
        scene.v0, scene.e1, scene.e2, scene.radius[:, None],
        scene.tri_normal, scene.prim_mat.to(torch.float32)[:, None],
        torch.zeros((n, 1), dtype=torch.float32, device=scene.device),
    ], dim=1)


def hit_records_from_prims(scene: Scene, idx, o, d, t_min, t_max, valid,
                           packed=None) -> rays_mod.HitRecords:
    """Recompute t / p / normal / uv for each ray's winning primitive.

    ``packed`` is :func:`packed_hit_fields` of ``scene`` (built here when
    not given); the winner's fields come from one index gather into it."""
    if packed is None:
        packed = packed_hit_fields(scene)
    rows = packed[idx]
    ptype = rows[:, 0].to(torch.int32)
    v0 = rows[:, 1:4]
    e1 = rows[:, 4:7]
    e2 = rows[:, 7:10]
    radius = rows[:, 10]
    tri_n = rows[:, 11:14]
    mat_id = rows[:, 14].to(torch.int64)

    s_hit, s_t = intersect_sphere(o, d, v0, radius, t_min, t_max)
    tr_hit, tr_t, b1, b2 = intersect_triangle(o, d, v0, e1, e2, t_min, t_max)

    is_sphere = ptype == PRIM_SPHERE
    t = torch.where(is_sphere, s_t, tr_t)
    p = o + t[:, None] * d

    # sphere outward normal (p - center) / radius; signed radius flips it
    # inward for hollow glass; radius 0 (padding rows) guarded
    safe_r = torch.where(radius == 0.0, 1.0, radius)
    sph_n = (p - v0) / safe_r[:, None]
    outward = torch.where(is_sphere[:, None], sph_n, tri_n)
    front_face, normal = rays_mod.set_face_normal(d, outward)

    # sphere UV; triangles leave uv = 0. acos has an infinite derivative
    # at the poles (|y| = 1), which would NaN the v0 gradient; under
    # autograd the value is taken at y and the gradient at y clipped a step
    # inside (as the reference does)
    y = torch.clamp(-sph_n[:, 1], -1.0, 1.0)
    theta = torch.acos(y)
    if theta.requires_grad:
        theta_safe = torch.acos(torch.clamp(y, -1.0 + 1e-6, 1.0 - 1e-6))
        theta = theta_safe + (theta - theta_safe).detach()
    x, z = sph_n[:, 0], -sph_n[:, 2]
    on_pole = (x * x + z * z) < 1e-12
    phi = torch.atan2(torch.where(on_pole, 0.0, z),
                      torch.where(on_pole, 1.0, x)) + vec.PI
    uv = torch.where(is_sphere[:, None],
                     torch.stack([phi * 0.5 * vec.PI_INV,
                                  theta * vec.PI_INV], dim=-1), 0.0)

    area_sph = 4.0 * vec.PI * radius * radius
    area_tri = 0.5 * vec.length(vec.cross(e1, e2))
    prim_area = torch.where(is_sphere, area_sph, area_tri)

    return rays_mod.HitRecords(p=p, normal=normal, mat_id=mat_id, t=t, uv=uv,
                               front_face=front_face, valid=valid,
                               prim_id=idx, prim_area=prim_area)
