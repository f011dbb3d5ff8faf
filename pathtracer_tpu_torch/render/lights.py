"""Area-light sampling for next-event estimation (``render/lights.py``).

Sampling is uniform over (light choice x surface area); the returned pdf is
with respect to area and includes the 1/L light-choice factor. Triangle
emitters are double-sided. A diffuse or fuzzy-metal hit samples one light
point and casts one shadow ray; the light sample and the BSDF-sampled
emissive hit are combined with the one-sample balance heuristic. The
shadow ray's query is the caller's: :func:`direct_lighting` gives what a
light sample brings should nothing occlude it, and the integrator adds it
where the query finds no occluder (``ops/shade.nee_finish``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import sampling, vec
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE, Scene

FOUR_PI = 4.0 * vec.PI


class LightSample(NamedTuple):
    """One point on one light per ray (:func:`sample_lights`)."""
    point: torch.Tensor   # (R, 3)
    normal: torch.Tensor  # (R, 3)
    emit: torch.Tensor    # (R, 3) the light's emitted radiance
    pdf: torch.Tensor     # (R,) area pdf, with the 1/L light-choice factor


def sample_lights(scene: Scene, u) -> LightSample:
    """One point on one light per ray. ``u`` (R, 3) in [0, 1): [0] the
    light choice, [1:3] the surface sample. Needs ``scene.num_lights >
    0``."""
    num_lights = scene.num_lights
    lv = scene.light_idx.long()
    li = torch.clamp((u[:, 0] * num_lights).to(torch.int64), 0,
                     num_lights - 1)
    prim = lv[li]
    ptype = scene.prim_type[prim]
    v0 = scene.v0[prim]
    e1 = scene.e1[prim]
    e2 = scene.e2[prim]
    radius = scene.radius[prim]
    tri_n = scene.tri_normal[prim]
    emit = scene.emit[scene.prim_mat[prim].long()]

    u1, u2 = u[:, 1], u[:, 2]

    # triangle: uniform barycentric (b1 = 1 - sqrt(u1), b2 = u2 * sqrt(u1))
    sq = torch.sqrt(u1)
    b1 = 1.0 - sq
    b2 = u2 * sq
    p_tri = v0 + b1[:, None] * e1 + b2[:, None] * e2
    area_tri = 0.5 * vec.length(vec.cross(e1, e2))

    # sphere: uniform on the whole surface
    omega = sampling.uniform_on_sphere(u1, u2)
    r_abs = torch.abs(radius)
    p_sph = v0 + r_abs[:, None] * omega
    area_sph = FOUR_PI * r_abs * r_abs

    is_sphere = ptype == PRIM_SPHERE
    point = torch.where(is_sphere[:, None], p_sph, p_tri)
    normal = torch.where(is_sphere[:, None], omega, tri_n)
    area = torch.where(is_sphere, area_sph, area_tri)
    pdf = 1.0 / (torch.clamp(area, min=1e-12) * num_lights)
    return LightSample(point, normal, emit, pdf)


def metal_lobe_pdf(w_unit, r_unit, fuzz):
    """Solid-angle density of the fuzzy-metal sampler (direction r + fuzz *
    u, u uniform in the unit ball) at unit direction ``w_unit``:
    (t2^3 - t1^3) / (4 pi fuzz^3), t1,2 = b -+ sqrt(b^2 - 1 + fuzz^2),
    b = w.r, t1 clamped to 0."""
    f = torch.clamp(fuzz, min=1e-4)
    b = vec.dot(w_unit, r_unit)
    disc = b * b - 1.0 + f * f
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    inside = (disc > 0.0) & (b + sq > 0.0)
    t1 = torch.clamp(b - sq, min=0.0)
    t2 = torch.clamp(b + sq, min=0.0)
    pdf = (t2 ** 3 - t1 ** 3) / (FOUR_PI * f ** 3)
    return torch.where(inside, pdf, 0.0)


def shadow_segment(rec_p, rec_normal, point, eps: float):
    """The shadow ray from a hit to its light point: (origin, segment),
    the origin ``eps`` off the surface along the normal, the segment
    unnormalized, so the light sits at t == 1."""
    origin = rec_p + eps * rec_normal
    return origin, point - origin


def direct_lighting(seg, rec_normal, albedo, light: LightSample, glossy):
    """One-sample NEE estimate of the direct radiance at diffuse / glossy
    hits, should nothing occlude the shadow ray's segment ``seg`` (R, 3)
    (:func:`shadow_segment` to ``light.point``); returns (radiance (R, 3),
    ok (R,) bool), the radiance 0 where not ok.

    L = w * albedo * p_lobe(w_l) * cos_l * emit / (dist^2 * pdf_area), with
    p_lobe cos/pi (lambertian) or :func:`metal_lobe_pdf` where ``glossy =
    (is_glossy, r_unit, fuzz)`` says so, and w the balance-heuristic weight
    against BSDF sampling. The caller queries the segment (near-zero
    t_min, detached): a hit with t < 1 - eps occludes."""
    dist2 = vec.dot(seg, seg)
    inv_dist = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_s = vec.dot(rec_normal, seg) * inv_dist
    # double-sided emitter
    cos_l = torch.abs(vec.dot(light.normal, seg)) * inv_dist

    is_glossy, r_unit, fuzz = glossy
    w_l = seg * inv_dist[:, None]
    p_lobe = torch.where(is_glossy, metal_lobe_pdf(w_l, r_unit, fuzz),
                         torch.clamp(cos_s, min=0.0) * vec.PI_INV)
    geom = p_lobe * cos_l / (torch.clamp(dist2, min=1e-12) * light.pdf)
    # balance heuristic in solid angle: p_light = pdf * dist^2 / cos_l
    p_light = light.pdf * dist2 / torch.clamp(cos_l, min=1e-8)
    radiance = (albedo * geom[:, None] * light.emit
                * (p_light / (p_light + p_lobe))[:, None])
    ok = (cos_s > 0.0) & (cos_l > 0.0) & (p_lobe > 0.0)
    return torch.where(ok[:, None], radiance, 0.0), ok


def bsdf_hit_light_weight(scene: Scene, rec, d, prev_pdf):
    """Balance-heuristic weight of a BSDF-sampled emissive hit: ``prev_pdf``
    (the solid-angle pdf of the bounce that chose ``d``) against the area
    pdf of sampling the hit light, in solid angle."""
    d_len = vec.length(d)
    dist = rec.t * d_len
    cos_l = torch.abs(vec.dot(rec.normal, d)) / torch.clamp(d_len,
                                                            min=1e-12)
    p_light = (dist * dist) / (torch.clamp(cos_l, min=1e-8)
                               * torch.clamp(rec.prim_area, min=1e-12)
                               * scene.num_lights)
    return prev_pdf / torch.clamp(prev_pdf + p_light, min=1e-20)
