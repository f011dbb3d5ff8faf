"""Area-light sampling for next-event estimation (``render/lights.py``).

Sampling is uniform over (light choice x surface area); the returned pdf is
with respect to area and includes the 1/L light-choice factor. Triangle
emitters are double-sided. A diffuse or fuzzy-metal hit samples one light
point and casts one shadow ray; the light sample and the BSDF-sampled
emissive hit are combined with the one-sample balance heuristic.
"""
from __future__ import annotations

import torch

from pathtracer_tpu_torch.core import sampling, vec
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE, Scene
from pathtracer_tpu_torch.utils import metrics

FOUR_PI = 4.0 * vec.PI


def sample_lights(scene: Scene, u):
    """One point on one light per ray. ``u`` (R, 3) in [0, 1): [0] the
    light choice, [1:3] the surface sample. Returns (point (R, 3), normal
    (R, 3), emitted (R, 3), pdf_area (R,)), the pdf including the 1/L
    light-choice factor. Needs ``scene.num_lights > 0``."""
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
    return point, normal, emit, pdf


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


def direct_lighting(scene: Scene, rec_p, rec_normal, albedo, closest_hit_fn,
                    u, glossy, eps: float = 1e-3, active=None):
    """One-sample NEE estimate of the direct radiance at diffuse / glossy
    hits; returns (radiance (R, 3), ok (R,) bool).

    L = w * albedo * p_lobe(w_l) * cos_l * emit / (dist^2 * pdf_area), with
    p_lobe cos/pi (lambertian) or :func:`metal_lobe_pdf` where ``glossy =
    (is_glossy, r_unit, fuzz)`` says so, and w the balance-heuristic weight
    against BSDF sampling. The shadow ray starts ``eps`` off the surface
    along the normal and runs along the unnormalized segment to the light
    point, so the light sits at t == 1: a hit with t < 1 - eps occludes.
    The segment goes to ``closest_hit_fn.query_shadow`` (near-zero t_min),
    detached.
    ``active`` (R,) bool: rays whose result is discarded query with
    d == 0."""
    point, n_l, emit, pdf = sample_lights(scene, u)
    origin = rec_p + eps * rec_normal
    seg = point - origin
    dist2 = vec.dot(seg, seg)
    inv_dist = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_s = vec.dot(rec_normal, seg) * inv_dist
    cos_l = torch.abs(vec.dot(n_l, seg)) * inv_dist  # double-sided emitter

    seg_q = seg if active is None else torch.where(active[:, None], seg, 0.0)
    with metrics.span("pt.query", "shadow"):
        _, t_sh, sh_valid = closest_hit_fn.query_shadow(
            origin.detach(), seg_q.detach(), active)
    unoccluded = (~sh_valid) | (t_sh >= 1.0 - eps)

    is_glossy, r_unit, fuzz = glossy
    w_l = seg * inv_dist[:, None]
    p_lobe = torch.where(is_glossy, metal_lobe_pdf(w_l, r_unit, fuzz),
                         torch.clamp(cos_s, min=0.0) * vec.PI_INV)
    geom = p_lobe * cos_l / (torch.clamp(dist2, min=1e-12) * pdf)
    # balance heuristic in solid angle: p_light = pdf * dist^2 / cos_l
    p_light = pdf * dist2 / torch.clamp(cos_l, min=1e-8)
    radiance = (albedo * geom[:, None] * emit
                * (p_light / (p_light + p_lobe))[:, None])
    ok = unoccluded & (cos_s > 0.0) & (cos_l > 0.0) & (p_lobe > 0.0)
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
