"""The plain reference renderer, ray by ray in plain PyTorch.

It renders chosen pixels of an image as the CLI renders it: samples
``0 .. n - 1`` of each pixel, summed pass by pass (each pass's samples
summed from zero in order, then added to the framebuffer), from the same
threefry streams:

- sample ``s`` keys ``fold_in(key(seed), s)``; the pixel's chunk (``chunk``
  pixels in raster order) keys ``fold_in(., first pixel of the chunk)``,
  split four ways into (jitter, trace, lens, time) keys;
- the pixel's lane ``j`` in its chunk takes elements ``j`` and ``chunk +
  j`` of the (2, chunk) jitter and lens draws;
- bounce ``k`` draws six uniforms keyed ``fold_in(trace key, k)`` by lane,
  and under NEE three more keyed ``fold_in(fold_in(trace key, k), 1)``;
- with stratified jitter, sample ``s`` falls in stratum ``s mod m^2`` of
  an m x m sub-pixel grid (column ``stratum mod m``, row ``stratum // m``),
  m the largest integer whose square divides the spp the image's renderer
  was built for.

Closest hit is a dense scan of every primitive (Moller-Trumbore with
strict edge rejection, the two-root sphere test), ties to the lowest
index. ``precision="tf32"`` rounds every operand of its products to TF32
(10 mantissa bits, as a tensor core reads float32), the control of the
comparison, shadow rays included; shading stays float32. Lambertian
(its albedo times the nearest texel at the hit's UV where the material
has a texture), metal (fuzz) and dielectric (Schlick) scattering; a
miss, or a path out of bounces, takes the white-to-blue sky times its
attenuation, or nothing with the sky off; an absorbed path is black.

Next-event estimation (``nee``; Veach 1997, ch. 9, the one-sample
balance heuristic): every hit on a diffuse or fuzzy-metal surface picks
one point on one emitter, uniform over (emitter, area), area pdf 1 / (L
area) for L emitting primitives, a sphere over its whole surface, a
triangle lit on both faces; casts one shadow ray from the hit offset
``t_min`` along the normal, over the segment to that point with t in
(1e-7, 3e38), the point unoccluded where nothing is hit before t = 1 -
``t_min``; and adds attenuation x albedo x f x |cos_l| x emission /
(dist^2 pdf) x p_light / (p_light + f), f the BSDF's solid-angle pdf of
the light's direction (cos / pi, or the metal lobe's, :func:`metal_lobe_pdf`)
and p_light = pdf dist^2 / |cos_l|. An emitter that a BSDF-sampled ray
hits counts f_prev / (f_prev + p_light) of its emission, f_prev the pdf
of the bounce that chose the ray; after a camera ray or a delta lobe
(mirror, glass) it counts whole. Departures from Veach's one-sample
model: each hit takes one sample of each technique (the light point and
the BSDF's own direction), both weighted by the balance heuristic, where
the one-sample model picks a single technique at random; the light term
is added whether or not the hit's own BSDF sample survives (a fuzzy-metal
direction below the surface); the shadow ray and its cosine start at the
offset origin; and the divisors are clamped as the program's are (area
and dist^2 at 1e-12, |cos_l| at 1e-8, the weight's sum at 1e-20).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from perfbench.reference import threefry as tf
from perfbench.reference.scenes.plain import (DIELECTRIC, EMISSIVE,
                                              LAMBERTIAN, METAL, SPHERE,
                                              PlainScene)

PI = 3.1415926535897932385
PI_INV = 1.0 / PI
BIG_T = 3.0e38
# the shadow ray's t_min: its origin is already offset off the surface
SHADOW_T_MIN = 1e-7
# elements of a (rays x primitives) block of the closest-hit scan
BLOCK_PAIRS = 1 << 24


def tf32(x):
    """float32 rounded to nearest-even at TF32's 10 mantissa bits."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x0FFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _mul32(a, b):
    return a * b


def _mul_tf32(a, b):
    if isinstance(a, torch.Tensor):
        a = tf32(a)
    if isinstance(b, torch.Tensor):
        b = tf32(b)
    return a * b


def dot(a, b, mul=_mul32):
    return (mul(a[..., 0], b[..., 0]) + mul(a[..., 1], b[..., 1])
            + mul(a[..., 2], b[..., 2]))


def cross(a, b, mul=_mul32):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([mul(ay, bz) - mul(az, by),
                        mul(az, bx) - mul(ax, bz),
                        mul(ax, by) - mul(ay, bx)], dim=-1)


def normalize(a):
    return a / torch.sqrt(dot(a, a))[..., None]


def sphere_t(o, d, c, r, t_min, mul=_mul32):
    """(hit, t) of rays against spheres (broadcast): the nearest root in
    (t_min, BIG_T), else the far one."""
    oc = o - c
    a = dot(d, d, mul)
    half_b = dot(oc, d, mul)
    cc = dot(oc, oc, mul) - mul(r, r)
    disc = mul(half_b, half_b) - mul(a, cc)
    pos = disc > 0.0
    sq = torch.where(pos, torch.sqrt(torch.where(pos, disc, 1.0)), 0.0)
    inv_a = 1.0 / a
    r0 = mul(-half_b - sq, inv_a)
    r1 = mul(-half_b + sq, inv_a)
    ok0 = ~((r0 < t_min) | (BIG_T < r0))
    ok1 = ~((r1 < t_min) | (BIG_T < r1))
    return (disc >= 0.0) & (ok0 | ok1), torch.where(ok0, r0, r1)


def triangle_t(o, d, v0, e1, e2, t_min, mul=_mul32):
    """(hit, t) of rays against triangles (broadcast); a ray through an
    edge or parallel to the plane misses."""
    s1 = cross(d, e2, mul)
    det = dot(s1, e1, mul)
    inv = 1.0 / torch.where(det == 0.0, 1.0, det)
    s = o - v0
    s2 = cross(s, e1, mul)
    t = mul(dot(s2, e2, mul), inv)
    b1 = mul(dot(s1, s, mul), inv)
    b2 = mul(dot(s2, d, mul), inv)
    miss = ((det == 0.0) | (b1 >= 1.0) | (b1 <= 0.0) | (b2 >= 1.0)
            | (b2 <= 0.0) | (b1 + b2 <= 0.0) | (b1 + b2 >= 1.0)
            | (t <= t_min) | (t >= BIG_T))
    return ~miss, t


class Geometry:
    """The scene's primitives on a device, split by kind with their
    indices, and its materials."""

    def __init__(self, scene: PlainScene, device):
        def f32(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=device)
        sph = np.nonzero(scene.ptype == SPHERE)[0]
        tri = np.nonzero(scene.ptype != SPHERE)[0]
        self.sph_idx = torch.as_tensor(sph, device=device)
        self.tri_idx = torch.as_tensor(tri, device=device)
        self.center, self.radius = f32(scene.v0[sph]), f32(scene.radius[sph])
        self.v0, self.e1, self.e2 = (f32(scene.v0[tri]), f32(scene.e1[tri]),
                                     f32(scene.e2[tri]))
        self.all_v0, self.all_e1, self.all_e2 = (f32(scene.v0),
                                                 f32(scene.e1),
                                                 f32(scene.e2))
        self.all_radius, self.normal = f32(scene.radius), f32(scene.normal)
        self.is_sphere = torch.as_tensor(scene.ptype == SPHERE, device=device)
        self.pmat = torch.as_tensor(scene.pmat, device=device)
        self.mtype = torch.as_tensor(scene.mtype, device=device)
        self.albedo, self.fuzz = f32(scene.albedo), f32(scene.fuzz)
        self.ir, self.emit = f32(scene.ir), f32(scene.emit)
        self.tex_id = torch.as_tensor(scene.tex_id, device=device)
        self.textures = f32(scene.textures)
        self.lights = torch.as_tensor(
            np.nonzero(scene.mtype[scene.pmat] == EMISSIVE)[0],
            device=device)
        self.n = len(scene.ptype)


def closest_hit(g: Geometry, o, d, t_min: float, precision: str = "fp32"):
    """(index, hit, t) of each ray's nearest primitive by a dense scan."""
    mul = _mul_tf32 if precision == "tf32" else _mul32
    n_rays = o.shape[0]
    best_t = torch.full((n_rays,), BIG_T, device=o.device)
    best_i = torch.zeros(n_rays, dtype=torch.int64, device=o.device)
    rows = max(1, BLOCK_PAIRS // max(g.n, 1))
    for lo in range(0, n_rays, rows):
        ob, db = o[lo:lo + rows, None, :], d[lo:lo + rows, None, :]
        t_run = best_t[lo:lo + rows]
        i_run = best_i[lo:lo + rows]
        for idx, hit_t in (
                (g.sph_idx, lambda: sphere_t(ob, db, g.center[None],
                                             g.radius[None], t_min, mul)),
                (g.tri_idx, lambda: triangle_t(ob, db, g.v0[None],
                                               g.e1[None], g.e2[None], t_min,
                                               mul))):
            if idx.numel() == 0:
                continue
            hit, t = hit_t()
            t = torch.where(hit, t, BIG_T)
            j = torch.argmin(t, dim=1)
            tj = torch.gather(t, 1, j[:, None])[:, 0]
            ij = idx[j]
            better = (tj < t_run) | ((tj == t_run) & (tj < BIG_T)
                                     & (ij < i_run))
            t_run = torch.where(better, tj, t_run)
            i_run = torch.where(better, ij, i_run)
        best_t[lo:lo + rows] = t_run
        best_i[lo:lo + rows] = i_run
    return best_i, best_t < BIG_T, best_t


def camera_basis(cam: dict, device):
    """(position, lower_left, horizontal, vertical, right, up, lens
    radius) of a thin-lens look-at camera, in float32."""
    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)
    look_from, look_at = f32(cam["look_from"]), f32(cam["look_at"])
    theta = f32(cam["vfov"]) * 0.01745329252
    vh = 2.0 * torch.tan(theta / 2.0)
    vw = cam["aspect"] * vh
    front = normalize(look_from - look_at)
    right = normalize(cross(f32([0.0, 1.0, 0.0]), front))
    up = cross(front, right)
    fd = cam["focus_dist"]
    horizontal = fd * vw * right
    vertical = fd * vh * up
    lower_left = look_from - horizontal / 2.0 - vertical / 2.0 - fd * front
    return (look_from, lower_left, horizontal, vertical, right, up,
            f32(cam["aperture"] / 2.0))


def on_sphere(u1, u2):
    phi = (2.0 * PI) * u1
    cos_t = 1.0 - 2.0 * u2
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    return torch.stack([torch.cos(phi) * sin_t, torch.sin(phi) * sin_t,
                        cos_t], dim=-1)


def safe_sqrt(x):
    pos = x > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def reflect(v, n):
    return v - 2.0 * dot(v, n)[:, None] * n


class Hit(NamedTuple):
    p: torch.Tensor        # (R, 3) point
    normal: torch.Tensor   # (R, 3) facing the ray
    front: torch.Tensor    # (R,) bool: the ray meets the outward side
    mat: torch.Tensor      # (R,) material
    t: torch.Tensor        # (R,)
    outward: torch.Tensor  # (R, 3) outward normal (a sphere's: (p - c) / r)
    sphere: torch.Tensor   # (R,) bool
    area: torch.Tensor     # (R,) the primitive's area


def hit_record(g: Geometry, idx, o, d, t_min: float) -> Hit:
    """The hit of each ray's winner, its t evaluated again in float32."""
    sph = g.is_sphere[idx]
    v0, r = g.all_v0[idx], g.all_radius[idx]
    e1, e2 = g.all_e1[idx], g.all_e2[idx]
    _, ts = sphere_t(o, d, v0, r, t_min)
    _, tt = triangle_t(o, d, v0, e1, e2, t_min)
    t = torch.where(sph, ts, tt)
    p = o + t[:, None] * d
    safe_r = torch.where(r == 0.0, 1.0, r)
    outward = torch.where(sph[:, None], (p - v0) / safe_r[:, None],
                          g.normal[idx])
    front = dot(d, outward) < 0.0
    normal = torch.where(front[:, None], outward, -outward)
    area = torch.where(sph, (4.0 * PI) * r * r,
                       0.5 * torch.sqrt(dot(cross(e1, e2), cross(e1, e2))))
    return Hit(p, normal, front, g.pmat[idx], t, outward, sph, area)


def sphere_uv(outward):
    """(u, v) of a point on a sphere by its outward normal n: u = (atan2(-n_z,
    n_x) + pi) / 2 pi, v = acos(-n_y) / pi (0 at the bottom pole); at a pole
    u = 1/2."""
    y = torch.clamp(-outward[:, 1], -1.0, 1.0)
    x, z = outward[:, 0], -outward[:, 2]
    pole = (x * x + z * z) < 1e-12
    phi = torch.atan2(torch.where(pole, 0.0, z), torch.where(pole, 1.0, x))
    return (phi + PI) * 0.5 * PI_INV, torch.acos(y) * PI_INV


def texel(g: Geometry, tex, u, v):
    """The nearest texel of texture ``tex`` (R,) at (u, v), both clamped to
    [0, 1]; v = 0 is the stack's last row. Column floor(u W), row floor((1
    - v) H), each at most the last."""
    _, th, tw, _ = g.textures.shape
    u = torch.clamp(u, 0.0, 1.0)
    v = torch.clamp(v, 0.0, 1.0)
    x = torch.clamp((u * tw).to(torch.int64), max=tw - 1)
    y = torch.clamp(((1.0 - v) * th).to(torch.int64), max=th - 1)
    return g.textures[tex, y, x]


def scatter(g: Geometry, hit: Hit, d, u):
    """(direction, attenuation, ok, emitted, is_emissive, mirror direction)
    of a hit."""
    mat, normal, front = hit.mat, hit.normal, hit.front
    mt = g.mtype[mat]
    albedo, fuzz, emit = g.albedo[mat], g.fuzz[mat], g.emit[mat]
    lamb_albedo = albedo
    if g.textures.shape[0] > 0:
        tex = g.tex_id[mat]
        textured = (mt == LAMBERTIAN) & (tex >= 0)
        su, sv = sphere_uv(hit.outward)
        # triangles have (u, v) = (0, 0)
        su = torch.where(hit.sphere, su, 0.0)
        sv = torch.where(hit.sphere, sv, 0.0)
        lamb_albedo = torch.where(
            textured[:, None],
            albedo * texel(g, torch.clamp(tex, min=0), su, sv), albedo)
    lamb = normal + on_sphere(u[:, 0], u[:, 1])
    near0 = torch.all(torch.abs(lamb) < 1e-7, dim=-1)
    lamb = torch.where(near0[:, None], normal, lamb)

    unit = normalize(d)
    refl = reflect(unit, normal)
    in_ball = on_sphere(u[:, 2], u[:, 3]) * torch.pow(u[:, 4],
                                                      1.0 / 3.0)[:, None]
    metal = refl + fuzz[:, None] * in_ball
    metal_ok = dot(metal, normal) > 0.0

    ir = torch.where(mt == DIELECTRIC, g.ir[mat], 1.0)
    eta = torch.where(front, 1.0 / ir, ir)
    cos_t = torch.clamp(dot(-unit, normal), max=1.0)
    sin_t = safe_sqrt(1.0 - cos_t * cos_t)
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    schlick = r0 + (1.0 - r0) * torch.pow(1.0 - cos_t, 5.0)
    use_refl = (eta * sin_t > 1.0) | (schlick > u[:, 5])
    perp = eta[:, None] * (unit + cos_t[:, None] * normal)
    par = -safe_sqrt(torch.abs(1.0 - dot(perp, perp)))[:, None] * normal
    diel = torch.where(use_refl[:, None], refl, perp + par)

    is_l, is_m = (mt == LAMBERTIAN)[:, None], (mt == METAL)[:, None]
    is_e = mt == EMISSIVE
    direction = torch.where(is_l, lamb, torch.where(is_m, metal, diel))
    atten = torch.where(is_l, lamb_albedo,
                        torch.where(is_m, albedo, torch.ones_like(albedo)))
    ok = torch.where(is_m[:, 0], metal_ok, ~is_e)
    emitted = torch.where(is_e[:, None], emit, torch.zeros_like(emit))
    return direction, atten, ok, emitted, is_e, refl


def sky(d):
    t = 0.5 * (normalize(d)[:, 1] + 1.0)
    white = d.new_tensor((1.0, 1.0, 1.0))
    blue = d.new_tensor((0.5, 0.7, 1.0))
    return (1.0 - t)[:, None] * white + t[:, None] * blue


def metal_lobe_pdf(w, r, fuzz):
    """Solid-angle density at unit direction ``w`` of the fuzzy-metal
    direction r + fuzz x (a point uniform in the unit ball), r the unit
    mirror direction: the ball's volume between the distances t1 and t2
    at which the ray along w meets it, (t2^3 - t1^3) / (4 pi fuzz^3), t1,2
    = b -+ sqrt(b^2 - 1 + fuzz^2), b = w.r, t1 at least 0; fuzz at least
    1e-4."""
    f = torch.clamp(fuzz, min=1e-4)
    b = dot(w, r)
    disc = b * b - 1.0 + f * f
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t1 = torch.clamp(b - sq, min=0.0)
    t2 = torch.clamp(b + sq, min=0.0)
    pdf = (t2 ** 3 - t1 ** 3) / ((4.0 * PI) * f ** 3)
    return torch.where((disc > 0.0) & (b + sq > 0.0), pdf, 0.0)


def light_sample(g: Geometry, u):
    """(point, its normal, emission, area pdf with the 1/L of the choice)
    of one point on one emitter a ray: emitter floor(u0 L); on a triangle
    barycentrics (1 - sqrt(u1), u2 sqrt(u1)), on a sphere the direction
    ``on_sphere(u1, u2)`` from its centre."""
    n_lights = g.lights.numel()
    pick = torch.clamp((u[:, 0] * n_lights).to(torch.int64), 0,
                       n_lights - 1)
    prim = g.lights[pick]
    v0, e1, e2 = g.all_v0[prim], g.all_e1[prim], g.all_e2[prim]
    r = torch.abs(g.all_radius[prim])
    sph = g.is_sphere[prim][:, None]
    sq = torch.sqrt(u[:, 1])
    b1, b2 = 1.0 - sq, u[:, 2] * sq
    on_tri = v0 + b1[:, None] * e1 + b2[:, None] * e2
    tri_area = 0.5 * torch.sqrt(dot(cross(e1, e2), cross(e1, e2)))
    omega = on_sphere(u[:, 1], u[:, 2])
    point = torch.where(sph, v0 + r[:, None] * omega, on_tri)
    normal = torch.where(sph, omega, g.normal[prim])
    area = torch.where(sph[:, 0], (4.0 * PI) * r * r, tri_area)
    pdf = 1.0 / (torch.clamp(area, min=1e-12) * n_lights)
    return point, normal, g.emit[g.pmat[prim]], pdf


def direct_light(g: Geometry, hit: Hit, albedo, glossy, refl, fuzz, u,
                 t_min: float, precision: str):
    """The light term (R, 3) of hits (module docstring), before the path's
    attenuation; ``u`` (R, 3) its uniforms."""
    point, n_l, emit, pdf = light_sample(g, u)
    origin = hit.p + t_min * hit.normal
    seg = point - origin
    dist2 = dot(seg, seg)
    inv_dist = 1.0 / torch.sqrt(torch.clamp(dist2, min=1e-12))
    cos_s = dot(hit.normal, seg) * inv_dist
    cos_l = torch.abs(dot(n_l, seg)) * inv_dist
    _, blocked, t_sh = closest_hit(g, origin, seg, SHADOW_T_MIN, precision)
    unoccluded = ~blocked | (t_sh >= 1.0 - t_min)
    w = seg * inv_dist[:, None]
    f = torch.where(glossy, metal_lobe_pdf(w, refl, fuzz),
                    torch.clamp(cos_s, min=0.0) * PI_INV)
    geom = f * cos_l / (torch.clamp(dist2, min=1e-12) * pdf)
    p_light = pdf * dist2 / torch.clamp(cos_l, min=1e-8)
    radiance = (albedo * geom[:, None] * emit
                * (p_light / (p_light + f))[:, None])
    ok = unoccluded & (cos_s > 0.0) & (cos_l > 0.0) & (f > 0.0)
    return torch.where(ok[:, None], radiance, 0.0)


def emitter_weight(g: Geometry, hit: Hit, d, f_prev):
    """Balance-heuristic weight of an emitter hit by a BSDF-sampled ray
    ``d`` chosen with solid-angle pdf ``f_prev``."""
    d_len = torch.sqrt(dot(d, d))
    dist = hit.t * d_len
    cos_l = torch.abs(dot(hit.normal, d)) / torch.clamp(d_len, min=1e-12)
    p_light = (dist * dist) / (torch.clamp(cos_l, min=1e-8)
                               * torch.clamp(hit.area, min=1e-12)
                               * g.lights.numel())
    return f_prev / torch.clamp(f_prev + p_light, min=1e-20)


def trace(g: Geometry, o, d, tkey, lane, max_depth: int, t_min: float,
          precision: str, sky_on: bool = True, nee: bool = False):
    """Radiance (R, 3) of rays whose bounce draws key ``fold_in(tkey,
    k)`` (per-ray key words) by ``lane``; ``sky_on`` and ``nee`` as the
    module docstring says (NEE only where the scene has emitters)."""
    n = o.shape[0]
    dev = o.device
    atten = torch.ones((n, 3), device=dev)
    emitted = torch.zeros((n, 3), device=dev)
    absorbed = torch.zeros(n, dtype=torch.bool, device=dev)
    nee = nee and g.lights.numel() > 0
    if nee:
        # the last bounce was a camera ray or a delta lobe; the solid-angle
        # pdf of the last BSDF sample that a light sample went with
        delta_prev = torch.ones(n, dtype=torch.bool, device=dev)
        f_prev = torch.zeros(n, device=dev)
    live = torch.arange(n, device=dev)
    for k in range(max_depth):
        if live.numel() == 0:
            break
        ol, dl, al = o[live], d[live], atten[live]
        bkey = tf.fold_in((tkey[0][live], tkey[1][live]), k)
        u = tf.uniform_rows(bkey, lane[live], 6)
        idx, valid, _ = closest_hit(g, ol, dl, t_min, precision)
        hit = hit_record(g, idx, ol, dl, t_min)
        direction, att, ok, emit, is_e, refl = scatter(g, hit, dl, u)
        hit_e = valid & is_e
        e_add = al * emit
        if nee:
            e_add = e_add * torch.where(
                delta_prev[live], 1.0,
                emitter_weight(g, hit, dl, f_prev[live]))[:, None]
        emitted[live] += torch.where(hit_e[:, None], e_add, 0.0)
        absorbed[live] |= (valid & ~is_e & ~ok) | hit_e
        step = valid & ok & ~is_e
        if nee:
            mt, fuzz = g.mtype[hit.mat], g.fuzz[hit.mat]
            glossy = (mt == METAL) & (fuzz > 0.0)
            take = valid & ~is_e & ((mt == LAMBERTIAN) | glossy)
            sel = torch.nonzero(take)[:, 0]
            u_nee = tf.uniform_rows(
                tf.fold_in((bkey[0][sel], bkey[1][sel]), 1),
                lane[live[sel]], 3)
            direct = direct_light(g, Hit(*(x[sel] for x in hit)), att[sel],
                                  glossy[sel], refl[sel], fuzz[sel], u_nee,
                                  t_min, precision)
            emitted[live[sel]] += al[sel] * direct
            delta = ((mt == METAL) | (mt == DIELECTRIC)) & ~glossy
            delta_prev[live] = torch.where(step, delta, delta_prev[live])
            w = direction / torch.sqrt(
                torch.clamp(dot(direction, direction), min=1e-20))[:, None]
            f = torch.where(glossy, metal_lobe_pdf(w, refl, fuzz),
                            torch.clamp(dot(hit.normal, w), min=0.0)
                            * PI_INV)
            f_prev[live] = torch.where(step & take, f, f_prev[live])
        o[live] = torch.where(step[:, None], hit.p, ol)
        d[live] = torch.where(step[:, None], direction, dl)
        atten[live] = torch.where(step[:, None], al * att, al)
        live = live[step]
    if not sky_on:
        return emitted
    return emitted + torch.where(absorbed[:, None], 0.0, atten * sky(d))


def stratum_grid(spp: int) -> int:
    """The largest m whose square divides ``spp``."""
    return max(m for m in range(1, math.isqrt(spp) + 1)
               if spp % (m * m) == 0)


def render_pixels(scene: PlainScene, pixels, width: int, height: int,
                  chunk: int, seed: int, samples: int, pass_spp: int,
                  max_depth: int, t_min: float, device,
                  precision: str = "fp32", sky_on: bool = True,
                  nee: bool = False, stratify_spp=None):
    """Framebuffer rows (P, 3) of ``pixels`` (raster indices) after
    ``samples`` samples rendered in passes of ``pass_spp``. ``chunk`` is
    the renderer's ray chunk (min of its setting and the pixel count).
    ``stratify_spp``, where given, stratifies the jitter on the grid of
    that many samples an image (the spp the renderer was built for)."""
    g = Geometry(scene, device)
    pos, ll, hor, ver, right, up, lens = camera_basis(scene.camera, device)
    pix = torch.as_tensor(pixels, dtype=torch.int64, device=device)
    row = (pix // width).to(torch.float32)
    col = (pix % width).to(torch.float32)
    lane = pix % chunk
    first = pix - lane
    base = tf.key(seed)
    # rays sample-major: ray (s, i) is sample s of pixel i
    n_pix = pix.numel()
    s_r = torch.arange(samples, device=device).repeat_interleave(n_pix)
    lane_r, first_r = lane.repeat(samples), first.repeat(samples)
    skey = tf.fold_in(base, s_r)
    ckey = tf.fold_in(skey, first_r)
    pkey, tkey, lkey, _ = tf.split(ckey, 4)
    xi0 = tf.uniform_at(pkey, lane_r)
    xi1 = tf.uniform_at(pkey, chunk + lane_r)
    m = stratum_grid(stratify_spp) if stratify_spp else 1
    if m > 1:
        stratum = s_r % (m * m)
        xi0 = ((stratum % m).to(torch.float32) + xi0) * (1.0 / m)
        xi1 = ((stratum // m).to(torch.float32) + xi1) * (1.0 / m)
    ud1 = tf.uniform_at(lkey, lane_r)
    ud2 = tf.uniform_at(lkey, chunk + lane_r)
    u = (col.repeat(samples) + xi0) * (1.0 / width)
    v = (row.repeat(samples) + xi1) * (1.0 / height)
    rad = torch.sqrt(ud1)
    th = (2.0 * PI) * ud2
    rd0 = lens * (rad * torch.cos(th))
    rd1 = lens * (rad * torch.sin(th))
    offset = right[None, :] * rd0[:, None] + up[None, :] * rd1[:, None]
    o = pos[None, :] + offset
    d = (ll[None, :] + u[:, None] * hor[None, :]
         + v[:, None] * ver[None, :] - pos[None, :] - offset)
    radiance = trace(g, o, d, tkey, lane_r, max_depth, t_min, precision,
                     sky_on, nee).view(samples, n_pix, 3)
    acc = torch.zeros((n_pix, 3), device=device)
    for p0 in range(0, samples, pass_spp):
        part = torch.zeros_like(acc)
        for s in range(p0, min(p0 + pass_spp, samples)):
            part = part + radiance[s]
        acc = acc + part
    return acc

