"""Branch-free material shading over a wavefront (``scene/materials.py``).

All three lobes are evaluated for every ray and selected by material type.
Material fields are gathered by index (the reference packs them into one
row gather for the TPU; a GPU gathers natively).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from pathtracer_tpu_torch.core import optics, sampling, vec
from pathtracer_tpu_torch.core.rays import HitRecords
from pathtracer_tpu_torch.scene.scene import (MAT_DIELECTRIC, MAT_EMISSIVE,
                                              MAT_LAMBERTIAN, MAT_METAL,
                                              Scene)


class ScatterResult(NamedTuple):
    direction: torch.Tensor    # (N, 3) next ray direction
    attenuation: torch.Tensor  # (N, 3)
    ok: torch.Tensor           # (N,) bool; False = absorbed
    emitted: torch.Tensor      # (N, 3)
    is_emissive: torch.Tensor  # (N,) bool
    is_diffuse: torch.Tensor   # (N,) bool
    is_specular: torch.Tensor  # (N,) bool
    is_glossy: torch.Tensor    # (N,) bool
    glossy_r: torch.Tensor     # (N, 3)
    fuzz: torch.Tensor         # (N,)


def sample_texture(scene: Scene, tex_id, uv):
    """Nearest-neighbour texel of texture ``tex_id`` at ``uv`` (N, 2);
    v = 0 is the bottom row. Coordinates clamp to the edge texels, and
    ``tex_id`` to the atlas. White when the scene has no textures."""
    k, th, tw = scene.textures.shape[:3]
    if k == 0:
        return torch.ones(uv.shape[:-1] + (3,), dtype=torch.float32,
                          device=uv.device)
    u = torch.clamp(uv[..., 0], 0.0, 1.0)
    v = torch.clamp(uv[..., 1], 0.0, 1.0)
    x = torch.clamp((u * tw).to(torch.int64), max=tw - 1)
    y = torch.clamp(((1.0 - v) * th).to(torch.int64), max=th - 1)
    tid = torch.clamp(tex_id.to(torch.int64), 0, k - 1)
    return scene.textures[tid, y, x]


def scatter(scene: Scene, rec: HitRecords, in_dir, uniforms) -> ScatterResult:
    """Evaluate all material lobes for a wavefront of hits.

    ``uniforms`` (N, 6): [0:2] sphere-surface sample (lambertian), [2:5]
    in-sphere sample (metal fuzz), [5] the dielectric reflect/refract coin.
    """
    mat = rec.mat_id
    mtype = scene.mat_type[mat]
    albedo = scene.albedo[mat]
    fuzz = scene.fuzz[mat]
    ir = scene.ir[mat]
    emit = scene.emit[mat]
    tex_id = scene.tex_id[mat]

    n = rec.normal

    # lambertian: normal + on-sphere sample, bare normal when near zero
    sphere_sample = sampling.uniform_on_sphere(uniforms[:, 0], uniforms[:, 1])
    lamb_dir = n + sphere_sample
    lamb_dir = torch.where(vec.near_zero(lamb_dir)[:, None], n, lamb_dir)
    lamb_albedo = albedo
    if scene.textures.shape[0] > 0:
        tex = sample_texture(scene, tex_id, rec.uv)
        lamb_albedo = torch.where((tex_id >= 0)[:, None], albedo * tex,
                                  albedo)

    # metal: reflect + fuzz * in-sphere; absorbed below the surface
    unit_in = vec.normalize(in_dir)
    reflected = optics.reflect(unit_in, n)
    fuzz_vec = sampling.uniform_in_sphere(uniforms[:, 2], uniforms[:, 3],
                                          uniforms[:, 4])
    metal_dir = reflected + fuzz[:, None] * fuzz_vec
    metal_ok = vec.dot(metal_dir, n) > 0.0

    # dielectric: Schlick-probabilistic reflect/refract (ir = 1 off-lobe)
    ir = torch.where(mtype == MAT_DIELECTRIC, ir, 1.0)
    ratio = torch.where(rec.front_face, 1.0 / ir, ir)
    cos_theta = torch.clamp(vec.dot(-unit_in, n), max=1.0)
    sin_theta = vec.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = ratio * sin_theta > 1.0
    schlick = optics.reflectance(cos_theta, ratio)
    use_reflect = cannot_refract | (schlick > uniforms[:, 5])
    diel_dir = torch.where(use_reflect[:, None], optics.reflect(unit_in, n),
                           optics.refract(unit_in, n, ratio))

    is_lamb = (mtype == MAT_LAMBERTIAN)[:, None]
    is_metal = (mtype == MAT_METAL)[:, None]
    is_diel = (mtype == MAT_DIELECTRIC)[:, None]
    is_emissive = mtype == MAT_EMISSIVE

    direction = torch.where(is_lamb, lamb_dir,
                            torch.where(is_metal, metal_dir, diel_dir))
    attenuation = torch.where(is_lamb, lamb_albedo,
                              torch.where(is_metal, albedo,
                                          torch.ones_like(albedo)))
    ok = torch.where(is_metal[:, 0], metal_ok, ~is_emissive)
    emitted = torch.where(is_emissive[:, None], emit, torch.zeros_like(emit))
    is_glossy = is_metal[:, 0] & (fuzz > 0.0)
    return ScatterResult(direction=direction, attenuation=attenuation,
                         ok=ok, emitted=emitted, is_emissive=is_emissive,
                         is_diffuse=is_lamb[:, 0],
                         is_specular=is_metal[:, 0] | is_diel[:, 0],
                         is_glossy=is_glossy, glossy_r=reflected, fuzz=fuzz)
