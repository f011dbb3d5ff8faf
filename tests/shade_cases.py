"""Inputs of one bounce's shading step (``ops/shade.shade_bounce``, and
under NEE ``shade_nee``) for the shading tests: the CPU twin against the
JAX package (``test_torch_shade.py``) and the kernels against their twins
on the card (``test_torch_cuda.py``). Imports neither jax nor the JAX
package.

A case is a primitive kind and a material kind: a scene of a distant
distractor sphere (row 0) and the target (row 1) with that material, a
wavefront aimed at the target from a spread of angles down to grazing
(from inside the sphere, or from behind the triangle, for the dielectric's
back face), with some dead lanes and some misses, the winners of a brute
scan, the scatter and roulette uniforms and a path state, all made from
numpy with a fixed seed. An NEE case adds two emitters, a triangle and a
sphere, far from the wavefront (the target is a third where it is the
emissive case), and the NEE state: spec_prev, the last bounce's pdf and
the light-sample uniforms.
"""
from __future__ import annotations

import numpy as np
import torch

from pathtracer_tpu_torch.ops import intersect, shade
from pathtracer_tpu_torch.scene.scene import SceneBuilder

PRIMS = ("sphere", "triangle")
MATERIALS = ("lambertian", "textured", "metal", "metal_fuzz_below",
             "dielectric_front", "dielectric_back_tir", "emissive")
N = 512
T_MIN = 1e-3
TRIANGLE = ((-2.0, -2.0, 0.0), (2.0, -2.0, 0.0), (0.0, 2.5, 0.0))
# the NEE case's emitters, away from every ray of the wavefront
LIGHT_TRIANGLE = ((-9.0, 6.0, 7.0), (-7.0, 6.0, 7.0), (-8.0, 6.5, 9.0))
LIGHT_SPHERE = ((-9.0, -1.0, -9.0), 0.75)


def _material(b: SceneBuilder, material: str) -> int:
    if material == "lambertian":
        return b.add_lambertian((0.7, 0.5, 0.3))
    if material == "textured":
        tex = np.random.default_rng(3).random((4, 8, 3), dtype=np.float32)
        return b.add_lambertian((0.9, 0.8, 0.7), tex_id=b.add_texture(tex))
    if material == "metal":
        return b.add_metal((0.8, 0.8, 0.9), 0.0)
    if material == "metal_fuzz_below":
        return b.add_metal((0.9, 0.6, 0.4), 0.9)
    if material.startswith("dielectric"):
        return b.add_dielectric(1.5)
    return b.add_emissive((4.0, 3.0, 2.0))


def _unit(rng, n):
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _rays(rng, prim: str, back: bool):
    """(o, d) float32 aimed at the target, unnormalised directions."""
    if prim == "sphere":
        if back:
            o = _unit(rng, N) * rng.uniform(0.0, 0.9, (N, 1))
            d = _unit(rng, N)
        else:
            o = _unit(rng, N) * 4.0
            d = _unit(rng, N) * rng.uniform(0.5, 0.999, (N, 1)) - o
    else:
        v0, v1, v2 = (np.asarray(v) for v in TRIANGLE)
        b = rng.dirichlet((2.0, 2.0, 2.0), N)
        target = b[:, :1] * v0 + b[:, 1:2] * v1 + b[:, 2:] * v2
        # elevation from grazing to straight on, from above or below
        elev = np.deg2rad(rng.uniform(2.0, 90.0, N))
        az = rng.uniform(0.0, 2 * np.pi, N)
        side = -1.0 if back else 1.0
        to_o = np.stack([np.cos(elev) * np.cos(az), np.cos(elev) * np.sin(az),
                         side * np.sin(elev)], axis=1)
        o = target + to_o * rng.uniform(1.0, 4.0, (N, 1))
        d = target - o
    d = d * rng.uniform(0.5, 2.0, (N, 1))
    # every 11th lane misses everything
    o[::11] = (20.0, 20.0, 20.0)
    d[::11] = (1.0, 1.0, 1.0)
    return o.astype(np.float32), d.astype(np.float32)


def make_case(prim: str, material: str, rr: bool, seed: int = 0,
              nee: bool = False) -> dict:
    """The case's scene (a CPU ``Scene``) and its inputs as numpy arrays:
    o, d, idx (int64), hit_valid, atten, emitted, alive, absorbed,
    spec_prev, flags (the sorted payload's word of ray id, absorbed and
    spec_prev), u (N, 6), u_rr ((N,) or None); with ``nee``, the scene's
    emitters and prev_pdf (N,), u_nee (N, 3)."""
    rng = np.random.default_rng(
        [seed, PRIMS.index(prim), MATERIALS.index(material), int(rr)])
    b = SceneBuilder()
    other = b.add_lambertian((0.2, 0.3, 0.4))
    b.add_sphere((10.0, 10.0, 10.0), 0.5, other)
    mat = _material(b, material)
    if prim == "sphere":
        b.add_sphere((0.0, 0.0, 0.0), 1.0, mat)
    else:
        b.add_triangle(*TRIANGLE, mat)
    if nee:
        lamp = b.add_emissive((5.0, 4.0, 3.0))
        b.add_triangle(*LIGHT_TRIANGLE, lamp)
        b.add_sphere(*LIGHT_SPHERE, b.add_emissive((2.0, 3.0, 4.0)))
    scene = b.build(device="cpu")
    o, d = _rays(rng, prim, material == "dielectric_back_tir")
    idx, _, hit_valid = intersect.brute_force_closest(
        scene, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        intersect.BIG_T)
    lane = np.arange(N)
    alive = lane % 7 != 3
    absorbed = lane % 13 == 5
    rid = rng.permutation(1 << 20)[:N] * 397 % (1 << shade.ABSORBED_BIT)
    spec_prev = rng.random(N) < 0.5
    flags = (rid | (absorbed.astype(np.int64) << shade.ABSORBED_BIT)
             | (spec_prev.astype(np.int64) << (shade.ABSORBED_BIT + 1)))
    case = dict(
        scene=scene, o=o, d=d, idx=idx.numpy(), hit_valid=hit_valid.numpy(),
        atten=rng.uniform(0.2, 1.0, (N, 3)).astype(np.float32),
        emitted=rng.uniform(0.0, 0.5, (N, 3)).astype(np.float32),
        alive=alive, absorbed=absorbed, spec_prev=spec_prev,
        flags=flags.astype(np.int32),
        u=rng.random((N, 6), dtype=np.float32),
        u_rr=rng.random(N, dtype=np.float32) if rr else None)
    if nee:
        # a fifth of the lanes come from a bounce that took no light sample
        pdf = rng.uniform(0.0, 2.0, N).astype(np.float32)
        case.update(prev_pdf=np.where(rng.random(N) < 0.2, 0.0,
                                      pdf).astype(np.float32),
                    u_nee=rng.random((N, 3), dtype=np.float32))
    return case


def state(case: dict, layout: str, device, perm=None) -> dict:
    """The arguments of ``shade.shade_bounce`` on ``device`` (fresh
    tensors) in ``layout``: "caller", the state as (N, 3) tensors and a
    bool ``absorbed``; "march", three separate planes each and the flags
    word, the lanes in the order ``perm`` (a fixed shuffle by default), as
    the march's sorted wavefront holds them. Of an NEE case, those of
    ``shade.shade_nee`` (and its twin ``integrator.shade_nee_reference``):
    the tables with their emitter rows, and besides, ``spec_prev`` (a bool
    plane in caller order, None in the march's, where the flags word holds
    it), ``prev_pdf``, ``u_nee``, ``handles_dead`` (the march's) and a
    fresh ``scratch``."""
    if perm is None:
        perm = (np.arange(N) if layout == "caller"
                else np.random.default_rng(9).permutation(N))

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x[perm])).to(device)
    scene = case["scene"].to(device)
    out = dict(tables=shade.shade_tables(scene, nee="u_nee" in case),
               idx=t(case["idx"]),
               hit_valid=t(case["hit_valid"]), o=t(case["o"]),
               d=t(case["d"]), alive=t(case["alive"]), u=t(case["u"]),
               u_rr=None if case["u_rr"] is None else t(case["u_rr"]),
               t_min=T_MIN)
    if layout == "caller":
        out["atten"] = t(case["atten"]).unbind(1)
        out["emitted"] = t(case["emitted"]).unbind(1)
        out["absorbed"] = t(case["absorbed"])
    else:
        out["atten"] = tuple(t(case["atten"][:, k]) for k in range(3))
        out["emitted"] = tuple(t(case["emitted"][:, k]) for k in range(3))
        out["absorbed"] = t(case["flags"])
    if "u_nee" in case:
        out.update(spec_prev=(t(case["spec_prev"]) if layout == "caller"
                              else None),
                   prev_pdf=t(case["prev_pdf"]), u_nee=t(case["u_nee"]),
                   handles_dead=layout == "march",
                   scratch=shade.nee_scratch(N, device))
    return out


def results(args: dict) -> dict:
    """The state after a call, as numpy: o, d, atten, emitted (N, 3),
    alive, absorbed (bool, decoded from the flags word in the march
    layout) and, in that layout, the word itself; of an NEE case besides
    spec_prev (decoded likewise), prev_pdf and the scratch's fields."""
    out = {k: args[k].cpu().numpy() for k in ("o", "d", "alive")}
    for k in ("atten", "emitted"):
        out[k] = torch.stack(args[k], dim=1).cpu().numpy()
    a = args["absorbed"].cpu().numpy()
    flags = a if a.dtype == np.int32 else None
    if flags is not None:
        out["flags"] = flags
        a = ((flags >> shade.ABSORBED_BIT) & 1) != 0
    out["absorbed"] = a
    if "scratch" in args:
        out["spec_prev"] = (((flags >> (shade.ABSORBED_BIT + 1)) & 1) != 0
                            if flags is not None
                            else args["spec_prev"].cpu().numpy())
        out["prev_pdf"] = args["prev_pdf"].cpu().numpy()
        for k, x in args["scratch"]._asdict().items():
            out[k] = x.cpu().numpy()
    return out
