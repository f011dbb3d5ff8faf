"""The port's NEE light sampling and MIS weights against the JAX reference
on the same numpy inputs (rtol 1e-5, atol 1e-6: sqrt, sin, cos and pow
differ by an ulp between the two libraries).

The scene is the Cornell room (two triangle lights) plus an emissive
sphere, built by both packages' SceneBuilders with the same calls.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import rays as jrays
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.render import lights as jlights
from pathtracer_tpu.render.renderer import _with_shadow as jwith_shadow
from pathtracer_tpu.scene import cornell as jcornell
from pathtracer_tpu.scene import scene as jscene
from pathtracer_tpu_torch.core import rays as trays
from pathtracer_tpu_torch.ops import shade
from pathtracer_tpu_torch.render import integrator as tintegrator
from pathtracer_tpu_torch.render import lights as tlights
from pathtracer_tpu_torch.render.renderer import _with_shadow as twith_shadow
from pathtracer_tpu_torch.scene import cornell as tcornell
from pathtracer_tpu_torch.scene import scene as tscene

torch.set_num_threads(1)

N = 1000
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    empty = str(tmp_path_factory.mktemp("no_obj"))
    built = []
    for mod, cornell in ((jscene, jcornell), (tscene, tcornell)):
        b = mod.SceneBuilder()
        cornell.add_cornell_room(b, empty)
        glow = b.add_emissive((4.0, 3.0, 2.0))
        b.add_sphere((300.0, 100.0, 300.0), 60.0, glow)
        metal = b.add_metal((0.8, 0.85, 0.88), 0.3)
        b.add_sphere((150.0, 80.0, 200.0), 80.0, metal)
        built.append(b.build() if mod is jscene else b.build(device="cpu"))
    js, ts = built
    assert js.num_lights == ts.num_lights == 3
    return js, ts


def _unit(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _both(x):
    return jnp.asarray(x), torch.from_numpy(np.ascontiguousarray(x))


def test_sample_lights_matches(scenes):
    js, ts = scenes
    u = np.random.default_rng(0).random((N, 3), dtype=np.float32)
    ju, tu = _both(u)
    for a, b in zip(jlights.sample_lights(js, ju),
                    tlights.sample_lights(ts, tu)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_metal_lobe_pdf_matches():
    rng = np.random.default_rng(1)
    w, r = _unit(rng, N), _unit(rng, N)
    # half of the directions near the mirror direction, inside the lobe
    w[::2] = r[::2] + 0.3 * w[::2]
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    fuzz = rng.random(N, dtype=np.float32)
    fuzz[::5] = 0.0
    a = jlights.metal_lobe_pdf(*(jnp.asarray(x) for x in (w, r, fuzz)))
    b = tlights.metal_lobe_pdf(*(torch.from_numpy(x) for x in (w, r, fuzz)))
    assert (np.asarray(a) > 0).sum() > N // 4
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_bsdf_hit_light_weight_matches(scenes):
    js, ts = scenes
    rng = np.random.default_rng(2)
    d = _unit(rng, N) * rng.uniform(0.5, 3.0, (N, 1)).astype(np.float32)
    normal = _unit(rng, N)
    t = rng.uniform(1.0, 500.0, N).astype(np.float32)
    area = rng.uniform(0.0, 2e4, N).astype(np.float32)
    prev_pdf = rng.uniform(0.0, 2.0, N).astype(np.float32)
    zeros3 = np.zeros((N, 3), np.float32)

    def rec(mod, conv, i64):
        return mod.HitRecords(
            p=conv(zeros3), normal=conv(normal), mat_id=conv(i64), t=conv(t),
            uv=conv(np.zeros((N, 2), np.float32)),
            front_face=conv(np.ones(N, bool)), valid=conv(np.ones(N, bool)),
            prim_id=conv(i64), prim_area=conv(area))
    i64 = np.zeros(N, np.int64)
    a = jlights.bsdf_hit_light_weight(js, rec(jrays, jnp.asarray,
                                              i64.astype(np.int32)),
                                      jnp.asarray(d), jnp.asarray(prev_pdf))
    b = tlights.bsdf_hit_light_weight(ts, rec(trays, torch.from_numpy, i64),
                                      torch.from_numpy(d),
                                      torch.from_numpy(prev_pdf))
    np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("masked", [False, True])
def test_direct_lighting_matches(scenes, masked):
    """Through the brute closest hit with its K_SHADOW_T_MIN shadow query,
    at points inside the room, lambertian and fuzzy-metal lobes. The
    port's ``direct_lighting`` is the estimate should nothing occlude the
    sample; its integrator queries the shadow ray and adds what the query
    lets through (``ops/shade.nee_finish``), composed here as there."""
    js, ts = scenes
    rng = np.random.default_rng(3)
    p = rng.uniform((10, 10, 10), (540, 540, 550), (N, 3)).astype(np.float32)
    normal = _unit(rng, N)
    albedo = rng.random((N, 3), dtype=np.float32)
    u = rng.random((N, 3), dtype=np.float32)
    is_glossy = rng.random(N) < 0.3
    r_unit = _unit(rng, N)
    fuzz = rng.uniform(0.05, 1.0, N).astype(np.float32)
    active = rng.random(N) < 0.8 if masked else None

    jclosest = jwith_shadow(jintegrator.make_brute_closest_hit, js, 1e-3)
    tclosest = twith_shadow(tintegrator.make_brute_closest_hit, ts, 1e-3)
    ja, ta = zip(*(_both(x) for x in (p, normal, albedo, u, is_glossy,
                                      r_unit, fuzz)))
    jrad, jok = jlights.direct_lighting(
        js, ja[0], ja[1], ja[2], jclosest, ja[3], eps=1e-3,
        active=None if active is None else jnp.asarray(active),
        glossy=ja[4:])
    light = tlights.sample_lights(ts, ta[3])
    origin, seg = tlights.shadow_segment(ta[0], ta[1], light.point, 1e-3)
    rad, tok = tlights.direct_lighting(seg, ta[1], ta[2], light, ta[4:])
    mask = None if active is None else torch.from_numpy(active)
    _, t_sh, valid = tclosest.query_shadow(
        origin, seg if mask is None else torch.where(mask[:, None], seg, 0.0),
        mask)
    tok = tok & (~valid | (t_sh >= 1.0 - 1e-3))
    trad = shade.nee_finish(t_sh, valid, rad, torch.zeros_like(rad), 1e-3)
    ok = np.asarray(jok)
    # some samples are lit, some occluded or facing away
    assert 0.1 * N < ok.sum() < 0.9 * N
    np.testing.assert_array_equal(tok.numpy(), ok)
    np.testing.assert_allclose(trad.numpy(), np.asarray(jrad), rtol=1e-5,
                               atol=1e-6)
