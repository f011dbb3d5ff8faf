"""The bounce's shading step (``ops/shade``) on the CPU:

- its twin, ``shade_bounce`` on CPU tensors, against the JAX package's
  bounce step on the same numpy inputs (``shade_cases``): the winner, the
  hit record, the scatter and the next state, for each primitive kind,
  material case and with and without Russian roulette (rtol 1e-5: sin, cos
  and pow differ by an ulp between the two libraries; flags exactly);
- the sorted payload's flags word: decoded, shaded and encoded, it gives
  the bool layout's state with the ray id and spec_prev bits kept;
- ``integrator.trace`` through the twins gives the bits of the torch
  composition that autograd runs (``_fused_shading`` False): on the
  triangle world, the bunny and the textured Cornell box without NEE
  (``shade_bounce``), and under NEE (``integrator.shade_nee_reference``
  and ``shade_nee_finish`` around the shadow query) on the Cornell box's
  spheres and full variants, a fuzzy-metal room lit by a sphere emitter,
  with and without Russian roulette, in caller order and on the march's
  sorted payload (``handles_dead``).
"""
import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import shade_cases
from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import materials as jmaterials
from pathtracer_tpu.scene.scene import Scene as JScene
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.core.camera import make_camera
from pathtracer_tpu_torch.ops import shade
from pathtracer_tpu_torch.presets import get_preset
from pathtracer_tpu_torch.render import integrator
from pathtracer_tpu_torch.render.renderer import make_renderer
from pathtracer_tpu_torch.scene.cornell import add_cornell_room, cornell_box
from pathtracer_tpu_torch.scene.scene import SceneBuilder
from pathtracer_tpu_torch.scene.worlds import get_world

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _jax_bounce(case):
    """The JAX package's bounce step without NEE (render/integrator.py's
    bounce_step, which is a closure there) on the case's inputs: (winner,
    valid), rec, sc and the next (o, d, atten, emitted, alive, absorbed)."""
    js = JScene(**{f: jnp.asarray(getattr(case["scene"], f).numpy())
                   for f in JScene._fields})
    o, d = jnp.asarray(case["o"]), jnp.asarray(case["d"])
    idx, _, hv = jintersect.brute_force_closest(
        js, o, d, shade_cases.T_MIN, jintersect.BIG_T)
    rec = jintersect.hit_records_from_prims(
        js, idx, o, d, jnp.float32(shade_cases.T_MIN), jintersect.BIG_T, hv)
    sc = jmaterials.scatter(js, rec, d, jnp.asarray(case["u"]))
    atten = jnp.asarray(case["atten"])
    alive, absorbed = jnp.asarray(case["alive"]), jnp.asarray(case["absorbed"])
    active = alive & hv
    hit_emitter = active & sc.is_emissive
    emitted = jnp.asarray(case["emitted"]) + jnp.where(
        hit_emitter[:, None], atten * sc.emitted, 0.0)
    absorbed = absorbed | (active & ~sc.is_emissive & ~sc.ok) | hit_emitter
    step = active & sc.ok & ~sc.is_emissive
    scale = jnp.ones(shade_cases.N, jnp.float32)
    if case["u_rr"] is not None:
        killed = step & (jnp.asarray(case["u_rr"])
                         >= jintegrator.K_RR_CONTINUE)
        scale = jnp.where(step & ~killed, jintegrator.K_RR_INV_CONTINUE, 1.0)
        step = step & ~killed
        absorbed = absorbed | killed
    nxt = dict(o=jnp.where(step[:, None], rec.p, o),
               d=jnp.where(step[:, None], sc.direction, d),
               atten=jnp.where(step[:, None],
                               atten * sc.attenuation * scale[:, None], atten),
               emitted=emitted, alive=alive & hv & step, absorbed=absorbed)
    return (idx, hv), rec, sc, {k: np.asarray(v) for k, v in nxt.items()}


@pytest.mark.parametrize("rr", [False, True], ids=["no_rr", "rr"])
@pytest.mark.parametrize("material", shade_cases.MATERIALS)
@pytest.mark.parametrize("prim", shade_cases.PRIMS)
def test_twin_matches_the_jax_bounce_step(prim, material, rr):
    case = shade_cases.make_case(prim, material, rr)
    (j_idx, j_valid), j_rec, j_sc, j_next = _jax_bounce(case)
    # the winner
    np.testing.assert_array_equal(case["hit_valid"], np.asarray(j_valid))
    hit = case["hit_valid"]
    assert hit.mean() > 0.8
    np.testing.assert_array_equal(case["idx"][hit], np.asarray(j_idx)[hit])
    assert (case["idx"][hit] == 1).all()
    args = shade_cases.state(case, "caller", "cpu")
    # the hit record and the scatter, where a lane hit
    rec, sc = shade.surface(args["tables"], args["idx"], args["o"],
                            args["d"], args["hit_valid"], args["u"],
                            shade_cases.T_MIN)
    for f in ("front_face", "mat_id"):
        np.testing.assert_array_equal(getattr(rec, f).numpy()[hit],
                                      np.asarray(getattr(j_rec, f))[hit],
                                      err_msg=f)
    for f in ("p", "normal", "uv", "t"):
        np.testing.assert_allclose(getattr(rec, f).numpy()[hit],
                                   np.asarray(getattr(j_rec, f))[hit],
                                   err_msg=f, **TOL)
    for f in ("ok", "is_emissive", "is_diffuse", "is_specular"):
        np.testing.assert_array_equal(getattr(sc, f).numpy()[hit],
                                      np.asarray(getattr(j_sc, f))[hit],
                                      err_msg=f)
    for f in ("direction", "attenuation", "emitted"):
        np.testing.assert_allclose(getattr(sc, f).numpy()[hit],
                                   np.asarray(getattr(j_sc, f))[hit],
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    # what each case is there for
    ok = sc.ok.numpy()[hit]
    front = rec.front_face.numpy()[hit]
    if material == "metal_fuzz_below":
        assert 0 < (~ok).sum() < ok.size
    if material == "dielectric_back_tir":
        assert not front.any()
        n, d = rec.normal.numpy()[hit], case["d"][hit]
        cos = -(d * n).sum(1) / np.linalg.norm(d, axis=1)
        assert (1.5 * np.sqrt(np.clip(1 - cos * cos, 0, None)) > 1).any()
    if material == "dielectric_front":
        assert front.all()
    # the next state
    shade.shade_bounce(**args)
    got = shade_cases.results(args)
    for f in ("alive", "absorbed"):
        np.testing.assert_array_equal(got[f], j_next[f], err_msg=f)
    for f in ("o", "d", "atten", "emitted"):
        np.testing.assert_allclose(got[f], j_next[f], err_msg=f,
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("material", ["metal_fuzz_below", "emissive"])
def test_flags_word_layout_matches_the_bool_layout(material):
    """The march's layout (separate planes, the int32 word, lanes
    shuffled) gives the caller layout's state lane for lane, bit for bit;
    the word keeps its ray id and spec_prev bits and takes absorbed."""
    case = shade_cases.make_case("sphere", material, rr=True)
    caller = shade_cases.state(case, "caller", "cpu")
    march = shade_cases.state(case, "march", "cpu")
    perm = np.random.default_rng(9).permutation(shade_cases.N)
    shade.shade_bounce(**caller)
    shade.shade_bounce(**march)
    a, b = shade_cases.results(caller), shade_cases.results(march)
    for f in ("o", "d", "atten", "emitted", "alive", "absorbed"):
        np.testing.assert_array_equal(b[f], a[f][perm], err_msg=f)
    keep = ~(1 << shade.ABSORBED_BIT)
    np.testing.assert_array_equal(b["flags"] & keep,
                                  case["flags"][perm] & keep)
    assert b["absorbed"].sum() > case["absorbed"].sum()


@pytest.mark.parametrize("material", shade_cases.MATERIALS)
@pytest.mark.parametrize("prim", shade_cases.PRIMS)
def test_nee_twin_layouts_agree_and_sample_lights(prim, material):
    """The NEE twin in the march's layout (separate planes, spec_prev in
    the flags word, lanes shuffled, the shadow query taking only the
    light-sampling lanes) gives the caller layout's results lane for lane,
    bar the segments it zeroes; the diffuse and fuzzy-metal hits sample a
    light, some of their samples reach it, and no other lane samples."""
    case = shade_cases.make_case(prim, material, rr=True, nee=True)
    caller = shade_cases.state(case, "caller", "cpu")
    march = shade_cases.state(case, "march", "cpu")
    perm = np.random.default_rng(9).permutation(shade_cases.N)
    integrator.shade_nee_reference(**caller)
    integrator.shade_nee_reference(**march)
    a, b = shade_cases.results(caller), shade_cases.results(march)
    for f in a:
        if f != "seg":
            np.testing.assert_array_equal(b[f], a[f][perm], err_msg=f)
    np.testing.assert_array_equal(
        b["seg"], np.where(a["take"][:, None], a["seg"], 0.0)[perm])
    keep = ~(3 << shade.ABSORBED_BIT)
    np.testing.assert_array_equal(b["flags"] & keep,
                                  case["flags"][perm] & keep)
    takes = material in ("lambertian", "textured", "metal_fuzz_below")
    assert a["take"].any() == takes
    if takes:
        assert 0 < (a["cand"][a["take"]] > 0).any(1).sum() < a["take"].sum()
    if material == "emissive":
        # the balance heuristic weighs the emitter hits off a glossy or
        # diffuse bounce, and keeps the full weight after a delta lobe
        hit = case["alive"] & case["hit_valid"]
        full = case["emitted"] + case["atten"] * np.float32((4.0, 3.0, 2.0))
        spec = case["spec_prev"]
        np.testing.assert_array_equal(a["emitted"][hit & spec],
                                      full[hit & spec])
        assert (a["emitted"][hit & ~spec] < full[hit & ~spec]).all()


def test_shade_nee_launches_only_on_the_card():
    """The first NEE kernel's wrapper has no CPU branch: on a CPU
    wavefront it raises and writes nothing (the integrator runs the twin
    there)."""
    case = shade_cases.make_case("sphere", "lambertian", rr=False, nee=True)
    args = shade_cases.state(case, "caller", "cpu")
    o = args["o"].clone()
    with pytest.raises(ValueError, match="shade_nee_reference"):
        shade.shade_nee(**args)
    assert torch.equal(args["o"], o)


def _fused_off(differentiable):
    return False


def _glossy_room(device):
    """The Cornell room (its ceiling light a pair of emitting triangles)
    with a fuzzy metal, a glass, a textured and an emitting sphere: every
    lobe the NEE bounce weighs, and both kinds of light sample."""
    b = SceneBuilder()
    add_cornell_room(b)
    b.add_sphere((180.0, 100.0, 200.0), 100.0, b.add_metal((0.9, 0.8, 0.7),
                                                           0.35))
    b.add_sphere((400.0, 90.0, 320.0), 90.0, b.add_dielectric(1.5))
    tex = np.random.default_rng(4).random((4, 8, 3), dtype=np.float32)
    b.add_sphere((420.0, 300.0, 420.0), 60.0,
                 b.add_lambertian((0.9, 0.9, 0.9), tex_id=b.add_texture(tex)))
    b.add_sphere((140.0, 420.0, 380.0), 40.0, b.add_emissive((6.0, 5.0, 4.0)))
    cam = make_camera((278, 273, -800), (278, 273, 0), 40, 16.0 / 9.0,
                      aperture=0, focus_dist=10, time0=0.0, time1=1.0,
                      device=device)
    return b.build(device=device), cam


NEE = dict(width=32, height=18, spp=2, max_depth=4, ray_chunk=288,
           sky=False, nee=True, scene="cornell")
WORLDS = {
    "cornell_full": lambda: get_preset("cornell-full", device="cpu")[:2],
    "cornell_spheres": lambda: cornell_box(variant="spheres", aspect=16 / 9,
                                           device="cpu"),
    "glossy_room": lambda: _glossy_room("cpu"),
}

RENDERS = {
    "triangle": dict(width=32, height=18, spp=2, max_depth=6, ray_chunk=288,
                     accel="auto", scene="triangle"),
    "bunny": dict(width=32, height=18, spp=2, max_depth=4, ray_chunk=288,
                  accel="auto", scene="bunny"),
    "bunny_rr": dict(width=32, height=18, spp=2, max_depth=6, ray_chunk=288,
                     accel="auto", scene="bunny", rr=True, rr_depth=1),
    # textures and emitters, no NEE: shade_bounce shades them
    "cornell_full": dict(width=32, height=18, spp=2, max_depth=4,
                         ray_chunk=288, accel="tensor", sky=False,
                         scene="cornell"),
    # under NEE, in caller order (the tensor route queries every lane)
    "nee_cornell_spheres": dict(NEE, accel="tensor"),
    "nee_cornell_full": dict(NEE, accel="tensor"),
    "nee_cornell_full_rr": dict(NEE, accel="tensor", rr=True, rr_depth=1),
    "nee_glossy_room": dict(NEE, accel="tensor"),
    "nee_glossy_room_rr": dict(NEE, accel="tensor", rr=True, rr_depth=1),
    # on the march's sorted payload, whose shadow query takes the lanes
    # that sample a light (handles_dead)
    "nee_march_glossy_room_rr": dict(NEE, accel="cluster", ray_chunk=256,
                                     rr=True, rr_depth=1),
}


def _render(name):
    kw = RENDERS[name]
    world = name.replace("nee_", "").replace("march_", "").replace("_rr",
                                                                   "")
    if world in WORLDS:
        scene, cam = WORLDS[world]()
    else:
        scene, cam = get_world(kw["scene"], device="cpu")
    renderer = make_renderer(RenderConfig(**kw), "cpu", with_stats=True)
    img, stats = renderer.render_passes(scene, cam, 1, seed=5)
    return stats, hashlib.sha256(img.numpy().tobytes()).hexdigest()


@pytest.mark.parametrize("name", sorted(RENDERS))
def test_trace_through_the_twin_gives_the_composition_bits(name,
                                                          monkeypatch):
    fused = _render(name)
    monkeypatch.setattr(integrator, "_fused_shading", _fused_off)
    composed = _render(name)
    assert fused == composed
    assert fused[0][0] > 0
    # every NEE render casts shadow rays
    assert (fused[0][1] > 0) == RENDERS[name].get("nee", False)
