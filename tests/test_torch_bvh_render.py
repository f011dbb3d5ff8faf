"""Renders and gradients on the "bvh" route (the LBVH and stackless
traversal) against the JAX reference's "bvh" route, and against the port's
brute force.

Tolerances: images as ``tests/test_torch_render.py`` (>= 99% of channels
within 1e-4, mean |diff| <= 1e-3: the random streams are bit-equal, and a
near-tie winner can flip between the libraries' ulps); the port's "bvh"
image against its "brute" image exactly (same winners, same shading);
gradients rtol 1e-4, atol 1e-6 against ``jax.grad``, as
``tests/test_torch_diff.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.lbvh import build_lbvh as jbuild
from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.core.camera import make_camera as jmake_camera
from pathtracer_tpu.render import diff as jdiff
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.render.renderer import render_image as jrender
from pathtracer_tpu.scene.scene import SceneBuilder as JBuilder
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core.camera import Camera
from pathtracer_tpu_torch.render import diff as tdiff
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.render.renderer import render_image as trender
from test_torch_diff import GRAD_TOL, _jax_sphere_scene
from test_torch_render import _assert_images_close, _both

torch.set_num_threads(1)


def _lit_scene():
    """A ground sphere under a small emissive sphere (NEE's shadow
    query), as ``tests/test_parallel.py``'s NEE case."""
    b = JBuilder()
    g = b.add_lambertian((0.7, 0.6, 0.5))
    b.add_sphere((0, -100.5, -3), 100.0, g)
    e = b.add_emissive((24.0, 20.0, 16.0))
    b.add_sphere((0, 3.0, -3), 0.6, e)
    m = b.add_metal((0.8, 0.8, 0.9), 0.2)
    b.add_triangle((-1, -0.5, -3), (1, -0.5, -3.5), (0, 1, -3.2), m)
    cam = jmake_camera((0, 1.2, 2.0), (0, 0, -3), 55, 2.0, aperture=0,
                       focus_dist=5)
    return b.build(), cam


def _port(js, jc):
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    return ts, Camera(*(torch.from_numpy(np.array(x)) for x in jc))


CASES = {
    "test world": dict(width=32, height=16, spp=2, max_depth=3,
                       ray_chunk=256, scene="test", seed=3),
    "lit, NEE": dict(width=32, height=16, spp=2, max_depth=3, ray_chunk=256,
                     scene="test", seed=9, sky=False, nee=True),
}


def _scenes(case):
    if case == "test world":
        js, jc, ts, tc = _both("test")
        return js, jc, ts, tc
    js, jc = _lit_scene()
    return (js, jc) + _port(js, jc)


@pytest.mark.parametrize("case", list(CASES))
def test_bvh_render_matches_jax_and_brute(case):
    js, jc, ts, tc = _scenes(case)
    kw = dict(CASES[case], accel="bvh")
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    got = trender(ts, tc, TConfig(**kw), device="cpu").numpy()
    assert got.mean() > 0.05
    _assert_images_close(got, ref)
    brute = trender(ts, tc, TConfig(**dict(kw, accel="brute")),
                    device="cpu").numpy()
    np.testing.assert_array_equal(got, brute)


def test_bvh_route_builds_once_and_carries_shadow_query():
    js, jc = _lit_scene()
    ts, _ = _port(js, jc)
    render = trenderer.make_renderer(TConfig(accel="bvh", nee=True),
                                     "cpu")
    query = render.prepare(ts)
    assert render.prepare(ts) is query
    assert hasattr(query.closest, "query_shadow")
    assert query.scene is not None and query.scene.num_prims == 3


@pytest.mark.parametrize("emissive", [False, True])
def test_bvh_gradients_match_jax(emissive):
    """jax.grad of mean(img^2) through the reference's "bvh" route against
    autograd through the port's (visibility detached on both); v0 only
    without NEE's light (the scene has no NEE here: sky lit)."""
    kw = dict(width=8, height=8, spp=2, max_depth=3, accel="bvh",
              ray_chunk=64, scene="test", sky=True)
    fields = ("albedo", "emit", "v0")
    js, jc = _jax_sphere_scene(emissive)
    jcfg = JConfig(**kw)
    rows, cols = jrenderer.padded_pixel_grid(jcfg, 64)
    key = jax.random.PRNGKey(0)
    bvh = jbuild(js)

    def loss(p):
        img = jdiff.render_linear(jdiff.apply_params(js, p), bvh, jc, key,
                                  rows, cols, jcfg, jcfg.spp)
        return jnp.mean(img ** 2)
    want = jax.grad(loss)(jdiff.scene_params(js, fields))

    ts, tc = _port(js, jc)
    cfg = TConfig(**kw)
    params = tdiff.scene_params(ts, fields)
    t_rows, t_cols = trenderer.padded_pixel_grid(cfg, 64, "cpu")
    img = tdiff.render_linear(tdiff.apply_params(ts, params), tc,
                              prng.PRNGKey(0), t_rows, t_cols, cfg, cfg.spp)
    torch.mean(img ** 2).backward()
    for f in fields:
        np.testing.assert_allclose(params[f].grad.numpy(),
                                   np.asarray(want[f]), err_msg=f,
                                   **GRAD_TOL)
    assert np.abs(params["albedo"].grad.numpy()).max() > 0
