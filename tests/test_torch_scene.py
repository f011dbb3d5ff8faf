"""Port scene, camera and config against the JAX reference.

The port's SceneBuilder worlds must produce the reference's scene fields
(textures included) bit for bit (same numpy host build), the camera must
match, and config validation / accel resolution must agree. Entry points
default to the GPU, so every port call here passes ``device="cpu"``.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import config as jconfig
from pathtracer_tpu import presets as jpresets
from pathtracer_tpu.scene import bunny as jbunny
from pathtracer_tpu.scene import cornell as jcornell
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch import config as tconfig
from pathtracer_tpu_torch import presets as tpresets
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import camera as tcamera
from pathtracer_tpu_torch.scene import bunny as tbunny
from pathtracer_tpu_torch.scene import cornell as tcornell
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)


def _worlds(name, empty_dir, monkeypatch):
    """(JAX (scene, cam), port (scene, cam)) of a named world; both take
    the vendored bunny and the built-in Cornell data, whatever else is
    installed."""
    monkeypatch.setenv("PT_BUNNY_OBJ", tbunny.ASSET_OBJ)
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    if name == "bunny":
        return (jbunny.bunny_world(obj_path=tbunny.ASSET_OBJ),
                tbunny.bunny_world(obj_path=tbunny.ASSET_OBJ, device="cpu"))
    if name.startswith("cornell"):
        variant = name.split("-")[1]
        return (jcornell.cornell_box(obj_dir=empty_dir, variant=variant),
                tcornell.cornell_box(variant=variant, device="cpu"))
    if name == "combined":
        monkeypatch.setattr(jcornell, "CORNELL_DIR", empty_dir)
        return (jpresets.combined_scene(),
                tpresets.combined_scene(device="cpu"))
    return jworlds.get_world(name), tworlds.get_world(name, device="cpu")


@pytest.mark.parametrize("name", ["bunny", "test", "triangle", "random",
                                  "cornell-spheres", "cornell-full",
                                  "combined"])
def test_scene_fields_equal(name, tmp_path, monkeypatch):
    (js, jc), (ts, tc) = _worlds(name, str(tmp_path), monkeypatch)
    assert ts.num_prims == js.num_prims
    for field in js._fields:
        a = np.asarray(getattr(js, field))
        b = getattr(ts, field).numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)
    for field in jc._fields:
        np.testing.assert_allclose(getattr(tc, field).numpy(),
                                   np.asarray(getattr(jc, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


def test_bunny_prim_count():
    ts, _ = tbunny.bunny_world(obj_path=tbunny.ASSET_OBJ, device="cpu")
    # 3,616 mesh triangles + ground, mirror and glass spheres
    assert ts.num_prims == 3619


def test_scene_sizes_and_textures():
    """The slice's small scenes stay under the auto crossover (dense
    routes); cornell-full stacks an 8x16 checker and the 128x128 marble
    PNG into one atlas, the checker resampled nearest-neighbour."""
    sizes = {"triangle": 601, "random": 405, "test": 3}
    for name, n in sizes.items():
        ts, _ = tworlds.get_world(name, device="cpu")
        assert ts.num_prims == n
        assert tconfig.resolve_accel("auto", n) == "tensor"
    ts, _ = tcornell.cornell_box(variant="full", device="cpu")
    assert ts.num_lights == 2 and ts.textures.shape == (2, 128, 128, 3)
    checker = ts.textures[0].numpy()
    np.testing.assert_array_equal(checker[0, 0], np.float32([0.9, 0.9,
                                                             0.85]))
    np.testing.assert_array_equal(checker[0, 8], np.float32([0.15, 0.25,
                                                             0.5]))
    assert sorted(ts.tex_id.tolist()).count(-1) == ts.num_materials - 2


def test_converter_round_trip():
    js, _ = jworlds.get_world("test")
    fields = {f: np.asarray(getattr(js, f)) for f in js._fields}
    ts = scene_from_jax_arrays(fields, device="cpu")
    for f, a in fields.items():
        back = getattr(ts, f).numpy()
        np.testing.assert_array_equal(back, a, err_msg=f)
        assert back.dtype == a.dtype, f
    with pytest.raises(KeyError):
        scene_from_jax_arrays({"v0": fields["v0"]}, device="cpu")


def test_get_rays_matches():
    from pathtracer_tpu.core.camera import get_rays as jget_rays
    _, jc = jworlds.get_world("test")
    _, cam = tworlds.get_world("test", device="cpu")
    rng = np.random.default_rng(3)
    u = rng.random((5, 257), dtype=np.float32)
    jo, jd, jt = jget_rays(jc, *(jnp.asarray(x) for x in u))
    to, td, tt = tcamera.get_rays(cam, *(torch.from_numpy(x) for x in u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


@pytest.mark.parametrize("accel", ["auto", "cluster", "tensor", "brute"])
@pytest.mark.parametrize("n", [3, 1023, 1024, 3619])
def test_resolve_accel_matches(accel, n):
    assert tconfig.resolve_accel(accel, n) == jconfig.resolve_accel(accel, n)


@pytest.mark.parametrize("device", ["cpu", "cuda", "cuda:1"])
@pytest.mark.parametrize("accel", ["auto", "cluster", "tensor", "pallas",
                                   "bvh", "brute"])
@pytest.mark.parametrize("n", [3, 36, 601, 1023, 1024, 3619])
def test_route_accel_on_each_device(device, accel, n):
    """The port's step: "auto" on a CUDA device takes the sweep kernel below
    the crossover and the march at or above it; on the CPU it is the
    reference's rule; an explicit accel passes through on every device."""
    got = tconfig.route_accel(accel, n, torch.device(device))
    assert got == tconfig.route_accel(accel, n, device)
    if accel != "auto":
        assert got == accel
    elif device == "cpu":
        assert got == jconfig.resolve_accel(accel, n)
    else:
        assert got == ("pallas" if n < tconfig.K_AUTO_ACCEL_PRIMS
                       else "cluster")


def test_render_config_matches():
    t, j = tconfig.RenderConfig(), jconfig.RenderConfig()
    assert t.to_json() == j.to_json()
    cfg = tconfig.RenderConfig(width=64, height=36, accel="cluster")
    assert tconfig.RenderConfig.from_json(cfg.to_json()) == cfg
    assert cfg.replace(spp=3).spp == 3 and cfg.num_pixels == 64 * 36
    for bad in (dict(width=0), dict(height=-1), dict(accel="octree")):
        with pytest.raises(ValueError):
            jconfig.RenderConfig(**bad)
        with pytest.raises(ValueError):
            tconfig.RenderConfig(**bad)


def test_off_slice_raises():
    """Nothing of the reference is off the port's slice any more: the
    "bvh" route (the last to raise) renders, equal to brute force."""
    from pathtracer_tpu_torch.render.renderer import render_image
    ts, tc = tworlds.get_world("test", device="cpu")
    small = dict(width=8, height=4, spp=1, max_depth=1, ray_chunk=32)
    images = [render_image(ts, tc, tconfig.RenderConfig(accel=a, **small),
                           device="cpu") for a in ("bvh", "brute")]
    assert torch.equal(*images) and images[0].mean() > 0.05


@pytest.mark.parametrize("accel", ["cluster", "pallas", "brute"])
def test_differentiable_render_sum_equals_forward(accel):
    """``render_sum(differentiable=True)`` (caller-order detached queries)
    gives the forward render's sums, on the test world where the march
    runs its sorted protocol forward; with a parameter that requires grad
    the sums carry its history."""
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render.renderer import (padded_pixel_grid,
                                                      render_sum)
    ts, tc = tworlds.get_world("test", device="cpu")
    cfg = tconfig.RenderConfig(width=16, height=8, spp=2, max_depth=3,
                               ray_chunk=128, accel=accel)
    rows, cols = padded_pixel_grid(cfg, 128, "cpu")
    fwd, stats = render_sum(ts, tc, prng.PRNGKey(4), rows, cols, cfg, 2)
    albedo = ts.albedo.clone().requires_grad_()
    got, stats_d = render_sum(ts._replace(albedo=albedo), tc,
                              prng.PRNGKey(4), rows, cols, cfg, 2,
                              differentiable=True)
    assert got.requires_grad and not fwd.requires_grad
    np.testing.assert_array_equal(got.detach().numpy(), fwd.numpy())
    assert stats_d[:2] == stats[:2]


def test_cornell_diff_preset_matches_jax(tmp_path, monkeypatch):
    """cornell-diff: the reference's scene and config exactly; its
    differentiable render at 16x16, 4 spp against the reference's,
    statistically (the reference's compiled loops round a few Cornell
    self-intersections differently from its op-by-op run): 97% of
    channels within 1e-4, the image mean and the emission gradient to
    1e-3, the albedo gradient to 5% of its largest entry. The reference's
    v0 gradient under NEE is NaN (``metal_lobe_pdf``'s unguarded sqrt at
    disc <= 0); the port's is finite."""
    import jax
    import jax.numpy as jnp
    from pathtracer_tpu.render import diff as jdiff
    from pathtracer_tpu.render import renderer as jrenderer
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render import diff as tdiff
    from pathtracer_tpu_torch.render import renderer as trenderer
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    monkeypatch.setattr(jcornell, "CORNELL_DIR", str(tmp_path))
    js, jc, jcfg = jpresets.get_preset("cornell-diff")
    ts, tc, tcfg = tpresets.get_preset("cornell-diff", device="cpu")
    assert "cornell-diff" in tpresets.PRESETS
    assert tcfg.to_json() == jcfg.to_json()
    assert (tcfg.width, tcfg.spp, tcfg.max_depth, tcfg.accel) == (64, 8, 2,
                                                                  "brute")
    for field in js._fields:
        np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                      np.asarray(getattr(js, field)),
                                      err_msg=field)
    small = dict(width=16, height=16, spp=4, ray_chunk=256)
    jcfg, tcfg = jcfg.replace(**small), tcfg.replace(**small)
    fields = ("albedo", "emit", "v0")
    rows, cols = jrenderer.padded_pixel_grid(jcfg, 256)

    def jloss(p):
        img = jdiff.render_linear(jdiff.apply_params(js, p), None, jc,
                                  jax.random.PRNGKey(0), rows, cols, jcfg,
                                  jcfg.spp)
        return jnp.mean(img ** 2), img
    (_, jimg), jg = jax.value_and_grad(jloss, has_aux=True)(
        jdiff.scene_params(js, fields))
    params = tdiff.scene_params(ts, fields)
    trows, tcols = trenderer.padded_pixel_grid(tcfg, 256, "cpu")
    img = tdiff.render_linear(tdiff.apply_params(ts, params), tc,
                              prng.PRNGKey(0), trows, tcols, tcfg, tcfg.spp)
    torch.mean(img ** 2).backward()
    img, jimg = img.detach().numpy(), np.asarray(jimg)
    assert (np.abs(img - jimg) <= 1e-4).mean() >= 0.97
    np.testing.assert_allclose(img.mean(), jimg.mean(), rtol=1e-3)
    np.testing.assert_allclose(params["emit"].grad.numpy(),
                               np.asarray(jg["emit"]), rtol=1e-3, atol=1e-7)
    ja = np.asarray(jg["albedo"])
    np.testing.assert_allclose(params["albedo"].grad.numpy(), ja, rtol=0,
                               atol=0.05 * np.abs(ja).max())
    assert np.isnan(np.asarray(jg["v0"])).any()
    assert np.isfinite(params["v0"].grad.numpy()).all()


def test_bunny_standin_matches_jax():
    from pathtracer_tpu.scene import standalone_assets as jassets
    from pathtracer_tpu_torch.scene import standalone_assets as tassets
    (jv, jf), (tv, tf) = jassets.bunny_standin(), tassets.bunny_standin()
    assert tv.dtype == jv.dtype and tf.dtype == jf.dtype
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert tf.shape[0] > 2000


def _assert_scenes_equal(js, ts):
    assert ts.num_prims == js.num_prims
    for field in js._fields:
        a = np.asarray(getattr(js, field))
        b = getattr(ts, field).numpy()
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(b, a, err_msg=field)


def test_scenes_build_without_a_bunny_obj(tmp_path, monkeypatch):
    """No bunny OBJ anywhere (PT_BUNNY_OBJ and the vendored asset point
    nowhere): bunny_world and combined_scene fall back to the stand-in
    mesh, as the reference's do, and equal the reference's scenes."""
    nowhere = str(tmp_path / "no_bunny.obj")
    monkeypatch.setenv("PT_BUNNY_OBJ", nowhere)
    monkeypatch.setattr(tbunny, "ASSET_OBJ", nowhere)
    monkeypatch.setattr(jbunny, "ASSET_OBJ", nowhere)
    monkeypatch.setattr(jbunny, "REFERENCE_OBJ", nowhere)
    monkeypatch.setattr(jcornell, "CORNELL_DIR", str(tmp_path))
    monkeypatch.delenv("PT_CORNELL_DIR", raising=False)
    ts, _ = tbunny.bunny_world(device="cpu")
    js, _ = jbunny.bunny_world()
    _assert_scenes_equal(js, ts)
    assert ts.num_prims > 2000
    _assert_scenes_equal(jpresets.combined_scene()[0],
                         tpresets.combined_scene(device="cpu")[0])


def test_reference_random_world_matches_jax():
    from pathtracer_tpu.scene import reference_world as jref
    from pathtracer_tpu_torch.scene import reference_world as tref
    assert [tref.MT19937().next_u32() for _ in range(3)] == \
        [jref.MT19937().next_u32() for _ in range(3)]
    (js, jc), (ts, tc) = (jref.reference_random_world(),
                          tref.reference_random_world(device="cpu"))
    _assert_scenes_equal(js, ts)
    for field in jc._fields:
        np.testing.assert_allclose(getattr(tc, field).numpy(),
                                   np.asarray(getattr(jc, field)),
                                   rtol=1e-6, atol=1e-6, err_msg=field)


def test_entry_points_default_to_cuda():
    """Every public factory and entry point renders or builds on the GPU
    unless the caller passes device="cpu"; without a GPU they raise rather
    than fall back."""
    from pathtracer_tpu_torch.convert import params_from_jax
    from pathtracer_tpu_torch.render import renderer
    from pathtracer_tpu_torch.scene.reference_world import \
        reference_random_world
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    for fn in (tworlds.get_world, tworlds.test_world, tworlds.triangle_world,
               tworlds.random_world, tbunny.bunny_world,
               tcornell.cornell_box, tpresets.get_preset,
               tpresets.combined_scene, SceneBuilder.build,
               tcamera.make_camera, scene_from_jax_arrays, params_from_jax,
               reference_random_world, renderer.padded_pixel_grid,
               renderer.render_image, renderer.make_renderer):
        default = inspect.signature(fn).parameters["device"].default
        assert default == "cuda", fn.__qualname__
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tworlds.get_world("test")
