"""Port scene, camera and config against the JAX reference.

The port's SceneBuilder worlds must produce the reference's scene fields
bit for bit (same numpy host build), the camera must match, and config
validation / accel resolution must agree.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu import config as jconfig
from pathtracer_tpu.scene import bunny as jbunny
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch import config as tconfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import camera as tcamera
from pathtracer_tpu_torch.scene import bunny as tbunny
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)


def _worlds(name):
    if name == "bunny":
        # both packages read the vendored asset, whatever else is installed
        return (jbunny.bunny_world(obj_path=tbunny.ASSET_OBJ),
                tbunny.bunny_world(obj_path=tbunny.ASSET_OBJ))
    return jworlds.get_world(name), tworlds.get_world(name)


@pytest.mark.parametrize("name", ["bunny", "test"])
def test_scene_fields_equal(name):
    (js, jc), (ts, tc) = _worlds(name)
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
    ts, _ = tbunny.bunny_world(obj_path=tbunny.ASSET_OBJ)
    # 3,616 mesh triangles + ground, mirror and glass spheres
    assert ts.num_prims == 3619


def test_converter_round_trip():
    js, _ = jworlds.get_world("test")
    fields = {f: np.asarray(getattr(js, f)) for f in js._fields}
    ts = scene_from_jax_arrays(fields)
    for f, a in fields.items():
        back = getattr(ts, f).numpy()
        np.testing.assert_array_equal(back, a, err_msg=f)
        assert back.dtype == a.dtype, f
    with pytest.raises(KeyError):
        scene_from_jax_arrays({"v0": fields["v0"]})


def test_get_rays_matches():
    from pathtracer_tpu.core.camera import get_rays as jget_rays
    _, jc = jworlds.get_world("test")
    _, cam = tworlds.get_world("test")
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
    from pathtracer_tpu_torch.render.renderer import render_image
    ts, tc = tworlds.get_world("test")
    small = dict(width=8, height=4, spp=1, max_depth=1, ray_chunk=32)
    # auto on a 3-prim scene resolves to the unported dense sweep
    with pytest.raises(NotImplementedError, match="Queue 1, item 7"):
        render_image(ts, tc, tconfig.RenderConfig(**small))
    for kw in (dict(nee=True), dict(rr=True), dict(sampler="sobol"),
               dict(stratify=True)):
        with pytest.raises(NotImplementedError, match="item 8"):
            render_image(ts, tc, tconfig.RenderConfig(accel="cluster",
                                                      **small, **kw))
    for name in ("random", "cornell"):
        with pytest.raises(NotImplementedError, match="item 7"):
            tworlds.get_world(name)
    with pytest.raises(NotImplementedError, match="item 9"):
        tbunny.bunny_world(subdivide=1)
    from pathtracer_tpu_torch.render.renderer import render_sum
    with pytest.raises(NotImplementedError, match="item 10"):
        render_sum(ts, tc, (0, 0), None, None,
                   tconfig.RenderConfig(accel="cluster", **small), 1, None,
                   differentiable=True)
