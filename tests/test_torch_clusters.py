"""The port's morton codes, sweep tables and cluster build against the JAX
reference, on the bunny (the main path's scene) and small scenes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import clusters as jclusters
from pathtracer_tpu.ops import morton as jmorton
from pathtracer_tpu.ops import tensor_sweep as jsweep
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.ops import clusters as tclusters
from pathtracer_tpu_torch.ops import morton as tmorton
from pathtracer_tpu_torch.ops import tensor_sweep as tsweep
from pathtracer_tpu_torch.scene.scene import SceneBuilder

torch.set_num_threads(1)


def _port_scene(js):
    return scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                  for f in js._fields}, device="cpu")


@pytest.fixture(scope="module")
def bunny_tables():
    js, _ = jworlds.get_world("bunny")
    return (jclusters.build_cluster_tables(js, K=64),
            tclusters.build_cluster_tables(_port_scene(js), K=64))


def test_bunny_tables_match(bunny_tables):
    jct, tct = bunny_tables
    assert (tct.K, tct.C_reg) == (jct.K, jct.C_reg) == (64, 57)
    for f in ("perm", "ctype", "is_sphere", "valid_row"):
        np.testing.assert_array_equal(getattr(tct, f).numpy(),
                                      np.asarray(getattr(jct, f)),
                                      err_msg=f)
    # ulp-level differences in the cross products are allowed
    for f in ("cols", "cmin", "cmax"):
        a = np.asarray(getattr(jct, f))
        b = getattr(tct, f).numpy()
        assert a.shape == b.shape, f
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6, err_msg=f)


def test_bunny_reordered_scene_matches(bunny_tables):
    jct, tct = bunny_tables
    for f in jct.scene._fields:
        np.testing.assert_array_equal(getattr(tct.scene, f).numpy(),
                                      np.asarray(getattr(jct.scene, f)),
                                      err_msg=f)


def test_bunny_residual_holds_ground(bunny_tables):
    _, tct = bunny_tables
    radius = tct.scene.radius.numpy()
    K, C = tct.K, tct.C_reg
    assert (np.abs(radius[C * K:]) >= 999).any()
    assert (np.abs(radius[:C * K]) < 999).all()


def test_morton_matches():
    rng = np.random.default_rng(2)
    c = rng.uniform(-3, 5, (1000, 3)).astype(np.float32)
    lo = np.array([-3, -2.5, -3], np.float32)
    hi = np.array([5, 5, 4.5], np.float32)
    a = np.asarray(jmorton.morton3d(jnp.asarray(c), jnp.asarray(lo),
                                    jnp.asarray(hi)))
    b = tmorton.morton3d(torch.from_numpy(c), torch.from_numpy(lo),
                         torch.from_numpy(hi)).numpy()
    np.testing.assert_array_equal(b, a.astype(np.int64))
    v = np.arange(1024, dtype=np.uint32)
    np.testing.assert_array_equal(
        tmorton.expand_bits(torch.from_numpy(v.astype(np.int64))).numpy(),
        np.asarray(jmorton.expand_bits(jnp.asarray(v))).astype(np.int64))


@pytest.mark.parametrize("tile", [128, 2048])
def test_pack_sweep_tables_matches(tile):
    js, _ = jworlds.get_world("test")
    jt = jsweep.pack_sweep_tables(js, tile=tile)
    tt = tsweep.pack_sweep_tables(_port_scene(js), tile=tile)
    assert (tt.tile, tt.num_prims) == (jt.tile, jt.num_prims)
    np.testing.assert_allclose(tt.cols.numpy(), np.asarray(jt.cols),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tt.is_sphere.numpy(),
                                  np.asarray(jt.is_sphere))
    np.testing.assert_array_equal(tt.valid_row.numpy(),
                                  np.asarray(jt.valid_row))


def test_huge_clamp_and_lights_match():
    """More huge prims than K_RES (the clamp demotes the rest) and an
    emissive prim (the light remap), against the reference build."""
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    light = b.add_emissive((4.0, 4.0, 4.0))
    rng = np.random.default_rng(5)
    for c in rng.uniform(-5, 5, (120, 3)):
        b.add_sphere(c, 0.1, m)
    b.add_triangle((0, 4, 0), (1, 4, 0), (0, 4, 1), light)
    for i in range(tclusters.K_RES + 3):
        b.add_sphere((i * 40.0 - 200.0, -60.0, 0.0), 50.0 + i, m)
    ts = b.build(device="cpu")
    fields = {f: getattr(ts, f).numpy() for f in ts._fields}
    from pathtracer_tpu.scene.scene import Scene as JScene
    js = JScene(**{f: jnp.asarray(v) for f, v in fields.items()})
    jct = jclusters.build_cluster_tables(js, K=64)
    tct = tclusters.build_cluster_tables(ts, K=64)
    np.testing.assert_array_equal(tct.perm.numpy(), np.asarray(jct.perm))
    np.testing.assert_array_equal(tct.scene.light_idx.numpy(),
                                  np.asarray(jct.scene.light_idx))
    np.testing.assert_array_equal(tct.ctype.numpy(), np.asarray(jct.ctype))
    with pytest.raises(ValueError):
        tclusters.build_cluster_tables(ts, K=12)
