"""The port's LBVH build and stackless traversal against the JAX reference
(``accel/lbvh.py``, ``ops/traversal.py``, and the helpers ``clz32``,
``clz64_pair`` and ``ray_aabb_hit`` beneath them).

The build is integer and min/max arithmetic only, so its seven arrays are
held to the bit. Traversal winners must equal the reference's traversal
and brute force up to ties at bit-equal t; t agrees to rtol 1e-5, with
atol 2e-4 on sphere winners (the reference's cancelling sphere root,
ROADMAP "Held against the reference").
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.accel.lbvh import build_lbvh as jbuild
from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.ops import traversal as jtraversal
from pathtracer_tpu.scene.scene import SceneBuilder
from pathtracer_tpu.scene.worlds import get_world as jget_world
from pathtracer_tpu_torch.accel.lbvh import build_lbvh
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core.camera import Camera, get_rays
from pathtracer_tpu_torch.ops import intersect, morton, traversal
from test_lbvh import _check_invariants, _small_world

torch.set_num_threads(1)

T_MIN = 1e-3


def _port(js):
    return scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                  for f in js._fields}, device="cpu")


def _spheres_at_one_point(n=8):
    b = SceneBuilder()
    m = b.add_lambertian((1, 1, 1))
    for _ in range(n):
        b.add_sphere((0, 0, 0), 1.0, m)
    return b.build()


def _one_sphere():
    return _spheres_at_one_point(1)


WORLDS = {
    "small40": lambda: _small_world(40),
    "small3": lambda: _small_world(3),
    "one prim": _one_sphere,
    "duplicate centres": _spheres_at_one_point,
    "test": lambda: jget_world("test")[0],
    "bunny": lambda: jget_world("bunny")[0],
}


def test_clz_matches_jax():
    rng = np.random.default_rng(11)
    x = rng.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    x >>= rng.integers(0, 32, 4096).astype(np.uint32)   # every bit length
    x[:6] = [0, 1, 2, 2**31, 2**32 - 1, 2**16]
    want = np.asarray(jax.lax.clz(jnp.asarray(x)))
    got = morton.clz32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)

    from pathtracer_tpu.ops import morton as jmorton
    codes = rng.integers(0, 2**30, (2, 2048)).astype(np.uint32)
    codes[1, :512] = codes[0, :512]               # equal codes: ids decide
    ids = rng.integers(0, 2**31, (2, 2048)).astype(np.int32)
    ids[1, :64] = ids[0, :64]                     # equal keys: 64
    want = np.asarray(jmorton.clz64_pair(*(jnp.asarray(a) for a in (
        codes[0], ids[0], codes[1], ids[1]))))
    got = morton.clz64_pair(*(torch.from_numpy(a.astype(np.int64)) for a in (
        codes[0], ids[0], codes[1], ids[1]))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:64] == 64).all()


def test_ray_aabb_hit_matches_jax():
    """Random boxes and rays, and axis-aligned rays whose origin lies on a
    slab plane: there (bmin - o) * (1 / 0) is NaN, which must fall through
    to the running bound as in the reference (a NaN-propagating max would
    decide those lanes otherwise)."""
    rng = np.random.default_rng(5)
    n = 4096
    bmin = rng.uniform(-2, 0, (n, 3)).astype(np.float32)
    bmax = bmin + rng.uniform(0, 2, (n, 3)).astype(np.float32)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    # aimed near each box, so about half hit
    d = (0.5 * (bmin + bmax) + rng.normal(0, 0.7, (n, 3)) - o).astype(
        np.float32)
    k = n // 2
    axis = rng.integers(0, 3, k)
    d[np.arange(k), axis] = np.where(np.arange(k) % 2, 0.0, -0.0)
    on = np.arange(k) % 4 < 2
    o[np.arange(k)[on], axis[on]] = np.where(
        np.arange(k)[on] % 8 < 4, bmin[np.arange(k)[on], axis[on]],
        bmax[np.arange(k)[on], axis[on]])
    t_max = rng.uniform(0.5, 20, n).astype(np.float32)
    t_max[::7] = 3e38
    want = np.asarray(jintersect.ray_aabb_hit(
        *(jnp.asarray(a) for a in (o, d, bmin, bmax)), jnp.float32(T_MIN),
        jnp.asarray(t_max)))
    args = [torch.from_numpy(a) for a in (o, d, bmin, bmax)]
    got = intersect.ray_aabb_hit(*args, T_MIN,
                                 torch.from_numpy(t_max)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.1 < want.mean() < 0.9

    # the trouble spot is exercised: torch.maximum / minimum propagate NaN
    o_, d_, lo_b, hi_b = args
    inv = 1.0 / d_
    t0, t1 = (lo_b - o_) * inv, (hi_b - o_) * inv
    lo = torch.where(inv < 0, t1, t0)
    hi = torch.where(inv < 0, t0, t1)
    nan_max = torch.maximum(lo.amax(1), torch.tensor(T_MIN))
    nan_min = torch.minimum(hi.amin(1), torch.from_numpy(t_max))
    assert (~(nan_min < nan_max)).numpy().tolist() != got.tolist()


@pytest.mark.parametrize("world", list(WORLDS))
def test_build_lbvh_bit_equal(world):
    js = WORLDS[world]()
    want = jbuild(js)
    got = build_lbvh(_port(js))
    assert got._fields == want._fields
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == (torch.float32 if name.startswith("box")
                           else torch.int32), name
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    if world != "one prim":
        _check_invariants(_port(js), got)
    else:
        assert got.num_nodes == 1 and got.obj_id.tolist() == [0]
        assert got.escape.tolist() == [1]


def _check_hits(got, want, prim_type):
    """Same valid flags; winners equal but at bit-equal t; t to rtol 1e-5
    (sphere winners also atol 2e-4)."""
    (gi, gt, gv), (wi, wt, wv) = ([np.asarray(x) for x in h]
                                  for h in (got, want))
    np.testing.assert_array_equal(gv, wv)
    differ = wv & (gi != wi)
    np.testing.assert_array_equal(gt[differ], wt[differ])
    same = wv & (gi == wi)
    sph = prim_type[wi] == 1
    np.testing.assert_allclose(gt[same & ~sph], wt[same & ~sph], rtol=1e-5)
    np.testing.assert_allclose(gt[same & sph], wt[same & sph], rtol=1e-5,
                               atol=2e-4)
    np.testing.assert_array_equal(gt[~wv], np.float32(3e38))
    return int(wv.sum())


def _rays(world, js, n, rng):
    if world in ("test", "bunny"):
        _, jc = jget_world(world)
        cam = Camera(*(torch.from_numpy(np.array(x)) for x in jc))
        u = torch.from_numpy(rng.random((2, n), dtype=np.float32))
        zero = torch.zeros(n)
        o, d, _ = get_rays(cam, u[0], u[1], zero, zero, zero)
        o, d = o.numpy().copy(), d.numpy().copy()
    else:
        o = rng.normal(0, 5, (n, 3)).astype(np.float32)
        d = (rng.normal(0, 2, (n, 3)) - o).astype(np.float32)  # inward
    d[::9] = 0.0                        # dead lanes, as the integrator's
    d[1::9, :2] = 0.0                   # axis-aligned
    return o, d


@pytest.mark.parametrize("world", ["small40", "duplicate centres", "test",
                                   "bunny"])
def test_traverse_matches_jax_and_brute_force(world):
    js = WORLDS[world]()
    ts = _port(js)
    o, d = _rays(world, js, 512, np.random.default_rng(3))
    want = jtraversal.traverse(jtraversal.pack_fat_nodes(js, jbuild(js)),
                               jnp.asarray(o), jnp.asarray(d), T_MIN,
                               jintersect.BIG_T)
    closest = traversal.make_bvh_closest_hit(ts, build_lbvh(ts), T_MIN)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    got = closest(to, td)
    prim_type = np.asarray(js.prim_type)
    assert _check_hits(got, want, prim_type) > 20
    brute = intersect.brute_force_closest(ts, to, td, T_MIN, intersect.BIG_T)
    _check_hits(got, brute, prim_type)


def test_traverse_one_prim_and_step_cap():
    """A root that is a leaf; and ``max_steps`` caps the walk: one step
    leaves every ray at the first node."""
    ts = _port(_one_sphere())
    nodes = traversal.pack_fat_nodes(ts, build_lbvh(ts))
    o = torch.tensor([[0.0, 0.0, 5.0], [0.0, 5.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]])
    idx, t, valid = traversal.traverse(nodes, o, d, T_MIN, intersect.BIG_T)
    assert valid.tolist() == [True, False] and idx.tolist() == [0, 0]
    assert t[0].item() == pytest.approx(4.0)
    js = _small_world(40)
    ts = _port(js)
    nodes = traversal.pack_fat_nodes(ts, build_lbvh(ts))
    o, d = _rays("small40", js, 64, np.random.default_rng(8))
    _, _, valid = traversal.traverse(nodes, torch.from_numpy(o),
                                     torch.from_numpy(d), T_MIN,
                                     intersect.BIG_T, max_steps=1)
    assert not valid.any()      # the root is internal: no leaf reached
