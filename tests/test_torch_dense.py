"""The port's dense closest hit against the JAX reference: the port's
``pallas_closest`` (its plain twin, on the CPU) against JAX
``pallas_closest`` (Pallas interpret mode), and the port's
``tensor_closest`` against JAX ``tensor_closest``, on the same rays.

Tolerances, both packages on the same rays. The reference contracts with
a bf16x6 split, the port in plain float32: each pair scalar carries an
absolute rounding error of a few ulps of its largest term, S = |o| + |v0|
for a triangle (t * det = o.m - v0.m) and (|o| + |c|)^2 / (2 r) for a
sphere (C = |o|^2 - 2 o.c + |c|^2 - r^2), and a hit whose ray meets the
surface at cosine cos carries it into t as about ulp(S) / (cos |d|). So:
- valid flags agree on every lane;
- t agrees to rtol 1e-5 plus 16 fp32 ulps of S / (cos |d|), measured in
  float64 at the reference's hit (the r=1000 backdrops and the
  550-unit Cornell box make S large; grazing hits make cos small; the
  largest reading on these rays is 4 ulps);
- winners agree on every lane except near ties (|dt| within that bound)
  and razor-edge hits, where float64 puts one of the two winners within
  1e-5 (relative) of its silhouette or edge, so that the two roundings
  may disagree on whether it is hit at all.

The CUDA kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core.camera import get_rays
from pathtracer_tpu.ops import pallas_sweep as jpallas
from pathtracer_tpu.ops import tensor_sweep as jtensor
from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.scene import cornell as jcornell
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.ops import pallas_sweep as tpallas
from pathtracer_tpu_torch.ops import tensor_sweep as ttensor
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE

torch.set_num_threads(1)

SCENES = ["test", "triangle", "random", "cornell-spheres", "cornell-full"]
N = 640          # a multiple of the reference's 128-ray tile
N_RAGGED = 300   # not a multiple of 128


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    # an empty OBJ directory: the reference takes its built-in Cornell data
    empty = str(tmp_path_factory.mktemp("no_obj"))
    out = {}
    for name in SCENES:
        if name.startswith("cornell"):
            js, jc = jcornell.cornell_box(obj_dir=empty,
                                          variant=name.split("-")[1])
        else:
            js, jc = jworlds.get_world(name)
        ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                    for f in js._fields}, device="cpu")
        out[name] = (js, jc, ts)
    return out


def _rays(js, jc, kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "camera":
        u = rng.random((4, n), dtype=np.float32)
        o, d, _ = get_rays(jc, *(jnp.asarray(x) for x in u),
                           jnp.zeros(n, jnp.float32))
        return np.array(o), np.array(d)
    # incoherent rays from inside the bounds of the prims (the r=1000
    # backdrops excluded), random directions, every 7th dead
    lo, hi = np.asarray(js.box_min), np.asarray(js.box_max)
    extent = (hi - lo).max(axis=1)
    small = extent <= 16.0 * np.median(extent)
    lo, hi = lo[small].min(axis=0), hi[small].max(axis=0)
    o = (lo + (hi - lo) * rng.random((n, 3))).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[::7] = 0.0
    return o, d


def _geometry(ts, idx, o, d, t):
    """Per lane, in float64 for primitive ``idx`` hit at ``t``: the
    rounding scale S, the cosine between ray and surface, and the
    relative distance of the hit from the prim's silhouette or edge."""
    ptype = ts.prim_type.numpy()[idx]
    v0, e1, e2 = (getattr(ts, f).numpy().astype(np.float64)[idx]
                  for f in ("v0", "e1", "e2"))
    r = np.abs(ts.radius.numpy().astype(np.float64)[idx])
    o, d = o.astype(np.float64), d.astype(np.float64)
    sph = ptype == PRIM_SPHERE
    o_n, c_n = np.linalg.norm(o, axis=1), np.linalg.norm(v0, axis=1)
    scale = np.where(sph, (o_n + c_n) ** 2 / (2 * np.maximum(r, 1e-30)),
                     o_n + c_n)
    # sphere: disc / B^2 of the quadratic
    oc = o - v0
    a = (d * d).sum(1)
    B = (oc * d).sum(1)
    disc = B * B - a * ((oc * oc).sum(1) - r * r)
    edge_sph = np.abs(disc) / np.maximum(B * B, 1e-300)
    # triangle: barycentrics (Moller-Trumbore)
    s1 = np.cross(d, e2)
    det = (s1 * e1).sum(1)
    inv = 1.0 / np.where(det == 0.0, 1.0, det)
    s = o - v0
    b1 = (s1 * s).sum(1) * inv
    b2 = (np.cross(s, e1) * d).sum(1) * inv
    edge_tri = np.abs(np.minimum(np.minimum(b1, b2), 1.0 - b1 - b2))
    p = o + t.astype(np.float64)[:, None] * d
    n = np.where(sph[:, None], p - v0, np.cross(e1, e2))
    cos = np.abs((n * d).sum(1)) / np.maximum(
        np.linalg.norm(n, axis=1) * np.sqrt(a), 1e-300)
    return scale, cos, np.where(sph, edge_sph, edge_tri)


def _check(a, b, ts, o, d):
    """Port result ``a`` (idx, t, valid) against the reference's ``b`` on
    rays (o, d); returns the number of hits."""
    idx_a, t_a, v_a = (np.asarray(x) for x in a)
    idx_b, t_b, v_b = (np.asarray(x) for x in b)
    np.testing.assert_array_equal(v_a, v_b)
    scale, cos, edge = _geometry(ts, idx_b, o, d, t_b)
    d_len = np.linalg.norm(d.astype(np.float64), axis=1)
    bound = (1e-5 * np.abs(t_b)
             + 16 * 2.0 ** -24 * scale / np.maximum(cos * d_len, 1e-30))
    dt = np.abs(t_a.astype(np.float64) - t_b)
    same = v_a & (idx_a == idx_b)
    assert (dt[same] <= bound[same]).all(), \
        f"t beyond the bound: {(dt[same] / bound[same]).max()} x"
    differ = v_a & (idx_a != idx_b)
    _, _, edge_a = _geometry(ts, idx_a, o, d, t_a)
    razor = (edge < 1e-5) | (edge_a < 1e-5)
    assert ((dt <= bound) | razor)[differ].all(), \
        "winners differ on lanes that are neither near ties nor razor edges"
    return int(v_a.sum())


@pytest.mark.parametrize("t_min", [1e-3, K_SHADOW_T_MIN])
@pytest.mark.parametrize("kind,n", [("camera", N), ("random", N_RAGGED)])
@pytest.mark.parametrize("name", SCENES)
def test_dense_closest_matches_jax(scenes, name, kind, n, t_min):
    js, jc, ts = scenes[name]
    o, d = _rays(js, jc, kind, n, seed=len(name) + n)
    jtab = jtensor.pack_sweep_tables(js, tile=jpallas.DEF_PRIM_TILE)
    ttab = ttensor.pack_sweep_tables(ts, tile=tpallas.DEF_PRIM_TILE)
    assert ttab.tile == jtab.tile
    jo, jd, to, td = (jnp.asarray(o), jnp.asarray(d), torch.from_numpy(o),
                      torch.from_numpy(d))

    ref = jpallas.pallas_closest(jtab, jo, jd, t_min)
    port = tpallas.pallas_closest(ttab, to, td, t_min)
    assert port[0].shape == (n,) and port[0].dtype == torch.int64
    hits = _check(port, ref, ts, o, d)
    if kind == "camera":
        assert hits > n // 4            # the wavefront really hits things
    else:
        assert not port[2].numpy()[::7].any()   # d == 0 lanes miss

    ref = jtensor.tensor_closest(jtensor.pack_sweep_tables(js), jo, jd,
                                 jnp.float32(t_min), jintersect.BIG_T)
    port = ttensor.tensor_closest(ttensor.pack_sweep_tables(ts), to, td,
                                  t_min, ttensor.intersect.BIG_T)
    _check(port, ref, ts, o, d)


def test_sweep_dispatch_and_ties():
    """CPU tensors take the plain twin (no kernel launch is counted), other
    devices raise; two identical triangles tie and the lower index wins,
    across tiles too."""
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    for _ in range(2):
        b.add_triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0), m)
    for i in range(200):
        b.add_sphere((0, 0, -5 - i), 0.5, m)
    b.add_triangle((-1, -1, 0), (1, -1, 0), (0, 1, 0), m)   # index 202
    scene = b.build(device="cpu")
    tables = ttensor.pack_sweep_tables(scene, tile=128)
    assert tables.cols.shape[0] == 2
    o = torch.tensor([[0.0, -0.2, 3.0]] * 5)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 5)
    before = tpallas.SWEEP_LAUNCHES
    idx, t, valid = tpallas.pallas_closest(tables, o, d, 1e-3)
    assert tpallas.SWEEP_LAUNCHES == before
    assert idx.tolist() == [0] * 5 and valid.all()
    np.testing.assert_allclose(t.numpy(), 3.0, rtol=1e-6)
    args = tpallas.sweep_inputs(tpallas.kernel_tables(tables), o, d, 1e-3)
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in args]
    with pytest.raises(ValueError, match="no dense sweep"):
        tpallas.sweep(*meta)
