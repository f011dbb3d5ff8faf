"""The port's cluster march (its plain twin, on the CPU) against the JAX
``cluster_march`` (Pallas interpret mode) and the dense brute-force scan,
on the bunny at the main path's cluster size (K=64).

Tolerances, both packages on the same rays:
- valid flags and winner indices agree on >= 99.9% of lanes, and any lane
  whose winner differs is a near tie (|dt| <= 1e-5 |t|): the reference
  sweeps with a bf16x6 split contraction, the port in plain float32, so
  pair scalars differ at ulp level;
- t agrees to rtol 1e-5 on triangle winners. Sphere winners get rtol 1e-5
  plus atol 2e-4: t = (-B - sqrt(B^2 - a C)) / a cancels for the r=1000
  ground sphere, and ulp differences in B and C grow to ~1e-4 in t there
  (the reference's own tests allow 2e-4..1e-3 for the same reason).

The CUDA kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core.camera import get_rays
from pathtracer_tpu.ops import clusters as jclusters
from pathtracer_tpu.ops import cluster_sweep as jsweep
from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops import clusters as tclusters
from pathtracer_tpu_torch.ops import intersect as tintersect
from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE

torch.set_num_threads(1)

T_MIN = 1e-3
N = 512


@pytest.fixture(scope="module")
def bunny():
    js, jc = jworlds.get_world("bunny")
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    return dict(js=js, jc=jc, ts=ts,
                jct=jclusters.build_cluster_tables(js, K=64),
                tct=tclusters.build_cluster_tables(ts, K=64))


def _camera_rays(jc, seed=1):
    u = np.random.default_rng(seed).random((4, N), dtype=np.float32)
    o, d, _ = get_rays(jc, *(jnp.asarray(x) for x in u),
                       jnp.zeros(N, jnp.float32))
    return np.asarray(o), np.asarray(d)


def _bounce_rays(seed=2):
    """Incoherent, bounce-like rays: origins in the scene's ball above the
    ground, random directions."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (N, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5
    d = rng.standard_normal((N, 3)).astype(np.float32)
    return o, d


def _wavefront(name, jc):
    if name == "camera":
        return _camera_rays(jc)
    o, d = _bounce_rays()
    if name == "dead":
        d[::5] = 0.0
    return o, d


def _check_pair(idx_a, t_a, v_a, idx_b, t_b, v_b, prim_type,
                sphere_tol=dict(rtol=1e-5, atol=2e-4)):
    """The module docstring's tolerances: a is checked against b."""
    assert (v_a == v_b).mean() >= 0.999
    both = v_a & v_b
    same = idx_a == idx_b
    assert same[both].mean() >= 0.999
    dt = np.abs(t_a - t_b)
    differ = both & ~same
    assert (dt[differ] <= 1e-5 * np.abs(t_b[differ])).all(), \
        "winners differ on lanes that are not near ties"
    sph = both & (prim_type[idx_b] == PRIM_SPHERE)
    tri = both & ~sph
    np.testing.assert_allclose(t_a[tri], t_b[tri], rtol=1e-5, atol=0)
    np.testing.assert_allclose(t_a[sph], t_b[sph], **sphere_tol)


@pytest.mark.parametrize("name", ["camera", "bounce", "dead"])
def test_march_matches_jax_and_brute(bunny, name):
    o, d = _wavefront(name, bunny["jc"])
    jct, tct = bunny["jct"], bunny["tct"]
    j = [np.asarray(x) for x in jsweep.cluster_march(
        jct, jnp.asarray(o), jnp.asarray(d), T_MIN)]
    t = [x.numpy() for x in tsweep.cluster_march(
        tct, torch.from_numpy(o), torch.from_numpy(d), T_MIN)]
    prim_type = tct.scene.prim_type.numpy()
    _check_pair(*t, *j, prim_type)
    if name == "dead":
        assert not t[2][::5].any()
    assert t[2].sum() > N // 4          # the wavefront really hits things

    # brute force over the original scene, compared by original prim id;
    # its sphere test is the factored form (o - c).d, |o - c|^2, which
    # rounds differently in the cancelling regime: rtol 1e-3 there (the
    # reference's own brute-force bound, tests/test_cluster.py) plus the
    # same atol 2e-4
    b = [np.asarray(x) for x in jintersect.brute_force_closest(
        bunny["js"], jnp.asarray(o), jnp.asarray(d), jnp.float32(T_MIN),
        jintersect.BIG_T)]
    perm = tct.perm.numpy()
    orig_type = bunny["ts"].prim_type.numpy()
    _check_pair(perm[t[0]], t[1], t[2], b[0], b[1], b[2], orig_type,
                sphere_tol=dict(rtol=1e-3, atol=2e-4))


def test_march_sorted_extras_mode(bunny):
    """The sorted-wavefront protocol: extras ride the binning sort and
    results stay in march order; by ray id they equal the reference's."""
    o, d = _bounce_rays(seed=3)
    alive = np.ones(N, bool)
    alive[::7] = False
    rid = np.arange(N, dtype=np.int32)
    payload = np.random.default_rng(4).random(N, dtype=np.float32)
    jq = jsweep.make_cluster_closest_hit(bunny["jct"], T_MIN).query_sorted
    j_idx, j_t, j_v, _, _, _, _, j_ex, _ = jq(
        jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive),
        (jnp.asarray(rid), jnp.asarray(payload)))
    tq = tsweep.make_cluster_closest_hit(bunny["tct"], T_MIN).query_sorted
    t_idx, t_t, t_v, t_o, t_d, t_alive, t_ex, pairs = tq(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(alive),
        (torch.from_numpy(rid), torch.from_numpy(payload)))
    t_rid = t_ex[0].numpy()
    assert sorted(t_rid.tolist()) == list(range(N))
    # extras and rays were permuted together
    np.testing.assert_array_equal(t_ex[1].numpy(), payload[t_rid])
    np.testing.assert_array_equal(t_o.numpy(), o[t_rid])
    np.testing.assert_array_equal(t_d.numpy(), d[t_rid])
    np.testing.assert_array_equal(t_alive.numpy(), alive[t_rid])
    assert pairs > 0 and pairs % (64 * 128) == 0

    def by_rid(rids, *xs):
        order = np.argsort(np.asarray(rids))
        return [np.asarray(x)[order] for x in xs]

    j = by_rid(j_ex[0], j_idx, j_t, j_v)
    t = by_rid(t_rid, t_idx.numpy(), t_t.numpy(), t_v.numpy())
    _check_pair(*t, *j, bunny["tct"].scene.prim_type.numpy())
    assert not t[2][~alive].any()


def test_unaligned_wavefront_and_t_max(bunny):
    """R not a multiple of the chunk (padded internally), and a t_max clamp
    of the hits and the march gate, against the reference."""
    o, d = _bounce_rays(seed=6)
    o, d = o[:300], d[:300]
    for kw in (dict(), dict(t_max=2.0)):
        j = [np.asarray(x) for x in jsweep.cluster_march(
            bunny["jct"], jnp.asarray(o), jnp.asarray(d), T_MIN, **kw)]
        t = [x.numpy() for x in tsweep.cluster_march(
            bunny["tct"], torch.from_numpy(o), torch.from_numpy(d), T_MIN,
            **kw)]
        assert t[0].shape == (300,)
        _check_pair(*t, *j, bunny["tct"].scene.prim_type.numpy())


def test_query_shadow_matches_jax(bunny):
    """The NEE shadow query of the march factory: near-zero t_min
    (K_SHADOW_T_MIN) and t_max = 1 on the unnormalized segment, caller
    order, against the reference's ``query_shadow``. Half of the segments
    start just behind a triangle, which they meet at t ~ 1e-4: a query at
    the bounce t_min (1e-3) would miss those occluders.

    The far half keeps the module's tolerances. On the contact half, flags
    and winners must agree exactly, but t there is a difference of pair
    scalars of size |o||d| ~ 1e2 divided by det, and float32 leaves about
    1e-5 of absolute error in it in both packages (against a float64
    Moller-Trumbore oracle: 1.2e-5 in the port, 6.3e-6 in the reference),
    so t is held to atol 3e-5 there: far below the 1e-3 that separates a
    contact occluder from a bounce-t_min miss."""
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    rng = np.random.default_rng(11)
    scene = bunny["tct"].scene
    tri = np.nonzero(scene.prim_type.numpy() != PRIM_SPHERE)[0]
    pick = rng.choice(tri, N // 2)
    v0, e1, e2 = (getattr(scene, f).numpy()[pick] for f in ("v0", "e1",
                                                             "e2"))
    q = v0 + 0.3 * e1 + 0.3 * e2
    light = rng.uniform((-6, 2, -6), (6, 12, 6), (N, 3)).astype(np.float32)
    o = np.empty((N, 3), np.float32)
    o[:N // 2] = q - 1e-4 * (light[:N // 2] - q)
    o[N // 2:] = rng.uniform((-8, 0.2, -8), (8, 6, 8), (N // 2, 3))
    d = (light - o).astype(np.float32)
    active = rng.random(N) < 0.9
    d_q = np.where(active[:, None], d, 0.0).astype(np.float32)

    jshadow = jsweep.make_cluster_closest_hit(bunny["jct"],
                                              T_MIN).query_shadow
    j = [np.asarray(x) for x in jshadow(jnp.asarray(o), jnp.asarray(d_q),
                                        jnp.asarray(active))]
    tshadow = tsweep.make_cluster_closest_hit(bunny["tct"],
                                              T_MIN).query_shadow
    t = [x.numpy() for x in tshadow(torch.from_numpy(o),
                                    torch.from_numpy(d_q),
                                    torch.from_numpy(active))]
    assert t[0].shape == (N,)
    far = slice(N // 2, N)
    _check_pair(*(x[far] for x in t), *(x[far] for x in j),
                scene.prim_type.numpy())
    contact = slice(0, N // 2)
    np.testing.assert_array_equal(t[2][contact], j[2][contact])
    hit = t[2][contact]
    np.testing.assert_array_equal(t[0][contact][hit], j[0][contact][hit])
    np.testing.assert_allclose(t[1][contact][hit], j[1][contact][hit],
                               rtol=0, atol=3e-5)
    assert not t[2][~active].any()
    assert (t[1][t[2]] < 1.0).all()
    # contact occluders that only the near-zero t_min sees
    near = t[2] & (t[1] < T_MIN)
    assert near.sum() > N // 8 and (t[1][near] > K_SHADOW_T_MIN).all()


def test_port_brute_force_matches_reference(bunny):
    o, d = _camera_rays(bunny["jc"], seed=8)
    o, d = o[:128], d[:128]
    j = [np.asarray(x) for x in jintersect.brute_force_closest(
        bunny["js"], jnp.asarray(o), jnp.asarray(d), jnp.float32(T_MIN),
        jintersect.BIG_T)]
    t = [x.numpy() for x in tintersect.brute_force_closest(
        bunny["ts"], torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        tintersect.BIG_T)]
    _check_pair(*t, *j, bunny["ts"].prim_type.numpy(),
                sphere_tol=dict(rtol=1e-5, atol=1e-4))


def test_hit_records_match(bunny):
    """Winner fields gathered by index give the reference's hit records."""
    o, d = _camera_rays(bunny["jc"], seed=9)
    jct, tct = bunny["jct"], bunny["tct"]
    idx, _, valid = tsweep.cluster_march(tct, torch.from_numpy(o),
                                         torch.from_numpy(d), T_MIN)
    trec = tintersect.hit_records_from_prims(
        tct.scene, idx, torch.from_numpy(o), torch.from_numpy(d), T_MIN,
        tintersect.BIG_T, valid)
    jrec = jintersect.hit_records_from_prims(
        jct.scene, jnp.asarray(idx.numpy().astype(np.int32)),
        jnp.asarray(o), jnp.asarray(d), jnp.float32(T_MIN),
        jintersect.BIG_T, jnp.asarray(valid.numpy()))
    v = valid.numpy()
    # t and p recompute the factored sphere test, which cancels for the
    # ground sphere (see _check_pair): atol 1e-4 scene units there
    for f, atol in (("p", 1e-4), ("normal", 1e-5), ("t", 1e-4),
                    ("prim_area", 1e-5)):
        np.testing.assert_allclose(getattr(trec, f).numpy()[v],
                                   np.asarray(getattr(jrec, f))[v],
                                   rtol=1e-5, atol=atol, err_msg=f)
    for f in ("mat_id", "front_face"):
        np.testing.assert_array_equal(getattr(trec, f).numpy()[v],
                                      np.asarray(getattr(jrec, f))[v])


def test_march_wrapper_dispatch(bunny):
    """CPU tensors take the plain twin (no kernel launch is counted);
    other devices raise instead of falling back."""
    o, d = _camera_rays(bunny["jc"], seed=10)
    q = tsweep.march_inputs(bunny["tct"], torch.from_numpy(o),
                            torch.from_numpy(d), T_MIN)
    before = tsweep.MARCH_LAUNCHES
    t_best, best, slots = tsweep.march(*q["args"])
    ref = tsweep.march_reference(*q["args"])
    assert tsweep.MARCH_LAUNCHES == before
    for a, b in zip((t_best, best, slots), ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert slots.shape == (N // 128,) and int(slots.sum()) > 0
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x
            for x in q["args"]]
    with pytest.raises(ValueError, match="no cluster march"):
        tsweep.march(*meta)

