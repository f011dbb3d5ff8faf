"""The port's "rounds" cluster strategy against the JAX reference: the
window sweep's plain twin against the JAX ``_window_pass`` (Pallas
interpret mode), the port's ``cluster_closest`` against the JAX
``cluster_closest`` and against the port's own march on the same tables,
the rounds shadow query, the factory and the renderer's environment knobs,
and a rounds render against the JAX render.

Tolerances, both packages on the same rays (those of
tests/test_torch_march.py):
- valid flags and winner indices agree on >= 99.9% of lanes, and a lane
  whose winner differs is a near tie (|dt| <= 1e-5 |t|): the reference's
  window kernel contracts with the bf16x6 split (``sweep_dot`` in Pallas
  interpret mode), the port in plain float32;
- t to rtol 1e-5 on triangle winners, rtol 1e-5 + atol 2e-4 on sphere
  winners (the r=1000 ground sphere's near root cancels);
- on the small worlds (random, triangle, cornell), whose r=1000 backdrops
  and grazing hits make the pair scalars' rounding larger than that, the
  bound of tests/test_torch_dense.py: t to rtol 1e-5 plus 16 fp32 ulps of
  the pair scalar's largest term over the cosine of incidence, flags equal,
  winners equal except at near ties and razor edges;
- the port's rounds against the port's march on the same tables: the same
  float32 arithmetic per (ray, primitive) pair, so flags are equal and t
  is bit-equal on every lane that hits; a winner may differ only at a tie;
- incoherent rays in the random world against the reference's march and
  rounds: rtol 1e-3 on t, the reference's own march-vs-rounds bound
  (tests/test_cluster.py).

The CUDA window kernel itself is held against the twin on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_dense import _check as _check_small_world
from test_torch_march import _bounce_rays, _check_pair

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.core.camera import get_rays
from pathtracer_tpu.ops import cluster_sweep as jsweep
from pathtracer_tpu.ops import clusters as jclusters
from pathtracer_tpu.render.renderer import render_image as jrender
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops import clusters as tclusters
from pathtracer_tpu_torch.ops.tensor_sweep import BIG, ray_features
from pathtracer_tpu_torch.render import renderer as trenderer
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)

T_MIN = 1e-3
N = 512
K = 128


@functools.lru_cache(maxsize=None)
def _tables(world):
    """Both packages' K=128 cluster tables of one reference world, built
    once per process."""
    js, jc = jworlds.get_world(world)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    return dict(js=js, jc=jc, ts=ts,
                jct=jclusters.build_cluster_tables(js, K=K),
                tct=tclusters.build_cluster_tables(ts, K=K))


@pytest.fixture(scope="module")
def bunny():
    return _tables("bunny")


def _camera_rays(jc, n=N, seed=1):
    u = np.random.default_rng(seed).random((4, n), dtype=np.float32)
    o, d, _ = get_rays(jc, *(jnp.asarray(x) for x in u),
                       jnp.zeros(n, jnp.float32))
    return np.array(o), np.array(d)


def _check_same_arithmetic(rounds, march):
    """Port rounds against port march on the same tables."""
    np.testing.assert_array_equal(rounds[2], march[2])
    hit = rounds[2]
    np.testing.assert_array_equal(rounds[1][hit], march[1][hit])
    assert (rounds[0][hit] == march[0][hit]).mean() >= 0.999


def _run_all(tabs, o, d, t_min=T_MIN, **kw):
    """(port rounds, JAX rounds, port march) as numpy triples."""
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    t = [x.numpy() for x in tsweep.cluster_closest(tabs["tct"], ot, dt,
                                                   t_min, **kw)]
    j = [np.asarray(x) for x in jsweep.cluster_closest(
        tabs["jct"], jnp.asarray(o), jnp.asarray(d), t_min, **kw)]
    m = [x.numpy() for x in tsweep.cluster_march(tabs["tct"], ot, dt, t_min)]
    return t, j, m


def _window_case(name, tct, o, d, rng):
    """(starts, skips, W) of one launch kind over the chunks of (o, d)."""
    C_reg = tct.C_reg
    n_chunks = o.shape[0] // 128
    if name == "residual":
        return (np.full(n_chunks, C_reg), rng.random(n_chunks) < 0.3, 1)
    if name == "window":
        # a first round's starts: each chunk's nearest touched cluster
        entry = tsweep._cull(o, d, torch.any(d != 0.0, dim=1), tct.cmin,
                             tct.cmax, T_MIN)
        key, _ = tsweep._key_and_resolved(
            entry, torch.zeros_like(entry, dtype=torch.bool),
            torch.full((o.shape[0],), BIG))
        chunk_min = key.view(n_chunks, 128).amin(dim=1).numpy()
        return (np.clip(chunk_min, 0, C_reg - 4),
                np.arange(n_chunks) % 4 == 1, 4)
    if name == "last":      # the window ends at the residual tile
        return (np.full(n_chunks, tct.cols.shape[0] - 4),
                np.zeros(n_chunks, bool), 4)
    if name == "fallback":
        return np.zeros(n_chunks, int), np.zeros(n_chunks, bool), C_reg
    return np.zeros(n_chunks, int), np.ones(n_chunks, bool), 4   # all skip


@pytest.mark.parametrize("name", ["residual", "window", "last", "fallback",
                                  "allskip"])
def test_window_twin_matches_jax(bunny, name):
    """``window_reference`` against the JAX ``_window_pass`` on the same
    features, starts and skips: the residual pass (W=1 from C_reg, random
    skips), a W=4 window at random starts, the last legal start, the
    full-width fallback and an all-skip launch."""
    rng = np.random.default_rng(["residual", "window", "last", "fallback",
                                 "allskip"].index(name))
    o, d = _camera_rays(bunny["jc"], seed=3)
    o[N // 2:], d[N // 2:] = (x[:N // 2] for x in _bounce_rays(4))
    d[::7] = 0.0
    ot, dt = torch.from_numpy(o), torch.from_numpy(d)
    phi = ray_features(ot, dt)
    a = vec.dot(dt, dt)
    a = torch.where(a == 0.0, 1.0, a)
    tct, jct = bunny["tct"], bunny["jct"]
    starts, skips, W = _window_case(name, tct, ot, dt, rng)
    C_tot = tct.cols.shape[0]
    t = [x.numpy() for x in tsweep.window_reference(
        phi, a, torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(skips.astype(np.int32)), tct.cols,
        tct.is_sphere.view(C_tot, K), tct.ranges, K, W, T_MIN, 128)]
    j = [np.asarray(x) for x in jsweep._window_pass(
        jct, jnp.asarray(phi.numpy()), jnp.asarray(a.numpy()),
        jnp.asarray(starts, jnp.int32), jnp.asarray(skips, jnp.int32), W,
        T_MIN, 128)]
    lane_skip = np.repeat(skips, 128)
    for t_, b_ in (t, j):
        assert (b_[lane_skip] == -1).all() and (t_[lane_skip] == BIG).all()
    v_t, v_j = t[1] >= 0, j[1] >= 0
    if v_t.any() or v_j.any():
        _check_pair(np.maximum(t[1], 0), t[0], v_t, np.maximum(j[1], 0),
                    j[0], v_j, tct.scene.prim_type.numpy())
    # the windows really hit things (the bunny covers a small part of the
    # image; the residual tile holds the ground sphere)
    assert v_t.sum() >= dict(residual=N // 8, window=4, last=0, fallback=16,
                             allskip=0)[name]
    # winners lie inside each chunk's window
    lo = np.repeat(starts, 128) * K
    win = v_t & ~lane_skip
    assert ((t[1][win] >= lo[win]) & (t[1][win] < lo[win] + W * K)).all()


@pytest.mark.parametrize("world", ["random", "triangle", "cornell"])
def test_rounds_camera_rays(world):
    """Camera rays on the reference's small worlds (tests/test_cluster.py's
    cases), K=128 tables."""
    tabs = _tables(world)
    o, d = _camera_rays(tabs["jc"], n=256, seed=1)
    t, j, m = _run_all(tabs, o, d)
    _check_small_world(t, j, tabs["tct"].scene, o, d)
    _check_same_arithmetic(t, m)
    assert t[2].sum() > 256 // 4


@pytest.mark.parametrize("name,kw", [
    ("camera", {}), ("bounce", {}), ("dead", {}),
    ("camera", dict(sort_rays=False)), ("bounce", dict(max_rounds=0))])
def test_rounds_bunny(bunny, name, kw):
    """Bunny camera, bounce and dead wavefronts; the unsorted mode; and
    max_rounds=0, which sends every unresolved ray through the exact
    fallback."""
    if name == "camera":
        o, d = _camera_rays(bunny["jc"])
    else:
        o, d = _bounce_rays(2)
    if name == "dead":
        d[::5] = 0.0
    t, j, m = _run_all(bunny, o, d, **kw)
    _check_pair(*t, *j, bunny["tct"].scene.prim_type.numpy())
    _check_same_arithmetic(t, m)
    assert t[2].sum() > N // 4
    if name == "dead":
        assert not t[2][::5].any()


def test_rounds_incoherent_random_world():
    """Incoherent rays with dead lanes in the random world, against the
    reference's march and rounds (rtol 1e-3, the reference's own bound)."""
    tabs = _tables("random")
    rng = np.random.default_rng(11)
    o = rng.uniform(-8, 8, (256, 3)).astype(np.float32)
    d = rng.standard_normal((256, 3)).astype(np.float32)
    dead = np.arange(256) % 5 == 0
    d[dead] = 0.0
    t, j, m = _run_all(tabs, o, d)
    j_march = [np.asarray(x) for x in jsweep.cluster_march(
        tabs["jct"], jnp.asarray(o), jnp.asarray(d), T_MIN)]
    for ref in (j, j_march):
        np.testing.assert_array_equal(t[2], ref[2])
        hit = t[2]
        np.testing.assert_allclose(t[1][hit], ref[1][hit], rtol=1e-3)
    _check_same_arithmetic(t, m)
    assert not t[2][dead].any() and t[2].sum() > 256 // 4


def test_dead_rays_resolve_as_miss(bunny):
    """Dead lanes (d == 0) are misses, and live lanes do not depend on
    their dead neighbours (tests/test_cluster.py's case)."""
    o, d = _camera_rays(bunny["jc"], n=256, seed=5)
    dead = np.arange(256) % 3 == 0
    d_m = np.where(dead[:, None], 0.0, d).astype(np.float32)
    tct = bunny["tct"]
    idx, t, valid = (x.numpy() for x in tsweep.cluster_closest(
        tct, torch.from_numpy(o), torch.from_numpy(d_m), T_MIN))
    idx2, t2, valid2 = (x.numpy() for x in tsweep.cluster_closest(
        tct, torch.from_numpy(o), torch.from_numpy(d), T_MIN))
    assert not valid[dead].any()
    np.testing.assert_array_equal(valid[~dead], valid2[~dead])
    np.testing.assert_array_equal(t[~dead], t2[~dead])
    np.testing.assert_array_equal(idx[~dead], idx2[~dead])


def test_rounds_query_shadow_matches_jax(bunny):
    """The rounds factory's NEE shadow query (K_SHADOW_T_MIN, no t_max, the
    caller's dead segments zeroed) against the reference's."""
    rng = np.random.default_rng(12)
    o, _ = _bounce_rays(13)
    light = rng.uniform((-6, 2, -6), (6, 12, 6), (N, 3)).astype(np.float32)
    active = rng.random(N) < 0.9
    d = np.where(active[:, None], light - o, 0.0).astype(np.float32)
    j = [np.asarray(x) for x in jsweep.make_cluster_closest_hit(
        bunny["jct"], T_MIN, strategy="rounds").query_shadow(
            jnp.asarray(o), jnp.asarray(d), jnp.asarray(active))]
    t = [x.numpy() for x in tsweep.make_cluster_closest_hit(
        bunny["tct"], T_MIN, strategy="rounds").query_shadow(
            torch.from_numpy(o), torch.from_numpy(d),
            torch.from_numpy(active))]
    _check_pair(*t, *j, bunny["tct"].scene.prim_type.numpy())
    assert not t[2][~active].any()
    # no t_max: occluders beyond the light point (t > 1) are hits too
    assert (t[1][t[2]] > 1.0).any() and (t[1][t[2]] < 1.0).any()


def test_rounds_needs_k128(bunny, monkeypatch):
    """K=64 tables with the rounds strategy raise ValueError in both
    packages, and so does the renderer's route for PT_CLUSTER_K=64."""
    o, d = _camera_rays(bunny["jc"], n=128)
    # the check comes first in both packages: K=64 stand-ins of the K=128
    # tables are enough
    jct64 = dataclasses.replace(bunny["jct"], K=64)
    tct64 = dataclasses.replace(bunny["tct"], K=64)
    with pytest.raises(ValueError, match="K % 128"):
        jsweep.make_cluster_closest_hit(jct64, T_MIN, strategy="rounds")(
            jnp.asarray(o), jnp.asarray(d))
    with pytest.raises(ValueError, match="K % 128"):
        tsweep.make_cluster_closest_hit(tct64, T_MIN, strategy="rounds")
    with pytest.raises(ValueError, match="K % 128"):
        tsweep.cluster_closest(tct64, torch.from_numpy(o),
                               torch.from_numpy(d), T_MIN)
    monkeypatch.setenv("PT_CLUSTER_STRATEGY", "rounds")
    monkeypatch.setenv("PT_CLUSTER_K", "64")
    with pytest.raises(ValueError, match="K % 128"):
        trenderer.make_query(bunny["ts"], TConfig(accel="cluster"))


def test_factory_and_environment_knobs(monkeypatch):
    """``make_query`` reads the reference's six knobs in one place; the
    rounds factory has no sorted protocol; an unknown strategy raises."""
    ts, _ = tworlds.get_world("test", device="cpu")
    cfg = TConfig(accel="cluster")
    for var in ("PT_CLUSTER_K", "PT_CLUSTER_STRATEGY", "PT_CLUSTER_RAY_TILE",
                "PT_CLUSTER_WINDOW", "PT_CLUSTER_MAX_ROUNDS",
                "PT_CLUSTER_SORT"):
        monkeypatch.delenv(var, raising=False)
    assert trenderer.cluster_options() == (trenderer.CLUSTER_K, {})
    march = trenderer.make_query(ts, cfg).closest
    assert march.handles_dead and march.query_sorted and march.query_shadow
    assert march.ray_tile == tsweep.DEF_RAY_TILE
    # the chunk size reaches the march (and its sorted protocol), as
    # PT_CLUSTER_RAY_TILE reaches the reference's factory
    monkeypatch.setenv("PT_CLUSTER_RAY_TILE", "256")
    assert trenderer.cluster_options() == (trenderer.CLUSTER_K,
                                           dict(ray_tile=256))
    assert trenderer.make_query(ts, cfg).closest.ray_tile == 256
    for var, value in (("PT_CLUSTER_K", "128"),
                       ("PT_CLUSTER_STRATEGY", "rounds"),
                       ("PT_CLUSTER_WINDOW", "2"),
                       ("PT_CLUSTER_MAX_ROUNDS", "3"),
                       ("PT_CLUSTER_SORT", "0")):
        monkeypatch.setenv(var, value)
    assert trenderer.cluster_options() == (128, dict(
        ray_tile=256, window=2, max_rounds=3, sort_rays=False,
        strategy="rounds"))
    query = trenderer.make_query(ts, cfg)
    rounds = query.closest
    assert rounds.handles_dead and rounds.query_shadow
    assert not hasattr(rounds, "query_sorted")
    o = torch.tensor([[0.0, 0.0, 5.0], [0.0, 0.0, 5.0]])
    d = torch.tensor([[0.0, 0.0, -1.0], [0.0, 0.0, 0.0]])
    idx, t, valid = rounds(o, d)
    assert idx.shape == t.shape == valid.shape == (2,) and not valid[1]
    monkeypatch.setenv("PT_CLUSTER_STRATEGY", "march")
    assert not hasattr(trenderer.make_query(ts, cfg).closest, "query_sorted")
    monkeypatch.setenv("PT_CLUSTER_STRATEGY", "octree")
    with pytest.raises(ValueError, match="unknown cluster strategy"):
        trenderer.make_query(ts, cfg)


@pytest.mark.parametrize("env", [
    {}, {"PT_CLUSTER_RAY_TILE": "256"}, {"PT_CLUSTER_RAYTILE": "256"},
    {"PT_CLUSTER_RAY_TILE": "512", "PT_CLUSTER_RAYTILE": "256"}],
    ids=["neither", "RAY_TILE", "RAYTILE", "both"])
def test_ray_tile_spellings_match_reference(env, monkeypatch):
    """Both spellings of the chunk-width knob: the renderer reads
    ``PT_CLUSTER_RAY_TILE`` and the factory ``PT_CLUSTER_RAYTILE``, which
    wins; the port's march chunks as the reference's
    (``renderer._make_closest``) does."""
    from pathtracer_tpu.render.renderer import _make_closest
    for var in ("PT_CLUSTER_K", "PT_CLUSTER_STRATEGY", "PT_CLUSTER_RAY_TILE",
                "PT_CLUSTER_RAYTILE", "PT_CLUSTER_SORT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    js, _ = jworlds.get_world("test")
    ts, _ = tworlds.get_world("test", device="cpu")
    ref, _ = _make_closest(js, None, T_MIN, accel="cluster")
    port = trenderer.make_query(ts, TConfig(accel="cluster")).closest
    assert port.ray_tile == ref.ray_tile
    assert port.ray_tile == int(env.get("PT_CLUSTER_RAYTILE")
                                or env.get("PT_CLUSTER_RAY_TILE")
                                or tsweep.DEF_RAY_TILE)


def test_window_wrapper_dispatch(bunny):
    """CPU tensors take the plain twin (no kernel launch is counted); other
    devices raise instead of falling back."""
    tct = bunny["tct"]
    C_tot = tct.cols.shape[0]
    o, d = (torch.from_numpy(x) for x in _camera_rays(bunny["jc"], n=256))
    args = (ray_features(o, d), vec.dot(d, d),
            torch.tensor([0, 3], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), tct.cols,
            tct.is_sphere.view(C_tot, K), tct.ranges)
    before = tsweep.WINDOW_LAUNCHES
    got = tsweep.window_sweep(*args, K, 4, T_MIN, 128)
    ref = tsweep.window_reference(*args, K, 4, T_MIN, 128)
    assert tsweep.WINDOW_LAUNCHES == before
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert (got[1][128:] == -1).all() and (got[1][:128] >= 0).any()
    meta = [x.to("meta") for x in args]
    with pytest.raises(ValueError, match="no window sweep"):
        tsweep.window_sweep(*meta, K, 4, T_MIN, 128)


@pytest.mark.parametrize("first,raises", [(-3, True), (-1 - 30, True),
                                          (-4, False)])
def test_window_twin_rejects_windows_off_the_tables(bunny, first, raises):
    """W = 4 from start C_tot + ``first`` on the swept chunk: past the last
    cluster or before the first it raises ValueError; the last legal start
    sweeps. The skipped chunk's start (C_tot) is never checked."""
    tct = bunny["tct"]
    C_tot = tct.cols.shape[0]
    assert C_tot == 30
    o, d = (torch.from_numpy(x) for x in _camera_rays(bunny["jc"], n=256))
    args = (ray_features(o, d), vec.dot(d, d),
            torch.tensor([C_tot + first, C_tot], dtype=torch.int32),
            torch.tensor([0, 1], dtype=torch.int32), tct.cols,
            tct.is_sphere.view(C_tot, K), tct.ranges)
    if raises:
        with pytest.raises(ValueError, match="leaves the 30 clusters"):
            tsweep.window_sweep(*args, K, 4, T_MIN, 128)
    else:
        t, b = tsweep.window_sweep(*args, K, 4, T_MIN, 128)
        assert (b[128:] == -1).all() and (b[:128] >= 0).any()


def test_rounds_render_matches_jax(monkeypatch):
    """A bunny render through the rounds route in both packages, at the
    render tolerance of tests/test_torch_render.py (>= 99% of channels
    within 1e-4, mean |diff| <= 1e-3). The reference keys its jitted
    renderer on the PT_CLUSTER_* variables, so the render below is traced
    anew; a spy on its ``cluster_closest`` proves the trace took the
    rounds route (a reused march trace would never call it)."""
    monkeypatch.setenv("PT_CLUSTER_STRATEGY", "rounds")
    monkeypatch.setenv("PT_CLUSTER_K", "128")
    calls = {"jax": 0, "port": 0}

    def spy(mod, name):
        inner = mod.cluster_closest

        def wrapped(*a, **k):
            calls[name] += 1
            return inner(*a, **k)
        monkeypatch.setattr(mod, "cluster_closest", wrapped)
    spy(jsweep, "jax")
    spy(tsweep, "port")
    js, jc = jworlds.get_world("bunny")
    ts, tc = tworlds.get_world("bunny", device="cpu")
    kw = dict(width=32, height=16, spp=2, max_depth=3, ray_chunk=512,
              accel="cluster", scene="bunny", seed=0)
    ref = np.asarray(jrender(js, jc, JConfig(**kw)))
    img = trenderer.render_image(ts, tc, TConfig(**kw), device="cpu").numpy()
    assert calls["jax"] > 0 and calls["port"] > 0
    assert np.isfinite(img).all() and img.mean() > 0.3
    diff = np.abs(img - ref)
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3
