"""The march's cull plans against the JAX reference: the two-level cull
("cull2": per-ray cull, bin key and stop gate on superclusters, members
ordered per chunk by the interval cull of the chunk's ray bundle) and the
flat supercluster cull (each supercluster expands to its members), each
through the port's plain twin against the JAX ``cluster_march`` (Pallas
interpret mode) under the same settings.

Tolerances, on the bunny at K=64:
- against the reference, those of tests/test_torch_march.py: valid flags
  and winners agree on >= 99.9% of lanes, a differing winner is a near tie
  (|dt| <= 1e-5 |t|), t within rtol 1e-5 (plus atol 2e-4 on sphere
  winners, where t cancels for the r=1000 ground sphere);
- against the port's own flat march: valid flags equal and t within rtol
  1e-6 on every hit (the reference's own bar, tests/test_cluster.py): the
  plan changes only which clusters a chunk marches and in what order, so
  winners may differ only at bit-equal t ties.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_march import N, T_MIN, _bounce_rays, _camera_rays, _check_pair

from pathtracer_tpu.ops import cluster_sweep as jsweep
from pathtracer_tpu.ops import clusters as jclusters
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.ops import cluster_sweep as tsweep
from pathtracer_tpu_torch.ops import clusters as tclusters
from pathtracer_tpu_torch.render import renderer as trenderer

torch.set_num_threads(1)

KNOBS = ("PT_CLUSTER_CULL2", "PT_CLUSTER_SUPER", "PT_CLUSTER_CULL2_C",
         "PT_CLUSTER_RAY_TILE", "PT_CLUSTER_RAYTILE")
# (name, environment of both packages, the port's resolved plan); the
# bunny has 57 regular clusters, under the automatic 2,048
SETTINGS = [
    ("cull2-sup4", {"PT_CLUSTER_CULL2": "1", "PT_CLUSTER_SUPER": "4"},
     (True, 4)),
    ("cull2-sup8", {"PT_CLUSTER_CULL2": "1", "PT_CLUSTER_SUPER": "8"},
     (True, 8)),
    ("cull2-auto-sup", {"PT_CLUSTER_CULL2": "1"}, (True, 1)),
    ("flat-sup4", {"PT_CLUSTER_SUPER": "4"}, (False, 4)),
    ("flat-sup8", {"PT_CLUSTER_SUPER": "8"}, (False, 8)),
    ("flat-sup64", {"PT_CLUSTER_SUPER": "64"}, (False, 64)),
]


def _clear(monkeypatch):
    for var in KNOBS:
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def bunny():
    js, jc = jworlds.get_world("bunny")
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    tct = tclusters.build_cluster_tables(ts, K=64)
    # 512 camera rays and 512 incoherent bounce-like rays (origins above
    # the ground, random directions), from numpy seeds
    waves = {"camera": _camera_rays(jc), "bounce": _bounce_rays()}
    flat = {name: [x.numpy() for x in tsweep.cluster_march(
        tct, torch.from_numpy(o), torch.from_numpy(d), T_MIN, cull2=False,
        sup=1)] for name, (o, d) in waves.items()}
    return dict(jct=jclusters.build_cluster_tables(js, K=64), tct=tct,
                waves=waves, flat=flat)


def _check_against_flat(got, flat):
    """Valid flags equal and t within rtol 1e-6 of the flat march."""
    idx, t, valid = got
    np.testing.assert_array_equal(valid, flat[2])
    np.testing.assert_allclose(t[flat[2]], flat[1][flat[2]], rtol=1e-6)
    assert (idx == flat[0])[flat[2]].mean() >= 0.999


@pytest.mark.parametrize("wave", ["camera", "bounce"])
@pytest.mark.parametrize("name,env,plan", SETTINGS,
                         ids=[s[0] for s in SETTINGS])
def test_cull_plan_matches_jax(bunny, name, env, plan, wave, monkeypatch):
    """The reference's knobs, read by both packages (the port's through
    ``cluster_options`` and the factory), give the same plan and the same
    hits."""
    _clear(monkeypatch)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    o, d = bunny["waves"][wave]
    _, kw = trenderer.cluster_options()
    closest = tsweep.make_cluster_closest_hit(bunny["tct"], T_MIN, **kw)
    assert closest.cull_plan == plan
    got = [x.numpy() for x in closest(torch.from_numpy(o),
                                      torch.from_numpy(d))]
    ref = [np.asarray(x) for x in jsweep.cluster_march(
        bunny["jct"], jnp.asarray(o), jnp.asarray(d), T_MIN)]
    _check_pair(*got, *ref, bunny["tct"].scene.prim_type.numpy())
    _check_against_flat(got, bunny["flat"][wave])
    assert got[2].sum() > N // 4        # the wavefront really hits things


@pytest.mark.parametrize("sort_rays", [True, False])
def test_cull2_incoherent_dead_and_shadow(sort_rays, monkeypatch):
    """cull2 under the adversarial wavefront of tests/test_cluster.py:
    random origins and directions (direction intervals span zero, so the
    bundle cull must stay conservative), every fifth lane dead (left out
    of the bundle hulls), and the unsorted t_max = 1 shadow query (the
    gate clamp), in both packages at CULL2=1, SUPER=4."""
    js, _ = jworlds.random_world(seed=11)
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    rng = np.random.default_rng(4)
    o = rng.uniform(-8.0, 8.0, (N, 3)).astype(np.float32)
    d = rng.standard_normal((N, 3)).astype(np.float32)
    dead = np.arange(N) % 5 == 0
    d[dead] = 0.0
    tct = tclusters.build_cluster_tables(ts)
    kw = dict(t_max=1.0, sort_rays=False) if not sort_rays else {}
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    flat = [x.numpy() for x in tsweep.cluster_march(
        tct, to, td, T_MIN, cull2=False, sup=1, **kw)]
    got = [x.numpy() for x in tsweep.cluster_march(
        tct, to, td, T_MIN, cull2=True, sup=4, **kw)]
    _clear(monkeypatch)
    monkeypatch.setenv("PT_CLUSTER_CULL2", "1")
    monkeypatch.setenv("PT_CLUSTER_SUPER", "4")
    ref = [np.asarray(x) for x in jsweep.cluster_march(
        jclusters.build_cluster_tables(js), jnp.asarray(o), jnp.asarray(d),
        T_MIN, **kw)]
    _check_against_flat(got, flat)
    _check_pair(*got, *ref, tct.scene.prim_type.numpy())
    assert not got[2][dead].any()
    assert got[2].sum() > (N // 8 if sort_rays else 16)
