"""The draws wrapper (``ops/uniforms``) on the CPU against ``jax.random``
and the JAX integrator.

- Draws: ``uniform_by_ray`` is bit-equal to the reference's
  ``integrator._uniform_by_ray`` for m in {1, 3, 6}, three keys, a permuted
  wavefront and ids up to 2^29 - 1 (the sorted wavefront's limit);
  ``uniform`` is bit-equal to ``jax.random.uniform``.
- The integrator's scatter draws equal the reference's on a small
  wavefront (both integrators spied on, op by op).
- Every draw of a render goes through the wrapper: the camera's flat
  draws and the integrator's scatter, NEE and Russian-roulette draws.
- On the CPU the wrapper takes the plain twins and launches nothing; it
  refuses what the kernel does not take.

The kernel against the twins on the card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import materials as jmaterials
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.ops import uniforms
from pathtracer_tpu_torch.render import integrator as tintegrator
from pathtracer_tpu_torch.render.renderer import make_renderer
from pathtracer_tpu_torch.scene import materials as tmaterials
from pathtracer_tpu_torch.scene import worlds as tworlds

torch.set_num_threads(1)

# the reference's other streams; the port draws the default one only
JAX_STREAM_VARS = ("PT_RNG_FAST", "PT_RNG_HASH", "PT_RNG_STUB")


@pytest.fixture(autouse=True)
def default_stream(monkeypatch):
    for var in JAX_STREAM_VARS:
        monkeypatch.delenv(var, raising=False)


def _words(key):
    return tuple(int(x) for x in np.asarray(key))


def _rids():
    """A permuted arange(4096) and ids near 2^29 - 1 (int32)."""
    rng = np.random.default_rng(7)
    top = (1 << 29) - 1 - np.arange(64)
    return np.concatenate([rng.permutation(4096), top]).astype(np.int32)


def _keys():
    base = jax.random.PRNGKey(2024)
    return [base, jax.random.fold_in(base, 3),
            jax.random.fold_in(jax.random.PRNGKey(7), 1 << 20)]


@pytest.mark.parametrize("m", [1, 3, 6])
def test_draws_match_jax(m):
    rid = _rids()
    before = uniforms.UNIFORMS_LAUNCHES
    for jk in _keys():
        ref = np.asarray(jintegrator._uniform_by_ray(jk, jnp.asarray(rid), m))
        tk = _words(jk)
        got = uniforms.uniform_by_ray(tk, torch.from_numpy(rid), m)
        assert got.dtype == torch.float32 and got.shape == (rid.size, m)
        np.testing.assert_array_equal(got.numpy(), ref)
        # an int64 rid gives the same draws
        np.testing.assert_array_equal(uniforms.uniform_by_ray(
            tk, torch.from_numpy(rid.astype(np.int64)), m).numpy(), ref)
    assert uniforms.UNIFORMS_LAUNCHES == before


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 4096), (3, 5, 4)])
def test_flat_draws_match_jax(shape):
    jk = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2), 11), 4)[2]
    ref = np.asarray(jax.random.uniform(jk, shape, jnp.float32))
    before = uniforms.UNIFORMS_LAUNCHES
    got = uniforms.uniform(_words(jk), shape, "cpu")
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_array_equal(got.numpy(), ref)
    assert uniforms.UNIFORMS_LAUNCHES == before


def test_wrapper_refuses_what_the_kernel_does_not_take():
    rid = torch.arange(64, dtype=torch.int32)
    with pytest.raises(ValueError):
        uniforms.uniform_by_ray((1, 2), rid, 0)
    with pytest.raises(ValueError):
        uniforms.uniform_by_ray((1, 2), rid.view(8, 8), 3)
    with pytest.raises(ValueError):
        uniforms.uniform_by_ray((1, 2), rid.to("meta"), 3)
    with pytest.raises(ValueError):
        uniforms.uniform((1, 2), (4,), "meta")
    assert uniforms.uniform_by_ray((1, 2), rid[:0], 3).shape == (0, 3)


def _spy(module, name, seen):
    orig = getattr(module, name)

    def spy(scene, rec, d, u):
        seen.append(np.asarray(u).copy() if not torch.is_tensor(u)
                    else u.numpy().copy())
        return orig(scene, rec, d, u)
    return spy


def test_integrator_scatter_draws_match_jax(monkeypatch):
    """The uniforms each bounce hands ``materials.scatter`` in both
    integrators, on 64 camera rays of the test world over 2 bounces: the
    bounce keys and the draws, bit for bit."""
    js, jc = jworlds.get_world("test")
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    rng = np.random.default_rng(5)
    o = np.tile(np.asarray(jc.position, np.float32), (64, 1))
    d = (np.asarray(jc.lower_left, np.float32)
         + rng.uniform(0, 1, (64, 1)).astype(np.float32)
         * np.asarray(jc.horizontal, np.float32)
         + rng.uniform(0, 1, (64, 1)).astype(np.float32)
         * np.asarray(jc.vertical, np.float32) - o)
    key = jax.random.PRNGKey(9)
    j_seen, t_seen = [], []
    monkeypatch.setattr(jmaterials, "scatter",
                        _spy(jmaterials, "scatter", j_seen))
    monkeypatch.setattr(tmaterials, "scatter",
                        _spy(tmaterials, "scatter", t_seen))
    with jax.disable_jit():
        jintegrator.trace(
            js, jnp.asarray(o), jnp.asarray(d), jnp.zeros(64), key, 2,
            lambda oo, dd: jintersect.brute_force_closest(
                js, oo, dd, jnp.float32(1e-3), jintersect.BIG_T))
    tintegrator.trace(ts, torch.from_numpy(o), torch.from_numpy(d),
                      _words(key), 2,
                      tintegrator.make_brute_closest_hit(ts, 1e-3))
    assert len(j_seen) == len(t_seen) == 2
    for j, t in zip(j_seen, t_seen):
        np.testing.assert_array_equal(t, j)


def test_render_draws_through_the_wrapper(monkeypatch):
    """Cornell with NEE and Russian roulette from bounce 1, 2 chunks x 2
    spp: each chunk-sample draws its 3 camera sets flat, and each bounce
    its scatter (m = 6), NEE (m = 3) and roulette (m = 1) sets by ray,
    all through the wrapper; the image is the one drawn without the spy."""
    cfg = RenderConfig(width=16, height=8, spp=2, max_depth=3, ray_chunk=64,
                       accel="pallas", scene="cornell", sky=False, nee=True,
                       rr=True, rr_depth=1, seed=3)
    scene, cam = tworlds.get_world("cornell", device="cpu")
    ref = make_renderer(cfg, "cpu")(scene, cam).numpy()
    calls = []
    flat, by_ray = uniforms.uniform, uniforms.uniform_by_ray

    def flat_spy(key, shape, device):
        calls.append(("flat", tuple(shape)))
        return flat(key, shape, device)

    def by_ray_spy(key, rid, m):
        calls.append(("by_ray", (rid.shape[0], m)))
        return by_ray(key, rid, m)
    monkeypatch.setattr(uniforms, "uniform", flat_spy)
    monkeypatch.setattr(uniforms, "uniform_by_ray", by_ray_spy)
    img = make_renderer(cfg, "cpu")(scene, cam).numpy()
    np.testing.assert_array_equal(img, ref)
    n = cfg.spp * 2
    assert calls.count(("flat", (2, 64))) == 2 * n
    assert calls.count(("flat", (64,))) == n
    assert {c for c in calls if c[0] == "by_ray"} == {
        ("by_ray", (64, 6)), ("by_ray", (64, 3)), ("by_ray", (64, 1))}
    assert n <= calls.count(("by_ray", (64, 6))) <= cfg.max_depth * n
