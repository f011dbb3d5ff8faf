"""The port's samplers, optics, materials and sky against the JAX
reference on the same inputs (rtol 1e-5: sin/cos/pow differ by an ulp
between the two libraries)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pathtracer_tpu.core import optics as joptics
from pathtracer_tpu.core import rays as jrays
from pathtracer_tpu.core import sampling as jsampling
from pathtracer_tpu.render import integrator as jintegrator
from pathtracer_tpu.scene import materials as jmaterials
from pathtracer_tpu.scene import worlds as jworlds
from pathtracer_tpu_torch.convert import scene_from_jax_arrays
from pathtracer_tpu_torch.core import optics as toptics
from pathtracer_tpu_torch.core import rays as trays
from pathtracer_tpu_torch.core import sampling as tsampling
from pathtracer_tpu_torch.render import integrator as tintegrator
from pathtracer_tpu_torch.scene import materials as tmaterials

torch.set_num_threads(1)

N = 1000
TOL = dict(rtol=1e-5, atol=1e-6)


def _u(k, seed=0):
    return np.random.default_rng(seed).random((k, N), dtype=np.float32)


def _unit(seed):
    v = np.random.default_rng(seed).standard_normal((N, 3)).astype(
        np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.mark.parametrize("fn,k", [("uniform_on_sphere", 2),
                                  ("uniform_in_sphere", 3),
                                  ("uniform_in_disk", 2)])
def test_samplers_match(fn, k):
    u = _u(k)
    a = np.asarray(getattr(jsampling, fn)(*(jnp.asarray(x) for x in u)))
    b = getattr(tsampling, fn)(*(torch.from_numpy(x) for x in u)).numpy()
    np.testing.assert_allclose(b, a, **TOL)
    lo, hi = np.float32(0.0), np.float32(1.0)
    np.testing.assert_array_equal(
        tsampling.uniform_in_range(torch.tensor(lo), torch.tensor(hi),
                                   torch.from_numpy(u[0])).numpy(),
        np.asarray(jsampling.uniform_in_range(lo, hi, jnp.asarray(u[0]))))


def test_optics_match():
    v, n = _unit(1), _unit(2)
    n = np.where((v * n).sum(1, keepdims=True) > 0, -n, n)
    eta = np.where(_u(1)[0] > 0.5, 1 / 1.5, 1.5).astype(np.float32)
    jv, jn, tv, tn = (jnp.asarray(v), jnp.asarray(n), torch.from_numpy(v),
                      torch.from_numpy(n))
    np.testing.assert_allclose(toptics.reflect(tv, tn).numpy(),
                               np.asarray(joptics.reflect(jv, jn)), **TOL)
    np.testing.assert_allclose(
        toptics.refract(tv, tn, torch.from_numpy(eta)).numpy(),
        np.asarray(joptics.refract(jv, jn, jnp.asarray(eta))), **TOL)
    cos = _u(1, seed=3)[0]
    np.testing.assert_allclose(
        toptics.reflectance(torch.from_numpy(cos), 1.5).numpy(),
        np.asarray(joptics.reflectance(jnp.asarray(cos), 1.5)), **TOL)


def test_sky_color_matches():
    d = _unit(4) * 3.0
    np.testing.assert_allclose(
        tintegrator.sky_color(torch.from_numpy(d)).numpy(),
        np.asarray(jintegrator.sky_color(jnp.asarray(d))), **TOL)


def test_scatter_matches():
    """Every material of the bunny world, front and back faces."""
    js, _ = jworlds.get_world("bunny")
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    rng = np.random.default_rng(5)
    d = _unit(6) * 2.0
    normal = _unit(7)
    normal = np.where((d * normal).sum(1, keepdims=True) > 0, -normal,
                      normal).astype(np.float32)
    mat = rng.integers(0, js.num_materials, N).astype(np.int32)
    front = rng.random(N) < 0.5
    p = rng.standard_normal((N, 3)).astype(np.float32)
    uniforms = rng.random((N, 6), dtype=np.float32)
    zero = np.zeros(N, np.float32)
    jrec = jrays.HitRecords(
        p=jnp.asarray(p), normal=jnp.asarray(normal), mat_id=jnp.asarray(mat),
        t=jnp.asarray(zero), uv=jnp.zeros((N, 2)), front_face=jnp.asarray(front),
        valid=jnp.ones(N, bool), prim_id=jnp.zeros(N, jnp.int32),
        prim_area=jnp.asarray(zero))
    trec = trays.HitRecords(
        p=torch.from_numpy(p), normal=torch.from_numpy(normal),
        mat_id=torch.from_numpy(mat).long(), t=torch.from_numpy(zero),
        uv=torch.zeros((N, 2)), front_face=torch.from_numpy(front),
        valid=torch.ones(N, dtype=torch.bool),
        prim_id=torch.zeros(N, dtype=torch.int64),
        prim_area=torch.from_numpy(zero))
    a = jmaterials.scatter(js, jrec, jnp.asarray(d), jnp.asarray(uniforms))
    b = tmaterials.scatter(ts, trec, torch.from_numpy(d),
                           torch.from_numpy(uniforms))
    for f in ("ok", "is_emissive", "is_diffuse", "is_specular", "is_glossy"):
        np.testing.assert_array_equal(getattr(b, f).numpy(),
                                      np.asarray(getattr(a, f)), err_msg=f)
    for f in ("direction", "attenuation", "emitted", "glossy_r", "fuzz"):
        np.testing.assert_allclose(getattr(b, f).numpy(),
                                   np.asarray(getattr(a, f)), rtol=1e-5,
                                   atol=1e-5, err_msg=f)
