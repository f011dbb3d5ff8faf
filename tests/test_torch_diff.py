"""The port's differentiable pass (``render/diff.py``) against the JAX
reference's, and against finite differences.

Scenes and CFG are ``tests/test_diff.py``'s: a lambertian sphere (and an
emissive one above it), 8x8, 2 spp, depth 3, brute force, sky. Each JAX
reference is computed once for the module.

Tolerances: images atol 1e-5; gradients rtol 1e-4, atol 1e-6 against
``jax.grad`` (the random streams are bit-equal, and the shading ops differ
by an ulp between the libraries); the fit's first three losses rtol 1e-4
(``torch.optim.Adam`` and ``optax.adam`` compute the same update in a
different order); finite differences as in ``tests/test_diff.py``. The
routes (pallas, cluster march, cluster rounds, tensor) against brute force
within 1e-6: the winners are the same, and the shading is.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.core.camera import make_camera as jmake_camera
from pathtracer_tpu.ops import intersect as jintersect
from pathtracer_tpu.render import diff as jdiff
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu.scene.scene import SceneBuilder as JBuilder
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.convert import params_from_jax, scene_from_jax_arrays
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core.camera import make_camera
from pathtracer_tpu_torch.ops import intersect as tintersect
from pathtracer_tpu_torch.render import diff as tdiff
from pathtracer_tpu_torch.render import renderer as trenderer

torch.set_num_threads(1)

KW = dict(width=8, height=8, spp=2, max_depth=3, accel="brute", ray_chunk=64,
          scene="test", sky=True)
CFG = TConfig(**KW)
FIELDS = ("albedo", "emit", "v0")
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)


def _jax_sphere_scene(emissive):
    b = JBuilder()
    m = b.add_lambertian((0.6, 0.3, 0.2))
    b.add_sphere((0, 0, -3), 1.0, m)
    if emissive:
        e = b.add_emissive((4.0, 3.0, 2.0))
        b.add_sphere((0, 2.2, -3), 0.7, e)
    cam = jmake_camera((0, 0, 1), (0, 0, -3), 60, 1.0, aperture=0,
                       focus_dist=4, time0=0.0, time1=0.0)
    return b.build(), cam


def _port(js):
    ts = scene_from_jax_arrays({f: np.asarray(getattr(js, f))
                                for f in js._fields}, device="cpu")
    tc = make_camera((0, 0, 1), (0, 0, -3), 60, 1.0, aperture=0,
                     focus_dist=4, time0=0.0, time1=0.0, device="cpu")
    return ts, tc


def _grid(cfg=CFG):
    return trenderer.padded_pixel_grid(cfg, 64, "cpu")


def _port_loss_and_grads(ts, tc, cfg=CFG, fields=FIELDS):
    """(image, loss, {field: grad}) of the port, loss = mean(img^2)."""
    params = tdiff.scene_params(ts, fields)
    rows, cols = _grid(cfg)
    img = tdiff.render_linear(tdiff.apply_params(ts, params), tc,
                              prng.PRNGKey(0), rows, cols, cfg, cfg.spp)
    loss = torch.mean(img ** 2)
    loss.backward()
    return (img.detach().numpy(), float(loss.detach()),
            {f: p.grad.numpy() for f, p in params.items()})


@pytest.fixture(scope="module")
def ref():
    """The JAX side, once: per scene the image at sample offsets 0 and 3
    and jax.grad of mean(img^2); the first three losses of a frozen-noise
    fit towards a brighter albedo, and its target."""
    jcfg = JConfig(**KW)
    rows, cols = jrenderer.padded_pixel_grid(jcfg, 64)
    key = jax.random.PRNGKey(0)
    out = {}
    for emissive in (False, True):
        js, jc = _jax_sphere_scene(emissive)

        def loss(p, js=js, jc=jc):
            img = jdiff.render_linear(jdiff.apply_params(js, p), None, jc,
                                      key, rows, cols, jcfg, jcfg.spp)
            return jnp.mean(img ** 2), img
        (_, img0), grads = jax.value_and_grad(loss, has_aux=True)(
            jdiff.scene_params(js, FIELDS))
        img3 = jdiff.render_linear(js, None, jc, key, rows, cols, jcfg,
                                   jcfg.spp, sample_offset=3)
        out[emissive] = dict(js=js, img={0: np.asarray(img0),
                                         3: np.asarray(img3)},
                             grads={f: np.asarray(g)
                                    for f, g in grads.items()})
    js, jc = _jax_sphere_scene(False)
    target_scene = js._replace(albedo=jnp.array([[0.9, 0.1, 0.5]],
                                                jnp.float32))
    target = jdiff.render_linear(target_scene, None, jc, key, rows, cols,
                                 jcfg, jcfg.spp)[:jcfg.num_pixels]
    _, history = jdiff.fit(js, None, jc, target, jcfg, steps=3, lr=0.05,
                           seed=0, resample=False)
    out["fit"] = dict(target=np.asarray(target), history=history)
    return out


@pytest.mark.parametrize("emissive", [False, True])
@pytest.mark.parametrize("offset", [0, 3])
def test_render_linear_matches_jax(ref, emissive, offset):
    ts, tc = _port(ref[emissive]["js"])
    rows, cols = _grid()
    img = tdiff.render_linear(ts, tc, prng.PRNGKey(0), rows, cols, CFG,
                              CFG.spp, sample_offset=offset)
    np.testing.assert_allclose(img.numpy(), ref[emissive]["img"][offset],
                               rtol=0, atol=1e-5)
    if offset:   # the offset moves the samples
        assert not np.allclose(ref[emissive]["img"][0],
                               ref[emissive]["img"][offset])


@pytest.mark.parametrize("emissive", [False, True])
def test_gradients_match_jax(ref, emissive):
    """albedo, emit (the emissive scene) and v0 (sphere centers) against
    jax.grad; every gradient finite, and the ones the scene exercises
    nonzero."""
    ts, tc = _port(ref[emissive]["js"])
    _, _, grads = _port_loss_and_grads(ts, tc)
    for f in FIELDS:
        assert np.isfinite(grads[f]).all(), f
        np.testing.assert_allclose(grads[f], ref[emissive]["grads"][f],
                                   err_msg=f, **GRAD_TOL)
    assert np.abs(grads["albedo"][0]).min() > 0
    assert np.abs(grads["v0"][0]).sum() > 0
    if emissive:
        assert np.abs(grads["emit"][1]).min() > 0


def _port_loss(ts, tc, fields):
    rows, cols = _grid()
    key = prng.PRNGKey(0)

    def loss(params):
        img = tdiff.render_linear(tdiff.apply_params(ts, params), tc, key,
                                  rows, cols, CFG, CFG.spp)
        return torch.mean(img ** 2)
    return loss, tdiff.scene_params(ts, fields)


@pytest.mark.parametrize("emissive,field,index", [
    (False, "albedo", (0, 0)),
    (False, "albedo", (0, 2)),
    (True, "emit", (1, 1)),
])
def test_grad_matches_finite_difference(ref, emissive, field, index):
    """The port alone: d(loss)/d(albedo|emission) equals the central
    finite difference (tests/test_diff.py's cases and tolerances)."""
    ts, tc = _port(ref[emissive]["js"])
    loss, params = _port_loss(ts, tc, ("albedo", "emit"))
    loss(params).backward()
    g = float(params[field].grad[index])

    eps = 1e-2

    def perturbed(sign):
        with torch.no_grad():
            p = {f: x.detach().clone() for f, x in params.items()}
            p[field][index] += sign * eps
            return float(loss(p))
    fd = (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=5e-3, atol=1e-6)


def test_vertex_gradient_flows(ref):
    """Moving the sphere center changes the image through the hit
    re-evaluation; the AD gradient tracks central differences (loosely:
    the difference also sees silhouette shifts that detached visibility
    ignores)."""
    ts, tc = _port(ref[False]["js"])
    loss, params = _port_loss(ts, tc, ("v0",))
    loss(params).backward()
    g = params["v0"].grad.numpy()
    assert np.all(np.isfinite(g)) and np.abs(g).sum() > 0.0

    eps = 1e-3
    for axis in (0, 1):
        def perturbed(sign):
            with torch.no_grad():
                v0 = params["v0"].detach().clone()
                v0[0, axis] += sign * eps
                return float(loss({"v0": v0}))
        fd = (perturbed(+1.0) - perturbed(-1.0)) / (2 * eps)
        np.testing.assert_allclose(g[0, axis], fd, rtol=0.05, atol=1e-4)


def test_fit_matches_jax_and_reduces_loss(ref):
    """A frozen-noise fit towards a brighter albedo: the first three
    losses equal the reference's fit, and 40 steps cut the loss tenfold
    and recover the albedo."""
    ts, tc = _port(ref[False]["js"])
    target = ref["fit"]["target"]
    _, history = tdiff.fit(ts, tc, target, CFG, steps=3, lr=0.05, seed=0,
                           resample=False)
    np.testing.assert_allclose(history, ref["fit"]["history"], rtol=1e-4)
    params, history = tdiff.fit(ts, tc, target, CFG, steps=40, lr=0.05,
                                seed=0, resample=False)
    assert history[-1] < history[0] * 0.1, history
    got = params["albedo"][0].numpy()
    assert abs(got[0] - 0.9) < 0.1 and abs(got[2] - 0.5) < 0.1, got
    assert not params["albedo"].requires_grad
    np.testing.assert_array_equal(ts.albedo.numpy(),
                                  np.asarray(ref[False]["js"].albedo))


@pytest.mark.parametrize("accel,env", [
    ("pallas", {}), ("tensor", {}), ("cluster", {}),
    ("cluster", {"PT_CLUSTER_STRATEGY": "rounds", "PT_CLUSTER_K": "128"})])
@pytest.mark.parametrize("nee", [False, True])
def test_routes_match_brute(ref, accel, env, nee, monkeypatch):
    """The differentiable render on the dense-sweep twin, the tensor route
    and the cluster twins (march; rounds), images and gradients, equal to
    brute force; with NEE on the emissive scene the shadow queries take
    the same routes."""
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    ts, tc = _port(ref[nee]["js"])
    cfg = CFG.replace(nee=nee, sky=not nee)
    img_b, _, grads_b = _port_loss_and_grads(ts, tc, cfg)
    img, _, grads = _port_loss_and_grads(ts, tc, cfg.replace(accel=accel))
    np.testing.assert_allclose(img, img_b, rtol=0, atol=1e-6)
    for f in FIELDS:
        assert np.isfinite(grads[f]).all(), f
        np.testing.assert_allclose(grads[f], grads_b[f], rtol=1e-6,
                                   atol=1e-7, err_msg=f)
    assert np.abs(grads["v0"]).sum() > 0


def test_query_with_autograd_history_raises(ref):
    """Kernel-facing tables built from a scene that requires grad are
    refused: visibility must be detached."""
    ts, tc = _port(ref[False]["js"])
    params = tdiff.scene_params(ts, ("v0",))
    live = tdiff.apply_params(ts, params)
    query = trenderer.make_query(live, CFG.replace(accel="pallas"))
    assert query.scene.v0 is params["v0"]
    from pathtracer_tpu_torch.ops.pallas_sweep import make_pallas_closest_hit
    bad = trenderer.Query(make_pallas_closest_hit(live, CFG.t_min),
                          query.scene)
    rows, cols = _grid()
    with pytest.raises(RuntimeError, match="autograd history"):
        trenderer.render_sum(live, tc, prng.PRNGKey(0), rows, cols, CFG, 1,
                             bad, differentiable=True)


def test_sharded_step_is_not_ported(ref):
    """The sharded train step is ported (``tests/test_torch_parallel.py``
    holds it against the reference): on a mesh of one CPU slot it is the
    unsharded step, loss and gradients to the bit."""
    from pathtracer_tpu_torch.parallel import make_mesh
    ts, tc = _port(ref[False]["js"])
    target = torch.full((CFG.num_pixels, 3), 0.25)
    runs = []
    for mesh in (None, make_mesh(["cpu"])):
        params = tdiff.scene_params(ts)
        opt = torch.optim.SGD(list(params.values()), lr=0.1)
        loss = tdiff.make_train_step(CFG, opt, mesh=mesh)(params, ts, tc,
                                                         target, 3)
        runs.append((loss, {f: p.grad for f, p in params.items()}))
    assert torch.equal(runs[0][0], runs[1][0])
    for f in runs[0][1]:
        assert torch.equal(runs[0][1][f], runs[1][1][f]), f


def test_train_step_matches_jax_sgd(ref):
    """One train step with SGD: the loss and the updated albedo equal the
    reference's jitted step (optax.sgd)."""
    js = ref[False]["js"]
    jcfg = JConfig(**KW)
    _, jc = _jax_sphere_scene(False)
    target = np.zeros((CFG.num_pixels, 3), np.float32)
    opt = optax.sgd(0.1)
    jparams = jdiff.scene_params(js)
    jp, _, jl = jdiff.make_train_step(jcfg, opt)(
        jparams, opt.init(jparams), js, None, jc, jnp.asarray(target), 5)
    ts, tc = _port(js)
    params = params_from_jax({f: np.asarray(v) for f, v in jparams.items()},
                             device="cpu")
    step = tdiff.make_train_step(CFG, torch.optim.SGD(
        list(params.values()), lr=0.1))
    loss = step(params, ts, tc, torch.from_numpy(target), 5)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    np.testing.assert_allclose(params["albedo"].detach().numpy(),
                               np.asarray(jp["albedo"]), rtol=1e-5,
                               atol=1e-7)


def test_params_from_jax_round_trip(ref):
    js = ref[True]["js"]
    arrays = {f: np.asarray(getattr(js, f)) for f in FIELDS}
    params = params_from_jax(arrays, device="cpu")
    for f, a in arrays.items():
        p = params[f]
        assert p.is_leaf and p.requires_grad and p.dtype == torch.float32
        np.testing.assert_array_equal(p.detach().numpy(), a)
    with pytest.raises(KeyError):
        params_from_jax({"weights": arrays["v0"]}, device="cpu")


def test_pole_hit_v0_gradient_matches_jax():
    """A ray straight down onto a sphere's top hits its pole, where
    d acos(y)/dy is infinite. In the render, uv reaches the loss only
    through an integer texel lookup, so here the loss takes uv (and p, the
    normal) from the hit records directly: the v0 gradient is finite and
    equals jax.grad's (both clip y a step inside the pole for the
    gradient)."""
    o = np.array([[0.0, 5.0, -3.0], [0.3, 5.0, -2.9], [0.0, 0.0, 1.0]],
                 np.float32)
    d = np.array([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.1, 0.05, -1.0]],
                 np.float32)
    js, _ = _jax_sphere_scene(False)
    ts, _ = _port(js)
    idx = np.zeros(3, np.int32)
    valid = np.ones(3, bool)

    def jloss(v0):
        rec = jintersect.hit_records_from_prims(
            js._replace(v0=v0), jnp.asarray(idx), jnp.asarray(o),
            jnp.asarray(d), jnp.float32(1e-3), jintersect.BIG_T,
            jnp.asarray(valid))
        return (jnp.sum(rec.uv) + jnp.sum(rec.p * rec.p)
                + jnp.sum(rec.normal))
    jg = np.asarray(jax.grad(jloss)(js.v0))

    v0 = ts.v0.clone().requires_grad_()
    rec = tintersect.hit_records_from_prims(
        ts._replace(v0=v0), torch.from_numpy(idx).long(), torch.from_numpy(o),
        torch.from_numpy(d), 1e-3, tintersect.BIG_T, torch.from_numpy(valid))
    assert float(rec.uv[0, 1]) == pytest.approx(1.0)   # theta = pi
    (rec.uv.sum() + (rec.p * rec.p).sum() + rec.normal.sum()).backward()
    g = v0.grad.numpy()
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, jg, **GRAD_TOL)


def test_pole_guard_runs_only_under_autograd():
    """The forward render keeps its one acos per hit evaluation; the
    guard's second acos (at the clipped y) runs only when the hit fields
    require grad, and its value agrees with the plain one to rounding."""
    o = torch.tensor([[0.0, 5.0, -3.0], [0.3, 5.0, -2.9], [0.0, 0.0, 1.0]])
    d = torch.tensor([[0.0, -1.0, 0.0], [0.0, -1.0, 0.0], [0.1, 0.05, -1.0]])
    ts, _ = _port(_jax_sphere_scene(False)[0])
    idx = torch.zeros(3, dtype=torch.long)
    valid = torch.ones(3, dtype=torch.bool)
    uvs = []
    for grad in (False, True):
        v0 = ts.v0.clone().requires_grad_(grad)
        with mock.patch.object(torch, "acos", wraps=torch.acos) as spy:
            rec = tintersect.hit_records_from_prims(
                ts._replace(v0=v0), idx, o, d, 1e-3, tintersect.BIG_T, valid)
        assert spy.call_count == (2 if grad else 1)
        uvs.append(rec.uv.detach().numpy())
    np.testing.assert_allclose(uvs[1], uvs[0], rtol=0, atol=2e-7)
