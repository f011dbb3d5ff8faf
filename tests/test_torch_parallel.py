"""The port's multi-device rendering (``parallel/``) and sharded train
step against the JAX reference's on the conftest's 8 virtual CPU devices,
and against the port's single-device render; and the chunk keys of
``render_sum`` on a permuted wavefront (every chunk keyed by its first
pixel's global index, as in the reference).

Tolerances: sharded images against the JAX sharded images as
``tests/test_torch_render.py`` (>= 99% of channels within 1e-4, mean
|diff| <= 1e-3); against the port's single-device render with the plan's
chunk, to the bit (every sample sum here adds in the single render's
order); losses rtol 1e-6; gradients rtol 1e-4, atol 1e-6 as
``tests/test_torch_diff.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pathtracer_tpu.accel.lbvh import build_lbvh as jbuild
from pathtracer_tpu.config import RenderConfig as JConfig
from pathtracer_tpu.parallel import make_mesh as jmake_mesh
from pathtracer_tpu.parallel import make_sharded_renderer as jsharded
from pathtracer_tpu.render import diff as jdiff
from pathtracer_tpu.render import renderer as jrenderer
from pathtracer_tpu_torch import __main__ as cli
from pathtracer_tpu_torch.config import RenderConfig as TConfig
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.parallel import (RAYS_AXIS, SPP_AXIS,
                                           initialize_distributed, make_mesh,
                                           make_sharded_renderer,
                                           sharded_render_image)
from pathtracer_tpu_torch.parallel.sharded import _shard_plan
from pathtracer_tpu_torch.render import diff as tdiff
from pathtracer_tpu_torch.render import renderer as trenderer
from test_torch_bvh_render import _lit_scene, _port
from test_torch_diff import GRAD_TOL
from test_torch_render import _assert_images_close, _both

torch.set_num_threads(1)

# tests/test_parallel.py's configuration
CFG = dict(width=32, height=16, spp=2, max_depth=3, accel="bvh",
           ray_chunk=64, scene="test")


def test_mesh_shapes_and_errors():
    mesh = make_mesh(["cpu"] * 8, spp_axis_size=2)
    assert mesh.shape == {RAYS_AXIS: 4, SPP_AXIS: 2}
    assert [(r, s) for r, s, _ in mesh.local_slots()] == [
        (r, s) for r in range(4) for s in range(2)]
    assert make_mesh(["cpu"] * 3).shape == {RAYS_AXIS: 3, SPP_AXIS: 1}
    for n, spp in ((8, 3), (2, 0), (0, 1)):
        with pytest.raises(ValueError):
            make_mesh(["cpu"] * n, spp_axis_size=spp)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_renderer(TConfig(**CFG).replace(spp=3), mesh)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
    # one process: bring-up is a no-op without an address
    initialize_distributed()
    initialize_distributed(None, 1, 0)
    assert not torch.distributed.is_initialized()


def test_shard_plan_matches_reference():
    from pathtracer_tpu.parallel.sharded import _shard_plan as jplan
    for w, h, chunk, (n, spp_axis) in [(32, 16, 64, (8, 1)),
                                       (32, 16, 64, (8, 2)),
                                       (640, 360, 57600, (2, 1)),
                                       (640, 360, 57600, (1, 1)),
                                       (100, 37, 999, (3, 1)),
                                       (64, 64, 4096, (2, 1))]:
        cfg = dict(width=w, height=h, spp=4, ray_chunk=chunk)
        jmesh = jmake_mesh(jax.devices()[:n], spp_axis_size=spp_axis)
        tmesh = make_mesh(["cpu"] * n, spp_axis_size=spp_axis)
        assert _shard_plan(TConfig(**cfg), tmesh) == jplan(JConfig(**cfg),
                                                           jmesh)


@pytest.mark.parametrize("nee", [False, True])
@pytest.mark.parametrize("spp_axis", [1, 2])
def test_sharded_matches_jax_and_single_device(spp_axis, nee):
    """8x1 and 4x2 meshes, "bvh" route, NEE off (the test world) and on
    (a lit scene): the port's sharded image against the reference's
    sharded image, and against the port's single-device render with the
    plan's chunk."""
    if nee:
        js, jc = _lit_scene()
        ts, tc = _port(js, jc)
        kw = dict(CFG, nee=True, sky=False)
    else:
        js, jc, ts, tc = _both("test")
        kw = CFG
    jmesh = jmake_mesh(jax.devices()[:8], spp_axis_size=spp_axis)
    ref = np.asarray(jsharded(JConfig(**kw), jmesh)(js, jbuild(js), jc, 7))
    cfg = TConfig(**kw)
    mesh = make_mesh(["cpu"] * 8, spp_axis_size=spp_axis)
    got = make_sharded_renderer(cfg, mesh)(ts, tc, 7)
    assert got.shape == (16, 32, 3) and got.numpy().mean() > 0.05
    _assert_images_close(got.numpy(), ref)
    chunk = _shard_plan(cfg, mesh)[4]
    single = trenderer.render_image(ts, tc, cfg.replace(ray_chunk=chunk),
                                    seed=7, device="cpu")
    assert torch.equal(got, single)
    assert torch.equal(sharded_render_image(ts, tc, cfg.replace(seed=7),
                                            mesh), got)


def test_render_sum_keys_chunks_by_first_pixel():
    """A permuted wavefront (chunks in reverse order, a chunk of padding
    alone in front): each chunk keys by its first pixel's global index, so
    the port's ``render_sum`` equals the reference's on the same inputs,
    and each pixel's sum equals the raster-order render's."""
    js, jc, ts, tc = _both("test")
    kw = dict(width=16, height=8, spp=2, max_depth=3, accel="brute",
              ray_chunk=32, scene="test")
    rows, cols = trenderer.padded_pixel_grid(TConfig(**kw), 32, "cpu")
    order = torch.cat([torch.tensor([4]), torch.arange(3, -1, -1)])
    pad = torch.zeros(32)
    rows_p = torch.cat([rows, pad]).view(5, 32)[order].reshape(-1)
    cols_p = torch.cat([cols, pad]).view(5, 32)[order].reshape(-1)
    want = np.asarray(jrenderer.render_sum(
        js, None, jc, jax.random.PRNGKey(4), jnp.asarray(rows_p.numpy()),
        jnp.asarray(cols_p.numpy()), JConfig(**kw), 2))
    got, _ = trenderer.render_sum(ts, tc, prng.PRNGKey(4), rows_p, cols_p,
                                  TConfig(**kw), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    raster, _ = trenderer.render_sum(ts, tc, prng.PRNGKey(4), rows, cols,
                                     TConfig(**kw), 2)
    assert torch.equal(got.view(5, 32, 3)[1:].flip(0).reshape(-1, 3),
                       raster)


def _jax_slot_grads(js, jc, target, kw, mesh_shape):
    """Each (r, s) slot's (SSE, weighted count, gradient of its SSE) under
    the reference's plan, from the reference's ``_loss_local``."""
    rays, spp_axis = mesh_shape
    jcfg = JConfig(**kw)
    jmesh = jmake_mesh(jax.devices()[:rays * spp_axis],
                       spp_axis_size=spp_axis)
    from pathtracer_tpu.parallel.sharded import _shard_plan as jplan
    _, _, spp_local, per_dev, chunk = jplan(jcfg, jmesh)
    n_padded = per_dev * rays
    rows, cols = jrenderer.padded_pixel_grid(jcfg, n_padded)
    w = jdiff._pixel_weights(jcfg.num_pixels, n_padded)
    tgt = jdiff._pad_target(jnp.asarray(target), n_padded)
    cfg_local = jcfg.replace(ray_chunk=chunk)

    @jax.jit
    def slot(p, rows, cols, tgt, w, offset):
        def sse(p):
            return jdiff._loss_local(p, js, None, jc, jax.random.PRNGKey(5),
                                     rows, cols, tgt, w, cfg_local,
                                     spp_local, sample_offset=offset)
        (a, b), g = jax.value_and_grad(sse, has_aux=True)(p)
        return a, b, g
    out = {}
    for r in range(rays):
        sl = slice(r * per_dev, (r + 1) * per_dev)
        for s in range(spp_axis):
            out[r, s] = slot(jdiff.scene_params(js), rows[sl], cols[sl],
                             tgt[sl], w[sl], jnp.int32(s * spp_local))
    return out


@pytest.mark.parametrize("mesh_shape", [(2, 1), (1, 2)])
def test_sharded_train_step(mesh_shape):
    """One SGD step over a 2x1 and a 1x2 mesh: the loss equals the
    reference's sharded step's; the gradient is the objective's, the sum
    over every slot (``jax.grad`` of the reference's per-slot SSE, summed,
    over the summed count). The reference's sharded step takes (R * S)
    times slot (0, 0)'s gradient instead (ROADMAP Queue 3, standing), so
    its gradient is held to that, not to the port's."""
    kw = dict(width=16, height=8, spp=2, max_depth=2, accel="brute",
              ray_chunk=64, scene="test")
    js, jc, ts, tc = _both("test")
    target = np.random.default_rng(0).random((128, 3)).astype(np.float32)
    rays, spp_axis = mesh_shape
    jmesh = jmake_mesh(jax.devices()[:rays * spp_axis],
                       spp_axis_size=spp_axis)
    opt = optax.sgd(1.0)
    jp = jdiff.scene_params(js)
    jp1, _, jloss = jdiff.make_train_step(JConfig(**kw), opt, mesh=jmesh)(
        jp, opt.init(jp), js, None, jc, jnp.asarray(target), 5)
    j_grad = {f: np.asarray(jp[f]) - np.asarray(jp1[f]) for f in jp}

    params = tdiff.scene_params(ts)
    sgd = torch.optim.SGD(list(params.values()), lr=0.1)
    mesh = make_mesh(["cpu"] * (rays * spp_axis), spp_axis_size=spp_axis)
    loss = tdiff.make_train_step(TConfig(**kw), sgd, mesh=mesh)(
        params, ts, tc, torch.from_numpy(target), 5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)

    slots = _jax_slot_grads(js, jc, target, kw, mesh_shape)
    n = sum(float(b) for _, b, _ in slots.values())
    for f, p in params.items():
        want = sum(np.asarray(g[f]) for _, _, g in slots.values()) / n
        np.testing.assert_allclose(p.grad.numpy(), want, err_msg=f,
                                   **GRAD_TOL)
        np.testing.assert_allclose(
            p.detach().numpy(),
            np.asarray(getattr(js, f)) - 0.1 * p.grad.numpy(), rtol=1e-6)
    # the reference: slot (0, 0)'s gradient over slot (0, 0)'s own count
    _, n00, g00 = slots[0, 0]
    first = np.asarray(g00["albedo"]) / float(n00)
    np.testing.assert_allclose(j_grad["albedo"], first, rtol=1e-4, atol=1e-6)
    assert not np.allclose(first, params["albedo"].grad.numpy(), rtol=1e-3)


def test_cli_mesh(tmp_path, monkeypatch):
    """``--mesh RxS`` renders sharded (on the CPU, R*S slots of it); on
    ``cuda`` it needs R*S devices and raises when fewer exist."""
    argv = ["--scene", "test", "--width", "32", "--height", "16", "--spp",
            "2", "--max-depth", "3", "--ray-chunk", "64", "--accel", "bvh",
            "--device", "cpu", "-o", str(tmp_path / "m.png")]
    args = cli.build_parser().parse_args(argv + ["--mesh", "4x2"])
    img, _, cfg, stats = cli.render_cli(args)
    ts, tc = _both("test")[2:]
    mesh = make_mesh(["cpu"] * 8, spp_axis_size=2)
    assert torch.equal(img, make_sharded_renderer(cfg, mesh)(ts, tc))
    assert stats[0] > 0
    assert cli.main(argv + ["--mesh", "2"]) == 0
    assert (tmp_path / "m.png").exists()
    for bad in ("0", "2y2", "x"):
        with pytest.raises(ValueError, match="R or RxS"):
            cli.parse_mesh(bad, "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 CUDA devices, 1 visible"):
        cli.parse_mesh("1x2", "cuda")
