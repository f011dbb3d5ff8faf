"""Processes in one gloo process group on localhost: the port's
multi-process path (``parallel/mesh.initialize_distributed``, a mesh of
the ranks' slots, ``all_reduce``) against the single-process render and
train step.

Each rank brings one CPU slot: a rays 2x1 mesh (each rank renders half
the chunks), a 1x2 mesh (each rank renders half the samples of every
pixel), and a group of one rank (1x1). Every rank returns the whole
image, which must equal the single-process render with the plan's chunk:
to the bit without an spp split, within 1e-6 on 1x2 (the ranks' sample
sums may add in another order). The train step (one SGD step on 2x1 and
1x2) all-reduces the count, every gradient and the loss across the
ranks: on every rank they must equal those of the single-process step
on a mesh of two CPU slots (the same plan) to rtol 1e-6, and the stepped
parameters must be equal on every rank.

The worker is this file run as a script; it imports neither jax nor the
JAX package.
"""
import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, mesh: str) -> None:
    rays, spp_axis = (int(v) for v in mesh.split("x"))
    world = rays * spp_axis                 # one slot a rank
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(rank), str(world),
         str(port), mesh, mode], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, env=env, cwd=REPO) for rank in range(world)]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=120)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
        outs.append(out)
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        assert f"RANK {rank} OK" in out, out[-3000:]
        assert "jax loaded: False" in out, out[-3000:]


@pytest.mark.parametrize("mesh", ["2x1", "1x2", "1x1"])
def test_gloo_group_render(mesh):
    _run_ranks("render", mesh)


@pytest.mark.parametrize("mesh", ["2x1", "1x2"])
def test_gloo_group_train_step(mesh):
    _run_ranks("train", mesh)


def _worker(rank: int, world: int, port: str, mesh_spec: str,
            mode: str) -> None:
    import torch

    from pathtracer_tpu_torch.parallel import (initialize_distributed,
                                               make_mesh)

    torch.set_num_threads(1)
    rays, spp_axis = (int(v) for v in mesh_spec.split("x"))
    if mode == "train":
        # the single-process step on two CPU slots, before any group is up
        reference = _sgd_step(make_mesh(["cpu"] * world,
                                        spp_axis_size=spp_axis))
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    initialize_distributed(f"localhost:{port}", world, rank, device="cpu")
    dist = torch.distributed
    assert dist.get_world_size() == world and dist.get_rank() == rank
    assert dist.get_backend() == "gloo"

    x = torch.tensor([float(rank + 1)])
    dist.all_reduce(x)
    assert x.item() == world * (world + 1) / 2, x

    mesh = make_mesh(["cpu"], spp_axis_size=spp_axis)
    assert mesh.shape == {"rays": rays, "spp": spp_axis}
    assert [(r, s) for r, s, _ in mesh.local_slots()] == (
        [(rank, 0)] if spp_axis == 1 else [(0, rank)])
    if mode == "train":
        _train_step(mesh, reference)
    else:
        _render(mesh, spp_axis)
    dist.destroy_process_group()
    loaded = "jax" in sys.modules or "pathtracer_tpu" in sys.modules
    print(f"jax loaded: {loaded}")
    print(f"RANK {rank} OK", flush=True)


def _render(mesh, spp_axis: int) -> None:
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.parallel import make_sharded_renderer
    from pathtracer_tpu_torch.parallel.sharded import _shard_plan
    from pathtracer_tpu_torch.render.renderer import render_image
    from pathtracer_tpu_torch.scene.worlds import test_world

    cfg = RenderConfig(width=32, height=16, spp=2, max_depth=3,
                       accel="brute", ray_chunk=64, scene="test", seed=3)
    scene, cam = test_world(device="cpu")
    img = make_sharded_renderer(cfg, mesh)(scene, cam)
    chunk = _shard_plan(cfg, mesh)[4]
    single = render_image(scene, cam, cfg.replace(ray_chunk=chunk),
                          device="cpu")
    if spp_axis == 1:
        assert torch.equal(img, single)
    else:
        assert torch.allclose(img, single, rtol=0.0, atol=1e-6)
    assert img.mean() > 0.05


def _sgd_step(mesh):
    """(loss, {field: gradient}, {field: stepped parameter}) of one SGD
    step (lr 0.1) of the test world on ``mesh``."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.worlds import test_world

    cfg = RenderConfig(width=16, height=8, spp=2, max_depth=2,
                       accel="brute", ray_chunk=64, scene="test")
    scene, cam = test_world(device="cpu")
    target = torch.from_numpy(
        np.random.default_rng(0).random((128, 3)).astype(np.float32))
    params = diff.scene_params(scene)
    sgd = torch.optim.SGD(list(params.values()), lr=0.1)
    loss = diff.make_train_step(cfg, sgd, mesh=mesh)(params, scene, cam,
                                                     target, 5)
    return (float(loss), {f: p.grad.clone() for f, p in params.items()},
            {f: p.detach().clone() for f, p in params.items()})


def _train_step(mesh, reference) -> None:
    import torch
    dist = torch.distributed

    loss, grads, stepped = _sgd_step(mesh)
    ref_loss, ref_grads, ref_stepped = reference
    assert abs(loss - ref_loss) <= 1e-6 * abs(ref_loss), (loss, ref_loss)
    assert grads["albedo"].abs().sum() > 0      # no emitter: emit's is 0
    for f, g in grads.items():
        torch.testing.assert_close(g, ref_grads[f], rtol=1e-6, atol=0.0,
                                   msg=f)
        torch.testing.assert_close(stepped[f], ref_stepped[f], rtol=1e-6,
                                   atol=0.0, msg=f)
        every = [torch.empty_like(stepped[f])
                 for _ in range(dist.get_world_size())]
        dist.all_gather(every, stepped[f])
        for other in every:
            assert torch.equal(other, stepped[f]), f


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
            sys.argv[5])
