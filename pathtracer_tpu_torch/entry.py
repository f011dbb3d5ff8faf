"""Compile-check entry points (the port of the repository's
``__graft_entry__.py``).

``entry()``             one forward render step of the flagship scene (the
                        bunny through the cluster march, ``bench.py``'s
                        default route) and its arguments, on the card;
``dryrun_multichip(n)`` one sharded render on the march, one on the BVH
                        route and one sharded train step (``torch.optim.
                        Adam``) over an n-slot (rays, spp) mesh, each
                        checked finite.

The JAX version forces ``PT_CLUSTER_STREAM=1`` for its sharded render:
the streamed march is a workaround for the TPU's 16 MB of VMEM, which the
port never had (its march reads its tables from the card's memory at any
scene size), so there is nothing to force here.

Usage:
    python -m pathtracer_tpu_torch.entry             # on the card, n = 2
    python -m pathtracer_tpu_torch.entry --device cpu --n 8   # the twins
"""
from __future__ import annotations

import argparse
import sys

from pathtracer_tpu_torch.config import RenderConfig

# the flagship step: the bunny at 160x90 through the march; the chunk
# divides the pixels, so every chunk is whole
ENTRY_CFG = RenderConfig(width=160, height=90, spp=2, max_depth=4,
                         accel="cluster", ray_chunk=14400, scene="bunny")


def entry(device="cuda", cfg: RenderConfig = ENTRY_CFG):
    """(forward_step, (scene, cam, 0)): ``forward_step(scene, cam, seed)``
    renders ``cfg`` (default :data:`ENTRY_CFG`) on ``device`` to the (H,
    W, 3) gamma-2 image, bit-equal to ``render_image`` at the same seed.
    Raises without a card unless ``device`` is "cpu"."""
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render import renderer as renderer_mod
    from pathtracer_tpu_torch.scene.worlds import get_world

    scene, cam = get_world(cfg.scene, device=device)
    rows, cols = renderer_mod.padded_pixel_grid(
        cfg, min(cfg.ray_chunk, cfg.num_pixels), device)
    render = renderer_mod.make_renderer(cfg, device)

    def forward_step(scene, cam, seed):
        acc, _ = renderer_mod.render_sum(
            scene, cam, prng.PRNGKey(seed), rows, cols, cfg, cfg.spp,
            render.prepare(scene))
        return renderer_mod.finish_image(acc, cfg)

    return forward_step, (scene, cam, 0)


def mesh_slots(n: int, device="cuda") -> list:
    """n slot devices: the CUDA cards in turn (cuda:0, cuda:1, ..., again
    from cuda:0 when n exceeds them), or n slots of the CPU."""
    import torch
    if torch.device(device).type == "cpu":
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' for the twins")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def dryrun_multichip(n_devices: int, device="cuda") -> float:
    """One sharded render on the march (the random world), one on the BVH
    route (the test world) and one sharded train step on the dense sweep
    (the test world) over an n-slot mesh (:func:`mesh_slots`): ``rays`` x
    ``spp``, the spp axis 2 when n is even. Asserts each result finite
    and returns the train step's loss."""
    import torch

    from pathtracer_tpu_torch.parallel import make_mesh, make_sharded_renderer
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.scene.worlds import get_world

    spp_axis = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    slots = mesh_slots(n_devices, device)
    mesh = make_mesh(slots, spp_axis_size=spp_axis)
    home = slots[0]

    # 1) the sharded render on the march
    cfg = RenderConfig(width=32, height=16, spp=2 * spp_axis, max_depth=2,
                       accel="cluster", ray_chunk=128, scene="random")
    scene, cam = get_world("random", device=home)
    img = make_sharded_renderer(cfg, mesh)(scene, cam, 0)
    if tuple(img.shape) != (cfg.height, cfg.width, 3) \
            or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"sharded march render: shape "
                             f"{tuple(img.shape)}, finite "
                             f"{bool(torch.isfinite(img).all())}")

    # 2) the BVH route, sharded
    cfg = cfg.replace(accel="bvh", ray_chunk=64, scene="test")
    scene, cam = get_world("test", device=home)
    img = make_sharded_renderer(cfg, mesh)(scene, cam, 0)
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("sharded BVH render is not finite")

    # 3) the full train step: loss and gradient over (rays, spp), one Adam
    # step
    cfg = cfg.replace(accel="pallas")
    params = diff.scene_params(scene)
    optimizer = torch.optim.Adam(list(params.values()), lr=1e-2)
    step = diff.make_train_step(cfg, optimizer, mesh=mesh, spp=cfg.spp)
    target = torch.zeros((cfg.num_pixels, 3), device=home)
    loss = float(step(params, scene, cam, target, 0))
    if not (loss == loss and abs(loss) != float("inf")):
        raise AssertionError(f"non-finite loss {loss}")
    print(f"dryrun_multichip({n_devices}): mesh={mesh.shape} on "
          f"{[str(d) for d in slots]} loss={loss:.6f} OK", flush=True)
    return loss


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="pathtracer_tpu_torch.entry",
                                description="compile-check entry points")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    p.add_argument("--n", type=int, default=2,
                   help="slots of dryrun_multichip's mesh")
    args = p.parse_args(argv)
    fn, fn_args = entry(args.device)
    img = fn(*fn_args)
    print(f"entry: {tuple(img.shape)} mean {float(img.mean()):.6f}",
          flush=True)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
