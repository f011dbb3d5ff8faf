"""Large-scene demo: render the bunny subdivided 4:1 per level (the same
surface at 4^k times the triangles) through the cluster march.

With the vendored asset, level 1 is 14,467 prims, level 2 57,859 (905
regular clusters of K=64), level 3 231,427 (3,617 clusters) and level 4
925,699. The march reads its tables from the card's memory at any size;
from 2,048 regular clusters its cull switches to the two-level "cull2"
plan on its own (``ops/cluster_sweep.cull_plan``; ``PT_CLUSTER_CULL2``,
``PT_CLUSTER_CULL2_C`` and ``PT_CLUSTER_SUPER`` override it).

Usage:
    python -m pathtracer_tpu_torch.examples.big_scene [--level 2] \\
        [--width 320] [--spp 4] [--max-depth 4] [--out out/big_bunny.png]
    # on the CPU through the plain twins (tests; tiny sizes only):
    python -m pathtracer_tpu_torch.examples.big_scene --device cpu \\
        --level 0 --width 32 --spp 1
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.examples.big_scene",
        description="render the subdivided bunny through the cluster march")
    p.add_argument("--level", type=int, default=2,
                   help="4:1 subdivision levels (2 -> 57,859 prims)")
    p.add_argument("--width", type=int, default=320,
                   help="image width; the height is width * 9 / 16")
    p.add_argument("--spp", type=int, default=4)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    p.add_argument("--out", default=os.path.join("out", "big_bunny.png"))
    return p


def render_big_scene(level: int = 2, width: int = 320, spp: int = 4,
                     max_depth: int = 4, device="cuda", seed: int = 0):
    """Build the level-``level`` bunny and render it on ``device`` with the
    cluster march in one chunk of min(57,600, w * h) rays; returns a dict:
    ``img`` ((H, W, 3) CPU tensor), ``cfg``, ``scene`` and ``cam`` (on
    ``device``), ``prims``, ``C_reg``, ``K``,
    ``cull2`` and ``sup`` (the cull plan), and the seconds of the scene
    build (host), the table build and the render (``scene_s``,
    ``table_s``, ``wall_s``; each ends in a device sync)."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.bunny import bunny_world

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu for the twins")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    scene, cam = bunny_world(subdivide=level, device=device)
    sync()
    t1 = time.perf_counter()
    height = int(width * 9 / 16)
    cfg = RenderConfig(width=width, height=height, spp=spp,
                       max_depth=max_depth, accel="cluster",
                       ray_chunk=min(57600, width * height), seed=seed,
                       scene="bunny")
    render = make_renderer(cfg, device)
    closest = render.prepare(scene).closest
    sync()
    t2 = time.perf_counter()
    img = render(scene, cam).cpu()       # waits for the device
    t3 = time.perf_counter()
    cull2, sup = closest.cull_plan
    return dict(img=img, cfg=cfg, scene=scene, cam=cam,
                prims=int(scene.num_prims),
                C_reg=closest.tables.C_reg, K=closest.tables.K, cull2=cull2,
                sup=sup, scene_s=t1 - t0, table_s=t2 - t1, wall_s=t3 - t2)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from pathtracer_tpu_torch.io.png import write_png
    from pathtracer_tpu_torch.utils.metrics import mrays_per_s

    r = render_big_scene(args.level, args.width, args.spp, args.max_depth,
                         args.device)
    cfg = r["cfg"]
    print(f"level {args.level}: {r['prims']} primitives, {r['C_reg']} "
          f"regular clusters of K={r['K']}, cull2 "
          f"{'on' if r['cull2'] else 'off'} (sup {r['sup']}); scene build "
          f"{r['scene_s']:.3f} s, table build {r['table_s']:.3f} s",
          flush=True)
    print(f"rendered {cfg.width}x{cfg.height}x{cfg.spp}spp depth "
          f"{cfg.max_depth} on {args.device} in {r['wall_s']:.3f} s "
          f"({mrays_per_s(cfg.num_pixels, cfg.spp, cfg.max_depth, r['wall_s']):.3f}"
          f" Mrays/s nominal)", flush=True)
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_png(args.out, r["img"].numpy())
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
