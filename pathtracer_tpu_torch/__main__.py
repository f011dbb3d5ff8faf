"""CLI: render a scene to PNG on the GPU.

Usage:
    python -m pathtracer_tpu_torch --scene bunny --width 640 --height 360 \\
        --spp 8 --max-depth 4 --ray-chunk 57600 -o out.png

The render runs on ``cuda``; ``--device cpu`` runs the plain PyTorch
twins instead (for tests, at small sizes).
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch",
        description="PyTorch/CUDA port of the path tracer (bunny slice)")
    p.add_argument("--scene", default="bunny", choices=["bunny", "test"])
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--max-depth", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-chunk", type=int, default=57600)
    p.add_argument("--accel", default="auto", choices=["auto", "cluster"])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    p.add_argument("-o", "--output", default="debug.png")
    return p


def render_cli(args):
    """Build the scene and config, render, return (image (H,W,3) CPU
    tensor, seconds, cfg, stats). Shared by the CLI and chip_smoke.py."""
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; the CLI renders on the GPU")
    device = torch.device(args.device)
    scene, cam = get_world(args.scene, device=device)
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, accel=args.accel,
                       seed=args.seed, ray_chunk=args.ray_chunk,
                       scene=args.scene)
    render = make_renderer(cfg, device, with_stats=True)
    render.tables(scene)            # cluster build is set-up, not render
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    img, stats = render(scene, cam)
    img = img.cpu()                 # waits for the device
    return img, time.perf_counter() - start, cfg, stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from pathtracer_tpu_torch.io.png import write_png

    img, seconds, cfg, (n_queries, n_pairs) = render_cli(args)
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    print(f"Rendered {cfg.scene}: {cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"depth {cfg.max_depth} on {args.device} in {seconds:.6g} s "
          f"({nominal / seconds / 1e6:.3f} Mrays/s nominal, "
          f"{n_queries / seconds / 1e6:.3f} executed)")
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_png(args.output, img.numpy())
    print(f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
