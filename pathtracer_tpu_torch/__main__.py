"""CLI: render a scene or a preset to PNG on the GPU.

Usage:
    python -m pathtracer_tpu_torch            # the reference's defaults
    python -m pathtracer_tpu_torch --scene bunny --width 640 --height 360 \\
        --spp 8 --max-depth 4 --ray-chunk 57600 -o out.png
    python -m pathtracer_tpu_torch --preset cornell-full --accel pallas \\
        --ray-chunk 65536 -o out/cornell.png

With no flags it renders what ``python -m pathtracer_tpu`` renders: the
triangle world at 800x450, 100 spp, depth 50, in 16,384-ray chunks, in
passes of ``--spp-per-pass`` 8 samples (a render of more spp than that, or
any render with ``--checkpoint FILE``, runs in passes; with a checkpoint,
re-running the same command resumes where it stopped). The render runs on
``cuda``; ``--device cpu`` runs the plain PyTorch twins instead (for
tests, at small sizes). The cluster route reads the
reference's knobs from the environment (``render/renderer.cluster_options``):

    PT_CLUSTER_STRATEGY=rounds PT_CLUSTER_K=128 \\
        python -m pathtracer_tpu_torch --scene bunny --width 640 \\
        --height 360 --spp 8 --max-depth 4 --ray-chunk 57600 \\
        -o out/bunny_rounds.png

``--accel bvh`` takes the LBVH route; ``--mesh R`` or ``--mesh RxS``
renders sharded over the first R*S CUDA devices (R over the pixels, S over
the samples; on ``--device cpu``, R*S slots of the CPU); ``--interactive``
opens the terminal viewer (WASD/QE move, ESC or x quits).
"""
from __future__ import annotations

import argparse
import os
import sys
import time

SCENES = ["test", "triangle", "random", "cornell", "bunny", "combined"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch",
        description="PyTorch/CUDA port of the path tracer")
    p.add_argument("--scene", default="triangle", choices=SCENES)
    p.add_argument("--preset", default=None,
                   help="named configuration (cornell-direct / "
                        "cornell-full / cornell-diff / bunny / "
                        "combined-1080p / bunny-l4); overrides scene, size, spp and "
                        "depth")
    p.add_argument("--scale", type=float, default=1.0,
                   help="resolution and spp factor applied to --preset")
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=450)
    p.add_argument("--spp", type=int, default=100)
    p.add_argument("--max-depth", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ray-chunk", type=int, default=None,
                   help="rays per wavefront chunk (default 16384; with "
                        "--preset, the preset's)")
    p.add_argument("--accel", default=None,
                   choices=["auto", "cluster", "tensor", "pallas", "bvh",
                            "brute"],
                   help="closest-hit route (default auto: tensor below "
                        "1,024 prims, cluster above; with --preset, "
                        "overrides the preset's)")
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation at diffuse bounces (scenes "
                        "with emissive lights)")
    p.add_argument("--no-sky", action="store_true",
                   help="black background (emissive-lit scenes)")
    p.add_argument("--sampler", default="random",
                   choices=["random", "sobol"],
                   help="pixel-filter sampler: uniform jitter or per-pixel "
                        "Owen-scrambled Sobol")
    p.add_argument("--rr", action="store_true",
                   help="Russian-roulette termination after --rr-depth "
                        "bounces (continue 0.8, survivors x1.25)")
    p.add_argument("--rr-depth", type=int, default=3)
    p.add_argument("--terminate-black", action="store_true",
                   help="depth-exhausted rays return black instead of "
                        "sky * attenuation")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file: accumulate spp in resumable "
                        "passes; re-running resumes where it stopped")
    p.add_argument("--spp-per-pass", type=int, default=8,
                   help="samples per pass: a render of more spp, or any "
                        "render with --checkpoint, runs in passes")
    p.add_argument("--interactive", action="store_true",
                   help="progressive terminal viewer with WASD/QE camera")
    p.add_argument("--mesh", default=None,
                   help="render sharded over a device mesh: 'R' (pixels "
                        "only) or 'RxS' (pixels x samples), on the first "
                        "R*S CUDA devices")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    p.add_argument("-o", "--output", default="debug.png")
    return p


def scene_and_config(args, device):
    """(scene, camera, RenderConfig) from the parsed arguments."""
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.scene.worlds import get_world

    if args.preset:
        scene, cam, cfg = get_preset(args.preset, device=device)
        if args.scale != 1.0:
            s = args.scale
            cfg = cfg.replace(width=max(8, int(cfg.width * s)),
                              height=max(8, int(cfg.height * s)),
                              spp=max(1, int(cfg.spp * s)))
        cfg = cfg.replace(seed=args.seed)
        if args.accel:
            cfg = cfg.replace(accel=args.accel)
        if args.ray_chunk:
            cfg = cfg.replace(ray_chunk=args.ray_chunk)
        if args.rr:
            cfg = cfg.replace(rr=True, rr_depth=args.rr_depth)
        if args.sampler != "random":
            cfg = cfg.replace(sampler=args.sampler)
        if args.terminate_black:
            cfg = cfg.replace(terminate_black=True)
        return scene, cam, cfg
    scene, cam = get_world(args.scene, device=device)
    # the Cornell box is lit by its area light alone
    cornell = args.scene == "cornell"
    cfg = RenderConfig(width=args.width, height=args.height, spp=args.spp,
                       max_depth=args.max_depth, accel=args.accel or "auto",
                       seed=args.seed, ray_chunk=args.ray_chunk or 16384,
                       sky=not (args.no_sky or cornell),
                       nee=args.nee or cornell,
                       terminate_black=args.terminate_black, rr=args.rr,
                       rr_depth=args.rr_depth, sampler=args.sampler,
                       scene=args.scene)
    return scene, cam, cfg


def parse_mesh(spec: str, device: str):
    """The mesh of ``--mesh R`` or ``--mesh RxS``: the first R*S CUDA
    devices, or on the CPU R*S slots of it; raises ValueError when fewer
    CUDA devices exist (no fallback)."""
    import torch

    from pathtracer_tpu_torch.parallel import make_mesh

    try:
        parts = [int(x) for x in spec.lower().split("x")]
    except ValueError:
        parts = []
    if len(parts) not in (1, 2) or min(parts) < 1:
        raise ValueError(f"--mesh {spec!r}: expected R or RxS")
    spp_n = parts[1] if len(parts) == 2 else 1
    n = parts[0] * spp_n
    if device == "cpu":
        return make_mesh(["cpu"] * n, spp_axis_size=spp_n)
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"--mesh {spec} needs {n} CUDA devices, "
                         f"{have} visible")
    return make_mesh([torch.device("cuda", i) for i in range(n)],
                     spp_axis_size=spp_n)


def cli_device(args):
    """The device ``--device`` names; raises without a CUDA device for
    ``cuda``."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; the CLI renders on the GPU")
    return torch.device(args.device)


def render_cli(args):
    """Build the scene and config, render, return (image (H,W,3) CPU
    tensor, seconds, cfg, (closest-hit queries, shadow queries, march pair
    tests)). Shared by the CLI and chip_smoke.py.

    The reference's route: with ``--mesh``, one sharded render
    (``parallel/sharded``; the statistics of this process's slots); else
    with ``--checkpoint``, or more spp than ``--spp-per-pass``, the render
    runs in passes (``utils/checkpoint.render_with_checkpoints``) with a
    progress line after each; else in one."""
    import torch

    from pathtracer_tpu_torch.parallel import make_sharded_renderer
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.utils.checkpoint import render_with_checkpoints

    device = cli_device(args)
    scene, cam, cfg = scene_and_config(args, device)
    if args.mesh:
        mesh = parse_mesh(args.mesh, args.device)
        print(f"mesh: {mesh.shape}")
        render = make_sharded_renderer(cfg, mesh, with_stats=True)
    else:
        render = make_renderer(cfg, device, with_stats=True)
    render.prepare(scene)           # table build is set-up, not render
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    start = time.perf_counter()
    if args.mesh:
        img, stats = render(scene, cam)
    elif args.checkpoint or cfg.spp > args.spp_per_pass:
        def show(done, total):
            print(f"  {done}/{total} spp "
                  f"({time.perf_counter() - start:.1f}s)", flush=True)

        img, stats = render_with_checkpoints(
            scene, cam, cfg, args.checkpoint,
            spp_per_chunk=args.spp_per_pass, progress=show, renderer=render)
    else:
        img, stats = render(scene, cam)
    img = img.cpu()                 # waits for the device
    return img, time.perf_counter() - start, cfg, stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from pathtracer_tpu_torch.io.png import write_png

    try:
        if args.interactive:
            from pathtracer_tpu_torch.viewer.interactive import run_viewer
            device = cli_device(args)
            scene, cam, cfg = scene_and_config(args, device)
            return run_viewer(scene, cam, cfg, device=device)
        img, seconds, cfg, (n_queries, n_shadow, _) = render_cli(args)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    print(f"Rendered {cfg.scene}: {cfg.width}x{cfg.height}, {cfg.spp} spp, "
          f"depth {cfg.max_depth}, accel {cfg.accel}"
          f"{', nee' if cfg.nee else ''} on {args.device} in {seconds:.6g} s"
          f" ({nominal / seconds / 1e6:.3f} Mrays/s nominal, "
          f"{n_queries / seconds / 1e6:.3f} executed, {n_shadow:.0f} shadow "
          f"rays)")
    out_dir = os.path.dirname(args.output)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    write_png(args.output, img.numpy())
    print(f"Wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
