"""Inverse-rendering demo: recover Cornell-box albedos from a target image
by gradient descent through the renderer (the port of the repository's
``examples/inverse_rendering.py``).

Renders a target with the true materials, perturbs every Lambertian
albedo (walls and spheres) toward grey, then fits them back with Adam
through the differentiable pass (``render/diff.py``) on a frozen noise
realization. Writes ``target.png``, ``initial.png``, ``fitted.png`` and
``history.json`` (the summary and every step's loss) under ``--out-dir``,
and prints the summary as one JSON line, the last.

The scene is the Cornell box with two diffuse spheres, at ``--size``
square, ``--spp`` samples, depth 2, NEE, no sky, on the "brute" route,
as in the JAX example.

Usage:
    python -m pathtracer_tpu_torch.examples.inverse_rendering \\
        [--steps 60] [--out-dir out/inverse_rendering]
    # on the CPU through the plain twins (tests; tiny sizes only):
    python -m pathtracer_tpu_torch.examples.inverse_rendering \\
        --device cpu --size 16 --spp 2 --steps 3
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.examples.inverse_rendering",
        description="fit Cornell-box albedos to a target render")
    p.add_argument("--steps", type=int, default=60)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--out-dir", default=os.path.join("out",
                                                     "inverse_rendering"))
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    p.add_argument("--size", type=int, default=48)
    p.add_argument("--spp", type=int, default=8)
    return p


def run(steps: int = 60, lr: float = 0.05, size: int = 48, spp: int = 8,
        device="cuda", out_dir=None) -> dict:
    """The fit; returns {"summary": ..., "loss": history}, and writes the
    PNGs and ``history.json`` under ``out_dir`` when it is given. Raises
    without a card unless ``device`` is "cpu"."""
    import numpy as np
    import torch

    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.io.png import write_png
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.renderer import padded_pixel_grid
    from pathtracer_tpu_torch.scene.cornell import cornell_box

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu for the twins")
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=2,
                       sky=False, nee=True, accel="brute",
                       ray_chunk=size * size, scene="cornell")
    scene, cam = cornell_box(variant="spheres", device=device)
    rows, cols = padded_pixel_grid(cfg, min(cfg.ray_chunk, cfg.num_pixels),
                                   device)
    key = prng.PRNGKey(0)

    def linear_img(s):
        with torch.no_grad():
            return diff.render_linear(s, cam, key, rows, cols, cfg,
                                      cfg.spp)[:cfg.num_pixels]

    def to_png(name, lin):
        if out_dir:
            img = np.sqrt(np.clip(lin.cpu().numpy(), 0, None))
            write_png(os.path.join(out_dir, name),
                      img.reshape(cfg.height, cfg.width, 3))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    target = linear_img(scene)
    to_png("target.png", target)
    start = scene._replace(albedo=scene.albedo * 0.3 + 0.45)
    to_png("initial.png", linear_img(start))
    params, history = diff.fit(start, cam, target, cfg, steps=steps, lr=lr,
                               param_fields=("albedo",), seed=0,
                               resample=False)
    fitted = diff.apply_params(start, params)
    to_png("fitted.png", linear_img(fitted))
    summary = {
        "loss_first": history[0], "loss_last": history[-1],
        "albedo_mae_initial": float((start.albedo - scene.albedo).abs()
                                    .mean()),
        "albedo_mae_fitted": float((params["albedo"] - scene.albedo).abs()
                                   .mean())}
    result = {"summary": summary, "loss": history}
    if out_dir:
        with open(os.path.join(out_dir, "history.json"), "w") as f:
            json.dump(result, f, indent=2)
    return result


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    result = run(args.steps, args.lr, args.size, args.spp, args.device,
                 args.out_dir)
    print(f"wrote target/initial/fitted PNGs to {args.out_dir}")
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
