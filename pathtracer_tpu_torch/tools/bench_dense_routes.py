"""The two dense closest-hit routes on small scenes, per query: the sweep
kernel (``accel="pallas"``) against the ``tensor`` route (a float32
matrix product and its torch epilogue).

The wavefronts are a render's own: one sample of a one-chunk image
(``--rays`` pixels, square) is rendered through the sweep kernel while its
queries are recorded, and the camera query (depth 0), the first bounce
query (depth 1) and, under NEE, the first shadow query (at
``K_SHADOW_T_MIN``) are replayed through both routes. Scenes without
emitters cast no shadow ray; for them the bounce wavefront is replayed at
the shadow t_min. Scenes: ``cornell`` (the preset cornell-full, 36
prims, NEE), ``triangle`` (the reference's triangle world, 601 prims) and
``triangle-1023`` (the same recipe with 1,022 objects: 1,023 prims, the
largest scene ``auto`` sends to a dense route).

Per route and wavefront, medians over ``--iters`` calls after a warm-up:
``host`` the call's own wall time (the enqueue: what the host spends),
``device`` CUDA events around the call, ``wall`` the call and a
synchronise, and ``stream`` the wall of ``--iters`` calls back to back
over their number (host and device overlapping, as in a bounce loop).
``agree`` is the share of lanes where both routes return the same hit
flag and index. On the CPU the plain twins run and only ``host`` and
``wall`` are printed (host clock; no number for the card).

Usage (on a machine with an NVIDIA GPU):
    python -m pathtracer_tpu_torch.tools.bench_dense_routes
    # the CPU check (plain twins; tiny sizes only):
    python -m pathtracer_tpu_torch.tools.bench_dense_routes --device cpu \\
        --rays 256 --iters 2
"""
from __future__ import annotations

import argparse
import math
import statistics
import sys
import time

SCENES = ("cornell", "triangle", "triangle-1023")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.tools.bench_dense_routes",
        description="the sweep kernel against the tensor route, per query")
    p.add_argument("--scenes", default=",".join(SCENES))
    p.add_argument("--rays", type=int, default=16384,
                   help="rays a query (a square image of one chunk)")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--seed", type=int, default=3)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    return p


def small_scene(name: str, device):
    """(scene, camera, config) of one of :data:`SCENES`."""
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.scene.worlds import triangle_world
    if name == "cornell":
        return get_preset("cornell-full", device=device)
    count = {"triangle": 600, "triangle-1023": 1022}[name]
    scene, cam = triangle_world(total_count=count, device=device)
    return scene, cam, RenderConfig(scene="triangle")


def recorded_wavefronts(scene, cam, cfg, side: int, seed: int, device):
    """[(kind, o, d, t_min)]: the camera, first bounce and first shadow
    queries of one sample of a ``side`` x ``side`` image in one chunk,
    rendered through the sweep kernel (module docstring)."""
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.render.renderer import (Query, make_query,
                                                      padded_pixel_grid,
                                                      render_sum)
    cfg = cfg.replace(width=side, height=side, spp=1, max_depth=2,
                      ray_chunk=side * side, accel="pallas")
    query = make_query(scene, cfg)
    calls, shadows = [], []

    def closest(o, d):
        calls.append((o.clone(), d.clone()))
        return query.closest(o, d)

    def query_shadow(o, d, active=None):
        shadows.append((o.clone(), d.clone()))
        return query.closest.query_shadow(o, d)
    closest.query_shadow = query_shadow
    rows, cols = padded_pixel_grid(cfg, cfg.ray_chunk, device)
    render_sum(scene, cam, prng.PRNGKey(seed), rows, cols, cfg, 1,
               Query(closest, query.scene))
    out = [("camera", *calls[0], cfg.t_min), ("bounce", *calls[1],
                                               cfg.t_min)]
    if shadows:
        out.append(("shadow", *shadows[0], K_SHADOW_T_MIN))
    else:
        out.append(("bounce @ shadow t_min", *calls[1], K_SHADOW_T_MIN))
    return out


class Clock:
    """Medians of a call's host, device and synchronised wall times in ms
    (device only on the card)."""

    def __init__(self, device, iters: int):
        import torch
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.iters = iters

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def times(self, fn) -> dict:
        torch = self.torch
        fn()
        self.sync()
        host, dev, wall = [], [], []
        for _ in range(self.iters):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
            t0 = time.perf_counter()
            fn()
            t1 = time.perf_counter()
            if self.cuda:
                stop.record()
            self.sync()
            t2 = time.perf_counter()
            host.append((t1 - t0) * 1e3)
            wall.append((t2 - t0) * 1e3)
            if self.cuda:
                dev.append(start.elapsed_time(stop))
        t0 = time.perf_counter()
        for _ in range(self.iters):
            fn()
        self.sync()
        stream = (time.perf_counter() - t0) * 1e3 / self.iters
        return {"host": statistics.median(host),
                "device": statistics.median(dev) if dev else None,
                "wall": statistics.median(wall), "stream": stream}


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    side = math.isqrt(args.rays)
    if side * side != args.rays:
        raise SystemExit(f"--rays must be a square, got {args.rays}")
    scenes = args.scenes.split(",")
    if not set(scenes) <= set(SCENES):
        raise SystemExit(f"--scenes takes {', '.join(SCENES)}")

    import torch

    from pathtracer_tpu_torch.ops.pallas_sweep import make_pallas_closest_hit
    from pathtracer_tpu_torch.ops.tensor_sweep import make_tensor_closest_hit

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu for the "
                               "plain twins")
        where = torch.cuda.get_device_name(0)
    else:
        where = "cpu (plain twins; host clock)"
    print(f"device: {where}; {args.rays} rays a query, medians of "
          f"{args.iters} calls (ms)", flush=True)
    clock = Clock(device, args.iters)
    for name in scenes:
        scene, cam, cfg = small_scene(name, device)
        fronts = recorded_wavefronts(scene, cam, cfg, side, args.seed,
                                     device)
        for kind, o, d, t_min in fronts:
            routes = {"K2": make_pallas_closest_hit(scene, t_min),
                      "tensor": make_tensor_closest_hit(scene, t_min)}
            hits = {r: fn(o, d) for r, fn in routes.items()}
            (ik, _, vk), (it, _, vt) = hits["K2"], hits["tensor"]
            agree = float(((vk == vt) & (~vk | (ik == it))).float().mean())
            line = []
            for r, fn in routes.items():
                t = clock.times(lambda: fn(o, d))
                dev = ("" if t["device"] is None
                       else f" device {t['device']:.4f}")
                line.append(f"{r} host {t['host']:.4f}{dev} wall "
                            f"{t['wall']:.4f} stream {t['stream']:.4f}")
            print(f"{name} ({scene.num_prims} prims) {kind} (t_min "
                  f"{t_min:g}): {'; '.join(line)}; agree {agree:.5f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
