#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``pathtracer_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the main path from ``csrc/`` (nvcc);
3. kernels vs plain twins on the card, at the main path's shapes: the
   cluster march on a 57,600-ray camera wavefront and a 57,600-ray bounce
   wavefront, timed with CUDA events (median of 5 after a warm-up);
4. main path: the bunny render at 640x360, 8 spp, depth 4, 57,600-ray
   chunks through the CLI's code path, with the launch counters reset just
   before it; checks finite pixels and the image mean, writes out/;
5. end to end: a small bunny render on the card against the same render on
   the CPU (the plain twins, which the CPU tests hold against the JAX
   reference).

The line before the last is a JSON object with each kernel's route,
source, launches in phase 4, error and times; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
RAYS = 57600
T_MIN = 1e-3


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, torch, reps: int = 5) -> float:
    """Median milliseconds of ``fn()`` over ``reps`` runs after a warm-up,
    timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def compare_march(kernel, twin, prim_type, torch):
    """Kernel vs twin outputs (t, best, slots); raises on disagreement.
    Returns (max |dt| on lanes both hit, slot totals)."""
    import numpy as np
    t_k, b_k, s_k = (x.cpu().numpy() for x in kernel)
    t_r, b_r, s_r = (x.cpu().numpy() for x in twin)
    v_k, v_r = b_k >= 0, b_r >= 0
    if (v_k == v_r).mean() < 0.999:
        fail(f"march valid agreement {(v_k == v_r).mean()}")
    both = v_k & v_r
    if (b_k[both] == b_r[both]).mean() < 0.999:
        fail(f"march index agreement {(b_k[both] == b_r[both]).mean()}")
    dt = np.abs(t_k - t_r)
    differ = both & (b_k != b_r)
    if (dt[differ] > 1e-5 * np.abs(t_r[differ])).any():
        fail("march winners differ on lanes that are not near ties")
    sph = both & (prim_type[np.maximum(b_r, 0)] == 1)
    tri = both & ~sph
    if (dt[tri] > 1e-5 * np.abs(t_r[tri])).any():
        fail(f"triangle t beyond rtol 1e-5: {dt[tri].max()}")
    if (dt[sph] > 1e-5 * np.abs(t_r[sph]) + 2e-4).any():
        fail(f"sphere t beyond rtol 1e-5 + atol 2e-4: {dt[sph].max()}")
    tot_k, tot_r = int(s_k.sum()), int(s_r.sum())
    if abs(tot_k - tot_r) > 0.001 * max(tot_r, 1):
        fail(f"slots marched differ: kernel {tot_k}, twin {tot_r}")
    return float(dt[both].max()) if both.any() else 0.0, tot_k, tot_r


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU, nothing to test")
    sys.path.insert(0, HERE)
    try:
        from pathtracer_tpu_torch.ops import _cuda_build, cluster_sweep
    except ImportError as e:
        fail(f"the port is not next to chip_smoke.py ({e})")
    import numpy as np

    from pathtracer_tpu_torch import __main__ as cli
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.core.camera import get_rays
    from pathtracer_tpu_torch.ops import intersect
    from pathtracer_tpu_torch.render.renderer import (CLUSTER_K,
                                                      make_renderer)
    from pathtracer_tpu_torch.scene import materials
    from pathtracer_tpu_torch.scene.worlds import get_world
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables

    # 1. device
    dev = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build
    t0 = time.perf_counter()
    _cuda_build.load("cluster_march")
    build_s = time.perf_counter() - t0
    print(f"build: cluster_march.cu in {build_s:.3f} s")
    for line in _cuda_build.BUILD_LOGS.get("cluster_march", "").splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")

    # 3. kernel vs plain twin at the main path's shapes
    scene, cam = get_world("bunny", device=dev)
    ct = build_cluster_tables(scene, K=CLUSTER_K)
    prim_type = ct.scene.prim_type.cpu().numpy()
    key = prng.PRNGKey(0)
    u = prng.uniform(prng.fold_in(key, 1), (4, RAYS), dev)
    o_cam, d_cam, _ = get_rays(cam, u[0], u[1], u[2], u[3],
                               torch.zeros(RAYS, device=dev))
    # one bounce: shade the camera hits, dead lanes get d = 0
    idx, _, valid = cluster_sweep.cluster_march(ct, o_cam, d_cam, T_MIN)
    rec = intersect.hit_records_from_prims(ct.scene, idx, o_cam, d_cam,
                                           T_MIN, intersect.BIG_T, valid)
    sc = materials.scatter(ct.scene, rec, d_cam,
                           prng.uniform_by_ray(key, torch.arange(RAYS,
                                                                 device=dev),
                                               6))
    alive = valid & sc.ok
    o_b = torch.where(alive[:, None], rec.p, o_cam)
    d_b = torch.where(alive[:, None], sc.direction, 0.0)

    max_err = 0.0
    times = {}
    for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_b, d_b)):
        q = cluster_sweep.march_inputs(ct, o, d, T_MIN)
        args = q["args"]
        kernel = cluster_sweep.march(*args)
        torch.cuda.synchronize()
        twin = cluster_sweep.march_reference(*args)
        err, tot_k, tot_r = compare_march(kernel, twin, prim_type, torch)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: cluster_sweep.march(*args), torch)
        plain_ms = cuda_ms(lambda: cluster_sweep.march_reference(*args),
                           torch)
        times[name] = (ms, plain_ms)
        print(f"march {name} wavefront ({RAYS} rays, {tot_k} slots kernel /"
              f" {tot_r} twin, max |dt| {err:.3g}): kernel {ms:.4f} ms, "
              f"plain twin {plain_ms:.4f} ms [{card}]")

    # 4. main path through the CLI's code path, counters reset just before
    out_png = os.path.join(HERE, "out", "chip_smoke_bunny.png")
    args = cli.build_parser().parse_args(
        ["--scene", "bunny", "--width", "640", "--height", "360", "--spp",
         "8", "--max-depth", "4", "--ray-chunk", str(RAYS), "--device",
         "cuda", "-o", out_png])
    cluster_sweep.MARCH_LAUNCHES = 0
    img, seconds, cfg, (n_queries, n_pairs) = cli.render_cli(args)
    launches = cluster_sweep.MARCH_LAUNCHES
    if launches <= 0:
        fail("the main path launched no march kernel")
    img_np = img.numpy()
    if img_np.shape != (360, 640, 3):
        fail(f"image shape {img_np.shape}")
    if not np.isfinite(img_np).all():
        fail("non-finite pixels")
    mean = float(img_np.mean())
    if not 0.3 <= mean <= 0.95:
        fail(f"image mean {mean} outside the sane range [0.3, 0.95]")
    from pathtracer_tpu_torch.io.png import write_png
    os.makedirs(os.path.dirname(out_png), exist_ok=True)
    write_png(out_png, img_np)
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    print(f"render bunny 640x360 8 spp depth 4, chunk {RAYS}: {seconds:.4f} s"
          f" wall, {nominal / seconds / 1e6:.4f} Mrays/s nominal, "
          f"{n_queries / seconds / 1e6:.4f} Mrays/s executed, "
          f"{launches} march launches, {n_pairs:.0f} pair tests, image mean "
          f"{mean:.5f} [{card}]")

    # 5. small render: card vs CPU twins
    small = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                         ray_chunk=64 * 36, accel="cluster", scene="bunny",
                         seed=5)
    g = make_renderer(small, dev)(scene, cam).cpu().numpy()
    scene_c, cam_c = get_world("bunny", device="cpu")
    c = make_renderer(small, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    close = float((diff <= 1e-4).mean())
    print(f"small render card vs CPU twins: {close:.5f} of channels within "
          f"1e-4, mean |diff| {diff.mean():.3g}")
    if close < 0.99 or diff.mean() > 1e-3:
        fail("card render disagrees with the CPU render")

    print(json.dumps({"kernels": [{
        "name": "cluster_march", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/cluster_march.cu",
        "replaces": "pathtracer_tpu/ops/cluster_sweep.py:446",
        "launches": launches, "max_abs_err": max_err,
        "ms": times["camera"][0], "plain_ms": times["camera"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
