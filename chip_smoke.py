#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``pathtracer_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the main paths from ``csrc/``, one nvcc
   process per source, all at once; print each kernel's ptxas line;
3. kernels vs plain twins on the card, at the main paths' shapes, timed
   with CUDA events (median of 5 after a warm-up), each beside its bound:
   the cluster march on a 57,600-ray bunny camera and bounce wavefront; the
   dense sweep on the triangle world's 90,000-ray camera wavefront, the
   cornell-full 65,536-ray camera wavefront and a cornell-full shadow
   wavefront (t_min = K_SHADOW_T_MIN), with the ``tensor`` route (the
   ``auto`` choice for these scenes) timed at the same shapes; the window
   sweep of the rounds strategy (K=128 tables) on the 57,600-ray bunny
   camera wavefront's residual pass, first round and full-width fallback,
   which must agree with the twin to the bit;
4. main paths through the CLI's code path, each with every launch counter
   reset just before it and read just after: the bunny at 640x360, 8 spp,
   depth 4 (cluster march); cornell-full at 256x256, 64 spp, depth 4 with
   NEE, stratified jitter and textures (dense sweep); the triangle world at
   the reference's default, 800x450, 100 spp, depth 50 (dense sweep); the
   bunny again on the rounds route (PT_CLUSTER_STRATEGY=rounds,
   PT_CLUSTER_K=128: window sweep, no march), whose image must agree with
   the march's. Each checks finite pixels and the image mean and writes
   out/;
5. end to end: small renders on the card against the same renders on the
   CPU (the plain twins, which the CPU tests hold against the JAX
   reference): the bunny, cornell-full through the dense sweep with NEE,
   the bunny in the Cornell room with NEE on the march, and the bunny on
   the rounds route with the Sobol sampler, Russian roulette and black
   termination.

The line before the last is a JSON object with each kernel's route,
source, launches on its main path, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from unittest import mock

HERE = os.path.dirname(os.path.abspath(__file__))
DEVICE = "cuda"
RAYS = 57600           # bunny chunk
TRI_RAYS = 90000       # triangle world chunk (800x450 / 4)
CORNELL_RAYS = 65536   # cornell-full chunk (256x256)
TRIANGLE_SPP = 100     # the reference's default; cut spp first for time
T_MIN = 1e-3
ROUNDS_K = 128         # the rounds strategy needs K % 128 == 0
ROUNDS_ENV = {"PT_CLUSTER_STRATEGY": "rounds", "PT_CLUSTER_K": str(ROUNDS_K)}

# H100 SXM peaks (NVIDIA's data sheet): HBM bytes/s and float32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# float32 operations per (ray, primitive) pair: 23 per pair scalar (12
# products, 11 sums) times the scalars the primitive needs (sphere 2,
# triangle 4), its epilogue (sphere 14, triangle 13) and the merge compare
OPS_SPHERE_PAIR = 2 * 23 + 14 + 1
OPS_TRI_PAIR = 4 * 23 + 13 + 1


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


def bound(n_bytes: float, n_ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the float32 operations over the CUDA-core peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_F32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def real_rows(ct, scene):
    """(C_tot, K) bool: the cluster tables' rows that hold one of the
    scene's primitives, not the inert padding (which the tables mark valid,
    as the reference's do)."""
    return (ct.perm < scene.num_prims).view(ct.cols.shape[0], ct.K)


def compare_hits(what, t_k, b_k, t_r, b_r, prim_type):
    """Kernel (t, best) vs twin (t, best) on the CPU as numpy; best is -1
    on a miss. Fails on disagreement; returns max |dt| on lanes both
    hit."""
    import numpy as np
    v_k, v_r = b_k >= 0, b_r >= 0
    if (v_k == v_r).mean() < 0.999:
        fail(f"{what}: valid agreement {(v_k == v_r).mean()}")
    both = v_k & v_r
    if (b_k[both] == b_r[both]).mean() < 0.999:
        fail(f"{what}: index agreement {(b_k[both] == b_r[both]).mean()}")
    dt = np.abs(t_k - t_r)
    differ = both & (b_k != b_r)
    if (dt[differ] > 1e-5 * np.abs(t_r[differ])).any():
        fail(f"{what}: winners differ on lanes that are not near ties")
    sph = both & (prim_type[np.maximum(b_r, 0)] == 1)
    tri = both & ~sph
    if (dt[tri] > 1e-5 * np.abs(t_r[tri])).any():
        fail(f"{what}: triangle t beyond rtol 1e-5: {dt[tri].max()}")
    if (dt[sph] > 1e-5 * np.abs(t_r[sph]) + 2e-4).any():
        fail(f"{what}: sphere t beyond rtol 1e-5 + atol 2e-4: "
             f"{dt[sph].max()}")
    return float(dt[both].max()) if both.any() else 0.0


@contextlib.contextmanager
def environ(env):
    """Set the environment variables ``env`` inside the block; restore them
    after it."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def check_image(name, img_np, shape, lo, hi):
    import numpy as np
    if img_np.shape != shape:
        fail(f"{name}: image shape {img_np.shape}, expected {shape}")
    if not np.isfinite(img_np).all():
        fail(f"{name}: non-finite pixels")
    mean = float(img_np.mean())
    if not lo <= mean <= hi:
        fail(f"{name}: image mean {mean} outside the sane range "
             f"[{lo}, {hi}]")
    return mean


def main() -> int:
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU, nothing to test")
    sys.path.insert(0, HERE)
    try:
        from pathtracer_tpu_torch.ops import (_cuda_build, cluster_sweep,
                                              pallas_sweep)
    except ImportError as e:
        fail(f"the port is not next to chip_smoke.py ({e})")
    import numpy as np

    from pathtracer_tpu_torch import __main__ as cli
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN, RenderConfig
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.core.camera import get_rays
    from pathtracer_tpu_torch.io.png import write_png
    from pathtracer_tpu_torch.ops import intersect, tensor_sweep
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.presets import combined_scene, get_preset
    from pathtracer_tpu_torch.render import lights
    from pathtracer_tpu_torch.render.renderer import (CLUSTER_K,
                                                      make_renderer)
    from pathtracer_tpu_torch.scene import materials
    from pathtracer_tpu_torch.scene.worlds import get_world

    # 1. device
    dev = torch.device(DEVICE)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build, every source at once
    kernels = ("cluster_march", "dense_sweep", "window_sweep")
    t0 = time.perf_counter()
    _cuda_build.build_all(kernels)
    for name in kernels:
        _cuda_build.load(name)
    print(f"build: {', '.join(k + '.cu' for k in kernels)} in "
          f"{time.perf_counter() - t0:.3f} s (parallel nvcc)")
    for name in kernels:
        for line in _cuda_build.BUILD_LOGS.get(name, "").splitlines():
            if "ptxas" in line:
                print(f"  {name}: {line.strip()}")

    def camera_wavefront(cam, n, seed):
        u = prng.uniform(prng.fold_in(prng.PRNGKey(seed), 1), (4, n), dev)
        o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3],
                           torch.zeros(n, device=dev))
        return o, d

    # 3a. the cluster march against its twin
    scene, cam = get_world("bunny", device=dev)
    ct = build_cluster_tables(scene, K=CLUSTER_K)
    prim_type = ct.scene.prim_type.cpu().numpy()
    key = prng.PRNGKey(0)
    o_cam, d_cam = camera_wavefront(cam, RAYS, 0)
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

    march_err = 0.0
    march = {}
    for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_b, d_b)):
        q = cluster_sweep.march_inputs(ct, o, d, T_MIN)
        args = q["args"]
        kernel = cluster_sweep.march(*args)
        torch.cuda.synchronize()
        twin = cluster_sweep.march_reference(*args)
        t_k, b_k, s_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r, s_r = (x.cpu().numpy() for x in twin)
        march_err = max(march_err, compare_hits(
            f"march {name}", t_k, b_k, t_r, b_r, prim_type))
        tot_k, tot_r = int(s_k.sum()), int(s_r.sum())
        if abs(tot_k - tot_r) > 0.001 * max(tot_r, 1):
            fail(f"march {name}: slots marched differ: kernel {tot_k}, "
                 f"twin {tot_r}")
        # executed pairs: each chunk's first `slots` clusters x its lanes,
        # by the prim types of each cluster's real rows (the padding rows
        # that fill the last cluster are swept, but the function needs none)
        ids, slots = args[3], kernel[2]
        live_rows = real_rows(ct, scene)
        sph_rows = (args[6] != 0) | (args[8] == 1)[:, None]
        n_sph_c = (live_rows & sph_rows).sum(1).double()
        n_tri_c = (live_rows & ~sph_rows).sum(1).double()
        marched = (torch.arange(ids.shape[1], device=dev)[None, :]
                   < slots[:, None].long())
        c = ids.long().clamp(0, n_sph_c.shape[0] - 1)
        lanes = args[12]
        ops = lanes * float((marched * (OPS_SPHERE_PAIR * n_sph_c[c]
                                        + OPS_TRI_PAIR * n_tri_c[c])).sum())
        b_ms, b_by = bound(nbytes(*args[:9], *kernel), ops)
        ms = cuda_ms(lambda: cluster_sweep.march(*args), torch)
        plain_ms = cuda_ms(lambda: cluster_sweep.march_reference(*args),
                           torch)
        march[name] = (ms, plain_ms, b_ms, b_by)
        print(f"march {name} wavefront ({RAYS} rays, {tot_k} slots kernel /"
              f" {tot_r} twin, max |dt| {march_err:.3g}): kernel {ms:.4f} "
              f"ms, plain twin {plain_ms:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}, {ops / 1e9:.4f} GFLOP) [{card}]")

    # 3b. the dense sweep against its twin, and the tensor route
    tri_scene, tri_cam = get_world("triangle", device=dev)
    cor_scene, cor_cam, _ = get_preset("cornell-full", device=dev)
    o_c, d_c = camera_wavefront(cor_cam, CORNELL_RAYS, 2)
    cor_tables = tensor_sweep.pack_sweep_tables(
        cor_scene, tile=pallas_sweep.DEF_PRIM_TILE)
    idx, _, valid = pallas_sweep.pallas_closest(cor_tables, o_c, d_c, T_MIN)
    rec = intersect.hit_records_from_prims(cor_scene, idx, o_c, d_c, T_MIN,
                                           intersect.BIG_T, valid)
    u_l = prng.uniform(prng.fold_in(prng.PRNGKey(3), 1), (CORNELL_RAYS, 3),
                       dev)
    point, _, _, _ = lights.sample_lights(cor_scene, u_l)
    o_s = rec.p + T_MIN * rec.normal
    d_s = torch.where(valid[:, None], point - o_s, 0.0)
    o_t, d_t = camera_wavefront(tri_cam, TRI_RAYS, 1)
    sweep_err = 0.0
    sweep = {}
    for name, sc_, o, d, t_min in (
            ("triangle camera", tri_scene, o_t, d_t, T_MIN),
            ("cornell-full camera", cor_scene, o_c, d_c, T_MIN),
            ("cornell-full shadow", cor_scene, o_s, d_s, K_SHADOW_T_MIN)):
        tables = tensor_sweep.pack_sweep_tables(
            sc_, tile=pallas_sweep.DEF_PRIM_TILE)
        kt = pallas_sweep.kernel_tables(tables)
        args = pallas_sweep.sweep_inputs(kt, o, d, t_min)
        kernel = pallas_sweep.sweep(*args)
        torch.cuda.synchronize()
        twin = pallas_sweep.sweep_reference(*args)
        t_k, b_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r = (x.cpu().numpy() for x in twin)
        err = compare_hits(f"sweep {name}", t_k, b_k, t_r, b_r,
                           sc_.prim_type.cpu().numpy())
        sweep_err = max(sweep_err, err)
        n_sph = int((sc_.prim_type == 1).sum())
        n_tri = sc_.num_prims - n_sph
        r = o.shape[0]
        ops = r * float(OPS_SPHERE_PAIR * n_sph + OPS_TRI_PAIR * n_tri)
        b_ms, b_by = bound(nbytes(*args[:5], *kernel), ops)
        ms = cuda_ms(lambda: pallas_sweep.sweep(*args), torch)
        plain_ms = cuda_ms(lambda: pallas_sweep.sweep_reference(*args),
                           torch)
        tensor_ms = cuda_ms(lambda: tensor_sweep.tensor_closest(
            tables, o, d, t_min, intersect.BIG_T), torch)
        sweep[name] = (ms, plain_ms, b_ms, b_by, tensor_ms)
        print(f"sweep {name} wavefront ({r} rays x {sc_.num_prims} prims, "
              f"tile {tables.tile}, t_min {t_min:g}, {int((b_k >= 0).sum())}"
              f" hits, max |dt| {err:.3g}): kernel {ms:.4f} ms, plain twin "
              f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{ops / 1e9:.4f} GFLOP); tensor route (auto) {tensor_ms:.4f}"
              f" ms [{card}]")

    # 3c. the window sweep (rounds strategy, K=128) against its twin, on the
    # launches of one rounds query of the bunny camera wavefront
    ct128 = build_cluster_tables(scene, K=ROUNDS_K)
    prim128 = ct128.scene.prim_type.cpu().numpy()
    with mock.patch.object(cluster_sweep, "window_sweep",
                           wraps=cluster_sweep.window_sweep) as spy:
        cluster_sweep.cluster_closest(ct128, o_cam, d_cam, T_MIN)
    captured = [call.args for call in spy.call_args_list]
    if len(captured) < 2 or captured[0][8] != 1 or captured[1][8] != 4:
        fail(f"rounds query: expected a W=1 residual pass and a W=4 round, "
             f"got widths {[c[8] for c in captured]}")
    res_args = captured[0]
    n_chunks = res_args[2].shape[0]
    zeros = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    fb_args = res_args[:2] + (zeros, zeros) + res_args[4:8] + (
        ct128.C_reg,) + res_args[9:]
    C_tot = ct128.cols.shape[0]
    real128 = real_rows(ct128, scene)
    sph128 = ct128.is_sphere.view(C_tot, ROUNDS_K) != 0
    ops_cluster = (OPS_SPHERE_PAIR * (real128 & sph128).sum(1)
                   + OPS_TRI_PAIR * (real128 & ~sph128).sum(1)).double()
    window_err = 0.0
    window = {}
    for name, args in (("residual", res_args), ("round 1", captured[1]),
                       ("fallback", fb_args)):
        kernel = cluster_sweep.window_sweep(*args)
        torch.cuda.synchronize()
        twin = cluster_sweep.window_reference(*args)
        t_k, b_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r = (x.cpu().numpy() for x in twin)
        err = compare_hits(f"window {name}", t_k, b_k, t_r, b_r, prim128)
        if not (np.array_equal(b_k, b_r) and np.array_equal(t_k, t_r)):
            fail(f"window {name}: kernel and twin are not bit-equal")
        window_err = max(window_err, err)
        # operations: every swept chunk's W clusters, each real prim by its
        # type
        starts, skips, W = args[2], args[3], args[8]
        swept = skips == 0
        c = (starts[swept].long()[:, None]
             + torch.arange(W, device=dev)[None, :])
        ops = args[10] * float(ops_cluster[c].sum())
        b_ms, b_by = bound(nbytes(*args[:7], *kernel), ops)
        ms = cuda_ms(lambda: cluster_sweep.window_sweep(*args), torch)
        plain_ms = cuda_ms(lambda: cluster_sweep.window_reference(*args),
                           torch)
        window[name] = (ms, plain_ms, b_ms, b_by)
        print(f"window {name} (W={W}, {int(swept.sum())} of {n_chunks} "
              f"chunks swept, {int((b_k >= 0).sum())} hits, max |dt| "
              f"{err:.3g}): kernel {ms:.4f} ms, plain twin {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}, {ops / 1e9:.4f} GFLOP) [{card}]")

    # 4. the main paths through the CLI's code path
    def run_cli(argv, out_png, env=None):
        args = cli.build_parser().parse_args(
            argv + ["--device", DEVICE, "-o", out_png])
        with environ(env or {}):
            cluster_sweep.MARCH_LAUNCHES = 0
            cluster_sweep.WINDOW_LAUNCHES = 0
            pallas_sweep.SWEEP_LAUNCHES = 0
            img, seconds, cfg, stats = cli.render_cli(args)
            counts = (cluster_sweep.MARCH_LAUNCHES,
                      pallas_sweep.SWEEP_LAUNCHES,
                      cluster_sweep.WINDOW_LAUNCHES)
        img_np = img.numpy()
        os.makedirs(os.path.dirname(out_png), exist_ok=True)
        write_png(out_png, img_np)
        return img_np, seconds, cfg, stats, counts

    def report(name, seconds, cfg, stats, counts, mean):
        n_queries, n_shadow, n_pairs = stats
        nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
        print(f"render {name} {cfg.width}x{cfg.height} {cfg.spp} spp depth "
              f"{cfg.max_depth}, accel {cfg.accel}, chunk {cfg.ray_chunk}"
              f"{', nee' if cfg.nee else ''}: {seconds:.4f} s wall, "
              f"{nominal / seconds / 1e6:.4f} Mrays/s nominal, "
              f"{n_queries / seconds / 1e6:.4f} Mrays/s executed, "
              f"{n_shadow:.0f} shadow rays, {counts[0]} march launches, "
              f"{counts[1]} sweep launches, {counts[2]} window launches, "
              f"{n_pairs:.0f} march pair tests,"
              f" image mean {mean:.5f} [{card}]")

    out = os.path.join(HERE, "out")
    bunny_argv = ["--scene", "bunny", "--width", "640", "--height", "360",
                  "--spp", "8", "--max-depth", "4", "--ray-chunk", str(RAYS)]
    img_np, seconds, cfg, stats, counts = run_cli(
        bunny_argv, os.path.join(out, "chip_smoke_bunny.png"))
    march_launches = counts[0]
    if march_launches <= 0 or counts[2] != 0:
        fail(f"the bunny path launched {counts[0]} march and {counts[2]} "
             f"window kernels")
    mean = check_image("bunny", img_np, (360, 640, 3), 0.3, 0.95)
    report("bunny", seconds, cfg, stats, counts, mean)
    march_img = img_np

    img_np, seconds, cfg, stats, counts = run_cli(
        ["--preset", "cornell-full", "--accel", "pallas", "--ray-chunk",
         str(CORNELL_RAYS)], os.path.join(out, "chip_smoke_cornell.png"))
    sweep_launches = counts[1]
    if sweep_launches <= 0:
        fail("the cornell-full path launched no dense sweep kernel")
    if (cfg.width, cfg.height, cfg.spp, cfg.max_depth) != (256, 256, 64, 4) \
            or not (cfg.nee and cfg.stratify) or stats[1] <= 0:
        fail(f"cornell-full ran {cfg} with {stats[1]} shadow rays")
    mean = check_image("cornell-full", img_np, (256, 256, 3), 0.05, 0.9)
    report("cornell-full", seconds, cfg, stats, counts, mean)

    img_np, seconds, cfg, stats, counts = run_cli(
        ["--scene", "triangle", "--width", "800", "--height", "450",
         "--spp", str(TRIANGLE_SPP), "--max-depth", "50", "--accel",
         "pallas", "--ray-chunk", str(TRI_RAYS)],
        os.path.join(out, "chip_smoke_triangle.png"))
    if counts[1] <= 0:
        fail("the triangle path launched no dense sweep kernel")
    mean = check_image("triangle", img_np, (450, 800, 3), 0.1, 0.95)
    report("triangle", seconds, cfg, stats, counts, mean)

    # the rounds strategy: a cross-check route of the march, not a target
    img_np, seconds, cfg, stats, counts = run_cli(
        bunny_argv, os.path.join(out, "chip_smoke_bunny_rounds.png"),
        env=ROUNDS_ENV)
    window_launches = counts[2]
    if window_launches <= 0 or counts[0] != 0:
        fail(f"the rounds bunny path launched {counts[2]} window and "
             f"{counts[0]} march kernels")
    mean = check_image("bunny (rounds)", img_np, (360, 640, 3), 0.3, 0.95)
    report("bunny (rounds)", seconds, cfg, stats, counts, mean)
    diff = np.abs(img_np - march_img)
    close = float((diff <= 1e-4).mean())
    print(f"bunny rounds vs march image: {close:.5f} of channels within "
          f"1e-4, mean |diff| {diff.mean():.3g}")
    if close < 0.99 or diff.mean() > 1e-3:
        fail("the rounds bunny image disagrees with the march bunny image")

    # 5. small renders: card vs CPU twins
    def card_vs_cpu(name, make, cfg, lo, env=None):
        with environ(env or {}):
            scene_g, cam_g = make(dev)
            g = make_renderer(cfg, dev)(scene_g, cam_g).cpu().numpy()
            scene_c, cam_c = make("cpu")
            c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
        diff = np.abs(g - c)
        close = float((diff <= 1e-4).mean())
        print(f"small render {name} card vs CPU twins: {close:.5f} of "
              f"channels within 1e-4, mean |diff| {diff.mean():.3g}, image "
              f"mean {g.mean():.5f}")
        if not np.isfinite(g).all() or g.mean() < lo:
            fail(f"{name}: card render is not finite or is dark")
        if close < 0.99 or diff.mean() > 1e-3:
            fail(f"{name}: card render disagrees with the CPU render")

    card_vs_cpu("bunny", lambda d: get_world("bunny", device=d),
                RenderConfig(width=64, height=36, spp=2, max_depth=3,
                             ray_chunk=64 * 36, accel="cluster",
                             scene="bunny", seed=5), 0.3)
    _, _, cor_cfg = get_preset("cornell-full", device="cpu")
    card_vs_cpu("cornell-full (pallas, NEE)",
                lambda d: get_preset("cornell-full", device=d)[:2],
                cor_cfg.replace(width=32, height=32, spp=4, max_depth=3,
                                ray_chunk=1024, accel="pallas", seed=3),
                0.05)
    card_vs_cpu("bunny in the Cornell room (cluster, NEE)",
                lambda d: combined_scene(device=d),
                RenderConfig(width=32, height=18, spp=1, max_depth=3,
                             ray_chunk=576, accel="cluster", sky=False,
                             nee=True, scene="combined", seed=2), 0.05)
    cluster_sweep.WINDOW_LAUNCHES = 0
    card_vs_cpu("bunny (rounds, Sobol, Russian roulette, black termination)",
                lambda d: get_world("bunny", device=d),
                RenderConfig(width=64, height=36, spp=2, max_depth=3,
                             ray_chunk=64 * 36, accel="cluster",
                             scene="bunny", seed=5, sampler="sobol", rr=True,
                             rr_depth=1, terminate_black=True), 0.2,
                env=ROUNDS_ENV)
    if cluster_sweep.WINDOW_LAUNCHES <= 0:
        fail("the small rounds render launched no window kernel")

    k2 = sweep["cornell-full camera"]
    k3 = window["round 1"]
    print(json.dumps({"kernels": [{
        "name": "cluster_march", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/cluster_march.cu",
        "replaces": "pathtracer_tpu/ops/cluster_sweep.py:446",
        "launches": march_launches, "max_abs_err": march_err,
        "ms": march["camera"][0], "plain_ms": march["camera"][1],
        "bound_ms": march["camera"][2], "bound_by": march["camera"][3],
        "library_ms": None}, {
        "name": "dense_sweep", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "pathtracer_tpu/ops/pallas_sweep.py:41",
        "launches": sweep_launches, "max_abs_err": sweep_err,
        "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2],
        "bound_by": k2[3], "library_ms": None}, {
        "name": "window_sweep", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/window_sweep.cu",
        "replaces": "pathtracer_tpu/ops/cluster_sweep.py:66",
        "launches": window_launches, "max_abs_err": window_err,
        "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[2],
        "bound_by": k3[3], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
