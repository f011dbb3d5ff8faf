"""Prim-count scaling of the closest-hit query: the cluster march against
the dense sweep, per query.

Times raw closest-hit queries of one camera-like wavefront on growing
scenes: a jittered-grid sphere cloud of ``--sizes`` spheres, or with
``--bunny`` the bunny subdivided ``--sizes`` levels (0 -> 3,619 prims, 1
-> 14,467, 2 -> 57,859, 3 -> 231,427, 4 -> 925,699; the same surface at
every level). Per size it prints the march (``accel="cluster"``, the CUDA
march kernel) for every ``--k``, ``--cull`` and ``--sup`` asked for, with
its table build and the peak device memory of one query; the dense sweep
(``accel="pallas"``, the CUDA dense kernel); the ``tensor`` route (dense
float32 matrix products over prim tiles) while one size's queries stay
within a minute; and the share of lanes whose valid
flag agrees between each march and the dense sweep. The dense sweep is
O(R x N); the march should grow far slower.

Times are medians over ``--iters`` queries after a warm-up, with CUDA
events on the card (host clock on the CPU, where the plain twins run and
no time means anything for the card).

Usage (on a machine with an NVIDIA GPU):
    python -m pathtracer_tpu_torch.tools.bench_prim_scaling --bunny \\
        --sizes 0,1,2,3,4 --k 64,128 --cull flat,cull2
    # the CPU check (plain twins; tiny sizes only):
    python -m pathtracer_tpu_torch.tools.bench_prim_scaling --device cpu \\
        --sizes 300 --rays 256 --iters 1
"""
from __future__ import annotations

import argparse
import statistics
import sys
import time

CULLS = {"auto": None, "flat": False, "cull2": True}
# seconds one size's tensor-route queries (warm-up and timed) may take;
# larger sizes skip the tensor route after a size that took longer
TENSOR_BUDGET_S = 60.0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.tools.bench_prim_scaling",
        description="closest-hit query time against scene size")
    p.add_argument("--sizes", default="5000,20000,45000",
                   help="sphere counts, or with --bunny subdivision levels")
    p.add_argument("--rays", type=int, default=57600)
    p.add_argument("--iters", type=int, default=4)
    p.add_argument("--bunny", action="store_true",
                   help="--sizes are 4:1 subdivision levels of the bunny "
                        "(default 0,1,2,3)")
    p.add_argument("--k", default="64",
                   help="cluster sizes K of the march, comma-separated")
    p.add_argument("--cull", default="auto",
                   help="cull plans of the march, comma-separated: auto "
                        "(the renderer's rule), flat, cull2")
    p.add_argument("--sup", default="auto",
                   help="clusters per supercluster, comma-separated: auto "
                        "(the plan's rule) or counts; a count above 1 "
                        "under the flat cull is the flat supercluster "
                        "expansion")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins (tests only)")
    return p


def sphere_cloud(n: int, device):
    """n spheres on a jittered grid in [-10, 10]^3 (numpy, host)."""
    import numpy as np

    from pathtracer_tpu_torch.scene.scene import (PRIM_SPHERE,
                                                  scene_from_numpy)
    rng = np.random.default_rng(7)
    m = int(np.ceil(n ** (1.0 / 3.0)))
    g = (np.stack(np.meshgrid(*[np.arange(m)] * 3, indexing="ij"),
                  axis=-1).reshape(-1, 3)[:n]).astype(np.float32)
    spacing = 20.0 / m
    centers = ((g + 0.5 + 0.35 * rng.standard_normal((n, 3))) * spacing
               - 10.0).astype(np.float32)
    radius = (0.25 * spacing) * np.ones(n, np.float32)
    zeros3 = np.zeros((n, 3), np.float32)
    bmin = centers - radius[:, None]
    bmax = centers + radius[:, None]
    return scene_from_numpy(dict(
        prim_type=np.full((n,), PRIM_SPHERE, np.int32), v0=centers,
        e1=zeros3, e2=zeros3, radius=radius, tri_normal=zeros3,
        prim_mat=np.zeros((n,), np.int32), box_min=bmin, box_max=bmax,
        mat_type=np.zeros((1,), np.int32),
        albedo=np.full((1, 3), 0.5, np.float32),
        fuzz=np.zeros((1,), np.float32), ir=np.zeros((1,), np.float32),
        emit=np.zeros((1, 3), np.float32),
        tex_id=np.full((1,), -1, np.int32), world_min=bmin.min(axis=0),
        world_max=bmax.max(axis=0), light_idx=np.zeros((0,), np.int32),
        textures=np.zeros((0, 8, 8, 3), np.float32)), device)


def wavefront(n: int, bunny: bool, device):
    """A camera-like wavefront: origins on a plane behind the scene,
    directions at uniform targets inside it (coherent like primary rays);
    for the bunny, aimed into its box from the bunny camera's side."""
    import torch

    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import uniforms
    u = uniforms.uniform(prng.PRNGKey(1), (n, 3), device)
    if bunny:
        tgt = torch.stack([u[:, 0] * 5.0 - 2.5, u[:, 1] * 5.0,
                           u[:, 2] * 4.0 - 2.0], dim=1)
        org = torch.stack([tgt[:, 0] * 0.2, tgt[:, 1] * 0.2 + 3.0,
                           torch.full((n,), 9.0, device=device)], dim=1)
    else:
        tgt = u * 20.0 - 10.0
        org = torch.stack([tgt[:, 0] * 0.2, tgt[:, 1] * 0.2,
                           torch.full((n,), -30.0, device=device)], dim=1)
    return org, tgt - org


class Clock:
    """Median milliseconds of a call after one warm-up: CUDA events on the
    card, the host clock on the CPU."""

    def __init__(self, device, iters: int):
        import torch
        self.torch = torch
        self.cuda = device.type == "cuda"
        self.iters = iters

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        self.sync()
        times = []
        for _ in range(self.iters):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn()
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
            else:
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def seconds(self, fn):
        """(result, seconds) of one call, ended by a device sync."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0


def main(argv=None) -> int:
    p = build_parser()
    args = p.parse_args(argv)
    if args.bunny and args.sizes == p.get_default("sizes"):
        args.sizes = "0,1,2,3"
    sizes = [int(s) for s in args.sizes.split(",")]
    if args.bunny and max(sizes) > 6:
        p.error(f"--bunny sizes are subdivision levels (got {max(sizes)}; "
                f"level 6 is already 15M prims)")
    ks = [int(k) for k in args.k.split(",")]
    culls = args.cull.split(",")
    if not set(culls) <= set(CULLS):
        p.error(f"--cull takes {', '.join(CULLS)}")
    sups = [None if x == "auto" else int(x) for x in args.sup.split(",")]

    import torch

    from pathtracer_tpu_torch.ops.cluster_sweep import (
        make_cluster_closest_hit)
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.ops.pallas_sweep import make_pallas_closest_hit
    from pathtracer_tpu_torch.ops.tensor_sweep import make_tensor_closest_hit
    from pathtracer_tpu_torch.scene.bunny import bunny_world

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass --device cpu for the "
                               "plain twins")
        where = torch.cuda.get_device_name(0)
    else:
        where = "cpu (plain twins; host clock)"
    print(f"device: {where}; {args.rays} rays, median of {args.iters} "
          f"queries", flush=True)
    clock = Clock(device, args.iters)
    t_min = 1e-3
    o, d = wavefront(args.rays, args.bunny, device)
    tensor_on = True
    for size in sizes:
        if args.bunny:
            scene, scene_s = clock.seconds(
                lambda: bunny_world(subdivide=size, device=device)[0])
        else:
            scene, scene_s = clock.seconds(lambda: sphere_cloud(size,
                                                                device))
        n = scene.num_prims
        dense, pack_s = clock.seconds(
            lambda: make_pallas_closest_hit(scene, t_min))
        _, _, v_dense = dense(o, d)
        dense_ms = clock.ms(lambda: dense(o, d))
        if tensor_on:
            tensor = make_tensor_closest_hit(scene, t_min)
            t0 = time.perf_counter()
            tensor_ms = clock.ms(lambda: tensor(o, d))
            tensor_s = time.perf_counter() - t0
            tensor_text = f"tensor {tensor_ms:.3f} ms/query"
            tensor_on = tensor_s <= TENSOR_BUDGET_S
            del tensor
        else:
            tensor_text = "tensor not timed (over its budget at a smaller " \
                          "size)"
        print(f"N={n}: scene build {scene_s:.3f} s, dense tables "
              f"{pack_s:.3f} s; dense (K2) {dense_ms:.3f} ms/query, "
              f"{tensor_text}", flush=True)
        for K in ks:
            ct, table_s = clock.seconds(
                lambda: build_cluster_tables(scene, K=K))
            for cull, sup_arg in ((c, x) for c in culls for x in sups):
                march = make_cluster_closest_hit(ct, t_min,
                                                 cull2=CULLS[cull],
                                                 sup=sup_arg)
                cull2, sup = march.cull_plan
                if clock.cuda:
                    torch.cuda.synchronize()
                    torch.cuda.reset_peak_memory_stats()
                    base = torch.cuda.memory_allocated()
                _, _, v = march(o, d)
                clock.sync()
                peak = (f"{(torch.cuda.max_memory_allocated() - base) / 2**20:.1f}"
                        f" MiB" if clock.cuda else "not measured")
                agree = float((v == v_dense).float().mean())
                ms = clock.ms(lambda: march(o, d))
                print(f"  K={K} C_reg={ct.C_reg} cull {cull} ("
                      f"{'cull2' if cull2 else 'flat'}, sup {sup}): table "
                      f"build {table_s:.3f} s; march {ms:.3f} ms/query, "
                      f"ratio dense/march {dense_ms / max(ms, 1e-9):.2f}x, "
                      f"query peak memory {peak}, valid-agree {agree:.4f}",
                      flush=True)
            del ct
        del scene, dense
    return 0


if __name__ == "__main__":
    sys.exit(main())
