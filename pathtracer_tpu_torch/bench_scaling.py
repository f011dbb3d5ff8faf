"""Multi-device scaling bench and its one-device proxy (the port of the
repository's root ``bench_scaling.py``).

Default mode: for n = 1, 2, 4, ... up to the CUDA devices present (or
``--devices``), the sharded renderer (``parallel/``) over a mesh of the
first n cards, timed as ``bench.py`` times a render (a warm-up at
``--seed``, then ``--iters`` renders, host clock around synchronised
work); one JSON line per n: ``metric`` "scaling", ``devices``, ``value``
(nominal Mrays/s), ``efficiency`` against n = 1, the executed queries,
each kernel's launches over the timed renders and the ``device`` stamp.
On a machine with one card only n = 1 runs, and the bench says so on an
earlier line: slots of one card are not a mesh of cards. In one process
the slots of several cards render in turn; one process per card
(``parallel.initialize_distributed``) is the form that overlaps them.
Unlike the JAX bench it takes ``--ray-chunk`` (default the bench's
57,600), so its n = 1 line is the bench's render on a 1x1 mesh.

``--proxy``: the multi-device risk from one device, written to
``out/scaling_proxy_torch.json`` (``--out``) and printed as one line:

- compute imbalance: each of the mesh's rays slots renders its shard
  alone with stats (``render/renderer.render_sum`` on the shard's chunks,
  the plan of ``parallel/sharded._shard_plan``), for the contiguous
  layout and for the round-robin interleave the sharded renderer uses;
  ``imbalance_efficiency`` = mean / max executed queries (the slowest
  shard gates the frame). The per-shard counts must sum to the unsharded
  render's count (the same plan's chunks, one device); the proxy exits 1
  if they do not;
- collective traffic: the framebuffer bytes that a frame's one
  ``dist.all_reduce`` carries (``parallel/sharded.frame_all_reduce_bytes``:
  with no process group on a mesh of slots, computed from the plan, not
  counted on a wire), over NVLink 4's 450 GB/s each way (H100 SXM data
  sheet; assumed, not measured);
- the times, when the slots are on a card (null, "not measured", on the
  CPU): each interleaved shard rendered alone on its slot (after the
  contiguous pass has warmed the slot's renderer), the unsharded render
  at the plan's chunk, and the bench's render (``--ray-chunk``, default
  57,600) on the first slot's device after a warm-up, all timed in this
  run.

``projected_efficiency`` = frame / (n x (slowest shard + collective)):
one card's frame at the bench's chunk against n cards that each render
their shard at the plan's chunk, then reduce the frame. It takes in the
imbalance and the plan's smaller chunk (which costs a host-bound render
more per ray) through the measured shard times. A model, not a
measurement across cards. The slots default to ``cuda:0`` x 8, and the
proxy fails at once without a card; ``--proxy-devices`` takes
comma-separated devices, ``DEVxN`` for N slots of one (``cpux8`` runs
the plain twins: counts, no times; tests only).

Usage:
    python -m pathtracer_tpu_torch.bench_scaling             # n = 1, 2, ..
    python -m pathtracer_tpu_torch.bench_scaling --proxy
    # the CPU checks (plain twins; tiny sizes only, no times):
    python -m pathtracer_tpu_torch.bench_scaling --device cpu --scene test \\
        --accel brute --width 32 --height 16 --spp 1 --depth 2 --iters 1
    python -m pathtracer_tpu_torch.bench_scaling --proxy --scene test \\
        --accel brute --width 32 --height 16 --spp 1 --depth 2 \\
        --proxy-devices cpux8
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys
import time

from pathtracer_tpu_torch import bench

# H100 SXM NVLink 4: 900 GB/s per card in all, 450 GB/s each way (NVIDIA's
# data sheet); assumed, not measured
NVLINK_GBPS = 450.0
PROXY_SLOTS = 8
TARGET_EFFICIENCY = 0.85


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.bench_scaling",
        description="sharded-render scaling, or its one-device proxy")
    p.add_argument("--devices", type=int, nargs="*", default=None,
                   help="mesh sizes (default: 1, 2, 4, ... up to the CUDA "
                        "devices present)")
    p.add_argument("--width", type=int, default=640)
    p.add_argument("--height", type=int, default=360)
    p.add_argument("--spp", type=int, default=8)
    p.add_argument("--depth", type=int, default=4)
    p.add_argument("--scene", default="bunny")
    p.add_argument("--accel", default="auto",
                   choices=["auto", "cluster", "tensor", "pallas", "bvh",
                            "brute"])
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--ray-chunk", type=int, default=57600)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs n = 1 on the plain twins: counts, no "
                        "times (tests only)")
    p.add_argument("--proxy", action="store_true",
                   help="the one-device proxy (module docstring)")
    p.add_argument("--proxy-devices", default=None,
                   help="the proxy's slots: comma-separated devices, DEVxN "
                        "for N slots of one (default cuda:0x8; cpux8 runs "
                        "the plain twins, tests only)")
    p.add_argument("--out", default=os.path.join("out",
                                                 "scaling_proxy_torch.json"))
    return p


def proxy_slots(spec):
    """The proxy's slot devices from ``--proxy-devices`` (default
    ``cuda:0`` x PROXY_SLOTS, card or none: the CPU only when asked)."""
    import torch
    if spec is None:
        return [torch.device("cuda", 0)] * PROXY_SLOTS
    slots = []
    for item in spec.split(","):
        m = re.fullmatch(r"(.+?)x(\d+)", item.strip())
        name, n = (m.group(1), int(m.group(2))) if m else (item.strip(), 1)
        slots += [torch.device(name)] * n
    return slots


def require_card(devices) -> None:
    import torch
    if any(torch.device(d).type == "cuda" for d in devices) \
            and not torch.cuda.is_available():
        raise bench.NoCard("no CUDA device (torch.cuda.is_available() is "
                           "False); pass --device cpu or CPU proxy slots")


def run_scaling(args) -> list:
    """The default mode's lines, one per mesh size (module docstring)."""
    import torch

    from pathtracer_tpu_torch.parallel import make_mesh, make_sharded_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world

    on_card = args.device == "cuda"
    require_card([args.device])
    if on_card:
        n_avail = torch.cuda.device_count()
        cards = [torch.device("cuda", i) for i in range(n_avail)]
    else:
        n_avail, cards = 1, [torch.device("cpu")]
    sizes = args.devices
    if not sizes:
        sizes, n = [], 1
        while n <= n_avail:
            sizes.append(n)
            n *= 2
    if n_avail == 1:
        print(f"scaling: one {'CUDA device' if on_card else 'CPU'}: n = 1 "
              f"only (slots of one device are not a mesh of devices)",
              flush=True)
    cfg = bench.bench_config(args)
    scene, cam = get_world(args.scene, device=cards[0])
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    stamp = bench.device_stamp(on_card)
    lines, first = [], None
    for n in sizes:
        if n > n_avail:
            break
        devices = cards[:n]
        render = make_sharded_renderer(cfg, make_mesh(devices),
                                       with_stats=True)
        render.prepare(scene)
        _, stats, _, walls, launches = bench.time_renders(
            render, scene, cam, args.seed, args.iters, *devices)
        wall = sum(walls) / len(walls)
        value = nominal / wall / 1e6 if on_card else None
        if n == 1:
            first = value
        eff = (value / (first * n) if value is not None and first
               else None)
        lines.append({"metric": "scaling", "devices": n, "value": value,
                      "unit": "Mrays/s", "efficiency": eff,
                      "walls_s": walls if on_card else None,
                      "wall_s": wall if on_card else None,
                      "nominal_queries": nominal,
                      "executed_queries": int(stats[0]),
                      "launches": launches, "device": stamp})
        print(json.dumps(lines[-1]), flush=True)
    return lines


def run_proxy(args) -> dict:
    """The proxy's record (module docstring); written to ``args.out``."""
    import torch

    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.parallel import make_mesh
    from pathtracer_tpu_torch.parallel import sharded as sharded_mod
    from pathtracer_tpu_torch.render import renderer as renderer_mod
    from pathtracer_tpu_torch.scene.worlds import get_world

    slots = proxy_slots(args.proxy_devices)
    require_card(slots)
    n_dev = len(slots)
    cfg = bench.bench_config(args).replace(
        ray_chunk=args.width * args.height // n_dev)
    mesh = make_mesh(slots)
    rays_size, _, _, per_dev, chunk = sharded_mod._shard_plan(cfg, mesh)
    cfg_c = cfg.replace(ray_chunk=chunk)
    per_dev_chunks = per_dev // chunk
    scene, cam = get_world(args.scene, device=slots[0])
    rows, cols = renderer_mod.padded_pixel_grid(cfg, per_dev * rays_size,
                                                "cpu")
    rows_c, cols_c = rows.view(-1, chunk), cols.view(-1, chunk)
    key = prng.PRNGKey(args.seed)
    renderers = {}

    def count(device, sel=None):
        """Executed closest-hit queries of the chunks ``sel`` (all when
        None) rendered alone on ``device``, and the render's seconds."""
        rnd = renderers.setdefault(
            device, renderer_mod.make_renderer(cfg_c, device))
        query = rnd.prepare(scene)
        rs, cs = (rows_c, cols_c) if sel is None else (rows_c[sel],
                                                       cols_c[sel])
        bench.sync(device)
        t0 = time.perf_counter()
        _, stats = renderer_mod.render_sum(
            query.scene, cam.to(device), key, rs.reshape(-1).to(device),
            cs.reshape(-1).to(device), cfg_c, cfg.spp, query)
        bench.sync(device)
        return int(stats[0]), time.perf_counter() - t0

    def shard_counts(interleave: bool):
        """Each rays slot's executed queries and seconds, its shard
        rendered alone on its device."""
        out, seconds = [], []
        for d in range(rays_size):
            if interleave:
                sel = [k * rays_size + d for k in range(per_dev_chunks)]
            else:
                sel = list(range(d * per_dev_chunks,
                                 (d + 1) * per_dev_chunks))
            n, s = count(slots[d], torch.tensor(sel))
            out.append(n)
            seconds.append(s)
        return out, seconds

    bench.reset_launch_counts()
    # the contiguous pass first: it warms each slot's renderer, so the
    # interleaved shards (the sharded renderer's layout) are timed warm
    counts_contig, _ = shard_counts(False)
    counts, shard_s = shard_counts(True)
    launches = bench.launch_counts()
    total, plan_frame_s = count(slots[0])
    on_card = slots[0].type == "cuda"
    frame_ms = plan_frame_ms = shard_ms = None
    if on_card:
        render = renderer_mod.make_renderer(cfg.replace(
            ray_chunk=args.ray_chunk), slots[0], with_stats=True)
        render.prepare(scene)
        bench.timed_render(render, scene, cam, args.seed, slots[0])
        frame_ms = bench.timed_render(render, scene, cam, args.seed + 1,
                                      slots[0])[2] * 1e3
        plan_frame_ms = plan_frame_s * 1e3
        shard_ms = max(shard_s) * 1e3

    def imbalance(c):
        return sum(c) / len(c) / max(c) if max(c) else 1.0

    coll = sharded_mod.frame_all_reduce_bytes(cfg, mesh)
    coll_ms = coll / (NVLINK_GBPS * 1e9) * 1e3
    # n cards each render their shard, then reduce the frame: the slowest
    # shard plus the collective, against one card's frame at the bench's
    # chunk (its best)
    mesh_frame_ms = shard_ms + coll_ms if on_card else None
    compute_fraction = shard_ms / mesh_frame_ms if on_card else None
    efficiency = (frame_ms / (n_dev * mesh_frame_ms) if on_card
                  else None)
    sums_match = sum(counts) == total == sum(counts_contig)
    out = {
        "model": "proxy (slots of one device); projected_efficiency = "
                 "single_device_frame_ms / (devices x projected_mesh_frame_"
                 "ms), projected_mesh_frame_ms = slowest_shard_ms + "
                 "collective_ms_projected: a model, not a measurement "
                 "across cards",
        "scene": args.scene,
        "config": {"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                   "depth": cfg.max_depth, "seed": args.seed,
                   "chunk": chunk, "chunks_per_slot": per_dev_chunks},
        "devices": n_dev, "slots": [str(d) for d in slots],
        "per_shard_executed_queries": counts,
        "per_shard_executed_queries_contiguous": counts_contig,
        "unsharded_executed_queries": total,
        "sums_match": sums_match,
        "imbalance_efficiency": imbalance(counts),
        "imbalance_efficiency_contiguous": imbalance(counts_contig),
        "collective_bytes_per_frame": {
            "all-reduce": coll, "total": coll,
            "how": "the framebuffer one dist.all_reduce carries a frame, "
                   "computed from the plan (no process group on a mesh of "
                   "slots): not counted on a wire"},
        "link_gbps_assumed": NVLINK_GBPS,
        "link": "NVLink 4, 450 GB/s each way (H100 SXM data sheet); "
                "assumed, not measured",
        "collective_ms_projected": coll_ms,
        "single_device_frame_ms": frame_ms,
        "plan_chunk_frame_ms": plan_frame_ms,
        "shard_ms": ([x * 1e3 for x in shard_s] if on_card else None),
        "slowest_shard_ms": shard_ms,
        "projected_mesh_frame_ms": mesh_frame_ms,
        "frame": (f"the bench's render ({args.ray_chunk}-ray chunks) and "
                  f"the unsharded render at the plan's {chunk}-ray chunks "
                  f"on {slots[0]}, timed in this run" if on_card
                  else "not measured (CPU slots)"),
        "compute_fraction": compute_fraction,
        "projected_efficiency": efficiency,
        "target": TARGET_EFFICIENCY,
        "launches": launches,
        "device": bench.device_stamp(on_card),
    }
    out_dir = os.path.dirname(args.out)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.proxy:
            return 0 if run_proxy(args)["sums_match"] else 1
        run_scaling(args)
    except bench.NoCard as e:
        print(f"bench_scaling: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
