"""Benchmark: forward path-tracing throughput of one render configuration,
on the card (the port of the repository's root ``bench.py``).

Prints ONE JSON line with the JAX bench's schema-2 keys: ``metric``
(``{scene}[_sub{k}]_forward_throughput``), ``value`` (nominal Mrays/s:
pixels x spp x depth over the mean wall), ``unit``, ``vs_baseline``
(null: the JAX bench's baseline was a TPU chip's), ``accel`` (the route
taken on the device, ``config.route_accel``), ``prims``,
``nominal_queries``, ``schema``, ``executed_queries`` and
``shadow_queries`` (closest-hit and NEE shadow queries made, from the
renderer's stats), ``executed_mrays_per_s``, ``pair_tests`` and
``march_tflops``; and the port's own: ``march_mfu``, ``device`` (the
card's name, power limit, SM clock, temperature and count), ``walls_s``
(each timed render) and ``wall_s`` (their mean), ``setup_s`` (scene,
tables and kernel build, kept out of the walls), ``warmup_s``,
``peak_mem_mib`` (``torch.cuda.max_memory_allocated`` over the timed
renders), ``launches`` (each kernel wrapper's launches over the timed
renders, its counter reset just before them), ``env`` (the
``PT_CLUSTER_*`` knobs that are set: a line from another cluster plan is
marked as such), ``correct`` and ``check``.

Timing: a warm-up render at ``--seed`` builds the kernels' inputs, then
``--iters`` renders at seeds ``seed + 1 ..``, each timed on the host clock
around work that ends in ``torch.cuda.synchronize()``; the renderer's
stats are host numbers by then. The counts are those of the last render,
as in the JAX bench.

``pair_tests`` is the port's count: the cluster slots each chunk really
marched x K x ray_tile (``ops/cluster_sweep.cluster_march``). The JAX
bench counts every slot of every window it marched, padding included, so
its figure is larger on the same render (on the bunny at 32x16, depth 3:
1,441,792 against the port's 1,253,376); the two are not comparable.
``march_tflops`` = pair_tests x OPS_TRI_PAIR / mean wall is an upper
count (every pair taken as a triangle's full test, ``utils/metrics``);
``march_mfu`` is that over the H100's float32 peak, null off an H100.
``suspect`` is set when ``march_mfu`` > 1, which no card can give.

Correctness (PERF.md §2): after the timed renders the same scene, accel
and depth render at 64x36, 2 spp on the device and on the CPU twins;
``correct`` is true when >= 99% of channels agree within 1e-4, the mean
|diff| is <= 1e-3 and the full-size image is finite. When it is false the
line still prints and the bench exits 1.

The measured body runs in a child process under a deadline
(``PT_BENCH_BUDGET_S``, default 1500 s), with SIGTERM and SIGINT trapped.
On a deadline, a signal, or a child that prints no JSON line, the bench
prints one line with ``"value": null`` and an ``error``, and exits 1: it
never prints a number it did not measure in that run. With no card it
fails at once unless given ``--device cpu``, where it runs the plain
twins and prints the counts and ``correct`` with every rate and time
null (checks, no times). ``PT_BENCH_FAKE=sleep:S`` makes the child sleep
S seconds and print nothing (a test hook for the deadline).

Usage:
    python -m pathtracer_tpu_torch.bench     # the bunny, 640x360, 8 spp
    python -m pathtracer_tpu_torch.bench --scene cornell --width 256 \\
        --height 256 --spp 16 --accel pallas
    # the CPU check (plain twins; tiny sizes only):
    python -m pathtracer_tpu_torch.bench --device cpu --scene test \\
        --accel brute --width 32 --height 16 --spp 1 --depth 2 --iters 1 \\
        --ray-chunk 512
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNELS = ("cluster_march", "dense_sweep", "window_sweep", "ray_uniforms",
           "bvh_traverse")
# the correctness check's render: the bench's scene, accel and depth at
# this size and spp, on the device and on the CPU twins
CHECK_WIDTH, CHECK_HEIGHT, CHECK_SPP = 64, 36, 2
CHECK_CLOSE, CHECK_MEAN = 1e-4, 1e-3


class NoCard(RuntimeError):
    """``--device cuda`` and no CUDA device."""


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer_tpu_torch.bench",
        description="forward path-tracing throughput, one JSON line")
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
    p.add_argument("--subdivide", type=int, default=0,
                   help="bunny only: 4:1 subdivision levels (2 -> 57,859 "
                        "prims)")
    p.add_argument("--seed", type=int, default=0,
                   help="the warm-up render's seed; timed renders take "
                        "the next --iters seeds")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs the plain twins: counts and the check, "
                        "no times (tests only)")
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    return p


def scene_kwargs(args) -> dict:
    return ({"subdivide": args.subdivide}
            if args.subdivide and args.scene == "bunny" else {})


def metric_name(args) -> str:
    scene = (f"{args.scene}_sub{args.subdivide}" if scene_kwargs(args)
             else args.scene)
    return f"{scene}_forward_throughput"


def bench_config(args):
    """The render configuration of the arguments. As the CLI does, cornell
    and the combined scene are emissive-lit: no sky, NEE on."""
    from pathtracer_tpu_torch.config import RenderConfig
    lit = args.scene in ("cornell", "combined")
    return RenderConfig(width=args.width, height=args.height, spp=args.spp,
                        max_depth=args.depth, accel=args.accel,
                        ray_chunk=args.ray_chunk, scene=args.scene,
                        seed=args.seed, sky=not lit, nee=lit)


def null_line(args, reason: str) -> dict:
    """The line of a run that measured nothing."""
    return {"metric": metric_name(args), "value": None, "unit": "Mrays/s",
            "vs_baseline": None, "schema": 2, "error": reason}


def emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def sync(*devices) -> None:
    """Wait for the work queued on each CUDA device among ``devices``."""
    import torch
    for device in devices:
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)


def timed_render(render, scene, cam, seed, *devices):
    """(image, stats, seconds) of ``render(scene, cam, seed)`` with stats,
    timed on the host clock from synchronised ``devices`` to the end of
    their work."""
    sync(*devices)
    t0 = time.perf_counter()
    img, stats = render(scene, cam, seed)
    sync(*devices)
    return img, stats, time.perf_counter() - t0


def time_renders(render, scene, cam, seed, iters, *devices):
    """The timed renders of a bench: a warm-up render at ``seed``, then
    ``iters`` renders at ``seed + 1 ..``, each timed by
    :func:`timed_render`, with the launch counters reset just before them
    and each CUDA device's peak memory statistics too. Returns (the last
    image, its stats, the warm-up's seconds, the walls, each kernel's
    launches over the timed renders)."""
    import torch
    warmup_s = timed_render(render, scene, cam, seed, *devices)[2]
    for device in devices:
        if torch.device(device).type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    walls = []
    for i in range(iters):
        img, stats, seconds = timed_render(render, scene, cam,
                                           seed + 1 + i, *devices)
        walls.append(seconds)
    return img, stats, warmup_s, walls, launch_counts()


def device_stamp(on_card: bool) -> dict:
    """The card's stamp (``utils/metrics.card_stamp``), or the CPU's with
    no card fields."""
    import torch

    from pathtracer_tpu_torch.utils import metrics
    if on_card:
        return metrics.card_stamp()
    return {"name": "cpu", "power_limit": None, "clocks_sm": None,
            "temperature": None, "count": torch.cuda.device_count()}


# The wrapper counters, one row each: (the name in a line's ``launches``,
# the module of ``pathtracer_tpu_torch.ops`` that keeps it, its attribute).
# "march_shadow" counts the march route's shadow queries and
# "march_prep_twin" its preparations run as torch ops (the two-level
# cull); the others count kernel launches.
LAUNCH_COUNTERS = (
    ("cluster_march", "cluster_sweep", "MARCH_LAUNCHES"),
    ("march_prep", "cluster_sweep", "MARCH_PREP_LAUNCHES"),
    ("dense_sweep", "pallas_sweep", "SWEEP_LAUNCHES"),
    ("window_sweep", "cluster_sweep", "WINDOW_LAUNCHES"),
    ("ray_uniforms", "uniforms", "UNIFORMS_LAUNCHES"),
    ("bvh_traverse", "traversal", "TRAVERSE_LAUNCHES"),
    ("shade_bounce", "shade", "SHADE_LAUNCHES"),
    ("shade_nee", "shade", "SHADE_NEE_LAUNCHES"),
    ("shade_nee_finish", "shade", "SHADE_NEE_FINISH_LAUNCHES"),
    ("march_shadow", "cluster_sweep", "MARCH_SHADOW_LAUNCHES"),
    ("march_prep_twin", "cluster_sweep", "MARCH_PREP_TWIN"))


def _counters():
    import importlib
    for name, module, attr in LAUNCH_COUNTERS:
        yield name, importlib.import_module(
            f"pathtracer_tpu_torch.ops.{module}"), attr


def launch_counts() -> dict:
    """Each wrapper counter's value since it was last reset, by name
    (:data:`LAUNCH_COUNTERS`)."""
    return {name: getattr(module, attr) for name, module, attr in _counters()}


def reset_launch_counts() -> None:
    for _, module, attr in _counters():
        setattr(module, attr, 0)


def env_knobs() -> dict:
    """The ``PT_CLUSTER_*`` variables that are set, by name: the port's
    knobs of how a render runs (``render/renderer.cluster_options``, the
    march factory's ``PT_CLUSTER_RAYTILE``), stamped on the line as the JAX
    bench stamps its log record."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("PT_CLUSTER_")}


def check_render(args, cfg, img) -> dict:
    """PERF.md §2's check: the configuration at CHECK_WIDTH x CHECK_HEIGHT
    and CHECK_SPP on the bench's device and on the CPU twins, and the
    full-size image ``img`` finite."""
    import torch

    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world
    small = cfg.replace(width=CHECK_WIDTH, height=CHECK_HEIGHT,
                        spp=CHECK_SPP,
                        ray_chunk=min(cfg.ray_chunk,
                                      CHECK_WIDTH * CHECK_HEIGHT))
    images = []
    for device in (args.device, "cpu"):
        scene, cam = get_world(args.scene, device=device,
                               **scene_kwargs(args))
        images.append(make_renderer(small, device)(scene, cam).cpu())
    diff = (images[0] - images[1]).abs()
    close = float((diff <= CHECK_CLOSE).float().mean())
    mean = float(diff.mean())
    finite = bool(torch.isfinite(img).all())
    return {"correct": close >= 0.99 and mean <= CHECK_MEAN and finite,
            "check": {"size": [CHECK_WIDTH, CHECK_HEIGHT],
                      "spp": CHECK_SPP, "close_share": close,
                      "mean_abs_diff": mean, "finite": finite}}


def measure(args) -> dict:
    """The bench's record (module docstring). Raises :class:`NoCard` if
    ``--device cuda`` finds no card."""
    import torch

    from pathtracer_tpu_torch.config import route_accel
    from pathtracer_tpu_torch.ops import _cuda_build
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world
    from pathtracer_tpu_torch.utils import metrics

    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise NoCard("no CUDA device (torch.cuda.is_available() is False); "
                     "pass --device cpu for the plain twins")
    cfg = bench_config(args)
    t0 = time.perf_counter()
    if on_card:
        _cuda_build.build_all(KERNELS)
    scene, cam = get_world(args.scene, device=device, **scene_kwargs(args))
    render = make_renderer(cfg, device, with_stats=True)
    render.prepare(scene)
    sync(device)
    setup_s = time.perf_counter() - t0
    img, stats, warmup_s, walls, launches = time_renders(
        render, scene, cam, args.seed, args.iters, device)
    peak_mib = (torch.cuda.max_memory_allocated(device) / 2**20
                if on_card else None)
    n_closest, n_shadow, n_pairs = (int(v) for v in stats)
    nominal = cfg.num_pixels * cfg.spp * cfg.max_depth
    wall = sum(walls) / len(walls)
    stamp = device_stamp(on_card)

    def rate(x):
        return x / wall if on_card else None

    tflops = rate(n_pairs * metrics.OPS_TRI_PAIR / 1e12) if n_pairs else None
    mfu = (tflops * 1e12 / metrics.PEAK_F32
           if tflops is not None and "H100" in stamp["name"] else None)
    rec = {
        "metric": metric_name(args),
        "value": rate(nominal / 1e6),
        "unit": "Mrays/s",
        "vs_baseline": None,
        "accel": route_accel(args.accel, int(scene.num_prims), device),
        "prims": int(scene.num_prims),
        "nominal_queries": nominal,
        "schema": 2,
        "executed_queries": n_closest,
        "shadow_queries": n_shadow,
        "executed_mrays_per_s": rate(n_closest / 1e6),
        "pair_tests": n_pairs,
        "march_tflops": tflops,
        "march_mfu": mfu,
        "device": stamp,
        "walls_s": walls if on_card else None,
        "wall_s": wall if on_card else None,
        "setup_s": setup_s if on_card else None,
        "warmup_s": warmup_s if on_card else None,
        "peak_mem_mib": peak_mib,
        "launches": launches,
        "env": env_knobs(),
        "config": {"width": cfg.width, "height": cfg.height, "spp": cfg.spp,
                   "depth": cfg.max_depth, "ray_chunk": cfg.ray_chunk,
                   "seed": args.seed, "iters": args.iters, "sky": cfg.sky,
                   "nee": cfg.nee},
        "counting": {
            "pair_tests": "real cluster slots marched x K x ray_tile (the "
                          "JAX bench counts every window slot, padding "
                          "included)",
            "march_tflops": "upper count: pair_tests x OPS_TRI_PAIR / "
                            "mean wall"},
    }
    rec.update(check_render(args, cfg, img))
    if mfu is not None and mfu > 1.0:
        rec["suspect"] = True
        rec["suspect_reason"] = f"march_mfu {mfu} > 1; walls {walls}"
    return rec


def child_main(args) -> int:
    """The measured body: prints the one JSON line; exits 1 unless
    ``correct``."""
    fake = os.environ.get("PT_BENCH_FAKE", "")
    if fake.startswith("sleep:"):
        time.sleep(float(fake.split(":", 1)[1]))
        return 3
    try:
        rec = measure(args)
    except NoCard as e:
        emit(null_line(args, str(e)))
        return 1
    emit(rec)
    return 0 if rec["correct"] else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if args.child:
        return child_main(args)

    # the watchdog around the measured child
    budget = float(os.environ.get("PT_BENCH_BUDGET_S", "1500"))
    t_start = time.monotonic()
    running = {}

    def die(reason: str):
        child = running.get("child")
        if child is not None:
            try:
                os.killpg(child.pid, signal.SIGKILL)
            except OSError:
                pass
        emit(null_line(args, reason))
        os._exit(1)

    def on_signal(signum, frame):
        die(f"signal {signum} after {time.monotonic() - t_start:.0f} s: "
            f"measured run killed")

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    child = subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch.bench", "--child",
         *argv], stdout=subprocess.PIPE, text=True, start_new_session=True,
        env=env)
    running["child"] = child
    print(f"bench: measuring in child {child.pid} (budget {budget:g} s)",
          file=sys.stderr, flush=True)
    lines: list = []

    def read():
        for line in child.stdout:
            lines.append(line.rstrip("\n"))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    while True:
        remaining = budget - (time.monotonic() - t_start)
        if remaining <= 0:
            die(f"internal budget PT_BENCH_BUDGET_S={budget:g} s exceeded: "
                f"measured run killed")
        try:
            rc = child.wait(timeout=min(5.0, remaining))
            break
        except subprocess.TimeoutExpired:
            continue
    reader.join(timeout=10)
    signal.signal(signal.SIGTERM, signal.SIG_DFL)
    signal.signal(signal.SIGINT, signal.SIG_DFL)
    if not any(line.startswith("{") for line in lines):
        emit(null_line(args, f"bench child exited with code {rc} without "
                             f"a JSON line"))
        return 1
    for line in lines:
        print(line)
    sys.stdout.flush()
    return rc


if __name__ == "__main__":
    sys.exit(main())
