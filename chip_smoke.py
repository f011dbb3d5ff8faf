#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``pathtracer_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every kernel of the main paths from ``csrc/``, one nvcc
   process per source, all at once; print each kernel's registers and
   spills from ptxas (fails if the march spills);
3. kernels vs plain twins on the card, at the main paths' shapes, timed
   with CUDA events (median of 5 after a warm-up), each beside its bound:
   the cluster march on a 57,600-ray bunny camera and bounce wavefront
   and on NEE shadow segments from the camera hits (t_max 1, caller
   order), each also with its device time from ``torch.profiler``, the
   chunks that march, their slots, and the time per slot of the longest
   chunk; the dense sweep on the triangle world's 90,000-ray camera
   wavefront, the cornell-full 65,536-ray camera wavefront and a
   cornell-full shadow wavefront (t_min = K_SHADOW_T_MIN), with the
   ``tensor`` route (the ``auto`` choice for these scenes) timed at the
   same shapes; the window
   sweep of the rounds strategy (K=128 tables) on every launch of one
   rounds query of the 57,600-ray bunny camera wavefront (residual pass,
   rounds, fallback: kind, W, live chunks, time and bound each, and their
   sums) and on a full-width fallback over every chunk; (3d) the draws
   kernel (``csrc/ray_uniforms.cu``) in both modes: "flat" at (2, 57,600)
   and (57,600,), "by_ray" at m = 6, 3 and 1 on a real march's 57,600 ray
   ids (the binning order of the bunny's camera wavefront) and on the same
   order counted down from 2^29 - 1, each with its device time
   (``torch.profiler``), its twin's time, the aten ops the twin
   dispatches and the int32 bound; (3e) the shading kernel
   (``csrc/shade_bounce.cu``) on a 16,384-lane chunk of camera rays of
   each benchmark cell's scene after its closest-hit query (the bunny at
   640x360 in the sorted march's payload layout, the triangle world at
   800x450 in caller order), timed beside its twin with the state
   restored before each call, with its device time, the twin's aten ops
   and the bytes bound, and its launches on a 1-spp image of each cell's
   shape; the NEE pair (``shade_nee``, ``shade_nee_finish``) likewise on
   a 16,384-lane chunk of the Cornell cell's scene (cornell-full at
   256x256 through the dense sweep), its bounce around the route's
   shadow query bit-equal to the twins', and each kernel's launches on a
   1-spp Cornell image at the cell's shape (one each a bounce, and none
   of ``shade_bounce``); (3f) the march's preparation kernels
   (``march_bin``, ``march_order`` in ``csrc/cluster_march.cu``) through
   ``march_inputs`` on the two march cells' queries (the bunny's
   16,384-lane sorted wavefront with the integrator's extras, the
   combined scene's 129,600-lane sorted closest-hit and unsorted shadow
   query), every output held to the twin ``march_inputs_reference``, the
   query's preparation timed beside the twin's with the aten ops it
   dispatches, each kernel's device time and the bytes bound.
   Every kernel must agree with its twin to the bit. On every path of the
   later phases the draws kernel must launch, counted from that path's own
   run, and the draw sets it recorded there (the first and last of each
   shape) must be bit-equal to their twin; a flat (2, chunk) set and a
   by-ray set on the path's chunk must be among them (57,600, 65,536 and
   90,000 rays in phase 4, 4,096 and 57,600 in 6, 28,800 in 8, 7,200 and
   14,400 in 9: all but 65,536 end in a partial 256-thread block);
4. main paths through the CLI's code path, each with every launch counter
   reset just before it and read just after: the bunny at 640x360, 8 spp,
   depth 4 (cluster march); cornell-full at 256x256, 64 spp, depth 4 with
   NEE, stratified jitter and textures (dense sweep), in the CLI's passes
   of 8 spp; the triangle world at the reference's default size and
   depth, 800x450, depth 50, at 40 spp (of the reference's 100, cut for
   the script's time; dense sweep), in 5 passes; the
   bunny again on the rounds route (PT_CLUSTER_STRATEGY=rounds,
   PT_CLUSTER_K=128: window sweep, no march), whose image must agree with
   the march's, with its window launches counted by kind; then the
   triangle world at 1 spp and the rounds bunny once more under
   ``torch.profiler``, for the device's busy share and the sweep kernel's
   share of the device time. Each checks finite pixels and the image mean
   and writes out/; the march bunny's preparation launches, read from
   its own render, must be two for each of its marches (``march_bin`` and
   ``march_order`` on every sorted closest-hit query);
5. end to end: small renders on the card against the same renders on the
   CPU (the plain twins, which the CPU tests hold against the JAX
   reference): the bunny, cornell-full through the dense sweep with NEE,
   the bunny in the Cornell room with NEE on the march, and the bunny on
   the rounds route with the Sobol sampler, Russian roulette and black
   termination;
6. differentiable (``render/diff``), each step with the launch counters
   reset just before it and read just after: (a) the inverse-rendering
   fit of ``examples/inverse_rendering.py`` at the cornell-diff preset's
   full size (64x64, 8 spp, depth 2, NEE) through the dense sweep
   (``accel="pallas"``): the target rendered with the true albedos, the
   start at albedo * 0.3 + 0.45, 30 Adam steps at lr 0.05 on a frozen
   noise realization; the loss must fall tenfold and the albedo error
   fall; (b) one forward and backward of the bunny's mean linear image at
   the bench shape (640x360, 8 spp, depth 4, 57,600-ray chunks) through
   the march, with respect to the albedos: finite and nonzero; (c)
   gradients with respect to albedo, emit and v0 on the card against the
   CPU twins at 32x32, 2 spp, depth 3: cornell-diff through the dense
   sweep, the bunny through the march (rtol 1e-4, atol 1e-7, over the
   pixels, at least 97%, whose image agrees within 1e-4 on both);
7. large scenes and long renders, each step with the launch counters
   reset just before it and read just after: (a) the march on the
   57,600-ray camera wavefront of the bunny subdivided three times
   (231,427 prims, 3,617 clusters), under the automatic plan (cull2, sup
   8) and the flat cull, each bit-equal to its twin, with its slots, time,
   whole-query time and peak memory; the two plans must agree (valid
   flags equal, winners equal but at bit-equal t, t within rtol 1e-6);
   (b) ``examples/big_scene.py`` at its defaults (level 2, 320x180, 4
   spp, depth 4) and at level 3, each against the same render under the
   other cull (>= 99.9% of channels within 1e-4), with the scene and
   table builds timed; (c) the bunny at 640x360, 8 spp, depth 4 through
   the CLI in passes of 2 with ``--checkpoint``, stopped after its second
   pass and run again: the resumed image must equal the uninterrupted
   pass render bit for bit and phase 4's one-pass image within 1e-6;
8. the BVH route, multi-device rendering, the viewer and the oracle, each
   step with the launch counters reset just before it and read just
   after: (a) the LBVH of the bunny and of its level-2 subdivision built
   on the card, equal array by array to the CPU build, both timed; (b)
   the traversal kernel (``csrc/bvh_traverse.cu``) bit-equal to its twin
   (``traverse_reference``) on four 57,600-ray wavefronts: the bunny's
   camera wavefront, its one bounce, NEE shadow segments from its hits
   (t_min K_SHADOW_T_MIN, unnormalised) and the level-2 bunny's camera
   wavefront; each query one launch with no host sync inside
   (``torch.cuda.set_sync_debug_mode``) and no march, sweep or window
   launch; with the kernel's time (CUDA events), the twin's (one call,
   its steps counted through ``ray_aabb_hit``), the march's whole query on
   the same rays, the bound from the visits the twin made, and the longest
   ray's steps; on the camera wavefront the winners equal the march's but
   at near ties, and the twin's aten ops are counted; (c) the bunny at
   160x90, 1 spp, depth 4 and cornell-full at 64x64 (16 spp, depth 4,
   NEE: the shadow query) through the CLI on the "bvh" route, each
   bit-equal to the brute route, one traversal launch a query; (c') the
   bunny at the bench shape (640x360, 8 spp, depth 4, 57,600-ray chunks)
   on the "bvh" route through the CLI, bit-equal to the "brute" route's
   image at that shape and within mean |diff| 1e-3 of phase 4's march
   image (the march's pair-scalar t differs at near ties, and four bounces
   carry it past 1e-4 on ~2% of channels), one launch and no host sync a
   traversal call, its wall beside the march route's in this process;
   (d) the
   sharded renderer on meshes of the one card ([cuda:0] 1x1, [cuda:0] * 2
   as 2x1 and 1x2) at the bench shape: the rays-only images bit-equal to
   the single render with the plan's chunk (57,600 and 28,800 rays), the
   spp split within 1e-6, march launches counted, and the march (K1)
   bit-equal to its twin on the first camera and the first bounce
   wavefront (28,800 rays) in which the 2x1 render marched; (e) a one-rank NCCL
   process group through ``initialize_distributed`` and a sharded render
   under it (its framebuffer through ``all_reduce``), bit-equal to (d)'s
   1x1 render; (f) the
   sharded cornell-diff train step (2x1 on the card, dense sweep) against
   the unsharded step with the plan's chunk: loss and every gradient
   entry within rtol 1e-5 (atol 1e-9); (g) a
   ``ViewerSession`` on the test world's "bvh" route for 3 frames, a move
   and a frame (the traversal kernel launched, and bit-equal to its twin
   on the first and last call it recorded, 2,304 rays each), then ``python -m pathtracer_tpu_torch --interactive`` on
   it under a pseudo-terminal: "w" after two frames, ESC after two more;
   it must exit 0 with its frames printed and restart its passes after the
   move;
   (h) the NumPy oracle against the port's card render of the test world
   (64x36, 24 spp, depth 8) within the CPU parity tests' noise-scaled
   bounds;
9. the entry points, each step with the launch counters reset just
   before it and read just after: (a) ``python -m
   pathtracer_tpu_torch.bench`` at its defaults (the bunny at 640x360, 8
   spp, depth 4, 57,600-ray chunks, 3 timed renders) in its own processes,
   whose measured child resets the counters just before its timed renders
   and reports them in its line: exactly one JSON line, ``correct``, a
   positive rate, executed queries within the nominal, ``march_mfu`` at
   most 1, this card's name, the march launched; then ``--accel bvh`` at
   the same defaults, in its own processes too: ``correct``, every query
   executed, one traversal launch a closest-hit query of each timed render
   and no march, sweep or window launch; (b) the bench on the
   triangle world (800x450, 2 spp, depth 50) and on cornell (256x256, 16
   spp, depth 4, NEE), in phase 4's chunks (90,000 and 65,536 rays, which
   divide the images), each through the dense sweep (``--accel pallas``)
   and the tensor route (the ``auto`` choice below 1,024 prims), their
   rates side by side; (c) ``bench_scaling``: the n = 1 line at the bench
   shape, then ``--proxy`` on ``cuda:0`` x 8, whose per-shard executed
   queries must sum to the unsharded render's; (d) the inverse-rendering
   example at its defaults (48x48, 8 spp, depth 2, NEE, "brute", 60
   Adam steps): the loss must fall tenfold and the albedo error fall; (e)
   ``entry()``'s step bit-equal to ``render_image`` through the march,
   then ``dryrun_multichip(2)`` on ``[cuda:0] * 2``, whose BVH leg must
   launch the traversal kernel, bit-equal to its twin on the first and last
   call it recorded (64-ray chunks). In (c) and (e) the
   march and the dense sweep record the arguments of their first and
   last calls that do work, at each wavefront size the step gives them
   (the proxy's 7,200-ray chunks, the entry's 14,400, the dry run's
   march and train step), and the kernel must be bit-equal to its twin
   on each;
10. the draws kernel on the paths, each render through the CLI's code
   path with every launch counter reset just before it and read just
   after: (a) cornell at 256x256, 16 spp, depth 4 with NEE and ``--rr``
   through the dense sweep, whose m = 3 and m = 1 draws on 65,536 rays
   must be among those held to the twin; (b) the bunny render's wall and,
   under ``torch.profiler``, its CUDA kernel launches, once as built and
   once with every draw patched to its plain twin (in this script only),
   the two images bit-equal;
11. the native host library (``native/``; host C++ built with g++, not a
   device kernel): (a) right after the build, before any phase parses the
   bunny: g++ builds ``native/src/ptnative.cpp`` on this host (seconds and
   zlib route printed); the vendored bunny (1,817 v, 3,616 f: with the
   three spheres, the pinned 3,619 prims) and the OBJ files of fault F5
   parse to the same bits through the native parser and its twin
   (``io/obj.load_obj_python``), each bunny parse timed on the host clock
   (median of 5); (b) phase 4's bunny image, written through the native
   encoder, byte-equal to the twin encoder's bytes (``io/png.encode_png``).

A line ``native {...}`` carries phase 11's readings. The line after it,
before the last, is a JSON object with each kernel's route,
source, launches on its main path (and, for the march and the dense
sweep, ``diff_launches`` on the differentiable path,
``sharded_launches`` on phase 8's 2x1 sharded bunny render and sharded
train step and ``bench_launches`` on phase 9's bench runs (the march's
at the bench's defaults, the dense sweep's on 9b's pallas runs, each over
the timed renders); for the march, ``big_launches`` on the level-2
big-scene render; for ``ray_uniforms``, which replaces no Pallas kernel,
``path_launches`` on every path named above and the times of its
largest main-path set, by_ray m = 6 on 57,600 ids; for ``bvh_traverse``,
which replaces no Pallas kernel, launches on 8c''s bench-shape bunny,
``path_launches`` on each "bvh" render of 8c and 8c', 8g's viewer
session, 9a's bench and 9e's dry run, and the times of the bunny's camera
wavefront; for ``shade_bounce``, which replaces no Pallas kernel,
``path_launches`` on phase 3e's three images (0 on the Cornell one,
whose bounces run the NEE pair) and the times of the bunny's chunk; for
``shade_nee`` and ``shade_nee_finish``, each one's own launches on phase
3e's Cornell image and the times of the Cornell chunk; for
``march_prep``, the preparation kernels, which replace no Pallas kernel,
launches on phase 4's march bunny, ``path_launches`` on each of phase
4's renders, ``case_launches`` on phase 3f's three queries and the times
of the bunny's query), error,
times and bound; the last line is
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --bench [DIR]

times the three kernels alone, on the inputs of phases 3a, 3b and 3c
(the same builders), and prints no result line: each wavefront or launch
with the wrapper's time (CUDA events, median of 20 calls after a warm-up)
and the kernel's own device time (``torch.profiler``, the mean over 20
launches), beside the card's name and power limit. With DIR it imports
``pathtracer_tpu_torch`` from that checkout instead of this one, so one
command can time two versions of the kernels on one card, in turns.

    python3 chip_smoke.py --shade

runs phase 3e alone.

    python3 chip_smoke.py --prep

runs phase 3f alone.

    python3 chip_smoke.py --launches [DIR]

renders the triangle world at 1 spp (phase 4's profiled render) once to
warm up and once under ``torch.profiler``, with the port imported from
DIR, and prints its wall, the device's busy share and every kernel's
launches and device time, most launched first: the parent's tree and this
one, run in turns, show which ops a change adds to a render.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import inspect
import json
import os
import re
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
BUNNY_PRIMS = 3619     # assets/bunny.obj's 3,616 faces and three spheres
TRIANGLE_SPP = 40      # of the reference's 100, cut for the script's time
BENCH_REPS = 20        # timed calls per wavefront or launch in --bench
SHADE_LANES = 16384    # the benchmark cells' chunk
T_MIN = 1e-3
ROUNDS_K = 128         # the rounds strategy needs K % 128 == 0
FIT_STEPS = 30         # Adam steps of the inverse-rendering fit
BIG_LEVEL = 3          # phase 7a's subdivided bunny: 3,617 clusters, cull2
BIG_SCENE_LEVELS = (2, 3)   # phase 7b: the example's default, then level 3
ROUNDS_ENV = {"PT_CLUSTER_STRATEGY": "rounds", "PT_CLUSTER_K": str(ROUNDS_K)}


def load_metrics():
    """This checkout's ``pathtracer_tpu_torch/utils/metrics.py``, loaded by
    its path: the peaks, the per-pair operation counts and the card stamp
    come from there (one copy for this script and the port's benches),
    while ``--bench DIR`` and ``--launches DIR`` import the rest of the
    port from DIR. Exits non-zero where the port is not beside this
    script."""
    path = os.path.join(HERE, "pathtracer_tpu_torch", "utils", "metrics.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_metrics", path)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    except FileNotFoundError:
        print(f"chip_smoke: FAIL: the port is not next to chip_smoke.py (no "
              f"{path})", file=sys.stderr, flush=True)
        sys.exit(1)
    return module


metrics = load_metrics()
PEAK_BYTES, PEAK_F32 = metrics.PEAK_BYTES, metrics.PEAK_F32
OPS_SPHERE_PAIR, OPS_TRI_PAIR = metrics.OPS_SPHERE_PAIR, metrics.OPS_TRI_PAIR
OPS_SPHERE_BASE, OPS_TRI_BASE = metrics.OPS_SPHERE_BASE, metrics.OPS_TRI_BASE
OPS_TRAV_RAY, OPS_BOX_VISIT = metrics.OPS_TRAV_RAY, metrics.OPS_BOX_VISIT
OPS_SPHERE_TEST, OPS_TRI_TEST = metrics.OPS_SPHERE_TEST, metrics.OPS_TRI_TEST


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    try:
        return metrics.card_line()
    except RuntimeError as e:
        fail(str(e))


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


def bound_int(n_bytes: float, n_ops: float):
    """(bound ms, "bytes" or "operations"): the larger of the bytes over
    the HBM rate and the int32 operations over the card's int32 peak."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / metrics.PEAK_INT32 * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def draw_work(mode: str, n: int, m: int):
    """(bytes, int32 operations) that one draw set needs: n elements of a
    flat set, or n rays x m columns of a by-ray set (ids read once,
    uniforms written once): a threefry block, the xor of its words and
    the conversion per uniform, plus the fold-in block per ray."""
    per_out = metrics.OPS_THREEFRY + 1 + metrics.OPS_TO_UNIT
    if mode == "flat":
        return 4 * n, n * per_out
    return 4 * n + 4 * n * m, n * (metrics.OPS_THREEFRY + m * per_out)


def nbytes(*xs) -> int:
    """Bytes of the tensors among ``xs``."""
    return sum(x.numel() * x.element_size() for x in xs
               if hasattr(x, "element_size"))


def kernel_label(mangled: str) -> str:
    """A kernel's short name from its mangled one."""
    m = re.search(r"(cluster_march|march_bin|march_order|dense_sweep|"
                  r"window_sweep|flat_uniforms|ray_uniforms|bvh_traverse)"
                  r"_kernel", mangled)
    return m.group(1) if m else mangled


def named(fn, args) -> dict:
    """The arguments of the call ``fn(*args)``, by parameter name."""
    return inspect.signature(fn).bind(*args).arguments


def with_args(fn, args, **changes) -> tuple:
    """``args`` of a call of ``fn`` with the named ones replaced."""
    bound = inspect.signature(fn).bind(*args)
    bound.arguments.update(changes)
    return bound.args


def camera_wavefront(dev, cam, n, seed):
    """n camera rays of ``cam`` from the seed, on ``dev``."""
    import torch
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.core.camera import get_rays
    u = prng.uniform(prng.fold_in(prng.PRNGKey(seed), 1), (4, n), dev)
    o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3],
                       torch.zeros(n, device=dev))
    return o, d


def dense_wavefronts(dev):
    """The dense sweep's main-path inputs, as (name, scene, sweep tables,
    o, d, t_min): the triangle world's 90,000-ray camera wavefront,
    cornell-full's 65,536-ray camera wavefront, and a shadow wavefront
    from its hits towards sampled light points (t_min =
    K_SHADOW_T_MIN)."""
    import torch
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import intersect, pallas_sweep, tensor_sweep
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.render import lights
    from pathtracer_tpu_torch.scene.worlds import get_world
    tri_scene, tri_cam = get_world("triangle", device=dev)
    cor_scene, cor_cam, _ = get_preset("cornell-full", device=dev)
    tri_tables, cor_tables = (tensor_sweep.pack_sweep_tables(
        sc, tile=pallas_sweep.DEF_PRIM_TILE) for sc in (tri_scene, cor_scene))
    o_c, d_c = camera_wavefront(dev, cor_cam, CORNELL_RAYS, 2)
    idx, _, valid = pallas_sweep.pallas_closest(cor_tables, o_c, d_c, T_MIN)
    rec = intersect.hit_records_from_prims(cor_scene, idx, o_c, d_c, T_MIN,
                                           intersect.BIG_T, valid)
    u_l = prng.uniform(prng.fold_in(prng.PRNGKey(3), 1), (CORNELL_RAYS, 3),
                       dev)
    point, _, _, _ = lights.sample_lights(cor_scene, u_l)
    o_s = rec.p + T_MIN * rec.normal
    d_s = torch.where(valid[:, None], point - o_s, 0.0)
    o_t, d_t = camera_wavefront(dev, tri_cam, TRI_RAYS, 1)
    return [("triangle camera", tri_scene, tri_tables, o_t, d_t, T_MIN),
            ("cornell-full camera", cor_scene, cor_tables, o_c, d_c, T_MIN),
            ("cornell-full shadow", cor_scene, cor_tables, o_s, d_s,
             K_SHADOW_T_MIN)]


def rounds_launches(ct, o, d):
    """Every window-sweep launch of one rounds query of the rays (o, d) on
    the cluster tables ``ct``, as (kind, window_sweep arguments), then
    ("fallback, all chunks", ...): a fallback (W = C_reg from cluster 0)
    over every chunk of the query's first launch."""
    import torch
    from pathtracer_tpu_torch.ops import cluster_sweep
    fn = cluster_sweep.window_sweep
    with mock.patch.object(cluster_sweep, "window_sweep", wraps=fn) as spy:
        cluster_sweep.cluster_closest(ct, o, d, T_MIN)
    captured = [call.args for call in spy.call_args_list]
    kinds = window_kinds([named(fn, c)["W"] for c in captured], ct.C_reg)
    if len(captured) < 2 or kinds[0] != "residual" or kinds[1] != "round 1":
        fail(f"rounds query: expected a W=1 residual pass and a W=4 round, "
             f"got {kinds}")
    zeros = torch.zeros_like(named(fn, captured[0])["starts"])
    full = with_args(fn, captured[0], starts=zeros, skips=zeros, W=ct.C_reg)
    return list(zip(kinds, captured)) + [("fallback, all chunks", full)]


def window_kinds(widths, C_reg):
    """The kind of each window-sweep launch of a run of rounds queries,
    from its width W: "residual" (W = 1, the first launch of a query),
    "round k" (the k-th W-wide window since it), "fallback" (W = C_reg)."""
    out, k = [], 0
    for W in widths:
        if W == 1:
            out.append("residual")
            k = 0
        elif W == C_reg:
            out.append("fallback")
        else:
            k += 1
            out.append(f"round {k}")
    return out


def kind_order(kind: str):
    return (0, 0) if kind == "residual" else (2, 0) if kind == "fallback" \
        else (1, int(kind.split()[1]))


def triangle_argv(spp):
    """The CLI's arguments for the triangle world at the reference's
    default size and depth, through the dense sweep, at ``spp``."""
    return ["--scene", "triangle", "--width", "800", "--height", "450",
            "--spp", str(spp), "--max-depth", "50", "--accel", "pallas",
            "--ray-chunk", str(TRI_RAYS)]


def profile_render(cli, name, argv, kernel, card, torch, env=None,
                   by_kernel=False):
    """One render of ``argv`` under torch.profiler (device activity only):
    the device's busy share of the wall, the kernels launched, and the
    share of the device time and of the wall taken by ``kernel``; with
    ``by_kernel``, also every kernel's launches and device time, most
    launched first."""
    from torch.profiler import ProfilerActivity, profile
    with environ(env or {}):
        args = cli.build_parser().parse_args(argv + ["--device", DEVICE])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            # the render's wall; the device time also holds the table build
            _, wall, _, _ = cli.render_cli(args)
    device_us = kernel_us = 0.0
    n_all = n_kernel = 0
    rows = []
    for e in prof.key_averages():
        us = float(getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0.0)))
        rows.append((e.count, us, e.key))
        device_us += us
        n_all += e.count
        if kernel in e.key:
            kernel_us += us
            n_kernel += e.count
    if by_kernel:
        for count, us, key in sorted(rows, key=lambda r: (-r[0], r[2])):
            print(f"  {count} launches, {us / 1e3:.3f} ms: {key}")
    if device_us <= 0.0:
        print(f"{name} under torch.profiler: device time not measured (the "
              f"profiler recorded none)")
        return
    busy = device_us / 1e6 / wall
    print(f"{name} under torch.profiler: wall {wall:.4f} s, device time "
          f"{device_us / 1e6:.4f} s (busy share {busy:.4f}), {n_all} kernel "
          f"launches; {kernel} {kernel_us / 1e6:.4f} s over {n_kernel} "
          f"launches ({kernel_us / device_us:.4f} of the device time, "
          f"{kernel_us / 1e6 / wall:.4f} of the wall) [{card}]")


def needed_ops(torch, phi, a, block, sph, chunk=16384):
    """The fp32 operations that rays (phi, a) need against n primitives
    whose (12, 4n) column block is ``block`` and whose sphere mask is
    ``sph`` (n,): per pair the base count of its type, plus the rest of
    the full count where the data needs it (OPS_* above)."""
    from pathtracer_tpu_torch.ops import tensor_sweep
    n = sph.shape[0]
    total = 0.0
    for r0 in range(0, phi.shape[0], chunk):
        S = tensor_sweep.contract(phi[r0:r0 + chunk], block)
        det, c0, p2, p3 = (S[:, k * n:(k + 1) * n] for k in range(4))
        disc = det * det - a[r0:r0 + chunk, None] * c0
        inv = 1.0 / torch.where(det == 0.0, 1.0, det)
        b1, b2 = p2 * inv, p3 * inv
        bary = ~((det == 0.0) | (b1 <= 0.0) | (b2 <= 0.0) | (b1 + b2 >= 1.0))
        ops = torch.where(
            sph[None, :],
            OPS_SPHERE_BASE + (OPS_SPHERE_PAIR - OPS_SPHERE_BASE)
            * (disc >= 0.0).double(),
            OPS_TRI_BASE + (OPS_TRI_PAIR - OPS_TRI_BASE) * bary.double())
        total += float(ops.sum())
    return total


def range_block(cols, is_sphere, lo, hi):
    """Columns (12, 4n) and sphere mask (n,) of rows [lo, hi) of one
    (12, 4 * width) column block."""
    n = hi - lo
    width = is_sphere.shape[0]
    block = cols.view(cols.shape[0], 4, width)[:, :, lo:hi]
    return block.reshape(cols.shape[0], 4 * n), is_sphere[lo:hi] != 0


def window_needed_ops(torch, w):
    """needed_ops of one window-sweep launch (its arguments ``w`` by name):
    each cluster against the rays of the swept chunks whose window holds
    it, over its real rows."""
    starts, skips, W, ray_tile = w["starts"], w["skips"], w["W"], \
        w["ray_tile"]
    n_chunks = starts.shape[0]
    P = w["phi"].view(n_chunks, ray_tile, -1)
    A = w["a"].view(n_chunks, ray_tile)
    total = 0.0
    for c, (lo, hi) in enumerate(w["ranges"].tolist()):
        sel = (skips == 0) & (starts <= c) & (c < starts + W)
        if hi == lo or not bool(sel.any()):
            continue
        block, sph = range_block(w["cols"][c], w["is_sphere"][c], lo, hi)
        total += needed_ops(torch, P[sel].reshape(-1, P.shape[2]),
                            A[sel].reshape(-1), block, sph)
    return total


def march_needed_ops(torch, m, slots):
    """(needed, full) operations of one march launch (its arguments ``m``
    by name, ``slots`` the slots each chunk marched): each cluster against
    the rays of the chunks that marched it, over its real rows; needed_ops
    for the first, every pair's full count (OPS_*_PAIR) for the second."""
    ids, ray_tile = m["ids"], m["ray_tile"]
    n_chunks, n_slots = ids.shape
    P = m["phi"].view(n_chunks, ray_tile, -1)
    A = m["a"].view(n_chunks, ray_tile)
    marched = (torch.arange(n_slots, device=ids.device)[None, :]
               < slots[:, None].long())
    needed = full = 0.0
    for c, (lo, hi) in enumerate(m["ranges"].tolist()):
        sel = ((ids == c) & marched).any(dim=1)
        if hi == lo or not bool(sel.any()):
            continue
        block, sph = range_block(m["cols"][c], m["is_sphere"][c], lo, hi)
        needed += needed_ops(torch, P[sel].reshape(-1, P.shape[2]),
                             A[sel].reshape(-1), block, sph)
        n_sph = int(sph.sum())
        full += int(sel.sum()) * ray_tile * float(
            OPS_SPHERE_PAIR * n_sph + OPS_TRI_PAIR * (hi - lo - n_sph))
    return needed, full


def march_walk(slots):
    """(chunks that march, slots p50 and max over them) of the slots each
    chunk marched, a numpy array."""
    import numpy as np
    walking = slots[slots > 0]
    if walking.size == 0:
        return 0, 0.0, 0
    return int(walking.size), float(np.median(walking)), int(walking.max())


def march_wavefronts(dev):
    """The march's inputs: the bunny's cluster tables (the renderer's K),
    its 57,600-ray camera wavefront, and the march arguments of three
    queries, as (tables, (o, d) of the camera, [(name, args)]): the camera
    wavefront and its one bounce (the camera hits shaded, dead lanes with
    d = 0), sorted as the render sorts them, and NEE shadow segments from
    the camera hits to points above the bunny (t_min K_SHADOW_T_MIN, t_max
    1, in caller order, as the shadow query runs)."""
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    from pathtracer_tpu_torch.ops import cluster_sweep
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.render.renderer import CLUSTER_K
    from pathtracer_tpu_torch.scene.worlds import get_world
    scene, cam = get_world("bunny", device=dev)
    ct = build_cluster_tables(scene, K=CLUSTER_K)
    o_cam, d_cam = camera_wavefront(dev, cam, RAYS, 0)
    idx, t, valid = cluster_sweep.cluster_march(ct, o_cam, d_cam, T_MIN)
    o_b, d_b, p, seg = bounce_and_shadow(dev, ct.scene, idx, t, valid,
                                         o_cam, d_cam)
    return ct, (o_cam, d_cam), [
        (name, cluster_sweep.march_inputs(ct, o, d, T_MIN)["args"])
        for name, o, d in (("camera", o_cam, d_cam), ("bounce", o_b, d_b))
    ] + [("shadow", cluster_sweep.march_inputs(
        ct, p, seg, K_SHADOW_T_MIN, active=valid, t_max=1.0,
        sort_rays=False)["args"])]


def op_counter():
    """A context manager that counts the aten ops dispatched inside it
    (``.n``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))
    return OpCount()


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


def stream_ms(fn, torch, reps: int = 20) -> float:
    """Milliseconds per call of ``reps`` back-to-back calls of ``fn()``
    after a warm-up, between two CUDA events: the device's time per call
    where each call's work outlasts the host's time to launch it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, torch, reps: int, kernel: str):
    """Mean device time of the kernels named ``*kernel*`` that ``fn()``
    launches, over ``reps`` calls after a warm-up, from torch.profiler
    (device activity only); None where the profiler recorded none of
    them."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(float(getattr(e, "self_device_time_total", 0.0))
             for e in prof.key_averages() if kernel in e.key)
    return us / 1e3 / reps if us > 0.0 else None


def ms_text(ms, slots=0) -> str:
    """A device time as printed, with its time per slot where ``slots``
    (the longest chunk's) is given; "not measured" where it is None."""
    if ms is None:
        return "device not measured"
    per_slot = f", {ms * 1e3 / slots:.3f} us per slot" if slots else ""
    return f"device {ms:.4f} ms{per_slot}"


def reset_counts():
    """Set the launch counter of every kernel wrapper to 0."""
    from pathtracer_tpu_torch import bench
    bench.reset_launch_counts()


def read_counts():
    """(march, dense sweep, window sweep) launches since the last reset."""
    from pathtracer_tpu_torch import bench
    counts = bench.launch_counts()
    return (counts["cluster_march"], counts["dense_sweep"],
            counts["window_sweep"])


def read_draws() -> int:
    """The draws kernel's launches since the last reset."""
    from pathtracer_tpu_torch import bench
    return bench.launch_counts()["ray_uniforms"]


def read_prep() -> int:
    """The march preparation kernels' launches since the last reset."""
    from pathtracer_tpu_torch import bench
    return bench.launch_counts()["march_prep"]


def read_traversals() -> int:
    """The traversal kernel's launches since the last reset."""
    from pathtracer_tpu_torch import bench
    return bench.launch_counts()["bvh_traverse"]


def twin_visits(nodes, o, d, t_min):
    """The traversal's plain twin on (o, d), with its work counted through
    its calls of ``ray_aabb_hit`` and ``intersect_prims``: (counts, the
    twin's result). Counts: "steps" the twin took, "visits" the node
    visits of all rays before each reached the done row (the kernel's loop
    trips), "longest" the most a ray took, and the primitive tests the
    kernel makes ("spheres", "triangles": leaves whose box is hit)."""
    import torch
    from pathtracer_tpu_torch.ops import intersect, traversal
    from pathtracer_tpu_torch.scene.scene import PRIM_SPHERE
    aabb, prims = intersect.ray_aabb_hit, intersect.intersect_prims
    per_ray = torch.zeros(o.shape[0], dtype=torch.int64, device=o.device)
    tests = torch.zeros(2, dtype=torch.int64, device=o.device)
    state = {"steps": 0, "box": None}

    def counting_aabb(o_, d_, bmin, bmax, t_min_, t_max_):
        hit = aabb(o_, d_, bmin, bmax, t_min_, t_max_)
        live = bmin[:, 0] < 1e38          # the done row's box min is 3e38
        per_ray.add_(live)
        state["steps"] += 1
        state["box"] = hit & live
        return hit

    def counting_prims(o_, d_, ptype, *rest):
        tested = state["box"] & (ptype > 0)
        sph = ptype == PRIM_SPHERE
        tests[0] += (tested & sph).sum()
        tests[1] += (tested & ~sph).sum()
        return prims(o_, d_, ptype, *rest)
    with mock.patch.object(intersect, "ray_aabb_hit", counting_aabb), \
            mock.patch.object(intersect, "intersect_prims", counting_prims):
        result = traversal.traverse_reference(nodes, o, d, t_min,
                                              intersect.BIG_T)
    return {"steps": state["steps"], "visits": int(per_ray.sum()),
            "longest": int(per_ray.max()), "spheres": int(tests[0]),
            "triangles": int(tests[1])}, result


def bounce_and_shadow(dev, scene, idx, t, valid, o_cam, d_cam):
    """From a camera wavefront's closest hits (``idx`` in ``scene``'s
    order): its one bounce (the hits shaded, dead lanes with d = 0) and
    NEE shadow segments from the hits to points above the bunny
    (unnormalised, zero where the camera ray missed), as (o_b, d_b, p,
    seg)."""
    import torch
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import intersect
    from pathtracer_tpu_torch.scene import materials
    n = o_cam.shape[0]
    rec = intersect.hit_records_from_prims(scene, idx, o_cam, d_cam, T_MIN,
                                           intersect.BIG_T, valid)
    sc = materials.scatter(scene, rec, d_cam, prng.uniform_by_ray(
        prng.PRNGKey(0), torch.arange(n, device=dev), 6))
    alive = valid & sc.ok
    o_b = torch.where(alive[:, None], rec.p, o_cam)
    d_b = torch.where(alive[:, None], sc.direction, 0.0)
    u = prng.uniform(prng.fold_in(prng.PRNGKey(4), 1), (n, 3), dev)
    light = (torch.tensor([-6.0, 2.0, -6.0], device=dev)
             + u * torch.tensor([12.0, 10.0, 12.0], device=dev))
    p = o_cam + t[:, None] * d_cam
    seg = torch.where(valid[:, None], light - p, 0.0)
    return o_b, d_b, p, seg


def differentiable(dev, card, march_img, path_draws):
    """Phase 6 (module docstring), each step with every launch counter
    reset just before it and read just after; ``march_img`` is phase 4's
    bunny render. Returns (dense sweep launches of the fit, march launches
    of the bunny gradient); each step's draws launches go into
    ``path_draws``."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.render import diff
    from pathtracer_tpu_torch.render.renderer import padded_pixel_grid
    from pathtracer_tpu_torch.scene.worlds import get_world

    # 6a. the inverse-rendering fit at the cornell-diff preset's size
    scene_d, cam_d, cfg_d = get_preset("cornell-diff", device=dev)
    cfg_d = cfg_d.replace(accel="pallas")
    rows, cols = padded_pixel_grid(
        cfg_d, min(cfg_d.ray_chunk, cfg_d.num_pixels), dev)
    target = diff.render_linear(scene_d, cam_d, prng.PRNGKey(0), rows, cols,
                                cfg_d, cfg_d.spp)[:cfg_d.num_pixels]
    start = scene_d._replace(albedo=scene_d.albedo * 0.3 + 0.45)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recording_draws() as fit_seen:
        fitted, history = diff.fit(start, cam_d, target, cfg_d,
                                   steps=FIT_STEPS, lr=0.05,
                                   param_fields=("albedo",), seed=0,
                                   resample=False)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / FIT_STEPS
    fit_counts = read_counts()
    path_draws["fit cornell-diff"] = read_draws()
    fit_peak = torch.cuda.max_memory_allocated()
    mae0 = float((start.albedo - scene_d.albedo).abs().mean())
    mae1 = float((fitted["albedo"] - scene_d.albedo).abs().mean())
    print(f"fit cornell-diff {cfg_d.width}x{cfg_d.height} {cfg_d.spp} spp "
          f"depth {cfg_d.max_depth}, NEE, accel pallas, {FIT_STEPS} Adam "
          f"steps at lr 0.05: loss {history[0]:.6g} -> {history[-1]:.6g} "
          f"(x{history[-1] / history[0]:.4g}), albedo MAE {mae0:.5f} -> "
          f"{mae1:.5f}, {step_s:.4f} s per step, peak memory "
          f"{fit_peak / 2**20:.1f} MiB, {fit_counts[1]} sweep launches, "
          f"{fit_counts[0]} march launches [{card}]")
    if not np.isfinite(history).all() or history[-1] >= 0.1 * history[0]:
        fail(f"the fit did not cut its loss tenfold: {history}")
    if not mae1 < mae0:
        fail(f"the fit did not lower the albedo error: {mae0} -> {mae1}")
    if fit_counts[1] <= 0 or fit_counts[0] or fit_counts[2]:
        fail(f"the fit launched {fit_counts} (march, sweep, window) kernels")
    hold_draws("fit cornell-diff", fit_seen, path_draws["fit cornell-diff"],
               min(cfg_d.ray_chunk, cfg_d.num_pixels), (6, 3))

    # 6b. the bunny at the bench shape through the march: one forward and
    # backward with respect to the albedos
    scene_b, cam_b = get_world("bunny", device=dev)
    cfg_b = RenderConfig(width=640, height=360, spp=8, max_depth=4,
                         ray_chunk=RAYS, accel="cluster", scene="bunny")
    rows, cols = padded_pixel_grid(cfg_b, RAYS, dev)
    params = diff.scene_params(scene_b, ("albedo",))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    with recording_draws() as grad_seen:
        img = diff.render_linear(diff.apply_params(scene_b, params), cam_b,
                                 prng.PRNGKey(0), rows, cols, cfg_b,
                                 cfg_b.spp)
    loss = img.mean()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    bunny_counts = read_counts()
    path_draws["bunny gradient"] = read_draws()
    bunny_peak = torch.cuda.max_memory_allocated()
    grad = params["albedo"].grad.cpu().numpy()
    print(f"bunny gradient {cfg_b.width}x{cfg_b.height} {cfg_b.spp} spp depth "
          f"{cfg_b.max_depth}, chunk {RAYS}, accel cluster: forward "
          f"{t1 - t0:.4f} s, backward {t2 - t1:.4f} s, peak memory "
          f"{bunny_peak / 2**20:.1f} MiB, {bunny_counts[0]} march launches, "
          f"|d mean / d albedo| max {np.abs(grad).max():.6g} [{card}]")
    if not np.isfinite(grad).all() or not np.abs(grad).sum() > 0.0:
        fail(f"the bunny's albedo gradient is not finite and nonzero: {grad}")
    if bunny_counts[0] <= 0 or bunny_counts[1] or bunny_counts[2]:
        fail(f"the bunny gradient launched {bunny_counts} (march, sweep, "
             f"window) kernels")
    hold_draws("bunny gradient", grad_seen, path_draws["bunny gradient"],
               RAYS)
    # its forward is the forward render's, gamma aside
    lin = img.detach()[:cfg_b.num_pixels].clamp(min=0.0).sqrt()
    diff_img = np.abs(lin.reshape(march_img.shape).cpu().numpy() - march_img)
    print(f"bunny differentiable forward vs the render: "
          f"{float((diff_img <= 1e-4).mean()):.5f} of channels within 1e-4, "
          f"max |diff| {diff_img.max():.3g}")
    if (diff_img <= 1e-4).mean() < 0.99:
        fail("the bunny's differentiable forward disagrees with its render")

    # 6c. gradients on the card against the CPU twins, small
    small = dict(width=32, height=32, spp=2, max_depth=3, ray_chunk=1024)
    for name, make, cfg, kernel in (
            ("cornell-diff (pallas, NEE)",
             lambda d: get_preset("cornell-diff", device=d)[:2],
             cfg_d.replace(**small), 1),
            ("bunny (cluster)", lambda d: get_world("bunny", device=d),
             RenderConfig(accel="cluster", scene="bunny", **small), 0)):
        reset_counts()
        close, kept, g_grads, c_grads = diff.paired_gradients(
            make, cfg, (dev, "cpu"))
        launched = read_counts()[kernel]
        errs, bad = [], []
        for f in g_grads:
            err = np.abs(g_grads[f] - c_grads[f])
            ratio = float((err / (1e-7 + 1e-4 * np.abs(c_grads[f]))).max())
            errs.append(f"{f} max |diff| {err.max():.3g} ({ratio:.3g} of "
                        f"the tolerance)")
            if not (np.isfinite(g_grads[f]).all() and ratio <= 1.0):
                bad.append(f)
        print(f"gradients {name} card vs CPU twins: {close:.5f} of image "
              f"channels within 1e-4, {kept:.5f} of pixels kept; "
              + "; ".join(errs))
        if bad:
            fail(f"{name}: the card's {', '.join(bad)} gradients disagree "
                 f"with the CPU twins' beyond rtol 1e-4, atol 1e-7")
        if launched <= 0 or close < 0.99 or kept < 0.97:
            fail(f"{name}: {launched} kernel launches on the card, image "
                 f"agreement {close}, pixels kept {kept}")
    return fit_counts[1], bunny_counts[0]


def large_scenes(dev, card, march_img, run_cli, bunny_argv, out):
    """Phase 7 (module docstring), every launch counter reset just before
    each step and read just after; ``march_img`` is phase 4's one-pass
    bunny image and ``run_cli`` phase 4's CLI runner. Returns the march
    launches of the level-2 big-scene render."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.examples import big_scene
    from pathtracer_tpu_torch.ops import cluster_sweep
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.render.renderer import CLUSTER_K, make_renderer
    from pathtracer_tpu_torch.scene.bunny import bunny_world
    from pathtracer_tpu_torch.utils import checkpoint

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # 7a. the march on the level-3 bunny's camera wavefront, under the
    # automatic plan (cull2) and the flat cull
    (scene, cam), scene_s = timed(
        lambda: bunny_world(subdivide=BIG_LEVEL, device=dev))
    ct, table_s = timed(lambda: build_cluster_tables(scene, K=CLUSTER_K))
    print(f"level-{BIG_LEVEL} bunny: {scene.num_prims} prims, {ct.C_reg} "
          f"regular clusters of K={CLUSTER_K}; scene build {scene_s:.3f} s, "
          f"table build {table_s:.3f} s [{card}]")
    if cluster_sweep.cull_plan(ct.C_reg) != (True, 8):
        fail(f"the level-{BIG_LEVEL} bunny's plan is "
             f"{cluster_sweep.cull_plan(ct.C_reg)}, not cull2 with sup 8")
    o, d = camera_wavefront(dev, cam, RAYS, 0)
    prim_type = ct.scene.prim_type.cpu().numpy()
    hits = {}
    for name, cull2 in (("cull2 (auto)", None), ("flat", False)):
        reset_counts()
        q = cluster_sweep.march_inputs(ct, o, d, T_MIN, cull2=cull2)
        args = q["args"]
        kernel = cluster_sweep.march(*args)
        torch.cuda.synchronize()
        if read_counts() != (1, 0, 0):
            fail(f"march {name}: launched {read_counts()} (march, sweep, "
                 f"window) kernels")
        twin, plain_s = timed(lambda: cluster_sweep.march_reference(*args))
        t_k, b_k, s_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r, s_r = (x.cpu().numpy() for x in twin)
        compare_hits(f"level-{BIG_LEVEL} march {name}", t_k, b_k, t_r, b_r,
                     prim_type)
        if not (np.array_equal(b_k, b_r) and np.array_equal(t_k, t_r)
                and np.array_equal(s_k, s_r)):
            fail(f"level-{BIG_LEVEL} march {name}: kernel and twin are not "
                 f"bit-equal")
        n_walk, p50, longest = march_walk(s_k)
        ms = cuda_ms(lambda: cluster_sweep.march(*args), torch)
        run_ms = stream_ms(lambda: cluster_sweep.march(*args), torch)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        idx, t, valid = cluster_sweep.cluster_march(ct, o, d, T_MIN,
                                                    cull2=cull2)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        hits[name] = (idx.cpu().numpy(), t.cpu().numpy(), valid.cpu().numpy())
        query_ms = cuda_ms(lambda: cluster_sweep.cluster_march(
            ct, o, d, T_MIN, cull2=cull2), torch)
        print(f"level-{BIG_LEVEL} march {name} (sup {q['sup']}, {RAYS} "
              f"camera rays, {n_walk} of {s_k.shape[0]} chunks march, slots "
              f"p50 {p50:g} / max {longest} of {args[3].shape[1]}, bit-equal "
              f"to the twin): kernel {ms:.4f} ms, {run_ms:.4f} ms a launch "
              f"over 20 back-to-back launches, "
              f"{run_ms * 1e3 / longest:.3f} us per slot of the longest "
              f"chunk; plain twin {plain_s * 1e3:.1f} ms; "
              f"whole query {query_ms:.4f} ms, query peak memory "
              f"{peak / 2**20:.1f} MiB above {base / 2**20:.1f} MiB "
              f"[{card}]")
    (i2, t2, v2), (i1, t1, v1) = hits["cull2 (auto)"], hits["flat"]
    differ = v1 & (i1 != i2)
    if not (np.array_equal(v1, v2) and np.array_equal(t1[differ], t2[differ])
            and np.allclose(t2[v1], t1[v1], rtol=1e-6, atol=0.0)):
        fail(f"level-{BIG_LEVEL}: cull2 and the flat cull disagree")
    print(f"level-{BIG_LEVEL} cull2 vs flat: valid flags equal, {int(v1.sum())}"
          f" hits, {int(differ.sum())} winners differ (at bit-equal t), max "
          f"|dt| {float(np.abs(t2 - t1)[v1].max()):.3g}")
    del scene, cam, ct, o, d, q, args, kernel, twin

    # 7b. the big-scene example at its defaults (level 2) and at level 3,
    # each against the same render under the other cull
    big_launches = 0
    for level in BIG_SCENE_LEVELS:
        reset_counts()
        r = big_scene.render_big_scene(level, device=dev)
        counts = read_counts()
        if counts[0] <= 0 or counts[1] or counts[2]:
            fail(f"big scene level {level}: launched {counts} (march, sweep, "
                 f"window) kernels")
        if level == BIG_SCENE_LEVELS[0]:
            big_launches = counts[0]
        cfg = r["cfg"]
        img = r["img"].numpy()
        mean = check_image(f"big scene level {level}", img,
                           (cfg.height, cfg.width, 3), 0.3, 0.95)
        write_png_out(os.path.join(out, f"chip_smoke_big_l{level}.png"), img)
        other = "0" if r["cull2"] else "1"
        with environ({"PT_CLUSTER_CULL2": other}):
            render = make_renderer(cfg, dev)
            if render.prepare(r["scene"]).closest.cull_plan[0] == r["cull2"]:
                fail(f"big scene level {level}: PT_CLUSTER_CULL2={other} "
                     f"kept the plan")
            alt = render(r["scene"], r["cam"]).cpu().numpy()
        diff = np.abs(img - alt)
        close = float((diff <= 1e-4).mean())
        print(f"big scene level {level} ({r['prims']} prims, C_reg "
              f"{r['C_reg']}, cull2 {'on' if r['cull2'] else 'off'}, sup "
              f"{r['sup']}) {cfg.width}x{cfg.height} {cfg.spp} spp depth "
              f"{cfg.max_depth}, chunk {cfg.ray_chunk}: wall {r['wall_s']:.4f}"
              f" s ({cfg.num_pixels * cfg.spp * cfg.max_depth / r['wall_s'] / 1e6:.4f}"
              f" Mrays/s nominal), scene build {r['scene_s']:.3f} s, table "
              f"build {r['table_s']:.3f} s, {counts[0]} march launches, "
              f"image mean {mean:.5f}, all finite; vs the other cull "
              f"{close:.5f} of channels within 1e-4 [{card}]")
        if close < 0.999:
            fail(f"big scene level {level}: the image under the other cull "
                 f"disagrees")
        del r, render

    # 7c. the bunny at the bench shape in passes of 2 spp with a
    # checkpoint: stopped after the second pass and resumed
    ck_dir = os.path.join(out, "chip_smoke_checkpoint")
    os.makedirs(ck_dir, exist_ok=True)
    full_ck = os.path.join(ck_dir, "full.ckpt.npz")
    part_ck = os.path.join(ck_dir, "part.ckpt.npz")
    for path in (full_ck, part_ck):
        if os.path.exists(path):
            os.unlink(path)
    argv = bunny_argv + ["--spp-per-pass", "2"]
    full, seconds, cfg, stats, counts = run_cli(
        argv + ["--checkpoint", full_ck],
        os.path.join(ck_dir, "full.png"))
    save = checkpoint.save_render_state

    def save_then_stop(path, acc, next_sample, *rest):
        save(path, acc, next_sample, *rest)
        if next_sample == 4:
            raise KeyboardInterrupt
    with mock.patch.object(checkpoint, "save_render_state", save_then_stop):
        try:
            run_cli(argv + ["--checkpoint", part_ck],
                    os.path.join(ck_dir, "part.png"))
            fail("the checkpointed bunny did not stop after its second pass")
        except KeyboardInterrupt:
            pass
    state = checkpoint.load_render_state(part_ck, cfg, BUNNY_PRIMS)
    if state is None or state[1] != 4:
        fail(f"the stopped bunny's checkpoint holds {state and state[1]} spp")
    resumed, res_s, _, _, res_counts = run_cli(
        argv + ["--checkpoint", part_ck], os.path.join(ck_dir, "part.png"))
    to_one_pass = float(np.abs(full - march_img).max())
    print(f"bunny {cfg.width}x{cfg.height} {cfg.spp} spp in passes of 2 "
          f"with a checkpoint: "
          f"uninterrupted {seconds:.4f} s ({counts[0]} march launches), "
          f"resumed after 4 spp {res_s:.4f} s ({res_counts[0]} march "
          f"launches), resumed vs uninterrupted bit-equal "
          f"{np.array_equal(resumed, full)}, max |pass render - one-pass "
          f"render| {to_one_pass:.3g} [{card}]")
    if counts[0] <= 0 or res_counts[0] <= 0 or counts[1] or counts[2]:
        fail(f"the checkpointed bunny launched {counts} and {res_counts} "
             f"(march, sweep, window) kernels")
    if not np.array_equal(resumed, full):
        fail("the resumed bunny is not bit-equal to the uninterrupted one")
    if to_one_pass > 1e-6:
        fail(f"the pass render is {to_one_pass} off the one-pass render")
    return big_launches


def bvh_and_sharded(dev, card, march_img, run_cli, bunny_argv, out,
                    path_draws):
    """Phase 8 (module docstring), every launch counter reset just before
    each step and read just after; ``march_img`` is phase 4's one-pass
    bunny image and ``run_cli`` phase 4's CLI runner. Returns (march
    launches of the 2x1 sharded bunny, dense sweep launches of the
    sharded train step, the traversal kernel's readings: (ms, plain ms,
    bound ms, bound by) on the bunny's camera wavefront, its max |dt|
    against the twin, its launches on each "bvh" path)."""
    import pty
    import select
    import socket

    import numpy as np
    import torch
    from pathtracer_tpu_torch import oracle
    from pathtracer_tpu_torch.accel.lbvh import build_lbvh
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    from pathtracer_tpu_torch.ops import cluster_sweep, intersect, traversal
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.parallel import (initialize_distributed,
                                               make_mesh,
                                               make_sharded_renderer)
    from pathtracer_tpu_torch.parallel.sharded import _shard_plan
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.render import diff, integrator
    from pathtracer_tpu_torch.render.renderer import (CLUSTER_K,
                                                      make_renderer)
    from pathtracer_tpu_torch.scene.bunny import bunny_world
    from pathtracer_tpu_torch.scene.worlds import get_world
    from pathtracer_tpu_torch.viewer.interactive import ViewerSession

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        return result, time.perf_counter() - t0

    # 8a. the LBVH of the bunny and of the level-2 bunny, on the card and
    # on the CPU; the card's builds are kept for 8b
    card_builds = {}
    for level in (0, BIG_SCENE_LEVELS[0]):
        scene, cam_l = bunny_world(subdivide=level, device="cpu")[:2] \
            if level else get_world("bunny", device="cpu")
        cpu, cpu_s = timed(lambda: build_lbvh(scene))
        scene_g = scene.to(dev)
        build_lbvh(scene_g)                          # warm-up
        card_bvh, card_s = timed(lambda: build_lbvh(scene_g))
        for name, a, b in zip(cpu._fields, cpu, card_bvh):
            if not torch.equal(a, b.cpu()):
                fail(f"LBVH level {level}: {name} built on the card differs "
                     f"from the CPU build")
        print(f"LBVH bunny level {level} ({scene.num_prims} prims, "
              f"{card_bvh.num_nodes} nodes): card build {card_s:.4f} s, CPU "
              f"build {cpu_s:.4f} s, all seven arrays equal [{card}]")
        card_builds[level] = (scene_g, cam_l.to(dev), card_bvh)
    del scene, scene_g, cpu, card_bvh

    # 8b. the traversal kernel against its twin on four wavefronts, and
    # the march (K1) on the same rays
    scene, cam = get_world("bunny", device=dev)
    ct = build_cluster_tables(scene, K=CLUSTER_K)
    nodes = traversal.pack_fat_nodes(scene, card_builds[0][2])
    o, d = camera_wavefront(dev, cam, RAYS, 0)
    idx_m, t_m, v_m = cluster_sweep.cluster_march(ct, o, d, T_MIN)
    b_m = torch.where(v_m, ct.perm[idx_m.long()], -1)
    o_b, d_b, p_s, seg = bounce_and_shadow(
        dev, scene, *traversal.traverse(nodes, o, d, T_MIN, intersect.BIG_T),
        o, d)
    scene2, cam2, bvh2 = card_builds[BIG_SCENE_LEVELS[0]]
    o2, d2 = camera_wavefront(dev, cam2, RAYS, 0)
    waves = [("camera", nodes, ct, o, d, T_MIN),
             ("bounce", nodes, ct, o_b, d_b, T_MIN),
             ("shadow", nodes, ct, p_s, seg, K_SHADOW_T_MIN),
             (f"level-{BIG_SCENE_LEVELS[0]} camera",
              traversal.pack_fat_nodes(scene2, bvh2),
              build_cluster_tables(scene2, K=CLUSTER_K), o2, d2, T_MIN)]
    traverse_err = 0.0
    bvh_main = None
    for name, nodes_w, ct_w, o_w, d_w, t_min in waves:
        reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = traversal.traverse(nodes_w, o_w, d_w, t_min,
                                     intersect.BIG_T)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launches = read_traversals()
        if launches != 1 or read_counts() != (0, 0, 0):
            fail(f"BVH {name} query: {launches} traversal launches and "
                 f"{read_counts()} (march, sweep, window), expected 1 and "
                 f"none")
        (visits, want), counted_s = timed(lambda: twin_visits(
            nodes_w, o_w, d_w, t_min))
        for x, y in zip(got, want):
            if x.dtype != y.dtype or not torch.equal(x, y):
                fail(f"BVH {name} query: the traversal kernel and its twin "
                     f"are not bit-equal")
        if not torch.equal(got[1].view(torch.int32),
                           want[1].view(torch.int32)):
            fail(f"BVH {name} query: t differs from the twin's in its bits")
        both = got[2] & want[2]
        if bool(both.any()):
            traverse_err = max(traverse_err, float(
                (got[1] - want[1])[both].abs().max()))
        ms = cuda_ms(lambda: traversal.traverse(nodes_w, o_w, d_w, t_min,
                                                intersect.BIG_T), torch)
        march_ms = cuda_ms(lambda: cluster_sweep.cluster_march(
            ct_w, o_w, d_w, t_min), torch)
        ops = (OPS_TRAV_RAY * o_w.shape[0] + OPS_BOX_VISIT * visits["visits"]
               + OPS_SPHERE_TEST * visits["spheres"]
               + OPS_TRI_TEST * visits["triangles"])
        b_ms, b_by = bound(nbytes(o_w, d_w, nodes_w.fdata, nodes_w.idata,
                                  *got), ops)
        print(f"BVH {name} wavefront ({o_w.shape[0]} rays, "
              f"{nodes_w.fdata.shape[0]} rows, t_min {t_min:g}, "
              f"{int(got[2].sum())} hits, bit-equal to the twin, one launch, "
              f"no host sync): kernel {ms:.4f} ms, plain twin with its "
              f"counters {counted_s * 1e3:.4f} ms ({visits['steps']} steps), "
              f"the march's whole query {march_ms:.4f} ms; bound "
              f"{b_ms:.6f} ms ({b_by}, "
              f"{visits['visits']} node visits, {visits['spheres']} sphere "
              f"and {visits['triangles']} triangle tests, "
              f"{ops / 1e9:.4f} GFLOP); longest ray {visits['longest']} "
              f"steps, {ms * 1e3 / visits['longest']:.3f} us a step of it "
              f"[{card}]")
        if name == "camera":
            _, plain_s = timed(lambda: traversal.traverse_reference(
                nodes, o, d, T_MIN, intersect.BIG_T))
            bvh_main = (ms, plain_s * 1e3, b_ms, b_by)
            print(f"plain twin alone on the camera wavefront: "
                  f"{plain_s * 1e3:.4f} ms (one call) [{card}]")
            b_b = torch.where(got[2], got[0], -1)
            err = compare_hits("BVH vs march (camera)", got[1].cpu().numpy(),
                               b_b.cpu().numpy(), t_m.cpu().numpy(),
                               b_m.cpu().numpy(),
                               scene.prim_type.cpu().numpy())
            print(f"BVH vs march, camera wavefront: winners equal but at "
                  f"near ties, max |dt| {err:.3g}")
            with op_counter() as ops_n:
                traversal.traverse_reference(nodes, o, d, T_MIN,
                                             intersect.BIG_T)
            print(f"the twin dispatched {ops_n.n} aten ops on the camera "
                  f"wavefront, {ops_n.n / visits['steps']:.2f} a step")
    prim_type_ct = ct.scene.prim_type.cpu().numpy()   # the march's order
    del ct, waves, o, d, o_b, d_b, p_s, seg, o2, d2, idx_m, t_m, v_m, b_m
    del got, want, scene2, cam2, bvh2, card_builds

    # 8c. "bvh"-route renders through the CLI against the brute route (the
    # same intersection arithmetic: bit-equal): the bunny, and cornell-full
    # with NEE (the shadow query); one traversal launch a query
    bvh_paths = {}
    for what, argv, shape, lo in (
            ("bunny", ["--scene", "bunny", "--width", "160", "--height",
                       "90", "--spp", "1", "--max-depth", "4",
                       "--ray-chunk", "14400"], (90, 160, 3), 0.3),
            ("cornell-full", ["--preset", "cornell-full", "--scale", "0.25",
                              "--ray-chunk", "4096"], (64, 64, 3), 0.05)):
        imgs = {}
        for accel in ("bvh", "brute"):
            img_np, seconds, cfg, stats, counts = run_cli(
                argv + ["--accel", accel],
                os.path.join(out, f"chip_smoke_{what}_{accel}.png"))
            launches = read_traversals()
            imgs[accel] = img_np
            mean = check_image(f"{what} ({accel})", img_np, shape, lo, 0.95)
            queries = (stats[0] + stats[1]) / min(cfg.ray_chunk,
                                                  cfg.num_pixels)
            print(f"render {what} {cfg.width}x{cfg.height} {cfg.spp} spp "
                  f"depth {cfg.max_depth}{', nee' if cfg.nee else ''}, accel "
                  f"{accel}: {seconds:.4f} s wall, {stats[0]:.0f} closest-hit"
                  f" and {stats[1]:.0f} shadow rays ({queries:g} queries), "
                  f"{launches} traversal launches, image mean {mean:.5f} "
                  f"[{card}]")
            if counts != (0, 0, 0) or launches != (
                    queries if accel == "bvh" else 0):
                fail(f"the {accel} {what} launched {counts} (march, sweep, "
                     f"window) and {launches} traversal kernels for "
                     f"{queries:g} queries")
            if what == "cornell-full" and not (cfg.nee and stats[1] > 0):
                fail("the cornell-full render ran no shadow query")
            if accel == "bvh":
                bvh_paths[what] = launches
        if not np.array_equal(imgs["bvh"], imgs["brute"]):
            fail(f"the bvh {what} image is not bit-equal to the brute image: "
                 f"max |diff| {np.abs(imgs['bvh'] - imgs['brute']).max():.3g}")
        print(f"{what} bvh vs brute image: bit-equal")

    # 8c'. the bench-shape bunny on the "bvh" route through the CLI,
    # bit-equal to the "brute" route's image at the same shape (the same
    # intersection arithmetic, as in 8c), and beside phase 4's march image
    # and the march route's wall in this process; each traversal call one
    # launch with no host sync inside. The march image is held only at
    # mean |diff| <= 1e-3: the march takes t through the pair-scalar sweep,
    # the direct formulas' near ties differ by up to ~3.5e-5 in t, and four
    # bounces carry that past 1e-4 on about 2% of channels
    real_traverse = traversal.traverse
    calls = []

    def no_sync_traverse(*args, **kw):
        calls.append(args[1].shape[0])
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_traverse(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    walls, bench_imgs = {}, {}
    for accel in ("cluster", "brute", "bvh"):
        with mock.patch.object(traversal, "traverse", no_sync_traverse):
            img_np, walls[accel], cfg, stats, counts = run_cli(
                bunny_argv + ["--accel", accel],
                os.path.join(out, f"chip_smoke_bunny_bench_{accel}.png"))
        launches = read_traversals()
        bench_imgs[accel] = img_np
        if accel != "bvh":
            if (counts[0] > 0) != (accel == "cluster") or counts[1:] != \
                    (0, 0) or launches:
                fail(f"the {accel} bunny launched {counts} (march, sweep, "
                     f"window) and {launches} traversal kernels")
            continue
        queries = stats[0] / RAYS
        if counts != (0, 0, 0) or launches != queries or len(calls) != \
                launches or set(calls) != {RAYS}:
            fail(f"the bench-shape bvh bunny: {launches} traversal launches "
                 f"for {queries:g} queries ({len(calls)} calls of "
                 f"{sorted(set(calls))} rays), {counts} (march, sweep, "
                 f"window)")
        bvh_paths["bunny bench shape"] = launches
    mean = check_image("bunny (bvh)", bench_imgs["bvh"], march_img.shape,
                       0.3, 0.95)
    gap = np.abs(bench_imgs["bvh"] - bench_imgs["brute"])
    gap_m = np.abs(bench_imgs["bvh"] - march_img)
    print(f"render bunny {cfg.width}x{cfg.height} {cfg.spp} spp depth "
          f"{cfg.max_depth}, accel bvh, chunk {cfg.ray_chunk}: "
          f"{walls['bvh']:.4f} s wall against the march route's "
          f"{walls['cluster']:.4f} s in this process "
          f"({walls['bvh'] / walls['cluster']:.3f}x; brute "
          f"{walls['brute']:.4f} s), {launches} traversal launches for "
          f"{queries:g} queries, none with a host sync; image mean "
          f"{mean:.5f}; against the brute image max |diff| {gap.max():.3g} "
          f"({'bit-equal' if not gap.any() else 'not bit-equal'}); "
          f"against phase 4's march image "
          f"{float((gap_m <= 1e-4).mean()):.5f} within 1e-4, mean |diff| "
          f"{gap_m.mean():.3g} [{card}]")
    if not np.array_equal(bench_imgs["bvh"], bench_imgs["brute"]):
        fail("the bench-shape bvh image is not bit-equal to the brute image")
    if gap_m.mean() > 1e-3:
        fail("the bench-shape bvh bunny disagrees with the march image")
    del bench_imgs, gap, gap_m

    # 8d. the sharded renderer on meshes of the one card, at the bench
    # shape; a rays-only mesh equals the single render with its plan's
    # chunk to the bit
    from pathtracer_tpu_torch import __main__ as cli
    args = cli.build_parser().parse_args(bunny_argv + ["--device", DEVICE])
    _, _, cfg_b = cli.scene_and_config(args, dev)
    sharded_marches = 0
    real_march = cluster_sweep.march
    real_trace = integrator.trace

    def check_sharded_marches(marched, chunk):
        """K1 against its twin on the first camera and the first bounce
        wavefront in which the 2x1 sharded render marched a chunk (chunk
        rays each), bit-equal (phase 3a)."""
        if len(marched) != 2:
            fail(f"the 2x1 sharded render marched {sorted(marched)} of the "
                 f"camera and bounce wavefronts")
        for name, args in marched.items():
            lanes = -(-chunk // args[11]) * args[11]   # whole ray tiles
            if args[0].shape[0] != lanes:
                fail(f"sharded 2x1 {name}: {args[0].shape[0]} lanes "
                     f"marched, expected {lanes}")
            kernel = real_march(*args)
            torch.cuda.synchronize()
            twin = cluster_sweep.march_reference(*args)
            t_k, b_k, s_k = (x.cpu().numpy() for x in kernel)
            t_r, b_r, s_r = (x.cpu().numpy() for x in twin)
            compare_hits(f"sharded 2x1 march {name}", t_k, b_k, t_r, b_r,
                         prim_type_ct)
            if not (np.array_equal(b_k, b_r) and np.array_equal(t_k, t_r)
                    and np.array_equal(s_k, s_r)):
                fail(f"sharded 2x1 march {name}: kernel and twin are not "
                     f"bit-equal (t, best or slots per chunk)")
            print(f"march on the 2x1 sharded render's first {name} "
                  f"wavefront that marches ({chunk} rays, "
                  f"{int((b_k >= 0).sum())} cluster hits, {int(s_k.sum())} "
                  f"slots): bit-equal to the twin")

    for devices, spp_axis in (([dev], 1), ([dev, dev], 1), ([dev, dev], 2)):
        mesh = make_mesh(devices, spp_axis_size=spp_axis)
        shape = f"{mesh.shape['rays']}x{mesh.shape['spp']}"
        chunk = _shard_plan(cfg_b, mesh)[4]
        render = make_sharded_renderer(cfg_b, mesh)
        render.prepare(scene)
        marched, path = {}, []

        def tracing(*args, **kw):
            path.clear()                 # a chunk's path starts
            return real_trace(*args, **kw)

        def recording(*args):
            # a path's closest-hit queries (NEE shadow queries run at
            # another t_min): the camera query, then the bounces; keep the
            # first camera and first bounce query in which a chunk marched
            # (a lane that hits only the residual marches nothing)
            out = real_march(*args)
            if len(marched) < 2 and (not path or args[9] == path[0]):
                depth = len(path)
                path.append(args[9])
                name = ("camera", "bounce")[depth] if depth < 2 else None
                if name and name not in marched and bool(out[2].any()):
                    marched[name] = args
            return out
        reset_counts()
        with mock.patch.object(cluster_sweep, "march", recording), \
                mock.patch.object(integrator, "trace", tracing), \
                recording_draws() as seen:
            img, wall = timed(lambda: render(scene, cam))
        counts = read_counts()
        draws = path_draws[f"sharded bunny {shape}"] = read_draws()
        hold_draws(f"sharded bunny {shape}", seen, draws, chunk)
        if shape == "2x1":
            check_sharded_marches(marched, chunk)
        if counts[0] <= 0 or counts[1] or counts[2]:
            fail(f"sharded bunny {shape}: launched {counts} (march, sweep, "
                 f"window) kernels")
        img = img.cpu().numpy()
        if shape == "2x1":
            sharded_marches = counts[0]
        elif shape == "1x1":
            one_slot = img
        if chunk == RAYS:
            single = march_img
        else:
            single = make_renderer(cfg_b.replace(ray_chunk=chunk), dev)(
                scene, cam).cpu().numpy()
        gap = float(np.abs(img - single).max())
        same = np.array_equal(img, single)
        print(f"sharded bunny {shape} on {len(devices)} slot(s) of the card"
              f", chunk {chunk}: wall {wall:.4f} s, {counts[0]} march "
              f"launches, max |sharded - single render| {gap:.3g} "
              f"({'bit-equal' if same else 'not bit-equal'}) [{card}]")
        if (spp_axis == 1 and not same) or gap > 1e-6:
            fail(f"sharded bunny {shape} differs from the single render")

    # 8e. a one-rank NCCL process group, and a sharded render under it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"localhost:{port}", 1, 0, device=DEVICE)
    try:
        backend = torch.distributed.get_backend()
        if backend != "nccl":
            fail(f"the process group runs {backend}, not NCCL")
        mesh = make_mesh([dev])
        reset_counts()
        img, wall = timed(lambda: make_sharded_renderer(cfg_b, mesh)(scene,
                                                                     cam))
        counts = read_counts()
    finally:
        torch.distributed.destroy_process_group()
    same = np.array_equal(img.cpu().numpy(), one_slot)
    print(f"sharded bunny 1x1 under a one-rank NCCL group (all_reduce of "
          f"the framebuffer): wall {wall:.4f} s, {counts[0]} march launches"
          f", bit-equal to the 1x1 render without a group {same} [{card}]")
    if not same or counts[0] <= 0:
        fail("the sharded render under NCCL differs from the one without")

    # 8f. the sharded cornell-diff train step (2x1 on the card) against
    # the unsharded step with the plan's chunk
    scene_d, cam_d, cfg_d = get_preset("cornell-diff", device=dev)
    cfg_d = cfg_d.replace(accel="pallas")
    mesh = make_mesh([dev, dev])
    chunk = _shard_plan(cfg_d, mesh)[4]
    target = torch.full((cfg_d.num_pixels, 3), 0.2, device=dev)
    runs = []
    for name, m, cfg in (("sharded 2x1", mesh, cfg_d),
                         ("unsharded", None, cfg_d.replace(ray_chunk=chunk))):
        params = diff.scene_params(scene_d, ("albedo", "emit"))
        opt = torch.optim.SGD(list(params.values()), lr=0.0)
        step = diff.make_train_step(cfg, opt, mesh=m)
        reset_counts()
        loss, wall = timed(lambda: step(params, scene_d, cam_d, target, 1))
        counts = read_counts()
        runs.append((float(loss), {f: p.grad.cpu().numpy()
                                   for f, p in params.items()}, counts))
        print(f"train step cornell-diff {name} (chunk {chunk}, accel "
              f"pallas): loss {float(loss):.8g}, {wall:.4f} s, {counts[1]} "
              f"sweep launches [{card}]")
    (l_s, g_s, c_s), (l_u, g_u, c_u) = runs
    # rtol 1e-5 per entry: the slots' sums add in another order; atol
    # 1e-9 only for an entry that cancels to about zero
    worst = max(float((np.abs(g_s[f] - g_u[f])
                       / (1e-9 + 1e-5 * np.abs(g_u[f]))).max()) for f in g_s)
    print(f"sharded vs unsharded step: loss rel diff "
          f"{abs(l_s - l_u) / l_u:.3g}, worst gradient entry at {worst:.3g} "
          f"of rtol 1e-5 (atol 1e-9)")
    if c_s[1] <= 0 or c_s[0] or c_s[2]:
        fail(f"the sharded step launched {c_s} (march, sweep, window)")
    if abs(l_s - l_u) > 1e-5 * abs(l_u) or worst > 1.0:
        fail("the sharded train step disagrees with the unsharded step")

    # 8g. the viewer on the test world's "bvh" route: a session for 3
    # frames and a key, then the CLI's --interactive under a
    # pseudo-terminal (w, then ESC)
    scene_t, cam_t = get_world("test", device=dev)
    cfg_v = cfg_b.replace(width=64, height=36, max_depth=3, accel="bvh")
    reset_counts()
    with recording_traversals() as viewer_traversals:
        sess = ViewerSession(scene_t, cam_t, cfg_v, device=dev)
        frames = [sess.step() for _ in range(3)]
        moved = sess.handle_key("w", 0.1)
        frames.append(sess.step())
    bvh_paths["viewer session"] = read_traversals()
    if not (moved and sess.passes == 1 and all(
            np.isfinite(f).all() and f.shape == (36, 64, 3) for f in frames)):
        fail("the viewer session did not render, accumulate and restart")
    hold_traversals("viewer session", viewer_traversals,
                    bvh_paths["viewer session"],
                    min(cfg_v.ray_chunk, cfg_v.num_pixels))
    master, slave = pty.openpty()
    env = dict(os.environ, PYTHONPATH=HERE)
    viewer = subprocess.Popen(
        [sys.executable, "-m", "pathtracer_tpu_torch", "--scene", "test",
         "--width", "64", "--height", "36", "--max-depth", "3", "--accel",
         "bvh", "--interactive", "--device", DEVICE], stdin=slave,
        stdout=slave, stderr=slave,
        cwd=HERE, env=env, close_fds=True)
    os.close(slave)
    text = b""
    sent = []
    t0 = time.perf_counter()
    try:
        while viewer.poll() is None and time.perf_counter() - t0 < 180:
            r, _, _ = select.select([master], [], [], 0.5)
            if r:
                try:
                    text += os.read(master, 1 << 16)
                except OSError:
                    break
            n_frames = text.count(b"FPS")
            if n_frames >= 2 and not sent:
                os.write(master, b"w")
                sent.append(n_frames)
            elif len(sent) == 1 and n_frames >= sent[0] + 2:
                os.write(master, b"\x1b")
                sent.append(n_frames)
        try:
            rc = viewer.wait(timeout=30)
        except subprocess.TimeoutExpired:
            rc = None
    finally:
        if viewer.poll() is None:
            viewer.kill()
            viewer.wait()
        os.close(master)
    n_frames = text.count(b"FPS")
    print(f"viewer: ViewerSession 4 frames on the card (a move restarts "
          f"its passes); --interactive under a pty: exit {rc}, {n_frames} "
          f"frames, keys sent after frames {sent} [{card}]")
    if rc != 0 or len(sent) != 2 or b"passes: 1 " not in text[
            text.find(b"FPS", text.find(b"FPS") + 1):]:
        fail(f"the interactive viewer did not quit cleanly on ESC after a "
             f"move: {text[-2000:]!r}")

    # 8h. the NumPy oracle against the port's card render of the test world
    w, h, spp, depth = 64, 36, 24, 8
    (mean, _), oracle_s = timed(lambda: oracle.render(scene_t, cam_t, w, h,
                                                      spp, depth, seed=7))
    stats = oracle.compare_to_torch(scene_t, cam_t, w, h, spp, depth, mean,
                                    seed=7, scene_name="test", device=DEVICE)
    print(f"oracle test world {w}x{h} {spp} spp depth {depth} "
          f"({oracle_s:.2f} s on the host) vs the card render: {stats} "
          f"[{card}]")
    # the noise-scaled bounds of the CPU parity tests (tests/test_oracle.py)
    if not (abs(stats["mean_signed_diff"]) < 0.004
            and stats["mean_abs_cross"] <= 1.35 * stats["mean_abs_self"]
            + 5e-3 and stats["p99_cross"] <= 1.5 * stats["p99_self"] + 0.02):
        fail(f"the card render disagrees with the oracle: {stats}")
    return sharded_marches, c_s[1], (bvh_main, traverse_err, bvh_paths)


def run_bench(argv):
    """``python -m pathtracer_tpu_torch.bench`` of this checkout with
    ``argv``, in its own processes (its watchdog and measured child): its
    one JSON line, and the seconds the command took. Fails unless it exits
    0 with exactly one line."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.bench", *argv],
        cwd=HERE, capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=HERE))
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or len(lines) != 1:
        fail(f"bench {' '.join(argv)}: exit {proc.returncode}, "
             f"{len(lines)} JSON lines:\n{proc.stdout[-3000:]}\n"
             f"{proc.stderr[-3000:]}")
    return json.loads(lines[0]), time.perf_counter() - t0


def bench_text(rec) -> str:
    """One bench line as printed here."""
    c = rec["config"]
    launches = ", ".join(f"{k} {v}" for k, v in rec["launches"].items()
                         if v)
    return (f"{rec['metric']} {c['width']}x{c['height']} {c['spp']} spp depth "
            f"{c['depth']}, accel {rec['accel']}, chunk {c['ray_chunk']}: "
            f"{rec['value']:.4f} Mrays/s nominal, "
            f"{rec['executed_mrays_per_s']:.4f} executed, walls "
            f"{', '.join(f'{w:.4f}' for w in rec['walls_s'])} s (mean "
            f"{rec['wall_s']:.4f}), setup {rec['setup_s']:.4f} s, warm-up "
            f"{rec['warmup_s']:.4f} s, peak memory "
            f"{rec['peak_mem_mib']:.1f} MiB, {rec['executed_queries']} of "
            f"{rec['nominal_queries']} queries, {rec['shadow_queries']} "
            f"shadow, {rec['pair_tests']} pair tests, march "
            f"{rec['march_tflops']} TFLOP/s (upper count, mfu "
            f"{rec['march_mfu']}), launches over {c['iters']} renders: "
            f"{launches or 'none'}; correct {rec['correct']} "
            f"({rec['check']['close_share']:.5f} of channels within 1e-4, "
            f"mean |diff| {rec['check']['mean_abs_diff']:.3g}) "
            f"[{rec['device']['name']}, {rec['device']['power_limit']}, "
            f"SM {rec['device']['clocks_sm']}, "
            f"{rec['device']['temperature']} C]")


def check_bench(rec, card, what):
    """Phase 9's checks of one bench line."""
    if not rec["correct"]:
        fail(f"{what}: the bench's check failed: {rec['check']}")
    if not (rec["value"] and rec["value"] > 0
            and 0 < rec["executed_queries"] <= rec["nominal_queries"]):
        fail(f"{what}: value {rec['value']}, {rec['executed_queries']} of "
             f"{rec['nominal_queries']} queries")
    if rec["march_mfu"] is not None and rec["march_mfu"] > 1.0:
        fail(f"{what}: march_mfu {rec['march_mfu']} > 1")
    if rec["device"]["name"] != card.split(",")[0].strip():
        fail(f"{what}: the bench ran on {rec['device']} and not on {card}")


@contextlib.contextmanager
def recording_work(module, name, works, tail=8):
    """Inside the block, the kernel wrapper ``module.name`` records the
    arguments of calls whose result ``works``, by their number of rays:
    the first such call of each size (a host sync each call only until
    it is found) and the last (the last such of the ``tail`` calls of its
    size that follow the first, found after the block, with no sync while
    the block runs). Yields {rays: {"first": args, "last": args}}."""
    real = getattr(module, name)
    seen, recent = {}, {}

    def recording(*args):
        out = real(*args)
        rays = args[0].shape[0]
        if rays in seen:
            recent[rays].append((args, out))
        elif works(out):
            seen[rays] = {"first": args}
            recent[rays] = collections.deque(maxlen=tail)
        return out
    try:
        with mock.patch.object(module, name, recording):
            yield seen
    finally:
        for rays, calls in recent.items():
            for args, out in reversed(calls):
                if works(out):
                    seen[rays]["last"] = args
                    break


def marched(out) -> bool:
    """A march that swept at least one cluster slot."""
    return bool(out[2].any())


def swept_a_hit(out) -> bool:
    """A dense sweep in which at least one ray hit."""
    return bool((out[1] >= 0).any())


def hold_recorded(what, seen, kernel, twin, chunk=None):
    """``kernel`` (the wrapper, on the card) bit-equal to its plain
    ``twin`` on each call :func:`recording_work` kept. With ``chunk``, a
    call on the path's chunk must be among them: ``chunk`` rays, or for
    the march ``chunk`` rounded up to whole ray tiles."""
    import numpy as np
    import torch

    def lanes(args):
        tile = args[11] if len(args) == 12 else 1   # the march's ray_tile
        return -(-chunk // tile) * tile

    if not seen or chunk is not None and not any(
            n == lanes(calls["first"]) for n, calls in seen.items()):
        fail(f"{what}: no call that did work at the path's chunk "
             f"({chunk} rays) recorded; sizes {sorted(seen)}")
    for n, calls in sorted(seen.items()):
        for which, args in calls.items():
            with torch.no_grad():
                out_k = kernel(*args)
                torch.cuda.synchronize()
                out_r = twin(*args)
            k = [x.cpu().numpy() for x in out_k]
            r = [x.cpu().numpy() for x in out_r]
            if not all(np.array_equal(a, b) for a, b in zip(k, r)):
                fail(f"{what}: the {which} {n}-ray call that did work: "
                     f"kernel and twin are not bit-equal (max |dt| "
                     f"{float(np.abs(k[0] - r[0]).max()):.3g}, "
                     f"{int((k[1] != r[1]).sum())} winners differ)")
            slots = f", {int(k[2].sum())} slots" if len(k) == 3 else ""
            print(f"{what}: the {which} {n}-ray call that did work "
                  f"({int((k[1] >= 0).sum())} hits{slots}): kernel "
                  f"bit-equal to the twin")


@contextlib.contextmanager
def recording_draws():
    """Inside the block, the draws wrapper (``ops/uniforms``) records the
    arguments of its first and last call of each signature: ("flat",
    shape) or ("by_ray", rays, m). Yields {signature: {"first": args,
    "last": args}}."""
    from pathtracer_tpu_torch.ops import uniforms
    flat, by_ray = uniforms.uniform, uniforms.uniform_by_ray
    seen = {}

    def note(sig, args):
        seen.setdefault(sig, {"first": args})["last"] = args

    def flat_recording(key, shape, device):
        note(("flat", tuple(shape)), (key, tuple(shape), device))
        return flat(key, shape, device)

    def by_ray_recording(key, rid, m):
        note(("by_ray", rid.shape[0], m), (key, rid, m))
        return by_ray(key, rid, m)
    with mock.patch.object(uniforms, "uniform", flat_recording), \
            mock.patch.object(uniforms, "uniform_by_ray", by_ray_recording):
        yield seen


def draw_text(sig) -> str:
    return (f"flat {sig[1]}" if sig[0] == "flat"
            else f"by_ray {sig[1]} x {sig[2]}")


def hold_draws(what, seen, launches, chunk=None, ms=(6,)):
    """The draws kernel bit-equal to its twin on each call
    :func:`recording_draws` kept, after a path that launched it
    ``launches`` times (which must be positive). With ``chunk``, the
    camera's flat (2, chunk) set and a by-ray set on ``chunk`` rays for
    each m in ``ms`` must be among them."""
    import torch
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import uniforms
    need = [] if chunk is None else (
        [("flat", (2, chunk))] + [("by_ray", chunk, m) for m in ms])
    missing = [draw_text(sig) for sig in need if sig not in seen]
    if launches <= 0:
        fail(f"{what}: the path launched no draws kernel")
    if not seen or missing:
        fail(f"{what}: no draws recorded at the path's chunk "
             f"({', '.join(missing)}); recorded "
             f"{', '.join(draw_text(sig) for sig in sorted(seen))}")
    n = 0
    for sig, calls in sorted(seen.items()):
        kernel, twin = ((uniforms.uniform, prng.uniform) if sig[0] == "flat"
                        else (uniforms.uniform_by_ray, prng.uniform_by_ray))
        for which, args in calls.items():
            if which == "last" and args is calls["first"]:
                continue
            got = kernel(*args)
            ref = twin(*args)
            if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
                fail(f"{what}: the {which} {draw_text(sig)} draw set: the "
                     f"draws kernel and its twin are not bit-equal")
            n += 1
    print(f"{what}: {launches} draws-kernel launches; the kernel bit-equal "
          f"to its twin on {n} recorded calls "
          f"({', '.join(draw_text(sig) for sig in sorted(seen))})")


@contextlib.contextmanager
def recording_traversals():
    """Inside the block, the traversal wrapper (``ops/traversal.traverse``)
    records its arguments, rays copied, on its first and last call of each
    signature (rays, t_min). Yields {signature: {"first": args, "last":
    args}}."""
    from pathtracer_tpu_torch.ops import traversal
    real = traversal.traverse
    seen = {}

    def recording(nodes, o, d, t_min, t_max, max_steps=0):
        args = (nodes, o.clone(), d.clone(), t_min, t_max, max_steps)
        seen.setdefault((o.shape[0], float(t_min)),
                        {"first": args})["last"] = args
        return real(nodes, o, d, t_min, t_max, max_steps)
    with mock.patch.object(traversal, "traverse", recording):
        yield seen


def hold_traversals(what, seen, launches, chunk):
    """The traversal kernel bit-equal (winner, t bits, valid) to its twin
    ``traverse_reference`` on each call :func:`recording_traversals` kept,
    after a path that launched it ``launches`` times (which must be
    positive); a call on ``chunk`` rays (the path's chunk) must be among
    them, and some recorded call must hit."""
    import torch
    from pathtracer_tpu_torch.ops import traversal
    if launches <= 0:
        fail(f"{what}: the path launched no traversal kernel")
    if not any(rays == chunk for rays, _ in seen):
        fail(f"{what}: no traversal recorded at the path's chunk ({chunk} "
             f"rays); recorded {sorted(seen)}")
    n = hits = 0
    for sig, calls in sorted(seen.items()):
        for which, args in calls.items():
            if which == "last" and args is calls["first"]:
                continue
            got = traversal.traverse(*args)
            want = traversal.traverse_reference(*args)
            if not (torch.equal(got[0], want[0]) and torch.equal(
                    got[1].view(torch.int32), want[1].view(torch.int32))
                    and torch.equal(got[2], want[2])):
                fail(f"{what}: the {which} {sig[0]}-ray traversal at t_min "
                     f"{sig[1]:g}: the kernel and its twin are not "
                     f"bit-equal")
            hits += int(got[2].sum())
            n += 1
    if not hits:
        fail(f"{what}: no recorded traversal hit anything")
    print(f"{what}: {launches} traversal launches; the kernel bit-equal to "
          f"its twin on {n} recorded calls ({hits} hits; "
          f"{', '.join(f'{r} rays at t_min {t:g}' for r, t in sorted(seen))})")


def entry_points(dev, card, out, path_draws, bvh_paths):
    """Phase 9 (module docstring). Returns (the bench's march launches over
    its timed renders at its defaults, its dense sweep launches over the
    pallas runs of 9b); each step's draws launches go into
    ``path_draws``, and the dry run's traversal launches (its BVH leg) into
    ``bvh_paths``."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch import bench_scaling
    from pathtracer_tpu_torch.entry import ENTRY_CFG, dryrun_multichip, entry
    from pathtracer_tpu_torch.examples import inverse_rendering
    from pathtracer_tpu_torch.ops import cluster_sweep, pallas_sweep
    from pathtracer_tpu_torch.render.renderer import render_image

    # 9a. the bench at its defaults; its child resets the launch counters
    # just before its timed renders and reports them just after
    rec, seconds = run_bench([])
    check_bench(rec, card, "bench at its defaults")
    bench_marches = rec["launches"]["cluster_march"]
    iters = rec["config"]["iters"]
    print(f"bench line: {json.dumps(rec)}")
    print(f"bench {bench_text(rec)}; {bench_marches / iters:g} march "
          f"launches a render; the command took {seconds:.1f} s")
    path_draws["bench"] = rec["launches"]["ray_uniforms"]
    if rec["metric"] != "bunny_forward_throughput" or bench_marches <= 0 \
            or rec["accel"] != "cluster" or path_draws["bench"] <= 0:
        fail(f"the bench at its defaults ran {rec['metric']} on "
             f"{rec['accel']} with {rec['launches']}")
    # ... and on the "bvh" route: one traversal launch a closest-hit query
    # of each timed render (``executed_queries`` counts the last render's
    # rays; every render of the bunny runs all its queries)
    rec, seconds = run_bench(["--accel", "bvh"])
    check_bench(rec, card, "bench --accel bvh")
    queries = rec["executed_queries"] / rec["config"]["ray_chunk"]
    bvh_paths["bench --accel bvh"] = rec["launches"]["bvh_traverse"]
    path_draws["bench --accel bvh"] = rec["launches"]["ray_uniforms"]
    print(f"bench line: {json.dumps(rec)}")
    print(f"bench {bench_text(rec)}; {queries:g} closest-hit queries a "
          f"render; the command took {seconds:.1f} s")
    if rec["accel"] != "bvh" or rec["launches"]["bvh_traverse"] != \
            rec["config"]["iters"] * queries or rec["executed_queries"] != \
            rec["nominal_queries"] or rec["shadow_queries"] \
            or path_draws["bench --accel bvh"] <= 0 or any(
                rec["launches"][k] for k in ("cluster_march", "dense_sweep",
                                             "window_sweep")):
        fail(f"the bench on bvh ran {rec['accel']} with {rec['launches']} "
             f"for {rec['config']['iters']} renders of {queries:g} queries")

    # 9b. the small scenes on the dense sweep (the auto choice below
    # K_AUTO_ACCEL_PRIMS on a card) and the tensor route (the reference's
    # auto choice there, which the CPU keeps), in phase 4's chunks, which
    # divide their images (the bench's default 57,600 pads them, and the
    # dense routes query the padding lanes too)
    bench_sweeps = 0
    for scene_argv in (["--scene", "triangle", "--width", "800", "--height",
                        "450", "--spp", "2", "--depth", "50", "--ray-chunk",
                        str(TRI_RAYS)],
                       ["--scene", "cornell", "--width", "256", "--height",
                        "256", "--spp", "16", "--depth", "4", "--ray-chunk",
                        str(CORNELL_RAYS)]):
        values = {}
        for accel in ("pallas", "tensor"):
            rec, seconds = run_bench(scene_argv + ["--accel", accel])
            check_bench(rec, card, f"bench {scene_argv[1]} {accel}")
            sweeps = rec["launches"]["dense_sweep"]
            # the other closest-hit kernels; the draws kernel launches on
            # every route
            others = (rec["launches"]["cluster_march"]
                      + rec["launches"]["window_sweep"])
            if (sweeps <= 0) != (accel == "tensor") or others \
                    or rec["launches"]["ray_uniforms"] <= 0:
                fail(f"bench {scene_argv[1]} {accel} launched "
                     f"{rec['launches']}")
            path_draws[f"bench {scene_argv[1]} {accel}"] = \
                rec["launches"]["ray_uniforms"]
            if accel == "pallas":
                bench_sweeps += sweeps
            values[accel] = rec["value"]
            print(f"bench line: {json.dumps(rec)}")
            print(f"bench {bench_text(rec)}; the command took "
                  f"{seconds:.1f} s")
        print(f"bench {scene_argv[1]}: pallas / tensor nominal Mrays/s "
              f"{values['pallas'] / values['tensor']:.4f} [{card}]")

    # 9c. bench_scaling: the n = 1 line at the bench shape, then the proxy
    # on cuda:0 x 8 slots
    parser = bench_scaling.build_parser()
    reset_counts()
    lines = bench_scaling.run_scaling(parser.parse_args([]))
    counts = read_counts()
    path_draws["bench_scaling n = 1"] = read_draws()
    if lines[0]["devices"] != 1 or not lines[0]["value"] > 0 \
            or counts[0] <= 0 or sum(ln["launches"]["cluster_march"]
                                     for ln in lines) != counts[0] \
            or path_draws["bench_scaling n = 1"] <= 0:
        fail(f"bench_scaling gave {lines} with {counts} (march, sweep, "
             f"window) launches")
    print(f"bench_scaling n = 1: {lines[0]['value']:.4f} Mrays/s, walls "
          f"{', '.join(f'{w:.4f}' for w in lines[0]['walls_s'])} s, "
          f"{counts[0]} march launches [{card}]")
    reset_counts()
    with recording_work(cluster_sweep, "march", marched) as proxy_marches, \
            recording_draws() as proxy_draws:
        proxy = bench_scaling.run_proxy(parser.parse_args(
            ["--proxy", "--out", os.path.join(out,
                                              "scaling_proxy_torch.json")]))
    counts = read_counts()
    path_draws["bench_scaling proxy"] = read_draws()
    if sum(proxy["per_shard_executed_queries"]) != \
            proxy["unsharded_executed_queries"] or not proxy["sums_match"] \
            or counts[0] <= 0 \
            or proxy["slots"] != ["cuda:0"] * 8 \
            or not proxy["single_device_frame_ms"] > 0:
        fail(f"the scaling proxy: {proxy} with {counts} launches")
    print(f"bench_scaling proxy on cuda:0 x 8 ({proxy['config']['chunk']}-"
          f"ray chunks, {proxy['config']['chunks_per_slot']} a slot): "
          f"executed queries per shard {proxy['per_shard_executed_queries']}"
          f" (contiguous {proxy['per_shard_executed_queries_contiguous']}), "
          f"summing to the unsharded {proxy['unsharded_executed_queries']}; "
          f"imbalance efficiency {proxy['imbalance_efficiency']:.4f} "
          f"(contiguous {proxy['imbalance_efficiency_contiguous']:.4f}); "
          f"{proxy['collective_bytes_per_frame']['total']} all-reduce bytes a "
          f"frame, {proxy['collective_ms_projected']:.4f} ms at the assumed "
          f"450 GB/s; frame {proxy['single_device_frame_ms']:.2f} ms at the "
          f"bench's chunk, {proxy['plan_chunk_frame_ms']:.2f} ms at the "
          f"plan's; shards "
          f"{', '.join(f'{x:.2f}' for x in proxy['shard_ms'])} ms; "
          f"projected mesh frame {proxy['projected_mesh_frame_ms']:.2f} ms,"
          f" efficiency {proxy['projected_efficiency']:.4f}; "
          f"{counts[0]} march launches [{card}]")
    hold_recorded("proxy march", proxy_marches, cluster_sweep.march,
                  cluster_sweep.march_reference, proxy["config"]["chunk"])
    hold_draws("proxy", proxy_draws, path_draws["bench_scaling proxy"],
               proxy["config"]["chunk"])

    # 9d. the inverse-rendering example at its defaults ("brute": no
    # kernel)
    inv_dir = os.path.join(out, "inverse_rendering")
    reset_counts()
    t0 = time.perf_counter()
    if inverse_rendering.main(["--out-dir", inv_dir]) != 0:
        fail("the inverse-rendering example failed")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    with open(os.path.join(inv_dir, "history.json")) as f:
        summary = json.load(f)["summary"]
    print(f"inverse-rendering example (48x48, 8 spp, depth 2, NEE, brute, "
          f"60 Adam steps): loss {summary['loss_first']:.6g} -> "
          f"{summary['loss_last']:.6g}, albedo MAE "
          f"{summary['albedo_mae_initial']:.5f} -> "
          f"{summary['albedo_mae_fitted']:.5f} in {seconds:.2f} s, "
          f"{counts} (march, sweep, window) launches [{card}]")
    if not summary["loss_last"] < 0.1 * summary["loss_first"] \
            or not summary["albedo_mae_fitted"] < \
            summary["albedo_mae_initial"]:
        fail(f"the example's fit did not cut its loss tenfold and lower the "
             f"albedo error: {summary}")

    # 9e. entry(): its step against render_image, then dryrun_multichip(2)
    fn, (scene, cam, seed) = entry()
    reset_counts()
    with recording_work(cluster_sweep, "march", marched) as entry_marches, \
            recording_draws() as entry_draws:
        img = fn(scene, cam, seed)
        torch.cuda.synchronize()
    counts = read_counts()
    path_draws["entry()"] = read_draws()
    ref = render_image(scene, cam, ENTRY_CFG, seed=seed, device=dev)
    equal = torch.equal(img, ref)
    print(f"entry() step {tuple(img.shape)}: bit-equal to render_image "
          f"{equal}, mean {float(img.mean()):.5f}, {counts[0]} march "
          f"launches")
    if not equal or counts[0] <= 0 or not bool(torch.isfinite(img).all()):
        fail(f"entry(): equal {equal}, {counts} launches")
    hold_recorded("entry() march", entry_marches, cluster_sweep.march,
                  cluster_sweep.march_reference, ENTRY_CFG.ray_chunk)
    hold_draws("entry()", entry_draws, path_draws["entry()"],
               ENTRY_CFG.ray_chunk)
    reset_counts()
    with recording_work(cluster_sweep, "march", marched) as dry_marches, \
            recording_work(pallas_sweep, "sweep", swept_a_hit) as dry_sweeps, \
            recording_draws() as dry_draws, \
            recording_traversals() as dry_traversals:
        loss = dryrun_multichip(2)
    counts = read_counts()
    path_draws["dryrun_multichip(2)"] = read_draws()
    bvh_paths["dryrun_multichip(2)"] = read_traversals()
    print(f"dryrun_multichip(2) on [cuda:0] * 2: loss {loss:.6f}, {counts} "
          f"(march, sweep, window) launches, "
          f"{bvh_paths['dryrun_multichip(2)']} traversal launches (its BVH "
          f"leg)")
    if not np.isfinite(loss) or counts[0] <= 0 or counts[1] <= 0 \
            or bvh_paths["dryrun_multichip(2)"] <= 0:
        fail(f"dryrun_multichip(2): loss {loss}, {counts} launches, "
             f"{bvh_paths['dryrun_multichip(2)']} traversal launches")
    hold_recorded("dryrun_multichip(2) march", dry_marches,
                  cluster_sweep.march, cluster_sweep.march_reference)
    hold_recorded("dryrun_multichip(2) sweep", dry_sweeps,
                  pallas_sweep.sweep, pallas_sweep.sweep_reference)
    hold_draws("dryrun_multichip(2)", dry_draws,
               path_draws["dryrun_multichip(2)"])
    # the BVH leg's ray_chunk (entry.dryrun_multichip), which the 512-pixel
    # image on a 1x2 mesh keeps
    hold_traversals("dryrun_multichip(2) BVH leg", dry_traversals,
                    bvh_paths["dryrun_multichip(2)"], 64)
    return bench_marches, bench_sweeps


def draws_kernel(dev, card, ct, o_cam, d_cam):
    """Phase 3d: the draws kernel against its twin on the card, bit for
    bit, in both modes at the main path's shapes, each timed beside its
    twin and its bound, with the aten ops the twin dispatches. Returns the
    kernels-line numbers of the main path's largest set (by_ray, m = 6,
    on a march's ids) and the largest |kernel - twin|."""
    import torch
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import cluster_sweep, uniforms
    # a real march's lane order: the binning sort of the camera wavefront;
    # then the same order counted down from 2^29 - 1, the largest id
    rid_march = cluster_sweep.march_inputs(ct, o_cam, d_cam, T_MIN)[
        "rid"].to(torch.int32)
    rid_top = (1 << 29) - 1 - rid_march
    # a bounce key as the renderer makes one (sample 0, chunk 0, bounce 1)
    key = prng.fold_in(prng.split(prng.fold_in(prng.fold_in(
        prng.PRNGKey(0), 0), 0), 4)[1], 1)
    cases = [("flat", None, shape) for shape in ((2, RAYS), (RAYS,))]
    cases += [("by_ray", ids, m) for m in (6, 3, 1)
              for ids in ("march", "top")]
    err = 0.0
    main = None
    for mode, ids, arg in cases:
        if mode == "flat":
            n, m = RAYS * (2 if len(arg) == 2 else 1), 1
            what = f"flat {arg}"

            def kernel():
                return uniforms.uniform(key, arg, dev)

            def twin():
                return prng.uniform(key, arg, dev)
        else:
            rid = rid_march if ids == "march" else rid_top
            n, m = rid.shape[0], arg
            what = f"by_ray m={m} on {n} ids ({ids})"

            def kernel():
                return uniforms.uniform_by_ray(key, rid, m)

            def twin():
                return prng.uniform_by_ray(key, rid, m)
        got = kernel()
        ref = twin()
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            fail(f"ray_uniforms {what}: kernel and twin are not bit-equal")
        err = max(err, float((got - ref).abs().max()))
        with op_counter() as ops:
            twin()
        n_bytes, n_ops = draw_work(mode, n, m)
        b_ms, b_by = bound_int(n_bytes, n_ops)
        ms = cuda_ms(kernel, torch)
        dev_ms = device_ms(kernel, torch, 20, "uniforms_kernel")
        plain_ms = cuda_ms(twin, torch)
        print(f"ray_uniforms {what}, bit-equal to the twin: kernel "
              f"{ms:.4f} ms, {ms_text(dev_ms)}; plain twin {plain_ms:.4f} ms "
              f"({ops.n} aten ops dispatched), bound {b_ms * 1e3:.4f} us "
              f"({b_by}, "
              f"{n_bytes / 1e6:.4f} MB, {n_ops / 1e6:.3f} M int32 ops) "
              f"[{card}]")
        if (mode, ids, arg) == ("by_ray", "march", 6):
            main = (ms, plain_ms, b_ms, b_by)
    return main, err


def shade_chunk(dev, cell: str):
    """The shading step's arguments on a 16,384-lane chunk of camera rays
    of a benchmark cell's scene (the bunny, 640x360, through the sorted
    march and in its payload layout; the triangle world, 800x450, through
    the tensor route in caller order), after the chunk's closest-hit
    query, as the integrator's first bounce holds them."""
    import torch
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import shade, uniforms
    from pathtracer_tpu_torch.render.renderer import make_query
    from pathtracer_tpu_torch.scene.worlds import get_world
    name, w, h = (("bunny", 640, 360) if cell == "bunny"
                  else ("triangle", 800, 450))
    scene, cam = get_world(name, device=dev)
    query = make_query(scene, RenderConfig(
        width=w, height=h, spp=1, max_depth=4, ray_chunk=SHADE_LANES,
        accel="auto", scene=name))
    n = SHADE_LANES
    o, d = camera_wavefront(dev, cam, n, 0)
    atten = torch.ones((n, 3), dtype=torch.float32, device=dev)
    emitted = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    key = (0, 1)
    args = dict(tables=shade.shade_tables(query.scene),
                emitted=emitted.unbind(1), u_rr=None, t_min=T_MIN)
    if cell == "bunny":
        flags = shade.encode_flags(rid, ~alive, alive)
        idx, _, hit, o, d, alive, ex, _ = query.closest.query_sorted(
            o, d, alive, (*atten.unbind(1), flags))
        rid = ex[3] & shade.RID_MASK
        args.update(atten=ex[0:3], absorbed=ex[3])
    else:
        idx, _, hit = query.closest(o, d)
        args.update(atten=atten.unbind(1), absorbed=~alive)
    args.update(idx=idx, hit_valid=hit, o=o, d=d, alive=alive,
                u=uniforms.uniform_by_ray(key, rid, 6))
    return args


def nee_chunk(dev):
    """The NEE pair's arguments on a 16,384-lane chunk of camera rays of
    the Cornell cell's scene (the preset cornell-full, 256x256, through the
    route ``auto`` takes there, the dense sweep, in caller order) after the
    chunk's closest-hit query, as the integrator's first bounce holds
    them, and the route."""
    import torch
    from pathtracer_tpu_torch.core import random as prng
    from pathtracer_tpu_torch.ops import shade, uniforms
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.render.renderer import make_query
    scene, cam, cfg = get_preset("cornell-full", device=dev)
    query = make_query(scene, cfg.replace(ray_chunk=SHADE_LANES))
    n = SHADE_LANES
    o, d = camera_wavefront(dev, cam, n, 0)
    idx, _, hit = query.closest(o, d)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    rid = torch.arange(n, dtype=torch.int32, device=dev)
    key = (0, 1)
    args = dict(
        tables=shade.shade_tables(query.scene, nee=True), idx=idx,
        hit_valid=hit,
        o=o, d=d,
        atten=torch.ones((n, 3), dtype=torch.float32, device=dev).unbind(1),
        emitted=torch.zeros((n, 3), dtype=torch.float32,
                            device=dev).unbind(1),
        alive=alive, absorbed=~alive, spec_prev=alive.clone(),
        prev_pdf=torch.zeros(n, dtype=torch.float32, device=dev),
        u=uniforms.uniform_by_ray(key, rid, 6),
        u_nee=uniforms.uniform_by_ray(prng.fold_in(key, 1), rid, 3),
        u_rr=None, t_min=cfg.t_min,
        handles_dead=getattr(query.closest, "handles_dead", False),
        scratch=shade.nee_scratch(n, dev))
    return args, query.closest


def nee_kernels(dev, card, reps: int = 20):
    """Phase 3e's NEE pair against its twins on a chunk of the Cornell
    cell's scene (:func:`nee_chunk`): the bounce through the first kernel,
    the route's shadow query and the second, bit for bit against the
    twins' bounce around the same query, then each kernel timed beside its
    twin and its bound, with the state restored, untimed, before every
    call. Returns (first kernel's ms, its twin's, bound ms, bound by) and
    the second's."""
    import torch
    from pathtracer_tpu_torch.ops import shade
    from pathtracer_tpu_torch.render import integrator
    args, closest = nee_chunk(dev)
    sc = args["scratch"]
    state = [args[k] for k in ("o", "d", "alive", "absorbed", "spec_prev",
                               "prev_pdf")]
    state += list(args["atten"]) + list(args["emitted"])
    saved = [x.clone() for x in state]

    def restore():
        for x, y in zip(state, saved):
            x.copy_(y)

    def bounce(first, finish):
        restore()
        first(**args)
        _, t_sh, valid = closest.query_shadow(
            sc.origin, sc.seg, sc.take if args["handles_dead"] else None)
        finish(t_sh, valid, sc.cand, args["emitted"], args["t_min"])
        torch.cuda.synchronize()
        return [x.clone() for x in state + list(sc)], (t_sh, valid)

    got, _ = bounce(shade.shade_nee, shade.shade_nee_finish)
    ref, answer = bounce(integrator.shade_nee_reference,
                         shade.shade_nee_finish_reference)
    if not all(torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))
               for a, b in zip(got, ref)):
        fail("shade_nee cornell chunk: the kernels and their twins are not "
             "bit-equal")
    finish_args = (*answer, sc.cand, args["emitted"], args["t_min"])

    def timed(fn, call):
        times = []
        for _ in range(reps + 1):
            restore()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            call(fn)
            stop.record()
            stop.synchronize()
            times.append(start.elapsed_time(stop))
        return statistics.median(times[1:])

    def first(fn):
        return fn(**args)

    def second(fn):
        return fn(*finish_args)

    out = []
    t = args["tables"]
    for name, kernel, twin, call, lanes in (
            ("shade_nee", shade.shade_nee, integrator.shade_nee_reference,
             first,
             # inputs read, state and scratch written, tables read once
             nbytes(args["idx"], args["hit_valid"], args["u"],
                    args["u_nee"], *state)
             + nbytes(args["o"], args["d"], args["alive"], args["absorbed"],
                      args["spec_prev"], args["prev_pdf"], *args["atten"],
                      *args["emitted"], *sc)
             + nbytes(t.prims, t.mats, t.lights, t.scene.textures)),
            ("shade_nee_finish", shade.shade_nee_finish,
             shade.shade_nee_finish_reference, second,
             nbytes(*answer, sc.cand, *args["emitted"], *args["emitted"]))):
        restore()
        with op_counter() as ops:
            call(twin)
        ms = timed(kernel, call)
        plain_ms = timed(twin, call)
        dev_ms = device_ms(lambda: (restore(), call(kernel)), torch, reps,
                           f"{name}_kernel")
        b_ms, b_by = bound(lanes, 0.0)
        print(f"{name} cornell chunk ({SHADE_LANES} lanes, "
              f"{int(sc.take.sum())} light samples), bit-equal to the twin "
              f"around the route's shadow query: kernel {ms:.4f} ms, "
              f"{ms_text(dev_ms)}; plain twin {plain_ms:.4f} ms ({ops.n} "
              f"aten ops dispatched), bound {b_ms * 1e3:.4f} us ({b_by}, "
              f"{lanes / 1e6:.4f} MB) [{card}]", flush=True)
        out.append((ms, plain_ms, b_ms, b_by))
    return out


def shade_kernel(dev, card, reps: int = 20):
    """Phase 3e: the shading kernel against its twin on a 16,384-lane chunk
    of each benchmark cell's scene (:func:`shade_chunk`), bit for bit, each
    timed beside its twin and its bound, with the aten ops the twin
    dispatches; the state is restored, untimed, before every call; the NEE
    pair on the Cornell cell's (:func:`nee_kernels`). Returns the
    kernels-line numbers of the bunny's chunk and of the NEE pair, the
    shading kernel's launches of one 1-spp image at each cell's shape, and
    each NEE kernel's on Cornell's."""
    import torch
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import shade
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.worlds import get_world
    main = None
    for cell in ("bunny", "rtow"):
        args = shade_chunk(dev, cell)
        state = [args[k] for k in ("o", "d", "alive", "absorbed")]
        state += list(args["atten"]) + list(args["emitted"])
        saved = [x.clone() for x in state]

        def restore():
            for x, y in zip(state, saved):
                x.copy_(y)

        def run(fn):
            restore()
            fn(**args)
            torch.cuda.synchronize()
            return [x.clone() for x in state]

        got = run(shade.shade_bounce)
        ref = run(shade.shade_reference)
        if not all(torch.equal(a.contiguous().view(torch.uint8),
                               b.contiguous().view(torch.uint8))
                   for a, b in zip(got, ref)):
            fail(f"shade_bounce {cell} chunk: kernel and twin are not "
                 f"bit-equal")

        def timed(fn):
            times = []
            for _ in range(reps + 1):
                restore()
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(**args)
                stop.record()
                stop.synchronize()
                times.append(start.elapsed_time(stop))
            return statistics.median(times[1:])

        restore()
        with op_counter() as ops:
            shade.shade_reference(**args)
        ms = timed(shade.shade_bounce)
        plain_ms = timed(shade.shade_reference)
        dev_ms = device_ms(lambda: (restore(), shade.shade_bounce(**args)),
                           torch, reps, "shade_bounce_kernel")
        # each lane's inputs read once and its state written once, and the
        # tables it gathers from read once
        t = args["tables"]
        lanes = (nbytes(args["idx"], args["hit_valid"], args["u"], *state)
                 + nbytes(args["o"], args["d"], args["alive"],
                          args["absorbed"], *args["atten"],
                          *args["emitted"]))
        n_bytes = lanes + nbytes(t.prims, t.mats, t.scene.textures)
        b_ms, b_by = bound(n_bytes, 0.0)
        live = int(args["alive"].sum())
        hits = int((args["alive"] & args["hit_valid"]).sum())
        print(f"shade_bounce {cell} chunk ({SHADE_LANES} lanes, {live} "
              f"live, {hits} hits), bit-equal to the twin: kernel "
              f"{ms:.4f} ms, {ms_text(dev_ms)}; plain twin "
              f"{plain_ms:.4f} ms ({ops.n} aten ops dispatched), bound "
              f"{b_ms * 1e3:.4f} us ({b_by}, {n_bytes / 1e6:.4f} MB) "
              f"[{card}]", flush=True)
        if cell == "bunny":
            main = (ms, plain_ms, b_ms, b_by)
    nee_main = nee_kernels(dev, card, reps)
    path_launches = {}
    for cell, cfg in (
            ("bunny 640x360 1 spp", RenderConfig(
                width=640, height=360, spp=1, max_depth=4, ray_chunk=16384,
                scene="bunny")),
            ("rtow 800x450 1 spp", RenderConfig(
                width=800, height=450, spp=1, max_depth=50,
                ray_chunk=16384, scene="triangle"))):
        scene, cam = get_world(cfg.scene, device=dev)
        shade.SHADE_LAUNCHES = 0
        make_renderer(cfg, dev)(scene, cam)
        torch.cuda.synchronize()
        path_launches[cell] = shade.SHADE_LAUNCHES
        print(f"shade_bounce launches, {cell}: {shade.SHADE_LAUNCHES}")
    from pathtracer_tpu_torch.presets import get_preset
    scene, cam, cfg = get_preset("cornell-full", device=dev)
    cell = "cornell 256x256 1 spp"
    shade.SHADE_LAUNCHES = shade.SHADE_NEE_LAUNCHES = 0
    shade.SHADE_NEE_FINISH_LAUNCHES = 0
    make_renderer(cfg.replace(spp=1, ray_chunk=SHADE_LANES), dev)(scene, cam)
    torch.cuda.synchronize()
    path_launches[cell] = shade.SHADE_LAUNCHES
    nee_launches = {"shade_nee": shade.SHADE_NEE_LAUNCHES,
                    "shade_nee_finish": shade.SHADE_NEE_FINISH_LAUNCHES}
    if shade.SHADE_LAUNCHES:
        fail(f"shade_bounce launched {shade.SHADE_LAUNCHES} times under NEE")
    if not nee_launches["shade_nee"] or len(set(nee_launches.values())) > 1:
        fail(f"the NEE pair's launches differ, {cell}: {nee_launches}")
    for name, n in nee_launches.items():
        print(f"{name} launches, {cell}: {n}")
    return main, nee_main, path_launches, nee_launches


PREP_CASES = ("bunny 16384 sorted, extras", "combined 129600 closest",
              "combined 129600 shadow")


def prep_case(dev, case: str):
    """(tables, o, d, t_min, march_inputs kwargs) of one of
    :data:`PREP_CASES`: the bunny's 16,384-lane camera wavefront in the
    sorted-wavefront protocol (a tenth of the lanes dead, three
    attenuation planes, strided as the integrator's first bounce holds
    them, and the flags word riding the sort), the combined
    scene's 129,600-lane camera chunk as its closest-hit query, and
    shadow segments from that query's hits to points in the room
    (K_SHADOW_T_MIN, t_max 1, caller order)."""
    import numpy as np
    import torch
    from pathtracer_tpu_torch.config import K_SHADOW_T_MIN
    from pathtracer_tpu_torch.ops import cluster_sweep
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.presets import combined_scene
    from pathtracer_tpu_torch.scene.worlds import get_world
    rng = np.random.default_rng(25)
    if case.startswith("bunny"):
        scene, cam = get_world("bunny", device=dev)
        n = SHADE_LANES
    else:
        scene, cam = combined_scene(device=dev)
        n = 129600
    ct = build_cluster_tables(scene, K=64)
    o, d = camera_wavefront(dev, cam, n, 0)
    if case.startswith("bunny"):
        alive = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        atten = torch.from_numpy(rng.random((n, 3), dtype=np.float32))
        flags = torch.arange(n, dtype=torch.int32, device=dev)
        return ct, o, d, T_MIN, dict(
            active=alive, extras=(*atten.to(dev).unbind(1), flags))
    if case.endswith("closest"):
        return ct, o, d, T_MIN, {}
    _, t, valid = cluster_sweep.cluster_march(ct, o, d, T_MIN)
    p = o + t[:, None] * d
    light = torch.from_numpy(rng.uniform(
        ct.cmin.amin(dim=0).cpu().numpy(), ct.cmax.amax(dim=0).cpu().numpy(),
        (n, 3)).astype(np.float32)).to(dev)
    seg = torch.where(valid[:, None], light - p, 0.0)
    return ct, p, seg, K_SHADOW_T_MIN, dict(active=valid, t_max=1.0,
                                            sort_rays=False)


def prep_outputs(q) -> list:
    """(name, tensor) of every output of a march_inputs dict."""
    out = [(k, q[k]) for k in ("o", "d", "active", "active0", "rid",
                               "t_res", "b_res")]
    out += list(zip(("phi", "a", "gate", "ids", "ents"), q["args"][:5]))
    return out + [("extras", x) for x in (q["extras"] or ())]


def prep_kernels(dev, card, reps: int = 20):
    """Phase 3f: the preparation kernels through ``march_inputs`` against
    the twin on each of :data:`PREP_CASES`, every output to the bit (a NaN
    matching any NaN: a NaN's bits are no part of the result), then the
    query's preparation timed (CUDA events, median of ``reps``) beside the
    twin's, the aten ops each dispatches, each kernel's device time
    (``torch.profiler``) and the bytes bound: each lane's ray and mask
    read once and its outputs written once, and each chunk's order.
    Returns {case: (ms, plain ms, bound ms, bound by, launches)}."""
    import torch
    from pathtracer_tpu_torch.ops import cluster_sweep
    main = {}
    for case in PREP_CASES:
        ct, o, d, t_min, kw = prep_case(dev, case)

        def kernels():
            return cluster_sweep.march_inputs(ct, o, d, t_min, **kw)

        def twin():
            return cluster_sweep.march_inputs_reference(ct, o, d, t_min,
                                                        **kw)
        before = cluster_sweep.MARCH_PREP_LAUNCHES
        got = prep_outputs(kernels())
        launches = cluster_sweep.MARCH_PREP_LAUNCHES - before
        want = prep_outputs(twin())
        torch.cuda.synchronize()
        for (name, g), (_, w) in zip(got, want, strict=True):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"march_inputs {case}: {name} is {g.dtype} "
                     f"{tuple(g.shape)}, the twin's {w.dtype} "
                     f"{tuple(w.shape)}")
            if g.dtype == torch.float32:
                nan = torch.isnan(w)
                same = (torch.equal(torch.isnan(g), nan)
                        and torch.equal(g[~nan].view(torch.int32),
                                        w[~nan].view(torch.int32)))
            else:
                same = torch.equal(g, w)
            if not same:
                fail(f"march_inputs {case}: the kernels' {name} is not the "
                     f"twin's")
        if launches != (2 if kw.get("sort_rays", True) else 1):
            fail(f"march_inputs {case}: {launches} preparation launches")
        with op_counter() as ops:
            kernels()
        with op_counter() as plain_ops:
            twin()
        ms = cuda_ms(kernels, torch, reps)
        plain_ms = cuda_ms(twin, torch, reps)
        dev_ms = {k: device_ms(kernels, torch, reps, k)
                  for k in ("march_bin_kernel", "march_order_kernel")}
        outs = {x.data_ptr(): x for _, x in got}   # active0 may be active
        n_bytes = (nbytes(o, d, kw.get("active"), *kw.get("extras", ()))
                   + nbytes(*outs.values()))
        b_ms, b_by = bound(n_bytes, 0.0)
        print(f"march_inputs {case} ({launches} preparation launches), "
              f"bit-equal to the twin: {ms:.4f} ms "
              f"({ops.n} aten ops dispatched), march_bin "
              f"{ms_text(dev_ms['march_bin_kernel'])}, march_order "
              f"{ms_text(dev_ms['march_order_kernel'])}; plain twin "
              f"{plain_ms:.4f} ms ({plain_ops.n} aten ops), bound "
              f"{b_ms * 1e3:.4f} us ({b_by}, {n_bytes / 1e6:.4f} MB) "
              f"[{card}]", flush=True)
        main[case] = (ms, plain_ms, b_ms, b_by, launches)
    return main


def draws_on_paths(run_cli, cli_draws, bunny_argv, out, card, cli, torch):
    """Phase 10 (module docstring), every launch counter reset just before
    each render and read just after; ``run_cli`` is phase 4's CLI runner,
    which holds each render's draws to their twin and keeps its launches
    and draw signatures in ``cli_draws``."""
    import numpy as np
    from pathtracer_tpu_torch.ops import uniforms

    # 10a. cornell with NEE and Russian roulette through the dense sweep:
    # the m = 3 and m = 1 draws at the path's chunk
    cornell_argv = ["--scene", "cornell", "--width", "256", "--height", "256",
                    "--spp", "16", "--max-depth", "4", "--accel", "pallas",
                    "--ray-chunk", str(CORNELL_RAYS), "--rr"]
    img, seconds, cfg, stats, counts = run_cli(
        cornell_argv, os.path.join(out, "chip_smoke_cornell_rr.png"))
    draws, sigs = cli_draws["cornell_rr"]
    mean = check_image("cornell (NEE, Russian roulette)", img, (256, 256, 3),
                       0.05, 0.9)
    print(f"render cornell 256x256 16 spp depth 4, nee, rr, accel pallas, "
          f"chunk {CORNELL_RAYS}: {seconds:.4f} s wall, {counts[1]} sweep "
          f"launches, {draws} draws-kernel launches, image mean {mean:.5f} "
          f"[{card}]")
    if counts[1] <= 0 or not {("by_ray", CORNELL_RAYS, 3),
                              ("by_ray", CORNELL_RAYS, 1)} <= set(sigs):
        fail(f"cornell with NEE and Russian roulette: {counts} (march, "
             f"sweep, window) launches, draws {sigs}")

    # 10b. the bunny render's kernel launches and wall with the draws
    # kernel (as built) and with every draw patched to its plain twin
    # (here only: measurement, not an option of the program)
    @contextlib.contextmanager
    def twin_draws():
        from pathtracer_tpu_torch.core import random as prng
        with mock.patch.object(uniforms, "uniform", prng.uniform), \
                mock.patch.object(uniforms, "uniform_by_ray",
                                  prng.uniform_by_ray):
            yield

    images = []
    for label, ctx, name in (
            ("draws through the kernel", contextlib.nullcontext,
             "bunny_draws_kernel"),
            ("draws through the twin", twin_draws, "bunny_draws_twin")):
        hold = ctx is contextlib.nullcontext
        with ctx():
            img, seconds, _, _, _ = run_cli(
                bunny_argv, os.path.join(out, f"chip_smoke_{name}.png"),
                hold=hold)
            draws = cli_draws[name][0]
            print(f"bunny, {label}: {seconds:.4f} s wall, {draws} "
                  f"draws-kernel launches [{card}]")
            if (draws > 0) != hold:
                fail(f"bunny, {label}: {draws} draws-kernel launches")
            profile_render(cli, f"bunny, {label}", bunny_argv,
                           "uniforms_kernel", card, torch)
        images.append(img)
    # the twin's draws are the draws before the kernel: the image must not
    # change by a bit
    if not np.array_equal(images[0], images[1]):
        fail("the bunny through the draws kernel differs from the bunny "
             "through its twin")
    print("bunny through the draws kernel vs through its twin: bit-equal")


# OBJ files on which the port's parser once differed from the reference's
# native one (fault F5), and a line longer than the reference's 4,095-byte
# buffer (the port reads it whole): the native parser and its twin must agree
F5_TRI = "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
F5_CASES = {
    "tab after the tag": "v\t0 0 0\nv\t1 0 0\nv\t0 1 0\nf\t1 2 3\n",
    "trailing comment": F5_TRI + "f 1 2 3 # c\n",
    "bad index token": F5_TRI + "v 1 1 0\nf 1 2 x 3\n",
    "empty index": F5_TRI + "f 1 /2 2 3\n",
    "short v": F5_TRI + "v 0 0\nv 1 2 abc\nf 1 2 3\n",
    "hex float": "v 0x1p3 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n",
    "CRLF, nan, inf, -0": "v nan -inf 1e400\r\nv -nan -0 0\r\nv 0 1 0\r\n"
                          "f -3 +2 0\r\n",
    "a 4,802-byte face": F5_TRI + "f " + " ".join(
        str(1 + i % 3) for i in range(2400)) + "\n",
}


def native_library(out):
    """Phase 11a, host work before any bunny phase: build the port's native
    library (``native/src/ptnative.cpp``) on this host, parse the vendored
    bunny and the F5 cases through it and through the twin
    (``io/obj.load_obj_python``), which must agree bit for bit, and time
    both parses of the bunny. Returns the ``native`` line's fields."""
    import zlib

    import numpy as np

    from pathtracer_tpu_torch.io import obj
    from pathtracer_tpu_torch.native import bindings, build
    from pathtracer_tpu_torch.scene.bunny import ASSET_OBJ

    def same(a, b):
        return (a[0].shape == b[0].shape and a[1].shape == b[1].shape
                and np.array_equal(a[0].view(np.uint32), b[0].view(np.uint32))
                and np.array_equal(a[1], b[1]))

    built = not os.path.exists(build.library_path())
    t0 = time.perf_counter()
    try:
        lib = build.build()
        bindings.available()
    except RuntimeError as e:
        fail(f"the native host library does not build: {e}")
    build_s = time.perf_counter() - t0
    # the source includes <zlib.h> and links -lz: this host's zlib, the one
    # Python's zlib module reports
    zlib_route = f"<zlib.h>, -lz (zlib {zlib.ZLIB_RUNTIME_VERSION})"
    gxx = subprocess.run(["g++", "--version"], capture_output=True,
                         text=True).stdout.splitlines()[0]
    print(f"native: {'built' if built else 'found (built earlier)'} "
          f"{os.path.relpath(lib, HERE)}, {gxx} "
          f"{' '.join(build.GXX_FLAGS + build.LIBS)}, {build_s:.3f} s; "
          f"zlib route {zlib_route}")
    native, twin = obj.load_obj(ASSET_OBJ), obj.load_obj_python(ASSET_OBJ)
    if not same(native, twin):
        fail("the bunny through the native parser differs from the twin's")
    n_v, n_f = native[0].shape[0], native[1].shape[0]
    if (n_v, n_f + 3) != (1817, BUNNY_PRIMS):
        fail(f"the native parser read {n_v} vertices and {n_f} faces of "
             f"{ASSET_OBJ}, expected 1,817 and {BUNNY_PRIMS - 3}")
    f5_dir = os.path.join(out, "chip_smoke_f5")
    os.makedirs(f5_dir, exist_ok=True)
    for i, (name, text) in enumerate(F5_CASES.items()):
        path = os.path.join(f5_dir, f"case{i}.obj")
        with open(path, "w", newline="") as f:
            f.write(text)
        if not same(obj.load_obj(path), obj.load_obj_python(path)):
            fail(f"F5 case {name!r}: the native parser and its twin differ")
    card = card_line()
    times = {}
    for what, fn in (("native", obj.load_obj), ("twin", obj.load_obj_python)):
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn(ASSET_OBJ)
            runs.append((time.perf_counter() - t0) * 1e3)
        times[what] = statistics.median(runs)
    print(f"native: bunny ({n_v} v, {n_f} f, {n_f + 3} prims) and "
          f"{len(F5_CASES)} F5 cases equal through the native parser and "
          f"its twin; bunny parse, host ms (median of 5): native "
          f"{times['native']:.3f}, twin {times['twin']:.3f} [{card}]")
    return {"source": "pathtracer_tpu_torch/native/src/ptnative.cpp",
            "route": "host C++, g++, not a device kernel",
            "library": os.path.relpath(lib, HERE), "compiler": gxx,
            "built": built, "build_s": build_s, "zlib": zlib_route,
            "bunny_prims": n_f + 3,
            "f5_cases": len(F5_CASES), "bunny_parse_host_ms": times}


def native_png(path, img_np):
    """Phase 11b: the image ``write_png`` wrote to ``path`` through the
    native encoder must equal, byte for byte, what the twin ``encode_png``
    makes of it."""
    from pathtracer_tpu_torch.io.png import encode_png, quantize
    with open(path, "rb") as f:
        data = f.read()
    if data != encode_png(quantize(img_np[::-1])):
        fail(f"{path}: the native PNG encoder and its twin differ")
    print(f"native: {os.path.relpath(path, HERE)} ({len(data)} bytes) "
          f"byte-equal to the twin encoder's")
    return len(data)


def write_png_out(path, img_np):
    from pathtracer_tpu_torch.io.png import write_png
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_png(path, img_np)


def bench(tree: str, reps: int = BENCH_REPS) -> int:
    """The three kernels alone on the inputs of phases 3a, 3b and 3c, with
    ``pathtracer_tpu_torch`` imported from ``tree``."""
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    try:
        from pathtracer_tpu_torch.ops import cluster_sweep, pallas_sweep
    except ImportError as e:
        fail(f"no pathtracer_tpu_torch in {tree} ({e})")
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.scene.worlds import get_world
    dev = torch.device(DEVICE)
    card = card_line()
    print(f"bench: {os.path.dirname(os.path.dirname(pallas_sweep.__file__))}"
          f" [{card}]", flush=True)

    def line(what, fn, kernel="sweep_kernel", slots=0):
        dev_ms = device_ms(fn, torch, reps, kernel)
        print(f"{what}: {cuda_ms(fn, torch, reps):.4f} ms, "
              f"{ms_text(dev_ms, slots)} [{card}]", flush=True)

    for name, args in march_wavefronts(dev)[2]:
        n_walk, p50, longest = march_walk(
            cluster_sweep.march(*args)[2].cpu().numpy())
        line(f"cluster_march {name} ({n_walk} chunks march, slots p50 "
             f"{p50:g} / max {longest})", lambda: cluster_sweep.march(*args),
             "cluster_march_kernel", longest)
    for name, _, tables, o, d, t_min in dense_wavefronts(dev):
        args = pallas_sweep.sweep_inputs(pallas_sweep.kernel_tables(tables),
                                         o, d, t_min)
        line(f"dense_sweep {name}", lambda: pallas_sweep.sweep(*args))
    scene, cam = get_world("bunny", device=dev)
    o, d = camera_wavefront(dev, cam, RAYS, 0)
    for kind, args in rounds_launches(build_cluster_tables(scene, K=ROUNDS_K),
                                      o, d):
        w = named(cluster_sweep.window_sweep, args)
        line(f"window_sweep {kind} (W={w['W']}, "
             f"{int((w['skips'] == 0).sum())} live chunks)",
             lambda: cluster_sweep.window_sweep(*args))
    return 0


def launch_list(tree: str) -> int:
    """The triangle world at 1 spp through the CLI's code path, once to
    warm up and once under torch.profiler, with ``pathtracer_tpu_torch``
    imported from ``tree``: its wall, device busy share and every kernel's
    launches."""
    import torch
    sys.path.insert(0, os.path.abspath(tree))
    try:
        from pathtracer_tpu_torch import __main__ as cli
    except ImportError as e:
        fail(f"no pathtracer_tpu_torch in {tree} ({e})")
    card = card_line()
    print(f"launches: {os.path.dirname(os.path.dirname(cli.__file__))} "
          f"[{card}]", flush=True)
    cli.render_cli(cli.build_parser().parse_args(
        triangle_argv(1) + ["--device", DEVICE]))
    profile_render(cli, "triangle world at 1 spp", triangle_argv(1),
                   "dense_sweep_kernel", card, torch, by_kernel=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description="Chip smoke test of the "
                                 "PyTorch/CUDA port.")
    ap.add_argument("--bench", nargs="?", const=HERE, metavar="DIR",
                    help="time the three kernels alone, with the port "
                    "imported from DIR (default: this checkout)")
    ap.add_argument("--launches", nargs="?", const=HERE, metavar="DIR",
                    help="profile the triangle world at 1 spp, with the "
                    "port imported from DIR, and list its kernels' launches")
    ap.add_argument("--prep", action="store_true",
                    help="phase 3f alone: the march's preparation kernels "
                    "against their twin at the march cells' shapes, timed")
    ap.add_argument("--shade", action="store_true",
                    help="phase 3e alone: the shading kernel against its "
                    "twin on a chunk of each benchmark cell's scene, timed")
    opts = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU, nothing to test")
    if opts.bench:
        return bench(opts.bench)
    if opts.launches:
        return launch_list(opts.launches)
    if opts.shade:
        sys.path.insert(0, HERE)
        shade_kernel(torch.device(DEVICE), card_line())
        return 0
    if opts.prep:
        sys.path.insert(0, HERE)
        prep_kernels(torch.device(DEVICE), card_line())
        return 0
    sys.path.insert(0, HERE)
    try:
        from pathtracer_tpu_torch.ops import (_cuda_build, cluster_sweep,
                                              pallas_sweep)
    except ImportError as e:
        fail(f"the port is not next to chip_smoke.py ({e})")
    import numpy as np

    from pathtracer_tpu_torch import __main__ as cli
    from pathtracer_tpu_torch.config import RenderConfig
    from pathtracer_tpu_torch.ops import intersect, tensor_sweep
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.presets import combined_scene, get_preset
    from pathtracer_tpu_torch.render.renderer import make_renderer
    from pathtracer_tpu_torch.scene.bunny import ASSET_OBJ, resolve_bunny_obj
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
    kernels = ("cluster_march", "dense_sweep", "window_sweep",
               "ray_uniforms", "bvh_traverse", "shade_bounce")
    t0 = time.perf_counter()
    _cuda_build.build_all(kernels)
    for name in kernels:
        _cuda_build.load(name)
    print(f"build: {', '.join(k + '.cu' for k in kernels)} in "
          f"{time.perf_counter() - t0:.3f} s (parallel nvcc)")
    for name in kernels:
        summary = _cuda_build.ptxas_summary(
            _cuda_build.BUILD_LOGS.get(name, ""))
        for func, regs, st, ld in summary:
            print(f"  {name}: {kernel_label(func)}: ptxas {regs} registers, "
                  f"{st} bytes spill stores, {ld} bytes spill loads")
        if name == "cluster_march" and any(
                st or ld for func, _, st, ld in summary
                if "cluster_march_kernel" in func):
            fail("the march kernel spills (ptxas above)")

    # 11a. the native host library, before any phase parses the bunny
    out = os.path.join(HERE, "out")
    t11 = time.perf_counter()
    native_line = native_library(out)
    print(f"phase 11a took {time.perf_counter() - t11:.1f} s")

    # 3a. the cluster march against its twin, on the vendored scan (every
    # bunny phase measures it, not the procedural stand-in mesh)
    scene, _ = get_world("bunny", device=dev)
    if resolve_bunny_obj() != ASSET_OBJ or scene.num_prims != BUNNY_PRIMS:
        fail(f"the bunny is not {ASSET_OBJ} ({scene.num_prims} prims, "
             f"expected {BUNNY_PRIMS})")
    ct, (o_cam, d_cam), march_waves = march_wavefronts(dev)
    prim_type = ct.scene.prim_type.cpu().numpy()
    march_err = 0.0
    march = {}
    for name, args in march_waves:
        m = named(cluster_sweep.march, args)
        kernel = cluster_sweep.march(*args)
        torch.cuda.synchronize()
        twin = cluster_sweep.march_reference(*args)
        t_k, b_k, s_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r, s_r = (x.cpu().numpy() for x in twin)
        err = compare_hits(f"march {name}", t_k, b_k, t_r, b_r, prim_type)
        if not (np.array_equal(b_k, b_r) and np.array_equal(t_k, t_r)
                and np.array_equal(s_k, s_r)):
            fail(f"march {name}: kernel and twin are not bit-equal (t, "
                 f"best or slots per chunk)")
        march_err = max(march_err, err)
        n_walk, p50, longest = march_walk(s_k)
        ops, full_ops = march_needed_ops(torch, m, kernel[2])
        b_ms, b_by = bound(nbytes(*args, *kernel), ops)
        ms = cuda_ms(lambda: cluster_sweep.march(*args), torch)
        dev_ms = device_ms(lambda: cluster_sweep.march(*args), torch, 20,
                           "cluster_march_kernel")
        plain_ms = cuda_ms(lambda: cluster_sweep.march_reference(*args),
                           torch)
        march[name] = (ms, plain_ms, b_ms, b_by)
        print(f"march {name} wavefront ({RAYS} rays, {n_walk} of "
              f"{s_k.shape[0]} chunks march, slots p50 {p50:g} / max "
              f"{longest}, {int(s_k.sum())} slots, bit-equal to the twin, "
              f"max |dt| {err:.3g}): kernel {ms:.4f} ms, "
              f"{ms_text(dev_ms, longest)} of the longest chunk; plain "
              f"twin {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
              f"{ops / 1e9:.4f} GFLOP needed of {full_ops / 1e9:.4f} in "
              f"full) [{card}]")

    # 3b. the dense sweep against its twin, and the tensor route
    sweep_err = 0.0
    sweep = {}
    for name, sc_, tables, o, d, t_min in dense_wavefronts(dev):
        args = pallas_sweep.sweep_inputs(pallas_sweep.kernel_tables(tables),
                                         o, d, t_min)
        kernel = pallas_sweep.sweep(*args)
        torch.cuda.synchronize()
        twin = pallas_sweep.sweep_reference(*args)
        t_k, b_k = (x.cpu().numpy() for x in kernel)
        t_r, b_r = (x.cpu().numpy() for x in twin)
        err = compare_hits(f"sweep {name}", t_k, b_k, t_r, b_r,
                           sc_.prim_type.cpu().numpy())
        if not (np.array_equal(b_k, b_r) and np.array_equal(t_k, t_r)):
            fail(f"sweep {name}: kernel and twin are not bit-equal")
        sweep_err = max(sweep_err, err)
        n_sph = int((sc_.prim_type == 1).sum())
        n_tri = sc_.num_prims - n_sph
        r = o.shape[0]
        full_ops = r * float(OPS_SPHERE_PAIR * n_sph + OPS_TRI_PAIR * n_tri)
        ops = sum(needed_ops(torch, args[0], args[1],
                             *range_block(args[2][i], args[3][i], lo, hi))
                  for i, (lo, hi) in enumerate(args[4].tolist()) if hi > lo)
        b_ms, b_by = bound(nbytes(*args, *kernel), ops)
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
              f"{ops / 1e9:.4f} GFLOP needed of {full_ops / 1e9:.4f} in full)"
              f"; tensor route (auto) {tensor_ms:.4f} ms [{card}]")

    # 3c. the window sweep (rounds strategy, K=128) against its twin, on
    # every launch of one rounds query of the bunny camera wavefront, and a
    # full-width fallback over every chunk
    ct128 = build_cluster_tables(scene, K=ROUNDS_K)
    prim128 = ct128.scene.prim_type.cpu().numpy()
    launches = rounds_launches(ct128, o_cam, d_cam)
    C_tot = ct128.cols.shape[0]
    real128 = real_rows(ct128, scene)
    sph128 = ct128.is_sphere.view(C_tot, ROUNDS_K) != 0
    ops_cluster = (OPS_SPHERE_PAIR * (real128 & sph128).sum(1)
                   + OPS_TRI_PAIR * (real128 & ~sph128).sum(1)).double()
    window_err = 0.0
    window = {}
    query_ms = query_bound = 0.0
    timed_plain = ("residual", "round 1", "fallback, all chunks")
    for name, args in launches:
        w = named(cluster_sweep.window_sweep, args)
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
        starts, skips, W = w["starts"], w["skips"], w["W"]
        n_chunks = starts.shape[0]
        swept = skips == 0
        c = (starts[swept].long()[:, None]
             + torch.arange(W, device=dev)[None, :])
        full_ops = w["ray_tile"] * float(ops_cluster[c].sum())
        ops = window_needed_ops(torch, w)
        b_ms, b_by = bound(nbytes(*args, *kernel), ops)
        ms = cuda_ms(lambda: cluster_sweep.window_sweep(*args), torch)
        plain_ms = (cuda_ms(lambda: cluster_sweep.window_reference(*args),
                            torch) if name in timed_plain else None)
        window[name] = (ms, plain_ms, b_ms, b_by)
        if name != "fallback, all chunks":
            query_ms += ms
            query_bound += b_ms
        plain = "" if plain_ms is None else \
            f", plain twin {plain_ms:.4f} ms"
        print(f"window {name} (W={W}, {int(swept.sum())} of {n_chunks} "
              f"chunks swept, {int((b_k >= 0).sum())} hits, max |dt| "
              f"{err:.3g}): kernel {ms:.4f} ms{plain}, bound {b_ms:.4f} ms "
              f"({b_by}, {ops / 1e9:.4f} GFLOP needed of "
              f"{full_ops / 1e9:.4f} in full) [{card}]")
    print(f"window sweep, one rounds query ({len(launches) - 1} launches): "
          f"kernel {query_ms:.4f} ms, bound {query_bound:.4f} ms [{card}]")

    # 3d. the draws kernel against its twin, bit for bit, in both modes
    t3d = time.perf_counter()
    draws_main, draws_err = draws_kernel(dev, card, ct, o_cam, d_cam)
    print(f"phase 3d took {time.perf_counter() - t3d:.1f} s")

    # 3e. the shading kernel against its twin, bit for bit, on a chunk of
    # each benchmark cell's scene, and its launches on their images
    t3e = time.perf_counter()
    shade_main, nee_main, shade_paths, nee_paths = shade_kernel(dev, card)
    print(f"phase 3e took {time.perf_counter() - t3e:.1f} s")

    # 3f. the march's preparation kernels against their twin, bit for bit,
    # on the two march cells' queries
    t3f = time.perf_counter()
    prep_main = prep_kernels(dev, card)
    print(f"phase 3f took {time.perf_counter() - t3f:.1f} s")

    # 4. the main paths through the CLI's code path; each render's draws
    # launches and draw signatures by its image's name, and its draws held
    # to their twin at its chunk
    cli_draws = {}
    cli_prep = {}

    def run_cli(argv, out_png, env=None, hold=True):
        args = cli.build_parser().parse_args(
            argv + ["--device", DEVICE, "-o", out_png])
        name = os.path.splitext(os.path.basename(out_png))[0]
        name = name.removeprefix("chip_smoke_")
        with environ(env or {}), \
                (recording_draws() if hold else contextlib.nullcontext({})) \
                as seen:
            reset_counts()
            img, seconds, cfg, stats = cli.render_cli(args)
            counts = read_counts()
            draws = read_draws()
            cli_prep[name] = read_prep()
        cli_draws[name] = (draws, sorted(seen))
        if hold:
            hold_draws(f"render {name}", seen, draws,
                       min(cfg.ray_chunk, cfg.num_pixels))
        img_np = img.numpy()
        write_png_out(out_png, img_np)
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

    bunny_argv = ["--scene", "bunny", "--width", "640", "--height", "360",
                  "--spp", "8", "--max-depth", "4", "--ray-chunk", str(RAYS)]
    img_np, seconds, cfg, stats, counts = run_cli(
        bunny_argv, os.path.join(out, "chip_smoke_bunny.png"))
    march_launches = counts[0]
    draw_launches = cli_draws["bunny"][0]
    if march_launches <= 0 or counts[2] != 0:
        fail(f"the bunny path launched {counts[0]} march and {counts[2]} "
             f"window kernels")
    # every march of the bunny path is a sorted closest-hit query (no
    # light, no shadow query): march_bin and march_order before each
    prep_launches = cli_prep["bunny"]
    if prep_launches != 2 * march_launches:
        fail(f"the bunny path launched {prep_launches} preparation kernels "
             f"for {march_launches} marches, not two a march")
    mean = check_image("bunny", img_np, (360, 640, 3), 0.3, 0.95)
    report("bunny", seconds, cfg, stats, counts, mean)
    march_img = img_np
    # 11b. the image just written through the native PNG encoder
    native_line["bunny_png_bytes"] = native_png(
        os.path.join(out, "chip_smoke_bunny.png"), img_np)

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
        triangle_argv(TRIANGLE_SPP),
        os.path.join(out, "chip_smoke_triangle.png"))
    triangle_launches = counts[1]
    if triangle_launches <= 0:
        fail("the triangle path launched no dense sweep kernel")
    mean = check_image("triangle", img_np, (450, 800, 3), 0.1, 0.95)
    report("triangle", seconds, cfg, stats, counts, mean)

    # the rounds strategy: a cross-check route of the march, not a target;
    # its window launches are counted by kind (the width of each)
    widths = []
    window_sweep = cluster_sweep.window_sweep
    w_at = list(inspect.signature(window_sweep).parameters).index("W")

    def counting(*args, **kw):
        widths.append(args[w_at])
        return window_sweep(*args, **kw)
    with mock.patch.object(cluster_sweep, "window_sweep", counting):
        img_np, seconds, cfg, stats, counts = run_cli(
            bunny_argv, os.path.join(out, "chip_smoke_bunny_rounds.png"),
            env=ROUNDS_ENV)
    window_launches = counts[2]
    split = collections.Counter(window_kinds(widths, ct128.C_reg))
    if sum(split.values()) != window_launches:
        fail(f"the rounds bunny's launch split {dict(split)} does not sum to "
             f"its {window_launches} window launches")
    print("rounds bunny window launches by kind: " + ", ".join(
        f"{k} {split[k]}" for k in sorted(split, key=kind_order)))
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
    # 1 spp: the profiler's summary of a render's ~300,000 kernel launches
    # per spp costs more host time than the render itself
    profile_render(cli, "triangle world at 1 spp", triangle_argv(1),
                   "dense_sweep_kernel", card, torch)
    profile_render(cli, "rounds bunny", bunny_argv, "window_sweep_kernel",
                   card, torch, ROUNDS_ENV)

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

    # 6. the differentiable pass
    path_draws = {}
    fit_sweeps, grad_marches = differentiable(dev, card, march_img,
                                              path_draws)

    # 7. large scenes and long renders
    big_launches = large_scenes(dev, card, march_img, run_cli, bunny_argv,
                                out)

    # 8. the BVH route, the sharded renderer and train step, the viewer
    # and the oracle
    t8 = time.perf_counter()
    sharded_marches, sharded_sweeps, (bvh_main, bvh_err, bvh_paths) = \
        bvh_and_sharded(dev, card, march_img, run_cli, bunny_argv, out,
                        path_draws)
    print(f"phase 8 took {time.perf_counter() - t8:.1f} s")

    # 9. the entry points: the bench, the scaling bench and its proxy, the
    # inverse-rendering example, the compile-check entry
    t9 = time.perf_counter()
    bench_marches, bench_sweeps = entry_points(dev, card, out, path_draws,
                                               bvh_paths)
    print(f"phase 9 took {time.perf_counter() - t9:.1f} s")

    # 10. the draws kernel on the paths: cornell with NEE and Russian
    # roulette, the bunny's launches with the draws kernel and its twin
    t10 = time.perf_counter()
    draws_on_paths(run_cli, cli_draws, bunny_argv, out, card, cli, torch)
    print(f"phase 10 took {time.perf_counter() - t10:.1f} s")

    k2 = sweep["triangle camera"]
    k3 = window["round 1"]
    print("native " + json.dumps(native_line))
    print(json.dumps({"kernels": [{
        "name": "cluster_march", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/cluster_march.cu",
        "replaces": "pathtracer_tpu/ops/cluster_sweep.py:446",
        "launches": march_launches, "diff_launches": grad_marches,
        "big_launches": big_launches, "sharded_launches": sharded_marches,
        "bench_launches": bench_marches, "max_abs_err": march_err,
        "ms": march["camera"][0], "plain_ms": march["camera"][1],
        "bound_ms": march["camera"][2], "bound_by": march["camera"][3],
        "library_ms": None}, {
        "name": "dense_sweep", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/dense_sweep.cu",
        "replaces": "pathtracer_tpu/ops/pallas_sweep.py:41",
        "launches": triangle_launches, "diff_launches": fit_sweeps,
        "sharded_launches": sharded_sweeps, "bench_launches": bench_sweeps,
        "max_abs_err": sweep_err,
        "ms": k2[0], "plain_ms": k2[1], "bound_ms": k2[2],
        "bound_by": k2[3], "library_ms": None}, {
        "name": "window_sweep", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/window_sweep.cu",
        "replaces": "pathtracer_tpu/ops/cluster_sweep.py:66",
        "launches": window_launches, "max_abs_err": window_err,
        "ms": k3[0], "plain_ms": k3[1], "bound_ms": k3[2],
        "bound_by": k3[3], "library_ms": None}, {
        "name": "ray_uniforms", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/ray_uniforms.cu",
        "replaces": None, "launches": draw_launches,
        "path_launches": dict(path_draws,
                              **{k: v[0] for k, v in cli_draws.items()}),
        "max_abs_err": draws_err,
        "ms": draws_main[0], "plain_ms": draws_main[1],
        "bound_ms": draws_main[2], "bound_by": draws_main[3],
        "library_ms": None}, {
        "name": "bvh_traverse", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/bvh_traverse.cu",
        "replaces": None, "launches": bvh_paths["bunny bench shape"],
        "path_launches": bvh_paths, "max_abs_err": bvh_err,
        "ms": bvh_main[0], "plain_ms": bvh_main[1],
        "bound_ms": bvh_main[2], "bound_by": bvh_main[3],
        "library_ms": None}, {
        "name": "shade_bounce", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/shade_bounce.cu",
        "replaces": None,
        "launches": shade_paths["bunny 640x360 1 spp"],
        "path_launches": shade_paths, "max_abs_err": 0.0,
        "ms": shade_main[0], "plain_ms": shade_main[1],
        "bound_ms": shade_main[2], "bound_by": shade_main[3],
        "library_ms": None}] + [{
        "name": name, "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/shade_bounce.cu",
        "replaces": None,
        "launches": nee_paths[name],
        "path_launches": {"cornell 256x256 1 spp": nee_paths[name]},
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        for name, (ms, plain_ms, b_ms, b_by) in zip(
            ("shade_nee", "shade_nee_finish"), nee_main)] + [{
        "name": "march_prep", "route": "cuda",
        "source": "pathtracer_tpu_torch/csrc/cluster_march.cu",
        "replaces": None, "launches": prep_launches,
        "path_launches": {k: cli_prep[k] for k in (
            "bunny", "cornell", "triangle", "bunny_rounds")},
        "case_launches": {case: v[4] for case, v in prep_main.items()},
        "max_abs_err": 0.0, "ms": prep_main[PREP_CASES[0]][0],
        "plain_ms": prep_main[PREP_CASES[0]][1],
        "bound_ms": prep_main[PREP_CASES[0]][2],
        "bound_by": prep_main[PREP_CASES[0]][3], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
