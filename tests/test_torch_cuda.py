"""The port's CUDA kernels on the card, against their plain PyTorch twins.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip. The file
imports neither jax nor the JAX package, so it runs where only PyTorch is
installed; the repository's conftest imports jax, hence on a GPU machine:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Tolerances: none. Kernel and twin are built to round alike, and every
kernel merges its thread groups by a rule that gives the twin's winner
for any split, so each is held to the bit: on ragged ray counts, chunk
sizes, window widths that the thread groups do not divide, and ties (for
the march, a tie across two slots).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.config import K_SHADOW_T_MIN, RenderConfig
from pathtracer_tpu_torch.core import random as prng
from pathtracer_tpu_torch.core.camera import get_rays
from pathtracer_tpu_torch.ops import (cluster_sweep, intersect, pallas_sweep,
                                      shade, traversal, uniforms)
from pathtracer_tpu_torch.core import vec
from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
from pathtracer_tpu_torch.ops.tensor_sweep import (BIG, pack_sweep_tables,
                                                   ray_features)
from pathtracer_tpu_torch.presets import get_preset
from pathtracer_tpu_torch.render import diff, integrator
from pathtracer_tpu_torch.render.renderer import make_renderer
from pathtracer_tpu_torch.scene.worlds import get_world

import shade_cases

pytestmark = pytest.mark.cuda

T_MIN = 1e-3


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _wavefront(name, cam, n, dev):
    if name == "camera":
        u = prng.uniform(prng.PRNGKey(1), (4, n), dev)
        o, d, _ = get_rays(cam, u[0], u[1], u[2], u[3],
                           torch.zeros(n, device=dev))
        return o, d
    rng = np.random.default_rng(2)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    o[:, 1] = np.abs(o[:, 1]) * 0.5
    d = rng.standard_normal((n, 3)).astype(np.float32)
    if name == "dead":
        d[::5] = 0.0
    return torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _march_bit_equal(args):
    """The march kernel on ``args`` against its twin: t and best to the
    bit, the same slots per chunk; one launch counted. Returns the
    kernel's (t, best, slots) as numpy."""
    before = cluster_sweep.MARCH_LAUNCHES
    got = [x.cpu().numpy() for x in cluster_sweep.march(*args)]
    assert cluster_sweep.MARCH_LAUNCHES == before + 1
    ref = [x.cpu().numpy() for x in cluster_sweep.march_reference(*args)]
    assert cluster_sweep.MARCH_LAUNCHES == before + 1
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x, y)
    return got


@pytest.mark.parametrize("name", ["camera", "bounce", "dead"])
@pytest.mark.parametrize("n", [512, 57600])
def test_march_kernel_matches_twin(gpu, name, n):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront(name, cam, n, gpu)
    q = cluster_sweep.march_inputs(ct, o, d, T_MIN)
    t_k, b_k, s_k = _march_bit_equal(q["args"])
    assert s_k.sum() > 0 and (b_k >= 0).sum() > 10


@pytest.mark.parametrize("ray_tile", [32, 96, 128, 256, 1024])
@pytest.mark.parametrize("n", [1, 129, 1001, 20000])
def test_march_kernel_tiles_and_ragged_counts_match_twin(gpu, ray_tile, n):
    """Chunks of 32 to 1,024 rays (8 groups of 32 threads to one group of
    512) and wavefronts that are no multiple of the chunk (march_inputs
    pads them with dead lanes), on camera rays."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, n, gpu)
    q = cluster_sweep.march_inputs(ct, o, d, T_MIN, ray_tile=ray_tile)
    _march_bit_equal(q["args"])


@pytest.mark.parametrize("sort_rays", [False, True])
def test_march_kernel_shadow_query_matches_twin(gpu, sort_rays):
    """NEE shadow segments from camera hits to points above the bunny:
    t_min K_SHADOW_T_MIN and t_max 1, which also clamps the gate; in
    caller order, as the query runs, and sorted."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 20000, gpu)
    _, t, valid = cluster_sweep.cluster_march(ct, o, d, T_MIN)
    p = o + t[:, None] * d
    light = torch.from_numpy(np.random.default_rng(3).uniform(
        (-6, 2, -6), (6, 12, 6), (20000, 3)).astype(np.float32)).to(gpu)
    seg = torch.where(valid[:, None], light - p, 0.0)
    q = cluster_sweep.march_inputs(ct, p, seg, K_SHADOW_T_MIN, active=valid,
                                   t_max=1.0, sort_rays=sort_rays)
    t_k, b_k, _ = _march_bit_equal(q["args"])
    assert (b_k >= 0).sum() > 100 and (t_k[b_k >= 0] < 1.0).all()


def _march_tie_args(dev):
    """march arguments in which each chunk visits two clusters that hold
    the same primitives, the higher-indexed one first (the tie scene's
    K=8 tables with the cluster of its first triangle copied into another
    one), with rays that all meet that triangle: the twin keeps the
    earlier slot's winner. Returns (args, winner index)."""
    scene, o, d = _tie_scene(dev)
    ct = build_cluster_tables(scene, K=8)
    K, C_tot = ct.K, ct.cols.shape[0]
    row = int(torch.nonzero(ct.perm == 0)[0, 0])
    c_a = row // K
    c_b = c_a + 1 if c_a + 1 < ct.C_reg else c_a - 1
    cols = ct.cols.clone()
    sph = ct.is_sphere.view(C_tot, K).clone()
    ranges = ct.ranges.clone()
    cols[c_b], sph[c_b], ranges[c_b] = cols[c_a], sph[c_a], ranges[c_a]
    n = 896
    o = o[:n].clone()
    o[:, 0] = o[:, 0] * 0.5          # inside the triangle
    o[:, 1] = o[:, 1] * 0.5 - 0.15
    d = d[:n]
    n_chunks = n // 128
    hi_c, lo_c = max(c_a, c_b), min(c_a, c_b)
    ids = torch.tensor([[hi_c, lo_c, 0]] * n_chunks, dtype=torch.int32,
                       device=dev)
    ents = torch.tensor([[0.0, 0.0, BIG]] * n_chunks, device=dev)
    gate = torch.full((n,), 10.0, device=dev)
    args = (ray_features(o, d).contiguous(), vec.dot(d, d).contiguous(),
            gate, ids, ents, cols, sph, ranges, K, T_MIN, BIG, 128)
    return args, hi_c * K + row % K


def test_march_kernel_cross_slot_tie_keeps_the_earlier_slot(gpu):
    args, winner = _march_tie_args(gpu)
    t_k, b_k, s_k = _march_bit_equal(args)
    assert (s_k == 2).all() and (b_k == winner).all()


def test_march_wrapper_rejects_bad_inputs(gpu):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 256, gpu)
    args = list(cluster_sweep.march_inputs(ct, o, d, T_MIN)["args"])
    bad = list(args)
    bad[0] = args[0].double()
    with pytest.raises(TypeError):
        cluster_sweep.march(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError):
        cluster_sweep.march(*bad)
    for bad_r, err in ((args[7].long(), TypeError),
                       (args[7][1:].contiguous(), ValueError),
                       (args[7].cpu(), ValueError)):
        bad = list(args)
        bad[7] = bad_r
        with pytest.raises(err):
            cluster_sweep.march(*bad)


def test_small_render_matches_cpu(gpu):
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                       ray_chunk=64 * 36, accel="cluster", scene="bunny",
                       seed=5)
    scene, cam = get_world("bunny", device=gpu)
    cluster_sweep.MARCH_LAUNCHES = 0
    g = make_renderer(cfg, gpu)(scene, cam).cpu().numpy()
    assert cluster_sweep.MARCH_LAUNCHES > 0
    scene_c, cam_c = get_world("bunny", device="cpu")
    c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    assert np.isfinite(g).all()
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3


def _dense_scene(name, dev):
    if name == "triangle":
        return get_world("triangle", device=dev)
    scene, cam, _ = get_preset("cornell-full", device=dev)
    return scene, cam


def _tie_scene(dev):
    """One triangle at rows 0 and 5 (the same triangle twice), spheres
    between and after them: rays through the triangle tie at bit-equal t
    and the lower index must win."""
    from pathtracer_tpu_torch.scene.scene import SceneBuilder
    b = SceneBuilder()
    m = b.add_lambertian((0.5, 0.5, 0.5))
    tri = ((-1, -1, 0), (1, -1, 0), (0, 1, 0))
    b.add_triangle(*tri, m)
    for i in range(4):
        b.add_sphere((3.0 * (i + 1), 0, -2), 0.5, m)
    b.add_triangle(*tri, m)
    for i in range(30):
        b.add_sphere((0.1 * i - 1.5, 0.2 * (i % 5) - 0.5, -4 - 0.1 * i),
                     0.4, m)
    scene = b.build(device=dev)
    n = 1000
    rng = np.random.default_rng(9)
    o = np.zeros((n, 3), np.float32)
    o[:, 0:2] = rng.uniform(-0.6, 0.6, (n, 2))
    o[:, 2] = 3.0
    d = np.tile(np.float32([0.0, 0.0, -1.0]), (n, 1))
    return scene, torch.from_numpy(o).to(dev), torch.from_numpy(d).to(dev)


def _assert_bit_equal(got, ref):
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.parametrize("name,kind,t_min", [
    ("triangle", "camera", T_MIN), ("cornell", "camera", T_MIN),
    ("cornell", "dead", T_MIN), ("cornell", "camera", K_SHADOW_T_MIN)])
@pytest.mark.parametrize("n", [512, 1001, 90000])
def test_dense_kernel_matches_twin(gpu, name, kind, t_min, n):
    scene, cam = _dense_scene(name, gpu)
    kt = pallas_sweep.kernel_tables(pack_sweep_tables(
        scene, tile=pallas_sweep.DEF_PRIM_TILE))
    o, d = _wavefront("camera", cam, n, gpu)
    if kind == "dead":
        d[::5] = 0.0
    args = pallas_sweep.sweep_inputs(kt, o, d, t_min)
    before = pallas_sweep.SWEEP_LAUNCHES
    t_k, b_k = (x.cpu().numpy() for x in pallas_sweep.sweep(*args))
    assert pallas_sweep.SWEEP_LAUNCHES == before + 1
    t_r, b_r = (x.cpu().numpy() for x in pallas_sweep.sweep_reference(*args))
    assert pallas_sweep.SWEEP_LAUNCHES == before + 1
    np.testing.assert_array_equal(b_k, b_r)
    np.testing.assert_array_equal(t_k, t_r)
    assert (b_k >= 0).sum() > n // 4
    if kind == "dead":
        assert (b_k[::5] == -1).all()


@pytest.mark.parametrize("n", [1, 129, 255, 257, 1001, 20000])
def test_dense_kernel_ragged_counts_match_twin(gpu, n):
    """Ragged ray counts (not a multiple of the kernel's 2 rays per thread,
    of its 256-ray block or of 128), the triangle world."""
    scene, cam = _dense_scene("triangle", gpu)
    kt = pallas_sweep.kernel_tables(pack_sweep_tables(
        scene, tile=pallas_sweep.DEF_PRIM_TILE))
    args = pallas_sweep.sweep_inputs(kt, *_wavefront("camera", cam, n, gpu),
                                     T_MIN)
    _assert_bit_equal(pallas_sweep.sweep(*args),
                      pallas_sweep.sweep_reference(*args))


def test_dense_kernel_tie_goes_to_the_lower_index(gpu):
    scene, o, d = _tie_scene(gpu)
    for tile in (128, 1024):
        kt = pallas_sweep.kernel_tables(pack_sweep_tables(scene, tile=tile))
        args = pallas_sweep.sweep_inputs(kt, o, d, T_MIN)
        got = pallas_sweep.sweep(*args)
        _assert_bit_equal(got, pallas_sweep.sweep_reference(*args))
        b = got[1].cpu().numpy()
        assert (b == 0).sum() > 100 and not (b == 5).any()


def test_dense_wrapper_rejects_bad_inputs(gpu):
    scene, cam = get_world("triangle", device=gpu)
    kt = pallas_sweep.kernel_tables(pack_sweep_tables(scene, tile=640))
    o, d = _wavefront("camera", cam, 300, gpu)
    args = list(pallas_sweep.sweep_inputs(kt, o, d, T_MIN))
    for i, bad_x, err in ((0, args[0].double(), TypeError),
                          (1, args[1].cpu(), ValueError),
                          (2, args[2][:, :, :-4], ValueError),
                          (0, args[0].t().contiguous().t(), ValueError)):
        bad = list(args)
        bad[i] = bad_x
        with pytest.raises(err):
            pallas_sweep.sweep(*bad)
    # the ranges: dtype, shape and device are checked
    for bad_r, err in ((args[4].long(), TypeError),
                       (args[4][:, :1].contiguous(), ValueError),
                       (torch.cat([args[4], args[4]]), ValueError),
                       (args[4].cpu(), ValueError)):
        bad = list(args)
        bad[4] = bad_r
        with pytest.raises(err):
            pallas_sweep.sweep(*bad)
    # a tile that is not a multiple of the kernel's 64-prim slice
    kt = pallas_sweep.kernel_tables(pack_sweep_tables(scene, tile=640))
    cut = (kt[0][:, :, :4 * 100].contiguous(), kt[1][:, :100].contiguous(),
           torch.tensor([[0, 100]], dtype=torch.int32, device=gpu))
    args = pallas_sweep.sweep_inputs(cut, o, d, T_MIN)
    _assert_bit_equal(pallas_sweep.sweep(*args),
                      pallas_sweep.sweep_reference(*args))


def test_small_cornell_render_matches_cpu(gpu):
    """cornell-full with NEE, stratify and textures through the dense
    sweep kernel on the card, against the same render on the CPU."""
    scene, cam, cfg = get_preset("cornell-full", device=gpu)
    cfg = cfg.replace(width=32, height=32, spp=4, max_depth=3,
                      ray_chunk=1024, accel="pallas", seed=3)
    pallas_sweep.SWEEP_LAUNCHES = 0
    g = make_renderer(cfg, gpu)(scene, cam).cpu().numpy()
    assert pallas_sweep.SWEEP_LAUNCHES > 0
    scene_c, cam_c, _ = get_preset("cornell-full", device="cpu")
    c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    assert np.isfinite(g).all() and g.mean() > 0.05
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3


def _small_auto_case(name, dev):
    """(scene, camera, config on "auto") of a small render of a scene
    under the auto crossover: the triangle world (601 prims, sky) or
    cornell-full (36 prims, NEE, strata, textures)."""
    if name == "triangle":
        scene, cam = get_world("triangle", device=dev)
        return scene, cam, RenderConfig(width=64, height=32, spp=2,
                                        max_depth=4, ray_chunk=1024,
                                        scene="triangle", seed=4)
    scene, cam, cfg = get_preset("cornell-full", device=dev)
    return scene, cam, cfg.replace(width=32, height=32, spp=4, max_depth=3,
                                   ray_chunk=1024, seed=3)


@pytest.mark.parametrize("name", ["triangle", "cornell-full"])
def test_auto_takes_the_sweep_kernel_below_the_crossover(gpu, name):
    """On the card "auto" below K_AUTO_ACCEL_PRIMS is the sweep kernel: the
    image and executed counts of the explicit "pallas" render, bit for
    bit; one launch per executed closest-hit or shadow query; no matrix
    product (the tensor route's cuBLAS gemm) anywhere in the render."""
    from torch.profiler import ProfilerActivity, profile
    scene, cam, cfg = _small_auto_case(name, gpu)
    assert cfg.accel == "auto"
    pallas_sweep.SWEEP_LAUNCHES = 0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        img, stats = make_renderer(cfg, gpu, with_stats=True)(scene, cam)
        torch.cuda.synchronize()
    launches = pallas_sweep.SWEEP_LAUNCHES
    ref, ref_stats = make_renderer(cfg.replace(accel="pallas"), gpu,
                                   with_stats=True)(scene, cam)
    assert torch.isfinite(img).all() and img.mean() > 0.05
    assert torch.equal(img, ref) and stats == ref_stats
    assert (stats[1] > 0) == (name == "cornell-full")
    assert launches > 0 and launches * cfg.ray_chunk == stats[0] + stats[1]
    ops = {e.key for e in prof.key_averages()}
    assert not ops & {"aten::matmul", "aten::mm", "aten::bmm"}, ops
    kernels = {e.key for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0.0) > 0.0}
    # the profiler now and then records no device activity at all; where
    # it recorded some, the sweep kernel is there and no gemm is
    if kernels:
        assert any("dense_sweep_kernel" in k for k in kernels), kernels
        assert not any("gemm" in k.lower() for k in kernels), kernels


def _window_args(ct, o, d, kind, ray_tile=128):
    """Arguments of ``window_sweep`` for one launch kind of the rounds
    strategy over the wavefront (o, d), K=128 tables."""
    K, C_reg = ct.K, ct.C_reg
    C_tot = ct.cols.shape[0]
    n_chunks = o.shape[0] // ray_tile
    dev = o.device
    phi = ray_features(o, d).contiguous()
    a = vec.dot(d, d)
    a = torch.where(a == 0.0, 1.0, a).contiguous()
    active = torch.any(d != 0.0, dim=1)
    zeros = torch.zeros(n_chunks, dtype=torch.int32, device=dev)
    if kind == "residual":
        dead = torch.all(~active.view(n_chunks, ray_tile), dim=1)
        starts, skips, W = zeros + C_reg, dead.to(torch.int32), 1
    elif kind == "window":
        # a first round: each chunk's nearest touched cluster
        entry = cluster_sweep._cull(o, d, active, ct.cmin, ct.cmax, T_MIN)
        key, _ = cluster_sweep._key_and_resolved(
            entry, torch.zeros_like(entry, dtype=torch.bool),
            torch.full((o.shape[0],), BIG, device=dev))
        chunk_min = key.view(n_chunks, ray_tile).amin(dim=1)
        W = 4
        starts = torch.clamp(chunk_min, 0, C_reg - W).to(torch.int32)
        skips = (chunk_min >= cluster_sweep._RESOLVED_KEY).to(torch.int32)
    elif kind == "fallback":
        starts, skips, W = zeros, zeros, C_reg
    elif kind == "last":    # the window ends at the residual tile
        starts, skips, W = zeros + C_tot - 4, zeros, 4
    else:   # all skipped
        starts, skips, W = zeros + C_tot, zeros + 1, 4
    return (phi, a, starts.contiguous(), skips.contiguous(), ct.cols,
            ct.is_sphere.view(C_tot, K), ct.ranges, K, W, T_MIN, ray_tile)


@pytest.mark.parametrize("kind", ["residual", "window", "fallback", "last",
                                  "allskip"])
@pytest.mark.parametrize("name,n", [("camera", 512), ("dead", 512),
                                    ("camera", 57600)])
def test_window_kernel_matches_twin(gpu, kind, name, n):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=128)
    o, d = _wavefront("camera", cam, n, gpu)
    if name == "dead":
        d[::5] = 0.0
        d[:128] = 0.0        # one chunk all dead: skipped by the residual
    args = _window_args(ct, o, d, kind)
    before = cluster_sweep.WINDOW_LAUNCHES
    t_k, b_k = (x.cpu().numpy() for x in cluster_sweep.window_sweep(*args))
    torch.cuda.synchronize()
    assert cluster_sweep.WINDOW_LAUNCHES == before + 1
    t_r, b_r = (x.cpu().numpy() for x in cluster_sweep.window_reference(
        *args))
    assert cluster_sweep.WINDOW_LAUNCHES == before + 1
    np.testing.assert_array_equal(b_k, b_r)
    np.testing.assert_array_equal(t_k, t_r)
    if kind == "allskip":
        assert (b_k == -1).all() and (t_k == BIG).all()
    elif kind in ("residual", "fallback"):
        assert (b_k >= 0).sum() > 16


def test_window_wrapper_rejects_bad_inputs(gpu):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=128)
    o, d = _wavefront("camera", cam, 512, gpu)
    args = list(_window_args(ct, o, d, "last"))
    for i, bad_x, err in (
            (0, args[0].double(), TypeError),
            (1, args[1].cpu(), ValueError),
            (2, args[2].long(), TypeError),
            (0, args[0].t().contiguous().t(), ValueError),
            (6, args[6].long(), TypeError),
            (6, args[6][1:].contiguous(), ValueError),
            (6, args[6].cpu(), ValueError)):
        bad = list(args)
        bad[i] = bad_x
        with pytest.raises(err):
            cluster_sweep.window_sweep(*bad)
    # a window that leaves the tables is fine where the chunk is skipped
    ok = list(args)
    ok[2] = args[2] + 1
    ok[3] = torch.ones_like(args[3])
    t, b = cluster_sweep.window_sweep(*ok)
    assert (b == -1).all()


@pytest.mark.parametrize("W", [1, 3, 4, 5, 9, "C_reg"])
@pytest.mark.parametrize("ray_tile", [32, 96, 128, 256, 1024])
def test_window_kernel_widths_and_tiles_match_twin(gpu, W, ray_tile):
    """Windows of 1, 3, 4, 5, 9 and C_reg clusters (not divisible by the 8
    thread groups), chunks of 32 to 1,024 rays (from 8 groups of 32
    threads to 1 group of 512), one chunk's window over a cluster whose
    range is empty, one over the residual tile."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=128)
    n = 2048 // ray_tile * ray_tile
    o, d = (x[:n] for x in _wavefront("camera", cam, 2048, gpu))
    args = list(_window_args(ct, o, d, "window", ray_tile))
    C_reg, C_tot = ct.C_reg, ct.cols.shape[0]
    W = C_reg if W == "C_reg" else W
    args[8] = W
    args[2] = torch.clamp(args[2], 0, C_tot - W).contiguous()
    args[2][0] = C_tot - W
    args[3] = torch.zeros_like(args[3])
    ranges = ct.ranges.clone()
    ranges[int(args[2][1])] = torch.tensor([7, 7])
    args[6] = ranges
    _assert_bit_equal(cluster_sweep.window_sweep(*args),
                      cluster_sweep.window_reference(*args))


def test_window_kernel_tie_goes_to_the_lower_index(gpu):
    scene, o, d = _tie_scene(gpu)
    ct = build_cluster_tables(scene, K=128)
    # the twin triangles' rows in the reordered tables: adjacent, so in
    # different groups
    rows = torch.nonzero((ct.perm == 0) | (ct.perm == 5)).squeeze(1)
    assert rows.tolist() == [int(rows[0]), int(rows[0]) + 1]
    o = o[:896]
    d = d[:896]
    for kind in ("fallback", "last"):
        args = _window_args(ct, o, d, kind)
        if kind == "last":
            args = args[:2] + (torch.zeros_like(args[2]),) + args[3:8] + (
                ct.cols.shape[0],) + args[9:]
        got = cluster_sweep.window_sweep(*args)
        _assert_bit_equal(got, cluster_sweep.window_reference(*args))
        b = got[1].cpu().numpy()
        assert (b == int(rows[0])).sum() > 100
        assert not (b == int(rows[1])).any()


@pytest.mark.parametrize("shift", ["1", "-C_tot"])
def test_window_kernel_asserts_off_the_tables(gpu, shift):
    """A swept window past the last cluster (starts + W > C_tot) or before
    the first (starts < 0) fails the kernel's device-side assert, and
    PyTorch raises at the next sync. The assert leaves the CUDA context
    unusable, so each case runs in a process of its own."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = f"""
import sys, torch
sys.path.insert(0, {here!r})
import test_torch_cuda as t
dev = torch.device("cuda")
scene, cam = t.get_world("bunny", device=dev)
ct = t.build_cluster_tables(scene, K=128)
C_tot = ct.cols.shape[0]
o, d = t._wavefront("camera", cam, 512, dev)
args = list(t._window_args(ct, o, d, "last"))
args[2] = args[2] + {shift}
t.cluster_sweep.window_sweep(*args)
torch.cuda.synchronize()
print("no error")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=os.path.dirname(here))
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


@pytest.mark.parametrize("kernel", ["dense", "window", "march",
                                    "march id"])
def test_sweep_kernels_assert_ranges_off_the_tables(gpu, kernel):
    """A range past the end of its tile or cluster fails the kernel's
    device-side assert, and so does a march cluster id past the tables
    (each case in a process of its own)."""
    here = os.path.dirname(os.path.abspath(__file__))
    if kernel == "dense":
        call = """
scene, cam = t.get_world("triangle", device=dev)
kt = list(t.pallas_sweep.kernel_tables(t.pack_sweep_tables(scene, 1024)))
kt[2] = kt[2] + 424
o, d = t._wavefront("camera", cam, 512, dev)
t.pallas_sweep.sweep(*t.pallas_sweep.sweep_inputs(kt, o, d, 1e-3))
"""
    elif kernel == "window":
        call = """
scene, cam = t.get_world("bunny", device=dev)
ct = t.build_cluster_tables(scene, K=128)
o, d = t._wavefront("camera", cam, 512, dev)
args = list(t._window_args(ct, o, d, "fallback"))
args[6] = args[6] + 1
t.cluster_sweep.window_sweep(*args)
"""
    else:
        change = ("args[7] = args[7] + 1" if kernel == "march" else
                  "args[3] = args[3] + args[5].shape[0]")
        call = f"""
scene, cam = t.get_world("bunny", device=dev)
ct = t.build_cluster_tables(scene, K=64)
o, d = t._wavefront("camera", cam, 512, dev)
args = list(t.cluster_sweep.march_inputs(ct, o, d, 1e-3)["args"])
{change}
t.cluster_sweep.march(*args)
"""
    code = f"""
import sys, torch
sys.path.insert(0, {here!r})
import test_torch_cuda as t
dev = torch.device("cuda")
{call}
torch.cuda.synchronize()
print("no error")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=os.path.dirname(here))
    assert out.returncode != 0 and "no error" not in out.stdout
    assert "device-side assert" in out.stderr, out.stderr[-2000:]


def test_small_rounds_render_matches_cpu(gpu, monkeypatch):
    """The bunny on the rounds route (K=128) with the Sobol sampler, Russian
    roulette from bounce 1 and black termination, on the card against the
    same render on the CPU."""
    monkeypatch.setenv("PT_CLUSTER_STRATEGY", "rounds")
    monkeypatch.setenv("PT_CLUSTER_K", "128")
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                       ray_chunk=64 * 36, accel="cluster", scene="bunny",
                       seed=5, sampler="sobol", rr=True, rr_depth=1,
                       terminate_black=True)
    scene, cam = get_world("bunny", device=gpu)
    cluster_sweep.MARCH_LAUNCHES = cluster_sweep.WINDOW_LAUNCHES = 0
    g = make_renderer(cfg, gpu)(scene, cam).cpu().numpy()
    assert cluster_sweep.WINDOW_LAUNCHES > 0
    assert cluster_sweep.MARCH_LAUNCHES == 0
    scene_c, cam_c = get_world("bunny", device="cpu")
    c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    assert np.isfinite(g).all() and g.mean() > 0.2
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3


def _small_diff_case(name):
    """(make, cfg) of a 32x32, 2 spp, depth 3 differentiable render:
    cornell-diff through the dense sweep, the bunny through the march."""
    if name == "bunny":
        return (lambda d: get_world("bunny", device=d),
                RenderConfig(width=32, height=32, spp=2, max_depth=3,
                             ray_chunk=1024, accel="cluster", scene="bunny",
                             seed=1))
    _, _, cfg = get_preset("cornell-diff", device="cpu")
    return (lambda d: get_preset("cornell-diff", device=d)[:2],
            cfg.replace(width=32, height=32, spp=2, max_depth=3,
                        ray_chunk=1024, accel="pallas", seed=1))


@pytest.mark.parametrize("name", ["cornell-diff", "bunny"])
def test_gradients_match_cpu(gpu, name):
    """The differentiable pass through the kernels on the card (K2 for
    cornell-diff with NEE, K1 for the bunny) against the CPU twins: every
    gradient to rtol 1e-4, atol 1e-7 (the card's scatter-add backward sums
    in another order) over the pixels whose image agrees within 1e-4: at
    least 97% (the forward checks allow 1% of channels to differ)."""
    cluster_sweep.MARCH_LAUNCHES = pallas_sweep.SWEEP_LAUNCHES = 0
    make, cfg = _small_diff_case(name)
    _, kept, g, c = diff.paired_gradients(make, cfg, (gpu, "cpu"))
    launched = (cluster_sweep.MARCH_LAUNCHES if name == "bunny"
                else pallas_sweep.SWEEP_LAUNCHES)
    assert launched > 0 and kept >= 0.97
    for f in g:
        assert np.isfinite(g[f]).all(), f
        np.testing.assert_allclose(g[f], c[f], rtol=1e-4, atol=1e-7,
                                   err_msg=f)
    assert np.abs(g["albedo"]).sum() > 0 and np.abs(g["v0"]).sum() > 0


@pytest.mark.parametrize("sort_rays", [True, False])
def test_march_kernel_matches_twin_under_cull2(gpu, sort_rays):
    """The level-2 bunny (905 regular clusters, past every chunk's old
    57 slots) with cull2 forced on (sup 2): the march's inputs under the
    two-level plan, kernel against twin to the bit, on a 57,600-ray camera
    wavefront and (unsorted, t_max 1) as a shadow query."""
    from pathtracer_tpu_torch.scene.bunny import bunny_world
    scene, cam = bunny_world(subdivide=2, device=gpu)
    ct = build_cluster_tables(scene, K=64)
    assert ct.C_reg == 905
    o, d = _wavefront("camera", cam, 57600, gpu)
    kw = {} if sort_rays else dict(t_max=1.0, sort_rays=False)
    q = cluster_sweep.march_inputs(ct, o, d, T_MIN, cull2=True, **kw)
    assert (q["cull2"], q["sup"]) == (True, 2)
    assert q["args"][3].shape[1] == ct.C_reg + 1
    t_k, b_k, s_k = _march_bit_equal(q["args"])
    assert s_k.sum() > 0 and (b_k >= 0).sum() > 1000


PREP_FIELDS = ("o", "d", "active", "active0", "rid", "t_res", "b_res")


def _prep_case(case, dev):
    """(tables, o, d, t_min, march_inputs kwargs) of a march cell's query
    at its shape: the bunny's 16,384-lane sorted wavefront with the
    integrator's extras (three attenuation planes, strided as its first
    bounce holds them, and the flags word; a tenth of the lanes dead), and
    the combined scene's 129,600-lane chunk
    (no multiple of the ray tile) as its sorted closest-hit query and its
    unsorted shadow query (t_min K_SHADOW_T_MIN, t_max 1)."""
    from pathtracer_tpu_torch.presets import combined_scene
    rng = np.random.default_rng(21)
    if case == "bunny_extras":
        scene, cam = get_world("bunny", device=dev)
        ct = build_cluster_tables(scene, K=64)
        n = 16384
        o, d = _wavefront("camera", cam, n, dev)
        alive = torch.from_numpy(rng.random(n) < 0.9).to(dev)
        atten = torch.from_numpy(rng.random((n, 3), dtype=np.float32)).to(dev)
        flags = torch.arange(n, dtype=torch.int32, device=dev)
        return ct, o, d, T_MIN, dict(active=alive,
                                     extras=(*atten.unbind(1), flags))
    scene, cam = combined_scene(device=dev)
    ct = build_cluster_tables(scene, K=64)
    n = 129600
    o, d = _wavefront("camera", cam, n, dev)
    if case == "combined_closest":
        return ct, o, d, T_MIN, {}
    assert case == "combined_shadow"
    _, t, valid = cluster_sweep.cluster_march(ct, o, d, T_MIN)
    p = o + t[:, None] * d
    lo = ct.cmin.amin(dim=0).cpu().numpy()
    hi = ct.cmax.amax(dim=0).cpu().numpy()
    light = torch.from_numpy(rng.uniform(lo, hi, (n, 3)).astype(
        np.float32)).to(dev)
    seg = torch.where(valid[:, None], light - p, 0.0)
    return ct, p, seg, K_SHADOW_T_MIN, dict(active=valid, t_max=1.0,
                                            sort_rays=False)


def _same_bits(name, got, want):
    """Equal to the bit; a NaN matches any NaN (its bits are no part of
    the result, which is only compared)."""
    got, want = got.cpu(), want.cpu()
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == torch.float32:
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan), name
        got, want = got[~nan].view(torch.int32), want[~nan].view(torch.int32)
    assert torch.equal(got, want), name


def _prep_bit_equal(ct, o, d, t_min, kw):
    """march_inputs on the card against its twin on the same inputs: every
    output to the bit. Returns (kernels' dict, launches counted)."""
    before = cluster_sweep.MARCH_PREP_LAUNCHES
    got = cluster_sweep.march_inputs(ct, o, d, t_min, **kw)
    launched = cluster_sweep.MARCH_PREP_LAUNCHES - before
    want = cluster_sweep.march_inputs_reference(ct, o, d, t_min, **kw)
    for name in PREP_FIELDS:
        _same_bits(name, got[name], want[name])
    for name, g, w in zip(("phi", "a", "gate", "ids", "ents"),
                          got["args"][:5], want["args"][:5]):
        _same_bits(name, g, w)
    for x, y in zip(got["args"][5:], want["args"][5:], strict=True):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y
    if want["extras"] is None:
        assert got["extras"] is None
    else:
        for g, w in zip(got["extras"], want["extras"], strict=True):
            _same_bits("extras", g, w)
    return got, launched


@pytest.mark.parametrize("case", ["bunny_extras", "combined_closest",
                                  "combined_shadow"])
def test_march_prep_kernels_match_twin_at_the_cells_shapes(gpu, case):
    """The preparation kernels at the two march cells' shapes: every
    output bit-equal to the twin; two launches a sorted query (march_bin,
    march_order), one an unsorted one."""
    ct, o, d, t_min, kw = _prep_case(case, gpu)
    q, launched = _prep_bit_equal(ct, o, d, t_min, kw)
    assert launched == (1 if kw.get("sort_rays") is False else 2)
    assert bool(q["active"].any()) and int((q["b_res"] >= 0).sum()) > 0


@pytest.mark.parametrize("case", ["bunny_extras", "combined_closest",
                                  "combined_shadow"])
def test_march_prep_kernels_keep_the_winners(gpu, case, monkeypatch):
    """cluster_march through the kernels returns what it returns through
    the twin (the parent's path), every tensor to the bit."""
    ct, o, d, t_min, kw = _prep_case(case, gpu)
    got = cluster_sweep.cluster_march(ct, o, d, t_min, **kw)
    monkeypatch.setattr(cluster_sweep, "march_inputs",
                        cluster_sweep.march_inputs_reference)
    before = cluster_sweep.MARCH_PREP_LAUNCHES
    want = cluster_sweep.cluster_march(ct, o, d, t_min, **kw)
    assert cluster_sweep.MARCH_PREP_LAUNCHES == before
    for g, w in zip(got, want, strict=True):
        if isinstance(g, tuple):
            for gg, ww in zip(g, w, strict=True):
                _same_bits("extras", gg, ww)
        else:
            _same_bits("result", g, w)
    assert int(got[2].sum()) > 100


@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("ray_tile", [32, 96, 256, 1024])
@pytest.mark.parametrize("n", [1, 129, 1001])
def test_march_prep_kernels_tiles_and_ragged_counts(gpu, sort_rays,
                                                    ray_tile, n):
    """Chunks of 32 to 1,024 lanes and wavefronts that are no multiple of
    the chunk, with dead lanes, sorted and not."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, n, gpu)
    d[::3] = 0.0
    _, launched = _prep_bit_equal(ct, o, d, T_MIN, dict(
        ray_tile=ray_tile, sort_rays=sort_rays))
    assert launched == (2 if sort_rays else 1)


@pytest.mark.parametrize("sort_rays", [True, False])
def test_march_prep_kernels_on_the_level2_bunny(gpu, sort_rays):
    """The level-2 bunny's flat plan (905 clusters: the boxes and every
    chunk's order well past the main path's 57) on a 57,600-ray camera
    wavefront, sorted and not: bit-equal to the twin."""
    from pathtracer_tpu_torch.scene.bunny import bunny_world
    scene, cam = bunny_world(subdivide=2, device=gpu)
    ct = build_cluster_tables(scene, K=64)
    assert ct.C_reg == 905
    o, d = _wavefront("camera", cam, 57600, gpu)
    q, launched = _prep_bit_equal(ct, o, d, T_MIN,
                                  dict(sort_rays=sort_rays))
    assert launched == (2 if sort_rays else 1)
    assert q["args"][3].shape == (450, 906)


def test_march_prep_extras_ride_the_kernel(gpu):
    """Up to eight extras of 4-byte elements, contiguous or strided, ride
    march_order, bit-equal to the twin's gather; a bool or int64 plane, a
    ninth plane and one that requires grad are refused before any
    launch."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    n = 1024
    o, d = _wavefront("bounce", cam, n, gpu)
    rng = np.random.default_rng(22)
    planes = torch.from_numpy(rng.random((n, 9), dtype=np.float32)).to(gpu)
    extras = (*planes.unbind(1)[:6], planes[:, 6].contiguous(),
              torch.arange(n, dtype=torch.int32, device=gpu))
    q, launched = _prep_bit_equal(ct, o, d, T_MIN, dict(extras=extras))
    assert launched == 2 and len(q["extras"]) == len(extras)
    assert [x.dtype for x in q["extras"]] == [x.dtype for x in extras]
    before = cluster_sweep.MARCH_PREP_LAUNCHES
    for bad in ((planes[:, 0] > 0.5,), (torch.arange(n, device=gpu),),
                (*extras, planes[:, 8]),
                (planes[:, 0].clone().requires_grad_(),)):
        with pytest.raises(ValueError):
            cluster_sweep.march_inputs(ct, o, d, T_MIN, extras=bad)
    assert cluster_sweep.MARCH_PREP_LAUNCHES == before


def test_march_prep_kernels_leave_other_plans_to_the_twin(gpu):
    """cull2 and an explicit sup > 1 take the twin on the card: no
    preparation launch; an empty wavefront launches nothing and counts
    none."""
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 512, gpu)
    before = cluster_sweep.MARCH_PREP_LAUNCHES
    for kw in (dict(cull2=True), dict(sup=4)):
        q = cluster_sweep.march_inputs(ct, o, d, T_MIN, **kw)
        assert (q["cull2"], q["sup"]) != (False, 1)
    for sort_rays in (True, False):
        _, launched = _prep_bit_equal(ct, o[:0], d[:0], T_MIN,
                                      dict(sort_rays=sort_rays))
        assert launched == 0
    assert cluster_sweep.MARCH_PREP_LAUNCHES == before
    cluster_sweep.march_inputs(ct, o, d, T_MIN)
    assert cluster_sweep.MARCH_PREP_LAUNCHES == before + 2


def test_march_prep_wrapper_rejects_bad_inputs(gpu):
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 256, gpu)
    with pytest.raises(TypeError):
        cluster_sweep.march_inputs(ct, o.double(), d, T_MIN)
    with pytest.raises(ValueError):
        cluster_sweep.march_inputs(ct, o, d, T_MIN, ray_tile=100)
    with pytest.raises(TypeError):
        cluster_sweep.march_inputs(ct, o, d, T_MIN,
                                   active=torch.ones(256, device=gpu))
    with pytest.raises(ValueError):
        cluster_sweep.march_inputs(ct, o, d, T_MIN,
                                   active=torch.ones(256, dtype=torch.bool))
    with pytest.raises(ValueError, match="requires grad"):
        cluster_sweep.march_inputs(ct, o, d.clone().requires_grad_(), T_MIN)


def test_checkpoint_resume_on_the_card(gpu, tmp_path):
    """A render in passes of 2 spp stopped after its first pass and
    resumed equals the uninterrupted pass render on the card, bit for
    bit."""
    from pathtracer_tpu_torch.utils import checkpoint
    cfg = RenderConfig(width=64, height=36, spp=4, max_depth=3,
                       ray_chunk=64 * 36, accel="cluster", scene="bunny",
                       seed=5)
    scene, cam = get_world("bunny", device=gpu)

    def passes(path, progress=None):
        return checkpoint.render_with_checkpoints(
            scene, cam, cfg, path, spp_per_chunk=2, progress=progress,
            device=gpu).cpu().numpy()

    full = passes(None)

    def stop(done, total):
        if done >= 2:
            raise KeyboardInterrupt
    ck = str(tmp_path / "r.npz")
    with pytest.raises(KeyboardInterrupt):
        passes(ck, stop)
    cluster_sweep.MARCH_LAUNCHES = 0
    resumed = passes(ck)
    assert cluster_sweep.MARCH_LAUNCHES > 0
    np.testing.assert_array_equal(resumed, full)
    assert np.isfinite(full).all() and full.mean() > 0.3


def test_lbvh_on_the_card_equals_cpu_build(gpu):
    """The LBVH of the bunny and of its level-1 subdivision built on the
    card: all seven arrays equal to the CPU build (integer and min/max
    arithmetic only)."""
    from pathtracer_tpu_torch.accel.lbvh import build_lbvh
    from pathtracer_tpu_torch.scene.bunny import bunny_world
    for scene in (get_world("bunny", device="cpu")[0],
                  bunny_world(subdivide=1, device="cpu")[0]):
        cpu = build_lbvh(scene)
        card = build_lbvh(scene.to(gpu))
        for name, a, b in zip(cpu._fields, cpu, card):
            assert b.device.type == "cuda"
            assert torch.equal(a, b.cpu()), name


def _agree_up_to_near_ties(idx_a, t_a, v_a, idx_b, t_b, v_b):
    """Valid flags equal; winners equal but where the two t are within
    rtol 1e-5 (a near tie that the two numerical paths break apart); t to
    rtol 1e-5, atol 2e-4 (the sphere root's cancellation)."""
    v = v_a.cpu().numpy()
    np.testing.assert_array_equal(v, v_b.cpu().numpy())
    ia, ib = idx_a.cpu().numpy(), idx_b.cpu().numpy()
    ta, tb = t_a.cpu().numpy(), t_b.cpu().numpy()
    differ = v & (ia != ib)
    assert differ.sum() <= 1e-3 * v.sum(), differ.sum()
    np.testing.assert_allclose(ta[v], tb[v], rtol=1e-5, atol=2e-4)
    return int(v.sum())


def test_bvh_winners_equal_the_march(gpu):
    """The "bvh" route's traversal on the bunny's camera wavefront (57,600
    rays) against the march (K1), winners mapped to scene order."""
    from pathtracer_tpu_torch.accel.lbvh import build_lbvh
    from pathtracer_tpu_torch.ops.traversal import make_bvh_closest_hit
    scene, cam = get_world("bunny", device=gpu)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 57600, gpu)
    idx_m, t_m, v_m = cluster_sweep.cluster_march(ct, o, d, T_MIN)
    idx_m = torch.where(v_m, ct.perm[idx_m.long()], 0)
    bvh = make_bvh_closest_hit(scene, build_lbvh(scene), T_MIN)
    idx_b, t_b, v_b = bvh(o, d)
    assert _agree_up_to_near_ties(idx_b, t_b, v_b, idx_m, t_m, v_m) > 20000


def _bunny_nodes(gpu):
    from pathtracer_tpu_torch.accel.lbvh import build_lbvh
    scene, cam = get_world("bunny", device=gpu)
    return scene, cam, traversal.pack_fat_nodes(scene, build_lbvh(scene))


def _traverse_bit_equal(nodes, o, d, t_min, max_steps=0):
    """The traversal kernel against its twin on the card: winner, t and
    valid to the bit, the twin's dtypes, one launch counted (none for the
    twin). Returns the kernel's valid flags as numpy."""
    before = traversal.TRAVERSE_LAUNCHES
    got = traversal.traverse(nodes, o, d, t_min, intersect.BIG_T, max_steps)
    assert traversal.TRAVERSE_LAUNCHES == before + 1
    want = traversal.traverse_reference(nodes, o, d, t_min, intersect.BIG_T,
                                        max_steps)
    assert traversal.TRAVERSE_LAUNCHES == before + 1
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and x.device == y.device
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    np.testing.assert_array_equal(got[1].cpu().numpy().view(np.int32),
                                  want[1].cpu().numpy().view(np.int32))
    return got[2].cpu().numpy()


def test_bvh_kernel_matches_twin_on_the_camera_wavefront(gpu):
    """The bunny's 57,600-ray camera wavefront, the "bvh" route's query."""
    _, cam, nodes = _bunny_nodes(gpu)
    o, d = _wavefront("camera", cam, 57600, gpu)
    assert _traverse_bit_equal(nodes, o, d, T_MIN).sum() > 20000


def test_bvh_kernel_matches_twin_on_shadow_segments(gpu):
    """The shadow query (t_min K_SHADOW_T_MIN) on unnormalised segments
    from the camera hits to points above the scene."""
    _, cam, nodes = _bunny_nodes(gpu)
    o, d = _wavefront("camera", cam, 57600, gpu)
    _, t, valid = traversal.traverse(nodes, o, d, T_MIN, intersect.BIG_T)
    p = o + torch.where(valid, t, 1.0)[:, None] * d
    rng = np.random.default_rng(12)
    target = rng.uniform(-4, 4, (57600, 3)).astype(np.float32)
    target[:, 1] = np.abs(target[:, 1]) + 3.0
    seg = torch.from_numpy(target).to(gpu) - p
    assert _traverse_bit_equal(nodes, p, seg, K_SHADOW_T_MIN).any()


@pytest.mark.parametrize("max_steps", [1, 7, 64])
def test_bvh_kernel_matches_twin_under_a_cap(gpu, max_steps):
    """A step cap stops every ray alike in kernel and twin, and a ragged
    ray count ends in a partial block."""
    _, cam, nodes = _bunny_nodes(gpu)
    o, d = _wavefront("bounce", cam, 1000, gpu)
    valid = _traverse_bit_equal(nodes, o, d, T_MIN, max_steps)
    if max_steps == 1:
        assert not valid.any()


def test_bvh_wrapper_rejects_bad_inputs(gpu):
    _, cam, nodes = _bunny_nodes(gpu)
    o, d = _wavefront("camera", cam, 256, gpu)
    with pytest.raises(TypeError):
        traversal.traverse(nodes, o.double(), d, T_MIN, intersect.BIG_T)
    with pytest.raises(ValueError):
        traversal.traverse(nodes, o[:, :2], d[:, :2], T_MIN, intersect.BIG_T)
    with pytest.raises(ValueError):
        traversal.traverse(nodes, o.requires_grad_(), d, T_MIN,
                           intersect.BIG_T)
    bad = nodes._replace(idata=nodes.idata.long())
    with pytest.raises(TypeError):
        traversal.traverse(bad, o.detach(), d, T_MIN, intersect.BIG_T)


@pytest.mark.parametrize("spp_axis", [1, 2])
def test_sharded_render_on_one_card(gpu, spp_axis):
    """A mesh of two slots of the one card (2x1, 1x2) against the single
    render with the plan's chunk: to the bit on 2x1, within 1e-6 on 1x2
    (here 1 sample a slot, so also to the bit). The march is held to its
    twin on the first two queries of the sharded render in which a chunk
    marched (the plan's chunk of rays each), since the single render runs
    it too."""
    from unittest import mock

    from pathtracer_tpu_torch.parallel import make_mesh, make_sharded_renderer
    from pathtracer_tpu_torch.parallel.sharded import _shard_plan
    cfg = RenderConfig(width=64, height=36, spp=2, max_depth=3,
                       ray_chunk=2304, accel="cluster", scene="bunny",
                       seed=5)
    scene, cam = get_world("bunny", device=gpu)
    mesh = make_mesh([gpu, gpu], spp_axis_size=spp_axis)
    chunk = _shard_plan(cfg, mesh)[4]
    real_march = cluster_sweep.march
    marched = []

    def recording(*args):
        out = real_march(*args)
        if len(marched) < 2 and bool(out[2].any()):    # a chunk marched
            marched.append(args)
        return out
    cluster_sweep.MARCH_LAUNCHES = 0
    with mock.patch.object(cluster_sweep, "march", recording):
        img = make_sharded_renderer(cfg, mesh)(scene, cam)
    assert cluster_sweep.MARCH_LAUNCHES > 0
    assert [args[0].shape[0] for args in marched] == [
        -(-chunk // args[11]) * args[11] for args in marched]   # whole tiles
    assert len(marched) == 2
    for args in marched:
        _march_bit_equal(args)
    single = make_renderer(cfg.replace(ray_chunk=chunk), gpu)(scene, cam)
    assert torch.equal(img, single)
    assert img.mean() > 0.3


def test_bench_on_the_card(gpu):
    """The bench (``python -m pathtracer_tpu_torch.bench``) on the bunny at
    a small size: one line, correct, rates measured, the march launched,
    stamped with this card."""
    import json
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "pathtracer_tpu_torch.bench", "--width", "64",
         "--height", "36", "--spp", "2", "--depth", "3", "--iters", "2",
         "--ray-chunk", "2304"], cwd=repo, capture_output=True, text=True,
        timeout=600, env=dict(os.environ, PYTHONPATH=repo))
    lines = [json.loads(ln) for ln in proc.stdout.splitlines()
             if ln.startswith("{")]
    assert proc.returncode == 0 and len(lines) == 1, proc.stderr[-3000:]
    rec = lines[0]
    assert rec["correct"] and rec["accel"] == "cluster"
    assert rec["value"] > 0 and len(rec["walls_s"]) == 2
    assert 0 < rec["executed_queries"] <= rec["nominal_queries"]
    assert rec["launches"]["cluster_march"] > 0 and rec["pair_tests"] > 0
    assert rec["device"]["name"] == torch.cuda.get_device_name(0)
    assert rec["march_mfu"] is None or rec["march_mfu"] <= 1.0


def test_entry_step_on_the_card(gpu):
    from pathtracer_tpu_torch.entry import ENTRY_CFG, dryrun_multichip, entry
    cfg = ENTRY_CFG.replace(width=64, height=36, ray_chunk=2304)
    fn, (scene, cam, seed) = entry(gpu, cfg)
    cluster_sweep.MARCH_LAUNCHES = 0
    img = fn(scene, cam, seed)
    assert cluster_sweep.MARCH_LAUNCHES > 0
    assert torch.equal(img, make_renderer(cfg, gpu)(scene, cam, 0))
    assert np.isfinite(dryrun_multichip(2, device="cuda"))


def _draw_ids(kind, dev):
    """Ray ids from a march's binning order of the bunny's 57,600-ray
    camera wavefront ("march"), the same order counted down from 2^29 - 1,
    the sorted wavefront's largest id ("top"), or the first 57,500 of the
    march's, which the 256-thread block does not divide ("tail")."""
    scene, cam = get_world("bunny", device=dev)
    ct = build_cluster_tables(scene, K=64)
    o, d = _wavefront("camera", cam, 57600, dev)
    rid = cluster_sweep.march_inputs(ct, o, d, T_MIN)["rid"].to(torch.int32)
    if kind == "top":
        return (1 << 29) - 1 - rid
    return rid if kind == "march" else rid[:57500]


@pytest.mark.parametrize("ids", ["march", "top", "tail"])
@pytest.mark.parametrize("m", [1, 3, 6])
def test_uniforms_kernel_matches_twin(gpu, m, ids):
    """The draws kernel's "by_ray" mode against its twin on the card and
    on the CPU, to the bit; one launch counted per draw set."""
    rid = _draw_ids(ids, gpu)
    for key in ((0, 0), prng.fold_in(prng.PRNGKey(5), 3), (0xFFFFFFFF, 1)):
        before = uniforms.UNIFORMS_LAUNCHES
        got = uniforms.uniform_by_ray(key, rid, m)
        assert uniforms.UNIFORMS_LAUNCHES == before + 1
        twin = prng.uniform_by_ray(key, rid, m)
        assert uniforms.UNIFORMS_LAUNCHES == before + 1
        assert got.shape == (rid.shape[0], m) and got.device == rid.device
        assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
        cpu = uniforms.uniform_by_ray(key, rid.cpu(), m)
        assert torch.equal(got.cpu(), cpu)


@pytest.mark.parametrize("shape", [(1,), (7,), (2, 57600), (57600,),
                                   (2, 7200), (90000,), (3, 5, 4)])
def test_flat_uniforms_kernel_matches_twin(gpu, shape):
    key = prng.split(prng.fold_in(prng.PRNGKey(2), 11), 4)[2]
    before = uniforms.UNIFORMS_LAUNCHES
    got = uniforms.uniform(key, shape, gpu)
    assert uniforms.UNIFORMS_LAUNCHES == before + 1
    twin = prng.uniform(key, shape, gpu)
    assert got.shape == shape
    assert torch.equal(got.view(torch.int32), twin.view(torch.int32))
    assert torch.equal(got.cpu(), uniforms.uniform(key, shape, "cpu"))


def test_uniforms_wrapper_rejects_bad_inputs(gpu):
    rid = torch.arange(64, dtype=torch.int32, device=gpu)
    with pytest.raises(ValueError):
        uniforms.uniform_by_ray((1, 2), rid.view(8, 8), 3)
    with pytest.raises(ValueError):
        uniforms.uniform_by_ray((1, 2), rid, 0)
    before = uniforms.UNIFORMS_LAUNCHES
    assert uniforms.uniform_by_ray((1, 2), rid[:0], 3).shape == (0, 3)
    assert uniforms.UNIFORMS_LAUNCHES == before
    # an int64 rid takes the kernel with the same low 32 bits
    got = uniforms.uniform_by_ray((1, 2), rid.long() + (1 << 32), 3)
    assert torch.equal(got, uniforms.uniform_by_ray((1, 2), rid, 3))


def test_small_nee_rr_render_draws_on_the_card(gpu):
    """Cornell with NEE and Russian roulette from bounce 1 through the
    dense sweep (every draw set: flat, m = 6, 3 and 1), on the card with
    the draws kernel against the same render on the CPU."""
    cfg = RenderConfig(width=32, height=32, spp=4, max_depth=3,
                       ray_chunk=1000, accel="pallas", scene="cornell",
                       sky=False, nee=True, rr=True, rr_depth=1, seed=3)
    scene, cam = get_world("cornell", device=gpu)
    uniforms.UNIFORMS_LAUNCHES = pallas_sweep.SWEEP_LAUNCHES = 0
    g = make_renderer(cfg, gpu)(scene, cam).cpu().numpy()
    assert uniforms.UNIFORMS_LAUNCHES > 0 and pallas_sweep.SWEEP_LAUNCHES > 0
    scene_c, cam_c = get_world("cornell", device="cpu")
    c = make_renderer(cfg, "cpu")(scene_c, cam_c).numpy()
    diff = np.abs(g - c)
    assert np.isfinite(g).all()
    assert (diff <= 1e-4).mean() >= 0.99 and diff.mean() <= 1e-3


def _as_bits(x):
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("layout", ["caller", "march"])
@pytest.mark.parametrize("rr", [False, True], ids=["no_rr", "rr"])
@pytest.mark.parametrize("material", shade_cases.MATERIALS)
@pytest.mark.parametrize("prim", shade_cases.PRIMS)
def test_shade_kernel_matches_twin(gpu, prim, material, rr, layout):
    """The shading kernel against its twin's torch composition on the
    card, from the same state, bit for bit: every primitive kind and
    material case, with and without roulette, in caller order (the (N, 3)
    state) and in march order (shuffled lanes, separate planes, the flags
    word); one launch, and none by the twin."""
    case = shade_cases.make_case(prim, material, rr)
    ref = shade_cases.state(case, layout, gpu)
    got = shade_cases.state(case, layout, gpu)
    before = shade.SHADE_LAUNCHES
    shade.shade_reference(**ref)
    assert shade.SHADE_LAUNCHES == before
    shade.shade_bounce(**got)
    assert shade.SHADE_LAUNCHES == before + 1
    a, b = shade_cases.results(got), shade_cases.results(ref)
    for f in a:
        np.testing.assert_array_equal(_as_bits(a[f]), _as_bits(b[f]),
                                      err_msg=f)
    assert (a["alive"] != shade_cases.results(
        shade_cases.state(case, layout, "cpu"))["alive"]).any()


def _shadow_answer(case, scratch, dev):
    """A shadow query's answer for the NEE case's scratch (a brute scan of
    its scene), with every fifth lane's t put on the occlusion threshold
    1 - t_min in float32 and its two neighbours."""
    _, t, valid = intersect.brute_force_closest(
        case["scene"].to(dev), scratch.origin, scratch.seg, K_SHADOW_T_MIN,
        intersect.BIG_T)
    edge = torch.tensor(1.0 - T_MIN, dtype=torch.float32)
    near = torch.stack([edge, torch.nextafter(edge, torch.tensor(0.0)),
                        torch.nextafter(edge, torch.tensor(2.0))]).to(dev)
    t, valid = t.clone(), valid.clone()
    for k in range(3):
        t[k::5] = near[k]
        valid[k::5] = True
    return t, valid


@pytest.mark.parametrize("layout", ["caller", "march"])
@pytest.mark.parametrize("rr", [False, True], ids=["no_rr", "rr"])
@pytest.mark.parametrize("material", shade_cases.MATERIALS)
@pytest.mark.parametrize("prim", shade_cases.PRIMS)
def test_shade_nee_kernels_match_twins(gpu, prim, material, rr, layout):
    """The NEE pair against its twins' torch composition on the card, from
    the same state, bit for bit: the first kernel's state, NEE state and
    scratch (shadow rays, with zero segments off the light-sampling lanes
    on the march, each sample's share), then, from one shadow answer, the
    second's emitted sum; every primitive kind and material case, with and
    without roulette, in caller order and in march order. One launch of
    each kernel, none by the twins."""
    case = shade_cases.make_case(prim, material, rr, nee=True)
    ref = shade_cases.state(case, layout, gpu)
    got = shade_cases.state(case, layout, gpu)
    before = shade.SHADE_NEE_LAUNCHES
    before_finish = shade.SHADE_NEE_FINISH_LAUNCHES
    integrator.shade_nee_reference(**ref)
    assert shade.SHADE_NEE_LAUNCHES == before
    shade.shade_nee(**got)
    assert shade.SHADE_NEE_LAUNCHES == before + 1
    a, b = shade_cases.results(got), shade_cases.results(ref)
    for f in a:
        np.testing.assert_array_equal(_as_bits(a[f]), _as_bits(b[f]),
                                      err_msg=f)
    t_sh, sh_valid = _shadow_answer(case, ref["scratch"], gpu)
    shade.shade_nee_finish_reference(t_sh, sh_valid, ref["scratch"].cand,
                                     ref["emitted"], T_MIN)
    assert shade.SHADE_NEE_FINISH_LAUNCHES == before_finish
    shade.shade_nee_finish(t_sh, sh_valid, got["scratch"].cand,
                           got["emitted"], T_MIN)
    assert shade.SHADE_NEE_LAUNCHES == before + 1
    assert shade.SHADE_NEE_FINISH_LAUNCHES == before_finish + 1
    np.testing.assert_array_equal(
        _as_bits(shade_cases.results(got)["emitted"]),
        _as_bits(shade_cases.results(ref)["emitted"]))
    # what the case is there for: the lanes that sample a light
    takes = material in ("lambertian", "textured", "metal_fuzz_below")
    assert a["take"].any() == takes
    if takes:
        assert (a["cand"][a["take"]] > 0).any()
    if layout == "march":
        assert not a["seg"][~a["take"]].any()


def _math_inputs(fn, dev):
    """Float32 inputs over the ranges the kernel calls each function on,
    and beyond: 2^22 of them, plus the edges."""
    g = torch.Generator(device="cpu").manual_seed(7)
    n = 1 << 22
    u = torch.rand(n, generator=g)
    if fn in ("sin", "cos"):
        a = torch.cat([(2.0 * vec.PI) * u, (u - 0.5) * 200.0])
    elif fn in ("acos", "atan2"):
        a = torch.cat([u * 2.0 - 1.0, torch.tensor([-1.0, 1.0, 0.0, -0.0])])
    elif fn in ("pow5", "cube"):
        a = torch.cat([u * 2.0, torch.tensor([0.0, 1.0, 1e-4])])
    else:
        a = torch.cat([u, torch.tensor([0.0, 1e-30])])
    b = torch.rand(a.shape[0], generator=g) * 2.0 - 1.0
    b[-4:] = torch.tensor([0.0, -0.0, 1.0, -1.0])
    return a.to(dev), b.to(dev)


@pytest.mark.parametrize("fn", shade.MATH_FUNCTIONS)
def test_shade_math_calls_match_torch(gpu, fn):
    """The math library calls of the shading kernel against torch's CUDA
    ops of the same function, which the twin calls, bit for bit."""
    a, b = _math_inputs(fn, gpu)
    ref = {"sin": lambda: torch.sin(a), "cos": lambda: torch.cos(a),
           "acos": lambda: torch.acos(a),
           "atan2": lambda: torch.atan2(a, b),
           "pow5": lambda: torch.pow(a, 5.0),
           "cbrt": lambda: torch.pow(a, 1.0 / 3.0),
           "cube": lambda: a ** 3}[fn]()
    got = shade.math_kernel(fn, a, b if fn == "atan2" else None)
    differ = (got.view(torch.int32) != ref.view(torch.int32))
    assert int(differ.sum()) == 0, (
        f"{fn}: {int(differ.sum())} of {a.numel()} differ, e.g. at "
        f"{a[differ][:3].tolist()}: {got[differ][:3].tolist()} vs "
        f"{ref[differ][:3].tolist()}")


def _count_bounces(monkeypatch):
    """A list whose first entry counts the bounces the integrator runs
    from now on (the loop's test passing)."""
    count = [0]
    test = integrator._any_alive

    def counting(alive):
        going = test(alive)
        count[0] += going
        return going
    monkeypatch.setattr(integrator, "_any_alive", counting)
    return count


@pytest.mark.parametrize("cell", ["bunny", "rtow", "cornell"])
def test_shade_launches_are_the_bounces_of_a_bench_render(gpu, cell,
                                                          monkeypatch):
    """One sample of a benchmark cell's image at its shape (the bunny
    640x360, depth 4, on the sorted march; the triangle world 800x450,
    depth 50, and the Cornell box's full variant 256x256 under NEE, depth
    4, through the dense sweep; chunks of 16,384): one launch a bounce,
    every bounce, of the shading kernel, or under NEE of each of the pair's
    kernels and none of the other."""
    if cell == "bunny":
        cfg = RenderConfig(width=640, height=360, spp=1, max_depth=4,
                           ray_chunk=16384, accel="auto", scene="bunny")
        scene, cam = get_world(cfg.scene, device=gpu)
    elif cell == "rtow":
        cfg = RenderConfig(width=800, height=450, spp=1, max_depth=50,
                           ray_chunk=16384, accel="auto", scene="triangle")
        scene, cam = get_world(cfg.scene, device=gpu)
    else:
        scene, cam, cfg = get_preset("cornell-full", device=gpu)
        cfg = cfg.replace(spp=1, ray_chunk=16384)
    count = _count_bounces(monkeypatch)
    shade.SHADE_LAUNCHES = shade.SHADE_NEE_LAUNCHES = 0
    shade.SHADE_NEE_FINISH_LAUNCHES = 0
    img = make_renderer(cfg, gpu)(scene, cam)
    torch.cuda.synchronize()
    nee = (shade.SHADE_NEE_LAUNCHES, shade.SHADE_NEE_FINISH_LAUNCHES)
    if cfg.nee:
        assert count[0] > 0 and nee == (count[0],) * 2
        assert shade.SHADE_LAUNCHES == 0
    else:
        assert count[0] > 0 and shade.SHADE_LAUNCHES == count[0]
        assert nee == (0, 0)
    assert torch.isfinite(img).all()


@pytest.mark.parametrize("path", ["autograd", "nee"])
def test_shade_kernels_under_nee_and_autograd(gpu, path, monkeypatch):
    """The differentiable pass keeps the torch composition: no shading
    launch, though it bounces. NEE's bounces (Cornell with Russian
    roulette through the dense sweep) launch each of the pair's kernels
    once a bounce and the shading kernel never."""
    count = _count_bounces(monkeypatch)
    shade.SHADE_LAUNCHES = shade.SHADE_NEE_LAUNCHES = 0
    shade.SHADE_NEE_FINISH_LAUNCHES = 0
    nee = (lambda: (shade.SHADE_NEE_LAUNCHES,
                    shade.SHADE_NEE_FINISH_LAUNCHES))
    if path == "autograd":
        make, cfg = _small_diff_case("bunny")
        diff.paired_gradients(make, cfg, (gpu, "cpu"))
        assert count[0] > 0 and nee() == (0, 0)
    else:
        cfg = RenderConfig(width=32, height=32, spp=2, max_depth=3,
                           ray_chunk=1024, accel="pallas", scene="cornell",
                           sky=False, nee=True, rr=True, rr_depth=1)
        scene, cam = get_world("cornell", device=gpu)
        make_renderer(cfg, gpu)(scene, cam)
        torch.cuda.synchronize()
        assert count[0] > 0 and nee() == (count[0],) * 2
    assert shade.SHADE_LAUNCHES == 0


@pytest.mark.parametrize("route", ["pallas", "cluster"])
def test_nee_render_on_the_card_gives_the_composition_bits(gpu, route,
                                                            monkeypatch):
    """The Cornell box's full variant under NEE and Russian roulette on
    the card, 64x64 at 2 spp: through the NEE pair, the image and stats
    bit-equal to the torch composition's on the card (``_fused_shading``
    False), in caller order through the dense sweep and on the march's
    sorted payload."""
    scene, cam, cfg = get_preset("cornell-full", device=gpu)
    cfg = cfg.replace(width=64, height=64, spp=2, ray_chunk=4096,
                      accel=route, rr=True, rr_depth=1)

    def render():
        img, stats = make_renderer(cfg, gpu, with_stats=True).render_passes(
            scene, cam, 1, seed=7)
        return img.cpu().numpy(), stats
    shade.SHADE_NEE_LAUNCHES = 0
    fused = render()
    assert shade.SHADE_NEE_LAUNCHES > 0
    monkeypatch.setattr(integrator, "_fused_shading",
                        lambda differentiable: False)
    composed = render()
    np.testing.assert_array_equal(fused[0].view(np.int32),
                                  composed[0].view(np.int32))
    assert fused[1] == composed[1] and fused[1][1] > 0


def test_shade_wrapper_rejects_bad_inputs(gpu):
    case = shade_cases.make_case("sphere", "lambertian", False)
    good = shade_cases.state(case, "caller", gpu)

    def bad(**changes):
        return {**shade_cases.state(case, "caller", gpu), **changes}
    before = shade.SHADE_LAUNCHES
    with pytest.raises(TypeError):
        shade.shade_bounce(**bad(idx=good["idx"].to(torch.int32)))
    with pytest.raises(TypeError):
        shade.shade_bounce(**bad(alive=good["alive"].to(torch.uint8)))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(u=good["u"][:, :5].contiguous()))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(o=good["o"][:-1]))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(alive=good["alive"].cpu()))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(atten=good["atten"][:2]))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(atten=(good["atten"][0].contiguous(),)
                                 + good["atten"][1:]))
    with pytest.raises(ValueError):
        shade.shade_bounce(**bad(o=good["o"].requires_grad_()))
    assert shade.SHADE_LAUNCHES == before


def test_shade_nee_wrappers_reject_bad_inputs(gpu):
    case = shade_cases.make_case("sphere", "lambertian", False, nee=True)
    good = shade_cases.state(case, "caller", gpu)
    march = shade_cases.state(case, "march", gpu)

    def bad(**changes):
        return {**shade_cases.state(case, "caller", gpu), **changes}
    n = shade_cases.N
    before = shade.SHADE_NEE_LAUNCHES
    scratch = good["scratch"]
    # the scratch is sized, typed and placed like the wavefront
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(scratch=shade.nee_scratch(n - 1, gpu)))
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(scratch=scratch._replace(
            cand=torch.zeros((n, 4), device=gpu))))
    with pytest.raises(TypeError):
        shade.shade_nee(**bad(scratch=scratch._replace(
            take=torch.zeros(n, dtype=torch.uint8, device=gpu))))
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(scratch=shade.nee_scratch(n, "cpu")))
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(scratch=scratch._replace(
            seg=torch.zeros((3, n), device=gpu).t())))
    # the NEE state
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(spec_prev=None))
    with pytest.raises(ValueError):
        shade.shade_nee(**{**march, "spec_prev": good["spec_prev"]})
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(prev_pdf=good["prev_pdf"][:-1]))
    with pytest.raises(TypeError):
        shade.shade_nee(**bad(u_nee=good["u_nee"].double()))
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(u_nee=good["u_nee"][:, :2].contiguous()))
    # the emitter rows: built, and of a scene that has emitters
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(tables=shade.shade_tables(
            case["scene"].to(gpu))))
    no_lights = case["scene"]._replace(
        light_idx=case["scene"].light_idx[:0]).to(gpu)
    with pytest.raises(ValueError):
        shade.shade_nee(**bad(tables=shade.shade_tables(no_lights,
                                                        nee=True)))
    assert shade.SHADE_NEE_LAUNCHES == before
    # the second kernel's inputs
    before = shade.SHADE_NEE_FINISH_LAUNCHES
    t_sh = torch.ones(n, device=gpu)
    valid = torch.zeros(n, dtype=torch.bool, device=gpu)
    with pytest.raises(ValueError):
        shade.shade_nee_finish(t_sh[:-1], valid, scratch.cand,
                               good["emitted"], T_MIN)
    with pytest.raises(TypeError):
        shade.shade_nee_finish(t_sh, valid.float(), scratch.cand,
                               good["emitted"], T_MIN)
    with pytest.raises(ValueError):
        shade.shade_nee_finish(t_sh, valid, scratch.cand,
                               good["emitted"][:2], T_MIN)
    assert shade.SHADE_NEE_FINISH_LAUNCHES == before
