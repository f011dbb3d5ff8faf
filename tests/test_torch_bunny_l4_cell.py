"""The benchmark's million-triangle cell, ``bunny-l4-128spp``, on the CPU:

- its configuration (``perfbench/configs/bunny-l4.json``) renders what the
  CLI preset ``bunny-l4`` renders: the same ``RenderConfig`` and the same
  scene and camera; at 925,699 primitives ``auto`` takes the cluster
  march on the card, and the cull plan is the two-level cull with
  superclusters of 29 clusters;
- the scene builder's whole-mesh rows are bit-equal to the rows built one
  triangle at a time (the bunny at levels 0-2, the combined scene, both
  Cornell boxes and the procedural worlds);
- the plain reference's recipe (``perfbench/reference/scenes/bunny_fine``)
  lists the program's rows at level 4: 925,699 of them, corners and edges
  bit-equal, materials equal, unit normals within 2 ulp;
- traced and untraced runs through ``perfbench.run.run_cell``, cut to the
  level-1 bunny at 32 x 16 in one 512-ray chunk, 2 spp, depth 4, with the
  two-level cull forced (``PT_CLUSTER_CULL2``), are correct and keep
  ``pt.cull2`` spans; with every other pixel x1.5 a run is not correct;
- with every lane's gate at its nearest touched supercluster's exit (the
  planted gate fault), the two-level cull's march loses hits: few at
  this size, too few for a run's comparison to see on the CPU, so the
  card's calibration judges that fault;
- the readers of the new metrics give their hand-computed values, and
  nothing without their spans or march intervals;
- ``march_prep_twin`` counts the preparations run as torch ops on the
  two-level cull, one a query, and none on the flat plan, where no
  ``pt.cull2`` span is kept.

The image is 32 x 16 rather than the other cells' 32 x 18 so that its
512-ray chunk is a multiple of the march's ray tile: the integrator then
takes the sorted wavefront, as the cell's 16,384-ray chunks do.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pathtracer_tpu_torch.ops import cluster_sweep
from pathtracer_tpu_torch.scene import scene as scene_mod
from pathtracer_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "bunny-l4-128spp"
SEED = 2147483659
OBJ = "assets/bunny.obj"
SMALL = {"width": 32, "height": 16, "spp": 2, "max_depth": 4,
         "ray_chunk": 512,
         "scene_args": {"obj_path": OBJ, "scale": 20.0, "subdivide": 1}}
# the largest distance, in units in the last place, between the
# reference's unit normals (length and division in float64) and the
# program's (in float32)
NORMAL_ULPS = 2


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reader(name):
    from perfbench.run import load_module
    return load_module(os.path.join(ROOT, "perfbench", "metrics",
                                    f"{name}.py"), f"test_bunny_l4_{name}")


def configuration():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "bunny-l4.json")) as f:
        return json.load(f)


def same_scene(ours, theirs):
    for name, a, b in zip(ours._fields, ours, theirs):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def test_configuration_is_the_bunny_l4_preset():
    from pathtracer_tpu_torch.config import route_accel
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.presets import PRESETS, get_preset
    from pathtracer_tpu_torch.render.renderer import CLUSTER_K
    from pathtracer_tpu_torch.scene.worlds import get_world
    from perfbench.run import load_module
    config = configuration()
    assert config["scene_args"] == {"obj_path": OBJ, "scale": 20.0,
                                    "subdivide": 4}
    assert "bunny-l4" in PRESETS
    passes = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      "passes.py"), "test_bunny_l4_passes")
    scene, cam, cfg = get_preset("bunny-l4", device="cpu")
    assert passes._render_config(config, config["spp"]) == cfg
    assert cfg.ray_chunk % cluster_sweep.DEF_RAY_TILE == 0
    ours, our_cam = get_world(config["scene"], device="cpu",
                              **config["scene_args"])
    same_scene(ours, scene)
    assert all(torch.equal(a, b) for a, b in zip(our_cam, cam))
    del ours
    # what the card takes: the march, on the two-level cull
    assert scene.num_prims == 3616 * 4 ** 4 + 3
    assert route_accel(cfg.accel, scene.num_prims, "cuda") == "cluster"
    tables = build_cluster_tables(scene, CLUSTER_K)
    assert (CLUSTER_K, tables.C_reg) == (64, 14465)
    assert cluster_sweep.cull_plan(tables.C_reg) == (True, 29)


@pytest.mark.parametrize("subdivide", [None, 0])
def test_the_fine_bunny_needs_a_level(subdivide):
    from pathtracer_tpu_torch.scene.worlds import get_world
    kw = {} if subdivide is None else {"subdivide": subdivide}
    with pytest.raises(ValueError, match="subdivide"):
        get_world("bunny_fine", device="cpu", **kw)


class PerTriangleBuilder(scene_mod.SceneBuilder):
    """The scene builder as it was: every row computed on its own, numpy's
    norm of one normal at a time, a mesh expanded face by face."""

    def add_sphere(self, center, radius, mat):
        z = np.zeros((1, 3), np.float32)
        self._add_rows(scene_mod.PRIM_SPHERE,
                       np.asarray(center, np.float32)[None], z, z, z, mat,
                       np.float32(radius))

    def add_triangle(self, v0, v1, v2, mat):
        v0 = np.asarray(v0, np.float32)
        v1 = np.asarray(v1, np.float32)
        v2 = np.asarray(v2, np.float32)
        e1, e2 = v1 - v0, v2 - v0
        n = np.cross(e1, e2)
        norm = np.linalg.norm(n)
        n = n / norm if norm > 0 else n
        self._add_rows(scene_mod.PRIM_TRIANGLE, v0[None],
                       e1.astype(np.float32)[None],
                       e2.astype(np.float32)[None],
                       n.astype(np.float32)[None], mat)

    def add_mesh(self, vertices, faces, mat):
        vertices = np.asarray(vertices, np.float32)
        for f in np.asarray(faces, np.int64):
            self.add_triangle(vertices[f[0]], vertices[f[1]],
                              vertices[f[2]], mat)


WORLDS = [("bunny", {}), ("bunny", {"subdivide": 1}),
          ("bunny", {"subdivide": 2}), ("combined", {"obj_path": OBJ}),
          ("cornell", {"variant": "full"}), ("cornell", {"variant": "spheres"}),
          ("test", {}), ("triangle", {}), ("random", {})]


@pytest.mark.parametrize("name,kw", WORLDS,
                         ids=[f"{n}-{'-'.join(map(str, k.values()))}"
                              for n, k in WORLDS])
def test_whole_mesh_rows_equal_the_per_triangle_rows(name, kw, monkeypatch):
    from pathtracer_tpu_torch import presets
    from pathtracer_tpu_torch.scene import bunny, cornell, worlds
    from pathtracer_tpu_torch.scene.worlds import get_world
    monkeypatch.chdir(ROOT)
    ours, our_cam = get_world(name, device="cpu", **kw)
    for module in (bunny, cornell, worlds, presets):
        monkeypatch.setattr(module, "SceneBuilder", PerTriangleBuilder)
    theirs, their_cam = get_world(name, device="cpu", **kw)
    if name == "bunny":
        assert ours.num_prims == 3616 * 4 ** kw.get("subdivide", 0) + 3
    same_scene(ours, theirs)
    assert all(torch.equal(a, b) for a, b in zip(our_cam, their_cam))


def test_whole_mesh_rows_keep_degenerate_normals():
    # a zero-area face keeps its zero normal, as one built alone does
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [2, 0, 0]],
                     np.float32)
    faces = np.array([[0, 1, 2], [0, 1, 3], [2, 0, 1]])
    rows = []
    for builder in (scene_mod.SceneBuilder(), PerTriangleBuilder()):
        builder.add_lambertian((0.5, 0.5, 0.5))
        builder.add_mesh(verts, faces, 0)
        builder.add_mesh(verts, faces[:0], 0)
        rows.append(builder.build(device="cpu"))
    same_scene(*rows)
    assert rows[0].num_prims == 3
    assert torch.equal(rows[0].tri_normal[1], torch.zeros(3))


def test_reference_rows_equal_the_programs(monkeypatch):
    from pathtracer_tpu_torch.scene.worlds import get_world
    from perfbench import compare
    monkeypatch.chdir(ROOT)
    config = configuration()
    plain = compare.reference_scene(config, ROOT)
    scene, _ = get_world(config["scene"], device="cpu",
                         **config["scene_args"])
    assert scene.num_prims == len(plain.ptype) == 925699
    mat = scene.prim_mat.long()
    pairs = [(plain.ptype, scene.prim_type), (plain.v0, scene.v0),
             (plain.e1, scene.e1), (plain.e2, scene.e2),
             (plain.radius, scene.radius),
             (plain.mtype[plain.pmat], scene.mat_type[mat]),
             (plain.albedo[plain.pmat], scene.albedo[mat]),
             (plain.fuzz[plain.pmat], scene.fuzz[mat]),
             (plain.ir[plain.pmat], scene.ir[mat]),
             (plain.emit[plain.pmat], scene.emit[mat]),
             (plain.tex_id[plain.pmat], scene.tex_id[mat]),
             (plain.textures, scene.textures)]
    for ours, theirs in pairs:
        assert np.array_equal(np.asarray(ours), theirs.numpy())
    ref = np.asarray(plain.normal)
    got = scene.tri_normal.numpy()
    # same signs, so the distance of the bit patterns counts ulps
    assert np.array_equal(np.signbit(ref), np.signbit(got))
    ulps = np.abs(ref.view(np.int32).astype(np.int64)
                  - got.view(np.int32).astype(np.int64))
    assert ulps.max() <= NORMAL_ULPS
    assert plain.camera["look_from"] == (0.0, 3.0, 9.0)
    assert plain.camera["look_at"] == (0.0, 1.5, 0.0)
    assert plain.camera["vfov"] == 35.0


def nearest_exit_gates(real):
    """``march_inputs_reference`` (``real``) with a fault planted on the
    two-level cull: each lane's gate is the exit of its nearest touched
    supercluster, not of its farthest, so a lane stops marching early and
    misses the hits beyond."""
    def broken(ct, o, d, t_min, **kw):
        q = real(ct, o, d, t_min, **kw)
        if not q["cull2"]:
            return q
        smin, smax = cluster_sweep._super_boxes(ct.cmin, ct.cmax, q["sup"])
        entry, exit_ = cluster_sweep._cull_T(q["o"], q["d"], q["active"],
                                             smin, smax, float(t_min),
                                             with_exit=True)
        big = cluster_sweep.BIG
        near = torch.argmin(entry, dim=0)
        gate = exit_.gather(0, near[None])[0]
        gate = torch.where(entry.amin(dim=0) >= big * 0.5, -big, gate)
        gate = gate * (1.0 + 1e-5) + 1e-5
        t_max = kw.get("t_max")
        if t_max is not None and t_max < big * 0.5:
            gate = torch.clamp(gate, max=t_max)
        gate = torch.where(q["active"], gate, -big)
        args = list(q["args"])
        args[2] = gate.contiguous()
        return {**q, "args": tuple(args)}
    return broken


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.chdir(ROOT)
    monkeypatch.setenv("PT_CLUSTER_CULL2", "1")
    # the CPU has no stream to wait for
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def run(traced, seconds=1.0):
    from perfbench.run import run_cell
    return run_cell(CELL, SEED, seconds, traced, device="cpu",
                    config_override=SMALL)


def test_traced_run_is_correct_and_reads_the_cull2_spans(on_cpu):
    metrics.SPANS.clear()
    cluster_sweep.MARCH_PREP_TWIN = 0
    result = run(True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    # the CPU's profile has no device interval, so no march interval: the
    # roofline reads nothing
    assert set(got) == {"cull2_host_ms"}, got
    assert got["cull2_host_ms"] > 0
    kept = [x for x in metrics.SPANS if x[2] in ("pt.cull", "pt.cull2")]
    culls = [x for x in kept if x[2] == "pt.cull"]
    culls2 = [x for x in kept if x[2] == "pt.cull2"]
    assert len(culls2) == len(culls) > 0
    # the set-up's warm-up sample marches once a bounce, before the profile
    assert cluster_sweep.MARCH_PREP_TWIN == len(culls) + SMALL["max_depth"]
    assert all(c[0] <= x[0] and x[1] <= c[1] for x, c in zip(culls2, culls))


@pytest.fixture
def pass_clock(on_cpu, monkeypatch):
    """One second a reading of the clock: a window of 2.5 s holds the
    passes of the first two images, one 2-spp pass each."""
    ticks = itertools.count(1000.0, 1.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


@pytest.mark.parametrize("fault", [None, "altered"])
def test_untraced_run_is_correct_and_faults_are_not(fault, pass_clock,
                                                    monkeypatch):
    from pathtracer_tpu_torch.render import renderer
    from perfbench.calibrate import faulty_render_sum
    if fault:
        monkeypatch.setattr(renderer, "render_sum", faulty_render_sum(
            renderer.render_sum, fault))
    cluster_sweep.MARCH_PREP_TWIN = 0
    result = run(False, seconds=2.5)
    assert result["attempted"] == 2
    assert cluster_sweep.MARCH_PREP_TWIN > 0
    assert result["correct"] == (fault is None), result["checks"]


def test_nearest_exit_gates_lose_hits(monkeypatch):
    """The gate fault at the query: a chunk stops once every lane's best
    hit or gate precedes its next cluster, so with gates too near some
    lanes lose their hit or keep a farther one; never a nearer one."""
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.scene.worlds import get_world
    monkeypatch.chdir(ROOT)
    scene, _ = get_world("bunny_fine", device="cpu",
                         **SMALL["scene_args"])
    ct = build_cluster_tables(scene, 64)
    gen = torch.Generator().manual_seed(7)
    o = torch.tensor([0.0, 3.0, 9.0]).repeat(4096, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, -0.2, -1.0]) + 0.12 * torch.randn(
            4096, 3, generator=gen), dim=1)
    sound = cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=True)
    flat = cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=False)
    monkeypatch.setattr(cluster_sweep, "march_inputs_reference",
                        nearest_exit_gates(
                            cluster_sweep.march_inputs_reference))
    broken = cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=True)
    # the flat plan keeps its gates
    assert all(torch.equal(a, b) for a, b in zip(
        flat, cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=False)))
    assert torch.equal(sound[1], flat[1])
    lost = sound[0] != broken[0]
    assert 0 < int(lost.sum()) < 100
    assert bool((broken[1][lost] > sound[1][lost]).all())
    assert int((sound[2] & ~broken[2]).sum()) > 0


# the window is [100, 1000); three pt.cull spans, two with a pt.cull2
# inside, one of them starting before the window
WINDOW = (100, 1000)
SPANS = [(90, 300, "pt.cull", None), (95, 280, "pt.cull2", None),
         (400, 500, "pt.cull", None), (410, 470, "pt.cull2", None),
         (600, 700, "pt.cull", None)]
MARCH = "cluster_march_kernel(float const*, float const*, float const*)"
DEVICE = [(50, 150, MARCH), (120, 130, "march_order_kernel"),
          (300, 400, MARCH), (350, 380, MARCH), (500, 520, "elementwise"),
          (900, 1100, MARCH)]


def run_of(device=DEVICE, pair_tests=4 * 8192.0):
    from perfbench import trace
    return SimpleNamespace(
        trace=trace.Summary(device=sorted(device), runtime={}, host_ops=[],
                            window_ns=WINDOW, window_s=1.0),
        window=SimpleNamespace(stats=[0.0, 0.0, pair_tests]), spheres=3,
        triangles=925696)


@pytest.fixture
def kept(monkeypatch):
    """The program's span log, holding what a test puts there."""
    log = type(metrics.SPANS)(maxlen=metrics.SPANS.maxlen)
    monkeypatch.setattr(metrics, "SPANS", log)
    return log


def test_readers_give_their_hand_computed_values(kept):
    from perfbench.peaks import PEAK_BYTES, PEAK_F32
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    # the pt.cull2 spans that start in the window: one of 60 ns
    assert reader("cull2_host_ms").read(run_of()) == pytest.approx(60 / 1e6)
    roof = reader("march_roofline")
    assert roof.OPS_PAIR == 106
    assert (roof.SLOT_TABLE_BYTES, roof.SLOT_RAY_BYTES) == (12288, 4608)
    # four slots of 64 rows x 128 rays; the march in the window: 50 + 100
    # + 100 ns
    ops = 4 * 8192 * 106 / PEAK_F32
    assert ops > 4 * (12288 + 4608) / PEAK_BYTES
    assert roof.read(run_of()) == pytest.approx(100 * ops / 250e-9)
    # a slower kernel against the same work
    slow = [x for x in DEVICE if x[0] != 350] + [(400, 500, MARCH)]
    assert roof.read(run_of(device=slow)) == pytest.approx(
        100 * ops / 350e-9)


def test_readers_give_none_without_their_spans(kept, monkeypatch):
    for name in ("cull2_host_ms", "march_roofline"):
        assert reader(name).read(SimpleNamespace(trace=None)) is None
    # the flat plan, or a program older than pt.cull2
    kept.extend(x for x in SPANS if x[2] != "pt.cull2")
    assert reader("cull2_host_ms").read(run_of()) is None
    kept.clear()
    kept.extend(x for x in SPANS if x[0] < 100)
    assert reader("cull2_host_ms").read(run_of()) is None
    # no march interval: another route, or the CPU's profile
    others = [x for x in DEVICE if x[2] != MARCH]
    assert reader("march_roofline").read(run_of(device=others)) is None
    assert reader("march_roofline").read(run_of(device=[])) is None
    # a program that keeps no spans
    monkeypatch.delattr(metrics, "SPANS")
    assert reader("cull2_host_ms").read(run_of()) is None


@pytest.mark.parametrize("cull2", [True, False])
def test_prep_twin_counts_the_two_level_cull_alone(cull2):
    from pathtracer_tpu_torch import bench
    from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
    from pathtracer_tpu_torch.scene.worlds import get_world
    scene, _ = get_world("bunny", device="cpu")
    ct = build_cluster_tables(scene, 64)
    gen = torch.Generator().manual_seed(7)
    o = torch.tensor([0.0, 3.0, 9.0]).repeat(256, 1)
    d = torch.nn.functional.normalize(
        torch.tensor([0.0, -0.15, -1.0]) + 0.2 * torch.randn(
            256, 3, generator=gen), dim=1)
    bench.reset_launch_counts()
    metrics.SPANS.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=cull2)
        cluster_sweep.cluster_march(ct, o, d, 1e-3, cull2=cull2,
                                    sort_rays=False)
    counts = bench.launch_counts()
    names = [x[2] for x in metrics.SPANS]
    assert counts["march_prep_twin"] == (4 if cull2 else 0)
    assert names.count("pt.cull") == 4
    assert names.count("pt.cull2") == (4 if cull2 else 0)
    # the flat plan's preparation on the CPU is the twin all the same, and
    # no kernel launched
    assert counts["march_prep"] == counts["cluster_march"] == 0
    bench.reset_launch_counts()
    assert bench.launch_counts()["march_prep_twin"] == 0
    metrics.SPANS.clear()
