"""The benchmark's combined cell, ``combined-512spp``, on the CPU:

- its configuration (``perfbench/configs/combined.json``) renders what the
  CLI preset ``combined-1080p`` renders: the same ``RenderConfig`` and the
  same scene and camera;
- the plain reference's recipe (``perfbench/reference/scenes/combined``)
  lists the rows of ``combined_scene(obj_path=...)``, in its order;
- a traced run through ``perfbench.run.run_cell``, cut to 32 x 18 with
  576-ray chunks (which leaves the sorted wavefront off, as the cell's
  129,600-ray chunks do), is correct and reads ``cull_host_ms``; an
  untraced one is correct, and not with the light sample dropped or with
  the shadow query answering "no occluder" everywhere;
- the readers of the new metrics give their hand-computed values on
  made-up spans and device intervals, and nothing where the program
  keeps no ``pt.cull`` or ``pt.light`` span.
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

from pathtracer_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "combined-512spp"
SEED = 2147483659
OBJ = "assets/bunny.obj"
# 2 spp in the mix's 1-spp passes (the traced run renders one), depth 3,
# one 576-ray chunk: 576 % 128 = 64, so the integrator queries the march in
# caller order, as at 129,600 rays
SMALL = {"width": 32, "height": 18, "spp": 2, "max_depth": 3,
         "ray_chunk": 576}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reader(name):
    from perfbench.run import load_module
    return load_module(os.path.join(ROOT, "perfbench", "metrics",
                                    f"{name}.py"), f"test_combined_{name}")


def configuration():
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "combined.json")) as f:
        return json.load(f)


def test_configuration_is_the_combined_1080p_preset():
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.scene.worlds import get_world
    from perfbench.run import load_module
    config = configuration()
    assert config["scene_args"] == {"obj_path": OBJ}
    passes = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      "passes.py"), "test_combined_passes")
    scene, cam, cfg = get_preset("combined-1080p", device="cpu")
    assert passes._render_config(config, config["spp"]) == cfg
    # 16 chunks a 1-spp pass, none of them chunk-aligned for the march
    assert cfg.num_pixels == 16 * cfg.ray_chunk and cfg.ray_chunk % 128
    ours, our_cam = get_world(config["scene"], device="cpu",
                              **config["scene_args"])
    for a, b in zip((*ours, *our_cam), (*scene, *cam)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


def test_reference_rows_equal_the_programs(monkeypatch):
    from pathtracer_tpu_torch.presets import combined_scene
    from perfbench import compare
    monkeypatch.chdir(ROOT)
    plain = compare.reference_scene(configuration(), ROOT)
    scene, cam = combined_scene(obj_path=OBJ, device="cpu")
    assert scene.num_prims == 3630 and scene.num_lights == 2
    mat = scene.prim_mat.long()
    pairs = [(plain.ptype, scene.prim_type), (plain.v0, scene.v0),
             (plain.e1, scene.e1), (plain.e2, scene.e2),
             (plain.radius, scene.radius), (plain.normal, scene.tri_normal),
             (plain.mtype[plain.pmat], scene.mat_type[mat]),
             (plain.albedo[plain.pmat], scene.albedo[mat]),
             (plain.fuzz[plain.pmat], scene.fuzz[mat]),
             (plain.ir[plain.pmat], scene.ir[mat]),
             (plain.emit[plain.pmat], scene.emit[mat]),
             (plain.tex_id[plain.pmat], scene.tex_id[mat]),
             (plain.textures, scene.textures)]
    for ours, theirs in pairs:
        assert np.array_equal(np.asarray(ours), theirs.numpy())
    assert plain.camera["look_from"] == (278.0, 273.0, -800.0)
    assert plain.camera["look_at"] == (278.0, 273.0, 0.0)
    assert plain.camera["vfov"] == 40.0
    assert plain.camera["aspect"] == pytest.approx(16.0 / 9.0)


def test_an_explicit_mesh_wins_over_the_environment(tmp_path, monkeypatch):
    from pathtracer_tpu_torch.presets import combined_scene
    one = tmp_path / "one_triangle.obj"
    one.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    monkeypatch.setenv("PT_BUNNY_OBJ", str(one))
    pinned, _ = combined_scene(obj_path=os.path.join(ROOT, OBJ),
                               device="cpu")
    # without a path the scene follows PT_BUNNY_OBJ, as it always has
    followed, _ = combined_scene(device="cpu")
    assert pinned.num_prims == 3630 and followed.num_prims == 12 + 1 + 2
    # ... and without it the vendored asset
    monkeypatch.delenv("PT_BUNNY_OBJ")
    vendored, _ = combined_scene(device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(vendored, pinned))


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.chdir(ROOT)
    # the CPU has no stream to wait for
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def run(traced, seconds=1.0):
    from perfbench.run import run_cell
    return run_cell(CELL, SEED, seconds, traced, device="cpu",
                    config_override=SMALL)


def test_traced_run_is_correct_and_reads_the_cull_spans(on_cpu):
    metrics.SPANS.clear()
    result = run(True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert got["cull_host_ms"] > 0
    # the CPU's profile has no device interval, so no shadow query's
    # device time: the roofline reads nothing
    assert "shadow_query_roofline" not in got
    assert set(got) == {"cull_host_ms"}, got


@pytest.fixture
def pass_clock(on_cpu, monkeypatch):
    """One second a reading of the clock: a window of 2.5 s holds the two
    passes of the first image."""
    ticks = itertools.count(1000.0, 1.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def _no_light(*args, **kw):
    rec_p = args[1]
    return (torch.zeros_like(rec_p),
            torch.zeros(rec_p.shape[0], dtype=torch.bool))


def _no_occluder(monkeypatch):
    """Every route's shadow query answers "nothing in the way"."""
    from pathtracer_tpu_torch.render import renderer
    make_query = renderer.make_query

    def faulty(scene, cfg):
        query = make_query(scene, cfg)

        def query_shadow(o, d, active=None):
            n = o.shape[0]
            return (torch.zeros(n, dtype=torch.int64),
                    torch.full((n,), 3.0e38),
                    torch.zeros(n, dtype=torch.bool))
        query.closest.query_shadow = query_shadow
        return query
    monkeypatch.setattr(renderer, "make_query", faulty)


@pytest.mark.parametrize("fault", [None, "light dropped", "no occluder"])
def test_untraced_run_is_correct_and_faults_are_not(fault, pass_clock,
                                                    monkeypatch):
    from pathtracer_tpu_torch.render import lights
    if fault == "light dropped":
        monkeypatch.setattr(lights, "direct_lighting", _no_light)
    elif fault == "no occluder":
        _no_occluder(monkeypatch)
    result = run(False, seconds=2.5)
    assert result["attempted"] == 2
    assert result["correct"] == (fault is None), result["checks"]


# the window is [100, 1000). Two bounces, each a closest-hit query and two
# pt.light spans, the second holding the shadow query; every query holds a
# pt.cull span. On the device, in stream order: a camera kernel, then per
# bounce the closest query's work, a shading kernel, the shadow query's
# work and a finishing kernel.
WINDOW = (100, 1000)
SPANS = [
    (90, 1000, "pt.pass", (0, 1)),
    (110, 500, "pt.bounce", 0),
    (120, 200, "pt.query", "closest"),
    (125, 175, "pt.cull", None),
    (210, 220, "pt.light", 0),
    (230, 400, "pt.light", 0),
    (240, 380, "pt.query", "shadow"),
    (245, 345, "pt.cull", None),
    (450, 470, "pt.wait", "alive.any"),
    (500, 950, "pt.bounce", 1),
    (510, 600, "pt.query", "closest"),
    (515, 565, "pt.cull", None),
    (610, 620, "pt.light", 1),
    (630, 900, "pt.light", 1),
    (640, 880, "pt.query", "shadow"),
    (650, 830, "pt.cull", None),
]
CLOSEST_0 = [(205, 215, "cull"), (215, 260, "march")]
SHADOW_0 = [(300, 310, "cull"), (310, 390, "march"), (390, 395, "copy")]
CLOSEST_1 = [(560, 570, "cull"), (570, 640, "march")]
SHADOW_1 = [(700, 720, "cull"), (720, 760, "march")]
QUERIES = CLOSEST_0 + SHADOW_0 + CLOSEST_1 + SHADOW_1
OTHER = [(105, 110, "camera"), (270, 280, "shade_nee"),
         (400, 410, "shade_nee_finish"), (650, 660, "shade_nee"),
         (800, 810, "shade_nee_finish")]


def run_of(device=QUERIES + OTHER, query_device=QUERIES, stats=(0.0, 50.0,
                                                                 0.0)):
    from perfbench import trace
    return SimpleNamespace(
        trace=trace.Summary(device=sorted(device), runtime={}, host_ops=[],
                            window_ns=WINDOW, window_s=1.0,
                            query_device=tuple(sorted(query_device)),
                            query_calls=4),
        window=SimpleNamespace(stats=list(stats)), spheres=2,
        triangles=3628)


@pytest.fixture
def kept(monkeypatch):
    """The program's span log, holding what a test puts there."""
    log = type(metrics.SPANS)(maxlen=metrics.SPANS.maxlen)
    monkeypatch.setattr(metrics, "SPANS", log)
    return log


def test_readers_give_their_hand_computed_values(kept):
    from perfbench.metrics.closest_hit_roofline import needed_bytes
    from perfbench.peaks import PEAK_BYTES
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    # four pt.cull spans: 50 + 100 + 50 + 180 ns
    assert reader("cull_host_ms").read(run_of()) == pytest.approx(
        380 / 4 / 1e6)
    # the second and fourth runs of query work, 95 + 60 ns, against 50
    # shadow rays and two reads of the scene
    need = needed_bytes(0.0, 2, 2, 3628, 50.0)
    assert need == 50 * 36 + 2 * (2 * 16 + 3628 * 36)
    assert reader("shadow_query_roofline").read(run_of()) == pytest.approx(
        100 * need / PEAK_BYTES / 155e-9)


def test_readers_give_none_without_their_spans(kept, monkeypatch):
    names = ("cull_host_ms", "shadow_query_roofline")
    for name in names:
        assert reader(name).read(SimpleNamespace(trace=None)) is None
        assert reader(name).read(run_of()) is None
    # a program older than pt.cull, or another route; a render without NEE
    kept.extend(sorted((x for x in SPANS if x[2] != "pt.cull"),
                       key=lambda x: x[1]))
    assert reader("cull_host_ms").read(run_of()) is None
    assert reader("shadow_query_roofline").read(run_of()) is not None
    kept.clear()
    kept.extend(sorted((x for x in SPANS if x[2] != "pt.light"),
                       key=lambda x: x[1]))
    assert reader("cull_host_ms").read(run_of()) is not None
    assert reader("shadow_query_roofline").read(run_of()) is None
    kept.clear()
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    # no device interval in a query (the CPU's profile), or runs that do
    # not pair off with the query spans (two queries' work run together)
    assert reader("shadow_query_roofline").read(
        run_of(device=OTHER, query_device=())) is None
    joined = [x for x in OTHER if x[2] != "shade_nee_finish"]
    assert reader("shadow_query_roofline").read(
        run_of(device=QUERIES + joined)) is None
    # a program that keeps no spans
    monkeypatch.delattr(metrics, "SPANS")
    for name in names:
        assert reader(name).read(run_of()) is None
