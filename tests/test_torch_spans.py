"""The port's spans and query counters (``utils/metrics.span``,
``render/integrator``, ``render/renderer``), on the CPU:

- under ``torch.profiler`` a render keeps ``pt.pass`` ⊃ ``pt.bounce`` ⊃
  ``pt.query`` / ``pt.wait`` nested on the host thread, one closest-hit
  query a bounce trip, under NEE ``pt.light`` spans inside the bounce
  holding each shadow ``pt.query``, on the march route one ``pt.cull``
  inside each ``pt.query``, and no span enters the profile itself (so a
  reader of the profile's events sees the work alone);
- with no profiler recording, a render enters ``record_function`` zero
  times and keeps nothing;
- ``trace_context``'s Chrome trace carries the spans;
- the renderer's stats are the ones recorded before the counters moved
  to the device, on the sorted march, the tensor route and the march's
  shadow queries (the combined scene's were recorded when the case was
  added, on the march queried in caller order), and its image bits are
  the same with the spans recorded under a profiler as without; the
  march's pair tests are its slots times K times the ray tile;
- the march's shadow-query counter counts one a bounce of a chunk under
  NEE on the march route, and none without NEE;
- a traced run of each benchmark cell on the CPU reads the four span
  metrics.
"""
from __future__ import annotations

import json
import math
import os

import pytest
import torch

from pathtracer_tpu_torch.config import RenderConfig
from pathtracer_tpu_torch.ops import cluster_sweep
from pathtracer_tpu_torch.ops.clusters import build_cluster_tables
from pathtracer_tpu_torch.render.renderer import make_renderer
from pathtracer_tpu_torch.scene.worlds import get_world
from pathtracer_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("pt.pass", "pt.bounce", "pt.query", "pt.wait")

# 2 samples in 1-spp passes of two 256-ray chunks (combined: one 576-ray
# chunk, which leaves the sorted wavefront off); recorded before the
# counters moved to the device (combined: when the case was added): the
# executed (queries, shadow queries, pair tests) at seed 5
CASES = {
    "bunny": (dict(width=32, height=16, spp=2, max_depth=4, ray_chunk=256,
                   accel="auto", scene="bunny"),
              (2147.0, 0.0, 3661824.0)),
    "triangle": (dict(width=32, height=16, spp=2, max_depth=6,
                      ray_chunk=256, accel="auto", scene="triangle"),
                 (6144.0, 0.0, 0.0)),
    "cornell": (dict(width=32, height=16, spp=2, max_depth=3, ray_chunk=256,
                     accel="cluster", sky=False, nee=True, scene="cornell"),
                (2614.0, 1901.0, 196608.0)),
    "combined": (dict(width=32, height=18, spp=2, max_depth=3,
                      ray_chunk=576, accel="auto", sky=False, nee=True,
                      stratify=True, scene="combined"),
                 (2187.0, 1198.0, 0.0)),
}
# the cases on the march route, whose queries each hold a pt.cull span
MARCH = ("bunny", "cornell", "combined")


def render(case, **changes):
    kw = {**CASES[case][0], **changes}
    args = ({"obj_path": os.path.join(ROOT, "assets", "bunny.obj")}
            if case == "combined" else {})
    scene, cam = get_world(kw["scene"], device="cpu", **args)
    renderer = make_renderer(RenderConfig(**kw), "cpu", with_stats=True)
    return renderer.render_passes(scene, cam, 1, seed=5)


def kept_by(fn):
    """(result of ``fn()``, the spans it kept)."""
    before = len(metrics.SPANS)
    result = fn()
    return result, list(metrics.SPANS)[before:]


def inside(child, parents):
    return any(p[0] <= child[0] and child[1] <= p[1] for p in parents)


@pytest.fixture(autouse=True)
def fresh_spans():
    metrics.SPANS.clear()
    yield
    metrics.SPANS.clear()


def profiled(fn):
    """(result of ``fn()`` under a CPU profiler, the spans it kept, the
    profiler)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        result, kept = kept_by(fn)
    return result, kept, prof


@pytest.mark.parametrize("case", sorted(CASES))
def test_spans_nest_under_a_profiler(case):
    (_, stats), kept, prof = profiled(lambda: render(case))
    names = (NAMES + (("pt.light",) if CASES[case][0].get("nee") else ())
             + (("pt.cull",) if case in MARCH else ()))
    by = {n: [x for x in kept if x[2] == n] for n in names}
    assert set(x[2] for x in kept) == set(names)
    assert [x[3] for x in by["pt.pass"]] == [(0, 1), (1, 1)]
    assert all(inside(b, by["pt.pass"]) for b in by["pt.bounce"])
    assert all(inside(q, by["pt.bounce"]) for q in by["pt.query"])
    if case in MARCH:
        # the march's host work, one a query, inside it
        assert len(by["pt.cull"]) == len(by["pt.query"])
        assert all(inside(c, by["pt.query"]) for c in by["pt.cull"])
    assert all(inside(w, by["pt.pass"]) for w in by["pt.wait"])
    closest = [q for q in by["pt.query"] if q[3] == "closest"]
    assert len(closest) == len(by["pt.bounce"])
    shadow = [q for q in by["pt.query"] if q[3] == "shadow"]
    if "pt.light" in by:
        # two pt.light spans a bounce, one holding its shadow query; the
        # closest-hit query outside them
        lights = by["pt.light"]
        assert len(lights) == 2 * len(by["pt.bounce"]) == 2 * len(shadow)
        assert all(inside(x, by["pt.bounce"]) for x in lights)
        assert all(inside(q, lights) for q in shadow)
        assert not any(inside(q, lights) for q in closest)
    else:
        assert not shadow
    assert {b[3] for b in by["pt.bounce"]} <= set(
        range(CASES[case][0]["max_depth"]))
    assert all(s <= e for s, e, _, _ in kept)
    # the bounce loop's test before each trip, the chunk keys once a pass
    sites = [w[3] for w in by["pt.wait"]]
    assert sites.count("alive.any") >= len(by["pt.bounce"])
    assert sites.count("chunk keys") == 2
    # the spans stay out of the profile: its events are the work alone
    assert not [e.name for e in prof.events() if e.name.startswith("pt.")]
    assert stats == CASES[case][1]


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_profiler_enters_record_function(case, monkeypatch):
    entered = []

    def counting(original):
        def record_function(*args, **kw):
            entered.append(args)
            return original(*args, **kw)
        return record_function
    for module in (torch.autograd.profiler, torch.profiler):
        monkeypatch.setattr(module, "record_function",
                            counting(module.record_function))
    (_, stats), kept = kept_by(lambda: render(case))
    assert entered == [] and kept == []
    assert stats == CASES[case][1]


def test_trace_context_carries_the_spans(tmp_path):
    log_dir = str(tmp_path / "trace")
    with metrics.trace_context(log_dir):
        render("triangle")
    with open(os.path.join(log_dir, metrics.TRACE_FILE)) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert set(NAMES) <= names
    assert not metrics._annotate


@pytest.mark.parametrize("case", sorted(CASES))
def test_stats_and_image_bits_as_recorded(case):
    img, stats = render(case)
    assert stats == CASES[case][1]
    assert all(isinstance(v, float) for v in stats)
    # the spans recorded under a profiler change no bit of the image
    (traced_img, traced_stats), kept, _ = profiled(lambda: render(case))
    assert kept and traced_stats == stats
    assert traced_img.numpy().tobytes() == img.numpy().tobytes()


@pytest.mark.parametrize("case,nee", [("combined", True),
                                      ("combined", False), ("bunny", False)])
def test_march_shadow_launches_count_one_a_bounce_under_nee(case, nee,
                                                           monkeypatch):
    monkeypatch.setattr(cluster_sweep, "MARCH_SHADOW_LAUNCHES", 0)
    _, kept, _ = profiled(lambda: render(case, nee=nee))
    bounces = [x for x in kept if x[2] == "pt.bounce"]
    shadows = [x for x in kept if x[2] == "pt.query" and x[3] == "shadow"]
    assert bounces
    assert len(shadows) == (len(bounces) if nee else 0)
    assert cluster_sweep.MARCH_SHADOW_LAUNCHES == len(shadows)


def test_march_pair_tests_stay_on_the_device():
    scene, cam = get_world("bunny", device="cpu")
    ct = build_cluster_tables(scene, K=64)
    n = 256
    g = torch.Generator().manual_seed(3)
    o = cam.position.expand(n, 3).contiguous()
    d = (cam.lower_left + torch.rand(n, 1, generator=g) * cam.horizontal
         + torch.rand(n, 1, generator=g) * cam.vertical - o)
    active = torch.rand(n, generator=g) < 0.8
    q = cluster_sweep.march_inputs(ct, o, d, 1e-3, active=active,
                                   extras=(o[:, 0],))
    _, _, slots = cluster_sweep.march(*q["args"])
    *_, pairs = cluster_sweep.cluster_march(ct, o, d, 1e-3, active=active,
                                            extras=(o[:, 0],))
    assert isinstance(pairs, torch.Tensor) and pairs.dim() == 0
    assert pairs.dtype == torch.int64
    want = float(slots.sum()) * ct.K * cluster_sweep.DEF_RAY_TILE
    assert want > 0 and float(pairs) == want


@pytest.mark.parametrize("workload,override", [
    ("bunny-128spp", {"width": 32, "height": 18, "spp": 16}),
    ("rtow-100spp", {"width": 32, "height": 18, "spp": 8})])
def test_traced_cell_reads_the_span_metrics(workload, override,
                                            monkeypatch):
    from perfbench.run import run_cell
    monkeypatch.chdir(ROOT)
    # the CPU has no stream to wait for
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    result = run_cell(workload, 2147483659, 1.0, True, device="cpu",
                      config_override=override)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    new = ("query_host_ms", "query_idle_share", "bounce_host_ms",
           "host_wait_share")
    assert all(math.isfinite(got[k]) for k in new), got
    assert got["query_host_ms"] > 0 and got["bounce_host_ms"] > 0
    assert 0 < got["host_wait_share"] < 100
    assert 0 < got["query_idle_share"] <= got["device_idle"]
