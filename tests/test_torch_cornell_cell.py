"""The benchmark's Cornell cell, ``cornell-64spp``, on the CPU:

- its configuration (``perfbench/configs/cornell.json``) renders what the
  CLI preset ``cornell-full`` renders: the same ``RenderConfig`` and the
  same scene and camera;
- a traced run through ``perfbench.run.run_cell``, cut to a small image,
  is correct and reads the four metrics of the NEE bounce's spans; an
  untraced one is correct, and not with the light sample dropped or the
  sky left on;
- the readers of the ``pt.light`` spans (``perfbench/light_spans.py``)
  give their hand-computed values on made-up spans and device intervals,
  and nothing where the program keeps no ``pt.light`` span.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from types import SimpleNamespace

import pytest
import torch

from pathtracer_tpu_torch.utils import metrics

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "cornell-64spp"
SEED = 2147483659
# a 64 x 64 image: 16 spp in two passes of the mix's 8 (the traced run
# renders one)
SMALL = {"width": 64, "height": 64, "spp": 16}
NEW = ("light_host_ms", "shade_host_ms", "shadow_query_host_ms",
       "light_idle_share")


def reader(name):
    from perfbench.run import load_module
    return load_module(os.path.join(ROOT, "perfbench", "metrics",
                                    f"{name}.py"), f"test_cornell_{name}")


def test_configuration_is_the_cornell_full_preset():
    from pathtracer_tpu_torch.presets import get_preset
    from pathtracer_tpu_torch.scene.worlds import get_world
    from perfbench.run import load_module
    with open(os.path.join(ROOT, "perfbench", "configs",
                           "cornell.json")) as f:
        config = json.load(f)
    passes = load_module(os.path.join(ROOT, "perfbench", "drivers",
                                      "passes.py"), "test_cornell_passes")
    scene, cam, cfg = get_preset("cornell-full", device="cpu")
    assert passes._render_config(config, config["spp"]) == cfg
    ours, our_cam = get_world(config["scene"], device="cpu",
                              **config["scene_args"])
    for a, b in zip((*ours, *our_cam), (*scene, *cam)):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
        else:
            assert a == b


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.chdir(ROOT)
    # the CPU has no stream to wait for
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def run(traced, seconds=1.0):
    from perfbench.run import run_cell
    return run_cell(CELL, SEED, seconds, traced, device="cpu",
                    config_override=SMALL)


def test_traced_run_is_correct_and_reads_the_light_spans(on_cpu):
    metrics.SPANS.clear()
    result = run(True)
    assert result["correct"], result["checks"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    assert set(got) == set(NEW), got
    assert got["light_host_ms"] > 0 and got["shade_host_ms"] > 0
    assert got["shadow_query_host_ms"] > 0
    # the CPU's profile has no device interval: every moment of NEE's host
    # work outside its shadow queries is idle
    assert 0 < got["light_idle_share"] < 100


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


@pytest.mark.parametrize("fault", [None, "light dropped", "sky on"])
def test_untraced_run_is_correct_and_faults_are_not(fault, pass_clock,
                                                    monkeypatch):
    from pathtracer_tpu_torch.render import integrator, lights
    if fault == "light dropped":
        monkeypatch.setattr(lights, "direct_lighting", _no_light)
    elif fault == "sky on":
        trace = integrator.trace
        monkeypatch.setattr(integrator, "trace",
                            lambda *a, **kw: trace(*a, **{**kw, "sky": True}))
    result = run(False, seconds=2.5)
    assert result["attempted"] == 2
    assert result["correct"] == (fault is None), result["checks"]


# the window is [100, 1000); the device is busy 150-250, 400-600 and
# 950-1100, so idle 100-150, 250-400 and 600-950. Each bounce holds a
# closest-hit query and two pt.light spans, the second holding the shadow
# query.
WINDOW = (100, 1000)
DEVICE = [(150, 250, "k"), (400, 600, "k"), (950, 1100, "k")]
SPANS = [
    (10, 115, "pt.bounce", 0),            # starts before the window
    (20, 30, "pt.light", 0),
    (40, 110, "pt.light", 0),
    (50, 100, "pt.query", "shadow"),
    (90, 1050, "pt.pass", (0, 8)),
    (120, 500, "pt.bounce", 1),
    (130, 200, "pt.query", "closest"),
    (210, 230, "pt.light", 1),
    (260, 420, "pt.light", 1),
    (300, 380, "pt.query", "shadow"),
    (450, 470, "pt.wait", "x"),
    (500, 520, "pt.wait", "alive.any"),   # between bounces
    (520, 980, "pt.bounce", 2),
    (540, 700, "pt.query", "closest"),
    (710, 730, "pt.light", 2),
    (740, 900, "pt.light", 2),
    (760, 850, "pt.query", "shadow"),
    (980, 1200, "pt.bounce", 3),          # crosses the window's end
    (985, 990, "pt.query", "closest"),
    (992, 995, "pt.light", 3),
    (996, 1150, "pt.light", 3),
    (1000, 1100, "pt.query", "shadow"),
]


def run_of(window=WINDOW, device=DEVICE):
    from perfbench import trace
    return SimpleNamespace(trace=trace.Summary(
        device=sorted(device), runtime={}, host_ops=[], window_ns=window,
        window_s=1.0))


@pytest.fixture
def kept(monkeypatch):
    """The program's span log, holding what a test puts there."""
    log = type(metrics.SPANS)(maxlen=metrics.SPANS.maxlen)
    monkeypatch.setattr(metrics, "SPANS", log)
    return log


def test_light_readers_give_their_hand_computed_values(kept):
    # closed order: a parent is kept after its children
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    got = {name: reader(name).read(run_of()) for name in NEW}
    # the pt.light spans that start in the window, less their shadow
    # queries: 20 + 80 + 20 + 70 + 3 + 54 ns, over bounces 1, 2 and 3
    assert got["light_host_ms"] == pytest.approx(247 / 3 / 1e6)
    # bounces 1, 2, 3 less their queries, waits and lights:
    # 380 - 270, 460 - 340, 220 - 162
    assert got["shade_host_ms"] == pytest.approx((110 + 120 + 58) / 3
                                                 / 1e6)
    # the shadow queries that start in the window: 80, 90 ns (the last
    # starts at its end)
    assert got["shadow_query_host_ms"] == pytest.approx(170 / 2 / 1e6)
    # lights in the window against the idle stretches, 10 + 140 + 20 +
    # 160 ns, less their shadow queries', 80 + 90 ns
    assert got["light_idle_share"] == pytest.approx(100 * 160 / 900)


def test_light_readers_give_none_without_light_spans(kept, monkeypatch):
    for name in NEW:
        assert reader(name).read(SimpleNamespace(trace=None)) is None
        assert reader(name).read(run_of()) is None
    # a render without NEE, or a program older than the span
    kept.extend(sorted((x for x in SPANS if x[2] != "pt.light"),
                       key=lambda x: x[1]))
    for name in NEW:
        assert reader(name).read(run_of()) is None
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    for name in NEW:
        assert reader(name).read(run_of(window=(5000, 6000))) is None
    # a program that keeps no spans
    monkeypatch.delattr(metrics, "SPANS")
    for name in NEW:
        assert reader(name).read(run_of()) is None
