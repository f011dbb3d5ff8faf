"""The readers of the program's spans (``perfbench/spans.py``) on made-up
spans and device intervals: nested spans, idle stretches that overlap
them, spans that cross either edge of the window, and no spans at all."""
from __future__ import annotations

import os
from types import SimpleNamespace

import pytest

from perfbench import trace
from perfbench.run import ROOT, load_module
from pathtracer_tpu_torch.utils import metrics

NEW = ("query_host_ms", "query_idle_share", "bounce_host_ms",
       "host_wait_share")

# the window is [100, 1000); the device is busy 150-250, 400-600 and
# 950-1100, so idle 100-150, 250-400 and 600-950
WINDOW = (100, 1000)
DEVICE = [(150, 250, "k"), (400, 600, "k"), (950, 1100, "k")]
SPANS = [
    (10, 115, "pt.bounce", 0),        # starts before the window
    (80, 110, "pt.query", "closest"),  # crosses the window's start
    (90, 1050, "pt.pass", (0, 8)),
    (120, 500, "pt.bounce", 1),
    (130, 300, "pt.query", "closest"),
    (350, 420, "pt.query", "shadow"),
    (450, 470, "pt.wait", "counters"),
    (500, 520, "pt.wait", "alive.any"),   # between bounces
    (520, 980, "pt.bounce", 2),
    (540, 700, "pt.query", "closest"),
    (650, 720, "pt.wait", "x"),           # overlaps the query before it
    (960, 975, "pt.wait", "y"),
    (980, 1200, "pt.bounce", 3),          # crosses the window's end
    (990, 1100, "pt.query", "closest"),
    (995, 1010, "pt.wait", "z"),
]


def reader(name):
    return load_module(os.path.join(ROOT, "perfbench", "metrics",
                                    f"{name}.py"), f"test_spans_{name}")


def run_of(window=WINDOW, device=DEVICE):
    return SimpleNamespace(trace=trace.Summary(
        device=sorted(device), runtime={}, host_ops=[], window_ns=window,
        window_s=1.0))


@pytest.fixture
def kept(monkeypatch):
    """The program's span log, holding what a test puts there."""
    log = type(metrics.SPANS)(maxlen=metrics.SPANS.maxlen)
    monkeypatch.setattr(metrics, "SPANS", log)
    return log


def test_each_reader_gives_its_hand_computed_value(kept):
    # closed order: a parent is kept after its children
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    run = run_of()
    got = {name: reader(name).read(run) for name in NEW}
    # queries that start in the window: 170, 70, 160, 110 ns
    assert got["query_host_ms"] == pytest.approx(510 / 4 / 1e6)
    # query union in the window (100-110, 130-300, 350-420, 540-700,
    # 990-1000) against the idle stretches: 10 + 20 + 50 + 50 + 100 ns
    assert got["query_idle_share"] == pytest.approx(100 * 230 / 900)
    # bounces 1, 2, 3: 380 - 260, 460 - (180 + 15), 220 - 110
    assert got["bounce_host_ms"] == pytest.approx((120 + 265 + 110) / 3
                                                  / 1e6)
    # waits in the window: 20 + 20 + 70 + 15 + 5 ns
    assert got["host_wait_share"] == pytest.approx(100 * 130 / 900)
    # no device interval at all: every query's time in the window is idle
    idle = reader("query_idle_share").read(run_of(device=[]))
    assert idle == pytest.approx(100 * (10 + 170 + 70 + 160 + 10) / 900)


def test_readers_give_none_without_spans(kept, monkeypatch):
    for name in NEW:
        # no trace, an empty log, spans outside the window
        assert reader(name).read(SimpleNamespace(trace=None)) is None
        assert reader(name).read(run_of()) is None
    kept.extend(sorted(SPANS, key=lambda x: x[1]))
    for name in NEW:
        assert reader(name).read(run_of(window=(5000, 6000))) is None
    # a program that keeps no spans
    monkeypatch.delattr(metrics, "SPANS")
    for name in NEW:
        assert reader(name).read(run_of()) is None
