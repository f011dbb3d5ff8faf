"""The harness's arithmetic on made-up inputs: the rate over whole passes,
the idle share as a union of intervals, the roofline's bytes, the sync and
launch counts, the breakdown, and the reduction of profiler events."""
from __future__ import annotations

import itertools
import os
import time
from types import SimpleNamespace

import pytest
import torch

from perfbench import trace
from perfbench.run import ROOT, load_module


def metric(name):
    return load_module(os.path.join(ROOT, "perfbench", "metrics",
                                    f"{name}.py"), f"test_metric_{name}")


def driver():
    return load_module(os.path.join(ROOT, "perfbench", "drivers",
                                    "passes.py"), "test_driver_passes")


class FakeRenderer:
    """Renders nothing: each pass advances the fake clock by 1 s."""

    def __init__(self, spp):
        self.spp = spp
        self.seeds = []

    def render_passes(self, scene, cam, pp, seed=None, on_pass=None):
        self.seeds.append(seed)
        acc = torch.zeros(4, 3)
        for done in range(pp, self.spp + pp, pp):
            on_pass(acc + done, min(done, self.spp))
        return torch.zeros(2, 2, 3), (10.0, 0.0, 0.0)


@pytest.fixture
def fake_clock(monkeypatch):
    ticks = itertools.count(100.0, 1.0)
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))


def fake_state(spp=16, pp=8, pixels=4):
    return SimpleNamespace(seed=5, device="cpu", scene=None, cam=None,
                           renderer=FakeRenderer(spp), spp=spp, pp=pp,
                           pixels=pixels)


def test_rate_counts_whole_passes_inside_the_window(fake_clock):
    # the window opens at t=100; passes end at 101, 102, 103, 104: with a
    # 3.5 s window the pass ending at 104 is left out
    state = fake_state(spp=16, pp=8, pixels=4)
    window = driver().measure(state, 3.5)
    assert window.passes == 3
    assert window.samples == 3 * 8 * 4
    assert window.seconds == 3.0
    # two images: the first finished (2 passes), the second stopped after 1
    assert [a.samples for a in window.answers] == [16, 8]
    assert window.answers[0].image is not None
    assert window.answers[1].image is None
    assert state.renderer.seeds == [5 * 1024, 5 * 1024 + 1]
    rate = metric("msamples_per_s").read(SimpleNamespace(window=window))
    assert rate == pytest.approx(96 / 3.0 / 1e6)


def summary(device, window=(0, 100), host=(), runtime=None):
    return trace.Summary(device=sorted(device), runtime=runtime or {},
                         host_ops=sorted(host), window_ns=window,
                         window_s=1.0)


def test_idle_share_is_one_minus_the_union_of_intervals():
    s = summary([(10, 30, "a"), (20, 40, "b"), (60, 70, "c"),
                 (95, 120, "d")])
    # union inside [0, 100): 10..40, 60..70, 95..100 = 45
    assert trace.busy_ns(s) == 45
    idle = metric("device_idle").read(SimpleNamespace(trace=s))
    assert idle == pytest.approx(55.0)
    assert trace.idle_gaps(s) == [(0, 10), (40, 60), (70, 95)]


def test_breakdown_names_gaps_by_the_outermost_host_op():
    s = summary([(10, 30, "k1"), (50, 60, "k2"), (70, 100, "k1")],
                host=[(30, 50, "aten::sort")])
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k1", 50e-9]
    assert dict(map(tuple, b["idle_gaps"])) == {
        "(python)": 20e-9, "aten::sort": 20e-9}


def test_roofline_bytes_and_share():
    roof = metric("closest_hit_roofline")
    assert roof.needed_bytes(1000, 2, 3, 4) == 1000 * 36 + 2 * (
        3 * 16 + 4 * 36)
    # two query calls: a march kernel and a gemm with its epilogue (the
    # epilogue overlapping the gemm by 0.5 ms), 2.5 ms in all; another
    # kernel outside the queries does not count
    query = [(0, 1_000_000, "cluster_march_kernel(float*)"),
             (2_000_000, 3_000_000, "sm90_xmma_gemm_f32f32"),
             (2_500_000, 3_500_000, "elementwise_kernel")]
    s = summary(query + [(4_000_000, 9_000_000, "elementwise_kernel")],
                window=(0, 10_000_000))
    s = s._replace(query_device=sorted(query), query_calls=2)
    run = SimpleNamespace(trace=s, window=SimpleNamespace(
        stats=[1e6, 0.0, 0.0]), spheres=3, triangles=4)
    need = 1e6 * 36 + 2 * (3 * 16 + 4 * 36)
    assert roof.read(run) == pytest.approx(100 * need / 3.35e12 / 2.5e-3)
    s_none = summary([(0, 5, "elementwise_kernel")])
    assert roof.read(SimpleNamespace(trace=s_none, window=run.window,
                                     spheres=3, triangles=4)) is None


def test_roofline_counts_shadow_rays_as_ray_bytes():
    roof = metric("closest_hit_roofline")
    # no shadow ray: the bytes and the share of the closest-hit rays alone
    assert roof.needed_bytes(1000, 2, 3, 4, 0.0) == roof.needed_bytes(
        1000, 2, 3, 4)
    assert roof.needed_bytes(1000, 2, 3, 4, 250) == 1250 * 36 + 2 * (
        3 * 16 + 4 * 36)
    query = [(0, 2_000_000, "elementwise_kernel")]
    s = summary(query, window=(0, 10_000_000))._replace(
        query_device=query, query_calls=4)

    def read(stats):
        return roof.read(SimpleNamespace(
            trace=s, window=SimpleNamespace(stats=stats), spheres=3,
            triangles=4))
    scene = 4 * (3 * 16 + 4 * 36)
    assert read([1e6, 0.0, 0.0]) == 100 * (1e6 * 36 + scene) / 3.35e12 / 2e-3
    assert read([1e6, 5e5, 0.0]) == pytest.approx(
        100 * (1.5e6 * 36 + scene) / 3.35e12 / 2e-3)


def test_sync_and_launch_counts_per_msample():
    runtime = {"cudaLaunchKernel": 90, "cuLaunchKernel": 10,
               "cudaStreamSynchronize": 7, "cudaDeviceSynchronize": 3,
               "cudaMemcpyAsync": 5}
    run = SimpleNamespace(trace=summary([], runtime=runtime),
                          window=SimpleNamespace(samples=2_000_000),
                          harness_syncs=3)
    assert metric("launches_per_msample").read(run) == 50.0
    assert metric("syncs_per_msample").read(run) == 3.5


class Event:
    def __init__(self, name, dev, start, dur, corr=0):
        self._v = (name, dev, start, dur, corr)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]


CPU, CUDA = "DeviceType.CPU", "DeviceType.CUDA"


def test_reduce_events_keeps_the_window_and_the_outermost_host_ops():
    events = [Event(trace.WINDOW_SPAN, CPU, 100, 100),
              Event(trace.WINDOW_SPAN, CUDA, 100, 100),
              Event("aten::add", CPU, 110, 20),
              Event("aten::empty", CPU, 112, 2),
              Event("cudaLaunchKernel", CPU, 120, 5),
              Event("aten::mul", CPU, 140, 10),
              Event("kernel", CUDA, 125, 10),
              Event("early kernel", CUDA, 10, 10),
              Event("aten::before", CPU, 50, 10)]
    s = trace.reduce_events(events, 1.0)
    assert s.window_ns == (100, 200)
    assert s.device == [(125, 135, "kernel")]
    assert s.runtime == {"cudaLaunchKernel": 1}
    assert [h[2] for h in s.host_ops] == ["aten::add", "aten::mul"]
    assert s.query_device == [] and s.query_calls == 0


def test_reduce_events_gives_a_query_the_work_its_launches_correlate():
    # two query spans; kernels 7 and 8 are launched inside them, kernel 9
    # between them, and kernel 8 runs after its span has closed
    events = [Event(trace.WINDOW_SPAN, CPU, 0, 1000),
              Event(trace.QUERY_SPAN, CPU, 100, 100),
              Event(trace.QUERY_SPAN, CUDA, 150, 100),
              Event("cudaLaunchKernel", CPU, 110, 5, corr=7),
              Event("cudaMemcpyAsync", CPU, 150, 5, corr=8),
              Event("cudaLaunchKernel", CPU, 250, 5, corr=9),
              Event(trace.QUERY_SPAN, CPU, 300, 50),
              Event("cudaLaunchKernelExC", CPU, 310, 5, corr=10),
              Event("march", CUDA, 120, 30, corr=7),
              Event("Memcpy DtoH", CUDA, 230, 10, corr=8),
              Event("mul", CUDA, 260, 20, corr=9),
              Event("gemm", CUDA, 320, 40, corr=10)]
    s = trace.reduce_events(events, 1.0)
    assert s.query_calls == 2
    assert s.query_device == [(120, 150, "march"),
                              (230, 240, "Memcpy DtoH"),
                              (320, 360, "gemm")]
    assert [d[2] for d in s.device] == ["march", "Memcpy DtoH", "mul",
                                        "gemm"]


def test_span_queries_wraps_both_query_entries():
    from pathtracer_tpu_torch.render.renderer import Query
    scene, other = object(), object()

    def closest(o, d):
        return ("closest", o, d)
    closest.handles_dead = True
    closest.query_sorted = lambda o, d, alive, extras: ("sorted", o)

    class Renderer:
        def prepare(self, s):
            return Query(closest, s)
    r = Renderer()
    trace.span_queries(r, scene)
    q = r.prepare(scene)
    assert q.scene is scene and q.closest is not closest
    assert q.closest.handles_dead
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        assert q.closest(1, 2) == ("closest", 1, 2)
        assert q.closest.query_sorted(3, 4, None, ()) == ("sorted", 3)
    names = [e.name for e in prof.events()]
    assert names.count(trace.QUERY_SPAN) == 2
    assert r.prepare(other).closest is closest


def test_off_share_counts_channels_past_off_at_and_judge_skips_settings():
    from perfbench import compare
    # four samples: shown values sqrt(fb / 4) are 1 and 0.5; the
    # reference's 1.21 shows 0.55, one channel of six 0.05 off
    fb = torch.tensor([[4.0, 4.0, 4.0], [1.0, 1.0, 1.0]])
    ref = fb.clone()
    ref[1, 0] = 1.21
    taken = [(1, 4, fb, None)]
    n = compare.numbers(taken, [ref], off_at=0.01)
    assert n["off_share"] == pytest.approx(1 / 6)
    assert n["mean_abs_diff"] == pytest.approx(0.05 / 6)
    assert n["rel_sum_diff"] == pytest.approx(0.21 / 15.21)
    assert "off_share" not in compare.numbers(taken, [ref])
    ok, checks = compare.judge(n, {"pixels": 2, "off_at": 0.01,
                                   "off_share": 0.2, "mean_abs_diff": 0.01})
    assert ok and set(checks) == {"off_share", "mean_abs_diff"}
    assert not compare.judge(n, {"off_share": 0.1})[0]
    assert not compare.judge({}, {"off_share": 0.1})[0]
