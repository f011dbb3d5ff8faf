"""The traced window: a ``torch.profiler`` capture of a few passes, reduced
in memory to what the per-layer metrics read. No trace file is written.

:func:`span_queries` puts each closest-hit and shadow query of a
renderer's cached route under a ``perfbench.query`` span (the harness's
wrapper; the program is not changed). :class:`Capture` starts the
profiler and a ``perfbench.window`` span; :meth:`Capture.stop`
synchronises, closes both and keeps a :class:`Summary`:

- ``device``: every device interval (kernel, copy, set) in the window,
  as (start_ns, end_ns, name), sorted;
- ``runtime``: counts of the host's CUDA runtime and driver calls in the
  window, by name;
- ``host_ops``: the outermost host operations (``aten::`` and other
  annotated spans) as (start_ns, end_ns, name), sorted;
- ``window_ns``: the span's (start, end) on the trace's clock, and
  ``window_s``: its length on the host clock;
- ``query_device``: the device intervals of the closest-hit and shadow
  queries, those that the profiler correlates with a runtime call made
  inside a query span, as (start_ns, end_ns, name), sorted;
  ``query_calls``: the query spans that start in the window.
"""
from __future__ import annotations

import bisect
import time
from typing import List, NamedTuple, Tuple

WINDOW_SPAN = "perfbench.window"
QUERY_SPAN = "perfbench.query"
# the harness's spans, which the profiler mirrors on the device's
# timeline: not work
SPANS = frozenset({WINDOW_SPAN, QUERY_SPAN})

# host calls that wait for the device
SYNC_CALLS = frozenset({
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize", "cuMemcpyDtoH", "cuMemcpyDtoH_v2"})


class Summary(NamedTuple):
    device: List[Tuple[int, int, str]]
    runtime: dict
    host_ops: List[Tuple[int, int, str]]
    window_ns: Tuple[int, int]
    window_s: float
    query_device: Tuple[Tuple[int, int, str], ...] = ()
    query_calls: int = 0


def is_runtime_call(name: str) -> bool:
    """A CUDA runtime (``cuda...``) or driver (``cu...``) API call."""
    return (name.startswith("cuda") and name[4:5].isupper()) or (
        name.startswith("cu") and name[2:3].isupper())


def launches(runtime: dict) -> int:
    return sum(n for name, n in runtime.items() if "LaunchKernel" in name)


def syncs(runtime: dict) -> int:
    return sum(n for name, n in runtime.items() if name in SYNC_CALLS)


def union(intervals) -> List[Tuple[int, int]]:
    """Merged (start, end) of intervals sorted by start."""
    merged: List[Tuple[int, int]] = []
    for start, end, *_ in intervals:
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def busy_ns(summary: Summary) -> int:
    lo, hi = summary.window_ns
    return sum(min(e, hi) - max(s, lo) for s, e in union(summary.device)
               if e > lo and s < hi)


def idle_gaps(summary: Summary) -> List[Tuple[int, int]]:
    """The window's stretches with no device interval."""
    lo, hi = summary.window_ns
    gaps, at = [], lo
    for s, e in union(summary.device):
        if s > at:
            gaps.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        gaps.append((at, hi))
    return [(s, e) for s, e in gaps if e > s]


def host_op_at(summary: Summary, starts, t: int) -> str:
    """The outermost host operation running at ``t`` (``starts``: the
    host operations' starts), or ``(python)``."""
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and summary.host_ops[i][1] > t:
        return summary.host_ops[i][2]
    return "(python)"


def top(pairs, n: int = 10):
    """The ``n`` largest (name, total seconds) of (name, ns) pairs."""
    totals: dict = {}
    for name, ns in pairs:
        totals[name] = totals.get(name, 0) + ns
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name, ns / 1e9] for name, ns in ranked]


def breakdown(summary: Summary) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing (each gap named by the outermost host
    operation at its middle)."""
    lo, hi = summary.window_ns
    ops = ((name, min(e, hi) - max(s, lo)) for s, e, name in summary.device
           if e > lo and s < hi)
    starts = [s for s, _, _ in summary.host_ops]
    gaps = ((host_op_at(summary, starts, (s + e) // 2), e - s)
            for s, e in idle_gaps(summary))
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}


def _inside(spans, starts, t: int) -> bool:
    """Whether ``t`` lies in one of ``spans`` (sorted, not overlapping;
    ``starts`` their starts)."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and spans[i][1] > t


def reduce_events(events, window_s: float) -> Summary:
    """:class:`Summary` of a profile's kineto events."""
    window = None
    device, host, calls, queries = [], [], [], []
    for e in events:
        name = e.name()
        start = e.start_ns()
        end = start + e.duration_ns()
        on_device = "CUDA" in str(e.device_type())
        if name in SPANS:
            if on_device:
                continue
            if name == WINDOW_SPAN:
                window = (start, end)
            else:
                queries.append((start, end))
        elif on_device:
            device.append((start, end, name, e.correlation_id()))
        elif is_runtime_call(name):
            calls.append((start, name, e.correlation_id()))
        else:
            host.append((start, end, name))
    if window is None:
        raise RuntimeError(f"the profile has no {WINDOW_SPAN} span")
    lo, hi = window
    queries.sort()
    query_starts = [s for s, _ in queries]
    runtime: dict = {}
    in_query = set()
    for start, name, corr in calls:
        if lo <= start < hi:
            runtime[name] = runtime.get(name, 0) + 1
        if corr and _inside(queries, query_starts, start):
            in_query.add(corr)
    device.sort()
    host.sort(key=lambda x: (x[0], -x[1]))
    outer, reach = [], None
    for s, e, name in host:
        if s < lo or s >= hi:
            continue
        if reach is None or s >= reach:
            outer.append((s, e, name))
            reach = e
    kept = [d for d in device if d[1] > lo and d[0] < hi]
    return Summary(device=[d[:3] for d in kept], runtime=runtime,
                   host_ops=outer, window_ns=window, window_s=window_s,
                   query_device=[d[:3] for d in kept if d[3] in in_query],
                   query_calls=sum(lo <= s < hi for s in query_starts))


def span_queries(renderer, scene) -> None:
    """Put each query of ``renderer``'s route for ``scene`` under a
    :data:`QUERY_SPAN` span: its ``closest``, NEE's ``closest.query_shadow``
    and, on the march route, ``closest.query_sorted``."""
    query = renderer.prepare(scene)
    closest = _spanned(query.closest)
    for name in ("query_sorted", "query_shadow"):
        if hasattr(closest, name):
            setattr(closest, name, _spanned(getattr(closest, name)))
    spanned = query._replace(closest=closest)
    prepare = renderer.prepare
    renderer.prepare = lambda s: spanned if s is scene else prepare(s)


def _spanned(fn):
    """``fn`` under a :data:`QUERY_SPAN` span, with its attributes."""
    import torch

    def call(*args, **kw):
        with torch.profiler.record_function(QUERY_SPAN):
            return fn(*args, **kw)
    call.__dict__.update(fn.__dict__)
    return call


class Capture:
    """A profiled window: ``start()``, the work, ``stop()``; then
    ``summary``. ``syncs`` counts the synchronisations the harness itself
    makes inside the window (:meth:`sync`), which the sync metric leaves
    out."""

    def __init__(self):
        self.summary = None
        self.syncs = 0
        self._prof = self._span = None
        self._t0 = 0.0
        self.reduce_s = (0.0, 0.0)

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        self._t0 = time.perf_counter()

    def sync(self):
        import torch
        torch.cuda.synchronize()
        self.syncs += 1

    def stop(self):
        self.sync()
        window_s = time.perf_counter() - self._t0
        self._span.__exit__(None, None, None)
        t = time.perf_counter()
        self._prof.__exit__(None, None, None)
        events = self._prof.profiler.kineto_results.events()
        t_exit = time.perf_counter() - t
        self.summary = reduce_events(events, window_s)
        self.reduce_s = (t_exit, time.perf_counter() - t - t_exit)
        self._prof = self._span = None
