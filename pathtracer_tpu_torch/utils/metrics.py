"""Timing and throughput instrumentation (``utils/metrics.py``).

- :class:`PhaseTimer`: named wall-clock phases (scene build, table build,
  render, readback) with a report table;
- :func:`mrays_per_s`: the nominal throughput, pixels x spp x depth
  closest-hit queries per wall-second;
- :func:`trace_context`: a ``torch.profiler`` scope that writes a Chrome
  trace (the reference's is a ``jax.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional

TRACE_FILE = "trace.json"


class PhaseTimer:
    """Accumulating named wall-clock phases.

    >>> t = PhaseTimer()
    >>> with t.phase("render"): ...
    >>> t.report()
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = ["phase                 total_s   calls    mean_s"]
        for name, total in sorted(self.totals.items(),
                                  key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<20} {total:>8.4f} {n:>7} "
                         f"{total / n:>9.5f}")
        return "\n".join(lines)


def mrays_per_s(num_pixels: int, spp: int, max_depth: int,
                seconds: float) -> float:
    """Closest-hit queries per wall-second, in millions, of the nominal
    workload (pixels x spp x depth). Paths end early, so fewer queries
    execute: this is an upper bound on the achieved per-query rate, for
    comparing workloads; the executed count is ``render_sum``'s."""
    if seconds <= 0:
        return float("inf")
    return num_pixels * spp * max_depth / seconds / 1e6


@contextlib.contextmanager
def trace_context(log_dir: Optional[str]) -> Iterator[None]:
    """A ``torch.profiler`` scope (host activity, and the card's where
    there is one) when ``log_dir`` is set, writing the Chrome trace
    ``log_dir/trace.json`` on exit; a no-op otherwise. Synchronise inside
    the scope, so the card's work falls in it:

        with trace_context("out/trace"):
            img = render(scene, cam).cpu()
    """
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
