"""The program's own spans in the traced window.

While a profiler records, the program keeps each span it closes
(``pathtracer_tpu_torch.utils.metrics.span``: ``pt.pass``, ``pt.bounce``,
``pt.query``, ``pt.wait``) in ``metrics.SPANS`` as (start_ns, end_ns,
name, args), on the profiler's clock: the clock of the window and of the
device intervals in :class:`perfbench.trace.Summary`. The spans stay out
of the profile itself, so they change no field of the summary.

:func:`of` gives a run's spans of one name; a program that keeps no
spans gives ``None``, and so does each reader that reads them.
"""
from __future__ import annotations

import bisect
from typing import List, Optional, Tuple

from perfbench import trace

BOUNCE, QUERY, WAIT = "pt.bounce", "pt.query", "pt.wait"


def program_spans() -> Optional[list]:
    """Every span the program kept, as (start_ns, end_ns, name) sorted by
    start; ``None`` where the program keeps none."""
    from pathtracer_tpu_torch.utils import metrics
    kept = getattr(metrics, "SPANS", None)
    if kept is None:
        return None
    return sorted((s, e, name) for s, e, name, _ in list(kept))


def of(run, *names) -> Optional[List[Tuple[int, int, str]]]:
    """The spans named one of ``names`` that overlap the run's traced
    window, sorted by start, unclipped; ``None`` without a trace or
    without program spans."""
    if run.trace is None:
        return None
    kept = program_spans()
    if kept is None:
        return None
    lo, hi = run.trace.window_ns
    return [x for x in kept if x[2] in names and x[1] > lo and x[0] < hi]


def starting_in(run, spans):
    """Those of ``spans`` that start in the run's window."""
    lo, hi = run.trace.window_ns
    return [x for x in spans if lo <= x[0] < hi]


def clipped_union(spans, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The union of ``spans`` (sorted by start) inside [lo, hi)."""
    return [(max(s, lo), min(e, hi)) for s, e in trace.union(spans)
            if e > lo and s < hi]


def length(intervals) -> int:
    return sum(e - s for s, e, *_ in intervals)


def overlap_ns(a, b) -> int:
    """The time that two lists of sorted, disjoint intervals share."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            total += e - s
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def self_ns(parent, children, child_starts) -> int:
    """``parent``'s duration less the union of the ``children`` (sorted by
    start; ``child_starts`` their starts) that lie inside it."""
    s, e = parent[0], parent[1]
    inside = [c for c in children[bisect.bisect_left(child_starts, s):
                                  bisect.bisect_left(child_starts, e)]
              if c[1] <= e]
    return (e - s) - length(trace.union(inside))
