"""The shadow queries' share of their roofline, in %: the least time the
traced window's shadow queries need on an H100, over their device time.

Least time: ``closest_hit_roofline.needed_bytes`` of the shadow rays
executed (the renderer's stats), 36 bytes each, and the scene's
primitives read once a shadow query, over the HBM peak.

Device time: every kernel, copy and set that the profiler correlates
with a launch inside a query call (``perfbench.trace.span_queries``'s
``query_device``) and that belongs to a shadow query, the program's
``pt.query`` spans inside a ``pt.light`` span
(``perfbench/light_spans.py``). The work goes down one stream, so a
query call's device intervals follow one another with no interval of
other work between them: the ``query_device`` intervals fall, in stream
order, into one run a call, and the k-th run is the work of the k-th
``pt.query`` span in the window. Whatever route or kernel answers the
query, the same work is read. Nothing is read without ``pt.light`` spans
(no NEE, or a program that keeps none), where no shadow query ran on the
device, and where the runs and the query spans do not pair off one to
one.
"""

from perfbench import light_spans, spans, trace
from perfbench.metrics.closest_hit_roofline import needed_bytes
from perfbench.peaks import PEAK_BYTES


def query_runs(summary):
    """The ``query_device`` intervals in stream order, split into runs at
    every device interval of other work."""
    mine = set(summary.query_device)
    runs, current = [], []
    for interval in summary.device:
        if tuple(interval) in mine:
            current.append(interval)
        elif current:
            runs.append(current)
            current = []
    if current:
        runs.append(current)
    return runs


def read(run):
    kept = light_spans.of(run)
    if kept is None:
        return None
    queries = spans.starting_in(run, light_spans.named(kept, spans.QUERY))
    shadows = set(spans.starting_in(run, light_spans.shadows(kept)))
    runs = query_runs(run.trace)
    if not shadows or len(runs) != len(queries):
        return None
    work = sorted(x for q, r in zip(queries, runs) if q in shadows
                  for x in r)
    lo, hi = run.trace.window_ns
    busy = sum(min(e, hi) - max(s, lo) for s, e in trace.union(work)
               if e > lo and s < hi) / 1e9
    if busy <= 0:
        return None
    need = needed_bytes(0.0, len(shadows), run.spheres, run.triangles,
                        run.window.stats[1])
    return 100.0 * need / PEAK_BYTES / busy
