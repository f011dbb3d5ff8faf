"""Share of the traced window, in %, in which the host was inside a
closest-hit or shadow query (the union of the program's ``pt.query``
spans) and no kernel, copy or set ran on the device: the part of
``device_idle`` that falls inside queries, on the profiler's one clock
(``perfbench/spans.py``)."""

from perfbench import spans, trace


def read(run):
    queries = spans.of(run, spans.QUERY)
    if not queries:
        return None
    lo, hi = run.trace.window_ns
    inside = spans.clipped_union(queries, lo, hi)
    idle = spans.overlap_ns(inside, trace.idle_gaps(run.trace))
    return 100.0 * idle / (hi - lo)
