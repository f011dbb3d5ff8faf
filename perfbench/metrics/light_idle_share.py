"""Share of the traced window, in %, in which the host was inside a
bounce's next-event estimation but not in its shadow query (the union of
the program's ``pt.light`` spans less that of the ``pt.query`` spans
inside them) and no kernel, copy or set ran on the device: the card
waiting on NEE's host work (``perfbench/light_spans.py``)."""

from perfbench import light_spans, spans, trace


def read(run):
    kept = light_spans.of(run)
    if kept is None:
        return None
    lo, hi = run.trace.window_ns
    gaps = trace.idle_gaps(run.trace)
    lights = spans.clipped_union(kept.lights, lo, hi)
    shadows = spans.clipped_union(light_spans.shadows(kept), lo, hi)
    idle = spans.overlap_ns(lights, gaps) - spans.overlap_ns(shadows, gaps)
    return 100.0 * idle / (hi - lo)
