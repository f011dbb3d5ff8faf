"""Host time of an NEE bounce's shading, in ms: the mean over the
``pt.bounce`` spans that start in the traced window and hold a
``pt.light`` span of each one's duration less the union of the
``pt.query``, ``pt.wait`` and ``pt.light`` spans inside it
(``perfbench/light_spans.py``): the hit record, scatter, absorption and
advance (``ops/shade``'s parts as torch ops) and the bounce's draws, which
the shading kernel does in one launch where there is no NEE."""

from perfbench import light_spans, spans


def read(run):
    kept = light_spans.of(run)
    if kept is None:
        return None
    bounces = spans.starting_in(run, light_spans.holding(
        light_spans.named(kept, spans.BOUNCE), kept.lights))
    if not bounces:
        return None
    children = light_spans.named(kept, spans.QUERY, spans.WAIT,
                                 light_spans.LIGHT)
    starts = [x[0] for x in children]
    total = sum(spans.self_ns(b, children, starts) for b in bounces)
    return total / len(bounces) / 1e6
