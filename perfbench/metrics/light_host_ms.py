"""Host time of a bounce's next-event estimation outside its shadow query,
in ms: the ``pt.light`` spans that start in the traced window, each less
the ``pt.query`` spans inside it, summed and divided by the number of
``pt.bounce`` spans that hold them (``perfbench/light_spans.py``): the
light draw, the light sample's arithmetic, the direct-lighting sum, the
pdf bookkeeping and the emitter hit's weight that the host dispatches a
bounce under NEE."""

from perfbench import light_spans, spans


def read(run):
    kept = light_spans.of(run)
    if kept is None:
        return None
    lights = spans.starting_in(run, kept.lights)
    bounces = light_spans.holding(light_spans.named(kept, spans.BOUNCE),
                                  lights)
    if not bounces:
        return None
    queries = light_spans.shadows(kept)
    starts = [q[0] for q in queries]
    total = sum(spans.self_ns(x, queries, starts) for x in lights)
    return total / len(bounces) / 1e6
