"""Host time of a shadow query, in ms: the mean duration of the program's
``pt.query`` spans that start in the traced window and lie inside a
``pt.light`` span (``perfbench/light_spans.py``), each route's
``query_shadow`` at its call site in ``render/lights.py``."""

from perfbench import light_spans, spans


def read(run):
    kept = light_spans.of(run)
    if kept is None:
        return None
    queries = spans.starting_in(run, light_spans.shadows(kept))
    if not queries:
        return None
    return spans.length(queries) / len(queries) / 1e6
