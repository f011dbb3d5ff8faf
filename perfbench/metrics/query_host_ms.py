"""Host time of a closest-hit or shadow query, in ms: the mean duration of
the program's ``pt.query`` spans that start in the traced window (each
query at its call site in the integrator, ``perfbench/spans.py``). On
the march route nearly all of it is ``march_inputs``'s cull and sorts."""

from perfbench import spans


def read(run):
    queries = spans.of(run, spans.QUERY)
    queries = queries and spans.starting_in(run, queries)
    if not queries:
        return None
    return spans.length(queries) / len(queries) / 1e6
