"""Host time of a bounce outside its queries and waits, in ms: the mean
over the program's ``pt.bounce`` spans that start in the traced window
of each one's duration less the union of the ``pt.query`` and
``pt.wait`` spans inside it (``perfbench/spans.py``): the shading,
draws and state update that the host dispatches a bounce."""

from perfbench import spans


def read(run):
    if run.trace is None:
        return None
    kept = spans.program_spans()
    if kept is None:
        return None
    bounces = spans.starting_in(
        run, [x for x in kept if x[2] == spans.BOUNCE])
    if not bounces:
        return None
    children = [x for x in kept if x[2] in (spans.QUERY, spans.WAIT)]
    starts = [x[0] for x in children]
    total = sum(spans.self_ns(b, children, starts) for b in bounces)
    return total / len(bounces) / 1e6
