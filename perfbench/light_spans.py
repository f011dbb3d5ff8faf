"""The program's ``pt.light`` spans in the traced window: a bounce's
next-event-estimation work (the light draw, the shadow ``pt.query``, the
direct-lighting sum, the next bounce's pdf, and the balance-heuristic
weight of a BSDF-sampled emitter hit), two a bounce under NEE
(``render/integrator.py``), nested in the ``pt.bounce`` span and holding
the shadow query.

:func:`of` gives a run's spans where the window holds a ``pt.light``
span, and ``None`` otherwise: without a trace, where the program keeps no
spans, and where it keeps no ``pt.light`` (a render without NEE, or a
program older than the span); each reader of these spans gives ``None``
then.
"""
from __future__ import annotations

import bisect
from typing import List, NamedTuple, Optional, Tuple

from perfbench import spans

LIGHT = "pt.light"

Span = Tuple[int, int, str]


class Kept(NamedTuple):
    every: List[Span]      # every span the program kept, sorted by start
    lights: List[Span]     # the pt.light spans that overlap the window


def of(run) -> Optional[Kept]:
    lights = spans.of(run, LIGHT)
    if not lights:
        return None
    return Kept(spans.program_spans(), lights)


def named(kept: Kept, *names) -> List[Span]:
    return [x for x in kept.every if x[2] in names]


def inside(children, parents) -> List[Span]:
    """Those of ``children`` that lie inside one of ``parents`` (sorted by
    start, disjoint)."""
    starts = [p[0] for p in parents]
    out = []
    for c in children:
        i = bisect.bisect_right(starts, c[0]) - 1
        if i >= 0 and c[1] <= parents[i][1]:
            out.append(c)
    return out


def holding(parents, children) -> List[Span]:
    """Those of ``parents`` that hold one of ``children`` (sorted by
    start)."""
    starts = [c[0] for c in children]
    out = []
    for p in parents:
        i = bisect.bisect_left(starts, p[0])
        if i < len(children) and children[i][1] <= p[1]:
            out.append(p)
    return out


def shadows(kept: Kept) -> List[Span]:
    """The ``pt.query`` spans inside a ``pt.light`` span: the shadow
    queries."""
    return inside(named(kept, spans.QUERY), kept.lights)
