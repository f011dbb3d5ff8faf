"""Host time of the cluster march's work before its launch, in ms: the
mean duration of the program's ``pt.cull`` spans that start in the traced
window (``ops/cluster_sweep.cluster_march`` around ``march_inputs``: the
cull, the binning sort, each chunk's cluster order, the gate and the
residual sweep), each inside the ``pt.query`` of a closest-hit, sorted or
shadow query. Nothing is read where the program keeps no ``pt.cull``
span: another route, or a program older than the span."""

from perfbench import spans

CULL = "pt.cull"


def read(run):
    culls = spans.of(run, CULL)
    culls = culls and spans.starting_in(run, culls)
    if not culls:
        return None
    return spans.length(culls) / len(culls) / 1e6
