"""Host time of the two-level cull's preparation, in ms: the mean duration
of the program's ``pt.cull2`` spans that start in the traced window
(``ops/cluster_sweep.march_inputs`` where it runs the preparation as
torch ops, ``march_inputs_reference``, on a cull plan that the
preparation kernels do not take: the cull against superclusters, the
binning sort, each chunk's interval cull and cluster order, the gates
and the residual sweep), each inside a march query's ``pt.cull``.
Nothing is read where the program keeps no ``pt.cull2`` span: the flat
plan, another route, or a program older than the span."""

from perfbench import spans

CULL2 = "pt.cull2"


def read(run):
    culls = spans.of(run, CULL2)
    culls = culls and spans.starting_in(run, culls)
    if not culls:
        return None
    return spans.length(culls) / len(culls) / 1e6
