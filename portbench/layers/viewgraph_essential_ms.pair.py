"""viewgraph_essential_ms.pair: host ms a view-graph pair in E-RANSAC (the
self time of the port's ``viewgraph.essential`` span: the normalization
and ``ransac_essential``), over the window before the profiled stretch."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "before", "spans", "viewgraph.essential", "self_ms"),
                 get(p, "before", "spans", "viewgraph.essential", "calls"))
