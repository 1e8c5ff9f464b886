"""viewgraph_launches.pair: CUDA launches a view-graph pair in the profiled
stretch (which runs inside finalize's full view graph): launches inside
the port's ``viewgraph`` span over the pairs begun there (its
``viewgraph.match`` spans)."""

from portbench.program import get, launches_in, ratio


def read(data):
    p = data.program
    return ratio(launches_in(p, "viewgraph"), get(p, "stretch", "spans", "viewgraph.match", "calls"))
