"""viewgraph_useful_share: the share of view-graph pairs that find an
overlap, in %: 100 x the port's ``viewgraph.useful_pairs`` counter (pairs
with at least 30 E-inliers, a loop-closure pair's floor) over its
``viewgraph.pairs``, over the whole graphs that ended before the profiled
stretch (the stretch cuts its own graph short)."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "before", "counters", "viewgraph.useful_pairs"),
                 get(p, "before", "counters", "viewgraph.pairs"), 100.0)
