"""viewgraph_ms.pair: host ms a view-graph pair, on the harness's
synchronized host clock around ``exhaustive.build_view_graph`` (both
graphs of a pass: the windowed one of the auto bootstrap and finalize's
full one), over the graphs' pairs, in the window before the profiled
stretch."""


def read(data):
    seconds = data.spans.get("viewgraph") or []
    pairs = data.counts.get("viewgraph_pairs") or []
    if not seconds or not sum(pairs):
        return None
    return 1e3 * sum(seconds) / sum(pairs)
