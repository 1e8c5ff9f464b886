"""finalize_ms.pass: host ms of ``IncrementalSfM.finalize`` a pass less its
full view graph: the port's ``finalize`` span less its ``loop_close`` span
but for the injections inside it (``loop_close.inject``), over the
finalize calls that ended before the profiled stretch."""

from portbench.program import get


def read(data):
    spans = get(data.program, "before", "spans") or {}
    fin, loop = spans.get("finalize"), spans.get("loop_close")
    if not fin or not fin["calls"]:
        return None
    graph_ms = 0.0
    if loop:
        graph_ms = loop["ms"] - (spans.get("loop_close.inject") or {}).get("ms", 0.0)
    return (fin["ms"] - graph_ms) / fin["calls"]
