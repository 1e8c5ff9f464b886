"""ba_ms.frame: mean ms of one per-frame ``bundle_adjust_map`` call
between CUDA events recorded before and after it, over the window's
frames before the profiled stretch."""


def read(data):
    s = data.counts.get("ba_events", [])
    return sum(s) / len(s) if s else None
