"""register_ms.frame: mean synchronized host-clock ms of one
``register_frame`` call (match, PnP-RANSAC, triangulation, appends), over
the window's frames before the profiled stretch."""


def read(data):
    s = data.spans.get("register", [])
    return 1e3 * sum(s) / len(s) if s else None
