"""detect_ms.frame: mean synchronized host-clock ms of one
``sift.detect_and_compute`` call (one frame), over the window's frames
before the profiled stretch."""


def read(data):
    s = data.spans.get("detect", [])
    return 1e3 * sum(s) / len(s) if s else None
