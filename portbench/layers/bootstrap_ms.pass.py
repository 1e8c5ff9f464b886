"""bootstrap_ms.pass: the mean latency of a pass's bootstrap frame in the
window before the profiled stretch (detection of frames 0 and 1 and
``init_from_bootstrap``, staged frames to the two-view map, synchronized),
on the host clock. One frame in
a pass is a bootstrap, so its latency weighs on ``frames_per_s`` and is
left out of ``frame_ms_p95``."""


def read(data):
    ms = data.counts.get("bootstrap_ms") or []
    if not ms:
        return None
    return sum(ms) / len(ms)
