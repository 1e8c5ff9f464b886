"""detect_launches.frame: CUDA launches a frame in detection, in the
profiled stretch: launches inside the port's ``detect`` spans over the
frames its ``detect.frames`` counter counted there."""

from portbench.program import get, launches_in, ratio


def read(data):
    p = data.program
    return ratio(launches_in(p, "detect"), get(p, "stretch", "counters", "detect.frames"))
