"""ba_launches.frame: CUDA launches a bundle adjustment call, in the
profiled stretch: launches inside the port's ``ba`` spans over the ``ba``
spans that started there."""

from portbench.program import get, launches_in, ratio


def read(data):
    p = data.program
    return ratio(launches_in(p, "ba"), get(p, "stretch", "spans", "ba", "calls"))
