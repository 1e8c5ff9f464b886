"""mvs_sweep_launches.view: CUDA launches a reference view in MVS pass 1,
in the profiled stretch: launches inside the port's ``mvs.ranges`` and
``mvs.sweep`` spans over the views its ``mvs.views`` counter counted
there."""

from portbench.program import get, launches_in, ratio


def read(data):
    p = data.program
    return ratio(launches_in(p, "mvs.ranges", "mvs.sweep"),
                 get(p, "stretch", "counters", "mvs.views"))
