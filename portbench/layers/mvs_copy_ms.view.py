"""mvs_copy_ms.view: host ms a reference view in the copy of the dense
cloud to the host (the port's ``mvs.copy`` span, which waits for pass 2
on the device), over the window before the profiled stretch."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "before", "spans", "mvs.copy", "ms"),
                 get(p, "before", "counters", "mvs.views"))
