"""register_launches.frame: CUDA launches a ``register_frame`` call, in the
profiled stretch: launches inside the port's ``register`` spans over the
``register`` spans that started there."""

from portbench.program import get, launches_in, ratio


def read(data):
    p = data.program
    return ratio(launches_in(p, "register"), get(p, "stretch", "spans", "register", "calls"))
