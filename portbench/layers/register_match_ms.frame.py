"""register_match_ms.frame: host ms a ``register_frame`` call in its
matching (the port's ``register.match`` span, K1 included), over the
window before the profiled stretch."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "before", "spans", "register.match", "ms"),
                 get(p, "before", "spans", "register", "calls"))
