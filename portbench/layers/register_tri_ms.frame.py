"""register_tri_ms.frame: host ms a ``register_frame`` call in
triangulation (the self time of the port's ``register.triangulate``
span), over the window before the profiled stretch."""

from portbench.program import get, ratio


def read(data):
    p = data.program
    return ratio(get(p, "before", "spans", "register.triangulate", "self_ms"),
                 get(p, "before", "spans", "register", "calls"))
