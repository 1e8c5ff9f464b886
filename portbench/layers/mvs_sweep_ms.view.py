"""mvs_sweep_ms.view: synchronized host-clock ms of MVS pass 1
(``mvs._depth_ranges`` and ``mvs._plane_sweep_batch``) per reference view,
over the window's calls before the profiled stretch."""


def read(data):
    s, views = data.spans.get("mvs_sweep", []), data.counts.get("views", 0)
    return 1e3 * sum(s) / views if s and views else None
