"""mvs_fuse_ms.view: synchronized host-clock ms of MVS pass 2
(``mvs._fuse_batch``: consistency, fusion, back-projection) per reference
view, over the window's calls before the profiled stretch."""


def read(data):
    s, views = data.spans.get("mvs_fuse", []), data.counts.get("views", 0)
    return 1e3 * sum(s) / views if s and views else None
