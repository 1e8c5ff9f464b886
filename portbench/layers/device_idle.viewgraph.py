"""device_idle.viewgraph: 100 * (1 - device busy / wall) over the profiled
stretch inside finalize's full view graph: busy is the union of the
intervals of every kernel and copy in the torch.profiler trace."""


def read(data):
    if not data.window_s > 0.0 or not data.busy_s > 0.0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)
