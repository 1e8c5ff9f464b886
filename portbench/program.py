"""The program's own spans and counters beside a cell's device trace.

The port records spans and counters where its work happens (its tracer,
``sfm_mvs_tpu_torch/utils/profiling.py``: ``detect``, ``register.pnp``,
``ba.lm``, ``k1``, ``mvs.sweep``, ...). This module maps them onto a
torch.profiler trace through the tracer's clock anchor and attributes the
trace to them: each CUDA launch (``cudaLaunchKernel`` and its variants) by
its host start, and each device-idle gap by the time it began, to the
innermost program span open then.

In a --trace 1 run the harness turns the tracer on after warm-up
(``harness.window_start``) and off when the profiled stretch ends, and
puts :func:`program_data`'s result in ``TraceData.program``: host times
from the window before the stretch, launches and idle from the stretch,
counters from the whole window. The per-layer readers of the
``program_span`` and ``program_counter`` metrics (``layers/<metric>.py``)
read it with :func:`get`, :func:`ratio` and :func:`launches_in`.
"""

from __future__ import annotations

LAUNCH_NAMES = ("LaunchKernel", "LaunchCooperativeKernel")


def is_launch(name: str) -> bool:
    """A CUDA launch call on the host (runtime or driver API)."""
    return name.startswith("cu") and any(k in name for k in LAUNCH_NAMES)


def trace_events(prof, prefix: str):
    """(trace_start_ns, host launch starts (us), device intervals (start,
    end, name) (us), device kernels) of a finished torch.profiler run.
    Times are the trace's: us after ``trace_start_ns`` (Unix ns). Device
    intervals leave out the harness's mirrored ranges (names starting with
    `prefix`); kernels also leave out copies and sets."""
    from torch.autograd import DeviceType

    launches, device, kernels = [], [], 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(prefix):
                continue
            device.append((e.time_range.start, e.time_range.end, e.name))
            if not e.name.startswith(("Memcpy", "Memset")):
                kernels += 1
        elif is_launch(e.name):
            launches.append(e.time_range.start)
    return prof.profiler.kineto_results.trace_start_ns(), launches, device, kernels


def map_spans(exported: dict, trace_start_ns: int) -> list:
    """The tracer's spans on the trace's clock: (start_us, end_us) each,
    through the export's clock anchor (an open span ends at +inf)."""
    c = exported["clock"]
    off = c["unix_ns"] - c["perf_ns"] - trace_start_ns
    return [((r[1] + off) / 1e3, (r[2] + off) / 1e3 if r[2] else float("inf"))
            for r in exported["spans"]]


def idle_gaps(device: list) -> list:
    """(start, end) of each gap between the union of the device intervals."""
    gaps, end = [], None
    for s, e, _ in sorted(device):
        if end is not None and s > end:
            gaps.append((end, s))
        end = e if end is None else max(end, e)
    return gaps


def innermost(times_us: list, spans_us: list, parents: list) -> list:
    """For each time, the index of the innermost span open then
    (start <= t < end), or -1: one sweep over the span boundaries, which
    nest as the tracer recorded them."""
    depth = []
    for p in parents:
        depth.append(0 if p < 0 else depth[p] + 1)
    marks = []
    for i, (s, e) in enumerate(spans_us):
        if e > s:
            marks.append((s, 1, depth[i], i))
            marks.append((e, 0, -depth[i], i))
    marks.sort()
    order = sorted(range(len(times_us)), key=times_us.__getitem__)
    out = [-1] * len(times_us)
    stack, open_, m = [], set(), 0
    for q in order:
        t = times_us[q]
        while m < len(marks) and marks[m][0] <= t:
            _, kind, _, i = marks[m]
            if kind:
                stack.append(i)
                open_.add(i)
            elif i in open_:
                while stack:  # children closing at the same instant close first
                    j = stack.pop()
                    open_.discard(j)
                    if j == i:
                        break
            m += 1
        out[q] = stack[-1] if stack else -1
    return out


def attribute(spans_us: list, parents: list, names: list, launches_us: list,
              device: list, from_us: float = 0.0) -> dict:
    """Launches and device-idle seconds by program span name.

    Each launch counts for the innermost span open at its host start, each
    idle gap for the innermost span open when it began: ``launches_self``
    and ``idle_s`` per name, ``launches`` inclusive of the span's subtree
    (a name counted once per launch however often it nests). ``calls``:
    spans of the name that start at or after `from_us`. The key ``None``
    holds what falls outside every span."""
    out: dict = {}

    def row(name):
        return out.setdefault(name, {"calls": 0, "launches": 0, "launches_self": 0,
                                     "idle_s": 0.0})

    for (s, _), n in zip(spans_us, names):
        r = row(n)
        if s >= from_us:
            r["calls"] += 1
    for i in innermost(launches_us, spans_us, parents):
        if i < 0:
            row(None)["launches"] += 1
            continue
        row(names[i])["launches_self"] += 1
        seen = set()
        while i >= 0:
            if names[i] not in seen:
                seen.add(names[i])
                row(names[i])["launches"] += 1
            i = parents[i]
    gaps = idle_gaps(device)
    for (g0, g1), i in zip(gaps, innermost([g[0] for g in gaps], spans_us, parents)):
        row(names[i] if i >= 0 else None)["idle_s"] += (g1 - g0) / 1e6
    return out


def program_data(prof, exported: dict, stretch_ns: int, prefix: str) -> dict:
    """What the program's metrics read from one traced run: ``before``
    (host times and counters of the spans that ended before the profiled
    stretch began at `stretch_ns` on the tracer's clock), ``stretch``
    (launches, idle and calls by span name, from the trace, and the
    counters of the spans that started in it), ``window`` (every
    counter), ``kernels`` (device kernels in the stretch) and
    ``launch_events`` (launch calls in the stretch)."""
    from sfm_mvs_tpu_torch.utils import profiling

    start_ns, launches, device, kernels = trace_events(prof, prefix)
    spans = exported["spans"]
    mapped = map_spans(exported, start_ns)
    off = exported["clock"]["unix_ns"] - exported["clock"]["perf_ns"] - start_ns
    from_us = (stretch_ns + off) / 1e3
    names = [r[0] for r in spans]
    parents = [r[3] for r in spans]
    during = profiling.summary(exported, lambda i: i >= 0 and spans[i][1] >= stretch_ns)
    return {
        "before": profiling.summary(exported,
                                    lambda i: i >= 0 and 0 < spans[i][2] <= stretch_ns),
        "stretch": {"spans": attribute(mapped, parents, names, launches, device, from_us),
                    "counters": during["counters"]},
        "window": profiling.summary(exported)["counters"],
        "kernels": kernels,
        "launch_events": len(launches),
    }


def get(data, *path):
    """data[path[0]][path[1]]..., or None where a key is missing."""
    for k in path:
        if not isinstance(data, dict) or k not in data:
            return None
        data = data[k]
    return data


def ratio(num, den, scale=1.0):
    """scale * num / den, or None where either is missing or den is 0."""
    if num is None or not den:
        return None
    return scale * num / den


def launches_in(data, *names):
    """CUDA launches in the stretch inside the spans of these names (each
    with its subtree), or None where the trace holds no launch at all (no
    card) or none of the spans ran in the stretch."""
    if not get(data, "launch_events"):
        return None
    parts = [get(data, "stretch", "spans", n, "launches") for n in names]
    if all(p is None for p in parts):
        return None
    return sum(p or 0 for p in parts)
