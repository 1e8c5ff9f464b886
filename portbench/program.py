"""The program's own spans and counters beside a cell's device trace.

The port records spans and counters where its work happens (its tracer,
``sfm_mvs_tpu_torch/utils/profiling.py``: ``detect``, ``register.pnp``,
``ba.lm``, ``k1``, ``mvs.sweep``, ...). This module maps them onto a
torch.profiler trace through the tracer's clock anchor and attributes the
trace to them: each CUDA launch (``cudaLaunchKernel`` and its variants) by
its host start, and each device-idle gap by the time it began, to the
innermost program span open then. It also holds the per-layer metrics
that read the result (:data:`METRICS`).

Run a cell with the tracer on, as a ``--trace 1`` run with the program's
readings added to its line:

    python3 -m portbench.program --workload fountain11-incremental --seed 5 --seconds 51

The tracer is turned on after warm-up and off when the profiled stretch
ends; host times are read from the window before the stretch, launches and
idle from the stretch, counters from the whole window. ``--tracer 0`` runs
the same with the tracer off (its cost: compare ``register_ms.frame`` and
``ba_ms.frame``). Nothing here changes the benchmark's own command.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

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


def _get(data, *path):
    for k in path:
        if not isinstance(data, dict) or k not in data:
            return None
        data = data[k]
    return data


def _ratio(num, den, scale=1.0):
    if num is None or not den:
        return None
    return scale * num / den


def _stretch(data, name, key):
    return _get(data, "stretch", "spans", name, key)


def _calls_before(data, name):
    return _get(data, "before", "spans", name, "calls")


def _mvs_sweep_launches(d):
    parts = [_stretch(d, n, "launches") for n in ("mvs.ranges", "mvs.sweep")]
    if all(p is None for p in parts):
        return None
    return _ratio(sum(p or 0 for p in parts), _get(d, "stretch", "counters", "mvs.views"))


# The per-layer metrics that read the program's spans and counters:
# metric -> (unit, better, function of program_data()'s dict -> value or None).
METRICS = {
    "detect_launches.frame": ("launches", "lower", lambda d: _ratio(
        _stretch(d, "detect", "launches"), _get(d, "stretch", "counters", "detect.frames"))),
    "register_launches.frame": ("launches", "lower", lambda d: _ratio(
        _stretch(d, "register", "launches"), _stretch(d, "register", "calls"))),
    "register_match_ms.frame": ("ms", "lower", lambda d: _ratio(
        _get(d, "before", "spans", "register.match", "ms"), _calls_before(d, "register"))),
    "register_pnp_ms.frame": ("ms", "lower", lambda d: _ratio(
        _get(d, "before", "spans", "register.pnp", "self_ms"), _calls_before(d, "register"))),
    "register_tri_ms.frame": ("ms", "lower", lambda d: _ratio(
        _get(d, "before", "spans", "register.triangulate", "self_ms"),
        _calls_before(d, "register"))),
    "ba_launches.frame": ("launches", "lower", lambda d: _ratio(
        _stretch(d, "ba", "launches"), _stretch(d, "ba", "calls"))),
    "ba_accepted_share": ("%", "higher", lambda d: _ratio(
        _get(d, "window", "ba.accepted"), _get(d, "window", "ba.lm_steps"), 100.0)),
    "k1_valid_share": ("%", "higher", lambda d: _ratio(
        _get(d, "window", "k1.valid_pairs"), _get(d, "window", "k1.slots"), 100.0)),
    "mvs_sweep_launches.view": ("launches", "lower", _mvs_sweep_launches),
    "mvs_copy_ms.view": ("ms", "lower", lambda d: _ratio(
        _get(d, "before", "spans", "mvs.copy", "ms"), _get(d, "before", "counters",
                                                           "mvs.views"))),
}


def read_metrics(data) -> dict:
    """{metric: value} for every metric of :data:`METRICS` that finds
    something to read in `data` (None or {} finds nothing)."""
    out = {}
    for name, (_, _, fn) in METRICS.items():
        v = fn(data or {})
        if v is not None:
            out[name] = v
    return out


def span_cost_us(n: int = 200_000) -> dict:
    """Host us per ``with profiling.span(...)`` with the tracer off and
    on, and per ``profiling.count`` on (the tracer is left off and empty)."""
    from sfm_mvs_tpu_torch.utils import profiling

    out = {}
    for on in (False, True):
        profiling.reset()
        (profiling.enable if on else profiling.disable)()
        t = time.perf_counter()
        for _ in range(n):
            with profiling.span("s"):
                pass
        out["span_on" if on else "span_off"] = (time.perf_counter() - t) / n * 1e6
        if on:
            t = time.perf_counter()
            with profiling.span("s"):
                for _ in range(n):
                    profiling.count("c", 1)
            out["count_on"] = (time.perf_counter() - t) / n * 1e6
    profiling.disable()
    profiling.reset()
    return out


class _Capture:
    """Turns the tracer on after a driver's warm-up (its ``settle``) and
    hands the profiled stretch's attribution over when the harness's
    profiler stops; ``undo`` restores what it patched."""

    def __init__(self, driver, tracer: bool, prefix: str):
        from portbench import harness
        from sfm_mvs_tpu_torch.utils import profiling

        self.harness, self.profiling, self.driver = harness, profiling, driver
        self.tracer, self.prefix = tracer, prefix
        self.data = None
        self.saved = [(driver, "settle", driver.settle),
                      (harness.Profiler, "start", harness.Profiler.start),
                      (harness.Profiler, "stop", harness.Profiler.stop)]
        settle, start, stop = (s[2] for s in self.saved)
        cap = self

        def settled():
            settle()
            if cap.tracer:
                profiling.reset()
                profiling.enable()

        def started(prof_self):
            start(prof_self)
            cap.stretch_ns = time.perf_counter_ns()

        def stopped(prof_self, data):
            stop(prof_self, data)
            if cap.tracer:
                cap.data = program_data(prof_self.prof, profiling.export(), cap.stretch_ns,
                                        cap.prefix)
            profiling.disable()
            profiling.reset()

        driver.settle = settled
        harness.Profiler.start = started
        harness.Profiler.stop = stopped

    def undo(self):
        for owner, attr, fn in self.saved:
            setattr(owner, attr, fn)


def main(argv) -> int:
    from portbench import run

    run._cache_env()
    p = argparse.ArgumentParser(prog="portbench.program")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    import torch

    from portbench import harness

    manifest = harness.load_json(run.HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = run.cell_files(manifest, args.workload)
    if not torch.cuda.is_available():
        print("portbench.program: CUDA is not available", file=sys.stderr)
        return 2
    print(f"portbench.program: span cost {json.dumps(span_cost_us())}", file=sys.stderr)
    ctx = harness.Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                          seconds=args.seconds, trace=True, device=torch.device("cuda", 0),
                          t_start=run.T_START)
    cap = _Capture(harness.load_driver(traffic["driver"]), bool(args.tracer), harness.SPAN_PREFIX)
    try:
        result = harness.run_cell(ctx, manifest, limits)
    finally:
        cap.undo()
    for name, v in read_metrics(cap.data).items():
        result["metrics"][name] = {"value": float(v), "unit": METRICS[name][0]}
    if cap.data is not None:
        st = cap.data["stretch"]["spans"]
        placed = sum(r["launches_self"] for k, r in st.items() if k is not None)
        outside = st.get(None, {}).get("launches", 0)
        result["program"] = {
            "kernels": cap.data["kernels"], "launch_events": cap.data["launch_events"],
            "launches_in_spans": placed, "launches_outside": outside,
            "stretch": {str(k): v for k, v in st.items()},
            "before": cap.data["before"], "window_counters": cap.data["window"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
