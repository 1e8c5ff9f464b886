"""What every cell shares: the run's context, spans, the device trace, the
record of K1's calls, and the assembly of the result line.

A driver (``drivers/<name>.py``, named by the traffic file's ``driver``)
builds its inputs from the seed, warms up, runs the measured window and
returns a :class:`Outcome`; the harness reads the memory peak, lets the
driver free the program's state, runs the driver's judge (the plain
reference, ``reference.py``) and prints one JSON line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "sfm_mvs_tpu")
SPAN_PREFIX = "portbench."


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``sfm_mvs_tpu_torch`` is not ``sfm_mvs_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path):
    with open(path) as fh:
        return json.load(fh)


def seed_stream(*words: int) -> np.random.Generator:
    """A numpy generator from the run's seed and further words (any
    non-negative integers, the seed up to 2**64)."""
    return np.random.default_rng(np.random.SeedSequence([int(w) for w in words]))


def seed_int(*words: int) -> int:
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])


def window_start(ctx) -> None:
    """What every driver calls between its warm-up and its window: collect,
    then keep the set-up's objects out of the collector's later passes, so
    that they do not lengthen the window's. In a --trace 1 run the port's
    tracer (``sfm_mvs_tpu_torch/utils/profiling.py``) is then reset and
    turned on; :meth:`Profiler.stop` turns it off at the end of the
    profiled stretch and hands its record to ``TraceData.program``, and
    :func:`run_cell` drops the record when the driver returns. A --trace 0
    run never turns it on."""
    gc.collect()
    gc.freeze()
    if ctx.trace:
        from sfm_mvs_tpu_torch.utils import profiling

        profiling.reset()
        profiling.enable()


def tracer_off() -> None:
    """Turn the port's tracer off and drop what it recorded."""
    from sfm_mvs_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class Context:
    """One run of one cell."""

    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float  # host clock at the run's start
    control: bool = False  # the lower-precision control (tests/test_control.py)

    def log(self, stage: str) -> None:
        """Seconds since the run's start at the end of a set-up stage, on
        standard error."""
        print(f"portbench: {stage} done at {time.perf_counter() - self.t_start:.2f} s",
              file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a driver hands back once its window has closed."""

    setup_s: float
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value (the --trace 0 metrics)
    trace: Optional["TraceData"]  # the --trace 1 readings
    free: Callable[[], None]  # drops the program's state
    judge: Callable[[], dict]  # reading name -> value, after free()


class Spans:
    """Host-clock spans around calls into the program's layers.

    Off: no cost. Synchronized (``sync=True``): the device is synchronized
    before and after, so a span holds its layer's whole time. Under the
    profiler spans are ``record_function`` ranges without synchronization,
    which name the host's work beside the device's idle gaps.
    """

    def __init__(self, device, enabled: bool):
        self.device = device
        self.enabled = enabled
        self.profiling = False
        self.seconds: dict[str, list[float]] = {}
        self._saved: list = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        elif self.enabled:
            sync(self.device)
            t = time.perf_counter()
            yield
            sync(self.device)
            self.seconds.setdefault(name, []).append(time.perf_counter() - t)
        else:
            yield

    @contextlib.contextmanager
    def outer(self, name: str):
        """A span that only names the host's work under the profiler (a
        frame, a call), around the synchronized spans of its layers."""
        if self.profiling:
            with torch.profiler.record_function(SPAN_PREFIX + name):
                yield
        else:
            yield

    def wrap(self, owner, attr: str, name: str):
        """Put a span around ``owner.attr`` until :meth:`unwrap_all`."""
        fn = owner.__dict__[attr]
        spans = self

        def wrapper(*args, **kwargs):
            with spans(name):
                return fn(*args, **kwargs)

        self._saved.append((owner, attr, fn))
        setattr(owner, attr, wrapper)

    def unwrap_all(self):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)
        self._saved = []


@dataclasses.dataclass
class TraceData:
    """The readings of a --trace 1 run, which the per-layer readers take."""

    spans: dict  # name -> [seconds]
    counts: dict  # name -> number (frames, views, ...)
    busy_s: float = 0.0  # union of device intervals in the profiled stretch
    window_s: float = 0.0  # the profiled stretch's wall
    kernels: dict = dataclasses.field(default_factory=dict)  # device op name -> seconds
    idle_by_span: dict = dataclasses.field(default_factory=dict)  # span -> idle seconds
    k1_launches: list = dataclasses.field(default_factory=list)  # (rows, cols, dim, s0, s1)
    power_limit_w: Optional[float] = None
    # The port's own spans and counters beside the trace (program.program_data);
    # empty where the tracer was off or the window never reached the stretch.
    program: dict = dataclasses.field(default_factory=dict)


class Profiler:
    """torch.profiler over a steady stretch of the window, and the port's
    tracer (on since :func:`window_start`) read against it."""

    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0_ns = 0  # the stretch's start, on the tracer's clock (perf_counter_ns)
        self.wall = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        sync(self.device)
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0_ns = time.perf_counter_ns()

    def stop(self, data: TraceData):
        from sfm_mvs_tpu_torch.utils import profiling

        from portbench import program

        sync(self.device)
        self.wall = (time.perf_counter_ns() - self.t0_ns) / 1e9
        traced = profiling.enabled()
        profiling.disable()
        self.prof.__exit__(None, None, None)
        reduce_trace(self.prof, data)
        data.window_s = self.wall
        if traced:
            data.program = program.program_data(self.prof, profiling.export(), self.t0_ns,
                                                SPAN_PREFIX)


def reduce_trace(prof, data: TraceData) -> None:
    """Device busy time (the union of kernel and copy intervals), time per
    device op name, and the idle gaps between device intervals summed by
    the harness span open on the host when each gap began."""
    from torch.autograd import DeviceType

    dev, spans = [], []
    for e in prof.events():
        if e.name.startswith(SPAN_PREFIX):  # a harness span (also mirrored on the device's timeline)
            if e.device_type != DeviceType.CUDA:
                spans.append((e.time_range.start, e.time_range.end, e.name[len(SPAN_PREFIX):]))
        elif e.device_type == DeviceType.CUDA:
            dev.append((e.time_range.start, e.time_range.end, e.name))
    dev.sort()
    busy, end, gaps = 0.0, None, []
    for s, e, name in dev:
        data.kernels[name] = data.kernels.get(name, 0.0) + (e - s) / 1e6
        if end is None or e > end:
            if end is not None and s > end:
                gaps.append((end, s))
            busy += e - (s if end is None else max(s, end))
            end = e
    data.busy_s = busy / 1e6
    spans.sort(key=lambda x: (x[0], -x[1]))
    for g0, g1 in gaps:
        name = "outside spans"
        for s, e, n in spans:  # innermost span open at the gap's start
            if s <= g0 < e:
                name = n
        data.idle_by_span[name] = data.idle_by_span.get(name, 0.0) + (g1 - g0) / 1e6


class K1Recorder:
    """Wraps the port's K1 entry (``matching_cuda.knn_match_cuda``) for the
    run: keeps the inputs and answers of the calls made while ``keep`` is
    set, logs each call's valid rows and columns while ``log_shapes`` is
    set, and in the control puts the reference's TF32 answer in the
    kernel's place."""

    def __init__(self, control: bool = False):
        from sfm_mvs_tpu_torch.ops import matching_cuda

        self.module = matching_cuda
        self.orig = matching_cuda.knn_match_cuda
        self.control = control
        self.keep = False
        self.log_shapes = False
        self.kept: list = []
        self.shapes: list = []
        matching_cuda.knn_match_cuda = self._call

    def _call(self, desc0, desc1, valid0, valid1, ratio=0.70):
        if self.control:
            from portbench import reference
            from sfm_mvs_tpu_torch.ops.matching import Matches

            j, ok = reference.knn2(desc0, desc1, valid0, valid1, ratio, precision="tf32")
            rows = torch.arange(desc0.shape[0], dtype=torch.int32, device=desc0.device)
            out = Matches(idx0=rows, idx1=j.to(torch.int32), valid=ok)
        else:
            out = self.orig(desc0, desc1, valid0, valid1, ratio=ratio)
        if self.keep:
            self.kept.append((desc0, desc1, valid0, valid1, ratio, out))
        if self.log_shapes:
            self.shapes.append((valid0, valid1, desc0.shape[-1]))
        return out

    def launch_shapes(self) -> list:
        """(valid rows, valid columns, dim, slots0, slots1) per logged call."""
        return [(int(v0.sum()), int(v1.sum()), int(d), v0.numel(), v1.numel())
                for v0, v1, d in self.shapes]

    def close(self):
        self.module.knn_match_cuda = self.orig


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi (None where it cannot be read)."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=20).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def load_reader(metric: str):
    """The reader of one per-layer metric: ``layers/<metric>.py``'s
    ``read(TraceData) -> value or None``. Metric names hold dots, so the
    file is loaded by its path."""
    path = ROOT / "layers" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_layer_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def load_driver(name: str):
    return importlib.import_module(f"portbench.drivers.{name}")


def checks_of(readings: dict, limits: dict) -> dict:
    """{name: {"value", "limit"}} for every limited reading; a reading that
    is missing or not a finite number fails its limit."""
    out = {}
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        out[name] = {"value": float(v) if v is not None else math.inf, "limit": float(limit)}
    return out


def passed(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def run_cell(ctx: Context, manifest: dict, limits: dict) -> dict:
    """Drive one run of the cell in `ctx` and return the result line's
    object (without printing it)."""
    driver = load_driver(ctx.traffic["driver"])
    if ctx.device.type == "cuda":
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(ctx.device)
    try:
        out: Outcome = driver.run(ctx)
    finally:  # also where the window never reached the profiled stretch
        tracer_off()
    peak = (torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0)
    out.free()
    readings = out.judge()
    checks = checks_of(readings, limits)
    name = ctx.cell["name"]
    metrics = {}
    if ctx.trace:
        for m in manifest.get("per_layer", []):
            if name not in m.get("workloads", [name]):
                continue
            v = load_reader(m["name"])(out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in manifest.get("end_to_end", []):
            if name not in m.get("workloads", [name]):
                continue
            v = out.setup_s if m["name"] == "setup_s" else out.end_to_end.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    device = {
        "platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
        "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                 else "cpu"),
        "count": int(ctx.cell.get("chips", 1)),
        "memory_peak_bytes": int(peak),
    }
    result = {
        "correct": passed(checks) and out.failed == 0,
        "attempted": int(out.attempted),
        "failed": int(out.failed),
        "metrics": metrics,
        "device": device,
    }
    if ctx.trace and out.trace is not None:
        device["busy_s"] = out.trace.busy_s
        device["window_s"] = out.trace.window_s
        device["power_limit_w"] = out.trace.power_limit_w  # beside the shares of the peaks
        result["breakdown"] = {
            "device_ops": sorted(([k, v] for k, v in out.trace.kernels.items()),
                                 key=lambda kv: -kv[1])[:10],
            "idle_gaps": sorted(([k, v] for k, v in out.trace.idle_by_span.items()),
                                key=lambda kv: -kv[1])[:10],
        }
    result["checks"] = checks
    return result
