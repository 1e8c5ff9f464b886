"""The port's tracer: host-clock spans and counters inside the pipeline.

Off by default, and then free: :func:`span` returns one shared no-op
context manager and :func:`count` returns at once. :func:`enable` turns it
on for the process; the CLI does, so that ``metrics.jsonl`` carries each
frame's spans and counters.

A span records its name, its start and end on ``time.perf_counter_ns()``,
the index of its parent (the span open around it, -1 at the root) and a
request id that every span under one root call shares (the root's index).
Spans never synchronize the device and never open a
``torch.profiler.record_function`` range: they time the host's work, and a
consumer that wants the device's finds it in a torch.profiler trace
through the clock anchor of :func:`export`.

A counter adds a value to the innermost open span (index -1 outside every
span). The value is a Python number or a 0-d tensor; tensors are kept as
they are, and the next :func:`export` sums them and moves them to the host
once (the sums then stay on the host), so counting adds no host
synchronization.

Spans and counters stay in memory until :func:`reset`. A consumer that
wants only what came after some point (a driver's per-frame record) takes
a :func:`mark` and later reads ``summary(export(), keep=lambda i: i >=
mark)``, which leaves the record whole for whoever turned the tracer on.
One thread at a time: the spans nest by the order they open and close in.

    profiling.enable()
    with profiling.span("register"):
        profiling.count("register.tracked", tracked.sum())
    out = profiling.export()  # {"spans", "counters", "clock"}
"""

from __future__ import annotations

import contextlib
import time

import torch

_on = False
_spans: list = []  # [name, start_ns, end_ns, parent, request] per span, in opening order
_stack: list = []  # indices of the open spans, innermost last
_numbers: dict = {}  # (span index, name) -> summed Python number
_tensors: dict = {}  # (span index, name) -> [0-d tensors]


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


class _Span:
    __slots__ = ("rec", "idx")

    def __init__(self, name: str):
        self.rec = [name, 0, 0, -1, -1]
        self.idx = -1

    def __enter__(self):
        rec = self.rec
        parent = _stack[-1] if _stack else -1
        self.idx = len(_spans)
        rec[3] = parent
        rec[4] = _spans[parent][4] if parent >= 0 else self.idx
        _spans.append(rec)
        _stack.append(self.idx)
        rec[1] = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        self.rec[2] = time.perf_counter_ns()
        # A reset while the span was open has dropped it already.
        if _stack and _stack[-1] == self.idx and _spans[self.idx] is self.rec:
            _stack.pop()
        return False


def span(name: str):
    """A context manager that records a span named `name` while the tracer
    is on (the shared no-op :data:`NOOP` while it is off)."""
    if not _on:
        return NOOP
    return _Span(name)


def count(name: str, value=1) -> None:
    """Add `value` (a Python number or a 0-d tensor) to counter `name` of
    the innermost open span. Nothing while the tracer is off."""
    if not _on:
        return
    key = (_stack[-1] if _stack else -1, name)
    if isinstance(value, torch.Tensor):
        _tensors.setdefault(key, []).append(value.detach())
    else:
        _numbers[key] = _numbers.get(key, 0) + value


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    """Stop recording; what was recorded stays until :func:`reset`."""
    global _on
    _on = False


def enabled() -> bool:
    return _on


@contextlib.contextmanager
def paused():
    """Record nothing inside the block (a CUDA graph's capture, whose spans
    would time the capture and whose tensor counts would alias the graph's
    memory); the tracer is on again after it if it was on before."""
    global _on
    was, _on = _on, False
    try:
        yield
    finally:
        _on = was


def reset() -> None:
    """Drop every recorded span and counter (open spans included)."""
    _spans.clear()
    _stack.clear()
    _numbers.clear()
    _tensors.clear()


def _clock_anchor() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the pair of the five
    readings whose perf_counter bracket around time_ns is narrowest, the
    bracket's midpoint as the perf_counter reading."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, u)
    return best[1], best[2]


def mark() -> int:
    """Where the record stands: the index the next span will have."""
    return len(_spans)


def _summed_tensors() -> dict:
    """(span index, name) -> the sum of its tensor values, on the host:
    one stack and one copy per device and dtype."""
    groups: dict = {}
    for key, vals in _tensors.items():
        for v in vals:
            groups.setdefault((v.device, v.dtype), []).append((key, v))
    out: dict = {}
    for items in groups.values():
        host = torch.stack([v.reshape(()) for _, v in items]).cpu().tolist()
        for (key, _), x in zip(items, host):
            out[key] = out.get(key, 0) + x
    return out


def export() -> dict:
    """What was recorded since the last reset.

    ``spans``: [name, start_ns, end_ns, parent, request] per span in opening
    order (an open span has end_ns 0). ``counters``: {span index: {name:
    value}}. ``clock``: {"perf_ns", "unix_ns"}, the tracer's clock and
    ``time.time_ns()`` read together, which maps a span onto Unix time
    (and so onto a torch.profiler trace, whose events Kineto stamps on a
    Unix-time base). The tensor counts go into the host sums here, so a
    later export moves only the tensors counted after this one.
    """
    for key, value in _summed_tensors().items():
        _numbers[key] = _numbers.get(key, 0) + value
    _tensors.clear()
    counters: dict = {}
    for (idx, name), value in _numbers.items():
        counters.setdefault(idx, {})[name] = value
    perf_ns, unix_ns = _clock_anchor()
    return {"spans": [list(r) for r in _spans], "counters": counters,
            "clock": {"perf_ns": perf_ns, "unix_ns": unix_ns}}


def self_times(spans: list) -> list:
    """Each span's host self time in ns: its own time minus its children's."""
    own = [max(r[2] - r[1], 0) for r in spans]
    out = list(own)
    for r, t in zip(spans, own):
        if r[3] >= 0:
            out[r[3]] -= t
    return out


def summary(exported: dict, keep=None) -> dict:
    """{"spans": {name: {"calls", "ms", "self_ms"}}, "counters": {name:
    total}} of an :func:`export`, summed over the spans of one name (only
    those whose index passes `keep`, where given; -1 stands for counts
    outside every span)."""
    spans = exported["spans"]
    by_name: dict = {}
    for i, (r, own) in enumerate(zip(spans, self_times(spans))):
        if keep is None or keep(i):
            d = by_name.setdefault(r[0], {"calls": 0, "ms": 0.0, "self_ms": 0.0})
            d["calls"] += 1
            d["ms"] += max(r[2] - r[1], 0) / 1e6
            d["self_ms"] += own / 1e6
    totals: dict = {}
    for i, per_span in exported["counters"].items():
        if keep is None or keep(i):
            for name, v in per_span.items():
                totals[name] = totals.get(name, 0) + v
    return {"spans": by_name, "counters": totals}
