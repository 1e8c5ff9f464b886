"""Profiling hooks: torch.profiler traces and roofline accounting.

PyTorch port of ``sfm_mvs_tpu/utils/profiling.py``. Any pipeline section
can be wrapped in a torch.profiler trace (exported as a Chrome trace, which
Perfetto opens), regions inside it named with ``annotate``, and timed
functions summarized against the GPU's measured peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch

# Measured peaks of the port's GPU, with the card beside them. The FP32
# rate is FFMA in independent chains, from ``python3 chip_smoke.py
# --microbench`` (PERF.md §6). Memory bandwidth was not measured, so rows
# report achieved GB/s without a share.
PEAKS = {
    "h100": {"card": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0, "f32_tflops": 65.4},
}


@contextlib.contextmanager
def trace(log_dir: str = "sfm_trace") -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace (CPU, and CUDA where available)
    around a pipeline section; writes ``<log_dir>/trace.json``.

        with profiling.trace("out/trace"):
            pipeline.run(...)
    """
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region inside a trace (shows up per frame in the timeline)."""
    with torch.profiler.record_function(name):
        yield


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Roofline:
    """Accumulate (flops, bytes, seconds) per function and report rates and
    the FP32 rate's share of the card's peak."""

    def __init__(self, chip: str = "h100"):
        self.chip = PEAKS[chip]
        self.rows: list[dict] = []

    def record(self, name: str, seconds: float, flops: float = 0.0, bytes_: float = 0.0):
        row = {"name": name, "ms": seconds * 1e3}
        if flops:
            row["achieved_tflops"] = flops / seconds / 1e12
            row["f32_fraction"] = row["achieved_tflops"] / self.chip["f32_tflops"]
        if bytes_:
            row["achieved_gbps"] = bytes_ / seconds / 1e9
        self.rows.append(row)
        return row

    def time_and_record(self, name: str, fn, *args, flops=0.0, bytes_=0.0, iters=10):
        """Mean wall time of `iters` calls after one warm-up call, with the
        device synchronized before and after the loop."""
        fn(*args)
        _synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        _synchronize()
        return self.record(name, (time.perf_counter() - t0) / iters, flops, bytes_)
