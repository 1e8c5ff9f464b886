"""Structured per-frame metrics: JSONL log + summaries.

PyTorch port of ``sfm_mvs_tpu/utils/metrics.py``, with the same records.
Every frame emits a structured record (inliers, reprojection error, point
counts, BA convergence, wall time; with the tracer of ``utils/profiling.py``
on, the frame's span self times and counters) to an append-only JSONL
file, plus an in-memory aggregate for end-of-run summaries.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class MetricsLogger:
    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.records: list[dict[str, Any]] = []
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            # truncate: one run per file
            open(path, "w").close()

    def log(self, **fields) -> dict[str, Any]:
        rec = {"ts": time.time(), **fields}
        self.records.append(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec

    def summary(self) -> dict[str, Any]:
        """Frame count, reprojection errors, mean frame time, and the rate:
        frames over the wall time from the first frame's start (its log
        time less its ``wall_s``) to the last frame's end (its log time),
        so the time between frames counts."""
        frames = [r for r in self.records if r.get("event") == "frame"]
        if not frames:
            return {"frames": 0}
        errs = [r["reproj_error"] for r in frames if "reproj_error" in r]
        timed = [r for r in frames if "wall_s" in r]
        times = [r["wall_s"] for r in timed]
        span_s = timed[-1]["ts"] - (timed[0]["ts"] - timed[0]["wall_s"]) if timed else 0.0
        return {
            "frames": len(frames),
            "mean_reproj_error": sum(errs) / max(len(errs), 1),
            "max_reproj_error": max(errs) if errs else None,
            "mean_frame_s": sum(times) / max(len(times), 1) if times else None,
            "frames_per_s": len(timed) / span_s if span_s > 0 else None,
        }
