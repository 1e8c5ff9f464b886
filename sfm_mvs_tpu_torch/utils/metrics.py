"""Structured per-frame metrics: JSONL log + summaries.

PyTorch port of ``sfm_mvs_tpu/utils/metrics.py``, with the same records
and summary. Every frame emits a structured record (inliers, reprojection
error, point counts, BA convergence, wall time) to an append-only JSONL
file, plus an in-memory aggregate for end-of-run summaries.

``StageTimer`` synchronizes the CUDA device before each clock reading when
given one: kernel launches are asynchronous, so an unsynchronized reading
would time the launches, not the work.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional

import torch


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
        frames = [r for r in self.records if r.get("event") == "frame"]
        if not frames:
            return {"frames": 0}
        errs = [r["reproj_error"] for r in frames if "reproj_error" in r]
        times = [r["wall_s"] for r in frames if "wall_s" in r]
        return {
            "frames": len(frames),
            "mean_reproj_error": sum(errs) / max(len(errs), 1),
            "max_reproj_error": max(errs) if errs else None,
            "mean_frame_s": sum(times) / max(len(times), 1) if times else None,
            "frames_per_s": len(times) / sum(times) if times else None,
        }


class StageTimer:
    """Context-manager accumulator for per-stage wall times.

    device: a CUDA device to synchronize before each clock reading (None or
    a CPU device: no synchronization).
    """

    def __init__(self, device=None):
        self.stages: dict[str, float] = {}
        dev = torch.device(device) if device is not None else None
        self._cuda = dev if dev is not None and dev.type == "cuda" else None

    def _now(self) -> float:
        if self._cuda is not None:
            torch.cuda.synchronize(self._cuda)
        return time.time()

    def stage(self, name: str):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = timer._now()

            def __exit__(self, *exc):
                timer.stages[name] = timer.stages.get(name, 0.0) + timer._now() - self.t0

        return _Ctx()
