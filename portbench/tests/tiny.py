"""Tiny cells for the CPU tests: each cell's own files, cut by its driver's
``tiny(config, traffic)`` so that a run takes seconds on a CPU, and held to
the limits in ``tiny_limits/<cell>.json``.

A tiny cell's limits sit above what its sound tiny runs read and below
what the faults of ``test_faults.py`` read; the scene's geometry is
coarse at 240x160. The two first cells' sound runs read k1_gap 0 (the
plain matcher on both sides), ATE ~0.007, BA cost gap ~1e-6, BA descent
0.1-0.7, triangulation gap ~1e-3; sweep and fusion mismatches ~4e-5,
cloud gap ~1e-7."""

import json
import time

import torch

from portbench import harness
from portbench.run import HERE

MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}
LIMITS = HERE / "tests" / "tiny_limits"


def limits_file(cell_name):
    return LIMITS / f"{cell_name}.json"


def tiny_files(cell_name):
    """(cell, config, traffic) of the cell, cut by its driver's ``tiny``."""
    cell = CELLS[cell_name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    tr = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    cfg, tr = harness.load_driver(tr["driver"]).tiny(cfg, tr)
    return cell, cfg, tr


def run_tiny(cell_name, seed=2**33 + 17, seconds=5.0, trace=False):
    """One run of a tiny cell on the CPU: the harness's result object."""
    cell, cfg, tr = tiny_files(cell_name)
    ctx = harness.Context(cell=cell, config=cfg, traffic=tr, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device("cpu"), t_start=time.perf_counter())
    return harness.run_cell(ctx, MANIFEST, json.loads(limits_file(cell_name).read_text()))
