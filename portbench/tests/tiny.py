"""Tiny cells for the CPU tests: the real cells' files with their sizes cut
so that a run takes seconds on a CPU, and limits for those sizes."""

import copy
import json
import time

import torch

from portbench import harness
from portbench.run import HERE

MANIFEST = json.loads((HERE.parent / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in MANIFEST["workloads"]}

# Limits for the tiny sizes (240x160 frames): the sound runs read
# k1_gap 0 (the plain matcher on both sides), ATE ~0.007, BA cost gap
# ~1e-6, BA descent 0.1-0.7, triangulation gap ~1e-3, sweep and fusion
# mismatches ~4e-5, cloud gap ~1e-7; the scene's
# geometry is coarse at this size.
TINY_LIMITS = {
    "fountain11-incremental": {"k1_gap": 1e-5, "unregistered": 0, "pose_ate": 0.05,
                               "ba_cost_gap": 1e-4, "ba_descent": 0.95, "tri_gap": 1e-2},
    "fountain11-dense": {"pose_ate": 0.05, "sweep_mismatch": 1e-3, "fuse_mismatch": 1e-3,
                         "depth_rel_rms": 0.2, "depth_median": 0.1, "depth_uncovered": 0.78,
                         "cloud_gap": 1e-5},
}


def tiny_files(cell_name):
    cell = CELLS[cell_name]
    cfg = json.loads((HERE / "configs" / f"{cell['config']}.json").read_text())
    tr = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    small = dict(image_size=[240, 160], fx=300.0, fy=301.0, cx=119.0, cy=81.0)
    cfg["scene"].update(small)
    cfg["sfm"].update({k: small[k] for k in ("fx", "fy", "cx", "cy")})
    cfg["sfm"]["frontend"]["max_features"] = 1024
    cfg["sfm"]["ransac"] = {"essential_iters": 256, "pnp_iters": 256}
    if tr["driver"] == "incremental":
        cfg["scene"].update(num_cameras=7, arc_degrees=18.0)
        cfg["sfm"]["map"] = {"max_cameras": 16, "max_points": 4096}
        tr.update(warmup_frames=2, profile_seconds=0.5)
    else:
        cfg["scene"].update(num_cameras=6, arc_degrees=12.0)
        cfg["sfm"]["map"] = {"max_cameras": 6, "max_points": 4096}
        cfg["mvs"]["num_depths"] = 16
        tr.update(profile_seconds=0.5)
    return cell, cfg, tr


def run_tiny(cell_name, seed=2**33 + 17, seconds=5.0, trace=False):
    """One run of a tiny cell on the CPU: the harness's result object."""
    cell, cfg, tr = tiny_files(cell_name)
    ctx = harness.Context(cell=cell, config=cfg, traffic=tr, seed=seed, seconds=seconds,
                          trace=trace, device=torch.device("cpu"), t_start=time.perf_counter())
    return harness.run_cell(ctx, MANIFEST, copy.deepcopy(TINY_LIMITS[cell_name]))
