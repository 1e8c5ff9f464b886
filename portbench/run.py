"""Run one cell of the benchmark once.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Finds the cell in ``BENCHMARK.json`` at the checkout's root, its
configuration in ``portbench/configs/<config>.json``, its traffic in
``portbench/traffic/<traffic>.json`` and its limits in
``portbench/limits/<cell>.json``; builds the inputs from the seed on the
card, warms up, measures for ``--seconds``, checks the outputs against the
plain reference and prints one JSON line. Exits non-zero, printing no
result, without CUDA or with fewer cards than the cell asks for, and when
JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache"


def _cache_env() -> None:
    """Kernel and extension caches inside the checkout, at fixed paths, and
    one host thread for CPU-side tensor work (the load is one process)."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    os.environ.setdefault("MKL_NUM_THREADS", "1")
    os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(CACHE / "nv"))


def parse(argv):
    p = argparse.ArgumentParser(prog="portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_files(manifest: dict, workload: str):
    """(cell, config, traffic, limits) of one workload, found by name."""
    from portbench.harness import load_json

    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    config = load_json(HERE / "configs" / f"{cell['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    limits = load_json(HERE / "limits" / f"{workload}.json")
    return cell, config, traffic, limits


def main(argv) -> int:
    _cache_env()
    args = parse(argv)
    from portbench.harness import Context, forbidden_modules, load_json, run_cell

    manifest = load_json(HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = cell_files(manifest, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: CUDA is not available", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell.get("chips", 1)):
        print(f"portbench: {cell['chips']} cards asked, {torch.cuda.device_count()} present",
              file=sys.stderr)
        return 2
    ctx = Context(cell=cell, config=config, traffic=traffic, seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=torch.device("cuda", 0),
                  t_start=T_START)
    result = run_cell(ctx, manifest, limits)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {', '.join(found)}: the run must not import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
