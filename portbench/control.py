"""Readings of a cell over several seeds in one process, sound or control.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 10 [--control]

Prints one JSON line per seed with the numbers compared and their limits.
With ``--control`` the run computes one step below the configurations'
float32 with TF32 off: the port's own float32 products run with TF32 on;
K1's answers are replaced by the plain reference's in TF32 (a matrix
product); triangulation, MVS pass 1's sweep and pass 2's filter, fusion
and back-projection by the plain reference's in bfloat16 (elementwise
work, which TF32 does not reach). Every control run has to come out as
not correct; the limits in ``limits/<cell>.json`` were set between the
sound runs' largest reading and the control's smallest. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run as run_mod


def main(argv) -> int:
    run_mod._cache_env()
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    from portbench.harness import Context, load_json, run_cell

    if not torch.cuda.is_available():
        print("portbench.control: CUDA is not available", file=sys.stderr)
        return 2
    manifest = load_json(run_mod.HERE.parent / "BENCHMARK.json")
    cell, config, traffic, limits = run_mod.cell_files(manifest, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell=cell, config=config, traffic=traffic, seed=seed, seconds=args.seconds,
                      trace=False, device=torch.device("cuda", 0), t_start=time.perf_counter(),
                      control=args.control)
        res = run_cell(ctx, manifest, limits)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(json.dumps({"workload": args.workload, "seed": seed, "control": args.control,
                          "correct": res["correct"], "attempted": res["attempted"],
                          "metrics": res["metrics"], "checks": res["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
