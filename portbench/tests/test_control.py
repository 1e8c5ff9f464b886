"""The control: the cell computed one step below the configurations'
float32 with TF32 off (TF32 for the matrix products; the plain reference
in bfloat16 in the place of triangulation and MVS passes 1 and 2) has to
come out as not correct, at the cell's own size, on three seeds. It runs
on the card only (TF32 does not exist on the CPU):
``python -m pytest portbench/tests -m chip``.
"""

import json
import os
import subprocess
import sys

import pytest

from portbench.run import HERE
from portbench.tests import tiny

SEEDS = "3000000011,3000000012,3000000013"


@pytest.mark.chip
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_control_is_not_correct(cuda, cell):
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    out = subprocess.run([sys.executable, "-m", "portbench.control", "--workload", cell,
                          "--seeds", SEEDS, "--seconds", "8", "--control"], cwd=HERE.parent,
                         env=env, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(ln) for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(runs) == 3
    for r in runs:
        assert r["control"] and not r["correct"], r["checks"]
