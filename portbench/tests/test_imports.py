"""Nothing the benchmark runs loads JAX or the JAX package, and the
command refuses to run where it cannot measure the card."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness
from portbench.run import HERE

ROOT = HERE.parent
BANNED = {"jax", "jaxlib", "flax", "sfm_mvs_tpu", "bench", "benchmarks"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {name.split(".")[0] for name in _imports(path)}
    assert not tops & BANNED
    if path.name in ("reference.py", "scene.py", "roofline.py"):
        assert "sfm_mvs_tpu_torch" not in tops  # the yardstick is independent of the port


def test_top_level_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "sfm_mvs_tpu_torch_probe", sys)
    assert "sfm_mvs_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sfm_mvs_tpu.ops", sys)
    assert harness.forbidden_modules() == ["sfm_mvs_tpu"]


def test_a_run_loads_no_jax(tmp_path):
    """A tiny run of each cell in a fresh interpreter, then its modules."""
    code = (
        "import json, sys\n"
        "from portbench.tests import tiny\n"
        "from portbench import harness\n"
        "for cell in tiny.CELLS:\n"
        "    tiny.run_tiny(cell, seconds=0.5, trace=True)\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_command(cwd, env):
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    cmd = manifest["command"] + ["--workload", manifest["workloads"][0]["name"], "--seed",
                                 str(2**33 + 1), "--seconds", "1", "--trace", "0"]
    cmd[0] = sys.executable
    return subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_without_cuda_the_command_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = _run_command(ROOT, dict(os.environ))
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_the_command_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run_command(tmp_path, env)
    assert out.returncode != 0 and out.stdout.strip() == ""
