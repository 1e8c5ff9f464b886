"""BENCHMARK.json against the contract's rules, and the harness finding
every configuration, traffic mix, limit file and per-layer reader by name."""

import json
import math
import re

import pytest

from portbench import harness
from portbench.run import HERE

ROOT = HERE.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELL_NAMES = [w["name"] for w in MANIFEST["workloads"]]


def text_ok(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MANIFEST["command"]) <= 32 and all(text_ok(w) for w in MANIFEST["command"])
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    rs = MANIFEST["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells fits in 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units():
    names = [c["name"] for c in MANIFEST["configs"]] + CELL_NAMES
    metrics = MANIFEST["end_to_end"] + MANIFEST["per_layer"]
    names += [m["name"] for m in metrics]
    for w in MANIFEST["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in MANIFEST["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len(set(CELL_NAMES)) == len(CELL_NAMES)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_exactly_their_keys():
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert text_ok(c["source"]) and text_ok(c["why"]) and len(c["reduced"]) <= 16
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and text_ok(w["why"])
    for m in MANIFEST["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MANIFEST["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert text_ok(m["layer"])


def test_setup_s_and_cell_coverage():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(MANIFEST["workloads"])
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == {c["name"] for c in MANIFEST["configs"]}
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    for cell in CELL_NAMES:
        reported = [m for m in MANIFEST["end_to_end"] if cell in m.get("workloads", [cell])]
        assert any(m["name"] == "setup_s" for m in reported)
        assert any(m["name"] != "setup_s" for m in reported)
        assert any(cell in m.get("workloads", [cell]) for m in MANIFEST["per_layer"])


def test_every_moves_is_reported_by_each_of_its_cells():
    e2e = {m["name"]: m for m in MANIFEST["end_to_end"]}
    for m in MANIFEST["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELL_NAMES):
            assert cell in CELL_NAMES
            assert cell in e2e[m["moves"]].get("workloads", CELL_NAMES), (m["name"], cell)


# The layers the benchmark has measured since it began (PERF.md section 3).
LAYERS = ("detection", "driver", "bundle adjustment", "kernel K1", "device", "MVS pass 1",
          "MVS pass 2")


def layer_faults(manifest) -> list:
    """What breaks the rule on layers: each of LAYERS is there, with a
    metric that some cell reports; any further layer has text and a metric
    that moves an end-to-end metric that each of its cells reports."""
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {}
    for m in manifest["per_layer"]:
        layers.setdefault(m["layer"], []).append(m)

    def sound(m):
        if m["moves"] not in e2e:
            return False
        reporting = e2e[m["moves"]].get("workloads", cells)
        mine = m.get("workloads", cells)
        return bool(mine) and all(c in cells and c in reporting for c in mine)

    faults = [f"layer {name!r} is missing" for name in LAYERS if name not in layers]
    for name, metrics in layers.items():
        if not text_ok(name):
            faults.append(f"layer {name!r} has no one-line text")
        if not any(sound(m) for m in metrics):
            faults.append(f"layer {name!r} has no metric that its cells report")
    return faults


def test_layers_are_a_superset_of_the_benchmarks_own():
    assert layer_faults(MANIFEST) == []


def _with(per_layer):
    return dict(MANIFEST, per_layer=per_layer)


@pytest.mark.parametrize("layer", LAYERS)
def test_taking_out_a_layer_fails(layer):
    assert layer_faults(_with([m for m in MANIFEST["per_layer"] if m["layer"] != layer]))


def test_a_new_layer_needs_a_metric_its_cells_report():
    cell = CELL_NAMES[0]
    moves = next(m for m in MANIFEST["end_to_end"]
                 if m["name"] != "setup_s" and cell in m.get("workloads", [cell]))
    other = [c for c in CELL_NAMES if c not in moves.get("workloads", CELL_NAMES)]
    moves = moves["name"]
    taken = {m["layer"] for m in MANIFEST["per_layer"]}
    layer = next(f"new layer {i}" for i in range(len(taken) + 1) if f"new layer {i}" not in taken)
    new = {"name": "x_ms.pair", "unit": "ms", "better": "lower", "source": "program_span",
           "layer": layer, "moves": moves, "workloads": [cell]}
    assert layer_faults(_with(MANIFEST["per_layer"] + [new])) == []
    for bad in (dict(new, layer=""), dict(new, layer="a\nb"), dict(new, moves="nothing"),
                dict(new, workloads=[]), dict(new, workloads=["no-such-cell"])):
        assert layer_faults(_with(MANIFEST["per_layer"] + [bad])), bad
    if other:  # a cell that does not report the moved metric
        assert layer_faults(_with(MANIFEST["per_layer"] + [dict(new, workloads=other)]))


def test_roofline_names():
    for m in MANIFEST["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_harness_finds_each_cells_files(cell):
    from portbench.run import cell_files

    w, config, traffic, limits = cell_files(MANIFEST, cell)
    assert config["name"] == w["config"]
    harness.load_driver(traffic["driver"])
    assert limits and all(isinstance(v, (int, float)) and math.isfinite(v) for v in limits.values())
    conf = next(c for c in MANIFEST["configs"] if c["name"] == w["config"])
    assert (ROOT / conf["file"]).is_file() and conf["file"].startswith("portbench/configs/")
    assert config["reduced"] == conf["reduced"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_each_cell_has_its_tiny_file_and_its_driver_a_tiny(cell):
    from portbench.run import cell_files
    from portbench.tests import tiny

    _, config, traffic, limits = cell_files(MANIFEST, cell)
    path = tiny.limits_file(cell)
    assert path.is_file(), f"{path.relative_to(ROOT)} is missing"
    small = json.loads(path.read_text())
    assert set(small) == set(limits), f"{path.relative_to(ROOT)} limits other numbers"
    cut = harness.load_driver(traffic["driver"]).tiny(config, traffic)
    assert len(cut) == 2 and cut[0] != config


@pytest.mark.parametrize("metric", [m["name"] for m in MANIFEST["per_layer"]])
def test_harness_finds_each_layer_reader(metric):
    read = harness.load_reader(metric)
    assert read(harness.TraceData(spans={}, counts={})) is None


def test_config_files_are_distinct():
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for c in MANIFEST["configs"]:
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]


@pytest.mark.parametrize("cell", CELL_NAMES)
def test_stated_limits_are_the_configurations_guarantees(cell):
    from portbench.run import cell_files

    _, config, _, limits = cell_files(MANIFEST, cell)
    for name, value in config.get("guarantees", {}).items():
        if name in limits:
            assert limits[name] == value
