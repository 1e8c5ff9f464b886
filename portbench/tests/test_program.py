"""The program's spans beside the trace (``portbench/program.py``): the
attribution rule on a synthetic trace, and tiny runs on the CPU with the
tracer off (``--trace 0``) and on (``--trace 1``)."""

import types

import pytest

from portbench import harness, program
from portbench.tests import tiny

# Spans (us): A [0, 100) holds B [10, 50), which holds C [20, 30), and
# D [60, 70); a second root named B, [200, 300).
SPANS = [(0.0, 100.0), (10.0, 50.0), (20.0, 30.0), (60.0, 70.0), (200.0, 300.0)]
PARENTS = [-1, 0, 1, 0, -1]
NAMES = ["A", "B", "C", "D", "B"]


def test_launches_go_to_the_innermost_span_by_host_start():
    launches = [5.0, 15.0, 25.0, 30.0, 50.0, 65.0, 150.0, 250.0]
    got = program.attribute(SPANS, PARENTS, NAMES, launches, [])
    assert {k: v["launches_self"] for k, v in got.items() if k} == {"A": 2, "B": 3, "C": 1,
                                                                    "D": 1}
    assert {k: v["launches"] for k, v in got.items()} == {"A": 6, "B": 4, "C": 1, "D": 1,
                                                          None: 1}  # 150: outside
    assert sum(v["launches_self"] for k, v in got.items() if k) + got[None]["launches"] == 8


def test_idle_gaps_go_to_the_span_open_when_they_began():
    # Gaps: [10, 20) begins at B's start (B), [50, 60) at B's end (A),
    # [70, 100) at D's end (A), [200, 210) at the second B's start.
    device = [(0.0, 10.0, "k"), (20.0, 50.0, "k"), (25.0, 40.0, "k"), (60.0, 70.0, "k"),
              (100.0, 200.0, "k"), (210.0, 400.0, "k")]
    assert program.idle_gaps(device) == [(10.0, 20.0), (50.0, 60.0), (70.0, 100.0),
                                         (200.0, 210.0)]
    got = program.attribute(SPANS, PARENTS, NAMES, [], device, from_us=15.0)
    assert got["B"]["idle_s"] == pytest.approx(20e-6)
    assert got["A"]["idle_s"] == pytest.approx(40e-6)
    assert None not in got
    assert {k: v["calls"] for k, v in got.items()} == {"A": 0, "B": 1, "C": 1, "D": 1}


def test_spans_closing_together_and_empty_spans():
    spans = [(0.0, 10.0), (5.0, 10.0), (7.0, 7.0)]
    assert program.innermost([4.0, 6.0, 7.0, 9.9, 10.0], spans, [-1, 0, 1]) == [0, 1, 1, 1, -1]


def run_spied(monkeypatch, cell, **kw):
    """run_tiny with the driver's Outcome kept: (result line, Outcome)."""
    seen = []
    load = harness.load_driver

    def spy(name):
        driver = load(name)

        def run(ctx):
            seen.append(driver.run(ctx))
            return seen[-1]

        return types.SimpleNamespace(run=run, tiny=driver.tiny)

    monkeypatch.setattr(harness, "load_driver", spy)
    res = tiny.run_tiny(cell, **kw)
    return res, seen[0]


PROGRAM = ("program_span", "program_counter")


def card_only(metric):
    """A reader that declares it finds nothing on the CPU (``CARD_ONLY``)."""
    return harness.load_reader(metric).__globals__.get("CARD_ONLY", False)


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_trace_0_run_leaves_the_tracer_off(monkeypatch, cell):
    from sfm_mvs_tpu_torch.utils import profiling

    turned_on = []
    monkeypatch.setattr(profiling, "enable", lambda: turned_on.append(1))
    res, out = run_spied(monkeypatch, cell, seconds=0.5, trace=False)
    assert not turned_on and not profiling.enabled()
    assert profiling.export()["spans"] == [] and out.trace is None
    assert not {m["name"] for m in tiny.MANIFEST["per_layer"]} & set(res["metrics"])


@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_a_traced_tiny_run_reads_the_programs_metrics(monkeypatch, cell):
    """The CPU makes no CUDA launch: its ATen ops stand in for launches, so
    that the trace's launch calls are mapped onto the port's spans."""
    from sfm_mvs_tpu_torch.utils import profiling

    monkeypatch.setattr(program, "is_launch", lambda name: name.startswith("aten::"))
    res, out = run_spied(monkeypatch, cell, seconds=8.0, trace=True)
    assert res["correct"] and not profiling.enabled() and profiling.export()["spans"] == []
    data = out.trace.program
    assert data["launch_events"] > 0 and data["kernels"] == 0  # no device on the CPU
    placed = sum(r["launches_self"] for k, r in data["stretch"]["spans"].items() if k)
    assert placed > 0
    mine = {m["name"] for m in tiny.MANIFEST["per_layer"]
            if m["source"] in PROGRAM and cell in m.get("workloads", [cell])}
    assert mine
    for name in sorted(mine):
        if card_only(name):
            assert name not in res["metrics"]
        else:
            assert res["metrics"][name]["value"] > 0, name


def test_the_program_record_of_a_traced_incremental_run(monkeypatch):
    res, out = run_spied(monkeypatch, "fountain11-incremental", seconds=8.0, trace=True)
    data = out.trace.program
    before = data["before"]["spans"]
    assert before["register"]["calls"] > 0 and before["ba.lm"]["calls"] > 0
    window = data["window"]
    assert window["ba.lm_steps"] == 8 * (before["ba"]["calls"] + data["stretch"]["spans"][
        "ba"]["calls"])
    assert 0.0 < res["metrics"]["ba_accepted_share"]["value"] <= 100.0
    # Without a card the trace holds no launch: the launch metrics find nothing.
    assert data["launch_events"] == 0 and "ba_launches.frame" not in res["metrics"]
