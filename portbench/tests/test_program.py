"""The program's spans beside the trace (``portbench/program.py``): the
attribution rule on a synthetic trace, the metrics on nothing, and tiny
runs on the CPU with the tracer off (``--trace 0``) and on."""

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


def test_the_metrics_find_nothing_in_nothing():
    assert program.read_metrics(None) == {} and program.read_metrics({}) == {}
    for unit, better, fn in program.METRICS.values():
        assert fn({}) is None and better in ("lower", "higher") and unit
    assert len(program.METRICS) == 10


def test_a_trace_0_run_leaves_the_tracer_off():
    from sfm_mvs_tpu_torch.utils import profiling

    profiling.disable()
    profiling.reset()
    tiny.run_tiny("fountain11-incremental", seconds=0.5, trace=False)
    assert not profiling.enabled() and profiling.export()["spans"] == []


def test_a_traced_tiny_run_reads_the_program():
    from sfm_mvs_tpu_torch.utils import profiling

    cap = program._Capture(harness.load_driver("incremental"), True, harness.SPAN_PREFIX)
    try:
        out = tiny.run_tiny("fountain11-incremental", seconds=8.0, trace=True)
    finally:
        cap.undo()
    assert out["correct"] and not profiling.enabled()
    data = cap.data
    assert data["kernels"] == data["launch_events"] == 0  # the CPU has no CUDA launches
    before = data["before"]["spans"]
    assert before["register"]["calls"] > 0 and before["ba.lm"]["calls"] > 0
    window = data["window"]
    assert window["ba.lm_steps"] == 8 * (before["ba"]["calls"] + data["stretch"]["spans"][
        "ba"]["calls"])
    got = program.read_metrics(data)
    assert {"register_match_ms.frame", "register_pnp_ms.frame", "register_tri_ms.frame",
            "ba_accepted_share"} <= set(got)
    assert 0.0 < got["ba_accepted_share"] <= 100.0
