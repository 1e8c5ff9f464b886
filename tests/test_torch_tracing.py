"""The port's tracer (sfm_mvs_tpu_torch/utils/profiling.py) on the CPU.

Off, it records nothing and hands out one shared no-op span. On, spans
nest (parent index, one request id per root call, self time = own time
less the children's), counters attach to the innermost open span and
tensor values are summed only at ``export``. The clock anchor maps a span
onto torch.profiler's timeline: ``record_function`` ranges opened around
the same statements land within 200 us of them (the median of 20). On a tiny scene,
``IncrementalSfM.run`` records the detection, bootstrap, registration and
BA spans (``ba.lm_steps`` = ``max_iterations`` per BA call) into each
frame's record and leaves the tracer's own record whole (each record is
the ``summary`` of the spans from a ``mark`` on), and ``densify_map``
records the MVS spans.
"""

import contextlib
import json

import pytest
import torch

from sfm_mvs_tpu_torch import cli
from sfm_mvs_tpu_torch.models import mvs
from sfm_mvs_tpu_torch.models.incremental import IncrementalSfM
from sfm_mvs_tpu_torch.utils import config, metrics, profiling
from sfm_mvs_tpu_torch.utils.synthetic import render_staircase_sequence

BA_ITERS = 3


@contextlib.contextmanager
def tracer_on():
    profiling.reset()
    profiling.enable()
    try:
        yield
    finally:
        profiling.disable()
        profiling.reset()


def test_off_records_nothing():
    profiling.disable()
    profiling.reset()
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b is profiling.NOOP and not profiling.enabled()
    with a:
        profiling.count("n", 3)
        profiling.count("t", torch.ones((), dtype=torch.int64))
    out = profiling.export()
    assert out["spans"] == [] and out["counters"] == {}
    assert set(out["clock"]) == {"perf_ns", "unix_ns"}


def test_spans_nest_with_parents_requests_and_self_time():
    with tracer_on():
        with profiling.span("root"):
            with profiling.span("child"):
                with profiling.span("leaf"):
                    profiling.count("n", 2)
                profiling.count("n", 1)
            with profiling.span("child"):
                pass
        with profiling.span("root"):
            profiling.count("m")
        profiling.count("outside", 5)
        out = profiling.export()
    spans = out["spans"]
    assert [r[0] for r in spans] == ["root", "child", "leaf", "child", "root"]
    assert [r[3] for r in spans] == [-1, 0, 1, 0, -1]  # parents
    assert [r[4] for r in spans] == [0, 0, 0, 0, 4]  # request ids: the root's index
    assert all(r[2] >= r[1] > 0 for r in spans)
    assert spans[0][1] <= spans[1][1] <= spans[2][1] <= spans[2][2] <= spans[1][2]
    assert out["counters"] == {2: {"n": 2}, 1: {"n": 1}, 4: {"m": 1}, -1: {"outside": 5}}
    selfs = profiling.self_times(spans)
    own = [r[2] - r[1] for r in spans]
    assert selfs[0] == own[0] - own[1] - own[3] and selfs[1] == own[1] - own[2]
    summary = profiling.summary(out)
    assert summary["spans"]["child"]["calls"] == 2
    assert summary["spans"]["root"]["ms"] == pytest.approx((own[0] + own[4]) / 1e6)
    assert summary["counters"] == {"n": 3, "m": 1, "outside": 5}


def test_tensor_counters_are_summed_at_export():
    with tracer_on():
        with profiling.span("s"):
            t = torch.tensor(4, dtype=torch.int32)
            profiling.count("k", t)
            profiling.count("k", torch.tensor(True))
            profiling.count("k", 10)
            profiling.count("f", torch.tensor(0.5))
            t.add_(1)  # kept as it is: the export reads its value then
        out = profiling.export()
    assert out["counters"] == {0: {"k": 16, "f": 0.5}}


def test_an_export_moves_each_tensor_to_the_host_once():
    with tracer_on():
        with profiling.span("s"):
            profiling.count("k", torch.tensor(4))
        first = profiling.export()
        again = profiling.export()
        mark = profiling.mark()
        with profiling.span("s"):
            t = torch.tensor(2)
            profiling.count("k", t)
        later = profiling.export()
        t.add_(5)  # exported already: the record keeps the value it read
        last = profiling.export()
    assert first["counters"] == again["counters"] == {0: {"k": 4}}
    assert mark == 1 and later["counters"] == last["counters"] == {0: {"k": 4}, 1: {"k": 2}}
    assert profiling.summary(later, keep=lambda i: i >= mark)["counters"] == {"k": 2}


def test_reset_with_a_span_open():
    with tracer_on():
        with profiling.span("open"):
            profiling.reset()
            with profiling.span("after"):
                pass
        out = profiling.export()
    assert [r[0] for r in out["spans"]] == ["after"] and out["spans"][0][3] == -1


def test_clock_anchor_maps_spans_onto_the_profiler():
    from torch.profiler import ProfilerActivity, profile, record_function

    x = torch.randn(64, 64)
    with tracer_on():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):  # the first range pays a one-time set-up
                x = torch.tanh(x @ x)
            for i in range(20):
                with profiling.span(f"s{i}"), record_function(f"s{i}"):
                    x = torch.tanh(x @ x)
        out = profiling.export()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    clock = out["clock"]
    ranges = {e.name: e.time_range for e in prof.events() if e.name.startswith("s")}
    gaps = []
    for name, t0, t1, _, _ in out["spans"]:
        mapped_us = (t0 - clock["perf_ns"] + clock["unix_ns"] - start_ns) / 1e3
        gaps.append(abs(mapped_us - ranges[name].start))
    # The median: a preemption between the two openings is not the clock's.
    assert len(gaps) == 20 and sorted(gaps)[10] < 200.0, gaps


@pytest.fixture(scope="module")
def traced_run(tmp_path_factory):
    """A 4-frame run on the CPU with the tracer on and a metrics log."""
    imgs, _, K = render_staircase_sequence(num_cameras=4, arc_degrees=18,
                                           image_size=(200, 150), focal=250.0)
    cfg = config.SfmConfig(
        fx=float(K[0, 0]), fy=float(K[1, 1]), cx=float(K[0, 2]), cy=float(K[1, 2]),
        downscale=1,
        frontend=config.FrontendConfig(max_features=512, num_octaves=3,
                                       contrast_threshold=0.015, lowe_ratio=0.75),
        ransac=config.RansacConfig(essential_iters=128, pnp_iters=128, homography_iters=128),
        map=config.MapConfig(max_cameras=8, max_points=4096),
        ba=config.BaConfig(enabled=True, max_iterations=BA_ITERS))
    path = tmp_path_factory.mktemp("traced") / "metrics.jsonl"
    sfm = IncrementalSfM(cfg, device="cpu", metrics=metrics.MetricsLogger(str(path)))
    with tracer_on():
        state = sfm.run(imgs)
        left = profiling.export()
    return imgs, sfm, state, path, left


def test_incremental_run_records_each_layer(traced_run):
    _, sfm, state, path, left = traced_run
    # Each record holds its frame's spans; the tracer's record stays whole.
    assert int(state.num_cams) == 4
    assert sum(v["calls"] for rec in sfm.stats for v in rec["spans"].values()) == len(
        left["spans"])
    boot, frames = sfm.stats[0], sfm.stats[1:]
    assert boot["frame"] == 1 and len(frames) == 2
    assert {"detect", "detect.scale_space", "detect.keypoints", "detect.describe", "bootstrap",
            "bootstrap.match", "bootstrap.essential", "bootstrap.homography",
            "bootstrap.triangulate"} <= set(boot["spans"])
    assert boot["spans"]["detect"]["calls"] == 2 and boot["counters"]["detect.frames"] == 2
    assert boot["counters"]["ransac.hypotheses"] == 2 * 128  # E and H
    for rec in frames:
        spans, counters = rec["spans"], rec["counters"]
        assert {"detect", "register", "register.match", "register.pnp", "register.triangulate",
                "register.append", "ba", "ba.lm", "ba.cg"} <= set(spans)
        assert spans["register"]["calls"] == 1 and spans["register.append"]["calls"] == 2
        assert spans["ba"]["calls"] == 1 and spans["ba.lm"]["calls"] == BA_ITERS
        assert counters["ba.lm_steps"] == BA_ITERS
        assert 0 <= counters["ba.accepted"] <= counters["ba.active"] <= BA_ITERS
        assert counters["ba.cg_steps"] == BA_ITERS * 20
        assert counters["register.tracked"] == rec["tracked"]
        assert counters["ransac.inliers"] == rec["pnp_inliers"]
        assert all(v["self_ms"] >= 0.0 for v in spans.values())
    with open(path) as fh:
        logged = [json.loads(line) for line in fh]
    assert [r["spans"] for r in logged if r["event"] == "frame"] == [
        r["spans"] for r in sfm.stats]


def test_a_run_that_keeps_no_trace_leaves_it_in_the_records(traced_run):
    imgs, sfm, _, _, _ = traced_run
    own = IncrementalSfM(sfm.config, device="cpu", keep_trace=False)  # as the CLI's
    with tracer_on():
        own.run(imgs[:3])
        left = profiling.export()
    assert left["spans"] == [] and left["counters"] == {}
    assert [r["counters"] for r in own.stats] == [r["counters"] for r in sfm.stats[:2]]
    assert [{k: v["calls"] for k, v in r["spans"].items()} for r in own.stats] == [
        {k: v["calls"] for k, v in r["spans"].items()} for r in sfm.stats[:2]]


def test_densify_map_records_mvs_spans(traced_run):
    imgs, _, state, _, _ = traced_run
    with tracer_on():
        pts, _ = mvs.densify_map(imgs, state, num_depths=8, batch=2)
        summary = profiling.summary(profiling.export())
    spans, n = summary["spans"], int(state.num_cams)
    assert spans["mvs"]["calls"] == 1 and summary["counters"]["mvs.views"] == n
    assert spans["mvs.ranges"]["calls"] == 1 and spans["mvs.stage"]["calls"] == 2
    assert spans["mvs.sweep"]["calls"] == spans["mvs.fuse"]["calls"] == spans["mvs.copy"][
        "calls"] == -(-n // 2)
    assert pts.shape[1] == 3 and pts.shape[0] > 0


def test_cli_leaves_the_tracer_as_it_found_it(tmp_path):
    profiling.disable()
    profiling.reset()
    assert cli.main(["--image-dir", str(tmp_path), "--out", str(tmp_path / "o"),
                     "--device", "cpu"]) == 2  # no images
    assert not profiling.enabled() and profiling.export()["spans"] == []


def test_paused_records_nothing_and_restores_the_tracer():
    with tracer_on():
        with profiling.span("outer"):
            with profiling.paused():
                assert not profiling.enabled()
                with profiling.span("hidden"):
                    profiling.count("n", torch.ones(()))
            profiling.count("m")
        assert profiling.enabled()
        rec = profiling.summary(profiling.export())
    assert set(rec["spans"]) == {"outer"} and rec["counters"] == {"m": 1}
    with profiling.paused():
        pass
    assert not profiling.enabled()
