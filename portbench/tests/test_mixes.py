"""Each cell runs end to end at a tiny size on the CPU and prints the
contract's line; the card's numbers are left out there."""

import json
import math

import pytest

from portbench.tests import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cell_runs_end_to_end(cell, trace):
    res = tiny.run_tiny(cell, trace=trace, seconds=8.0 if trace else 5.0)
    keys = list(res)
    assert keys[:5] == KEYS and keys[-1] == "checks"
    assert json.loads(json.dumps(res)) == res
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for c in res["checks"].values():
        assert math.isfinite(c["value"]) and c["value"] <= c["limit"]
    mine = [m for m in (tiny.MANIFEST["per_layer"] if trace else tiny.MANIFEST["end_to_end"])
            if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in mine}
    assert set(res["metrics"]) <= names
    if trace:
        assert "breakdown" in res and res["device"]["window_s"] > 0
        # On the CPU there is no device trace: no device metric is reported,
        # and every metric of the harness's host-clock spans is.
        by_source = lambda s: {m["name"] for m in mine if m["source"] == s}  # noqa: E731
        assert not by_source("device_trace") & set(res["metrics"])
        assert by_source("host_clock") <= set(res["metrics"])
    else:
        assert names == set(res["metrics"])
        assert all(m["value"] > 0 for m in res["metrics"].values())


def test_the_same_seed_gives_the_same_inputs():
    import torch

    from portbench import pipeline
    from portbench.harness import Context

    cell, cfg, tr = tiny.tiny_files("fountain11-incremental")
    make = lambda seed: pipeline.render(Context(cell, cfg, tr, seed, 1.0, False,  # noqa: E731
                                                torch.device("cpu"), 0.0))
    a, b, c = make(2**40 + 3), make(2**40 + 3), make(2**40 + 4)
    assert torch.equal(a.images, b.images) and not torch.equal(a.images, c.images)
