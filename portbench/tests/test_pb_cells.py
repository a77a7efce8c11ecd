"""Every cell of BENCHMARK.json runs at its rehearsal size on the CPU
and prints one result line of the benchmark's shape."""

import json
import os

import pytest

from .conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_prints_one_result_line(cell, trace, cell_runner):
    rc, line, err = cell_runner(cell, 3_000_000_123 + trace, trace=trace)
    assert rc == 0, err[-3000:]
    assert line is not None, err[-3000:]
    assert list(line)[-1] == "checks"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in line
    assert line["correct"] is True, err[-3000:]
    assert line["device"]["platform"] == "cpu"
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if cell in m.get("workloads", [cell])}
    if trace:
        assert "breakdown" in line
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["metrics"]) <= {m["name"] for m in
                                        BENCH["per_layer"]}
    else:
        assert set(line["metrics"]) == e2e
        assert line["attempted"] > 0
    # The checks are the last lines of standard error, each with its
    # limit.
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_unknown_workload_fails(cell_runner):
    rc, line, _ = cell_runner("no-such.cell", 1)
    assert rc != 0 and line is None
