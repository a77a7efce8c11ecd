"""BENCHMARK.json passes its checker, and the checker refuses the
faults it is there for."""

import copy
import json
import os

import pytest

from portbench import check_benchmark

from .conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)


def test_benchmark_json_passes():
    assert check_benchmark.check(BENCH, ROOT) == []


def _set(path, value):
    def edit(b):
        node = b
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value
    return edit


@pytest.mark.parametrize("edit", [
    _set(["workloads", 0, "name"], "has space"),
    _set(["workloads", 0, "chips"], 4),
    _set(["end_to_end", 0, "unit"], "operations per second"),
    _set(["end_to_end", 0, "bound"], 0.3),
    _set(["per_layer", 0, "moves"], "ops_per_s"),
    _set(["per_layer", 0, "name"], "no_reader_for_this"),
    _set(["run_seconds", ], 52),
    _set(["configs", 0, "reduced"], ["hidden_size"]),
    _set(["configs", 0, "why"], ""),
    lambda b: b["configs"][0].pop("why"),
])
def test_checker_refuses(edit):
    bench = copy.deepcopy(BENCH)
    edit(bench)
    assert check_benchmark.check(bench, ROOT)


def test_config_without_cell_refused():
    bench = copy.deepcopy(BENCH)
    bench["configs"].append(dict(bench["configs"][0], name="lonely",
                                 file="portbench/configs/lonely.json"))
    assert any("no cell" in f for f in check_benchmark.check(bench, ROOT))
