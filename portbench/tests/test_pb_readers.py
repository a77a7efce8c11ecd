"""A per-layer metric is found by its file name alone: in a copy of
the benchmark, a new reader file and a BENCHMARK.json entry add a
metric, with no other file edited."""

import json
import os
import shutil

from .conftest import ROOT


def test_reader_added_by_files_alone(tmp_path, cell_runner):
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["per_layer"].append({
        "name": "units_in_window.major", "unit": "count",
        "better": "higher", "source": "host_clock", "layer": "pipeline",
        "moves": "major_ms", "workloads": ["shard1-kv16x64.major"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "portbench" / "metrics" / "units_in_window.major.py"
     ).write_text("def read(record):\n"
                  "    return record['generator']['units']\n")
    rc, line, err = cell_runner(
        "shard1-kv16x64.major", 9, trace=1, root=str(tmp_path),
        env={"PYTHONPATH": ROOT})
    assert rc == 0, err[-3000:]
    assert line["metrics"]["units_in_window.major"]["value"] >= 1
    assert line["metrics"]["units_in_window.major"]["unit"] == "count"


def test_reader_that_finds_nothing_is_left_out():
    import importlib.util

    path = os.path.join(ROOT, "portbench", "metrics",
                        "device_idle_share.major.py")
    spec = importlib.util.spec_from_file_location("r", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.read({"trace": None}) is None
    assert mod.read({"trace": {"span_s": {"merge": 2.0},
                               "span_busy_s": {"merge": 0.0}}}) is None
    assert mod.read({"trace": {"span_s": {"merge": 2.0},
                               "span_busy_s": {"merge": 0.5}}}) == 75.0
