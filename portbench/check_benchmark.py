#!/usr/bin/env python3
"""Check BENCHMARK.json against the rules its harness relies on.

    python3 portbench/check_benchmark.py [BENCHMARK.json]

Prints each fault found and exits 1, or prints ``ok`` and exits 0.
Checks names, units and the lengths of text fields; that every
configuration's file and every traffic mix exists and every
configuration has a cell; that no cell asks for more than one card;
that each per-layer metric has a reader, and names one ``moves`` that
every cell it is read in reports; that every cell reports ``setup_s``,
another end-to-end metric and a per-layer one; the bounds; and that a
full check of 24 cells at ``run_seconds`` fits its time.
"""

from __future__ import annotations

import json
import os
import re
import sys
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection",
               "head", "expansion", "experts_per_tok", "fieldlength",
               "fieldcount", "key_bytes", "value_bytes")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
DATA_EXTS = (".json", ".jsonl", ".toml", ".txt", ".csv")


def _text(faults, what, s):
    if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s \
            or "\t" in s:
        faults.append(f"{what}: 1 to 200 characters on one line")


def check(bench: dict, root: str = ROOT) -> List[str]:
    f: List[str] = []
    if set(bench) != TOP_KEYS:
        f.append(f"top-level keys {sorted(bench)}")
        return f
    paths = bench["paths"]
    if not 1 <= len(paths) <= 16 or not all(PATH.match(p) and ".." not in p
                                            for p in paths):
        f.append("paths: 1 to 16 relative paths")
    cmd = bench["command"]
    if not 1 <= len(cmd) <= 32:
        f.append("command: 1 to 32 words")
    for w in cmd:
        _text(f, "command word", w)
        if w.startswith("/") or ".." in w:
            f.append(f"command word {w!r} leaves the checkout")
    rs = bench["run_seconds"]
    if not isinstance(rs, int) or not 1 <= rs <= 51:
        f.append("run_seconds: a whole number from 1 to 51")
    elif (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 > 43200:
        f.append("run_seconds: a full check of 24 cells does not fit")

    configs = {c["name"]: c for c in bench["configs"]}
    if not 1 <= len(configs) <= 24 or len(configs) != len(bench["configs"]):
        f.append("configs: 1 to 24, names unique")
    for c in bench["configs"]:
        if set(c) != {"name", "source", "file", "reduced", "why"}:
            f.append(f"config {c.get('name')}: keys {sorted(c)}")
            continue
        if not NAME.match(c["name"]):
            f.append(f"config name {c['name']!r}")
        _text(f, f"config {c['name']} source", c["source"])
        _text(f, f"config {c['name']} why", c["why"])
        if not any(c["file"].startswith(p.rstrip("/") + "/") for p in paths):
            f.append(f"config {c['name']}: file outside paths")
        elif not os.path.exists(os.path.join(root, c["file"])):
            f.append(f"config {c['name']}: no file {c['file']}")
        else:
            with open(os.path.join(root, c["file"])) as fh:
                body = json.load(fh)
            if sorted(body.get("reduced", [])) != sorted(c["reduced"]):
                f.append(f"config {c['name']}: reduced differs from its "
                         "file's")
        if len(c["reduced"]) > 16:
            f.append(f"config {c['name']}: more than 16 reduced keys")
        for k in c["reduced"]:
            if not NAME.match(k) or k.endswith(("_dim", "_rank")) or any(
                    w in k for w in WIDTH_WORDS):
                f.append(f"config {c['name']}: reduced key {k!r} is a "
                         "width or no name")
    if len({c["file"] for c in bench["configs"]}) != len(configs):
        f.append("configs share a file")

    cells = {w["name"]: w for w in bench["workloads"]}
    if not 1 <= len(cells) <= 24 or len(cells) != len(bench["workloads"]):
        f.append("workloads: 1 to 24, names unique")
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != {"name", "config", "traffic", "chips", "why"}:
            f.append(f"workload {w.get('name')}: keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            if not NAME.match(str(w[k])):
                f.append(f"workload {w['name']}: {k} {w[k]!r}")
        _text(f, f"workload {w['name']} why", w["why"])
        if w["chips"] != 1:
            f.append(f"workload {w['name']}: asks for {w['chips']} chips")
        if w["config"] not in configs:
            f.append(f"workload {w['name']}: no config {w['config']}")
        if (w["config"], w["traffic"]) in pairs:
            f.append(f"workload {w['name']}: pair repeated")
        pairs.add((w["config"], w["traffic"]))
        if not any(os.path.exists(os.path.join(
                HERE, "traffic", w["traffic"] + e)) for e in DATA_EXTS):
            f.append(f"workload {w['name']}: no traffic file")
    for name in configs:
        if not any(w["config"] == name for w in bench["workloads"]):
            f.append(f"config {name}: no cell")

    names = set()
    reported = {w: set() for w in cells}
    for m in bench["end_to_end"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "bound",
                                      "source"}:
            f.append(f"metric {m.get('name')}: keys {sorted(m)}")
        _metric_common(f, m, names, cells)
        if m["source"] not in ("host_clock", "device_trace"):
            f.append(f"metric {m['name']}: end-to-end source")
        if not 0.01 <= m["bound"] <= 0.25:
            f.append(f"metric {m['name']}: bound outside 0.01-0.25")
        for w in m.get("workloads", cells):
            if w in reported:
                reported[w].add(m["name"])
    if not any(m["name"] == "setup_s" for m in bench["end_to_end"]):
        f.append("no setup_s")
    per_cell = {w: 0 for w in cells}
    layers = {}
    for m in bench["per_layer"]:
        if set(m) - {"workloads"} != {"name", "unit", "better", "source",
                                      "layer", "moves"}:
            f.append(f"metric {m.get('name')}: keys {sorted(m)}")
        _metric_common(f, m, names, cells)
        _text(f, f"metric {m['name']} layer", m["layer"])
        if not os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py")):
            f.append(f"metric {m['name']}: no reader")
        for w in m.get("workloads", [w for w in cells
                                     if m["moves"] in reported[w]]):
            if w not in cells:
                continue
            if m["moves"] not in reported[w]:
                f.append(f"metric {m['name']}: cell {w} does not report "
                         f"{m['moves']}")
            per_cell[w] += 1
        layers.setdefault(m["layer"].lower(), m["layer"])
        if layers[m["layer"].lower()] != m["layer"]:
            f.append(f"layer {m['layer']!r} spelled two ways")
    for w in cells:
        if "setup_s" not in reported[w] or len(reported[w]) < 2:
            f.append(f"workload {w}: needs setup_s and another end-to-end "
                     "metric")
        if not per_cell[w]:
            f.append(f"workload {w}: no per-layer metric")
    if len(json.dumps(bench)) > 64 * 1024:
        f.append("BENCHMARK.json over 64 KiB")
    return f


def _metric_common(f, m, names, cells):
    if not NAME.match(m["name"]) or m["name"] in names:
        f.append(f"metric name {m['name']!r} malformed or repeated")
    names.add(m["name"])
    if not UNIT.match(m["unit"]):
        f.append(f"metric {m['name']}: unit {m['unit']!r}")
    if m["better"] not in ("lower", "higher"):
        f.append(f"metric {m['name']}: better")
    if m["source"] not in ("device_trace", "program_span",
                           "program_counter", "host_clock"):
        f.append(f"metric {m['name']}: source")
    for w in m.get("workloads", []):
        if w not in cells:
            f.append(f"metric {m['name']}: no cell {w}")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path = argv[0] if argv else os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as fh:
        faults = check(json.load(fh), os.path.dirname(os.path.abspath(path)))
    for fault in faults:
        print(fault)
    if not faults:
        print("ok")
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
