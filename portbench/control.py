#!/usr/bin/env python3
"""The control of a major cell's correctness check: the reference put
in the program's place with one guarantee of the configuration broken,
held by the same comparison a run makes.  It has to come out as not
correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        [--rehearse]

prints one JSON line a seed: the numbers the run's check compares,
as the control reads them.  The control is the merged table with its
bloom filter sized for twice the configuration's false-positive rate
(a smaller, cheaper filter, the step that would tempt a later change).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.reference import major_ref  # noqa: E402
from portbench.run import load_json, with_rehearsal  # noqa: E402


def major_control(cfg, seed):
    runs = major_ref.bench_runs(seed, cfg["keys_per_unit"], cfg["runs"])
    want = major_ref.merge(runs, cfg["bloom_fp_rate"], cfg["bloom_min_size"])
    ctl = major_ref.merge(runs, 2 * cfg["bloom_fp_rate"],
                          cfg["bloom_min_size"])
    got = {"data": ctl.data, "index": ctl.index, "bloom": ctl.bloom}
    out = major_ref.compare(got, want)
    out["units_differing"] = int(ctl.digests() != want.digests())
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = with_rehearsal(load_json(os.path.join(ROOT, conf["file"])),
                         args.rehearse)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": major_control(cfg, seed)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
