#!/usr/bin/env python3
"""Benchmark of dbeel_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names
a configuration, ``portbench/configs/<config>.json``, whose ``system``
names the module of ``portbench/systems/`` that sets it up and runs the
window, and a traffic mix, ``portbench/traffic/<traffic>.json``.  Each
per-layer metric is read by ``portbench/metrics/<name>.py``.  So a
later cell, mix or metric is added as files and entries alone.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``:
each number the correctness check compared, with its limit.  The
checks are also the last lines of standard error.

The run exits non-zero, and prints no result, without the cards the
cell asks for, or when its process holds JAX, the repository's JAX
package or msgpack once the window has closed.

``--rehearse`` (for the tests of ``portbench/tests``) runs the cell at
the sizes of its files' ``rehearse`` blocks, on the CPU, with the
kernels' plain versions; its line names the platform ``cpu``.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "portbench")
# The program's build caches stay at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import isolation  # noqa: E402
from portbench.trace import Profiler  # noqa: E402

DATA_EXTS = (".json", ".jsonl", ".toml", ".txt", ".csv")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def data_file(folder: str, name: str) -> str:
    for ext in DATA_EXTS:
        p = os.path.join(HERE, folder, name + ext)
        if os.path.exists(p):
            return p
    raise FileNotFoundError(f"portbench/{folder}/{name}.*")


def with_rehearsal(d: dict, rehearse: bool) -> dict:
    d = dict(d)
    block = d.pop("rehearse", {})
    if rehearse:
        d.update(block)
    return d


def metrics_for(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics,
    or with ``trace`` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", [cell]) and m["moves"] in names]


def load_reader(name: str):
    """``read`` of ``portbench/metrics/<name>.py``, found by file name."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Window:
    def __init__(self, profiler):
        self.profiler = profiler

    def open(self) -> float:
        """Mark the window's start; returns its time."""
        if self.profiler is not None:
            self.profiler.open_window()
        return time.monotonic()


class Context:
    """What a system module gets: the cell's files, its seed and window, and
    the window's profiler and clock."""

    def __init__(self, args, config, traffic, device, workdir):
        self.root = ROOT
        self.config = config
        self.traffic = traffic
        self.seed = args.seed
        self.seconds = args.seconds
        self.device = device
        self.cuda = device == "cuda"
        self.workdir = workdir
        self.t_start = T_START
        self.profiler = Profiler(workdir, self.cuda) if args.trace else None

    @contextlib.contextmanager
    def window(self):
        """The measured window, traced with ``--trace 1`` from entry to
        exit.  The system module calls the yielded object's ``open()`` where
        the window starts."""
        prof = self.profiler
        win = Window(prof)
        if prof is not None:
            prof.start()
        try:
            yield win
        finally:
            if prof is not None:
                prof.stop()

    def memory_peak(self) -> int:
        if not self.cuda:
            return 0
        import torch

        return int(torch.cuda.max_memory_allocated())


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rehearse", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = with_rehearsal(load_json(os.path.join(
        ROOT, configs[cell["config"]]["file"])), args.rehearse)
    traffic = with_rehearsal(load_json(data_file("traffic", cell["traffic"])),
                             args.rehearse)

    import torch

    if args.rehearse:
        device = "cpu"
        torch.set_num_threads(2)
    else:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device", file=sys.stderr)
            return 2
        if torch.cuda.device_count() < cell["chips"]:
            print(f"portbench: {cell['chips']} cards needed, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = "cuda"
        torch.cuda.reset_peak_memory_stats()
    system = importlib.import_module(f"portbench.systems.{config['system']}")
    workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        ctx = Context(args, config, traffic, device, workdir)
        out = system.run(ctx)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    held = sorted(set(out.get("modules", []))
                  | set(isolation.forbidden_modules()))
    if held:
        print(f"portbench: forbidden modules loaded: {held}", file=sys.stderr)
        return 3

    trace = ctx.profiler.summary if ctx.profiler is not None else None
    kind = torch.cuda.get_device_name(0) if device == "cuda" else "cpu"
    record = dict(out["record"], trace=trace, device_kind=kind)
    metrics = {}
    for m in metrics_for(bench, cell["name"], bool(args.trace)):
        if args.trace:
            value = load_reader(m["name"])(record)
        else:
            value = out["e2e"].get(m["name"])
        if value is None:
            if not args.trace:
                raise RuntimeError(f"no value for {m['name']}")
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    checks = out["checks"]
    correct = all(v <= limit for v, limit in checks.values())
    device_block = {"platform": "gpu" if device == "cuda" else "cpu",
                    "kind": kind,
                    "count": cell["chips"],
                    "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_block}
    if trace is not None:
        device_block["busy_s"] = trace["busy_s"]
        device_block["window_s"] = trace["window_s"]
        result["breakdown"] = {"device_ops": trace["device_ops"],
                               "idle_gaps": trace["idle_gaps"]}
    if "detail" in out:
        print(f"portbench: detail {json.dumps(out['detail'])}",
              file=sys.stderr)
    result["checks"] = {k: {"value": v, "limit": limit}
                        for k, (v, limit) in checks.items()}
    for k, (v, limit) in checks.items():
        print(f"check {k} {v} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
