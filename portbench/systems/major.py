"""Major cells: one shard's tables merged by the compaction strategy the
configuration names (``get_strategy``), a unit at a fixed schedule.

Set-up writes the runs once (``bench.py``'s generator, a frozen copy of
``chip_smoke.py`` ``build_bench_runs``, through the port's table
writer) and merges them once outside the window.  In the window a unit
is due every ``period_s``, the first a period after its start; a unit
due while the one before it still runs starts when that one ends, and
its time counts from its start.  A unit opens the runs, merges them
into a fresh output table and closes them.  The window ends when the
last unit started in it ends; ``major_ms`` is the mean wall time of its
units.

After each unit its output is read, hashed and deleted; the last
unit's bytes are kept for a record-by-record comparison.  Once the window
has closed, every unit's hashes and the kept output are held against
``reference/major_ref.py``.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np

from .. import isolation
from ..reference import major_ref, tables
from ..trace import span

OUT_EXTS = ("compact_data", "compact_index", "compact_bloom", "compact_sums")


def write_runs(dir_path: str, seed: int, total_keys: int, n_runs: int):
    """``build_bench_runs``: the runs of ``major_ref.bench_runs`` as
    SSTables (data, index and ``.sums``) through the port's writers."""
    from dbeel_tpu_torch.storage import checksums
    from dbeel_tpu_torch.storage.file_io import PageMirroringWriter

    indices = []
    for r, (keys, values, ts) in enumerate(
            major_ref.bench_runs(seed, total_keys, n_runs)):
        recs = tables.records_bytes(keys, values, ts)
        index = r * 2
        data_w = PageMirroringWriter(
            os.path.join(dir_path, tables.file_name(index, "data")),
            ("data", index), None)
        view = memoryview(recs.reshape(-1))
        for off in range(0, len(view), 32 << 20):
            data_w.write(view[off:off + (32 << 20)])
        size = data_w.close()
        index_w = PageMirroringWriter(
            os.path.join(dir_path, tables.file_name(index, "index")),
            ("index", index), None)
        index_w.write(tables.index_bytes(keys.shape[1], recs.shape[1],
                                         keys.shape[0]))
        index_w.close()
        checksums.write(dir_path, index, data_w.page_crcs,
                        index_w.page_crcs, size, None)
        indices.append(index)
    return indices


def merge_unit(strategy, dir_path, indices, out_index, bloom_min):
    from dbeel_tpu_torch.storage.sstable import SSTable

    sources = [SSTable(dir_path, i, None) for i in indices]
    try:
        result = strategy.merge(sources, dir_path, out_index, None, False,
                                bloom_min)
    finally:
        for s in sources:
            s.close()
    return result


def read_output(dir_path, out_index) -> dict:
    got = {}
    for key, ext in (("data", "compact_data"), ("index", "compact_index"),
                     ("bloom", "compact_bloom")):
        p = os.path.join(dir_path, tables.file_name(out_index, ext))
        if os.path.exists(p):  # no bloom file below bloom_min_size
            with open(p, "rb") as f:
                got[key] = f.read()
        else:
            got[key] = b""
    return got


def remove_output(dir_path, out_index):
    for ext in OUT_EXTS:
        p = os.path.join(dir_path, tables.file_name(out_index, ext))
        if os.path.exists(p):
            os.unlink(p)


def schedule(t0: float, seconds: float, period: float, unit, after,
             clock=time.monotonic, sleep=time.sleep):
    """Run ``unit(i)`` due at ``t0 + (i + 1) * period`` for every due
    time before ``t0 + seconds``; a unit due while the one before it
    still runs starts when that one ends.  ``after(unit's result)``
    runs between units, outside their times.  Returns each unit's
    (start, end): the window ends when the last unit started in it
    ends."""
    units = []
    i = 0
    while (i + 1) * period < seconds:
        wait = t0 + (i + 1) * period - clock()
        if wait > 0:
            with span("wait"):
                sleep(wait)
        a = clock()
        res = unit(i)
        units.append((a, clock()))
        after(res)
        i += 1
    return units


def major_ms(units) -> float:
    """The mean wall time of the units, in ms."""
    return 1e3 * float(np.mean([b - a for a, b in units]))


def run(ctx) -> dict:
    from dbeel_tpu_torch.storage.compaction import get_strategy

    cfg, mix = ctx.config, ctx.traffic
    if mix["generator"] != "schedule":
        raise ValueError(f"major cells run a schedule, not "
                         f"{mix['generator']}")
    d = os.path.join(ctx.workdir, "major")
    os.makedirs(d)
    total, n_runs = cfg["keys_per_unit"], cfg["runs"]
    try:
        indices = write_runs(d, ctx.seed, total, n_runs)
        strategy = get_strategy(cfg["compaction_backend"], device=ctx.device)
        bloom_min = cfg["bloom_min_size"]
        # One warm unit, checked with the window's.  The window opens
        # when its check is done; its first unit is due a period later,
        # as every later unit is due a period after the one before.
        merge_unit(strategy, d, indices, 1, bloom_min)
        digests = [{k: major_ref.digest(v)
                    for k, v in read_output(d, 1).items()}]
        remove_output(d, 1)

        digests_in_window = []

        def unit(i):
            out_index = 3 + 2 * i
            with span("merge"):
                merge_unit(strategy, d, indices, out_index, bloom_min)
            return out_index

        def check(out_index):
            nonlocal kept
            with span("check"):
                kept = read_output(d, out_index)
                remove_output(d, out_index)
                digests_in_window.append(
                    {k: major_ref.digest(v) for k, v in kept.items()})

        kept = None
        with ctx.window() as win:
            t0 = win.open()
            units = schedule(t0, ctx.seconds, mix["period_s"], unit, check)
        digests += digests_in_window
        mem = ctx.memory_peak()
        strategy_name = type(strategy).__name__
        del strategy

        # The reference, once the window has closed.
        runs = major_ref.bench_runs(ctx.seed, total, n_runs)
        want = major_ref.merge(runs, cfg["bloom_fp_rate"], bloom_min)
        want_digests = want.digests()
        detail = major_ref.compare(kept, want)
        durations = [b - a for a, b in units]
        n_in = n_runs * (total // n_runs)
        out = {
            "attempted": len(units), "failed": 0,
            "memory_peak_bytes": mem,
            "e2e": {"major_ms": major_ms(units),
                    "setup_s": t0 - ctx.t_start},
            "checks": {
                "units_differing": [sum(dg != want_digests
                                        for dg in digests), 0],
                "records_differing": [detail["records_differing"], 0],
                "index_entries_differing": [
                    detail["index_entries_differing"], 0],
                "bloom_bytes_differing": [detail["bloom_bytes_differing"],
                                          0],
            },
            "detail": {"units": len(units), "unit_ms": [
                round(1e3 * x, 3) for x in durations],
                "entries": want.entries, "strategy": strategy_name},
            "record": {"generator": {
                "units": len(units), "keys_in": n_in,
                "keys_out": want.entries, "runs": n_runs,
                "unit_s": durations}},
        }
    finally:
        shutil.rmtree(d, ignore_errors=True)
    out["modules"] = isolation.forbidden_modules()
    return out
