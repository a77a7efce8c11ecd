"""The major cells' reference: the merged table a major compaction of
the bench runs has to write, byte for byte, worked out in NumPy.

The runs are ``bench.py``'s fixed-size generator (a frozen copy of
``chip_smoke.py`` ``build_bench_runs``): ``n_runs`` runs of uniform
random 16-byte keys, each run sorted, 64-byte values derived from the
key, timestamps by run and position.  The merge orders every record by
its key bytewise, keeps the newest timestamp of a key (ties to the
newer run) and writes the data, index and bloom files of
``reference/tables.py``'s format.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Dict

import numpy as np

from . import tables

KEY_BYTES = 16
VALUE_BYTES = 64
RECORD = tables.HEADER + KEY_BYTES + VALUE_BYTES


def bench_run(rng: np.random.Generator, r: int, per_run: int,
              total_keys: int):
    """Run ``r``: (keys, values, timestamps), in the run's key order.
    ``rng`` is shared by the runs and drawn from in run order."""
    keys = rng.integers(0, 256, size=(per_run, KEY_BYTES), dtype=np.uint8)
    kv = np.ascontiguousarray(keys).view(">u8").reshape(per_run, 2)
    keys = keys[np.lexsort((kv[:, 1], kv[:, 0]))]
    ts = (np.int64(r) * total_keys + np.arange(per_run)).astype("<i8")
    values = np.repeat(
        (keys[:, :8].astype(np.uint16).sum(axis=1) % 251).astype(
            np.uint8)[:, None], VALUE_BYTES, axis=1)
    return keys, values, ts


def bench_runs(seed: int, total_keys: int, n_runs: int):
    rng = np.random.default_rng(seed)
    per_run = total_keys // n_runs
    return [bench_run(rng, r, per_run, total_keys) for r in range(n_runs)]


@dataclass
class Expected:
    data: bytes
    index: bytes
    bloom: bytes
    entries: int

    def digests(self) -> Dict[str, str]:
        return {"data": digest(self.data), "index": digest(self.index),
                "bloom": digest(self.bloom)}


def digest(blob) -> str:
    return hashlib.blake2b(blob, digest_size=16).hexdigest()


def merge(runs, fp_rate: float = 0.01, bloom_min: int = 1) -> Expected:
    """The merged table of ``runs`` (oldest first); its bloom file is
    empty below ``bloom_min`` bytes of data, as none is written."""
    keys = np.concatenate([k for k, _, _ in runs])
    values = np.concatenate([v for _, v, _ in runs])
    ts = np.concatenate([t for _, _, t in runs])
    src = np.concatenate([np.full(len(t), i) for i, (_, _, t) in
                          enumerate(runs)])
    kv = np.ascontiguousarray(keys).view(">u8").reshape(-1, 2)
    # Key ascending, then newest timestamp, then newest run first.
    order = np.lexsort((-src, -ts, kv[:, 1], kv[:, 0]))
    kv_o = kv[order]
    first = np.ones(order.size, bool)
    first[1:] = np.any(kv_o[1:] != kv_o[:-1], axis=1)
    order = order[first]
    out_keys = keys[order]
    recs = tables.records_bytes(out_keys, values[order], ts[order])
    return Expected(
        data=recs.tobytes(),
        index=tables.index_bytes(KEY_BYTES, RECORD, order.size),
        bloom=(tables.bloom_bytes(out_keys, fp_rate)
               if recs.size >= bloom_min else b""),
        entries=int(order.size),
    )


def compare(got: Dict[str, bytes], want: Expected) -> Dict[str, int]:
    """Record-level differences between a written table (``got``:
    ``data``, ``index``, ``bloom`` file bytes) and the reference."""
    out: Dict[str, int] = {}
    gd = np.frombuffer(got["data"], np.uint8)
    wd = np.frombuffer(want.data, np.uint8)
    n_want = want.entries
    if gd.size % RECORD or gd.size != wd.size:
        out["records_differing"] = n_want
    else:
        g = gd.reshape(-1, RECORD)
        w = wd.reshape(-1, RECORD)
        out["records_differing"] = int(np.any(g != w, axis=1).sum())
    gi = np.frombuffer(got["index"], np.uint8)
    wi = np.frombuffer(want.index, np.uint8)
    if gi.size != wi.size:
        out["index_entries_differing"] = n_want
    else:
        out["index_entries_differing"] = int(
            np.any(gi.reshape(-1, 16) != wi.reshape(-1, 16), axis=1).sum())
    gb = np.frombuffer(got["bloom"], np.uint8)
    wb = np.frombuffer(want.bloom, np.uint8)
    out["bloom_bytes_differing"] = (
        int(np.count_nonzero(gb != wb)) if gb.size == wb.size
        else max(gb.size, wb.size))
    return out
