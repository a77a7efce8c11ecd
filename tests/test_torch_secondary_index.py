"""Secondary indexes in dbeel_tpu_torch against dbeel_tpu on the same
seeded inputs: the ``.fidx`` run format, its emission by every flush and
merge route, the compaction journal that carries it, the quarantine of a
corrupt run, and the planner behind ``scan_filter_page``'s "indexed"
eval path.  The port runs with ``device="cpu"`` (the kernels' plain
versions), dbeel_tpu on JAX-CPU; the tolerance is byte-identity
throughout (SHA-256 of the files, equal pages and masks).

The first four cases are tests/test_secondary_index.py's storage-level
cases run against the port.  Its DDL case
(``test_index_ddl_round_trips_metadata``) needs a ``ClusterNode`` of the
port and waits for the server to be ported (ROADMAP.md Queue 1 item
5(c)).
"""

import asyncio
import hashlib
import os
import random
import shutil

import msgpack
import numpy as np
import pytest

from dbeel_tpu.ops import device_compaction as jdc
from dbeel_tpu.ops import sort as jsort
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import secondary_index as jsi
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu_torch import query as Q
from dbeel_tpu_torch.errors import CorruptedFile
from dbeel_tpu_torch.ops import device_compaction as tdc
from dbeel_tpu_torch.ops import pipeline as tpipe
from dbeel_tpu_torch.ops import sort as tsort
from dbeel_tpu_torch.storage import checksums
from dbeel_tpu_torch.storage import native as tnative
from dbeel_tpu_torch.storage import secondary_index as si
from dbeel_tpu_torch.storage.compaction import (
    HeapMergeStrategy,
    compaction_stats,
)
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.storage.entry import COMPACT_ACTION_FILE_EXT, file_name
from dbeel_tpu_torch.storage.lsm_tree import QUARANTINE_DIR
from dbeel_tpu_torch.storage.lsm_tree import LSMTree as TTree
from dbeel_tpu_torch.storage.sstable import SSTable

from conftest import run
from test_scan_plane import _random_doc, _random_where

FIELDS = ["n", "s"]


def LSMTree(d, **kw):
    """The port's tree on the CPU: the device strategy's plain kernels."""
    kw.setdefault("strategy", tget("device", device="cpu"))
    return TTree.open_or_create(d, device="cpu", **kw)


async def _fill(tree, rng, n=600, key_space=900):
    for i in range(n):
        k = rng.randrange(key_space)
        await tree.set_with_timestamp(
            msgpack.packb(f"k{k:05d}"),
            msgpack.packb(_random_doc(rng, i)),
            1000 + i,
        )


async def _page_all(tree, where, agg, limit=128, max_bytes=1 << 20):
    """Drain a filtered scan page by page (mid-scan cursor resume via
    start_after=cover), collecting entries, per-page accounting and
    eval paths."""
    out, covers, paths, partials, sa = [], [], [], [], None
    while True:
        (
            es, more, cover, srows, sbytes, partial, path,
        ) = await tree.scan_filter_page(
            0, 0, sa, None, limit, max_bytes, True,
            where, agg, Q.MODE_DROP,
        )
        out.extend(es)
        covers.append((cover, srows, sbytes))
        paths.append(path)
        if partial is not None:
            partials.append(partial)
        if not more:
            return out, covers, paths, partials
        sa = cover


def _sha(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _digest(d, exts=None):
    """{file name: SHA-256} of the live files (``exts`` filters by
    extension)."""
    out = {}
    for name in sorted(os.listdir(d)):
        p = os.path.join(d, name)
        if os.path.isfile(p) and (
            exts is None or name.rsplit(".", 1)[-1] in exts
        ):
            out[name] = _sha(p)
    return out


# ---------------------------------------------------------------------
# Inline emission + maintenance accounting
# ---------------------------------------------------------------------


def test_flush_and_compact_emit_runs_inline(tmp_dir):
    """Flush and compaction both emit fidx runs in the SAME pass as
    the data: no extra data-byte reads (per-pass bytes_read delta
    still equals the merge input bytes), and the maintenance cost is
    reported as index_maintenance_amplification."""

    async def main():
        rng = random.Random(17001)
        before = compaction_stats.stats()
        idx_before = si.index_stats.stats()
        d = tmp_dir + "/t"
        tree = LSMTree(
            d, capacity=256, index_fields=FIELDS, memtable_kind="sorted",
        )
        try:
            await _fill(tree, rng, n=500)
            await tree.flush()
            live = [i for i, _ in tree.sstable_indices_and_sizes()]
            assert len(live) >= 2
            for i in live:
                fidx, fsums = si.run_paths(d, i)
                assert os.path.exists(fidx), i
                assert os.path.exists(fsums), i
                assert si.load_run(d, i) is not None, i
            await tree.compact(live, max(live) + 1, False)
            out = max(live) + 1
            now = [i for i, _ in tree.sstable_indices_and_sizes()]
            assert now == [out]
            # Lockstep retirement: input runs went with their tables.
            for i in live:
                assert not os.path.exists(si.run_paths(d, i)[0])
            assert si.load_run(d, out) is not None
            after = compaction_stats.stats()
            idx_after = si.index_stats.stats()
            # Zero extra data reads: this pass read exactly its
            # inputs even though it also built the index run.
            assert (
                after["bytes_read"] - before["bytes_read"]
                == after["merge_input_bytes"] - before["merge_input_bytes"]
            )
            assert after["sidecar_posthoc"] == before["sidecar_posthoc"]
            assert (
                after["index_bytes_written"] > before["index_bytes_written"]
            )
            assert after["index_maintenance_amplification"] is not None
            assert idx_after["runs_built"] > idx_before["runs_built"]
            assert idx_after["runs_merged"] > idx_before["runs_merged"]
        finally:
            tree.close()

    run(main(), timeout=60)


# ---------------------------------------------------------------------
# Crash safety: the run rides the SAME journaled rename set
# ---------------------------------------------------------------------


def test_crash_mid_compaction_index_rides_journal(tmp_dir):
    """Crash after the journal fsync with only the data rename
    applied.  Recovery replays the journal; because the compact_fidx
    renames ride the SAME action, the live output can never end up
    with a data triplet but no index run, and the indexed scan still
    matches the non-indexed path after reopen."""

    async def main():
        rng = random.Random(17002)
        d = tmp_dir + "/t"
        tree = LSMTree(
            d, capacity=256, index_fields=FIELDS, memtable_kind="sorted",
        )
        await _fill(tree, rng, n=400)
        await tree.flush()
        live = [i for i, _ in tree.sstable_indices_and_sizes()]
        assert len(live) >= 2
        tree.close()

        out = max(live) + 1
        srcs = [SSTable(d, i, None) for i in live]
        strategy = HeapMergeStrategy()
        strategy.index_fields = FIELDS
        strategy.merge(srcs, d, out, None, False, 1 << 30)

        def p(idx, ext):
            return os.path.join(d, file_name(idx, ext))

        assert os.path.exists(p(out, "compact_fidx"))
        renames = [
            [p(out, "compact_data"), p(out, "data")],
            [p(out, "compact_index"), p(out, "index")],
            [p(out, "compact_sums"), p(out, "sums")],
            [p(out, "compact_fidx"), p(out, "fidx")],
            [p(out, "compact_fidx_sums"), p(out, "fidx_sums")],
        ]
        deletes = [q for t in srcs for q in t.paths()]
        for t in srcs:
            t.close()
        action_path = p(out, COMPACT_ACTION_FILE_EXT)
        with open(action_path, "wb") as f:
            f.write(msgpack.packb({"renames": renames, "deletes": deletes}))
            f.flush()
            os.fsync(f.fileno())
        # CRASH: only the data rename landed.
        os.replace(*renames[0])

        tree = LSMTree(
            d, capacity=256, index_fields=FIELDS, memtable_kind="sorted",
        )
        try:
            assert not os.path.exists(action_path)
            now = [i for i, _ in tree.sstable_indices_and_sizes()]
            assert now == [out]
            assert checksums.load(d, out) is not None
            assert si.load_run(d, out) is not None
            for i in live:
                assert not os.path.exists(p(i, "data"))
                assert not os.path.exists(si.run_paths(d, i)[0])
            where = Q.validate_where(["cmp", "n", ">=", 0])
            got = await _page_all(tree, where, None)
            assert got[2]
            tree.index_fields = None
            tree._drop_scan_stage()
            golden = await _page_all(tree, where, None)
            assert got[0] == golden[0]
            assert got[1] == golden[1]
        finally:
            tree.close()

    run(main(), timeout=60)


# ---------------------------------------------------------------------
# Corruption containment: run quarantines alone, retryably
# ---------------------------------------------------------------------


def test_bitflip_index_run_quarantines_retryably(tmp_dir):
    """A bit-flipped fidx run fails its CRC sidecar: the FIRST
    indexed scan errors retryably (CorruptedFile tagged
    index_run_only), the run — and only the run — moves to
    quarantine/, and the RETRY serves correct results off the data
    triplet, which never stops serving point reads."""

    async def main():
        d = tmp_dir + "/t"
        tree = LSMTree(
            d, capacity=4096, index_fields=FIELDS, memtable_kind="sorted",
        )
        docs = {}
        for i in range(800):
            k = f"k{i:05d}"
            doc = {"n": i % 37, "s": f"user{i:04d}", "i": i}
            docs[k] = doc
            await tree.set_with_timestamp(
                msgpack.packb(k), msgpack.packb(doc), 1000 + i
            )
        await tree.flush()
        live = [i for i, _ in tree.sstable_indices_and_sizes()]
        assert len(live) == 1
        tidx = live[0]
        tree.close()

        fidx_p, _ = si.run_paths(d, tidx)
        blob = bytearray(open(fidx_p, "rb").read())
        blob[len(blob) // 2] ^= 0x40
        with open(fidx_p, "wb") as f:
            f.write(bytes(blob))

        tree = LSMTree(
            d, capacity=4096, index_fields=FIELDS, memtable_kind="sorted",
        )
        try:
            q_before = si.index_stats.stats()["runs_quarantined"]
            where = Q.validate_where(["cmp", "n", "==", 5])
            with pytest.raises(CorruptedFile) as ei:
                await tree.scan_filter_page(
                    0, 0, None, None, 1000, 1 << 20, True,
                    where, None, Q.MODE_DROP,
                )
            assert getattr(ei.value, "index_run_only", False)
            assert (
                si.index_stats.stats()["runs_quarantined"] == q_before + 1
            )
            qdir = os.path.join(d, QUARANTINE_DIR)
            for _ in range(100):
                if not os.path.exists(fidx_p):
                    break
                await asyncio.sleep(0.02)
            assert not os.path.exists(fidx_p)
            assert os.path.exists(os.path.join(qdir, os.path.basename(fidx_p)))
            assert os.path.exists(os.path.join(d, file_name(tidx, "data")))
            live_now = [i for i, _ in tree.sstable_indices_and_sizes()]
            assert live_now == [tidx], "data table was poisoned"

            es, _m, _c, _srows, _b, _p1, path = await tree.scan_filter_page(
                0, 0, None, None, 1000, 1 << 20, True,
                where, None, Q.MODE_DROP,
            )
            assert path != "indexed"
            want = sorted(k for k, doc in docs.items() if doc["n"] == 5)
            got = sorted(msgpack.unpackb(e[0], raw=False) for e in es)
            assert got == want
            v = await tree.get(msgpack.packb("k00007"))
            assert msgpack.unpackb(v, raw=False) == docs["k00007"]
        finally:
            tree.close()

    run(main(), timeout=60)


# ---------------------------------------------------------------------
# Byte-identity: randomized specs, indexed vs non-indexed
# ---------------------------------------------------------------------


def test_randomized_specs_indexed_byte_identical(tmp_dir):
    """On randomized adversarial specs over an adversarial doc mix,
    paging the indexed planner produces byte-identical entries, covers
    and scanned accounting — mid-scan cursor resume included — to the
    same tree scanned with indexes disabled.  The planner must engage
    at least once, or the test is vacuous."""

    async def main():
        rng = random.Random(17004)
        d = tmp_dir + "/t"
        tree = LSMTree(
            d, capacity=512, index_fields=FIELDS, memtable_kind="sorted",
        )
        try:
            await _fill(tree, rng, n=700)
            await tree.flush()
            live = [i for i, _ in tree.sstable_indices_and_sizes()]
            await tree.compact(live, max(live) + 1, False)
            # Post-compaction writes: the memtable source must stay
            # all-candidates without breaking identity.
            for i in range(60):
                await tree.set_with_timestamp(
                    msgpack.packb(f"k{rng.randrange(900):05d}"),
                    msgpack.packb(_random_doc(rng, -i)),
                    50000 + i,
                )
            hits_before = si.index_stats.stats()["planner_hits"]
            for trial in range(14):
                where = Q.validate_where(_random_where(rng))
                agg = None
                if trial % 4 == 3:
                    agg = Q.validate_agg({"op": "count", "group": 0})
                limit = rng.choice([64, 256])
                max_bytes = rng.choice([4096, 1 << 20])
                got = await _page_all(tree, where, agg, limit, max_bytes)
                tree.index_fields = None
                tree._drop_scan_stage()
                try:
                    golden = await _page_all(
                        tree, where, agg, limit, max_bytes
                    )
                finally:
                    tree.index_fields = FIELDS
                    tree._drop_scan_stage()
                assert got[0] == golden[0], (trial, where)
                assert got[1] == golden[1], (trial, where)
                if agg is not None:

                    def fold(partials):
                        st = Q.AggState(agg)
                        for p in partials:
                            st.fold_partial(p)
                        return st.result()

                    assert fold(got[3]) == fold(golden[3]), (trial, where)
            assert si.index_stats.stats()["planner_hits"] > hits_before, (
                "planner never engaged — identity test is vacuous"
            )
        finally:
            tree.close()

    run(main(), timeout=120)


# ---------------------------------------------------------------------
# The run format against dbeel_tpu
# ---------------------------------------------------------------------


def _adversarial_rows(seed, n=400):
    """(data offset, value) rows over every lane rule: bools, ints
    beyond 2^53 and float64's range edge, NaN and infinities, bytes
    with embedded and trailing NULs, strings past the prefix width,
    missing fields, non-scalars, non-map documents and tombstones."""
    rng = random.Random(seed)
    specials = [
        True, False, None, (1 << 63) - 1, -(1 << 63), (1 << 64) - 1,
        (1 << 53) + 1, float("nan"), float("inf"), float("-inf"), -0.0,
        1.7976931348623157e308, 5e-324, b"", b"\x00", b"a\x00b",
        b"x" * 40, "é" * 9, "", [1, 2], {"a": 1},
    ]
    rows, off = [], 0
    for i in range(n):
        roll = rng.random()
        if roll < 0.05:
            value = b""  # tombstone
        elif roll < 0.1:
            value = msgpack.packb(i)  # not a map
        elif roll < 0.15:
            value = b"\xc1not msgpack"  # undecodable
        else:
            doc = _random_doc(rng, i)
            if isinstance(doc, dict) and rng.random() < 0.4:
                doc[rng.choice(FIELDS)] = rng.choice(specials)
            value = msgpack.packb(doc)
        rows.append((off, value))
        off += 16 + 8 + len(value)
    return rows


@pytest.mark.parametrize("seed", range(4))
def test_run_blob_and_emit_equal_reference(tmp_dir, seed):
    rows = _adversarial_rows(seed)
    fields = FIELDS + ["i", "missing"]
    got, n_got = si.build_run_blob(fields, rows)
    want, n_want = jsi.build_run_blob(fields, rows)
    assert n_got == n_want > 0
    assert hashlib.sha256(got).hexdigest() == hashlib.sha256(want).hexdigest()
    for compact in (False, True):
        shas = []
        for mod, sub in ((si, "t"), (jsi, "j")):
            d = os.path.join(tmp_dir, f"{sub}{int(compact)}")
            os.makedirs(d)
            nb = mod.emit_run(d, 6, fields, rows, compact=compact)
            assert nb == len(got)
            shas.append([_sha(p) for p in mod.run_paths(d, 6, compact)])
        assert shas[0] == shas[1]
    # Each package loads the other's run to the same lanes.
    for loader, d in ((si, f"{tmp_dir}/j0"), (jsi, f"{tmp_dir}/t0")):
        a = loader.load_run(d, 6)
        b = si._parse_run(got, "blob")
        assert sorted(a.fields) == sorted(b.fields) == sorted(fields)
        for f in fields:
            for x, y in zip(a.fields[f], b.fields[f]):
                assert x.tobytes() == y.tobytes()
    assert si.sanitize_index_fields(["s", "$key", b"n", "s", 3]) == \
        jsi.sanitize_index_fields(["s", "$key", b"n", "s", 3]) == ["n", "s"]


def test_candidate_mask_equal_reference(tmp_dir):
    """The planner of both packages, on the same tree's stage and runs,
    gives the same candidate masks (or the same miss)."""

    async def build(tree):
        rng = random.Random(17005)
        await _fill(tree, rng, n=900, key_space=1200)
        await tree.flush()
        live = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(live[:2], live[1] + 1, True)
        for i in range(40):
            await tree.set_with_timestamp(
                msgpack.packb(f"k{rng.randrange(1200):05d}"),
                msgpack.packb(_random_doc(rng, -i)),
                90000 + i,
            )
        stage = await tree._current_scan_stage()
        return stage, await tree._load_index_runs(stage)

    async def main():
        jt = JTree.open_or_create(
            f"{tmp_dir}/j", capacity=256, index_fields=FIELDS,
            strategy=jget("heap"),
        )
        tt = LSMTree(f"{tmp_dir}/t", capacity=256, index_fields=FIELDS)
        try:
            jstage, jruns = await build(jt)
            tstage, truns = await build(tt)
            assert sorted(jruns) == sorted(truns) and truns
            rng = random.Random(3)
            hits = 0
            for _ in range(60):
                where = Q.validate_where(_random_where(rng))
                a = si.candidate_mask(tstage, where, truns, FIELDS)
                b = jsi.candidate_mask(jstage, where, jruns, FIELDS)
                assert (a is None) == (b is None), where
                if a is not None:
                    hits += 1
                    assert np.array_equal(a, b), where
            assert hits > 0
        finally:
            jt.close()
            tt.close()

    run(main(), timeout=60)


# ---------------------------------------------------------------------
# Every route that writes a run, against dbeel_tpu
# ---------------------------------------------------------------------

# route -> (port tree kwargs, dbeel_tpu tree kwargs, compacts)
ROUTES = {
    "heap": (dict(strategy=lambda: tget("heap")),
             dict(strategy=lambda: jget("heap")), True),
    "cpu": (dict(strategy=lambda: tget("cpu")),
            dict(strategy=lambda: jget("cpu")), True),
    "device": (dict(strategy=lambda: tget("device", device="cpu")),
               dict(strategy=lambda: jget("device")), True),
    "device_k4": (dict(strategy=lambda: tget("device", device="cpu")),
                  dict(strategy=lambda: jget("device")), True),
    "sorted": (dict(memtable_kind="sorted"),
               dict(memtable_kind="sorted"), False),
    "hash": (dict(memtable_kind="hash"), dict(memtable_kind="hash"), False),
    "arena": (dict(memtable_kind="arena"),
              dict(memtable_kind="arena"), False),
}


async def _route_script(tree, n, key_fmt, compacts):
    rng = random.Random(17006)
    for i in range(n):
        await tree.set_with_timestamp(
            msgpack.packb(key_fmt % rng.randrange(1 << 20)),
            msgpack.packb(_random_doc(rng, i)),
            1000 + i,
        )
        if i % 97 == 0:
            await tree.delete_with_timestamp(
                msgpack.packb(key_fmt % rng.randrange(1 << 20)), 1000 + i
            )
    await tree.flush()
    live = [i for i, _ in tree.sstable_indices_and_sizes()]
    assert len(live) >= 2
    if compacts:
        await tree.compact(live, max(live) + 1, False)
    tree.close()


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_runs_equal_reference(tmp_dir, monkeypatch, route):
    """Each route writes ``.fidx``/``.fidx_sums`` SHA-256-equal to
    dbeel_tpu's: the heap, cpu and device (K3; K4 on a tie-heavy
    keyspace) merges, and the sorted, hash (K5) and arena flushes."""
    port_kw, ref_kw, compacts = ROUTES[route]
    if route == "arena" and tnative.load() is None:
        pytest.skip("the arena memtable needs the native host runtime")
    calls = {"k3": 0, "k4": 0, "k5": 0}
    real_single = tdc.DeviceMergeStrategy._merge_single_shot
    real_full = tdc.DeviceFullMergeStrategy.sort_and_dedup
    real_sort = tsort._device_sort

    def single(self, *a, **kw):
        calls["k3"] += 1
        return real_single(self, *a, **kw)

    def full(self, cols):
        calls["k4"] += 1
        return real_full(self, cols)

    def sort(items, dev):
        calls["k5"] += 1
        return real_sort(items, dev)

    monkeypatch.setattr(tdc.DeviceMergeStrategy, "_merge_single_shot", single)
    monkeypatch.setattr(tdc.DeviceFullMergeStrategy, "sort_and_dedup", full)
    monkeypatch.setattr(tsort, "_device_sort", sort)
    for mod in (jsort, tsort):
        monkeypatch.setattr(mod, "DEVICE_THRESHOLD", 64)
    # A keyspace whose keys share their first 8 bytes sends the device
    # merge's tie refinement to K4.
    key_fmt = "user:%012d" if route == "device_k4" else "k%07d"
    n = 1400 if route == "device_k4" else 700

    def opened(cls, d, kw, **extra):
        kw = {k: (v() if callable(v) else v) for k, v in kw.items()}
        return cls.open_or_create(
            d, capacity=256, bloom_min_size=2048, index_fields=FIELDS,
            **kw, **extra,
        )

    if "strategy" not in port_kw:
        port_kw = dict(port_kw, strategy=lambda: tget("heap"))
        ref_kw = dict(ref_kw, strategy=lambda: jget("heap"))
    asyncio.run(_route_script(
        opened(JTree, f"{tmp_dir}/j", ref_kw), n, key_fmt, compacts))
    asyncio.run(_route_script(
        opened(TTree, f"{tmp_dir}/t", port_kw, device="cpu"),
        n, key_fmt, compacts))
    runs = _digest(f"{tmp_dir}/t", ("fidx", "fidx_sums"))
    assert runs and runs == _digest(f"{tmp_dir}/j", ("fidx", "fidx_sums"))
    assert _digest(f"{tmp_dir}/t", ("data", "index", "sums")) == \
        _digest(f"{tmp_dir}/j", ("data", "index", "sums"))
    if compacts:
        assert len(runs) == 2  # the compacted output's run + sidecar
    want = {"device": (1, 0, 0), "device_k4": (1, 1, 0),
            "hash": (0, 0, 1)}.get(route, (0, 0, 0))
    assert (calls["k3"], calls["k4"], min(calls["k5"], 1)) == want


def test_pipeline_route_emits_no_run_in_either_package(tmp_dir, monkeypatch):
    """Merges of PIPELINE_MIN_BYTES or more take the pipeline (K1/K2),
    which writes no index run in dbeel_tpu; the port matches it, and
    the planner then misses on that table while the scan still equals
    the non-indexed path."""
    if tnative.load() is None:
        pytest.skip("the pipeline needs the native host runtime")
    for cls in (jdc.DeviceMergeStrategy, tdc.DeviceMergeStrategy):
        monkeypatch.setattr(cls, "PIPELINE_MIN_BYTES", 0)
    wrote = []
    real = tpipe._pipeline_merge_impl

    def spy(*a, **kw):
        res = real(*a, **kw)
        wrote.append(res is not None)
        return res

    monkeypatch.setattr(tpipe, "_pipeline_merge_impl", spy)

    async def main(tree, d):
        rng = random.Random(17007)
        await _fill(tree, rng, n=1200, key_space=5000)
        await tree.flush()
        live = [i for i, _ in tree.sstable_indices_and_sizes()]
        out = max(live) + 1
        await tree.compact(live, out, False)
        assert [i for i, _ in tree.sstable_indices_and_sizes()] == [out]
        assert not any(
            os.path.exists(p) for c in (False, True)
            for p in si.run_paths(d, out, c)
        )
        where = Q.validate_where(["cmp", "n", "<", -45])
        got = await _page_all(tree, where, None)
        tree.index_fields = None
        tree._drop_scan_stage()
        golden = await _page_all(tree, where, None)
        tree.close()
        assert got[:2] == golden[:2]
        return got

    jd, td = f"{tmp_dir}/j", f"{tmp_dir}/t"
    jgot = run(main(JTree.open_or_create(
        jd, capacity=512, index_fields=FIELDS, strategy=jget("device")), jd),
        timeout=60)
    misses = si.index_stats.stats()["planner_misses"]
    tgot = run(main(LSMTree(td, capacity=512, index_fields=FIELDS), td),
               timeout=60)
    assert wrote == [True]
    assert "indexed" not in tgot[2]
    assert si.index_stats.stats()["planner_misses"] > misses
    assert tgot[:2] == jgot[:2] and tgot[0]
    assert _digest(td, ("data", "index", "sums")) == \
        _digest(jd, ("data", "index", "sums"))


def test_reference_written_tree_plans_the_same_in_the_port(tmp_dir):
    """State carries across: a tree written and indexed by dbeel_tpu,
    reopened by the port, plans the same candidates and pages."""

    async def write():
        tree = JTree.open_or_create(
            f"{tmp_dir}/j", capacity=256, index_fields=FIELDS,
            strategy=jget("heap"),
        )
        rng = random.Random(17008)
        await _fill(tree, rng, n=900, key_space=1100)
        await tree.flush()
        live = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(live[:3], live[2] + 1, True)
        tree.close()

    run(write(), timeout=60)
    shutil.copytree(f"{tmp_dir}/j", f"{tmp_dir}/t")

    async def pages(tree, specs):
        out = []
        try:
            for where, agg, limit in specs:
                out.append(await _page_all(tree, where, agg, limit, 8192))
        finally:
            tree.close()
        return out

    rng = random.Random(5)
    specs = []
    for trial in range(12):
        agg = (Q.validate_agg({"op": "count", "group": 0})
               if trial % 3 == 2 else None)
        specs.append((Q.validate_where(_random_where(rng)), agg,
                      rng.choice([64, 256])))
    hits = si.index_stats.stats()["planner_hits"]
    want = run(pages(JTree.open_or_create(
        f"{tmp_dir}/j", capacity=256, index_fields=FIELDS,
        strategy=jget("heap")), specs), timeout=60)
    got = run(pages(LSMTree(
        f"{tmp_dir}/t", capacity=256, index_fields=FIELDS), specs),
        timeout=60)
    assert si.index_stats.stats()["planner_hits"] > hits
    for (w, _a, _l), g, r in zip(specs, got, want):
        assert g[0] == r[0] and g[1] == r[1], w
        # The indexed plan engages where, and only where, dbeel_tpu's
        # does.
        assert [p == "indexed" for p in g[2]] == \
            [p == "indexed" for p in r[2]], w
