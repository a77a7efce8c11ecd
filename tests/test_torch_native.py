"""The native host runtime in dbeel_tpu_torch against dbeel_tpu on the
same seeded inputs: the arena memtable, its single-pass flush, the
``native`` merge backend, the WAL appender and the profiler trace of the
compaction pipeline.  Both packages bind the same ``native/`` library,
so every file they write must be SHA-256-equal."""

import asyncio
import hashlib
import os

import numpy as np
import pytest

from conftest import write_sstable_fixture

from dbeel_tpu.errors import MemtableCapacityReached as JCapacity
from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage import native as jnative
from dbeel_tpu.storage import wal as jwal
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu.storage.memtable import ArenaMemtable as JArena
from dbeel_tpu.storage.sstable import SSTable as JTable
from dbeel_tpu_torch.errors import MemtableCapacityReached as TCapacity
from dbeel_tpu_torch.ops import pipeline as tpipe
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import native as tnative
from dbeel_tpu_torch.storage import wal as twal
from dbeel_tpu_torch.storage.compaction import compaction_stats
from dbeel_tpu_torch.storage.compaction import get_strategy as tget
from dbeel_tpu_torch.storage.entry import file_name
from dbeel_tpu_torch.storage.memtable import ArenaMemtable as TArena
from dbeel_tpu_torch.storage.sstable import SSTable as TTable
from dbeel_tpu_torch.utils import msgpack_codec

@pytest.fixture(autouse=True)
def _native_library():
    if tnative.load() is None:
        pytest.skip("native library cannot be built")


def _digests(d, skip=(".memtable",)):
    out = {}
    for name in sorted(os.listdir(d)):
        if not name.endswith(skip) and os.path.isfile(os.path.join(d, name)):
            with open(os.path.join(d, name), "rb") as f:
                out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _ops(seed, n, n_keys, tomb=0.05):
    """Seeded (key, value, ts) writes; value b"" is a delete."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_keys, size=n)
    lens = rng.integers(0, 48, size=n)
    dels = rng.random(n) < tomb
    ts = rng.integers(1, 1 << 40, size=n)
    out = []
    for i in range(n):
        key = b"key-%06d" % ids[i] + b"x" * int(ids[i] % 7)
        value = b"" if dels[i] else rng.bytes(int(lens[i]))
        out.append((key, value, int(ts[i])))
    return out


# ---------------------------------------------------------------------
# ArenaMemtable
# ---------------------------------------------------------------------


@pytest.mark.parametrize("seed,capacity,n_keys", [
    (0, 4096, 600),  # overwrites and stale writes under capacity
    (1, 200, 400),  # capacity refusals of new keys
])
def test_arena_memtable_equals_reference(seed, capacity, n_keys):
    ops = _ops(seed, 3000, n_keys)
    port, ref = TArena(capacity), JArena(capacity)
    for key, value, ts in ops:
        refused = []
        for m, cap_err in ((port, TCapacity), (ref, JCapacity)):
            try:
                m.set(key, value, ts)
                refused.append(False)
            except cap_err:
                refused.append(True)
        assert refused[0] == refused[1], key
    assert len(port) == len(ref) and len(port) > 0
    assert port.sorted_items() == ref.sorted_items()
    assert port.max_ts == ref.max_ts == max(ts for _, _, ts in ops)
    assert port.data_bytes == ref.data_bytes
    assert port.is_full() == ref.is_full() == (capacity < n_keys)
    for key, _, _ in ops[:200]:
        assert port.get(key) == ref.get(key)
    batch = [(b"batch-%04d" % i, b"v", 7) for i in range(300)]
    assert port.set_batch(batch) == ref.set_batch(batch)


def _drive(tree_cls, d, ops, kind, strategy, **kw):
    async def main():
        tree = tree_cls.open_or_create(
            d, capacity=256, memtable_kind=kind, strategy=strategy,
            bloom_min_size=4096, **kw,
        )
        for key, value, ts in ops:
            await tree.set_with_timestamp(key, value, ts)
        await tree.flush()
        kind_used = tree.memtable_kind
        tree.close()
        return kind_used

    return asyncio.run(main())


def test_arena_flush_files_equal_reference_and_sorted(tmp_dir):
    """Arena flushes (triplet, bloom, .sums) from the port are
    SHA-256-equal to dbeel_tpu's arena flushes and to the port's
    sorted-memtable flush of the same writes; every one is inline."""
    ops = _ops(2, 1500, 900)
    before = compaction_stats.stats()
    assert _drive(TTree, f"{tmp_dir}/port", ops, "auto",
                  tget("heap")) == "arena"
    after = compaction_stats.stats()
    assert _drive(JTree, f"{tmp_dir}/ref", ops, "arena", jget("heap")) \
        == "arena"
    assert _drive(TTree, f"{tmp_dir}/sorted", ops, "sorted",
                  tget("heap")) == "sorted"
    port = _digests(f"{tmp_dir}/port")
    assert sum(n.endswith(".sums") for n in port) >= 5
    assert any(n.endswith(".bloom") for n in port)
    assert port == _digests(f"{tmp_dir}/ref") == _digests(f"{tmp_dir}/sorted")
    flushes = after["flush_passes"] - before["flush_passes"]
    assert flushes == sum(n.endswith(".data") for n in port)
    assert after["sidecar_inline"] - before["sidecar_inline"] == flushes
    assert after["sidecar_posthoc"] == before["sidecar_posthoc"]


def test_arena_tree_recovers_its_wal_in_both_packages(tmp_dir):
    """An arena tree closed before its flush replays its WAL into the
    arena (and dbeel_tpu replays the same WAL)."""
    ops = _ops(3, 180, 150)
    oracle = {}
    for key, value, ts in ops:
        if key not in oracle or ts >= oracle[key][1]:
            oracle[key] = (value, ts)

    async def write():
        tree = TTree.open_or_create(
            f"{tmp_dir}/t", capacity=256, memtable_kind="arena",
            strategy=tget("heap"),
        )
        for key, value, ts in ops:
            await tree.set_with_timestamp(key, value, ts)
        tree.close()

    async def read(tree_cls, strategy):
        tree = tree_cls.open_or_create(
            f"{tmp_dir}/t", capacity=256, memtable_kind="arena",
            strategy=strategy,
        )
        assert type(tree._active).__name__ == "ArenaMemtable"
        got = {}
        for key in oracle:
            got[key] = await tree.get_entry(key)
        tree.close()
        return got

    asyncio.run(write())
    for tree_cls, strategy in ((TTree, tget("heap")), (JTree, jget("heap"))):
        got = asyncio.run(read(tree_cls, strategy))
        for key, (value, ts) in oracle.items():
            assert got[key] == (value, ts), key


# ---------------------------------------------------------------------
# NativeMergeStrategy
# ---------------------------------------------------------------------


class _Ticks:
    def __init__(self):
        self.n = 0

    def tick(self):
        self.n += 1


def _write_runs(d, seed, sizes):
    rng = np.random.default_rng(seed)
    for r, n in enumerate(sizes):
        entries = {}
        for _ in range(n):
            key = bytes(rng.integers(0, 6, size=int(rng.integers(1, 9)))
                        .astype(np.uint8))
            value = b"" if rng.random() < 0.15 else rng.bytes(
                int(rng.integers(0, 120)))
            entries[key] = (value, int(rng.integers(1, 1 << 40)))
        write_sstable_fixture(
            d, r * 2, [(k, v, ts) for k, (v, ts) in sorted(entries.items())]
        )
    return [r * 2 for r in range(len(sizes))]


@pytest.mark.parametrize("case", [
    "keep_tombstones", "drop_tombstones", "tombstone_drop_before",
    "empty_source", "one_source", "overlapped_odirect",
])
def test_native_merge_equals_reference(tmp_dir, monkeypatch, case):
    sizes = {"empty_source": [700, 0, 500], "one_source": [900],
             "overlapped_odirect": [3000, 2500, 2000, 1500]}.get(
        case, [800, 600, 400])
    idx = _write_runs(tmp_dir, sizes=sizes, seed=len(case))
    keep = case == "keep_tombstones"
    cutoff = (1 << 39) if case == "tombstone_drop_before" else None
    throttle = None
    if case == "overlapped_odirect":
        # Chunked, ticked IO: the io_uring input pass and the O_DIRECT
        # output writes at test size.
        for mod in (jnative, tnative):
            monkeypatch.setattr(mod, "_IO_CHUNK_BYTES", 4096)
            monkeypatch.setattr(mod, "ODIRECT_MIN_BYTES", 0)
        throttle = _Ticks()
    shas, results = [], []
    for table_cls, strategy, out in (
        (JTable, jnative.NativeMergeStrategy(), 101),
        (TTable, tget("native"), 103),
        (TTable, tget("heap"), 105),
    ):
        assert strategy.name in ("native", "heap")
        strategy.tombstone_drop_before = cutoff
        if strategy.name == "native":
            strategy.throttle = throttle
        srcs = [table_cls(tmp_dir, i, None) for i in idx]
        res = strategy.merge(srcs, tmp_dir, out, None, keep, 1)
        for s in srcs:
            s.close()
        results.append((res.entry_count, res.data_size, res.wrote_bloom))
        shas.append({
            ext: _digests(tmp_dir).get(file_name(out, ext))
            for ext in ("compact_data", "compact_index", "compact_bloom",
                        "compact_sums")
        })
    # The reference's native merge, the port's and the heap oracle.
    assert shas[0] == shas[1] == shas[2]
    assert results[0] == results[1] == results[2]
    assert results[1][0] > 0
    if throttle is not None:
        assert throttle.n > 0


def test_native_merge_refuses_index_runs(tmp_dir):
    """With index fields the native merge writes the output's index run
    from its resident buffers, SHA-256-equal to dbeel_tpu's native
    merge and to the port's heap merge."""
    rng = np.random.default_rng(9)
    for r, n in enumerate([300, 250, 200]):
        entries = {}
        for _ in range(n):
            key = b"k%05d" % rng.integers(0, 600)
            roll = rng.random()
            score = (int(rng.integers(-1 << 60, 1 << 60)) if roll < 0.3
                     else float(rng.normal()) if roll < 0.6
                     else bytes(rng.integers(0, 3, size=int(rng.integers(0, 20)))
                                .astype(np.uint8)) if roll < 0.85
                     else None)
            doc = {} if score is None else {"score": score, "r": r}
            value = b"" if rng.random() < 0.1 else msgpack_codec.packb(doc)
            entries[key] = (value, int(rng.integers(1, 1 << 40)))
        write_sstable_fixture(
            tmp_dir, r * 2, [(k, v, ts) for k, (v, ts) in sorted(entries.items())]
        )
    shas = []
    for table_cls, strategy, out in (
        (JTable, jnative.NativeMergeStrategy(), 101),
        (TTable, tget("native"), 103),
        (TTable, tget("heap"), 105),
    ):
        strategy.index_fields = ["score"]
        srcs = [table_cls(tmp_dir, i, None) for i in (0, 2, 4)]
        strategy.merge(srcs, tmp_dir, out, None, False, 1)
        for s in srcs:
            s.close()
        shas.append({
            ext: _digests(tmp_dir).get(file_name(out, ext))
            for ext in ("compact_data", "compact_fidx", "compact_fidx_sums")
        })
    assert shas[0] == shas[1] == shas[2]
    assert all(shas[1].values())


def test_native_helpers_equal_reference():
    data = np.frombuffer(np.random.default_rng(4).bytes(3 * 4096 + 17),
                         dtype=np.uint8)
    assert tnative.page_crcs_native(tnative.load(), data, data.size) == \
        jnative.page_crcs_native(jnative._load(), data, data.size)
    for blob in (b"", b"a", b"dbeel", bytes(range(256))):
        assert tnative.murmur3_32_native(blob, 7) == \
            jnative.murmur3_32_native(blob, 7)
    buf = tnative.aligned_u8_buffer(5000)
    assert buf.ctypes.data % 4096 == 0 and buf.size == 5000
    assert tnative.odirect_fallbacks() >= 0
    assert all(n >= 0 for n in tnative.read_overlap_stats())


# ---------------------------------------------------------------------
# The WAL
# ---------------------------------------------------------------------


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("port_path", ["native", "python"])
def test_wal_cross_replay(tmp_dir, monkeypatch, port_path, sync):
    """The same appends through each package's Wal give byte-identical
    files, and each package replays the other's."""
    records = _ops(5, 120, 80)
    if port_path == "python":
        monkeypatch.setattr(tnative, "load_if_built", lambda: None)

    async def write(mod, path):
        w = mod.Wal(path, sync=sync)
        assert (w._native is not None) == (
            mod is jwal or port_path == "native"
        )
        for key, value, ts in records[:60]:
            await w.append(key, value, ts)
        await w.append_batch(records[60:])
        w.close()
        await asyncio.sleep(0)

    asyncio.run(write(twal, f"{tmp_dir}/port.wal"))
    asyncio.run(write(jwal, f"{tmp_dir}/ref.wal"))
    digests = _digests(tmp_dir, skip=())
    assert digests["port.wal"] == digests["ref.wal"]
    assert list(jwal.replay(f"{tmp_dir}/port.wal")) == records
    assert list(twal.replay(f"{tmp_dir}/ref.wal")) == records


# ---------------------------------------------------------------------
# No silent fallback
# ---------------------------------------------------------------------


def test_native_refusals_without_the_library(tmp_dir, monkeypatch):
    assert isinstance(tget("native"), tnative.NativeMergeStrategy)
    monkeypatch.setattr(tnative, "load", lambda: None)
    with pytest.raises(RuntimeError, match="make -C native"):
        tget("native")
    with pytest.raises(RuntimeError, match="make -C native"):
        TTree.open_or_create(
            f"{tmp_dir}/t", memtable_kind="arena", strategy=tget("heap")
        )
    with pytest.raises(RuntimeError, match="make -C native"):
        TArena(16)


# ---------------------------------------------------------------------
# The pipeline's profiler trace
# ---------------------------------------------------------------------


def test_pipeline_merge_profile_dir_trace(tmp_dir, monkeypatch):
    """With DBEEL_PROFILE_DIR set, each pipeline merge leaves a Chrome
    trace there and its output is unchanged."""
    rng = np.random.default_rng(6)
    for r in range(3):
        keys = sorted({rng.bytes(16) for _ in range(300)})
        write_sstable_fixture(
            tmp_dir, r * 2, [(k, rng.bytes(20), 100 + r) for k in keys]
        )
    trace_dir = f"{tmp_dir}/traces"

    def merge(out):
        srcs = [TTable(tmp_dir, r * 2, None) for r in range(3)]
        res = tpipe.pipeline_merge(srcs, tmp_dir, out, False, 1,
                                   device="cpu")
        for s in srcs:
            s.close()
        assert res is not None and res.entry_count == 900
        return {ext: _digests(tmp_dir)[file_name(out, ext)]
                for ext in ("compact_data", "compact_index",
                            "compact_bloom", "compact_sums")}

    plain = merge(101)
    assert not os.path.exists(trace_dir)
    monkeypatch.setenv("DBEEL_PROFILE_DIR", trace_dir)
    assert merge(103) == plain
    assert merge(105) == plain
    traces = os.listdir(trace_dir)
    assert len(traces) == 2 and all(t.endswith(".json") for t in traces)
    for t in traces:
        assert os.path.getsize(os.path.join(trace_dir, t)) > 0
