"""dbeel_tpu_torch's memtables held to tests/test_memtable.py (the
reference's rbtree_arena suite, reference rbtree_arena/src/lib.rs:
651-860): ordering, capacity errors, overwrite/timestamp-conflict
semantics for every kind, and the arena's native flush byte-identical
to the Python writer.  The hash memtable sorts with K5's plain version
(``device="cpu"``)."""

import asyncio
import functools
import hashlib
import os
import random

import pytest

from dbeel_tpu_torch.errors import MemtableCapacityReached
from dbeel_tpu_torch.storage.compaction import get_strategy
from dbeel_tpu_torch.storage.memtable import (
    ArenaMemtable,
    HashMemtable,
    Memtable,
)
from dbeel_tpu_torch.storage.native import native_available


@pytest.fixture
def need_native():
    if not native_available():
        pytest.skip("native library unavailable")


@pytest.fixture(params=["sorted", "hash", "arena"])
def memtable_cls(request):
    if request.param == "arena":
        request.getfixturevalue("need_native")
        return ArenaMemtable
    if request.param == "hash":
        return functools.partial(HashMemtable, device="cpu")
    return Memtable


def test_capacity_error_on_new_keys_only(memtable_cls):
    m = memtable_cls(4)
    for i in range(4):
        m.set(f"k{i}".encode(), b"v", i)
    assert m.is_full()
    with pytest.raises(MemtableCapacityReached):
        m.set(b"new", b"v", 99)
    # Overwriting an existing key at capacity is fine (the arena
    # updates in place).
    m.set(b"k0", b"v2", 100)
    assert m.get(b"k0") == (b"v2", 100)


def test_timestamp_conflict_keeps_newest(memtable_cls):
    m = memtable_cls(8)
    m.set(b"k", b"new", 100)
    m.set(b"k", b"stale", 50)  # older write arrives late (replication)
    assert m.get(b"k") == (b"new", 100)
    m.set(b"k", b"same-ts", 100)  # equal ts: last writer wins
    assert m.get(b"k") == (b"same-ts", 100)


def test_sorted_items_ordering(memtable_cls):
    rng = random.Random(5)
    m = memtable_cls(512)
    keys = set()
    while len(keys) < 300:
        keys.add(bytes(rng.randrange(256) for _ in range(rng.randrange(1, 24))))
    for k in keys:
        m.set(k, b"v", 1)
    assert [k for k, _ in m.sorted_items()] == sorted(keys)


def test_range_queries(memtable_cls):
    m = memtable_cls(64)
    for i in range(20):
        m.set(f"k{i:02}".encode(), b"v", i)
    got = [k for k, _ in m.range(b"k05", b"k10")]
    assert got == [f"k{i:02}".encode() for i in range(5, 11)]


def test_data_bytes_accounting(memtable_cls):
    m = memtable_cls(8)
    m.set(b"abc", b"12345", 1)
    assert m.data_bytes == 16 + 3 + 5
    m.set(b"abc", b"1234567", 2)  # value grows by 2
    assert m.data_bytes == 16 + 3 + 7


def test_random_ops_match_model(memtable_cls):
    """Randomized inserts/overwrites/stale-writes against a dict+sort
    model, black-box."""
    rng = random.Random(11)
    m = memtable_cls(4096)
    model = {}
    for _ in range(5000):
        k = bytes(rng.randrange(4) for _ in range(rng.randrange(1, 6)))
        v = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 8)))
        ts = rng.randrange(1000)
        prev = model.get(k)
        m.set(k, v, ts)
        if prev is None or ts >= prev[1]:
            model[k] = (v, ts)
    assert len(m) == len(model)
    assert m.sorted_items() == [(k, model[k]) for k in sorted(model)]
    for k in list(model)[:200]:
        assert m.get(k) == model[k]
    assert m.get(b"\xff" * 9) is None


def test_arena_flush_bytes_identical_to_sorted(tmp_dir, need_native):
    """memtable_kind="arena" leaves byte-identical SSTables to the
    sorted Python memtable."""
    from dbeel_tpu_torch.storage.lsm_tree import LSMTree

    async def build(kind, sub):
        d = os.path.join(tmp_dir, sub)
        os.makedirs(d)
        tree = LSMTree.open_or_create(
            d, capacity=64, memtable_kind=kind, strategy=get_strategy("heap")
        )
        rng = random.Random(2)
        for i in range(500):
            k = f"key{rng.randrange(300):04}".encode()
            await tree.set_with_timestamp(k, b"v%d" % i, 1000 + i)
            if rng.random() < 0.1:
                await tree.delete_with_timestamp(k, 2000 + i)
        await tree.flush()
        digest = hashlib.sha256()
        for name in sorted(os.listdir(d)):
            if name.endswith((".data", ".index")):
                with open(os.path.join(d, name), "rb") as f:
                    digest.update(name.encode())
                    digest.update(f.read())
        tree.close()
        return digest.hexdigest()

    async def main():
        assert await build("sorted", "a") == await build("arena", "b")

    from conftest import run

    run(main())


def test_arena_bytes_bounded_under_updates(need_native):
    """Update-heavy workload below capacity: the native byte arena
    reclaims superseded values instead of growing without bound."""
    m = ArenaMemtable(8192)
    for rnd in range(100):
        for i in range(500):
            m.set(b"key%04d" % i, b"v" * (20 + rnd % 7), rnd * 1000 + i)
    arena_bytes = int(m._lib.dbeel_memtable_bytes(m._handle))
    live = sum(len(k) + len(v) for k, (v, _) in m.sorted_items())
    assert arena_bytes < 4 * live + (2 << 20), (
        f"arena grew unbounded: {arena_bytes} vs live {live}"
    )
    assert m.get(b"key0000") == (b"v" * (20 + 99 % 7), 99 * 1000)


def test_native_flush_byte_identical(tmp_dir, need_native):
    """dbeel_memtable_flush_write produces the exact triplet the Python
    EntryWriter path writes — below and above the bloom threshold — and
    the inline sums equal a post-hoc compute over the native files."""
    from dbeel_tpu_torch.storage import checksums
    from dbeel_tpu_torch.storage.lsm_tree import LSMTree

    def sha(path):
        with open(path, "rb") as f:
            return hashlib.sha256(f.read()).hexdigest()

    for case, n, vsize, bloom_min in (
        ("no-bloom", 200, 50, 1 << 30),
        ("bloom", 3000, 400, 1 << 20),
        ("bloom-small-n", 64, 40, 1),  # tiny n exercises m/k rounding
    ):
        arena = ArenaMemtable(max(n + 1, 8))
        py = Memtable(max(n + 1, 8))
        for i in range(n):
            k = f"{case}-key-{i:06d}".encode()
            v = (f"v{i:04d}" * (vsize // 5)).encode()
            ts = 1_700_000_000_000_000_000 + i
            arena.set(k, v, ts)
            py.set(k, v, ts)

        nat_dir = os.path.join(tmp_dir, f"nat-{case}")
        py_dir = os.path.join(tmp_dir, f"py-{case}")
        os.makedirs(nat_dir)
        os.makedirs(py_dir)
        assert arena.flush_to_sstable(nat_dir, 0, bloom_min) == n
        tree = LSMTree.__new__(LSMTree)
        tree.dir_path = py_dir
        tree.bloom_min_size = bloom_min
        tree._write_sstable_from_items(0, py.sorted_items())

        # flush_to_sstable writes the triplet alone; the Python writer
        # adds the .sums sidecar.
        nat_files = sorted(os.listdir(nat_dir))
        py_files = sorted(
            f for f in os.listdir(py_dir) if not f.endswith(".sums")
        )
        assert nat_files == py_files, (case, nat_files, py_files)
        for fn in nat_files:
            assert sha(os.path.join(nat_dir, fn)) == sha(
                os.path.join(py_dir, fn)
            ), (case, fn)
        checksums.compute_and_write(
            nat_dir,
            0,
            os.path.join(nat_dir, "00000000000000000000.data"),
            os.path.join(nat_dir, "00000000000000000000.index"),
            os.path.join(nat_dir, "00000000000000000000.bloom"),
        )
        assert sha(checksums.sums_path(nat_dir, 0)) == sha(
            checksums.sums_path(py_dir, 0)
        ), case
