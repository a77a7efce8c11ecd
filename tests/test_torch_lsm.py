"""dbeel_tpu_torch's LSMTree against dbeel_tpu's, the compact-action
journal codec against msgpack, and import_tree on a dbeel_tpu-written
directory."""

import asyncio
import hashlib
import os
import random
import shutil

import msgpack
import pytest

from dbeel_tpu.storage import LSMTree as JTree
from dbeel_tpu.storage.compaction import get_strategy as jget
from dbeel_tpu_torch.storage import LSMTree as TTree
from dbeel_tpu_torch.storage import import_tree, journal
from dbeel_tpu_torch.storage.compaction import get_strategy as tget


def _digest(d):
    out = {}
    for f in sorted(os.listdir(d)):
        with open(os.path.join(d, f), "rb") as fh:
            out[f] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _ops(seed, n=2500):
    """Seeded set/overwrite/delete script with deterministic timestamps;
    keys share 8-byte prefixes and some run past 16 bytes."""
    rng = random.Random(seed)
    keys = [b"acct:%04d" % rng.randrange(600) for _ in range(n)]
    keys += [b"acct:0000-long-suffix-%d" % rng.randrange(50) for _ in range(200)]
    rng.shuffle(keys)
    ops = []
    for i, k in enumerate(keys):
        if rng.random() < 0.1:
            ops.append((k, None, 1_000 + i))
        else:
            ops.append((k, b"v%d" % rng.randrange(10**6), 1_000 + i))
    return ops


async def _settle():
    """Await every task the trees spawned (capacity-triggered flushes):
    closing a tree under an in-flight flush would tear its files."""
    others = [t for t in asyncio.all_tasks() if t is not asyncio.current_task()]
    await asyncio.gather(*others)


async def _run_script(tree_cls, d, strategy, ops):
    tree = tree_cls.open_or_create(
        d, capacity=256, strategy=strategy, bloom_min_size=2048
    )
    half = len(ops) // 2
    for k, v, ts in ops[:half]:
        if v is None:
            await tree.delete_with_timestamp(k, ts)
        else:
            await tree.set_with_timestamp(k, v, ts)
    await tree.flush()
    idx = [i for i, _ in tree.sstable_indices_and_sizes()]
    await tree.compact(idx, max(idx) + 1, keep_tombstones=True)
    for k, v, ts in ops[half:]:
        if v is None:
            await tree.delete_with_timestamp(k, ts)
        else:
            await tree.set_with_timestamp(k, v, ts)
    # Close with WAL-resident entries and reopen: recovery replays them.
    await _settle()
    tree.close()
    tree = tree_cls.open_or_create(
        d, capacity=256, strategy=strategy, bloom_min_size=2048
    )
    await tree.flush()
    idx = [i for i, _ in tree.sstable_indices_and_sizes()]
    await tree.compact(idx, max(idx) + 1, keep_tombstones=False)
    gets = {k: await tree.get(k) for k, _, _ in ops}
    tree.close()
    return _digest(d), gets


@pytest.mark.parametrize("strategy", ["heap", "device", "device_full"])
def test_lsm_script_identical_to_reference(tmp_dir, strategy):
    ops = _ops(3)
    want_files, want_gets = asyncio.run(
        _run_script(JTree, f"{tmp_dir}/j", jget("heap"), ops)
    )
    port = (
        tget(strategy, device="cpu") if strategy != "heap" else tget("heap")
    )
    got_files, got_gets = asyncio.run(
        _run_script(TTree, f"{tmp_dir}/t", port, ops)
    )
    assert got_files == want_files
    assert got_gets == want_gets
    oracle = {}
    for k, v, _ in ops:
        oracle[k] = v
    assert got_gets == oracle  # deletes read back as absent
    assert not any(f.endswith("memtable") and os.path.getsize(
        os.path.join(f"{tmp_dir}/t", f)) for f in os.listdir(f"{tmp_dir}/t"))


@pytest.mark.parametrize(
    "obj",
    [
        {},
        {"renames": [], "deletes": []},
        {"renames": [["/a/" + "x" * 20, "/b"]], "deletes": ["/c"] * 3},
        {"k": "s" * 31, "l": "s" * 32, "m": "s" * 255, "n": "s" * 256},
        {"big": "é" * 40000},
        {"arr": ["p%d" % i for i in range(16)], "arr2": ["q"] * 70000},
        {"m%d" % i: "v" for i in range(16)},
    ],
)
def test_journal_codec_matches_msgpack(obj):
    blob = msgpack.packb(obj, use_bin_type=True)
    assert journal.packb(obj) == blob
    assert journal.unpackb(blob) == msgpack.unpackb(blob, raw=False)


def test_journal_codec_rejects_torn_and_foreign():
    blob = journal.packb({"renames": [["a", "b"]], "deletes": ["c"]})
    for torn in (blob[:-1], blob[:3], blob + b"\x00"):
        with pytest.raises(ValueError):
            journal.unpackb(torn)
    with pytest.raises(ValueError):
        journal.unpackb(msgpack.packb({"n": 1}))
    with pytest.raises(TypeError):
        journal.packb({"n": 1})


def _commit_unapplied_compaction(d):
    """A committed-but-unapplied compaction of the two newest tables:
    compact_* outputs plus a msgpack journal naming them (the state a
    crash between the journal fsync and the renames leaves)."""
    from dbeel_tpu.storage.compaction import HeapMergeStrategy
    from dbeel_tpu.storage.sstable import SSTable

    idx = sorted(int(f.split(".")[0]) for f in os.listdir(d)
                 if f.endswith(".data"))
    out = idx[-1] + 1
    inputs = [SSTable(d, i, None) for i in idx[-2:]]
    HeapMergeStrategy().merge(inputs, d, out, None, True, 2048)
    for t in inputs:
        t.close()
    renames = [
        [f"{d}/{out:020}.compact_{e}", f"{d}/{out:020}.{e}"]
        for e in ("data", "index", "bloom", "sums")
        if os.path.exists(f"{d}/{out:020}.compact_{e}")
    ]
    deletes = [f"{d}/{i:020}.{e}" for i in idx[-2:]
               for e in ("data", "index", "bloom", "sums")]
    with open(f"{d}/{out:020}.compact_action", "wb") as f:
        f.write(msgpack.packb({"renames": renames, "deletes": deletes},
                              use_bin_type=True))


def test_import_tree_opens_reference_directory(tmp_dir):
    """A directory written by dbeel_tpu — flushed tables, a compacted
    table, WAL-resident entries and a pending compact journal — opens
    in the port with every value intact, and compacts to the same bytes
    as dbeel_tpu compacting the same directory."""
    ops = _ops(5, n=1500)
    src = f"{tmp_dir}/ref"

    async def write_reference():
        tree = JTree.open_or_create(
            src, capacity=200, strategy=jget("heap"), bloom_min_size=2048
        )
        for k, v, ts in ops:
            if v is None:
                await tree.delete_with_timestamp(k, ts)
            else:
                await tree.set_with_timestamp(k, v, ts)
        await _settle()
        idx = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(idx[:3], idx[2] + 1, keep_tombstones=True)
        tree.close()

    asyncio.run(write_reference())
    twin = f"{tmp_dir}/twin"
    shutil.copytree(src, twin)
    for d in (src, twin):
        _commit_unapplied_compaction(d)

    async def finish(tree):
        oracle = {}
        for k, v, _ in ops:
            oracle[k] = v
        assert {k: await tree.get(k) for k in oracle} == oracle
        await tree.flush()
        tables = [i for i, _ in tree.sstable_indices_and_sizes()]
        await tree.compact(tables, max(tables) + 1, keep_tombstones=False)
        tree.close()

    async def port_side():
        tree = import_tree(
            src, capacity=200, strategy=tget("device", device="cpu"),
            bloom_min_size=2048,
        )
        await finish(tree)

    async def reference_side():
        tree = JTree.open_or_create(
            twin, capacity=200, strategy=jget("heap"), bloom_min_size=2048
        )
        await finish(tree)

    asyncio.run(port_side())
    asyncio.run(reference_side())
    assert _digest(src) == _digest(twin)
    with pytest.raises(FileNotFoundError):
        import_tree(f"{tmp_dir}/missing")


def test_unported_memtable_kinds_refuse(tmp_dir, monkeypatch):
    """"arena" and "auto" are ported: "auto" resolves to the arena when
    native/ is built, as in dbeel_tpu.  Without the library "auto" takes
    the sorted memtable and an explicit "arena" refuses to open."""
    from dbeel_tpu_torch.storage import native

    for kind in ("arena", "auto"):
        tree = TTree.open_or_create(
            f"{tmp_dir}/{kind}", memtable_kind=kind, strategy=tget("heap")
        )
        assert tree.memtable_kind == "arena"
        assert type(tree._active).__name__ == "ArenaMemtable"
        tree.close()
    monkeypatch.setattr(native, "load", lambda: None)
    monkeypatch.setattr(native, "load_if_built", lambda: None)
    with pytest.raises(RuntimeError, match="make -C native"):
        TTree.open_or_create(
            f"{tmp_dir}/none", memtable_kind="arena", strategy=tget("heap")
        )
    tree = TTree.open_or_create(
        f"{tmp_dir}/none", memtable_kind="auto", strategy=tget("heap")
    )
    assert tree.memtable_kind == "sorted"
    tree.close()
