"""dbeel_tpu_torch's single-pass compaction held to
tests/test_compaction_sidecar.py: the inline ``.sums``/bloom sidecars of
the native merge and the native flush are byte-identical to the
post-hoc ``checksums.compute_and_write`` re-read, also through the
overlapped io_uring input loader; a crash between the compact-action
journal and its renames never exposes a sum-less live table; and an
arena flush + native compaction through the LSM tree is single-pass
(every sidecar inline, read amplification 1.0).  The journal is written
with the port's codec (storage/journal.py), not msgpack."""

import os
import random

import pytest

from conftest import run

from dbeel_tpu_torch.storage import checksums, journal
from dbeel_tpu_torch.storage.compaction import (
    ColumnarMergeStrategy,
    compaction_stats,
    get_strategy,
)
from dbeel_tpu_torch.storage.entry import COMPACT_ACTION_FILE_EXT, file_name
from dbeel_tpu_torch.storage import native
from dbeel_tpu_torch.storage.entry_writer import EntryWriter
from dbeel_tpu_torch.storage.lsm_tree import LSMTree
from dbeel_tpu_torch.storage.sstable import SSTable


@pytest.fixture(autouse=True)
def _native_library():
    if not native.native_available():
        pytest.skip("native library unavailable")


def _make_table(d, idx, n, rng, tombstone_frac=0.1, max_val=300):
    w = EntryWriter(d, idx, None)
    keys = sorted({os.urandom(rng.randrange(1, 24)) for _ in range(n)})
    for k in keys:
        v = (
            b""
            if rng.random() < tombstone_frac
            else os.urandom(rng.randrange(0, max_val))
        )
        w.write(k, v, rng.randrange(1, 1 << 60))
    w.close()
    return SSTable(d, idx, None)


def _sums_bytes(d, idx, ext):
    with open(os.path.join(d, file_name(idx, ext)), "rb") as f:
        return f.read()


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("keep_tombstones", [True, False])
def test_native_merge_inline_sums_byte_identity(
    tmp_dir, seed, keep_tombstones
):
    """The native strategy's inline compact_sums equals a post-hoc
    compute_and_write over the triplet it wrote."""
    rng = random.Random(seed)
    srcs = [
        _make_table(tmp_dir, 0, 400, rng),
        _make_table(tmp_dir, 2, 250, rng),
        _make_table(tmp_dir, 4, 150, rng),
    ]
    s = native.NativeMergeStrategy()
    s.merge(srcs, tmp_dir, 5, None, keep_tombstones, 1)
    inline = _sums_bytes(tmp_dir, 5, "compact_sums")
    checksums.compute_and_write(
        tmp_dir,
        7,
        os.path.join(tmp_dir, file_name(5, "compact_data")),
        os.path.join(tmp_dir, file_name(5, "compact_index")),
        os.path.join(tmp_dir, file_name(5, "compact_bloom")),
    )
    assert inline == _sums_bytes(tmp_dir, 7, "sums")


@pytest.mark.parametrize("want_bloom", [True, False])
def test_native_flush_inline_sums_byte_identity(tmp_dir, want_bloom):
    """The single-pass native flush emits the sidecar bytes the post-hoc
    re-read would compute, bloom or no bloom."""
    from dbeel_tpu_torch.storage.memtable import ArenaMemtable

    rng = random.Random(11)
    mt = ArenaMemtable(4000)
    for i in range(1500):
        mt.set(
            f"key{rng.randrange(10**6):06d}".encode(),
            os.urandom(rng.randrange(0, 150)),
            1000 + i,
        )
    n = mt.flush_to_sstable_with_sums(tmp_dir, 4, 1 if want_bloom else 1 << 40)
    assert n == len(mt)
    assert os.path.exists(
        os.path.join(tmp_dir, file_name(4, "bloom"))
    ) == want_bloom
    checksums.compute_and_write(
        tmp_dir,
        6,
        os.path.join(tmp_dir, file_name(4, "data")),
        os.path.join(tmp_dir, file_name(4, "index")),
        os.path.join(tmp_dir, file_name(4, "bloom")),
    )
    assert _sums_bytes(tmp_dir, 4, "sums") == _sums_bytes(tmp_dir, 6, "sums")
    sums = checksums.load(tmp_dir, 4)
    assert sums is not None and sums.has_bloom == want_bloom


def test_overlapped_read_merge_byte_identity(tmp_dir, monkeypatch):
    """The io_uring overlapped input loader (chunk threshold shrunk):
    the merged triplet and sums are byte-equal to the columnar merge's.
    Without io_uring the loader reads serially; the identity holds
    either way."""
    monkeypatch.setattr(native, "_IO_CHUNK_BYTES", 4096)
    rng = random.Random(21)
    srcs = [
        _make_table(tmp_dir, 0, 700, rng, max_val=120),
        _make_table(tmp_dir, 2, 500, rng, max_val=120),
    ]
    before = sum(native.read_overlap_stats())
    native.NativeMergeStrategy().merge(srcs, tmp_dir, 3, None, True, 1)
    assert sum(native.read_overlap_stats()) == before + 1
    ColumnarMergeStrategy().merge(srcs, tmp_dir, 5, None, True, 1)
    for ext in ("compact_data", "compact_index", "compact_bloom",
                "compact_sums"):
        assert _sums_bytes(tmp_dir, 3, ext) == _sums_bytes(
            tmp_dir, 5, ext
        ), ext


def test_crash_mid_compaction_never_exposes_sumless_table(tmp_dir):
    """Crash between the journal fsync and (some of) its renames:
    recovery replays the journal, and because the sums sidecar rides
    the same journaled rename set as the triplet, the output table
    never goes live without it."""
    rng = random.Random(31)
    srcs = [
        _make_table(tmp_dir, 0, 300, rng, tombstone_frac=0.0),
        _make_table(tmp_dir, 2, 200, rng, tombstone_frac=0.0),
    ]
    for t in srcs:
        checksums.compute_and_write(
            tmp_dir,
            t.index,
            t.data_path,
            t.index_path,
            os.path.join(tmp_dir, file_name(t.index, "bloom")),
        )
    out = 3
    res = native.NativeMergeStrategy().merge(srcs, tmp_dir, out, None, True, 1)

    def p(idx, ext):
        return os.path.join(tmp_dir, file_name(idx, ext))

    renames = [
        [p(out, "compact_data"), p(out, "data")],
        [p(out, "compact_index"), p(out, "index")],
    ]
    if res.wrote_bloom:
        renames.append([p(out, "compact_bloom"), p(out, "bloom")])
    renames.append([p(out, "compact_sums"), p(out, "sums")])
    deletes = [q for t in srcs for q in t.paths()]
    for t in srcs:
        t.close()
    action_path = p(out, COMPACT_ACTION_FILE_EXT)
    with open(action_path, "wb") as f:
        f.write(journal.packb({"renames": renames, "deletes": deletes}))
        f.flush()
        os.fsync(f.fileno())
    # Crash after only the first rename (data): the worst intermediate
    # state the journal permits.
    os.replace(*renames[0])

    async def main():
        tree = LSMTree.open_or_create(
            tmp_dir, capacity=64, strategy=get_strategy("heap")
        )
        try:
            assert not os.path.exists(action_path)
            assert [i for i, _ in tree.sstable_indices_and_sizes()] == [out]
            assert checksums.load(tmp_dir, out) is not None
            assert not os.path.exists(p(0, "data"))
            assert not os.path.exists(p(2, "data"))
            count = 0
            async for _k, _v, _ts in tree.iter_filter():
                count += 1
            assert count == res.entry_count
        finally:
            tree.close()

    run(main(), timeout=30)


def test_lsm_flush_compact_is_single_pass(tmp_dir):
    """Arena flush + native compaction through the LSM tree: every
    sidecar inline, no post-hoc re-read, and the pass read exactly its
    inputs."""

    async def main():
        before = compaction_stats.stats()
        tree = LSMTree.open_or_create(
            tmp_dir + "/tree",
            capacity=256,
            strategy=get_strategy("native"),
            memtable_kind="arena",
        )
        try:
            for i in range(700):
                await tree.set(f"k{i:05d}".encode(), os.urandom(48))
            await tree.flush()
            idx = [i for i, _ in tree.sstable_indices_and_sizes()]
            assert len(idx) >= 2
            await tree.compact(idx, max(idx) + 1, keep_tombstones=False)
            after = compaction_stats.stats()
            assert after["sidecar_posthoc"] == before["sidecar_posthoc"]
            assert after["sidecar_inline"] > before["sidecar_inline"]
            assert after["merge_passes"] == before["merge_passes"] + 1
            assert (
                after["bytes_read"] - before["bytes_read"]
                == after["merge_input_bytes"] - before["merge_input_bytes"]
            )
            assert await tree.get(b"k00001") is not None
        finally:
            tree.close()

    run(main(), timeout=30)
