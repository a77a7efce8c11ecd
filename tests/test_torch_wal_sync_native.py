"""dbeel_tpu_torch's native wal-sync group commit held to the node-free
cases of tests/test_wal_sync_native.py: an OK may only leave once a
completed fdatasync covers the append — acks park on sync tickets that
the io_uring sync hub (or, with ``DBEEL_NO_WAL_HUB=1``, a C sync thread)
releases through an eventfd.  Reference semantics: reference
src/storage_engine/lsm_tree.rs:805-837."""

import asyncio
import os
import threading

import pytest

from conftest import run

from dbeel_tpu_torch.storage import wal as wal_mod
from dbeel_tpu_torch.storage.native import load_if_built, native_available


def _syncer_available() -> bool:
    return native_available() and hasattr(os, "eventfd")


def _hub_available() -> bool:
    """True only when a hub ring can be created: io_uring may be
    disabled (kernel.io_uring_disabled, a seccomp filter), and then the
    Wal correctly takes thread mode."""
    lib = load_if_built()
    if lib is None:
        return False
    h = lib.dbeel_walsync_hub_new(64)
    if not h:
        return False
    lib.dbeel_walsync_hub_free(h)
    return True


@pytest.fixture(autouse=True)
def _native_syncer():
    if not _syncer_available():
        pytest.skip("native wal syncer unavailable")


@pytest.fixture
def need_hub():
    if not _hub_available():
        pytest.skip("wal sync hub unavailable")


def test_wal_native_syncer_unit(tmp_dir):
    """Wal(sync=True) gets a native syncer; appends resolve their sync
    tickets; records survive in the file; parked callbacks fire."""

    async def main():
        w = wal_mod.Wal(f"{tmp_dir}/w.wal", sync=True)
        assert w._syncer is not None, "native syncer must engage"
        for i in range(10):
            await w.append(b"k%d" % i, b"v%d" % i, 1000 + i)
        lib = w._lib
        assert lib.dbeel_wal_synced(w._native) >= 10
        fired = []
        # An already-covered ticket releases on the next watermark
        # event — forced with another append.
        w._syncer.park(lib.dbeel_wal_seq(w._native), lambda: fired.append(1))
        await w.append(b"kx", b"vx", 2000)
        for _ in range(200):
            if fired:
                break
            await asyncio.sleep(0.005)
        assert fired == [1]
        w.close()
        got = list(wal_mod.replay(f"{tmp_dir}/w.wal"))
        assert len(got) == 11
        assert got[0] == (b"k0", b"v0", 1000)

    run(main(), timeout=30)


def test_wal_sync_hub_zero_threads(tmp_dir, need_hub):
    """Hub mode spawns no sync threads however many WALs are live: the
    fsync is a SQE on one loop-owned ring."""

    async def main():
        before = threading.active_count()
        wals = [
            wal_mod.Wal(f"{tmp_dir}/w{i}.wal", sync=True) for i in range(12)
        ]
        try:
            for w in wals:
                assert w._syncer is not None
                assert w._syncer._hub is not None, (
                    "hub mode must engage on this kernel"
                )
            assert threading.active_count() == before, (
                "sync threads leaked into hub mode"
            )
            await asyncio.gather(
                *(w.append(b"k%d" % i, b"v", 7 + i) for i, w in enumerate(wals))
            )
            for w in wals:
                assert w._lib.dbeel_wal_synced(w._native) >= 1
        finally:
            for w in wals:
                w.delete()
            await asyncio.gather(*(w.wait_disposed() for w in wals))

    run(main(), timeout=30)


def test_wal_sync_hub_delay_coalesces(tmp_dir, need_hub):
    """wal_sync_delay in hub mode arms an IORING_OP_TIMEOUT before the
    fsync: a burst of appends inside the window rides one sync and
    every ticket still resolves."""

    async def main():
        w = wal_mod.Wal(f"{tmp_dir}/d.wal", sync=True, sync_delay_us=5000)
        try:
            assert w._syncer is not None and w._syncer._hub is not None
            before = wal_mod.group_commit_stats()["syncs"]
            await asyncio.gather(
                *(w.append(b"c%d" % i, b"v", i) for i in range(20))
            )
            assert w._lib.dbeel_wal_synced(w._native) >= 20
            assert wal_mod.group_commit_stats()["syncs"] - before < 20
        finally:
            w.close()
        assert len(list(wal_mod.replay(f"{tmp_dir}/d.wal"))) == 20

    run(main(), timeout=30)


def test_wal_sync_thread_fallback_still_works(tmp_dir, monkeypatch):
    """DBEEL_NO_WAL_HUB=1 forces the dedicated-thread backend: the same
    ticket semantics, the same durability."""
    monkeypatch.setenv("DBEEL_NO_WAL_HUB", "1")

    async def main():
        w = wal_mod.Wal(f"{tmp_dir}/t.wal", sync=True)
        try:
            assert w._syncer is not None
            assert w._syncer._hub is None, "hub must be disabled"
            for i in range(5):
                await w.append(b"k%d" % i, b"v", i)
            assert w._lib.dbeel_wal_synced(w._native) >= 5
        finally:
            w.close()
        assert len(list(wal_mod.replay(f"{tmp_dir}/t.wal"))) == 5

    run(main(), timeout=30)
