"""io_uring page reads in dbeel_tpu_torch (storage/uring.py and
CachedFileReader._read_pages_async): tests/test_uring_reads.py's cases
against the port, plus the executor path every host takes when the
kernel refuses a ring.  The ring cases skip, from a fixture, where no
ring can be made."""

import asyncio
import gc
import os
import weakref

import pytest

from dbeel_tpu_torch.storage import uring
from dbeel_tpu_torch.storage.entry import PAGE_SIZE
from dbeel_tpu_torch.storage.file_io import CachedFileReader
from dbeel_tpu_torch.storage.page_cache import PageCache, PartitionPageCache

from conftest import run


@pytest.fixture
def ring():
    async def probe():
        return uring.get_for_loop() is not None

    try:
        ok = run(probe())
    except Exception:
        ok = False
    if not ok:
        pytest.skip("io_uring unavailable here")


def test_uring_pread_roundtrip(tmp_dir, ring):
    async def main():
        ur = uring.get_for_loop()
        assert ur is not None
        path = os.path.join(tmp_dir, "f")
        blob = bytes(range(256)) * 64  # 16K
        with open(path, "wb") as f:
            f.write(blob)
        fd = os.open(path, os.O_RDONLY)
        try:
            futs = [
                ur.submit_pread(fd, PAGE_SIZE, a)
                for a in range(0, len(blob), PAGE_SIZE)
            ]
            assert all(f is not None for f in futs)
            raws = await asyncio.gather(*futs)
            assert b"".join(raws) == blob
            # Short read at EOF reports actual bytes.
            tail = ur.submit_pread(fd, PAGE_SIZE, len(blob) - 100)
            assert len(await tail) == 100
        finally:
            os.close(fd)

    run(main())


def _cached_reader_reads(tmp_dir):
    """Cold, warm and EOF-crossing reads of one file through
    ``read_at_async``; returns the cold pages' bytes."""

    async def main():
        path = os.path.join(tmp_dir, "f")
        blob = os.urandom(5 * PAGE_SIZE + 123)
        with open(path, "wb") as f:
            f.write(blob)
        cache = PartitionPageCache("t", PageCache(64))
        r = CachedFileReader(path, ("data", 0), cache)
        try:
            got = await r.read_at_async(100, 3 * PAGE_SIZE)
            assert got == blob[100 : 100 + 3 * PAGE_SIZE]
            # Warm: the same range now serves from cache (sync path).
            assert r.read_at_cached(100, 3 * PAGE_SIZE) == got
            tail = await r.read_at_async(len(blob) - 50, 1000)
            assert tail == blob[-50:]
            pages = await r._read_pages_async(
                list(range(0, len(blob), PAGE_SIZE))
            )
            padded = blob + b"\x00" * (-len(blob) % PAGE_SIZE)
            assert b"".join(pages) == padded
            return pages
        finally:
            r.close()

    return run(main())


def test_cached_reader_async_uses_uring_and_matches(
    tmp_dir, ring, monkeypatch
):
    queued = []
    real = uring.UringReader.queue_pread

    def spy(self, fd, size, offset):
        fut = real(self, fd, size, offset)
        queued.append(fut is not None)
        return fut

    monkeypatch.setattr(uring.UringReader, "queue_pread", spy)
    _cached_reader_reads(tmp_dir)
    # Cold: every page went through io_uring.
    assert queued and all(queued)


def test_executor_path_returns_the_same_pages(tmp_dir, monkeypatch):
    """Where the kernel refuses a ring (``get_for_loop()`` is None) the
    pages come from one executor hop, identical to the ring's."""
    monkeypatch.setattr(uring, "get_for_loop", lambda loop=None: None)
    hops = []
    real = CachedFileReader._pread_pages

    def spy(self, addresses):
        hops.append(len(addresses))
        return real(self, addresses)

    monkeypatch.setattr(CachedFileReader, "_pread_pages", spy)
    pages = _cached_reader_reads(tmp_dir)
    assert hops and len(pages) == 6


def test_uring_many_concurrent_reads(tmp_dir, ring):
    """More in-flight reads than the drain batch handles at once."""

    async def main():
        ur = uring.get_for_loop()
        path = os.path.join(tmp_dir, "f")
        blob = os.urandom(64 * PAGE_SIZE)
        with open(path, "wb") as f:
            f.write(blob)
        fd = os.open(path, os.O_RDONLY)
        try:
            futs = []
            for _rep in range(3):
                for a in range(0, len(blob), PAGE_SIZE):
                    f = ur.submit_pread(fd, PAGE_SIZE, a)
                    if f is not None:
                        futs.append((a, f))
            assert len(futs) >= 64
            for a, f in futs:
                assert await f == blob[a : a + PAGE_SIZE]
        finally:
            os.close(fd)

    run(main())


def test_uring_capacity_gate_returns_none_instead_of_hanging(tmp_dir, ring):
    """Beyond the completion-queue capacity the ring REFUSES new reads
    (callers take the executor) — unreaped overflow completions would
    otherwise hang futures forever."""

    async def main():
        ur = uring.get_for_loop()
        path = os.path.join(tmp_dir, "f")
        with open(path, "wb") as f:
            f.write(os.urandom(PAGE_SIZE))
        fd = os.open(path, os.O_RDONLY)
        try:
            futs = []
            refused = 0
            for _ in range(2048):  # far beyond cq_entries
                f2 = ur.queue_pread(fd, PAGE_SIZE, 0)
                if f2 is None:
                    refused += 1
                else:
                    futs.append(f2)
            assert refused > 0, "capacity gate never engaged"
            assert ur.flush()
            for f2 in futs:  # every accepted read completes
                assert len(await f2) == PAGE_SIZE
        finally:
            os.close(fd)

    run(main())


def test_closed_loop_releases_its_ring(tmp_dir, ring):
    """A loop that read through its ring and was then closed leaves no
    reader, ring fd or eventfd behind, loop after loop."""
    path = os.path.join(tmp_dir, "f")
    blob = os.urandom(PAGE_SIZE)
    with open(path, "wb") as f:
        f.write(blob)
    fd = os.open(path, os.O_RDONLY)
    readers = []

    async def main():
        ur = uring.get_for_loop()
        readers.append(weakref.ref(ur))
        return await ur.submit_pread(fd, PAGE_SIZE, 0)

    try:
        gc.collect()
        before = len(os.listdir("/proc/self/fd"))
        for _ in range(4):
            loop = asyncio.new_event_loop()
            assert loop.run_until_complete(main()) == blob
            loop.close()
            del loop
        gc.collect()
        assert all(r() is None for r in readers)
        assert len(os.listdir("/proc/self/fd")) == before
    finally:
        os.close(fd)
