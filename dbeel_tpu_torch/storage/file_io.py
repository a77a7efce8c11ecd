"""Page-aligned file I/O: cached reader and page-mirroring writer.

Role parity with reference src/storage_engine/cached_file_reader.rs
:13-89 (page-granular read-through cache over DmaFile) and the write side
of entry_writer.rs (every completed page mirrored into the cache so fresh
SSTables are warm).

The reference reads through glommio ``DmaFile`` (O_DIRECT + io_uring); the
host-runtime equivalent here is positional ``os.pread``/``os.pwrite`` on
page boundaries — the access pattern (aligned whole pages, read-through
cache) is identical, and the native C++ runtime can swap in O_DIRECT
without changing callers.
"""

from __future__ import annotations

import asyncio
import errno
import os
import shutil
import zlib
from typing import Optional, Sequence, Tuple

from ..errors import CorruptedFile
from .entry import PAGE_SIZE
from .page_cache import PartitionPageCache, align_down

# ---------------------------------------------------------------------
# Disk-fault injection seam — the storage-plane twin of
# remote_comm.set_fault: tests arm a fault for every file whose path
# starts with a prefix, and the affected I/O paths (page preads,
# page-mirroring writes, WAL appends/fsyncs, free-space probes)
# misbehave deterministically — bit rot, short reads, EIO, ENOSPC and
# torn closes with no real hardware tricks.  Production never touches
# this: the dict stays empty and the per-call check is one truthiness
# test.  ``DBEEL_DISK_FAULTS="<prefix>=<mode>[,...]"`` pre-arms faults
# at import for subprocess harnesses (chaos_soak --disk-faults).
# ---------------------------------------------------------------------

FAULT_BITFLIP = "bitflip"  # flip one bit in every page read
FAULT_SHORT_READ = "short_read"  # preads return half the bytes
FAULT_EIO_READ = "eio_read"  # preads raise EIO
FAULT_EIO_WRITE = "eio_write"  # writes raise EIO
FAULT_ENOSPC = "enospc"  # writes raise ENOSPC
FAULT_TORN_CLOSE = "torn_close"  # writer close drops the tail page
FAULT_NO_SPACE = "no_space"  # free-space probe reports 0 bytes

_faults: dict = {}  # path prefix -> mode


def set_fault(path_prefix: str, mode: Optional[str]) -> None:
    """Arm ``mode`` for every path under ``path_prefix`` (None
    disarms)."""
    if mode is None:
        _faults.pop(path_prefix, None)
    else:
        _faults[path_prefix] = mode


def clear_faults() -> None:
    _faults.clear()


def fault_for(path: str) -> Optional[str]:
    if not _faults:
        return None
    for prefix, mode in _faults.items():
        if path.startswith(prefix):
            return mode
    return None


def _arm_from_env() -> None:
    spec = os.environ.get("DBEEL_DISK_FAULTS", "")
    for part in spec.split(","):
        if "=" in part:
            prefix, mode = part.rsplit("=", 1)
            if prefix and mode:
                set_fault(prefix, mode)


_arm_from_env()


def check_write_fault(path: str) -> None:
    """Raise the armed write-side fault for ``path``, if any — called
    by the WAL append path and the page-mirroring writer so EIO/ENOSPC
    scenarios inject identically across the Python and native write
    backends."""
    mode = fault_for(path)
    if mode == FAULT_EIO_WRITE:
        raise OSError(errno.EIO, f"[fault] write EIO: {path}")
    if mode == FAULT_ENOSPC:
        raise OSError(
            errno.ENOSPC, f"[fault] no space left on device: {path}"
        )


def free_disk_space(path: str) -> int:
    """Free bytes on the filesystem holding ``path`` (seam-aware:
    FAULT_NO_SPACE reports zero so ENOSPC back-off paths are testable
    without filling a disk)."""
    if fault_for(path) == FAULT_NO_SPACE:
        return 0
    try:
        return shutil.disk_usage(os.path.dirname(path) or ".").free
    except OSError:
        return 1 << 62  # unknown filesystem: never back off on it


def _apply_read_fault(path: str, raw: bytes) -> bytes:
    mode = fault_for(path)
    if mode is None:
        return raw
    if mode == FAULT_EIO_READ:
        raise OSError(errno.EIO, f"[fault] read EIO: {path}")
    if mode == FAULT_SHORT_READ:
        return raw[: len(raw) // 2]
    if mode == FAULT_BITFLIP and raw:
        i = min(len(raw) - 1, PAGE_SIZE // 2)
        flipped = bytearray(raw)
        flipped[i] ^= 0x01
        return bytes(flipped)
    return raw


class CachedFileReader:
    """Read-through page cache over one immutable file.

    ``crcs`` (one CRC32 per 4 KiB page, storage/checksums.py) arms
    verification: every page is checked right after the pread — BEFORE
    it can enter the page cache or reach a caller — and a mismatch
    raises ``CorruptedFile`` (with ``.path`` set for quarantine
    attribution).  Without crcs the reader serves legacy-unverified,
    exactly as before."""

    def __init__(
        self,
        path: str,
        file_id: Tuple[str, int],
        cache: Optional[PartitionPageCache],
        crcs: Optional[Sequence[int]] = None,
    ) -> None:
        self.path = path
        self.file_id = file_id
        self._cache = cache
        self._fd = os.open(path, os.O_RDONLY)
        self.size = os.fstat(self._fd).st_size
        from . import checksums as _ck

        # Held by reference (TableSums owns the array('I')): a large
        # table's CRC arrays must not be duplicated per reader.
        self._crcs = (
            crcs
            if crcs is not None and _ck.verification_enabled()
            else None
        )

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def __del__(self):  # best-effort fd hygiene
        try:
            self.close()
        except Exception:
            pass

    def _verify_page(self, address: int, raw: bytes) -> None:
        crcs = self._crcs
        if crcs is None:
            return
        i = address // PAGE_SIZE
        if i >= len(crcs) or zlib.crc32(raw) != crcs[i]:
            exc = CorruptedFile(
                f"{self.path}: page at {address} failed its CRC"
            )
            exc.path = self.path
            raise exc

    def read_at(self, pos: int, size: int) -> bytes:
        """cached_file_reader.rs:28-79: walk the range page by page, cache
        hit or aligned read + fill."""
        if size <= 0:
            return b""
        end = min(pos + size, self.size)
        out = bytearray()
        address = align_down(pos)
        while address < end:
            page = self._page(address)
            lo = pos - address if address <= pos else 0
            hi = min(PAGE_SIZE, end - address)
            out += page[lo:hi]
            address += PAGE_SIZE
        return bytes(out)

    def read_all(self) -> bytes:
        return self.read_at(0, self.size)

    def _page(self, address: int) -> bytes:
        if self._cache is not None:
            page = self._cache.get_copied(self.file_id, address)
            if page is not None:
                return page
        raw = self._pread_page(address)
        if self._cache is not None:
            self._cache.set(self.file_id, address, raw)
        return raw

    def _pread_page(self, address: int) -> bytes:
        return self._finish_page(
            address, os.pread(self._fd, PAGE_SIZE, address)
        )

    def _finish_page(self, address: int, raw: bytes) -> bytes:
        """Injected fault, zero-pad to a whole page, CRC check: once for
        every page read, whichever way it was read."""
        if _faults:
            raw = _apply_read_fault(self.path, raw)
        if len(raw) < PAGE_SIZE:
            raw = raw + b"\x00" * (PAGE_SIZE - len(raw))
        self._verify_page(address, raw)
        return raw

    def _pread_pages(self, addresses) -> list:
        return [self._pread_page(a) for a in addresses]

    async def _read_pages_async(self, addresses) -> list:
        """Whole pages for every address: io_uring submissions when
        available (each a zero-thread async read), executor preads
        otherwise; partial trailing pages are zero-padded either way."""
        from . import uring

        ur = uring.get_for_loop()
        if ur is not None:
            futs = []  # (address, future)
            fallback = []
            for a in addresses:
                f = ur.queue_pread(self._fd, PAGE_SIZE, a)
                if f is None:  # ring at capacity: executor for these
                    fallback.append(a)
                else:
                    futs.append((a, f))
            if futs and not ur.flush():
                # Kernel rejected the batch: those futures will never
                # complete — cancel them and take the executor path.
                for _a, f in futs:
                    f.cancel()
                fallback.extend(a for a, _f in futs)
                futs = []
            by_addr = {}
            if futs:
                done = await asyncio.gather(*[f for _a, f in futs])
                for (a, _f), r in zip(futs, done):
                    # Verify BEFORE the caller can cache or decode it —
                    # uring completions bypass _pread_page.
                    by_addr[a] = self._finish_page(a, r)
            if fallback:
                for a, r in zip(
                    fallback,
                    await asyncio.get_event_loop().run_in_executor(
                        None, self._pread_pages, fallback
                    ),
                ):
                    by_addr[a] = r
            return [by_addr[a] for a in addresses]
        return await asyncio.get_event_loop().run_in_executor(
            None, self._pread_pages, addresses
        )

    def read_at_cached(self, pos: int, size: int) -> Optional[bytes]:
        """Cache-only read: the bytes if EVERY page of the range is
        already cached, else None (no disk access, no awaits) — the
        warm-path shortcut that keeps a fully-cached probe synchronous."""
        if size <= 0:
            return b""
        if self._cache is None:
            return None
        end = min(pos + size, self.size)
        out = bytearray()
        address = align_down(pos)
        while address < end:
            page = self._cache.get_copied(self.file_id, address)
            if page is None:
                return None
            lo = pos - address if address <= pos else 0
            hi = min(PAGE_SIZE, end - address)
            out += page[lo:hi]
            address += PAGE_SIZE
        return bytes(out)

    async def read_at_async(self, pos: int, size: int) -> bytes:
        """read_at that never blocks the event loop on disk: cached
        pages are served inline; missing pages are SUBMITTED to the
        loop's io_uring reader (storage/uring.py — true async reads
        with no thread hop, the reference's DmaFile-over-io_uring
        shape, cached_file_reader.rs:28-88) or, when io_uring is
        unavailable, pread in one executor hop.  Cache insertion
        happens back on the loop — cache mutation stays
        loop-confined."""
        if size <= 0:
            return b""
        end = min(pos + size, self.size)
        start = align_down(pos)
        pages = {}
        missing = []
        address = start
        while address < end:
            page = (
                self._cache.get_copied(self.file_id, address)
                if self._cache is not None
                else None
            )
            if page is None:
                missing.append(address)
            else:
                pages[address] = page
            address += PAGE_SIZE
        if missing:
            raws = await self._read_pages_async(missing)
            for address, raw in zip(missing, raws):
                if self._cache is not None:
                    self._cache.set(self.file_id, address, raw)
                pages[address] = raw
        out = bytearray()
        address = start
        while address < end:
            page = pages[address]
            lo = pos - address if address <= pos else 0
            hi = min(PAGE_SIZE, end - address)
            out += page[lo:hi]
            address += PAGE_SIZE
        return bytes(out)


class PageMirroringWriter:
    """Append-only writer that mirrors every completed page into the page
    cache (entry_writer.rs:94-138) and pads the final partial page with
    zeros at close (so files are whole-page sized, as DMA writes are)."""

    def __init__(
        self,
        path: str,
        file_id: Tuple[str, int],
        cache: Optional[PartitionPageCache],
    ) -> None:
        self.path = path
        self.file_id = file_id
        self._cache = cache
        self._fd = os.open(
            path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644
        )
        self._buf = bytearray()
        self._flushed = 0  # bytes written to the OS so far (page multiple)
        self.written = 0  # logical bytes appended
        # CRC32 per completed page, accumulated as pages are emitted —
        # the write-side half of the checksum plane (zero extra I/O;
        # the sums sidecar is assembled from these at close by the
        # sstable-writing call sites).
        self.page_crcs: list = []

    def write(self, data: bytes) -> None:
        self._buf += data
        self.written += len(data)
        if len(self._buf) >= PAGE_SIZE:
            whole = len(self._buf) & ~(PAGE_SIZE - 1)
            self._emit(bytes(self._buf[:whole]))
            del self._buf[:whole]

    def _emit(self, chunk: bytes) -> None:
        if _faults:
            check_write_fault(self.path)
        os.pwrite(self._fd, chunk, self._flushed)
        for off in range(0, len(chunk), PAGE_SIZE):
            self.page_crcs.append(
                zlib.crc32(chunk[off : off + PAGE_SIZE])
            )
        if self._cache is not None:
            for off in range(0, len(chunk), PAGE_SIZE):
                self._cache.set(
                    self.file_id,
                    self._flushed + off,
                    chunk[off : off + PAGE_SIZE],
                )
        self._flushed += len(chunk)

    def close(self, sync: bool = True) -> int:
        """Flush the zero-padded tail, truncate to logical size; returns
        logical size."""
        if self._fd < 0:
            return self.written
        if self._buf:
            tail = bytes(self._buf) + b"\x00" * (
                PAGE_SIZE - len(self._buf) % PAGE_SIZE
            ) if len(self._buf) % PAGE_SIZE else bytes(self._buf)
            self._emit(tail)
            self._buf.clear()
        # Pages are written whole (cache mirroring needs that), but the
        # file's logical length is exact so entry counts derive from size.
        os.ftruncate(self._fd, self.written)
        if _faults and fault_for(self.path) == FAULT_TORN_CLOSE:
            # Torn write: the final page vanishes, as if power died
            # between the tail write and the fsync below.
            os.ftruncate(
                self._fd, align_down(max(0, self.written - 1))
            )
        if sync:
            os.fsync(self._fd)
        os.close(self._fd)
        self._fd = -1
        return self.written

    def abort(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1
        try:
            os.unlink(self.path)
        except OSError:
            pass
