"""Write-ahead log with page-padded records and coalesced fdatasync.

Role parity with the reference's WAL (reference src/storage_engine/
lsm_tree.rs:805-837 write path, 552-574 recovery): every set appends one
record at a page-aligned offset, padded to a whole number of 4 KiB pages;
sync is off by default, immediate with ``wal_sync``, or delay-coalesced
with ``wal_sync_delay`` (many writers share one fdatasync, lsm_tree.rs:
817-832).  Recovery strides the file page by page re-applying records.

Record layout at each page-aligned offset:
    [u32 magic][u32 entry_len][u32 crc32(entry)][u32 reserved][entry bytes]
padded with zeros to the next page boundary.  The crc + magic make torn
tail writes detectable (recovery stops at the first invalid record).

Two append paths write that same format.  When the native library
(``native/``) is built, a C appender encodes, CRCs and pwrites each
record in one call and owns the offset while it lives; durable
(``sync``) WALs then group-commit through the native syncer — the
io_uring sync hub (fsyncs as SQEs on one ring whose eventfd the event
loop polls, no threads), or a dedicated C sync thread when the hub is
off.  Without the library, records are encoded and written here and
durable appends coalesce their fdatasync on an executor thread.
``DBEEL_NO_WAL_SYNCER=1`` turns both native syncers off;
``DBEEL_NO_WAL_HUB=1`` selects the thread over the hub.
"""

from __future__ import annotations

import asyncio
import heapq
import logging
import os
import struct
import zlib
from collections import deque
from typing import Iterator, Tuple

from .entry import PAGE_SIZE, decode_entry, encode_entry
from ..utils.event import LocalEvent

log = logging.getLogger(__name__)

_MAGIC = 0x77A11065


def hub_fsync_errors() -> "int | None":
    """Process-wide count of FAILED IORING_OP_FSYNC completions in
    the native wal-sync hub: a non-zero value means the device
    rejected syncs and durable acks were held back and retried.  None
    when the native library is not built."""
    from . import native as native_mod

    lib = native_mod.load_if_built()
    if lib is None:
        return None
    return int(lib.dbeel_walsync_errors())


# Process-wide wal-sync group-commit accounting: how many durable acks
# each completed fdatasync released.  Updated by both sync backends —
# the native syncer's release pump and the executor-coalesced Python
# path — so the metric survives the backend switches.
_group_commit = {"syncs": 0, "ops_acked": 0, "max_batch": 0}


def _record_group_commit(released: int) -> None:
    if released <= 0:
        return
    _group_commit["syncs"] += 1
    _group_commit["ops_acked"] += released
    if released > _group_commit["max_batch"]:
        _group_commit["max_batch"] = released


def group_commit_stats() -> dict:
    g = _group_commit
    return {
        "syncs": g["syncs"],
        "ops_acked": g["ops_acked"],
        "max_batch": g["max_batch"],
        "mean_batch": (
            round(g["ops_acked"] / g["syncs"], 2) if g["syncs"] else None
        ),
    }
_HEADER = struct.Struct("<IIII")


class _SyncHub:
    """Process-wide io_uring group-commit hub (zero sync threads).

    Thread-mode wal-sync costs one dedicated fdatasync thread per WAL
    plus a cv->thread->eventfd->epoll wake chain per durable ack.  The
    hub (native dbeel_walsync_hub_*) queues IORING_OP_FSYNC SQEs
    straight from the append path on a ring whose registered eventfd
    the loop polls — no threads at all, and fsyncs for different WALs
    overlap in the kernel.  Reference analog: glommio runs the WAL
    fdatasync on the same per-core io_uring reactor (reference
    src/storage_engine/lsm_tree.rs:805-837).

    Single-threaded contract: all attached WALs append from the one
    loop thread (server run_node / per-shard process / test loop).
    Across sequential loops (tests), the eventfd reader rebinds to
    the currently-running loop on first use."""

    _instance = None  # None = untried, False = unavailable

    def __init__(self, lib, handle) -> None:
        self._lib = lib
        self._h = handle
        self._efd = lib.dbeel_walsync_hub_eventfd(handle)
        self._syncers: set = set()
        self._loop = None

    @classmethod
    def get(cls, lib):
        if cls._instance is None:
            cls._instance = False
            try:
                # NULL when io_uring is unavailable (a kernel with it
                # disabled, a seccomp filter): the WALs use thread mode.
                h = lib.dbeel_walsync_hub_new(128)
                if h:
                    cls._instance = cls(lib, h)
            except Exception:
                log.exception("wal sync hub unavailable")
        return cls._instance or None

    def register(self, syncer) -> None:
        self._syncers.add(syncer)
        loop = asyncio.get_event_loop()
        if self._loop is not loop:
            if self._loop is not None:
                try:
                    self._loop.remove_reader(self._efd)
                except Exception:
                    pass  # previous loop already torn down
            self._loop = loop
            loop.add_reader(self._efd, self._on_ready)

    def unregister(self, syncer) -> None:
        self._syncers.discard(syncer)

    def _on_ready(self) -> None:
        try:
            os.read(self._efd, 8)
        except (BlockingIOError, OSError):
            pass
        self._lib.dbeel_walsync_hub_reap(self._h)
        for s in list(self._syncers):
            s._pump()


class _NativeSyncer:
    """Event-loop bridge for native wal-sync group commit.  Two
    backends behind one park/wait/ticket surface:

    * hub mode (preferred): the io_uring _SyncHub above — the fsync
      is a SQE submitted from the append path, completion arrives on
      the hub's shared eventfd, zero threads.
    * thread mode (fallback, no io_uring): a dedicated C thread owns
      the coalesced fdatasync (dbeel_wal_sync_enable) and pings a
      per-WAL eventfd.

    Either way this object parks serving-plane responses and
    slow-path waiters on sync *tickets* (append sequence numbers) and
    releases them once the published watermark covers them — so a
    durable ack never leaves before its fdatasync, and the event loop
    never blocks on one (reference semantics: reference
    src/storage_engine/lsm_tree.rs:805-837)."""

    def __init__(self, lib, native, delay_us: int, hub=None) -> None:
        self._lib = lib
        self._native = native
        self._hub = hub
        if hub is not None:
            if lib.dbeel_wal_sync_attach(native, hub._h, delay_us) != 0:
                raise OSError("wal sync attach failed")
            self._efd = -1
        else:
            self._efd = os.eventfd(0, os.EFD_NONBLOCK | os.EFD_CLOEXEC)
            if lib.dbeel_wal_sync_enable(
                native, delay_us, self._efd
            ) != 0:
                os.close(self._efd)
                raise OSError("wal sync enable failed")
        self._loop = None
        self._parks: deque = deque()  # (ticket, callback), FIFO==ticket order
        self._waiters: list = []  # heap of (ticket, n, future)
        self._wseq = 0
        self._closed = False
        self._stopping = False
        self._on_done: list = []

    def ticket(self) -> int:
        """Current append sequence — call immediately after the
        append whose durability you need (loop thread only)."""
        return self._lib.dbeel_wal_seq(self._native)

    def _ensure_reader(self) -> None:
        if self._loop is None:
            self._loop = asyncio.get_event_loop()
            if self._hub is not None:
                self._hub.register(self)
            else:
                self._loop.add_reader(self._efd, self._on_ready)

    def park(self, ticket: int, cb) -> None:
        """Run ``cb()`` once a completed sync covers ``ticket``.
        Calls arrive in ticket order (single loop thread)."""
        if self._closed:
            cb()
            return
        self._ensure_reader()
        self._parks.append((ticket, cb))

    async def wait(self, ticket: int) -> None:
        if self._closed:
            return
        if self._lib.dbeel_wal_synced(self._native) >= ticket:
            return
        self._ensure_reader()
        fut = self._loop.create_future()
        self._wseq += 1
        heapq.heappush(self._waiters, (ticket, self._wseq, fut))
        await fut

    def _on_ready(self) -> None:
        try:
            os.read(self._efd, 8)  # clear the eventfd counter
        except (BlockingIOError, OSError):
            pass
        self._pump()

    def _pump(self) -> None:
        """Release everything a completed sync now covers (called
        from the per-WAL eventfd callback in thread mode, from the
        hub dispatcher in hub mode)."""
        self._release(self._lib.dbeel_wal_synced(self._native))
        if self._stopping and not self._closed:
            # Async close handshake: the backend's exit signal (final
            # drain published, watermark == seq) finishes the
            # shutdown here — the disable below then lands on an
            # already-exited thread / empty hub slot, so the loop
            # never blocks on an in-flight usleep/fdatasync.
            seq = self._lib.dbeel_wal_seq(self._native)
            if self._lib.dbeel_wal_synced(self._native) >= seq:
                self._finish_close()

    def _release(self, synced: int) -> None:
        released = 0
        while self._parks and self._parks[0][0] <= synced:
            _, cb = self._parks.popleft()
            released += 1
            try:
                cb()
            except Exception:
                log.exception("parked wal-sync ack release failed")
        while self._waiters and self._waiters[0][0] <= synced:
            _, _, fut = heapq.heappop(self._waiters)
            released += 1
            if not fut.done():
                fut.set_result(None)
        _record_group_commit(released)

    def close(self, on_done=None) -> None:
        """Stop the C sync thread (its final drain covers every
        outstanding append) and release everything parked.  Called
        before the WAL closes — by then flush has made the contents
        durable via the sstable, so releasing is correct even if the
        final fdatasync raced the close.

        When an event-loop reader is active this is ASYNCHRONOUS: the
        stop is signalled, the thread finishes its final drain off
        the loop, and its exit ping completes the shutdown from the
        eventfd callback (the loop never blocks on an in-flight
        usleep/fdatasync).  ``on_done`` runs after the
        native side is fully released (the WAL uses it to defer
        closing its fd/handle).  Without a reader (no loop engaged)
        it degrades to the synchronous join."""
        if self._closed:
            if on_done is not None:
                on_done()
            return
        if self._stopping:
            if on_done is not None:
                self._on_done.append(on_done)
            return
        if on_done is not None:
            self._on_done.append(on_done)
        # The async handshake needs a LIVE loop to deliver the exit
        # ping; after loop shutdown (process teardown, __del__) fall
        # back to the synchronous join or the native handle, eventfd,
        # and any pending unlink would leak forever.
        if self._loop is not None and self._loop.is_running():
            self._stopping = True
            self._lib.dbeel_wal_sync_stop_async(self._native)
            return  # _pump finishes via the exit ping
        self._finish_close()

    def _finish_close(self) -> None:
        if self._closed:
            return
        self._closed = True
        # Thread mode: joins the sync thread (already exited on the
        # async path — its exit ping got us here).  Hub mode: detaches
        # the slot, draining any straggler SQE.
        self._lib.dbeel_wal_sync_disable(self._native)
        if self._hub is not None:
            self._hub.unregister(self)
        elif self._loop is not None:
            try:
                self._loop.remove_reader(self._efd)
            except Exception:
                pass
        self._release(self._lib.dbeel_wal_seq(self._native))
        if self._efd >= 0:
            os.close(self._efd)
        self._efd = -1
        for cb in self._on_done:
            try:
                cb()
            except Exception:
                log.exception("wal close completion callback failed")
        self._on_done = []


def _padded(n: int) -> int:
    return (n + PAGE_SIZE - 1) & ~(PAGE_SIZE - 1)


def _encode_record(key: bytes, value: bytes, timestamp: int) -> bytes:
    """One page-padded WAL record — the single owner of the on-disk
    framing (magic + length + crc + entry + zero padding), shared by
    the single-append and batch-append Python paths so the two can
    never diverge from what recovery parses."""
    entry = encode_entry(key, value, timestamp)
    record = _HEADER.pack(
        _MAGIC, len(entry), zlib.crc32(entry), 0
    ) + entry
    return record + b"\x00" * (_padded(len(record)) - len(record))


class Wal:
    def __init__(
        self,
        path: str,
        sync: bool = False,
        sync_delay_us: int = 0,
        on_error=None,
    ) -> None:
        self.path = path
        self._sync = sync
        self._sync_delay_us = sync_delay_us
        # Disk-fault escalation hook (degraded mode): called with the
        # OSError when an append or fdatasync hits EIO/ENOSPC.
        self._on_error = on_error
        self._fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
        # Resume appending after the last *valid* record: a torn tail from
        # a crash must be overwritten, not skipped, or post-recovery
        # appends land beyond the point where replay stops and acked
        # writes become unreachable.
        self._offset = _valid_end(self._fd)
        os.ftruncate(self._fd, self._offset)
        # Native appender (encode + crc + padded pwrite in one C call):
        # it owns the offset while alive, so the serving data plane and
        # this class can interleave appends on one shared counter.
        self._native = None
        self._lib = None
        try:
            from . import native as native_mod

            lib = native_mod.load_if_built()
            if lib is not None:
                handle = lib.dbeel_wal_new(self._fd, self._offset)
                if handle:
                    self._native = handle
                    self._lib = lib
        except Exception:
            self._native = None
        self._seq = 0  # appends so far
        self._synced_seq = 0  # appends covered by a completed fdatasync
        self._syncing = False
        self._sync_event = LocalEvent()
        self._inflight_syncs = 0
        self._closing = False
        self._unlink_on_close = False
        self._disposed = False
        self._dispose_future = None
        self._dispose_waiter = None
        self._sync_closing = False
        self._closing_syncer = None
        # Native group-commit syncer — hub mode (io_uring SQEs from
        # the append path, zero threads) with a dedicated-C-thread
        # fallback when io_uring is unavailable; without either,
        # durable writes take the executor-coalesced fdatasync path.
        # DBEEL_NO_WAL_SYNCER=1 disables both native backends;
        # DBEEL_NO_WAL_HUB=1 forces thread mode.
        self._syncer = None
        if (
            sync
            and self._native is not None
            and hasattr(os, "eventfd")
            and os.environ.get("DBEEL_NO_WAL_SYNCER", "0")
            in ("", "0")
        ):
            hub = None
            if os.environ.get("DBEEL_NO_WAL_HUB", "0") in ("", "0"):
                hub = _SyncHub.get(self._lib)
            if hub is not None:
                try:
                    self._syncer = _NativeSyncer(
                        self._lib, self._native, sync_delay_us, hub
                    )
                except Exception:
                    log.exception("wal sync hub attach failed")
                    self._syncer = None
            if self._syncer is None:
                try:
                    self._syncer = _NativeSyncer(
                        self._lib, self._native, sync_delay_us
                    )
                except Exception:
                    log.exception("native wal syncer unavailable")
                    self._syncer = None

    def _report_io_error(self, e: BaseException) -> None:
        if self._on_error is not None:
            try:
                self._on_error(e)
            except Exception:
                log.exception("wal on_error callback failed")

    def _append_record_sync(
        self, key: bytes, value: bytes, timestamp: int
    ) -> None:
        """One record appended, no sync (shared by append and
        append_batch; the native appender owns the offset when
        present).  EIO/ENOSPC surfaces as OSError AND fires the
        on_error escalation hook — both write backends inject
        identically through the file_io fault seam."""
        from . import file_io as _fio

        try:
            if _fio._faults:
                _fio.check_write_fault(self.path)
            if self._native is not None:
                new_off = self._lib.dbeel_wal_append(
                    self._native,
                    key,
                    len(key),
                    value,
                    len(value),
                    timestamp,
                )
                if new_off == 0:
                    raise OSError(
                        f"WAL append failed for {self.path}"
                    )
                self._offset = new_off
            else:
                record = _encode_record(key, value, timestamp)
                os.pwrite(self._fd, record, self._offset)
                self._offset += len(record)
        except OSError as e:
            self._report_io_error(e)
            raise
        self._seq += 1

    async def append(self, key: bytes, value: bytes, timestamp: int) -> None:
        self._append_record_sync(key, value, timestamp)
        await self._maybe_sync()

    async def append_batch(
        self, entries: "list[tuple[bytes, bytes, int]]"
    ) -> None:
        """Append N records, pay ONE durability wait (group commit).
        Record layout on disk is identical to N single appends —
        recovery/replay cannot tell them apart.  Without the native
        appender the records are concatenated into one buffer and land
        in a single pwrite (the writev shape); with it, appends are
        already a few µs of C each and the win is the single shared
        fdatasync ticket below."""
        if not entries:
            return
        if self._native is not None:
            for key, value, ts in entries:
                self._append_record_sync(key, value, ts)
        else:
            blob = b"".join(
                _encode_record(key, value, ts)
                for key, value, ts in entries
            )
            try:
                from . import file_io as _fio

                if _fio._faults:
                    _fio.check_write_fault(self.path)
                os.pwrite(self._fd, blob, self._offset)
            except OSError as e:
                self._report_io_error(e)
                raise
            self._offset += len(blob)
            self._seq += len(entries)
        await self._maybe_sync()

    async def _fdatasync(self) -> None:
        """fdatasync guarded against the flush path closing this WAL while
        a coalesced sync is still in flight (the file's contents are then
        durable via the flushed sstable instead)."""
        if self._closing or self._fd < 0:
            return
        self._inflight_syncs += 1

        def _sync_fd(fd=self._fd, path=self.path):
            from . import file_io as _fio

            if _fio._faults:
                _fio.check_write_fault(path)
            os.fdatasync(fd)

        try:
            await asyncio.get_event_loop().run_in_executor(
                None, _sync_fd
            )
        except OSError as e:
            # Riders are still released (the flush path makes the
            # contents durable via the sstable), but the failure
            # escalates: a device that rejects fsync is exactly the
            # degraded-mode trigger.
            self._report_io_error(e)
        finally:
            self._inflight_syncs -= 1
            if self._closing and self._inflight_syncs == 0:
                self._really_close()

    async def _maybe_sync(self) -> None:
        """Return only once a completed fdatasync covers this writer's
        append.  Writers that arrive while a sync is already in flight
        wait for a *later* sync — riding the in-flight one would ack bytes
        that fdatasync began before they were written
        (coalescing a la lsm_tree.rs:817-832, but watermark-correct)."""
        if not self._sync:
            return
        if self._syncer is not None:
            # Ticket = the native appender's sequence (it counted this
            # append); no await happened since, so it is exactly ours.
            await self._syncer.wait(self._syncer.ticket())
            return
        my_seq = self._seq
        while self._synced_seq < my_seq and not self._closing:
            if self._syncing:
                await self._sync_event.listen()
                continue
            self._syncing = True
            try:
                if self._sync_delay_us > 0:
                    await asyncio.sleep(self._sync_delay_us / 1e6)
                covered = self._seq
                await self._fdatasync()
                _record_group_commit(covered - self._synced_seq)
                self._synced_seq = max(self._synced_seq, covered)
            finally:
                self._syncing = False
                self._sync_event.notify()

    def _really_close(self) -> None:
        if self._native is not None:
            self._lib.dbeel_wal_free(self._native)
            self._native = None
        fd, self._fd = self._fd, -1
        unlink = self._unlink_on_close
        if fd < 0 and not unlink:
            return
        path = self.path

        def _dispose():
            # close() of a WAL with dirty page-cache data and unlink
            # of a page-padded multi-MB file both BLOCK for tens of
            # ms.  Retired-WAL disposal is pure
            # cleanup with no ordering contract beyond the flush
            # being durable (which it is before delete() is called),
            # so it runs on an executor thread when a loop is up.
            # The NEXT flush awaits wait_disposed() before creating
            # its WAL, keeping the on-disk invariant at <= 2 WALs
            # for the recovery protocol.
            try:
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                if unlink:
                    try:
                        os.unlink(path)
                    except OSError:
                        pass
            finally:
                self._disposed = True

        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            _dispose()
            return
        self._dispose_future = loop.run_in_executor(None, _dispose)
        if (
            self._dispose_waiter is not None
            and not self._dispose_waiter.done()
        ):
            self._dispose_waiter.set_result(None)

    def join_disposed(self, timeout: float = 2.0) -> bool:
        """Synchronously wait (bounded) for an IN-FLIGHT off-loop
        disposal — terminal-path helper for LSMTree.close(): an
        in-process close->reopen of the same directory must not race
        recovery's file listing against the retired WAL's executor
        unlink.  Polling is safe only once the executor job exists
        (that thread progresses independently of the caller's loop);
        when disposal hasn't been scheduled yet (async-syncer close
        handshake still pending on loop callbacks) blocking here from
        the loop thread would PREVENT it — return False immediately
        and let recovery's own retry (LSMTree._open) absorb a later
        unlink."""
        import time as _time

        if self._dispose_future is None:
            return self._disposed
        deadline = _time.monotonic() + timeout
        while not self._disposed and _time.monotonic() < deadline:
            _time.sleep(0.002)
        return self._disposed

    async def wait_disposed(self) -> None:
        """Resolve once the off-loop fd close / unlink has finished
        (flush-ordering hook: at most 2 WALs may ever exist on
        disk)."""
        if self._dispose_future is None and not self._disposed:
            # Disposal not scheduled yet (async syncer close still in
            # flight): _really_close resolves this waiter the moment
            # it schedules the executor job.
            if self._dispose_waiter is None:
                self._dispose_waiter = (
                    asyncio.get_running_loop().create_future()
                )
            await self._dispose_waiter
        if self._dispose_future is not None:
            await self._dispose_future

    def close(self) -> None:
        self._closing = True
        if self._sync_closing:
            # Async syncer shutdown already pending: a second close()
            # (__del__, delete()) must NOT free the native handle the
            # in-flight eventfd callback still dereferences — UNLESS
            # the loop has stopped for good, in which case the exit
            # ping will never be delivered and the handshake must be
            # finished synchronously here (the C disable joins the
            # already-exiting thread) or the native handle, eventfd,
            # WAL fd, and a delete()'s unlink all leak.
            s = self._closing_syncer
            if s is not None and (
                s._loop is None or not s._loop.is_running()
            ):
                self._closing_syncer = None
                s._finish_close()
            return
        if self._syncer is not None:
            # Async shutdown: the C thread's final drain runs off the
            # loop; fd/handle teardown (and file unlink, see delete)
            # defer to its completion callback.  dbeel_wal_free's own
            # sync_disable then joins an already-exited thread.
            self._sync_closing = True
            syncer, self._syncer = self._syncer, None
            self._closing_syncer = syncer
            syncer.close(on_done=self._close_when_unreferenced)
            return
        self._sync_event.notify()  # release riders; contents now owned
        if self._inflight_syncs == 0:  # by the flushed sstable
            self._really_close()

    def _close_when_unreferenced(self) -> None:
        self._sync_closing = False
        self._closing_syncer = None
        self._sync_event.notify()
        if self._inflight_syncs == 0:
            self._really_close()

    def delete(self) -> None:
        self._unlink_on_close = True
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _valid_end(fd: int) -> int:
    """Byte offset just past the last valid record in an open WAL."""
    size = os.fstat(fd).st_size
    buf = os.pread(fd, size, 0)
    offset = 0
    while offset + _HEADER.size <= len(buf):
        magic, entry_len, crc, _ = _HEADER.unpack_from(buf, offset)
        if magic != _MAGIC:
            break
        start = offset + _HEADER.size
        end = start + entry_len
        if end > len(buf) or zlib.crc32(buf[start:end]) != crc:
            break
        offset += _padded(_HEADER.size + entry_len)
    return offset


def replay(path: str) -> Iterator[Tuple[bytes, bytes, int]]:
    """Yield (key, value, timestamp) records; stops at the first hole or
    corrupt record (torn tail write)."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return
    offset = 0
    n = len(buf)
    while offset + _HEADER.size <= n:
        magic, entry_len, crc, _ = _HEADER.unpack_from(buf, offset)
        if magic != _MAGIC:
            return
        start = offset + _HEADER.size
        end = start + entry_len
        if end > n:
            return
        entry = buf[start:end]
        if zlib.crc32(entry) != crc:
            return
        key, value, ts, _ = decode_entry(entry)
        yield key, value, ts
        offset += _padded(_HEADER.size + entry_len)
