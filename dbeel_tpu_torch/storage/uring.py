"""asyncio bridge over the native raw-io_uring reader (the port of
``dbeel_tpu/storage/uring.py``).

Role parity with glommio's io_uring read path
(reference src/storage_engine/cached_file_reader.rs:28-88,
DmaFile::read_at_aligned): page reads SUBMIT from the event-loop
thread without blocking and complete via an eventfd the loop polls —
no executor threads and no thread hop on every cold point read.

One ``UringReader`` per event loop (``get_for_loop``); callers take
the executor path when io_uring is unavailable (sandboxes, old kernels
that refuse a ring, lib not built) or the submission queue is full.
The ``dbeel_uring_*`` symbols are bound by ``storage/native.py``'s
prototype table, like every other symbol of ``native/``.
"""

from __future__ import annotations

import asyncio
import ctypes
import logging
import os
import weakref
from typing import Dict, Optional, Tuple

from . import native as native_mod

log = logging.getLogger(__name__)

_ENTRIES = 256
_loop_readers: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_unavailable = False
# Buffers abandoned at release while kernel reads were in flight (see
# _destroy) — intentionally immortal.
_leaked_buffers: list = []


class UringReader:
    """Event-loop-confined io_uring submission/completion bridge."""

    def __init__(self, loop: asyncio.AbstractEventLoop, lib) -> None:
        self._lib = lib
        self._h = lib.dbeel_uring_create(_ENTRIES)
        if not self._h:
            raise OSError("io_uring unavailable")
        self._efd = lib.dbeel_uring_eventfd(self._h)
        # The loop is held weakly: the loop's selector holds the reader
        # (through ``_drain``), never the other way round.
        self._loop = weakref.ref(loop)
        self._tag = 0
        # tag -> (future, requested_len); tag -> buffer the kernel fills
        self._pending: Dict[int, Tuple[asyncio.Future, int]] = {}
        self._bufs: Dict[int, object] = {}
        self._reap_tags = (ctypes.c_uint64 * _ENTRIES)()
        self._reap_res = (ctypes.c_int32 * _ENTRIES)()
        loop.add_reader(self._efd, self._drain)
        # Frees the ring (fd, eventfd, mmaps) when the reader goes,
        # which is when its loop closes and drops ``_drain``.  The
        # callback holds no reference to the reader or the loop.
        weakref.finalize(self, _destroy, lib, self._h, self._bufs)

    def queue_pread(
        self, fd: int, size: int, offset: int
    ) -> Optional[asyncio.Future]:
        """Queue one positional read WITHOUT submitting; call
        ``flush()`` once per batch (one syscall for the whole miss
        list).  Returns a Future resolving to the raw bytes (possibly
        short at EOF), or None when the ring is at capacity / gone
        (caller falls back to the executor path).  The C side caps
        in-flight + queued at the CQ size, so completions can never
        overflow and hang."""
        loop = self._loop()
        if loop is None:
            return None
        buf = ctypes.create_string_buffer(size)
        self._tag += 1
        tag = self._tag
        rc = self._lib.dbeel_uring_queue_read(
            self._h,
            fd,
            ctypes.cast(buf, ctypes.c_void_p),
            size,
            offset,
            tag,
        )
        if rc != 0:
            return None
        fut = loop.create_future()
        self._pending[tag] = (fut, size)
        self._bufs[tag] = buf
        return fut

    def flush(self) -> bool:
        """Submit everything queued; False on kernel rejection (the
        queued futures will then never complete — callers must treat
        this as fatal for those reads)."""
        return self._lib.dbeel_uring_flush(self._h) >= 0

    def submit_pread(
        self, fd: int, size: int, offset: int
    ) -> Optional[asyncio.Future]:
        """queue_pread + flush for single-read callers."""
        fut = self.queue_pread(fd, size, offset)
        if fut is None:
            return None
        if not self.flush():
            self._pending.pop(self._tag, None)
            self._bufs.pop(self._tag, None)
            return None
        return fut

    def _drain(self) -> None:
        try:
            os.read(self._efd, 8)
        except BlockingIOError:
            pass
        while True:
            n = self._lib.dbeel_uring_reap(
                self._h, self._reap_tags, self._reap_res, _ENTRIES
            )
            if n <= 0:
                break
            for i in range(n):
                tag = int(self._reap_tags[i])
                entry = self._pending.pop(tag, None)
                buf = self._bufs.pop(tag, None)
                if entry is None:
                    continue
                fut, _size = entry
                if fut.done():
                    continue
                res = int(self._reap_res[i])
                if res < 0:
                    fut.set_exception(
                        OSError(-res, os.strerror(-res))
                    )
                else:
                    fut.set_result(buf.raw[:res])
            if n < _ENTRIES:
                break


def _destroy(lib, h, bufs: Dict[int, object]) -> None:
    if bufs:
        # The kernel may still DMA into these buffers after the ring fd
        # closes (in-flight ops hold references): leak them on purpose
        # rather than free memory under a live write.
        _leaked_buffers.append(list(bufs.values()))
    lib.dbeel_uring_destroy(h)


def get_for_loop(
    loop: Optional[asyncio.AbstractEventLoop] = None,
) -> Optional[UringReader]:
    """The loop's UringReader, created on first use; None when the
    kernel refuses a ring or the native lib is unavailable."""
    global _unavailable
    if _unavailable:
        return None
    if loop is None:
        loop = asyncio.get_event_loop()
    ref = _loop_readers.get(loop)
    reader = ref() if ref is not None else None
    if reader is not None:
        return reader
    lib = native_mod.load_if_built()
    if lib is None:
        _unavailable = True
        return None
    try:
        reader = UringReader(loop, lib)
    except OSError as e:
        log.info("io_uring unavailable (%s); executor reads", e)
        _unavailable = True
        return None
    # Weak both ways: the map pins neither the loop nor its reader.
    _loop_readers[loop] = weakref.ref(reader)
    return reader
