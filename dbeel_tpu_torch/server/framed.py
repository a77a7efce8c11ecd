"""Shared raw-protocol server machinery for the two framed planes.

Both serving surfaces — the client-facing db server (u16-LE frames,
db_server.rs:395-428) and the peer-facing remote shard server (u32-LE
frames, remote_shard_server.rs:23-49) — need the same skeleton: parse
length-prefixed frames in ``data_received``, answer eligible frames
synchronously through the native data plane, queue the rest for an
in-order async drain, and apply read/write backpressure water marks.
This base holds that skeleton ONCE so a fix to the framing or
backpressure logic cannot land in only one plane; subclasses supply
the frame width, the fast-path handler, the per-frame serve step, and
the connection-lifecycle policy (client connections cancel their drain
on disconnect; peer connections keep applying already-received frames
after a fire-and-forget sender's FIN).
"""

from __future__ import annotations

import asyncio
import time
from collections import deque

# _try_fast verdicts.
FAST_MISS = 0  # not handled: queue the frame for _drain
FAST_HANDLED = 1  # answered synchronously: next frame
FAST_CLOSE = 2  # answered + connection closed: stop parsing


class FramedServerProtocol(asyncio.Protocol):
    """Length-prefixed request/response server over a raw transport.

    Subclass contract:
    - ``HEADER``: frame-length prefix width in bytes (little-endian).
    - ``MAX_FRAME``: reject frames above this (None = the header
      width itself is the bound).
    - ``_registry()``: the shard set tracking live connections (for
      shutdown and py3.12 ``Server.wait_closed()``).
    - ``_on_connect()`` / ``_on_disconnect()``: lifecycle policy.
    - ``_on_data()``: per-read bookkeeping (activity stamps, fg_mark).
    - ``_try_fast(frame)``: native fast path; one of the FAST_*
      verdicts.  Only consulted when in-order delivery is safe (no
      queued frames, transport writable).
    - ``_serve_one(frame)``: async slow path; return False to stop
      draining this connection.
    """

    PENDING_HIGH = 64
    PENDING_LOW = 16
    HEADER = 4
    MAX_FRAME: int | None = None

    __slots__ = (
        "shard",
        "transport",
        "buf",
        "pending",
        "task",
        "closing",
        "paused_reading",
        "writable",
        "parked",
        "_parked_drained",
        "_wbuf",
        "_wclose",
        "_wflush_scheduled",
        "window",
        "_aimd_cooldown",
    )

    def __init__(self, my_shard) -> None:
        self.shard = my_shard
        self.transport = None
        self.buf = bytearray()
        self.pending: deque = deque()
        self.task = None
        self.closing = False
        self.paused_reading = False
        self.writable = asyncio.Event()
        self.writable.set()
        # Order-preserving deferred responses (wal-sync group commit:
        # an ack may only leave once a completed fdatasync covers its
        # append).  Entries flush strictly in arrival order; later
        # already-ready responses queue behind a pending head.
        self.parked: deque = deque()
        self._parked_drained = None
        # Response-write coalescing: every response on this
        # connection goes through _write_out, which batches the
        # bytes and makes ONE transport.write per loop tick
        # (call_soon).  A pipelined client draining a 16-deep train
        # costs one send syscall instead of 16 — on this host the
        # per-write syscall is a measurable slice of the serving
        # loop (loopwatch stacks pointed at sock.send).  Ordering is
        # preserved because every response path appends to the same
        # buffer.
        self._wbuf: list = []
        self._wclose = False
        self._wflush_scheduled = False
        # AIMD per-connection window (overload plane): the
        # public plane caps concurrent pipelined frames with it, the
        # peer plane derives its read-pause watermark from it.  None =
        # static behavior (the subclass never initialized it).
        self.window: "float | None" = None
        self._aimd_cooldown = 0

    # -- AIMD window (overload plane) -------------------------------

    def aimd_tick(self, wmin: float, wmax: float) -> None:
        """One completed unit of work: multiplicative decrease while
        the shard's governor reports backlog (at most once per
        window's worth of completions — one halving per 'round trip',
        the classic AIMD guard), additive increase back toward wmax
        while it doesn't.  Drives queueing back into clients when the
        shard is the bottleneck and recovers to full pipelining the
        moment the backlog drains."""
        if self.window is None:
            return
        if self._aimd_cooldown > 0:
            self._aimd_cooldown -= 1
        gov = getattr(self.shard, "governor", None)
        if gov is None:
            return
        if gov.soft_overloaded():
            if self._aimd_cooldown == 0:
                self.window = max(wmin, self.window / 2.0)
                self._aimd_cooldown = max(1, int(self.window))
                gov.note_window(self.window, True)
        elif self.window < wmax:
            self.window = min(
                wmax, self.window + 1.0 / max(1.0, self.window)
            )

    def _pending_high(self) -> int:
        """Read-pause watermark; subclasses may derive it from the
        AIMD window so a backlogged shard pushes bytes back into the
        kernel/client instead of buffering frames."""
        return self.PENDING_HIGH

    # -- lifecycle --------------------------------------------------

    def connection_made(self, transport) -> None:
        self.transport = transport
        self._registry().add(self)
        self._on_connect()

    def connection_lost(self, exc) -> None:
        self._registry().discard(self)
        self.writable.set()  # unblock a _drain awaiting writability
        if self._parked_drained is not None:
            self._parked_drained.set()
        self._on_disconnect()

    # Transport write-buffer backpressure: while the peer reads slowly
    # the loop pauses us; _drain stops serving until resumed, so
    # responses never pile up in an unbounded kernel buffer.
    def pause_writing(self) -> None:
        self.writable.clear()

    def resume_writing(self) -> None:
        self.writable.set()
        # Parked responses released while the transport was
        # write-paused deferred here (see _flush_parked).
        if self.parked:
            self._flush_parked()

    # -- coalesced response writes ----------------------------------

    def _write_out(self, data: bytes, close: bool = False) -> None:
        """Queue response bytes; one transport.write per loop tick.
        ``close=True`` closes the transport right after this chunk
        reaches it (non-keepalive responses) — later appends are
        dropped, like writes to a closed transport were."""
        if (
            self._wclose
            or self.transport is None
            or self.transport.is_closing()
        ):
            return
        if data:
            self._wbuf.append(data)
        if close:
            self._wclose = True
        if not self._wflush_scheduled:
            self._wflush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush_wbuf)

    def _flush_wbuf(self) -> None:
        self._wflush_scheduled = False
        if self.transport is None or self.transport.is_closing():
            self._wbuf.clear()
            return
        if self._wbuf:
            if len(self._wbuf) == 1:
                data = self._wbuf[0]
            else:
                data = b"".join(self._wbuf)
            self._wbuf.clear()
            self.transport.write(data)
        if self._wclose:
            self.closing = True
            self.transport.close()

    def _registry(self) -> set:
        raise NotImplementedError

    def _on_connect(self) -> None:
        pass

    def _on_disconnect(self) -> None:
        pass

    def _on_data(self) -> None:
        pass

    def _try_fast(self, frame: bytes) -> int:
        return FAST_MISS

    async def _serve_one(self, frame: bytes, arrived: float = 0.0) -> bool:
        """``arrived``: time.monotonic() at frame receipt (queue-wait
        attribution for the tracing plane)."""
        raise NotImplementedError

    # -- deferred (sync-parked) responses ---------------------------

    def park_response(
        self, resp, keepalive=True, op=None, started=0.0, done=False
    ):
        """Reserve the next in-order response slot.  ``done=False``
        slots complete later via finish_park (e.g. when the WAL sync
        watermark covers the write); ``done=True`` queues an
        already-ready response behind pending ones so per-connection
        order is preserved.  Returns the entry token."""
        e = [done, resp, keepalive, op, started]
        self.parked.append(e)
        if done:
            self._flush_parked()
        return e

    def finish_park(self, e, resp=None) -> None:
        e[0] = True
        if resp is not None:
            e[1] = resp
        if self.parked and self.parked[0] is not e:
            # Ready, but an earlier response on this connection is
            # still pending: the in-order release rule makes this one
            # wait — the head-of-line pressure counter.
            metrics = getattr(self.shard, "metrics", None)
            if metrics is not None:
                metrics.record_hol_wait()
        self._flush_parked()

    def _flush_parked(self) -> None:
        while self.parked and self.parked[0][0]:
            if (
                not self.writable.is_set()
                and self.transport is not None
                and not self.transport.is_closing()
            ):
                # Transport write-paused (pause_writing): honor the
                # backpressure gate every other response path honors
                # instead of bursting parked acks into the kernel
                # buffer of a slow-reading client; resume_writing
                # re-enters this flush.
                return
            _, resp, keepalive, op, started = self.parked.popleft()
            if op is not None:
                # Metrics stamp at release time: the measured latency
                # honestly includes the fdatasync wait.
                self.shard.metrics.record_request(op, started)
            # Note: ``self.closing`` alone must NOT skip the write —
            # a parked non-keepalive ack sets closing at park time
            # (to stop applying later frames) while its own response
            # is still owed; only a dead transport skips.
            if self.transport is None or self.transport.is_closing():
                continue
            if not keepalive:
                self.closing = True
                self._write_out(
                    resp if resp is not None else b"", close=True
                )
            elif resp is not None:
                self._write_out(resp)
        if not self.parked and self._parked_drained is not None:
            self._parked_drained.set()

    async def _wait_parked_drained(self) -> None:
        """Slow-path responses must queue behind any parked fast-path
        responses on this connection."""
        if not self.parked:
            return
        if self._parked_drained is None:
            self._parked_drained = asyncio.Event()
        while self.parked and not self.closing:
            self._parked_drained.clear()
            await self._parked_drained.wait()

    # -- framing ----------------------------------------------------

    def data_received(self, data: bytes) -> None:
        # lint: allow(stats-schema) — bytearray append, not a counter
        self.buf += data
        self._on_data()
        parsed = False
        hdr = self.HEADER
        while len(self.buf) >= hdr:
            size = int.from_bytes(self.buf[:hdr], "little")
            if self.MAX_FRAME is not None and size > self.MAX_FRAME:
                # Protocol error: stop reading, but frames already
                # received MUST still be applied (fire-and-forget
                # senders close right after their last write; the
                # oversized header may simply be stream garbage after
                # a peer bug).  The drain below applies the backlog;
                # response writes are skipped once the transport
                # closes.
                self.buf.clear()
                self.transport.close()
                break
            if len(self.buf) < hdr + size:
                break
            frame = bytes(self.buf[hdr : hdr + size])
            del self.buf[: hdr + size]
            # Native fast path: only when no async frames are queued
            # (responses must leave in arrival order per connection)
            # and the transport is writable — while the peer reads
            # slowly (pause_writing fired) responses must queue behind
            # _drain's writable.wait(), not pile into the transport
            # buffer unboundedly.
            if (
                self.task is None
                and not self.pending
                and not self.closing
                and self.writable.is_set()
                # Parked (sync-deferred) acks are bounded like pending
                # frames: past the high-water mark new frames take the
                # slow path, whose queue pauses reading — otherwise a
                # pipelining client against a slow fdatasync could grow
                # the parked deque without bound.
                and len(self.parked) <= self.PENDING_HIGH
            ):
                verdict = self._try_fast(frame)
                if verdict == FAST_CLOSE:
                    return
                if verdict:
                    continue
            # Arrival stamp rides with the frame: queue-wait (arrival
            # to dispatch) is the first span stage of a traced op, and
            # one monotonic read per frame is noise next to the parse.
            self.pending.append((frame, time.monotonic()))
            parsed = True
        if (
            len(self.pending) > self._pending_high()
            and not self.paused_reading
        ):
            self.paused_reading = True
            self.transport.pause_reading()
        if parsed and self.task is None:
            self.task = self.shard.spawn(self._drain())

    async def _drain(self) -> None:
        try:
            while self.pending and not self.closing:
                frame, arrived = self.pending.popleft()
                if (
                    self.paused_reading
                    and len(self.pending) < self.PENDING_LOW
                    and not self.transport.is_closing()
                ):
                    self.paused_reading = False
                    self.transport.resume_reading()
                if not await self._serve_one(frame, arrived):
                    return
        except asyncio.CancelledError:
            # Shard shutdown (or client disconnect) cancelled us:
            # suppress the finally-respawn, or the orphan drain would
            # outlive the cancellation snapshot and keep writing to
            # trees the shard is about to close.
            self.closing = True
            raise
        finally:
            self.task = None
            # Frames may have arrived while we were finishing.
            if self.pending and not self.closing:
                self.task = self.shard.spawn(self._drain())
