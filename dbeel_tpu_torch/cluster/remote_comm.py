"""Inter-node shard RPC plane: msgpack over TCP.

Role parity with reference src/remote_shard_connection.rs:15-120:
connect-per-request with connect/read/write timeouts, 4-byte LE length
framing, typed helpers (ping / get_metadata / get_collections /
send_request), plus a persistent stream for migration
(migration.rs:70-72).
"""

from __future__ import annotations

import asyncio
import os
import struct
from collections import deque
from typing import List, Optional, Tuple

from ..errors import (
    ConnectionError_,
    Overloaded,
    ProtocolError,
    Timeout,
)
from . import messages
from .messages import (
    NodeMetadata,
    ShardRequest,
    ShardResponse,
    pack_message,
    response_to_result,
    unpack_message,
)

_LEN = struct.Struct("<I")
MAX_MESSAGE = 64 << 20

# ---------------------------------------------------------------------
# Test-only fault-injection seam (failure-aware request plane): tests
# mark a peer address as refusing / black-holing / delaying its
# remote-shard plane, and every RemoteShardConnection to it behaves
# accordingly — deterministic dead-peer scenarios with no real node
# kills, no OS-level tricks.  Production never touches this: the dict
# stays empty and the per-call check is one hash miss.
# ---------------------------------------------------------------------

FAULT_REFUSE = "refuse"  # connect refused / reset instantly
FAULT_BLACKHOLE = "blackhole"  # accepts, never answers (cancellable)

_faults: dict = {}  # "<ip>:<port>" -> mode | ("delay", seconds)


def set_fault(address: str, mode) -> None:
    """Arm a fault for one peer address (``None`` disarms)."""
    if mode is None:
        _faults.pop(address, None)
    else:
        _faults[address] = mode


def clear_faults() -> None:
    _faults.clear()


def _arm_from_env() -> None:
    """``DBEEL_REMOTE_FAULTS="<ip:port>=<mode>[,...]"`` pre-arms
    faults at import — the subprocess twin of set_fault (mirroring
    storage/file_io's DBEEL_DISK_FAULTS), so harnesses running real
    node processes (chaos_soak --partition) can impose an ASYMMETRIC
    partition: the armed node cannot reach the listed peers' shard
    planes while they reach it fine.

    ``DBEEL_REMOTE_FAULTS_DELAY_S=N`` arms them N seconds AFTER
    import instead: the node boots cleanly, discovers its peers and
    joins the ring, and the partition then drops mid-operation — the
    realistic onset, and the one that exercises detector-bounded
    blind windows plus departed-node hinting rather than a node that
    never learned its peers existed."""
    spec = os.environ.get("DBEEL_REMOTE_FAULTS", "")
    if not spec:
        return

    def arm() -> None:
        for part in spec.split(","):
            if "=" in part:
                address, mode = part.rsplit("=", 1)
                if address and mode:
                    _faults[address] = mode

    delay = float(
        os.environ.get("DBEEL_REMOTE_FAULTS_DELAY_S", "0") or 0
    )
    if delay > 0:
        import threading

        timer = threading.Timer(delay, arm)
        timer.daemon = True
        timer.start()
    else:
        arm()


_arm_from_env()


async def _apply_fault(conn: "RemoteShardConnection") -> None:
    """Raise/stall per the armed fault for this connection, if any."""
    mode = _faults.get(conn.address)
    if mode is None:
        return
    if mode == FAULT_REFUSE:
        raise ConnectionError_(
            f"connect to {conn.address}: [fault] connection refused"
        )
    if mode == FAULT_BLACKHOLE:
        # Hang like a partitioned peer: nothing comes back until the
        # read timeout (or the caller cancels us — the detector-bound
        # mid-flight cancellation path).
        await asyncio.sleep(conn.read_timeout)
        raise Timeout(f"rpc to {conn.address} [fault blackhole]")
    kind, seconds = mode  # ("delay", s)
    assert kind == "delay"
    await asyncio.sleep(seconds)


async def send_message_to_stream(
    writer: asyncio.StreamWriter, message: list
) -> None:
    buf = pack_message(message)
    writer.write(_LEN.pack(len(buf)) + buf)
    await writer.drain()


async def read_frame(reader: asyncio.StreamReader) -> bytes:
    """One u32-LE length-prefixed frame payload, MAX_MESSAGE-bounded."""
    header = await reader.readexactly(_LEN.size)
    (size,) = _LEN.unpack(header)
    if size > MAX_MESSAGE:
        raise ProtocolError(f"frame too large: {size}")
    return await reader.readexactly(size)


async def get_message_from_stream(reader: asyncio.StreamReader) -> list:
    return unpack_message(await read_frame(reader))


def _pipeline_enabled() -> bool:
    return os.environ.get("DBEEL_NO_PEER_PIPELINE", "0") in ("", "0")


# Request kinds eligible for FIFO stream multiplexing: the quick data
# verbs a coordinator fans out per-op.  Bulk transfers (RANGE_*) and
# admin/probe traffic keep their own round trips — a multi-second
# RANGE_PULL response parked in front of quorum acks would be
# self-inflicted head-of-line blocking.
_PIPE_KINDS = frozenset(
    (
        ShardRequest.SET,
        ShardRequest.DELETE,
        ShardRequest.GET,
        ShardRequest.GET_DIGEST,
        ShardRequest.MULTI_SET,
        ShardRequest.MULTI_GET,
    )
)
_MULTI_KINDS = frozenset(
    (ShardRequest.MULTI_SET, ShardRequest.MULTI_GET)
)
# MULTI batches are data verbs but not bounded like single ops (up to
# 4096 sub-ops of arbitrary values; a multi_get's aligned response
# can be multi-MB off a small request).  One such frame parked on THE
# shared stream would block every quick verb queued behind it — the
# same head-of-line hazard RANGE_* is excluded for — and the FIFO
# read timeout would kill the stream and fail every in-flight op.
# Oversized batches take a pooled round trip instead.
_PIPE_MAX_FRAME = 128 * 1024
_PIPE_MAX_SUBOPS = 256


class _PipeStream:
    """One persistent peer stream carrying many in-flight frames,
    FIFO-matched (all-native serving path): the remote shard
    server releases responses strictly in frame-arrival order (the
    framed base's parked queue), so the n-th response on the stream
    answers the n-th request — the same multiplexing contract the
    public plane's pipelined clients use.  A send is one buffered
    ``writer.write`` with no await before the future is enqueued, so
    concurrent senders can never interleave partial frames or desync
    the FIFO."""

    __slots__ = ("reader", "writer", "inflight", "dead", "task")

    def __init__(self, reader, writer) -> None:
        self.reader = reader
        self.writer = writer
        self.inflight: deque = deque()
        self.dead = False
        self.task = None  # reader-loop task (strong ref, no GC)

    def kill(self, why: str) -> None:
        """Close the stream and fail every in-flight future: a stream
        that timed out or errored may still deliver late bytes that
        would FIFO-match the wrong op — it must never be reused."""
        if self.dead:
            return
        self.dead = True
        try:
            self.writer.close()
        except Exception:
            pass
        while self.inflight:
            fut = self.inflight.popleft()
            if not fut.done():
                fut.set_exception(ConnectionError_(why))


class RemoteShardConnection:
    """``pooled=True`` keeps request/response connections open between
    calls (the remote shard server is a persistent multi-message loop,
    remote_shard_server.rs:23-49) — used for ring entries, where the
    reference's connect-per-request (rs:50-72) dominates quorum
    latency.  Events stay connect-per-send: an event error produces a
    server-side error response with no reader, which would desync a
    pooled stream.

    Slow-peer isolation (overload plane): in-flight ops (and
    pre-packed frame bytes) to this peer are capped.  Over the cap,
    the NEW send is shed immediately with the retryable ``Overloaded``
    error — LIFO-over-limit: work already in flight keeps its place,
    the newest arrival is the one refused — so one degraded replica
    stalling its reads can never absorb an unbounded slice of a
    coordinator's memory in parked frames and blocked tasks.  The
    fan-out layer treats the shed exactly like an unreachable peer:
    mutations fall back to the hint path and converge when the peer
    recovers."""

    MAX_POOL = 4
    # Class defaults for directly-constructed connections (tests,
    # probes); ring entries get the configured values via from_config.
    # 0 disables a cap.
    MAX_INFLIGHT_OPS = 128
    MAX_INFLIGHT_BYTES = 8 << 20

    def __init__(
        self,
        address: str,  # "<ip>:<port>"
        connect_timeout_ms: int = 5000,
        read_timeout_ms: int = 15000,
        write_timeout_ms: int = 15000,
        pooled: bool = False,
        max_inflight_ops: "int | None" = None,
        max_inflight_bytes: "int | None" = None,
    ) -> None:
        self.address = address
        host, port = address.rsplit(":", 1)
        self.host = host
        self.port = int(port)
        self.connect_timeout = connect_timeout_ms / 1000
        self.read_timeout = read_timeout_ms / 1000
        self.write_timeout = write_timeout_ms / 1000
        self.pooled = pooled
        self._pool: list = []
        self._pool_closed = False
        self.max_inflight_ops = (
            self.MAX_INFLIGHT_OPS
            if max_inflight_ops is None
            else max_inflight_ops
        )
        self.max_inflight_bytes = (
            self.MAX_INFLIGHT_BYTES
            if max_inflight_bytes is None
            else max_inflight_bytes
        )
        self.inflight_ops = 0
        self.inflight_bytes = 0
        self.shed_count = 0  # summed into get_stats.overload
        # Pipelined outbound stream (all-native serving path):
        # pooled ring entries multiplex in-flight data frames
        # FIFO on ONE persistent stream instead of lockstep
        # request/response per pooled stream — RF>1 coordinator
        # assist overlaps its peer frames the way the native fan-out
        # engine does, including when that engine is unavailable
        # (mixed local connections, stream repair in progress,
        # DBEEL_NO_QF).
        self.pipeline = pooled and _pipeline_enabled()
        self._pipe: "Optional[_PipeStream]" = None
        self._pipe_lock: "Optional[asyncio.Lock]" = None
        self.pipelined_ops = 0  # frames sent while others in flight

    @classmethod
    def from_config(
        cls, address: str, cfg, pooled: bool = False
    ) -> "RemoteShardConnection":
        return cls(
            address,
            cfg.remote_shard_connect_timeout_ms,
            cfg.remote_shard_read_timeout_ms,
            cfg.remote_shard_write_timeout_ms,
            pooled=pooled,
            max_inflight_ops=getattr(
                cfg, "peer_queue_max_ops", None
            ),
            max_inflight_bytes=getattr(
                cfg, "peer_queue_max_bytes", None
            ),
        )

    def _admit(self, nbytes: int) -> None:
        """Outbound-queue cap check; raises Overloaded (counted) when
        this peer already holds its limit of our in-flight work."""
        if (
            self.max_inflight_ops
            and self.inflight_ops >= self.max_inflight_ops
        ) or (
            self.max_inflight_bytes
            and nbytes
            and self.inflight_bytes + nbytes
            > self.max_inflight_bytes
        ):
            self.shed_count += 1
            raise Overloaded(
                f"outbound queue to {self.address} full "
                f"({self.inflight_ops} ops / "
                f"{self.inflight_bytes} bytes in flight)"
            )

    def close_pool(self) -> None:
        """Permanently close: in-flight round trips finishing after this
        (e.g. background replica drains racing a dead-node removal) must
        not re-pool their streams."""
        self._pool_closed = True
        for _r, w in self._pool:
            w.close()
        self._pool.clear()
        if self._pipe is not None:
            self._pipe.kill(f"connection to {self.address} closed")
            self._pipe = None

    def _maybe_pool(self, reader, writer) -> None:
        if self._pool_closed or len(self._pool) >= self.MAX_POOL:
            writer.close()
        else:
            self._pool.append((reader, writer))

    async def _connect(self):
        try:
            return await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port),
                self.connect_timeout,
            )
        except asyncio.TimeoutError as e:
            raise Timeout(f"connect to {self.address}") from e
        except OSError as e:
            raise ConnectionError_(
                f"connect to {self.address}: {e}"
            ) from e

    async def _round_trip(self, reader, writer, message: list) -> list:
        await asyncio.wait_for(
            send_message_to_stream(writer, message), self.write_timeout
        )
        return await asyncio.wait_for(
            get_message_from_stream(reader), self.read_timeout
        )

    async def _rpc(self, op, nbytes: int = 0):
        """Run ``op(reader, writer) -> result`` with the pooled
        persistent-stream semantics when enabled, else
        connect-per-request (remote_shard_connection.rs:50-72).
        ``nbytes`` (pre-packed frames) feeds the byte cap."""
        self._admit(nbytes)
        self.inflight_ops += 1
        self.inflight_bytes += nbytes
        try:
            return await self._rpc_inner(op)
        finally:
            self.inflight_ops -= 1
            self.inflight_bytes -= nbytes

    async def _rpc_inner(self, op):
        if _faults:
            await _apply_fault(self)
        if self.pooled:
            while self._pool:
                reader, writer = self._pool.pop()
                try:
                    response = await op(reader, writer)
                except asyncio.TimeoutError as e:
                    # Must precede OSError: on py3.11+ asyncio
                    # .TimeoutError IS TimeoutError ⊂ OSError.  A slow
                    # peer is not a stale stream — surface it, and
                    # never reuse a stream that may carry a late
                    # response.
                    writer.close()
                    raise Timeout(f"rpc to {self.address}") from e
                except (OSError, asyncio.IncompleteReadError):
                    # Stale pooled stream (idle disconnect, peer
                    # restart): retry on another.  Re-sending is safe
                    # even if the peer processed the request — shard
                    # messages are idempotent by design (reference
                    # shards.rs:544 "All events should be idempotent";
                    # writes converge by newest-timestamp).
                    writer.close()
                    continue
                except BaseException:
                    writer.close()
                    raise
                self._maybe_pool(reader, writer)
                return response
        reader, writer = await self._connect()
        try:
            try:
                response = await op(reader, writer)
            except asyncio.TimeoutError as e:
                raise Timeout(f"rpc to {self.address}") from e
            except (OSError, asyncio.IncompleteReadError) as e:
                raise ConnectionError_(
                    f"rpc to {self.address}: {e}"
                ) from e
        except BaseException:
            writer.close()
            raise
        if self.pooled:
            self._maybe_pool(reader, writer)
        else:
            writer.close()
        return response

    # ---- pipelined stream (all-native serving path) ------------------

    async def _pipe_stream(self) -> _PipeStream:
        """The live multiplexed stream, connecting (once) if needed.
        Concurrent ops share one connect attempt via the lock; a
        failed connect raises to every waiter and the next op
        retries."""
        if self._pipe_lock is None:
            self._pipe_lock = asyncio.Lock()
        while True:
            st = self._pipe
            if st is not None and not st.dead:
                return st
            async with self._pipe_lock:
                if self._pipe is None or self._pipe.dead:
                    if self._pool_closed:
                        raise ConnectionError_(
                            f"connection to {self.address} closed"
                        )
                    reader, writer = await self._connect()
                    st = _PipeStream(reader, writer)
                    self._pipe = st
                    st.task = asyncio.get_event_loop().create_task(
                        self._pipe_read_loop(st)
                    )

    async def _pipe_read_loop(self, st: _PipeStream) -> None:
        """Single reader per stream: each response frame resolves the
        oldest in-flight future (the peer server releases responses
        strictly in frame-arrival order).  Any read error — EOF from
        an idle-closed peer, a reset, a malformed length — kills the
        stream and fails whatever was in flight; senders retry once
        on a fresh stream (idempotent by design, shards.rs:544)."""
        try:
            while not st.dead:
                payload = await read_frame(st.reader)
                if not st.inflight:
                    # A response nothing asked for: protocol desync —
                    # never guess at FIFO matching again.
                    raise ProtocolError(
                        f"unsolicited frame from {self.address}"
                    )
                fut = st.inflight.popleft()
                if not fut.done():
                    fut.set_result(payload)
        except Exception as e:
            st.kill(f"peer stream to {self.address} died: {e}")
        finally:
            if self._pipe is st:
                self._pipe = None

    async def _pipe_rpc(self, framed: bytes) -> bytes:
        """One frame through the multiplexed stream: write (never
        interleaved — the whole frame is buffered before any await),
        then await this op's FIFO slot.  A read timeout kills the
        stream (a late response would mis-match a newer op); a dead
        stream fails the slot and the op retries ONCE on a fresh
        stream — re-sending a possibly-processed request is safe for
        the same idempotency reason the pooled path already re-sends
        on stale streams."""
        if _faults:
            await _apply_fault(self)
        last: Optional[BaseException] = None
        for attempt in (0, 1):
            st = await self._pipe_stream()
            fut = asyncio.get_event_loop().create_future()
            if st.inflight:
                self.pipelined_ops += 1
            st.inflight.append(fut)
            st.writer.write(framed)
            try:
                await asyncio.wait_for(
                    st.writer.drain(), self.write_timeout
                )
                return await asyncio.wait_for(
                    fut, self.read_timeout
                )
            except asyncio.TimeoutError as e:
                # Write-drain timeout: our own future is still
                # pending in the FIFO — cancel it so kill()'s
                # set_exception has nothing to attach to an
                # un-awaited future ("exception was never
                # retrieved" log spam under slow peers).  After a
                # fut-wait timeout, wait_for already cancelled it.
                fut.cancel()
                st.kill(f"rpc to {self.address} timed out")
                raise Timeout(f"rpc to {self.address}") from e
            except ConnectionError_ as e:
                last = e
            except (OSError, asyncio.IncompleteReadError) as e:
                st.kill(f"peer stream to {self.address} died: {e}")
                last = e
            except BaseException:
                # Cancellation mid-flight: the future stays in the
                # FIFO to absorb its response when it arrives (the
                # done() guard makes the set_result a no-op), so the
                # stream stays in sync and later ops keep their
                # slots.
                raise
        raise ConnectionError_(
            f"rpc to {self.address}: {last}"
        ) from last

    async def send_message(self, message: list) -> list:
        """Send one message, read one reply.  Quick data verbs on a
        pipelined pooled connection multiplex FIFO with other
        in-flight work instead of claiming a pooled stream for a full
        round trip."""
        if (
            self.pipeline
            and isinstance(message, (list, tuple))
            and len(message) > 1
            and message[0] == "request"
            and message[1] in _PIPE_KINDS
        ):
            buf = pack_message(message)
            if len(buf) <= _PIPE_MAX_FRAME and (
                message[1] not in _MULTI_KINDS
                or len(message) < 4
                or len(message[3]) <= _PIPE_MAX_SUBOPS
            ):

                async def op() -> list:
                    return unpack_message(
                        await self._pipe_rpc(
                            _LEN.pack(len(buf)) + buf
                        )
                    )

                return await self._rpc_accounted(op, len(buf))
        return await self._rpc(
            lambda r, w: self._round_trip(r, w, message)
        )

    async def _rpc_accounted(self, op, nbytes: int):
        """The _rpc admission/accounting envelope for pipelined ops
        (which manage their own stream instead of op(reader,
        writer))."""
        self._admit(nbytes)
        self.inflight_ops += 1
        self.inflight_bytes += nbytes
        try:
            return await op()
        finally:
            self.inflight_ops -= 1
            self.inflight_bytes -= nbytes

    async def _round_trip_packed(
        self, reader, writer, framed: bytes
    ) -> bytes:
        writer.write(framed)
        await asyncio.wait_for(writer.drain(), self.write_timeout)
        return await asyncio.wait_for(
            read_frame(reader), self.read_timeout
        )

    async def send_packed(self, framed: bytes) -> bytes:
        """Send one PRE-PACKED frame (already carrying its 4B-LE
        length prefix — e.g. the native coordinator's peer frame) and
        return the raw response payload bytes (length prefix
        stripped, NOT unpacked).  Callers byte-compare against the
        expected constant ack and only unpack on mismatch.  On a
        pipelined connection the frame multiplexes FIFO with other
        in-flight work — only data verbs travel this path, so
        eligibility needs no inspection."""
        if self.pipeline and len(framed) <= _PIPE_MAX_FRAME:
            return await self._rpc_accounted(
                lambda: self._pipe_rpc(framed), len(framed)
            )
        return await self._rpc(
            lambda r, w: self._round_trip_packed(r, w, framed),
            nbytes=len(framed),
        )

    async def send_request(self, request: list) -> list:
        """Send a ShardRequest, return the ShardResponse payload list."""
        return await self.send_message(request)

    async def send_event(self, event: list) -> None:
        """Fire one ShardEvent (no reply expected) and close."""
        self._admit(0)
        self.inflight_ops += 1
        try:
            await self._send_event_inner(event)
        finally:
            self.inflight_ops -= 1

    async def _send_event_inner(self, event: list) -> None:
        if _faults:
            await _apply_fault(self)
        reader, writer = await self._connect()
        try:
            await asyncio.wait_for(
                send_message_to_stream(writer, event),
                self.write_timeout,
            )
        except asyncio.TimeoutError as e:
            raise Timeout(f"event to {self.address}") from e
        except OSError as e:
            raise ConnectionError_(
                f"event to {self.address}: {e}"
            ) from e
        finally:
            writer.close()

    async def ping(self) -> None:
        response_to_result(
            await self.send_request(ShardRequest.ping()),
            ShardResponse.PONG,
        )

    async def get_metadata(self) -> List[NodeMetadata]:
        nodes = response_to_result(
            await self.send_request(ShardRequest.get_metadata()),
            ShardResponse.GET_METADATA,
        )
        return [NodeMetadata.from_wire(n) for n in nodes]

    async def get_collections(self):
        cols = response_to_result(
            await self.send_request(ShardRequest.get_collections()),
            ShardResponse.GET_COLLECTIONS,
        )
        # Third element (when the peer sends one): per-collection
        # quota overrides — propagated so a discovering node adopts
        # the same admission config (old peers simply lack it).
        # Fourth: the secondary-index field list.
        return [
            (
                c[0],
                c[1],
                c[2] if len(c) > 2 else None,
                c[3] if len(c) > 3 else None,
            )
            for c in cols
        ]

    async def open_stream(self) -> "RemoteShardStream":
        """Persistent multi-message connection (migration uses one
        stream for a whole range hand-off, migration.rs:70-112)."""
        reader, writer = await self._connect()
        return RemoteShardStream(self, reader, writer)


class RemoteShardStream:
    def __init__(self, conn, reader, writer) -> None:
        self.conn = conn
        self.reader = reader
        self.writer = writer

    async def send(self, message: list) -> None:
        await asyncio.wait_for(
            send_message_to_stream(self.writer, message),
            self.conn.write_timeout,
        )

    async def recv(self) -> list:
        return await asyncio.wait_for(
            get_message_from_stream(self.reader), self.conn.read_timeout
        )

    def close(self) -> None:
        self.writer.close()
