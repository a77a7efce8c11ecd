"""Smart client for dbeel_tpu_torch (and wire-compatible with dbeel
servers).

Role parity with the reference's dbeel_client (lib.rs): bootstrap from
seed db addresses, pull cluster metadata, build the client-side hash
ring, route each key to the first ring shard at/after its hash, walk
replicas across distinct nodes injecting ``replica_index``, resync the
ring and retry on ``KeyNotOwnedByShard``, and offer per-op consistency
(fixed / quorum / all).

Every msgpack frame goes through this package's own codec
(``utils/msgpack_codec.py``), byte-identical to ``msgpack``'s, so a
key hashes to the same ring position as under any other client.
"""

from __future__ import annotations

import asyncio
import random
import struct
import time
from bisect import bisect_left
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..errors import (
    ERROR_CLASS_OVERLOAD,
    ERROR_CLASS_PEER_DEAD,
    ERROR_CLASS_QUOTA,
    BadFieldType,
    CasConflict,
    ConnectionError_,
    DbeelError,
    KeyNotFound,
    KeyNotOwnedByShard,
    ProtocolError,
    Timeout,
    classify_error,
    from_wire,
    is_retryable_class,
)
from ..cluster.messages import ClusterMetadata
from ..cluster.messages import qos_class_of as _qos_class_of
from ..utils import msgpack_codec
from ..utils.murmur import hash_bytes, hash_string

RESPONSE_ERR = 0
RESPONSE_OK = 1
RESPONSE_BYTES = 2

# Ops that carry the membership-epoch write fence: every
# mutation routed by the client's ring view.  Conditional writes MUST
# stamp it — a CAS decided against a mid-migration stale view is
# exactly the lost-update the atomic plane exists to prevent.
# tests/test_torch_client.py holds the frames that carry it equal to
# the reference client's, so the set cannot silently shrink.
_EPOCH_STAMPED_OPS = ("set", "delete", "cas", "atomic_batch")


class Consistency:
    """dbeel_client/src/lib.rs:465-480."""

    @staticmethod
    def fixed(n: int):
        return ("fixed", n)

    QUORUM = ("quorum", 0)
    ALL = ("all", 0)

    @staticmethod
    def resolve(c, replication_factor: int) -> int:
        kind, n = c
        if kind == "fixed":
            return n
        if kind == "quorum":
            return replication_factor // 2 + 1
        return replication_factor


@dataclass
class _RingShard:
    node_name: str
    hash: int
    ip: str
    db_port: int  # already shard-specific (base + id)


class _PipelinedConnection:
    """One keepalive connection multiplexing many in-flight requests.

    The server answers pipelined frames strictly in arrival order
    (db_server._DbProtocol), so response dispatch is a FIFO: the j-th
    response frame resolves the j-th outstanding future.  A semaphore
    caps the in-flight window; writes go out as one buffer append per
    frame (atomic on the loop), and a single reader task fans
    responses back out.  Any transport error fails EVERY outstanding
    future with ConnectionError_ — callers treat that as the usual
    replica-walk transport failure and retry elsewhere."""

    def __init__(self, host: str, port: int, window: int) -> None:
        self.host = host
        self.port = port
        self._window = max(1, window)
        self._sem = asyncio.Semaphore(self._window)
        self._fifo: deque = deque()  # futures awaiting responses
        self._reader_task = None
        self._reader = None
        self._writer = None
        self._connecting: Optional[asyncio.Future] = None
        self._broken: Optional[Exception] = None

    @property
    def usable(self) -> bool:
        return self._broken is None

    async def _ensure_connected(self) -> None:
        # Single-flight dial: concurrent first requests must share
        # ONE connection — a second open_connection would overwrite
        # the streams under the first reader task and split response
        # frames between two readexactly loops.
        while self._connecting is not None:
            await asyncio.shield(self._connecting)
        if self._writer is not None:
            return
        self._connecting = asyncio.get_event_loop().create_future()
        try:
            self._reader, self._writer = (
                await asyncio.open_connection(self.host, self.port)
            )
            self._reader_task = asyncio.ensure_future(
                self._read_loop()
            )
        finally:
            fut, self._connecting = self._connecting, None
            fut.set_result(None)

    async def request(self, request_buf: bytes) -> bytes:
        """One framed round trip through the pipeline; returns the
        raw response payload (length prefix stripped)."""
        # Frame BEFORE queueing the future: an oversized request's
        # struct.error must not leave an orphan FIFO slot that would
        # misalign every later response.
        framed = struct.pack("<H", len(request_buf)) + request_buf
        async with self._sem:
            if self._broken is not None:
                raise ConnectionError_(
                    f"pipelined connection to "
                    f"{self.host}:{self.port} broken: {self._broken!r}"
                )
            await self._ensure_connected()
            fut = asyncio.get_event_loop().create_future()
            self._fifo.append(fut)
            self._writer.write(framed)
            # Transport-buffer backpressure (the window bounds how
            # many writes can be outstanding before this drain).
            await self._writer.drain()
            return await fut

    async def _read_loop(self) -> None:
        try:
            while True:
                header = await self._reader.readexactly(4)
                (size,) = struct.unpack("<I", header)
                payload = await self._reader.readexactly(size)
                if not self._fifo:
                    raise ProtocolError(
                        "unsolicited pipelined response"
                    )
                fut = self._fifo.popleft()
                if not fut.done():
                    fut.set_result(payload)
        except BaseException as e:  # noqa: BLE001 — fail everything
            self._fail(e)

    def _fail(self, exc: BaseException) -> None:
        self._broken = exc if isinstance(
            exc, Exception
        ) else ConnectionError_(repr(exc))
        while self._fifo:
            fut = self._fifo.popleft()
            if not fut.done():
                fut.set_exception(
                    ConnectionError_(
                        f"pipelined connection to "
                        f"{self.host}:{self.port} lost: {exc!r}"
                    )
                )
        self.close()

    def close(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            self._reader_task = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        if self._broken is None:
            self._broken = ConnectionError_("closed")


class DbeelClient:
    """``pooled=True`` (default) reuses connections via the keepalive
    protocol extension; pass False for strict reference behavior
    (connect per request).

    Failure-aware routing: every keyed op carries a per-op deadline
    budget (``op_deadline_s``).  Connection-class failures walk to the
    next ring replica; an exhausted walk resyncs the ring (churn moves
    ownership) and retries after capped exponential backoff with
    jitter, until the budget runs out.  Benign application outcomes
    (KeyNotFound et al.) are final immediately.

    ``pipeline_window=N`` (N >= 1) switches transport to PIPELINED
    connections: one keepalive connection per target multiplexes up
    to N concurrent requests (the server executes them concurrently
    and answers in arrival order), so M coroutines hitting one shard
    share one socket and overlap their round trips instead of
    serializing on a per-request pool checkout."""

    MAX_POOL_PER_TARGET = 8
    OP_DEADLINE_S = 10.0
    BACKOFF_BASE_S = 0.02
    BACKOFF_CAP_S = 0.5

    def __init__(
        self,
        seed_addresses: Sequence[Tuple[str, int]],
        pooled: bool = True,
        op_deadline_s: Optional[float] = None,
        pipeline_window: Optional[int] = None,
        qos_class: "str | int | None" = None,
        tenant: Optional[str] = None,
    ):
        # QoS plane: when set, every data-op frame this
        # client sends is stamped with the traffic class
        # ("interactive" > "standard" > "batch" — under server
        # overload batch sheds first and interactive last) and/or the
        # tenant id the server's per-collection token buckets key by.
        # A QuotaExceeded answer is retryable like an Overloaded shed
        # (the walk backs off; tokens refill).
        self._qos_class: Optional[int] = (
            None if qos_class is None else _qos_class_of(qos_class)
        )
        self._tenant = tenant if tenant else None
        self._seeds = list(seed_addresses)
        self._ring: List[_RingShard] = []
        self._ring_hashes: List[int] = []
        self._collections: dict = {}
        self._cluster_epoch = 0
        self._pooled = pooled
        self._pool: dict = {}  # (host, port) -> [(reader, writer)]
        self._pipeline_window = pipeline_window
        self._pipes: Dict[tuple, _PipelinedConnection] = {}
        self._op_deadline_s = (
            self.OP_DEADLINE_S if op_deadline_s is None else op_deadline_s
        )
        self._rng = random.Random()

    # -- bootstrap / metadata sync (lib.rs:85-152) ---------------------

    @classmethod
    async def from_seed_nodes(
        cls, addresses: Sequence[Tuple[str, int]], **kwargs
    ) -> "DbeelClient":
        client = cls(addresses, **kwargs)
        await client.sync_metadata()
        return client

    async def sync_metadata(self) -> None:
        # Failover: metadata can come from ANY live ring member, not
        # just the configured seeds — a client whose only seed is the
        # dead node would otherwise keep a stale ring forever and
        # bounce on KeyNotOwnedByShard through the whole churn window.
        candidates: List[Tuple[str, int]] = list(self._seeds)
        seen = set(candidates)
        for s in self._ring:
            addr = (s.ip, s.db_port)
            if addr not in seen:
                seen.add(addr)
                candidates.append(addr)
        last_error: Optional[Exception] = None
        for host, port in candidates:
            try:
                # Per-candidate bound: _send_to's bare open_connection
                # would otherwise ride the OS connect timeout
                # (~2 min) on a SYN-black-holed member.
                raw = await asyncio.wait_for(
                    self._send_to(
                        host, port, {"type": "get_cluster_metadata"}
                    ),
                    5.0,
                )
                metadata = ClusterMetadata.from_wire(
                    msgpack_codec.unpackb(raw)
                )
                self._apply_metadata(metadata)
                return
            except (
                DbeelError,
                OSError,
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
            ) as e:
                last_error = e
        raise ConnectionError_(
            f"no seed or ring member reachable: {last_error!r}"
        )

    def _apply_metadata(self, metadata: ClusterMetadata) -> None:
        ring: List[_RingShard] = []
        for node in metadata.nodes:
            for i, sid in enumerate(node.ids):
                # Vnode dialect: a node that advertises
                # per-shard token lists gets one ring entry per token;
                # nodes without the trailing element (old peers)
                # imply the legacy single-token derivation.
                if node.tokens is not None and i < len(node.tokens):
                    tokens = node.tokens[i]
                else:
                    tokens = [hash_string(f"{node.name}-{sid}")]
                for h in tokens:
                    ring.append(
                        _RingShard(
                            node_name=node.name,
                            hash=h,
                            ip=node.ip,
                            db_port=node.db_port + sid,
                        )
                    )
        ring.sort(key=lambda s: (s.hash, s.node_name))
        self._ring = ring
        self._ring_hashes = [s.hash for s in ring]
        self._collections = {
            name: rf for name, rf in metadata.collections
        }
        # Membership epoch of the view this ring came from: stamped on
        # writes so a server mid-migration can refuse (retryably) ops
        # routed with a stale ring instead of misplacing them.
        self._cluster_epoch = metadata.epoch

    # -- raw protocol --------------------------------------------------

    @staticmethod
    async def _round_trip(reader, writer, request: dict) -> bytes:
        buf = msgpack_codec.packb(request)
        writer.write(struct.pack("<H", len(buf)) + buf)
        await writer.drain()
        header = await reader.readexactly(4)
        (size,) = struct.unpack("<I", header)
        return await reader.readexactly(size)

    def _pipe_for(self, host: str, port: int) -> _PipelinedConnection:
        key = (host, port)
        pipe = self._pipes.get(key)
        if pipe is None or not pipe.usable:
            pipe = _PipelinedConnection(
                host, port, self._pipeline_window
            )
            self._pipes[key] = pipe
        return pipe

    async def _send_to(self, host: str, port: int, request: dict) -> bytes:
        """One request/response round trip (u16-len request; u32-len
        response + trailing type byte), over a pooled keepalive
        connection (or the target's pipelined connection) when
        enabled."""
        if self._pipeline_window:
            request = dict(request)
            request["keepalive"] = True
            try:
                payload = await self._pipe_for(host, port).request(
                    msgpack_codec.packb(request)
                )
            except (OSError, asyncio.IncompleteReadError) as e:
                raise ConnectionError_(
                    f"pipelined request to {host}:{port}: {e}"
                ) from e
            if not payload:
                raise ProtocolError("empty response")
            body, rtype = payload[:-1], payload[-1]
            if rtype == RESPONSE_ERR:
                raise from_wire(msgpack_codec.unpackb(body))
            return body
        payload = None
        if self._pooled:
            request = dict(request)
            request["keepalive"] = True
            key = (host, port)
            while payload is None and self._pool.get(key):
                reader, writer = self._pool[key].pop()
                try:
                    payload = await self._round_trip(
                        reader, writer, request
                    )
                except (OSError, asyncio.IncompleteReadError):
                    writer.close()  # stale pooled conn; try another
                except BaseException:
                    writer.close()  # cancellation etc: don't leak
                    raise
            if payload is not None:
                self._release(key, reader, writer)
        if payload is None:
            reader, writer = await asyncio.open_connection(host, port)
            try:
                payload = await self._round_trip(
                    reader, writer, request
                )
            except BaseException:
                writer.close()
                raise
            if self._pooled:
                self._release((host, port), reader, writer)
            else:
                writer.close()
        if not payload:
            raise ProtocolError("empty response")
        body, rtype = payload[:-1], payload[-1]
        if rtype == RESPONSE_ERR:
            raise from_wire(msgpack_codec.unpackb(body))
        return body

    def _release(self, key, reader, writer) -> None:
        pool = self._pool.setdefault(key, [])
        if len(pool) < self.MAX_POOL_PER_TARGET:
            pool.append((reader, writer))
        else:
            writer.close()

    def close(self) -> None:
        for conns in self._pool.values():
            for _r, w in conns:
                w.close()
        self._pool.clear()
        for pipe in self._pipes.values():
            pipe.close()
        self._pipes.clear()

    # -- routing (lib.rs:336-417) ---------------------------------------

    def _shards_for_key(self, key_hash: int, rf: int) -> List[_RingShard]:
        """First ring shard at/after the hash, then the next shards on
        distinct nodes — the replica walk."""
        if not self._ring:
            raise ConnectionError_("empty ring; sync_metadata first")
        start = bisect_left(self._ring_hashes, key_hash)
        if start == len(self._ring):
            start = 0
        out: List[_RingShard] = []
        seen_nodes: set = set()
        for off in range(len(self._ring)):
            s = self._ring[(start + off) % len(self._ring)]
            if s.node_name in seen_nodes:
                continue
            seen_nodes.add(s.node_name)
            out.append(s)
            if len(out) >= rf:
                break
        return out

    @classmethod
    def _backoff_s(
        cls, attempt: int, rng: random.Random
    ) -> float:
        """Capped exponential backoff with jitter: uniform in
        [d/2, d] for d = min(cap, base * 2^attempt) — bounded above
        by BACKOFF_CAP_S, never zero (no synchronized retry storms
        from many clients hitting one churn event)."""
        shift = min(attempt, 20)  # 1<<unbounded overflows float mult
        d = min(cls.BACKOFF_CAP_S, cls.BACKOFF_BASE_S * (1 << shift))
        return d * (0.5 + 0.5 * rng.random())

    def _retry_reserve_s(self) -> float:
        """Minimum budget a NEW attempt needs to be worth dialing.
        The backoff pause is capped at the remaining budget, so
        without this floor the last retry of every deadline-bounded
        sequence launches with ~0 ms left — guaranteed wasted work
        that the server's deadline check answers with a generic
        Timeout, downgrading the meaningful refusal (Overloaded,
        QuotaExceeded) the earlier rounds surfaced as last_error."""
        return min(0.1, self._op_deadline_s / 4)

    def _stamp_qos(self, request: dict) -> None:
        """QoS stamp (class + tenant) on a data-op frame — one place
        so every transport (walk, scan chunks, multi frames) stamps
        identically."""
        if self._qos_class is not None:
            request["qos"] = self._qos_class
        if self._tenant is not None:
            request["tenant"] = self._tenant

    async def _sharded_request(
        self, key: Any, request: dict, rf: int
    ) -> bytes:
        key_encoded = msgpack_codec.packb(key)
        key_hash = hash_bytes(key_encoded)
        request = dict(request)
        request["hash"] = key_hash
        self._stamp_qos(request)

        loop = asyncio.get_event_loop()
        deadline = loop.time() + self._op_deadline_s
        # Deadline propagation (overload plane): the op's absolute
        # wall-clock budget rides the request frame, so the server can
        # drop the work server-side (and replicas replica-side) once
        # we have given up — instead of computing a dead response.
        request["deadline_ms"] = int(
            (time.time() + self._op_deadline_s) * 1000
        )
        attempt = 0
        last_error: Optional[Exception] = None
        # Conditional writes are NOT blindly replayable: past the
        # decider's decide point a failed exchange may have committed,
        # and replaying the same expectations would either lose to the
        # op's own applied outcome (mis-reporting a committed write as
        # a definitive CasConflict) or double-apply it.  The server
        # keeps every PRE-decide refusal on distinguishable kinds
        # (KeyNotOwnedByShard, Overloaded, QuotaExceeded, PeerDead)
        # and folds every post-decide failure into plain Timeout — so
        # only those kinds (plus a connect-refused dial, provably
        # undelivered) walk on and retry; everything else surfaces
        # as-is, and the caller resolves ambiguity by re-reading (rmw
        # does; so does the chaos gate's ambiguous bucket).
        conditional = request.get("type") in (
            "cas",
            "atomic_batch",
        )
        while True:
            replicas = self._shards_for_key(key_hash, max(1, rf))
            # Epoch fence: writes carry the membership epoch
            # of the ring view that routed them, re-stamped every round
            # so the post-resync retry carries the refreshed epoch.  A
            # server mid-migration refuses (retryably) a write stamped
            # with an older epoch instead of placing it by a dead view.
            if (
                self._cluster_epoch
                and request.get("type") in _EPOCH_STAMPED_OPS
            ):
                request["epoch"] = self._cluster_epoch
            not_owned = False
            # Sticky per-round transport flag (C walk parity,
            # dbeel_client.cpp): once any replica was unreachable the
            # key's state is UNKNOWN — a later replica's KeyNotFound
            # must not downgrade the op to a final "not found".
            transport_error: Optional[Exception] = None
            for replica_index, shard in enumerate(replicas):
                budget = deadline - loop.time()
                if budget <= 0:
                    break
                request["replica_index"] = replica_index
                # Bound the coordinator's own quorum wait to what is
                # left of OUR budget, so a stalled quorum still
                # leaves room to walk to the next coordinator.
                request["timeout"] = max(
                    100, min(5000, int(budget * 1000))
                )
                try:
                    return await asyncio.wait_for(
                        self._send_to(
                            shard.ip, shard.db_port, request
                        ),
                        budget,
                    )
                except CasConflict:
                    # Atomic plane: a lost CAS race is a
                    # DECIDED outcome, not an infrastructure failure
                    # — no other replica can answer differently, and
                    # a blind replay of the same expectations would
                    # just lose again.  Surface it immediately; the
                    # rmw helper re-reads and retries with fresh
                    # expectations.
                    raise
                except KeyNotOwnedByShard as e:
                    # Stale ring: resync and retry (lib.rs:392-409).
                    last_error = e
                    not_owned = True
                    break
                except asyncio.TimeoutError:
                    # Our own budget expired mid-request: transport-
                    # class (state UNKNOWN) — it must never be
                    # downgraded by another replica's KeyNotFound.
                    if transport_error is None:
                        transport_error = Timeout(
                            f"op deadline ({self._op_deadline_s:.1f}s)"
                            " exhausted"
                        )
                    if conditional:
                        # The conditional may have been decided in
                        # flight: surface the ambiguity.
                        raise transport_error
                    break
                except (
                    DbeelError,
                    OSError,
                    asyncio.IncompleteReadError,
                ) as e:
                    # Reference walk semantics (lib.rs:368-383): record
                    # and advance — connect refused/reset, a dead
                    # coordinator's quorum-timeout, or an application
                    # error; the next replica may answer.
                    last_error = e
                    if conditional and not (
                        isinstance(e, ConnectionRefusedError)
                        or (
                            isinstance(e, DbeelError)
                            and classify_error(e)
                            in (
                                ERROR_CLASS_OVERLOAD,
                                ERROR_CLASS_QUOTA,
                                ERROR_CLASS_PEER_DEAD,
                            )
                        )
                    ):
                        # Possibly decided in flight (or a definitive
                        # refusal): no replay — see the contract above.
                        raise
                    if not isinstance(e, DbeelError) or (
                        is_retryable_class(classify_error(e))
                    ):
                        transport_error = e
                    continue
            if transport_error is not None:
                # Unknown state beats any benign outcome seen on OTHER
                # replicas this round — raise/retry the transport
                # error, never the downgraded KeyNotFound.
                last_error = transport_error
            # Walk exhausted.  Application outcomes are final; the
            # infrastructure classes retry after backoff while budget
            # remains — under churn the ring heals in well under an
            # op deadline.
            retryable = not_owned or is_retryable_class(
                classify_error(last_error)
                if last_error is not None
                else None
            )
            if (
                not retryable
                or loop.time() >= deadline - self._retry_reserve_s()
            ):
                break
            if not_owned or not isinstance(last_error, DbeelError):
                # Ring is stale (wrong owner) or nodes vanished
                # (transport errors): refresh the view before the
                # next round.  Best-effort — with every seed briefly
                # down we keep walking the last known ring.
                try:
                    await asyncio.wait_for(
                        self.sync_metadata(),
                        max(0.05, deadline - loop.time()),
                    )
                except (DbeelError, OSError, asyncio.TimeoutError):
                    pass
            backoff_attempt = attempt
            if last_error is not None and classify_error(
                last_error
            ) in (ERROR_CLASS_OVERLOAD, ERROR_CLASS_QUOTA):
                # The server is SHEDDING (or this tenant's bucket is
                # dry): retrying fast only feeds the overload / burns
                # the refill — skip ahead in the backoff schedule
                # (the jittered cap still bounds the pause).
                backoff_attempt += 2
            # Leave the retry reserve intact: a pause that drains the
            # budget just moves the wasted ~0-budget dial after the
            # sleep instead of skipping it.
            pause = min(
                self._backoff_s(backoff_attempt, self._rng),
                max(
                    0.0,
                    deadline - self._retry_reserve_s() - loop.time(),
                ),
            )
            if pause > 0:
                await asyncio.sleep(pause)
            attempt += 1
        raise last_error if last_error else ConnectionError_(
            "no replica reachable"
        )

    # -- streaming scans ----------------------------------------------

    async def _scan_chunk_request(self, request: dict) -> dict:
        """One scan/scan_next chunk with the full failure discipline:
        the chunk can run on ANY node (the cursor is self-contained),
        so a dead or Overloaded coordinator walks to the next ring
        member after capped backoff, resyncing the ring on transport
        errors — a scan survives a coordinator restart mid-stream."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self._op_deadline_s
        request = dict(request)
        request["deadline_ms"] = int(
            (time.time() + self._op_deadline_s) * 1000
        )
        self._stamp_qos(request)
        attempt = 0
        last_error: Optional[Exception] = None
        while True:
            targets = [
                (s.ip, s.db_port) for s in self._ring
            ] or list(self._seeds)
            if len(targets) > 1:
                # Rotate for load spread: scans have no owning key,
                # any coordinator merges the same stream.
                rot = self._rng.randrange(len(targets))
                targets = targets[rot:] + targets[:rot]
            for host, port in targets:
                budget = deadline - loop.time()
                if budget <= 0:
                    break
                request["timeout"] = max(
                    100, min(5000, int(budget * 1000))
                )
                try:
                    raw = await asyncio.wait_for(
                        self._send_to(host, port, request), budget
                    )
                    return msgpack_codec.unpackb(raw)
                except asyncio.TimeoutError:
                    last_error = Timeout(
                        f"scan chunk deadline "
                        f"({self._op_deadline_s:.1f}s) exhausted"
                    )
                    break
                except (
                    DbeelError,
                    OSError,
                    asyncio.IncompleteReadError,
                ) as e:
                    last_error = e
                    if isinstance(
                        e, DbeelError
                    ) and not is_retryable_class(classify_error(e)):
                        raise  # benign/final (bad cursor, no such collection)
                    continue
            if loop.time() >= deadline - self._retry_reserve_s():
                break
            if not isinstance(last_error, DbeelError):
                try:
                    await asyncio.wait_for(
                        self.sync_metadata(),
                        max(0.05, deadline - loop.time()),
                    )
                except (DbeelError, OSError, asyncio.TimeoutError):
                    pass
            backoff_attempt = attempt
            if last_error is not None and classify_error(
                last_error
            ) in (ERROR_CLASS_OVERLOAD, ERROR_CLASS_QUOTA):
                # The shard shed the chunk (or the tenant's bucket is
                # dry): the cursor survives — back off harder before
                # resuming.
                backoff_attempt += 2
            # Leave the retry reserve intact (see _sharded_request).
            pause = min(
                self._backoff_s(backoff_attempt, self._rng),
                max(
                    0.0,
                    deadline - self._retry_reserve_s() - loop.time(),
                ),
            )
            if pause > 0:
                await asyncio.sleep(pause)
            attempt += 1
        raise last_error if last_error else ConnectionError_(
            "no node reachable for scan"
        )

    # -- watch/CDC streams --------------------------------------------

    async def _watch_chunk_request(self, request: dict) -> dict:
        """One watch/watch_next chunk with the scan plane's walk
        discipline — the cursor is self-contained, so the stream
        resumes on ANY node after a coordinator death or shed — plus
        the epoch-fence leg: a retryable ``KeyNotOwnedByShard``
        (cursor stamped before the current churn) resyncs metadata
        before retrying the SAME cursor, which the next coordinator
        re-stamps once its migration settles."""
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self._op_deadline_s
        request = dict(request)
        request["deadline_ms"] = int(
            (time.time() + self._op_deadline_s) * 1000
        )
        self._stamp_qos(request)
        attempt = 0
        last_error: Optional[Exception] = None
        while True:
            targets = [
                (s.ip, s.db_port) for s in self._ring
            ] or list(self._seeds)
            if len(targets) > 1:
                rot = self._rng.randrange(len(targets))
                targets = targets[rot:] + targets[:rot]
            for host, port in targets:
                budget = deadline - loop.time()
                if budget <= 0:
                    break
                request["timeout"] = max(
                    100, min(5000, int(budget * 1000))
                )
                try:
                    raw = await asyncio.wait_for(
                        self._send_to(host, port, request), budget
                    )
                    return msgpack_codec.unpackb(raw)
                except asyncio.TimeoutError:
                    last_error = Timeout(
                        f"watch chunk deadline "
                        f"({self._op_deadline_s:.1f}s) exhausted"
                    )
                    break
                except (
                    DbeelError,
                    OSError,
                    asyncio.IncompleteReadError,
                ) as e:
                    last_error = e
                    if isinstance(
                        e, DbeelError
                    ) and not is_retryable_class(classify_error(e)):
                        raise  # benign/final (bad cursor, no such collection)
                    continue
            if loop.time() >= deadline - self._retry_reserve_s():
                break
            if not isinstance(
                last_error, DbeelError
            ) or isinstance(last_error, KeyNotOwnedByShard):
                # Transport loss OR the epoch fence: refresh the
                # ring/epoch view before the next walk.
                try:
                    await asyncio.wait_for(
                        self.sync_metadata(),
                        max(0.05, deadline - loop.time()),
                    )
                except (DbeelError, OSError, asyncio.TimeoutError):
                    pass
            backoff_attempt = attempt
            if last_error is not None and classify_error(
                last_error
            ) in (ERROR_CLASS_OVERLOAD, ERROR_CLASS_QUOTA):
                # Shed (slow-subscriber byte budget, subscriber cap,
                # or hard overload): the cursor survives — back off
                # harder before polling again.
                backoff_attempt += 2
            pause = min(
                self._backoff_s(backoff_attempt, self._rng),
                max(
                    0.0,
                    deadline - self._retry_reserve_s() - loop.time(),
                ),
            )
            if pause > 0:
                await asyncio.sleep(pause)
            attempt += 1
        raise last_error if last_error else ConnectionError_(
            "no node reachable for watch"
        )

    # -- batched multi-ops --------------------------------------------

    # Per-frame bounds: the request framing is u16-LE, so a batch
    # frame must stay comfortably under 64 KiB; the op count cap
    # bounds server-side allocation fan per frame.
    MULTI_MAX_OPS_PER_FRAME = 256
    MULTI_MAX_BYTES_PER_FRAME = 48 << 10

    async def _multi_request(
        self,
        collection: str,
        rf: int,
        is_set: bool,
        keys: list,
        values: list,
        consistency: Optional[int],
        trace_id: Optional[int] = None,
    ) -> list:
        """Group sub-ops by owning coordinator via the ring, send ONE
        multi frame per node (chunked under the u16 frame bound), and
        fail over per sub-op: any sub-op that comes back with a
        retryable/ownership error — or whose whole frame failed —
        re-runs through the single-op replica walk (full PR-1
        failover: walk, resync, backoff, deadline).  Returns outcomes
        aligned with ``keys``: ("ok", payload) or ("err", exc)."""
        n = len(keys)
        enc = [
            msgpack_codec.packb(k) for k in keys
        ]
        hashes = [hash_bytes(e) for e in enc]
        outcomes: list = [None] * n
        groups: Dict[tuple, list] = {}
        for i, h in enumerate(hashes):
            shard = self._shards_for_key(h, max(1, rf))[0]
            groups.setdefault((shard.ip, shard.db_port), []).append(i)

        rtype = "multi_set" if is_set else "multi_get"

        async def send_chunk(addr: tuple, idxs: list) -> None:
            ops = [
                [keys[i], hashes[i], values[i]]
                if is_set
                else [keys[i], hashes[i]]
                for i in idxs
            ]
            request: dict = {
                "type": rtype,
                "collection": collection,
                "ops": ops,
                "replica_index": 0,
                # Coordinator-side bound, mirroring _sharded_request:
                # the batch's quorum wait must not outlive our own
                # deadline budget.
                "timeout": max(
                    100, min(5000, int(self._op_deadline_s * 1000))
                ),
                # Deadline propagation for the whole batch frame.
                "deadline_ms": int(
                    (time.time() + self._op_deadline_s) * 1000
                ),
            }
            if consistency is not None:
                request["consistency"] = consistency
            if is_set and self._cluster_epoch:
                # Same epoch fence as the single-op path; fenced
                # sub-ops come back retryable and fall into the
                # single-op walk, which resyncs and re-stamps.
                request["epoch"] = self._cluster_epoch
            self._stamp_qos(request)
            if isinstance(trace_id, int) and trace_id > 0:
                # Tracing plane: the whole batch frame records one
                # per-stage span (replica spans piggyback on the
                # MULTI_* peer responses).
                request["trace"] = trace_id
            try:
                try:
                    # Deadline-bound like every single op (a black-
                    # holed coordinator must fail the chunk over to
                    # the per-sub-op walk, not hang the batch).
                    raw = await asyncio.wait_for(
                        self._send_to(addr[0], addr[1], request),
                        self._op_deadline_s,
                    )
                except struct.error:
                    # Frame overflowed the u16 bound (values are not
                    # pre-measured — serializing them twice just to
                    # size chunks would double client CPU on the hot
                    # batch path): split and retry.
                    if len(idxs) == 1:
                        outcomes[idxs[0]] = (
                            "err",
                            ProtocolError(
                                "sub-op exceeds the u16 frame bound"
                            ),
                        )
                        return
                    mid = len(idxs) // 2
                    await send_chunk(addr, idxs[:mid])
                    await send_chunk(addr, idxs[mid:])
                    return
                results = msgpack_codec.unpackb(raw)
                if (
                    not isinstance(results, list)
                    or len(results) != len(idxs)
                ):
                    raise ProtocolError("bad multi response shape")
            except (
                DbeelError,
                OSError,
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
            ) as e:
                # Whole-frame failure (dead coordinator, stale ring
                # collection, transport): every sub-op falls back to
                # the single-op walk.
                for i in idxs:
                    outcomes[i] = ("retry", e)
                return
            for i, res in zip(idxs, results):
                status, payload = res[0], res[1]
                if status == 0:
                    outcomes[i] = ("ok", payload)
                    continue
                e = from_wire(payload)
                if isinstance(e, KeyNotOwnedByShard) or (
                    is_retryable_class(classify_error(e))
                ):
                    outcomes[i] = ("retry", e)
                else:
                    outcomes[i] = ("err", e)

        # Chunk by op count and KEY bytes only — value sizes are not
        # pre-measured (that would serialize every value twice); a
        # chunk whose packed frame still overflows the u16 bound is
        # split on struct.error inside send_chunk.
        chunks: List[tuple] = []
        for addr, idxs in groups.items():
            cur: list = []
            cur_bytes = 0
            for i in idxs:
                op_bytes = len(enc[i]) + 16
                if cur and (
                    len(cur) >= self.MULTI_MAX_OPS_PER_FRAME
                    or cur_bytes + op_bytes
                    > self.MULTI_MAX_BYTES_PER_FRAME
                ):
                    chunks.append((addr, cur))
                    cur, cur_bytes = [], 0
                cur.append(i)
                cur_bytes += op_bytes
            if cur:
                chunks.append((addr, cur))
        await asyncio.gather(
            *(send_chunk(addr, idxs) for addr, idxs in chunks)
        )

        retries = [
            i for i in range(n) if outcomes[i][0] == "retry"
        ]
        if retries:
            async def walk_one(i: int) -> None:
                request: dict = {
                    "type": "set" if is_set else "get",
                    "collection": collection,
                    "key": keys[i],
                }
                if is_set:
                    request["value"] = values[i]
                if consistency is not None:
                    request["consistency"] = consistency
                try:
                    body = await self._sharded_request(
                        keys[i], request, rf
                    )
                    outcomes[i] = ("ok", None if is_set else body)
                except (
                    DbeelError,
                    OSError,
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                ) as e:
                    # _sharded_request re-raises its LAST transport
                    # error raw (OSError et al.) when the walk
                    # exhausts — one dead sub-op must become an
                    # aligned outcome, not abort the whole batch.
                    outcomes[i] = ("err", e)

            await asyncio.gather(*(walk_one(i) for i in retries))
        return outcomes

    # -- public API (lib.rs:482-619) -------------------------------------

    async def create_collection(
        self,
        name: str,
        replication_factor: Optional[int] = None,
        ops_per_sec: Optional[int] = None,
        bytes_per_sec: Optional[int] = None,
        index: Optional[list] = None,
    ) -> "DbeelCollection":
        """``ops_per_sec``/``bytes_per_sec`` carry per-collection
        tenant-quota overrides on the DDL: they
        beat the server's ``--tenant-*`` flag defaults for this
        collection only (0 disables the limit), and round-trip
        through collection metadata (restart- and gossip-safe).

        ``index`` names value fields to maintain persisted secondary
        index runs for: flush/compaction emit per-SSTable
        fidx runs inline and indexed ``scan(filter=)`` / ``count``
        predicates on those fields skip the full scan.  Round-trips
        through metadata/gossip like quotas."""
        request = {"type": "create_collection", "name": name}
        if replication_factor is not None:
            request["replication_factor"] = replication_factor
        if ops_per_sec is not None:
            request["ops_per_sec"] = int(ops_per_sec)
        if bytes_per_sec is not None:
            request["bytes_per_sec"] = int(bytes_per_sec)
        if index:
            request["index"] = [str(f) for f in index]
        host, port = self._seeds[0]
        await self._send_to(host, port, request)
        await self.sync_metadata()
        return self.collection(name)

    async def drop_collection(self, name: str) -> None:
        host, port = self._seeds[0]
        await self._send_to(
            host, port, {"type": "drop_collection", "name": name}
        )
        await self.sync_metadata()

    def collection(self, name: str) -> "DbeelCollection":
        rf = self._collections.get(name, 1)
        return DbeelCollection(self, name, rf)

    async def get_cluster_metadata(self) -> ClusterMetadata:
        host, port = self._seeds[0]
        raw = await self._send_to(
            host, port, {"type": "get_cluster_metadata"}
        )
        return ClusterMetadata.from_wire(msgpack_codec.unpackb(raw))

    async def get_stats(
        self, host: Optional[str] = None, port: Optional[int] = None
    ) -> dict:
        """Per-shard observability snapshot from one server (the
        first seed by default): durability, scheduler, metrics and
        the ``convergence`` block (hints queued/replayed/expired,
        read repairs, anti-entropy rounds / keys healed)."""
        if host is None or port is None:
            host, port = self._seeds[0]
        raw = await self._send_to(host, port, {"type": "get_stats"})
        return msgpack_codec.unpackb(raw)

    async def trace_dump(
        self, host: Optional[str] = None, port: Optional[int] = None
    ) -> dict:
        """One shard's flight-recorder dump (tracing plane): sampled
        per-stage spans — coordinator stages plus per-replica RTT and
        piggybacked replica stage summaries — and a minimal record
        for every slow/error op.  Always served, even at hard
        overload (like get_stats)."""
        if host is None or port is None:
            host, port = self._seeds[0]
        raw = await self._send_to(host, port, {"type": "trace_dump"})
        return msgpack_codec.unpackb(raw)

    async def cluster_stats(
        self, host: Optional[str] = None, port: Optional[int] = None
    ) -> dict:
        """The gossip-aggregated cluster health view from one node
        (the first seed by default): per-node digests (level, ops/s,
        error/shed rates, degraded flag, hint backlog, watchdog
        finding kinds) under ``nodes``, plus ``missing`` for ring
        members not yet heard from.  Always served, even at hard
        overload — ask ANY node, see the whole cluster."""
        if host is None or port is None:
            host, port = self._seeds[0]
        raw = await self._send_to(
            host, port, {"type": "cluster_stats"}
        )
        return msgpack_codec.unpackb(raw)

    async def telemetry_dump(
        self, host: Optional[str] = None, port: Optional[int] = None
    ) -> dict:
        """One shard's full telemetry time-series ring (flattened
        get_stats samples stamped with seq/ts_ms/uptime_s), derived
        rates, and the health watchdog's verdict.  Always served,
        like get_stats/trace_dump."""
        if host is None or port is None:
            host, port = self._seeds[0]
        raw = await self._send_to(
            host, port, {"type": "telemetry_dump"}
        )
        return msgpack_codec.unpackb(raw)

    async def rearm(
        self, host: Optional[str] = None, port: Optional[int] = None
    ) -> None:
        """Admin: tell one node (the first seed by default) to exit
        sticky degraded read-only mode after disk replacement — the
        node re-runs its free-space/WAL-append pre-checks on every
        shard and re-registers the native write plane.  Raises the
        server's error (node stays degraded) when a pre-check still
        fails."""
        if host is None or port is None:
            host, port = self._seeds[0]
        await self._send_to(host, port, {"type": "rearm"})


class DbeelCollection:
    def __init__(self, client: DbeelClient, name: str, rf: int):
        self.client = client
        self.name = name
        self.replication_factor = rf

    async def set(
        self, key: Any, value: Any, consistency=None,
        trace_id: Optional[int] = None,
    ) -> None:
        """``trace_id`` (tracing plane): stamp the request so the
        server records a full per-stage span for this op, queryable
        via trace_dump."""
        request = {
            "type": "set",
            "collection": self.name,
            "key": key,
            "value": value,
        }
        if consistency is not None:
            request["consistency"] = Consistency.resolve(
                consistency, self.replication_factor
            )
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        await self.client._sharded_request(
            key, request, self.replication_factor
        )

    async def get(
        self, key: Any, consistency=None,
        trace_id: Optional[int] = None,
    ) -> Any:
        request = {
            "type": "get",
            "collection": self.name,
            "key": key,
        }
        if consistency is not None:
            request["consistency"] = Consistency.resolve(
                consistency, self.replication_factor
            )
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        raw = await self.client._sharded_request(
            key, request, self.replication_factor
        )
        return msgpack_codec.unpackb(raw)

    async def multi_set(
        self, items, consistency=None,
        trace_id: Optional[int] = None,
    ) -> None:
        """Batched set: ``items`` is a dict or an iterable of
        (key, value) pairs.  Keys are grouped by owning coordinator
        and travel one frame per node (multi_set); failed sub-ops
        fall back to the single-op replica walk.  Raises the first
        sub-op error (all other sub-ops still complete)."""
        pairs = (
            list(items.items())
            if isinstance(items, dict)
            else list(items)
        )
        if not pairs:
            return
        resolved = (
            Consistency.resolve(consistency, self.replication_factor)
            if consistency is not None
            else None
        )
        outcomes = await self.client._multi_request(
            self.name,
            self.replication_factor,
            True,
            [k for k, _v in pairs],
            [v for _k, v in pairs],
            resolved,
            trace_id=trace_id,
        )
        for kind, payload in outcomes:
            if kind == "err":
                raise payload

    async def multi_get(
        self, keys: Sequence[Any], consistency=None,
        trace_id: Optional[int] = None,
    ) -> list:
        """Batched get: returns values aligned with ``keys`` (None
        for missing keys).  One frame per owning node; failed sub-ops
        fall back to the single-op replica walk.  Raises the first
        non-KeyNotFound sub-op error."""
        keys = list(keys)
        if not keys:
            return []
        resolved = (
            Consistency.resolve(consistency, self.replication_factor)
            if consistency is not None
            else None
        )
        outcomes = await self.client._multi_request(
            self.name,
            self.replication_factor,
            False,
            keys,
            [None] * len(keys),
            resolved,
            trace_id=trace_id,
        )
        out = []
        for kind, payload in outcomes:
            if kind == "ok":
                out.append(msgpack_codec.unpackb(payload))
            elif isinstance(payload, KeyNotFound):
                out.append(None)
            else:
                raise payload
        return out

    async def scan(
        self,
        prefix: Optional[bytes] = None,
        limit: Optional[int] = None,
        max_bytes: Optional[int] = None,
        trace_id: Optional[int] = None,
        filter: Optional[Any] = None,
    ):
        """Streaming full/range scan (scan plane): an async
        generator yielding (key, value) pairs — decoded documents —
        in raw encoded-key byte order (the storage order), merged
        newest-wins across every replica of every ring arc with
        tombstones excluded.  One governor-paced chunk per server
        round trip; the resumable cursor rides inside, so the stream
        survives Overloaded sheds and coordinator restarts.

        ``prefix`` filters on the msgpack-ENCODED key bytes (pushed
        down to the vectorized storage stage).  ``limit`` caps total
        yielded entries; ``max_bytes`` lowers the per-chunk byte
        budget below the server's ``--scan-bytes-per-slice``.

        ``filter`` (query compute plane) is a predicate tree
        — see dbeel_tpu_torch.query (e.g. ``["and", ["cmp", "temp", ">=",
        20], ["prefix", "city", "san"]]``) — evaluated VECTORIZED on
        the replicas over their staged columns: non-matching values
        never cross any wire, and the per-chunk budget bills bytes
        scanned, so a selective scan returns in the same bounded
        chunks with ~none of the bytes."""
        request: dict = {"type": "scan", "collection": self.name}
        if prefix:
            request["prefix"] = bytes(prefix)
        if limit:
            request["limit"] = int(limit)
        if max_bytes:
            request["max_bytes"] = int(max_bytes)
        if filter is not None:
            from .. import query as _query

            w, _ = _query.build_spec(filter, None)
            request["spec"] = _query.pack_spec(w, None)
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        while True:
            chunk = await self.client._scan_chunk_request(request)
            # Entries arrive as DECODED (key, value) documents: the
            # server splices the stored encodings into the chunk
            # payload, so the chunk's one unpack decoded everything.
            for key, value in chunk.get("entries") or ():
                yield key, value
            cursor = chunk.get("cursor")
            if not cursor:
                return
            request = {"type": "scan_next", "cursor": cursor}
            if isinstance(trace_id, int) and trace_id > 0:
                request["trace"] = trace_id

    def watcher(
        self,
        filter: Optional[Any] = None,
        wait_ms: int = 1000,
        sub_id: Optional[str] = None,
        cursor: Optional[bytes] = None,
    ) -> "Watcher":
        """Chunk-level handle on a change stream (watch/CDC plane):
        ``await w.next_events()`` returns one chunk of
        events, ``w.cursor`` is the resumable token after every
        chunk — persist it and pass it back as ``cursor=`` to resume
        the exact stream (on ANY node) after a client restart."""
        return Watcher(
            self.client,
            self.name,
            filter=filter,
            wait_ms=wait_ms,
            sub_id=sub_id,
            cursor=cursor,
        )

    async def watch(
        self,
        filter: Optional[Any] = None,
        wait_ms: int = 1000,
        sub_id: Optional[str] = None,
        cursor: Optional[bytes] = None,
    ):
        """Change stream (watch/CDC plane): an async
        generator yielding ``(key, value, ts, flags)`` for every
        acked mutation from NOW on (or from ``cursor`` when
        resuming) — ``value is None`` is a delete, ``flags & 1`` an
        explicitly flagged possible duplicate (catch-up/handoff
        replay; never silent).  Delivery is state-compacting
        (newest version per key per chunk) and loss-free across
        coordinator death, partitions, and membership churn; the
        stream long-polls ``wait_ms`` per empty round and backs off
        adaptively between empty chunks.

        ``filter`` is the query plane's predicate dialect, evaluated
        replica-side; a filtered stream delivers matching live
        versions only (no deletes)."""
        w = self.watcher(
            filter=filter,
            wait_ms=wait_ms,
            sub_id=sub_id,
            cursor=cursor,
        )
        streak = 0
        while True:
            events = await w.next_events()
            if events:
                streak = 0
                for ev in events:
                    yield ev
            else:
                # The server already parked wait_ms on its LOCAL
                # ring; this client-side backoff only paces polls
                # when events live on remote arcs or the stream is
                # idle.
                streak = min(streak + 1, 6)
                await asyncio.sleep(
                    min(1.0, 0.05 * (2 ** streak))
                )

    async def count(
        self,
        prefix: Optional[bytes] = None,
        limit: Optional[int] = None,
        filter: Optional[Any] = None,
        aggregate: Optional[dict] = None,
    ) -> Any:
        """Count live documents (optionally under an encoded-key
        prefix) WITHOUT materializing a single value: replicas stream
        keys-only pages (vectorized count pushdown), the coordinator
        merge dedups/count them, and only the running total crosses
        back per chunk.

        ``filter`` (query compute plane) counts only matching
        documents.  ``aggregate`` (e.g. ``{"op": "sum", "field":
        "qty"}``, optionally ``{"group": L}`` for a group-by on the
        first L encoded-key bytes) returns the aggregate instead of
        the count — computed replica-side from the staged columns
        where possible, combined as exact per-arc partials, with the
        running state riding the resumable cursor.  Grouped results
        come back as {key_prefix_bytes: value}."""
        request: dict = {
            "type": "scan",
            "collection": self.name,
        }
        if aggregate is not None:
            from .. import query as _query

            w, a = _query.build_spec(filter, aggregate)
            request["spec"] = _query.pack_spec(w, a)
            if limit:
                raise BadFieldType(
                    "limit is not supported with an aggregate"
                )
        else:
            request["count"] = True
            if filter is not None:
                from .. import query as _query

                w, _ = _query.build_spec(filter, None)
                request["spec"] = _query.pack_spec(w, None)
        if prefix:
            request["prefix"] = bytes(prefix)
        if limit:
            request["limit"] = int(limit)
        total = 0
        while True:
            chunk = await self.client._scan_chunk_request(request)
            total = int(chunk.get("count") or 0)
            cursor = chunk.get("cursor")
            if not cursor:
                if aggregate is not None:
                    return chunk.get("agg")
                return total
            request = {"type": "scan_next", "cursor": cursor}

    async def delete(
        self, key: Any, consistency=None,
        trace_id: Optional[int] = None,
    ) -> None:
        request = {
            "type": "delete",
            "collection": self.name,
            "key": key,
        }
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        if consistency is not None:
            request["consistency"] = Consistency.resolve(
                consistency, self.replication_factor
            )
        await self.client._sharded_request(
            key, request, self.replication_factor
        )

    # -- atomic conditional writes ------------------------------------

    _NO_EXPECT = object()

    async def cas(
        self,
        key: Any,
        value: Any = None,
        *,
        delete: bool = False,
        expect_ts: Optional[int] = None,
        expect_value: Any = _NO_EXPECT,
        expect_absent: bool = False,
        consistency=None,
        trace_id: Optional[int] = None,
    ) -> int:
        """Conditional write: set ``key`` to ``value`` (or tombstone
        it with ``delete=True``) only if the key's current state at
        its arc owner matches EVERY expectation given — ``expect_ts``
        (the exact current server timestamp), ``expect_value`` (the
        exact current decoded value), ``expect_absent`` (no live
        entry).  At least one expectation is required.  Returns the
        decided server timestamp on success; raises ``CasConflict``
        when an expectation mismatched (the decided state is intact —
        re-read and retry with fresh expectations, or use ``rmw``).

        The op is serialized at the key's arc owner, fenced by the
        membership epoch (a mid-migration stale view refuses
        retryably and this client resyncs + retries), and the decided
        outcome replicates as an ordinary LWW write.  Guarantees
        require quorum consistency (the default) and break if raw
        ``set``/``delete`` races the same key."""
        request: dict = {
            "type": "cas",
            "collection": self.name,
            "key": key,
        }
        if delete:
            request["delete"] = True
        else:
            request["value"] = value
        if expect_absent:
            request["expect_absent"] = True
        if expect_ts is not None:
            request["expect_ts"] = int(expect_ts)
        if expect_value is not DbeelCollection._NO_EXPECT:
            request["expect_value"] = expect_value
        if consistency is not None:
            request["consistency"] = Consistency.resolve(
                consistency, self.replication_factor
            )
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        raw = await self.client._sharded_request(
            key, request, self.replication_factor
        )
        decided = msgpack_codec.unpackb(raw)
        return int(decided["ts"])

    async def rmw(
        self,
        key: Any,
        fn,
        *,
        max_retries: int = 64,
        consistency=None,
    ) -> Any:
        """Read-modify-write retry loop over ``cas``: read the
        current value (None when absent), apply ``fn(current) ->
        new_value``, and commit conditionally on the state read —
        ``expect_absent`` for absent keys, ``expect_value`` for live
        ones.  On ``CasConflict`` (a concurrent writer won the race)
        re-read and re-apply, up to ``max_retries`` times.  Returns
        the committed new value.

        ``expect_value`` carries the usual ABA caveat: ``fn`` should
        produce values that never repeat a previous state (counters,
        version-stamped documents) for exactly-once semantics."""
        last: Optional[Exception] = None
        for _attempt in range(max_retries):
            try:
                current = await self.get(
                    key, consistency=consistency
                )
            except KeyNotFound:
                current = None
            new_value = fn(current)
            try:
                if current is None:
                    await self.cas(
                        key,
                        new_value,
                        expect_absent=True,
                        consistency=consistency,
                    )
                else:
                    await self.cas(
                        key,
                        new_value,
                        expect_value=current,
                        consistency=consistency,
                    )
                return new_value
            except CasConflict as e:
                last = e
                continue
        raise last if last is not None else Timeout("rmw")

    async def atomic_batch(
        self,
        ops: Sequence[dict],
        consistency=None,
        trace_id: Optional[int] = None,
    ) -> int:
        """All-or-nothing conditional multi-key batch on ONE ring
        arc.  Each op is a dict: ``{"key": k}`` plus either
        ``"value"`` or ``"delete": True``, plus any of the cas
        expectation fields (``expect_ts`` / ``expect_value`` /
        ``expect_absent``; an op with none is unconditional within
        the batch).  Every key must hash to the same ring arc —
        batches spanning arcs are refused as a client error.  All
        conditions are evaluated against a consistent read under the
        arc's decider lock; on success the whole batch commits
        through one WAL group-commit ticket with one decided
        timestamp (returned), on any mismatch the whole batch refuses
        with ``CasConflict``."""
        ops = [dict(op) for op in ops]
        if not ops:
            raise BadFieldType("ops: empty atomic batch")
        for op in ops:
            if "key" not in op:
                raise BadFieldType("ops: op without a key")
        request: dict = {
            "type": "atomic_batch",
            "collection": self.name,
            "ops": ops,
        }
        if consistency is not None:
            request["consistency"] = Consistency.resolve(
                consistency, self.replication_factor
            )
        if isinstance(trace_id, int) and trace_id > 0:
            request["trace"] = trace_id
        # Routed by the FIRST key: the server verifies all keys share
        # its arc, and a stale-ring miss walks/resyncs as usual.
        raw = await self.client._sharded_request(
            ops[0]["key"], request, self.replication_factor
        )
        decided = msgpack_codec.unpackb(raw)
        return int(decided["ts"])


class Watcher:
    """Client half of one watch subscription: issues watch /
    watch_next chunks through the any-node walk, tracks the
    resumable cursor, decodes events, and audits the server's
    per-replica ``(boot_epoch, seq)`` positions for monotonicity
    (``monotonicity_violations`` stays 0 on a correct stream — the
    chaos gate's ledger leans on this)."""

    def __init__(
        self,
        client: "DbeelClient",
        collection: str,
        filter: Optional[Any] = None,
        wait_ms: int = 1000,
        sub_id: Optional[str] = None,
        cursor: Optional[bytes] = None,
    ):
        self._client = client
        self._wait_ms = int(wait_ms)
        self.cursor: Optional[bytes] = cursor
        self.chunks = 0
        self.events_seen = 0
        self.dup_flagged = 0
        self.monotonicity_violations = 0
        self._positions: dict = {}
        if cursor is not None:
            self._request = {
                "type": "watch_next",
                "cursor": bytes(cursor),
            }
        else:
            self._request = {
                "type": "watch",
                "collection": collection,
            }
            if filter is not None:
                from .. import query as _query

                w, _ = _query.build_spec(filter, None)
                self._request["spec"] = _query.pack_spec(w, None)
            if sub_id:
                self._request["sub_id"] = str(sub_id)
        if self._wait_ms > 0:
            self._request["wait_ms"] = self._wait_ms

    @staticmethod
    def _cursor_positions(raw) -> dict:
        """Per-replica (boot_epoch, seq) positions out of the opaque
        w1 cursor — a READ-ONLY peek for auditing; the token itself
        stays opaque client state."""
        try:
            w = msgpack_codec.unpackb(bytes(raw))
            if (
                not isinstance(w, list)
                or len(w) != 6
                or w[0] != "w1"
            ):
                return {}
            return {
                g[0]: (int(g[2]), int(g[3]))
                for g in w[5]
                if int(g[2]) >= 0
            }
        except Exception:
            return {}

    async def next_events(self) -> list:
        """One chunk: a list of (key, value, ts, flags) with decoded
        documents (value None = delete, flags bit 0 = dup-flagged).
        Empty list = no new events this round (the server long-polled
        ``wait_ms`` on its local ring first)."""
        chunk = await self._client._watch_chunk_request(
            self._request
        )
        cursor = chunk.get("cursor")
        events = []
        for key, value, ts, flags in chunk.get("events") or ():
            self.events_seen += 1
            if flags & 1:
                self.dup_flagged += 1
            events.append(
                (
                    msgpack_codec.unpackb(key),
                    msgpack_codec.unpackb(value)
                    if value
                    else None,
                    ts,
                    flags,
                )
            )
        if cursor:
            pos = self._cursor_positions(cursor)
            for name, p in pos.items():
                old = self._positions.get(name)
                if old is not None and p < old:
                    self.monotonicity_violations += 1
            self._positions.update(pos)
            self.cursor = bytes(cursor)
            self._request = {
                "type": "watch_next",
                "cursor": self.cursor,
            }
            if self._wait_ms > 0:
                self._request["wait_ms"] = self._wait_ms
        self.chunks += 1
        return events


class DbeelClientSync:
    """Blocking convenience wrapper (the reference ships a 49-line
    synchronous python client, dbeel.py — this is its
    batteries-included equivalent)."""

    def __init__(self, seed_addresses: Sequence[Tuple[str, int]]):
        import asyncio as _asyncio

        self._loop = _asyncio.new_event_loop()
        self._client = self._run(
            DbeelClient.from_seed_nodes(seed_addresses)
        )

    def _run(self, coro):
        return self._loop.run_until_complete(coro)

    def create_collection(self, name, replication_factor=None):
        self._run(
            self._client.create_collection(name, replication_factor)
        )
        return SyncCollection(self, self._client.collection(name))

    def drop_collection(self, name):
        self._run(self._client.drop_collection(name))

    def collection(self, name):
        return SyncCollection(self, self._client.collection(name))

    def get_stats(self, host=None, port=None):
        return self._run(self._client.get_stats(host, port))

    def cluster_stats(self, host=None, port=None):
        return self._run(self._client.cluster_stats(host, port))

    def telemetry_dump(self, host=None, port=None):
        return self._run(self._client.telemetry_dump(host, port))

    def rearm(self, host=None, port=None):
        self._run(self._client.rearm(host, port))

    def close(self):
        self._loop.close()


class SyncCollection:
    def __init__(self, sync_client, collection):
        self._c = sync_client
        self._col = collection

    def set(self, key, value, consistency=None):
        self._c._run(self._col.set(key, value, consistency))

    def get(self, key, consistency=None):
        return self._c._run(self._col.get(key, consistency))

    def cas(self, key, value=None, **kw):
        return self._c._run(self._col.cas(key, value, **kw))

    def rmw(self, key, fn, **kw):
        return self._c._run(self._col.rmw(key, fn, **kw))

    def atomic_batch(self, ops, consistency=None):
        return self._c._run(
            self._col.atomic_batch(ops, consistency)
        )

    def scan(
        self, prefix=None, limit=None, max_bytes=None, filter=None
    ):
        async def collect():
            out = []
            async for kv in self._col.scan(
                prefix, limit, max_bytes, filter=filter
            ):
                out.append(kv)
            return out

        return self._c._run(collect())

    def count(
        self, prefix=None, limit=None, filter=None, aggregate=None
    ):
        return self._c._run(
            self._col.count(
                prefix, limit, filter=filter, aggregate=aggregate
            )
        )

    def delete(self, key, consistency=None):
        self._c._run(self._col.delete(key, consistency))

    def watcher(
        self, filter=None, wait_ms=1000, sub_id=None, cursor=None
    ):
        return SyncWatcher(
            self._c,
            self._col.watcher(
                filter=filter,
                wait_ms=wait_ms,
                sub_id=sub_id,
                cursor=cursor,
            ),
        )


class SyncWatcher:
    """Blocking wrapper over Watcher: each ``next_events()`` call
    pulls one chunk (possibly empty after the server's long-poll)."""

    def __init__(self, sync_client, watcher):
        self._c = sync_client
        self._w = watcher

    def next_events(self):
        return self._c._run(self._w.next_events())

    @property
    def cursor(self):
        return self._w.cursor

    @property
    def monotonicity_violations(self):
        return self._w.monotonicity_violations

    @property
    def dup_flagged(self):
        return self._w.dup_flagged

    @property
    def events_seen(self):
        return self._w.events_seen
