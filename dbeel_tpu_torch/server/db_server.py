"""The public document API server — msgpack over TCP.

Wire-compatible with the reference's db_server.rs: one listener per
shard at ``port + shard_id``; requests are u16-LE length-prefixed
msgpack maps; responses are u32-LE length-prefixed payloads with one
trailing type byte (Err=0, Ok=1, Bytes=2); errors cross as
``[name, message]``; the connection closes after each response.  The
reference's own 49-line python client (dbeel.py) works against this
server unchanged.

Every msgpack frame goes through this package's own codec
(``utils/msgpack_codec.py``), byte-identical to ``msgpack``'s.
"""

from __future__ import annotations

import asyncio
import logging
import struct
import time

from typing import Optional

from ..errors import (
    BadFieldType,
    CasConflict,
    CorruptedFile,
    DbeelError,
    KeyNotFound,
    KeyNotOwnedByShard,
    MissingField,
    ERROR_CLASS_OTHER,
    ERROR_CLASS_OVERLOAD,
    Overloaded,
    PeerDead,
    Timeout,
    UnsupportedField,
    classify_error,
)
from ..cluster import messages as msgs
from ..cluster.messages import (
    ShardRequest,
    ShardResponse,
    pack_message,
)
from ..storage.entry import TOMBSTONE
from ..utils import msgpack_codec
from ..utils.murmur import hash_bytes, murmur3_32
from ..utils.timestamps import now_nanos
from . import framed
from . import qos as qos_mod
from . import trace as trace_mod
from .shard import MyShard

log = logging.getLogger(__name__)

RESPONSE_ERR = 0
RESPONSE_OK = 1
RESPONSE_BYTES = 2

DEFAULT_SET_TIMEOUT_MS = 5000  # db_server.rs:31-32
DEFAULT_GET_TIMEOUT_MS = 5000

# "No local read happened yet" marker for the RF>1 get path (None is
# a legitimate local read result: key absent).
_NO_LOCAL_READ = object()


def _quorum_error(my_shard: MyShard, op: str, op_status: dict):
    """Error for a quorum deadline expiry: ``PeerDead`` when a
    fan-out target was marked Dead during (or just before) the wait —
    the op stalled on a dead replica, distinct from a merely slow
    quorum; ``Overloaded`` when a replica SHED the request (its
    governor past the hard limit / propagated deadline expired / our
    capped outbound queue refused it) — the client should back off,
    not immediately hammer the next replica; else plain
    ``Timeout``."""
    targets = op_status.get("targets", ())
    if op_status.get("peer_dead") or any(
        t in my_shard.dead_nodes for t in targets
    ):
        return PeerDead(
            f"{op}: replica marked Dead during quorum wait"
        )
    if op_status.get("peer_overloaded"):
        return Overloaded(
            f"{op}: replica shed the request during quorum wait"
        )
    return Timeout(op)


def _wall_deadline_ms(request: dict, timeout_ms: int) -> int:
    """Absolute wall-clock deadline (ms) to propagate on peer frames:
    the client's own budget when it sent one (deadline_ms), else this
    op's timeout from receipt.  Wall clock like the LWW timestamps —
    replicas on loosely-synced clocks share the caveat the data model
    already accepts."""
    deadline_ms = request.get("deadline_ms")
    if isinstance(deadline_ms, int) and deadline_ms > 0:
        return deadline_ms
    return int(time.time() * 1000) + timeout_ms


# Ops the governor may shed at the hard limit.  Admin/observability
# (get_stats, metadata, rearm, collection DDL) always serve: an
# operator must be able to see into — and command — an overloaded
# node, and DDL is rare enough to never be the overload source.
_SHEDDABLE_OPS = frozenset(
    {
        "set",
        "get",
        "delete",
        "multi_set",
        "multi_get",
        # Atomic plane: conditional writes are data ops —
        # sheddable, deadline-droppable, QoS-laned like any set.
        "cas",
        "atomic_batch",
    }
)


def _note_completion(
    my_shard: MyShard,
    op: str,
    started: float,
    timeout_ms: Optional[int],
    deadline_ms: Optional[int],
) -> None:
    """Feed the governor's dead-completion signal: a data op that
    finished after the budget its client gave it (propagated
    deadline, or its own timeout field) produced a response nobody
    was waiting for."""
    if op not in _SHEDDABLE_OPS:
        return
    if isinstance(deadline_ms, int) and deadline_ms > 0:
        dead = time.time() * 1000.0 > deadline_ms
    else:
        elapsed_ms = (time.monotonic() - started) * 1000.0
        dead = elapsed_ms > float(
            timeout_ms or DEFAULT_SET_TIMEOUT_MS
        )
    my_shard.governor.note_completion(dead)


def _deadline_dead_on_arrival(my_shard: MyShard, request: dict) -> bool:
    """Client-supplied absolute deadline already expired at dispatch
    (the frame sat in a backlogged queue longer than the client was
    willing to wait): drop the work instead of computing a dead
    response."""
    deadline_ms = request.get("deadline_ms")
    if not isinstance(deadline_ms, int) or deadline_ms <= 0:
        return False
    if time.time() * 1000.0 <= deadline_ms:
        return False
    my_shard.governor.deadline_drops += 1
    return True


def _extract(map_: dict, field: str):
    if field not in map_:
        raise MissingField(field)
    return map_[field]


def _client_trace_id(request: dict) -> Optional[int]:
    """Client-stamped trace id on the request frame (tracing plane):
    a positive int under the ``trace`` key forces a full span for
    this op — the C parsers punt such frames so the interpreted path
    (which owns the stage marks) always serves them."""
    tid = request.get("trace")
    if isinstance(tid, int) and tid > 0:
        return tid
    return None


def _trace_id_for_peers(ctx) -> Optional[int]:
    """Trace id to stamp on fan-out peer frames: replicas serving a
    traced frame piggyback their own stage summary on the response."""
    return ctx.trace_id if ctx is not None else None


def _qos_for_peers(request: dict) -> Optional[int]:
    """QoS class to stamp on fan-out peer frames (QoS plane): the
    client's class, or None for STANDARD so default traffic keeps the
    pre-QoS peer dialects byte-for-byte (old replicas treat an absent
    element as standard anyway)."""
    cls = qos_mod.request_class(request)
    return cls if cls != qos_mod.QOS_STANDARD else None


def _encode_field(value) -> bytes:
    """Keys/values are stored as their msgpack encoding
    (db_server.rs:93-104)."""
    return msgpack_codec.packb(value)


def extract_key(my_shard: MyShard, map_: dict, replica_index: int) -> bytes:
    key = _encode_field(_extract(map_, "key"))
    key_hash = map_.get("hash")
    if not isinstance(key_hash, int):
        key_hash = hash_bytes(key)
    if not my_shard.owns_key(key_hash, replica_index):
        raise KeyNotOwnedByShard(
            f"shard {my_shard.shard_name} does not own hash {key_hash}"
        )
    return key


def _check_membership_epoch(my_shard: MyShard, request: dict) -> None:
    """Epoch fence (elastic membership plane): a write stamped with a
    membership epoch older than this shard's — WHILE a migration is
    live — was routed by an outdated ring view and may land on an arc
    that is mid-handoff; refuse it retryably (`not-owned` class) so
    the client resyncs metadata and re-routes.  Unstamped writes (old
    clients, the C client) are never fenced — for them the ownership
    check + anti-entropy remain the convergence story, exactly as
    before this plane existed.  Once the last migration drains the
    fence lifts even for stale stamps: a long-converged cluster must
    not refuse a client that simply hasn't polled metadata lately."""
    epoch = request.get("epoch")
    if (
        isinstance(epoch, int)
        and epoch > 0
        and epoch < my_shard.membership_epoch
        and my_shard._migration_tasks
    ):
        my_shard.fence_refusals += 1
        raise KeyNotOwnedByShard(
            f"stale membership epoch {epoch} < "
            f"{my_shard.membership_epoch} during migration"
        )


async def handle_request(
    my_shard: MyShard, request: dict
) -> Optional[bytes]:
    """Returns the response payload (None => plain 'OK')."""
    timestamp = now_nanos()
    rtype = request.get("type")

    if rtype in _SHEDDABLE_OPS and _deadline_dead_on_arrival(
        my_shard, request
    ):
        # Deadline propagation, coordinator side: the client's budget
        # expired while this frame waited its turn — every cycle
        # spent on it now (local read, quorum fan-out) would compute
        # a response nobody reads.  Retryable by taxonomy; the client
        # has long since walked on.
        raise Overloaded("client deadline expired before dispatch")

    if rtype == "get_cluster_metadata":
        return msgpack_codec.packb(
            my_shard.get_cluster_metadata().to_wire()
        )

    if rtype == "get_stats":
        # Observability extension (no reference analog).
        return msgpack_codec.packb(my_shard.get_stats())

    if rtype == "trace_dump":
        # Tracing plane: the flight recorder's ring — sampled
        # spans plus every slow/error op.  Always served, like
        # get_stats: the slow tail of an overload must be readable
        # DURING the overload (not in _SHEDDABLE_OPS).
        return msgpack_codec.packb(
            my_shard.trace_recorder.dump()
        )

    if rtype == "cluster_stats":
        # Telemetry plane: the gossip-aggregated per-node
        # health view — ask ANY node, see the whole cluster.  Always
        # served (an overloaded or degraded cluster is exactly when
        # the operator needs the rollup).
        return msgpack_codec.packb(
            my_shard.cluster_stats()
        )

    if rtype == "telemetry_dump":
        # Telemetry plane: this shard's full time-series ring
        # + derived rates + health verdict.  Always served, like
        # get_stats/trace_dump.
        return msgpack_codec.packb(
            my_shard.telemetry.dump()
        )

    if rtype == "rearm":
        # Admin: exit sticky degraded read-only mode after disk
        # replacement, no restart — re-runs the free-space/WAL-append
        # pre-checks, re-registers the native write plane, and fans
        # the verb out to this node's sibling shards over the REARM
        # peer frame (every shard of the node shares the replaced
        # disk; the peer handler never re-enters this path, so the
        # fan-out cannot recurse).  Errors (pre-check still failing
        # on any shard) surface as the usual error frame; the shard
        # stays degraded.
        await my_shard.rearm()
        await my_shard.send_request_to_local_shards(
            ShardRequest.rearm(), ShardResponse.REARM
        )
        return None

    if rtype == "create_collection":
        name = _extract(request, "name")
        rf = request.get("replication_factor")
        if not isinstance(rf, int):
            rf = my_shard.config.default_replication_factor
        # DDL-carried tenant-quota overrides:
        # per-collection ops/bytes rates that beat the --tenant-*
        # flag defaults, round-tripped through collection metadata.
        quotas = None
        if isinstance(request.get("ops_per_sec"), int) or isinstance(
            request.get("bytes_per_sec"), int
        ):
            quotas = {}
            if isinstance(request.get("ops_per_sec"), int):
                quotas["ops_per_sec"] = request["ops_per_sec"]
            if isinstance(request.get("bytes_per_sec"), int):
                quotas["bytes_per_sec"] = request["bytes_per_sec"]
        # Secondary-index DDL: optional list of value
        # fields to maintain persisted per-SSTable index runs for.
        # Sanitized shard-side; junk entries are dropped there.
        index = request.get("index")
        if not isinstance(index, (list, tuple)):
            index = None
        from ..errors import CollectionAlreadyExists

        if name in my_shard.collections:
            raise CollectionAlreadyExists(name)
        await my_shard.create_collection(name, rf, quotas, index)
        await my_shard.send_request_to_local_shards(
            ShardRequest.create_collection(name, rf, quotas, index),
            ShardResponse.CREATE_COLLECTION,
        )
        await my_shard.gossip(
            msgs.GossipEvent.create_collection(name, rf, quotas, index)
        )
        return None

    if rtype == "get_collection":
        name = _extract(request, "name")
        col = my_shard.get_collection(name)
        body = {"replication_factor": col.replication_factor}
        if col.quotas:
            body["quotas"] = col.quotas
        if col.index_fields:
            body["index"] = col.index_fields
        return msgpack_codec.packb(body)

    if rtype == "drop_collection":
        name = _extract(request, "name")
        await my_shard.drop_collection(name)
        await my_shard.send_request_to_local_shards(
            ShardRequest.drop_collection(name),
            ShardResponse.DROP_COLLECTION,
        )
        await my_shard.gossip(msgs.GossipEvent.drop_collection(name))
        return None

    if rtype in ("set", "delete"):
        ctx = trace_mod.current()
        collection_name = _extract(request, "collection")
        timeout_ms = request.get("timeout") or DEFAULT_SET_TIMEOUT_MS
        replica_index = request.get("replica_index") or 0
        col = my_shard.get_collection(collection_name)
        key = extract_key(my_shard, request, replica_index)
        _check_membership_epoch(my_shard, request)
        rf = col.replication_factor

        if rtype == "set":
            value = _encode_field(_extract(request, "value"))
        else:
            value = TOMBSTONE

        consistency = request.get("consistency")
        if not isinstance(consistency, int):
            consistency = rf
        consistency = min(consistency, rf)
        if ctx is not None:
            # Ownership check + key/value encode + admission.
            ctx.mark("prep")

        async def local_write():
            # stale_abort: if our capacity wait spans a flush swap
            # that lands a NEWER write for this key, a blind insert
            # would put our older ts in a layer above it and
            # first-match reads would serve it — apply read-guarded
            # instead (LWW: whichever ts is newer wins), the same
            # contract as the replica-side handle_shard_set_message.
            t_local = time.monotonic()
            if not await col.tree.set_with_timestamp(
                key, value, timestamp, stale_abort=True
            ):
                await my_shard.apply_if_newer(
                    col.tree, key, value, timestamp
                )
            if ctx is not None:
                # Overlapping detail: the local memtable+WAL write
                # runs concurrently with the quorum fan-out, so it is
                # attributed beside the stages, not among them.
                ctx.note(
                    "local_write_us",
                    (time.monotonic() - t_local) * 1e6,
                )

        if rf > 1:
            peer_deadline = _wall_deadline_ms(request, timeout_ms)
            peer_qos = _qos_for_peers(request)
            remote_request = (
                ShardRequest.set(
                    collection_name, key, value, timestamp,
                    deadline_ms=peer_deadline,
                    trace_id=_trace_id_for_peers(ctx),
                    qos=peer_qos,
                )
                if rtype == "set"
                else ShardRequest.delete(
                    collection_name, key, timestamp,
                    deadline_ms=peer_deadline,
                    trace_id=_trace_id_for_peers(ctx),
                    qos=peer_qos,
                )
            )
            expected = (
                ShardResponse.SET
                if rtype == "set"
                else ShardResponse.DELETE
            )
            op_status: dict = {}
            remote = my_shard.send_request_to_replicas(
                remote_request,
                consistency - 1,
                rf - replica_index - 1,
                expected,
                op_status=op_status,
                key_hash=hash_bytes(key),
            )
            try:
                await asyncio.wait_for(
                    asyncio.gather(local_write(), remote),
                    timeout_ms / 1000,
                )
            except asyncio.TimeoutError as e:
                raise _quorum_error(
                    my_shard, rtype, op_status
                ) from e
            finally:
                if ctx is not None:
                    # Wall time of the overlapped local write +
                    # replica fan-out up to the consistency-th ack.
                    ctx.mark("quorum")
        else:
            try:
                await asyncio.wait_for(local_write(), timeout_ms / 1000)
            except asyncio.TimeoutError as e:
                raise Timeout(rtype) from e
            finally:
                if ctx is not None:
                    ctx.mark("local")
        return None

    if rtype in ("multi_set", "multi_get"):
        return await _handle_multi(my_shard, request, timestamp, rtype)

    if rtype == "cas":
        # Atomic plane: conditional single-key write,
        # decided at the key's arc owner under the per-arc lock.
        return await _handle_cas(my_shard, request)

    if rtype == "atomic_batch":
        # Atomic plane: all-or-nothing multi-key
        # conditional batch on ONE ring arc.
        return await _handle_atomic_batch(my_shard, request)

    if rtype in ("scan", "scan_next"):
        # Streaming scan plane: one governor-admitted chunk
        # per frame — byte-budgeted, merged across every ring arc's
        # replicas, resumable via the opaque cursor in the payload.
        # Shedding/pacing and the scan stats block live in the plane;
        # a shed surfaces as the retryable Overloaded and the CURSOR
        # SURVIVES (it is client-held state), so the client backs off
        # and resumes where it left.
        return await my_shard.scan_plane.handle(request, rtype)

    if rtype in ("watch", "watch_next"):
        # Watch/CDC streaming plane: one chunk of change
        # events per frame with a self-contained resumable cursor in
        # EVERY chunk — the stream survives coordinator death, sheds
        # (retryable Overloaded; the cursor is client-held state),
        # arc handoff (durable-state catch-up, dup-flagged) and the
        # membership-epoch fence (retryable not-owned → resync).
        return await my_shard.watch_plane.handle(request, rtype)

    if rtype == "get":
        ctx = trace_mod.current()
        collection_name = _extract(request, "collection")
        timeout_ms = request.get("timeout") or DEFAULT_GET_TIMEOUT_MS
        replica_index = request.get("replica_index") or 0
        col = my_shard.get_collection(collection_name)
        key = extract_key(my_shard, request, replica_index)
        rf = col.replication_factor

        consistency = request.get("consistency")
        if not isinstance(consistency, int):
            consistency = rf
        consistency = min(consistency, rf)
        if ctx is not None:
            ctx.mark("prep")

        if rf > 1:
            deadline = (
                asyncio.get_event_loop().time() + timeout_ms / 1000
            )
            op_status = {}
            local_value = _NO_LOCAL_READ
            if _digest_reads_enabled():
                # Digest round: local read first (it anchors the
                # predicted digest bytes), then (ts, hash) fan-out —
                # full entries move only when a replica is newer.
                try:
                    # consistency=1 means this local read may be the
                    # ONLY evidence: shadow-suspect hits must demote
                    # to (guarded) misses.  With consistency>1 the
                    # quorum merge outvotes staleness by timestamp.
                    local_value = await asyncio.wait_for(
                        col.tree.get_entry(
                            key, suspect_guard=consistency == 1
                        ),
                        timeout_ms / 1000,
                    )
                except asyncio.TimeoutError as e:
                    raise Timeout("get") from e
                finally:
                    if ctx is not None:
                        # Local memtable/table probe anchoring the
                        # predicted digest bytes.
                        ctx.mark("probe")
                digest_agreed = await _digest_quorum_round(
                    my_shard,
                    collection_name,
                    col,
                    key,
                    local_value,
                    consistency,
                    rf - replica_index - 1,
                    max(
                        0.001,
                        deadline - asyncio.get_event_loop().time(),
                    ),
                    op_status=op_status,
                    deadline_ms=_wall_deadline_ms(
                        request, timeout_ms
                    ),
                    trace_id=_trace_id_for_peers(ctx),
                    qos=_qos_for_peers(request),
                )
                if ctx is not None:
                    ctx.mark("digest")
                if digest_agreed:
                    if (
                        local_value is None
                        or bytes(local_value[0]) == TOMBSTONE
                    ):
                        if (
                            local_value is None
                            and consistency == 1
                            and col.tree.reads_suspect
                        ):
                            # No replica corroborated this absence
                            # (consistency=1 ends the digest round
                            # immediately): unproven during a pending
                            # repair — error retryably.
                            raise CorruptedFile(
                                "local miss is suspect: quarantined "
                                "table pending repair"
                            )
                        raise KeyNotFound(repr(key))
                    return bytes(local_value[0])
            remote = my_shard.send_request_to_replicas(
                ShardRequest.get(
                    collection_name,
                    key,
                    deadline_ms=_wall_deadline_ms(
                        request, timeout_ms
                    ),
                    trace_id=_trace_id_for_peers(ctx),
                    qos=_qos_for_peers(request),
                ),
                consistency - 1,
                rf - replica_index - 1,
                ShardResponse.GET,
                op_status=op_status,
                key_hash=hash_bytes(key),
            )
            try:
                if local_value is _NO_LOCAL_READ:
                    local_value, values = await asyncio.wait_for(
                        asyncio.gather(
                            col.tree.get_entry(
                                key, suspect_guard=consistency == 1
                            ),
                            remote,
                        ),
                        max(
                            0.001,
                            deadline
                            - asyncio.get_event_loop().time(),
                        ),
                    )
                else:
                    # The digest round already read the local entry;
                    # don't pay a second tree lookup on fallback.
                    values = await asyncio.wait_for(
                        remote,
                        max(
                            0.001,
                            deadline
                            - asyncio.get_event_loop().time(),
                        ),
                    )
            except asyncio.TimeoutError as e:
                raise _quorum_error(my_shard, "get", op_status) from e
            finally:
                if ctx is not None:
                    ctx.mark("quorum")
            return _merge_quorum_get(
                my_shard,
                collection_name,
                col,
                key,
                local_value,
                values,
                rf - replica_index - 1,
            )
        try:
            entry = await asyncio.wait_for(
                col.tree.get_entry(key, suspect_guard=True),
                timeout_ms / 1000,
            )
        except asyncio.TimeoutError as e:
            raise Timeout("get") from e
        finally:
            if ctx is not None:
                ctx.mark("probe")
        if entry is not None and bytes(entry[0]) != TOMBSTONE:
            return bytes(entry[0])
        if entry is None and col.tree.reads_suspect:
            # RF=1 read on a tree with a quarantine pending repair:
            # absence is unproven (the key may have lived in the
            # dropped table) — surface the retryable corruption
            # error, not a confident KeyNotFound.  A TOMBSTONE hit
            # that survived the suspect guard is newest evidence and
            # stays a confident KeyNotFound.
            raise CorruptedFile(
                "local miss is suspect: quarantined table "
                "pending repair"
            )
        raise KeyNotFound(repr(key))

    if isinstance(rtype, str):
        raise UnsupportedField(rtype)
    raise BadFieldType("type")


# Batched multi-op bounds: ops per frame (the u16 request framing is
# its own byte bound; this caps the per-frame allocation fan).
MULTI_MAX_OPS = 4096


async def _handle_multi(
    my_shard: MyShard, request: dict, timestamp: int, rtype: str
) -> bytes:
    """One multi_set/multi_get frame: N sub-ops in, ONE response frame
    with N aligned results out.  Each result is ``[0, payload]`` (ok —
    payload is the value bytes for gets, nil for sets) or
    ``[1, [kind, message]]`` (per-sub-op error in the standard wire
    error shape), so a client can fail over individual keys without
    losing the rest of the batch.

    The batch shares everything a per-op loop would repeat: ownership
    checks ride one ring lookup each but the storage work batches —
    one memtable capacity check + one WAL append_batch + one wal-sync
    ticket for sets (group commit), one sstable-list acquire for gets
    (LSMTree.multi_get) — and RF>1 batches fan out ONE peer frame per
    replica (ShardRequest.multi_set/multi_get) with a single quorum
    wait for the whole batch, instead of a frame per sub-op."""
    collection_name = _extract(request, "collection")
    ops = _extract(request, "ops")
    if not isinstance(ops, (list, tuple)):
        raise BadFieldType("ops")
    if len(ops) > MULTI_MAX_OPS:
        raise BadFieldType(f"ops: batch above {MULTI_MAX_OPS}")
    is_set = rtype == "multi_set"
    timeout_ms = request.get("timeout") or (
        DEFAULT_SET_TIMEOUT_MS if is_set else DEFAULT_GET_TIMEOUT_MS
    )
    replica_index = request.get("replica_index") or 0
    col = my_shard.get_collection(collection_name)
    if is_set:
        # Frame-level fence: the epoch stamps the client's ring VIEW,
        # which routed the whole batch — a stale view refuses the
        # frame, not individual sub-ops.
        _check_membership_epoch(my_shard, request)
    rf = col.replication_factor
    consistency = request.get("consistency")
    if not isinstance(consistency, int):
        consistency = rf
    consistency = min(consistency, rf)
    my_shard.metrics.record_batch_size(len(ops))

    results: list = [None] * len(ops)
    keyed: list = []  # (result_index, key_bytes[, value_bytes])
    min_fields = 3 if is_set else 2
    for i, op in enumerate(ops):
        try:
            if (
                not isinstance(op, (list, tuple))
                or len(op) < min_fields
            ):
                raise BadFieldType("ops")
            key = _encode_field(op[0])
            key_hash = op[1]
            if not isinstance(key_hash, int):
                key_hash = hash_bytes(key)
            if not my_shard.owns_key(key_hash, replica_index):
                raise KeyNotOwnedByShard(
                    f"shard {my_shard.shard_name} does not own "
                    f"hash {key_hash}"
                )
            if is_set:
                keyed.append((i, key, _encode_field(op[2])))
            else:
                keyed.append((i, key))
        except DbeelError as e:
            my_shard.metrics.record_error(classify_error(e))
            results[i] = [1, e.to_wire()]
    if not keyed:
        return msgpack_codec.packb(results)

    peer_qos = _qos_for_peers(request)
    if is_set:
        await _multi_set_keyed(
            my_shard,
            collection_name,
            col,
            keyed,
            results,
            timestamp,
            consistency,
            rf,
            replica_index,
            timeout_ms,
            peer_qos,
        )
    else:
        await _multi_get_keyed(
            my_shard,
            collection_name,
            col,
            keyed,
            results,
            consistency,
            rf,
            replica_index,
            timeout_ms,
            peer_qos,
        )
    return msgpack_codec.packb(results)


def _group_keyed_by_replica_set(
    my_shard: MyShard, keyed: list, number_of_nodes: int
) -> list:
    """Group multi-op sub-ops by their keys' replica sets (elastic
    membership plane): under vnodes one coordinator shard owns many
    arcs, and keys on different arcs fan to DIFFERENT downstream
    replica nodes — one peer frame per distinct replica set keeps
    placement exact.  With one token per shard every owned key shares
    the shard's lone arc, so this collapses to a single group: the
    legacy one-frame-per-batch behavior, byte for byte.  Returns
    ``[(items, anchor_key_hash), ...]`` in first-seen order."""
    groups: dict = {}
    order: list = []
    for item in keyed:
        kh = hash_bytes(item[1])
        names = tuple(
            n
            for n, _c in my_shard._replica_connections(
                number_of_nodes, kh
            )
        )
        g = groups.get(names)
        if g is None:
            g = groups[names] = (list(), kh)
            order.append(g)
        g[0].append(item)
    return order


async def _multi_set_keyed(
    my_shard: MyShard,
    collection_name: str,
    col,
    keyed: list,
    results: list,
    timestamp: int,
    consistency: int,
    rf: int,
    replica_index: int,
    timeout_ms: int,
    peer_qos: Optional[int] = None,
) -> None:
    entries = [(key, value, timestamp) for _i, key, value in keyed]
    op_status: dict = {}
    ctx = trace_mod.current()
    if ctx is not None:
        ctx.mark("prep")

    async def local_batch():
        # stale_abort mirrors the single-set coordinator path: a
        # capacity wait spanning a flush swap must not land our
        # older ts above a flushed newer value — rejected entries
        # apply read-guarded (LWW).
        rejected = await col.tree.set_batch_with_timestamp(
            entries, stale_abort=True
        )
        for k, v, ts in rejected:
            await my_shard.apply_if_newer(col.tree, k, v, ts)

    try:
        local = local_batch()
        if rf > 1:
            remotes = [
                my_shard.send_request_to_replicas(
                    ShardRequest.multi_set(
                        collection_name,
                        [
                            [key, value, timestamp]
                            for _i, key, value in items
                        ],
                        deadline_ms=int(time.time() * 1000)
                        + timeout_ms,
                        trace_id=_trace_id_for_peers(ctx),
                        qos=peer_qos,
                    ),
                    consistency - 1,
                    rf - replica_index - 1,
                    ShardResponse.MULTI_SET,
                    op_status=op_status,
                    key_hash=anchor,
                )
                for items, anchor in _group_keyed_by_replica_set(
                    my_shard, keyed, rf - replica_index - 1
                )
            ]
            await asyncio.wait_for(
                asyncio.gather(local, *remotes), timeout_ms / 1000
            )
        else:
            await asyncio.wait_for(local, timeout_ms / 1000)
    except asyncio.TimeoutError:
        err = _quorum_error(my_shard, "multi_set", op_status)
        my_shard.metrics.record_error(classify_error(err))
        wire = err.to_wire()
        for i, *_rest in keyed:
            results[i] = [1, wire]
        return
    finally:
        # In a finally like the single-op paths: the timed-out multi
        # ops are exactly the ones whose quorum wait must not be
        # misattributed to "respond".
        if ctx is not None:
            ctx.mark("quorum" if rf > 1 else "local")
    for i, *_rest in keyed:
        results[i] = [0, None]


async def _multi_get_keyed(
    my_shard: MyShard,
    collection_name: str,
    col,
    keyed: list,
    results: list,
    consistency: int,
    rf: int,
    replica_index: int,
    timeout_ms: int,
    peer_qos: Optional[int] = None,
) -> None:
    keys = [key for _i, key in keyed]
    op_status: dict = {}
    number_of_nodes = rf - replica_index - 1
    ctx = trace_mod.current()
    if ctx is not None:
        ctx.mark("prep")
    group_results: list = []  # (items, replica_lists) per group
    try:
        # suspect_guard whenever the local read may be the ONLY
        # evidence (consistency=1 — including RF>1 with 0 remote acks
        # awaited): a quorum merge outvotes shadow-suspect staleness
        # by timestamp, an evidence-free merge cannot.
        local = col.tree.multi_get(
            keys, suspect_guard=consistency == 1
        )
        if rf > 1:
            # Full-entry round only: the digest prediction is a
            # per-key byte-compare trick and does not compose with
            # one-frame-per-peer batching (ARCHITECTURE.md).  One
            # frame per distinct replica set (vnodes: keys on
            # different arcs read different replica nodes).
            groups = _group_keyed_by_replica_set(
                my_shard, keyed, number_of_nodes
            )
            remotes = [
                my_shard.send_request_to_replicas(
                    ShardRequest.multi_get(
                        collection_name,
                        [key for _i, key in items],
                        deadline_ms=int(time.time() * 1000)
                        + timeout_ms,
                        trace_id=_trace_id_for_peers(ctx),
                        qos=peer_qos,
                    ),
                    consistency - 1,
                    number_of_nodes,
                    ShardResponse.MULTI_GET,
                    op_status=op_status,
                    key_hash=anchor,
                )
                for items, anchor in groups
            ]
            local_map, *per_group = await asyncio.wait_for(
                asyncio.gather(local, *remotes), timeout_ms / 1000
            )
            group_results = [
                (items, lists)
                for (items, _anchor), lists in zip(groups, per_group)
            ]
        else:
            local_map = await asyncio.wait_for(
                local, timeout_ms / 1000
            )
    except asyncio.TimeoutError:
        err = _quorum_error(my_shard, "multi_get", op_status)
        my_shard.metrics.record_error(classify_error(err))
        wire = err.to_wire()
        for i, _key in keyed:
            results[i] = [1, wire]
        return
    finally:
        if ctx is not None:
            ctx.mark("quorum" if rf > 1 else "local")
    if rf > 1:
        for items, replica_lists in group_results:
            aligned = [
                r
                for r in replica_lists
                if isinstance(r, (list, tuple))
                and len(r) == len(items)
            ]
            for j, (i, key) in enumerate(items):
                local_value = local_map.get(key)
                try:
                    win = _merge_quorum_get(
                        my_shard,
                        collection_name,
                        col,
                        key,
                        local_value,
                        [r[j] for r in aligned],
                        number_of_nodes,
                    )
                    results[i] = [0, win]
                except KeyNotFound as e:
                    results[i] = [1, e.to_wire()]
                except CorruptedFile as e:
                    # Suspect miss (quarantine pending repair):
                    # retryable per-sub-op error; the client re-runs
                    # it through the single-op replica walk.
                    my_shard.metrics.record_error(classify_error(e))
                    results[i] = [1, e.to_wire()]
        return
    for i, key in keyed:
        local_value = local_map.get(key)
        if local_value is None and col.tree.reads_suspect:
            e = CorruptedFile(
                "local miss is suspect: quarantined table pending "
                "repair"
            )
            my_shard.metrics.record_error(classify_error(e))
            results[i] = [1, e.to_wire()]
        elif (
            local_value is None
            or bytes(local_value[0]) == TOMBSTONE
        ):
            results[i] = [1, KeyNotFound(repr(key)).to_wire()]
        else:
            results[i] = [0, bytes(local_value[0])]


# ---------------------------------------------------------------------
# Atomic plane: epoch-fenced CAS + per-arc atomic batches.
#
# A conditional write DECIDES at exactly one replica — the key's arc
# owner (replica index 0 on the walk, or the first live stand-in when
# everything ahead is marked Dead) — under a per-(collection, arc)
# asyncio.Lock, so read-compare-decide sequences on an arc can never
# interleave.  The decider reads the key's current state at the op's
# consistency (R mirrors W, so quorum-consistency CAS observes every
# prior quorum-decided write even on a decider whose local tree is
# behind), compares the client's expectations, and on a match commits
# a fresh LWW timestamp that replicates as ORDINARY set/delete/
# multi_set peer frames — hinted handoff, read repair and
# anti-entropy converge replicas with no new peer verbs.  The
# membership-epoch fence applies exactly as it does to plain writes
# (re-checked under the lock: a migration may start while the op
# queues), and frames always serve on this interpreted path — the C
# planes punt the cas/atomic_batch verbs by construction (lint-pinned)
# so the fence and the lock cannot be bypassed.
#
# Caveats (documented in ARCHITECTURE.md): mixing raw LWW sets with
# CAS on the same key forfeits the CAS guarantees, and expect_value
# has the usual ABA limitation.
# ---------------------------------------------------------------------

# Ops per atomic_batch frame.  Small by design: the batch holds the
# arc lock across its quorum read + commit, so a huge batch would
# head-of-line-block every other conditional write on the arc.
ATOMIC_BATCH_MAX_OPS = 128

_NO_EXPECT = object()


def _atomic_decider_gate(
    my_shard: MyShard, key_hash: int, replica_index: int
) -> None:
    """Single-decider election for conditional writes.  The natural
    decider is replica index 0 on the key's walk; a later replica may
    stand in ONLY while every node ahead of it is marked Dead (the
    client walked here because the primary was unreachable).  Two
    LIVE deciders on one arc would each serialize CAS locally and
    could ack conflicting outcomes — the split brain the arc lock
    exists to prevent.  A freshly-restarted decider additionally sits
    out the boot barrier, so its comeback cannot race a stand-in that
    has not yet seen its Alive edge."""
    if replica_index > 0:
        alive = [
            n
            for n in my_shard.preceding_replica_nodes(key_hash)
            if n not in my_shard.dead_nodes
        ]
        if alive:
            raise KeyNotOwnedByShard(
                f"conditional write at replica_index {replica_index}"
                f" refused: preceding replica(s) {alive} are alive"
            )
    barrier_s = my_shard.atomic_barrier_remaining_s()
    if barrier_s > 0:
        raise Overloaded(
            "conditional-write decider barrier: "
            f"{int(barrier_s * 1000)}ms remaining after restart"
        )


def _cas_mismatch(
    request: dict, current, require: bool = True
) -> Optional[str]:
    """None when the map's expectations match the key's current
    state, else the conflict detail.  ``request`` is the client's cas
    request map OR one atomic_batch op map (same expectation fields
    by design); ``current`` is the decider's merged (value_bytes, ts)
    view — the value may be the tombstone — or None for
    never-written.  With ``require`` (the cas verb) at least one
    expectation field is demanded; batch ops may be unconditional
    (they still commit-or-refuse with the whole batch)."""
    live = current is not None and bytes(current[0]) != TOMBSTONE
    cur_ts = None if current is None else current[1]
    checked = False
    if request.get("expect_absent"):
        checked = True
        if live:
            return f"expected absent, but live at ts {cur_ts}"
    expect_ts = request.get("expect_ts")
    if isinstance(expect_ts, int):
        checked = True
        if cur_ts != expect_ts:
            return f"expected ts {expect_ts}, current ts {cur_ts}"
    expect_value = request.get("expect_value", _NO_EXPECT)
    if expect_value is not _NO_EXPECT:
        checked = True
        if not live:
            return "expected a live value, but key is absent"
        if bytes(current[0]) != _encode_field(expect_value):
            return "expected value does not match current value"
    if not checked and require:
        raise MissingField("expect_ts|expect_value|expect_absent")
    return None


async def _handle_cas(my_shard: MyShard, request: dict) -> bytes:
    ctx = trace_mod.current()
    collection_name = _extract(request, "collection")
    timeout_ms = request.get("timeout") or DEFAULT_SET_TIMEOUT_MS
    replica_index = request.get("replica_index") or 0
    col = my_shard.get_collection(collection_name)
    key = extract_key(my_shard, request, replica_index)
    _check_membership_epoch(my_shard, request)
    key_hash = hash_bytes(key)
    _atomic_decider_gate(my_shard, key_hash, replica_index)
    rf = col.replication_factor
    consistency = request.get("consistency")
    if not isinstance(consistency, int):
        consistency = rf
    consistency = min(consistency, rf)
    number_of_nodes = rf - replica_index - 1
    is_delete = bool(request.get("delete"))
    value = (
        TOMBSTONE
        if is_delete
        else _encode_field(_extract(request, "value"))
    )
    deadline = asyncio.get_event_loop().time() + timeout_ms / 1000
    op_status: dict = {}
    if ctx is not None:
        ctx.mark("prep")
    async with my_shard.atomic_lock(collection_name, key_hash):
        # Fence re-check under the lock: a migration (and its epoch
        # bump) may have landed while this op queued behind another
        # conditional write.
        _check_membership_epoch(my_shard, request)
        try:
            current = await _atomic_read_current(
                my_shard,
                collection_name,
                col,
                key,
                consistency,
                number_of_nodes,
                deadline,
                request,
                timeout_ms,
                op_status,
                ctx,
            )
        except asyncio.TimeoutError as e:
            raise _quorum_error(my_shard, "cas", op_status) from e
        if ctx is not None:
            ctx.mark("read")
        detail = _cas_mismatch(request, current)
        if detail is not None:
            my_shard.cas_conflicts += 1
            raise CasConflict(f"cas on {key!r}: {detail}")
        # Decide with a fresh LWW timestamp strictly above the
        # observed current, so the outcome replicates as an ordinary
        # WINNING set/delete everywhere.
        decided_ts = now_nanos()
        if current is not None and decided_ts <= current[1]:
            decided_ts = current[1] + 1
        await _replicate_decided(
            my_shard,
            collection_name,
            col,
            request,
            key,
            value,
            is_delete,
            decided_ts,
            consistency,
            number_of_nodes,
            deadline,
            timeout_ms,
            op_status,
            "cas",
            ctx,
        )
    my_shard.cas_served += 1
    return msgpack_codec.packb({"ts": decided_ts})


def _live_arc_peers(
    my_shard: MyShard, number_of_nodes: int, key_hash: int
) -> int:
    """How many of the arc's walk-after-self replicas are NOT marked
    Dead right now — the response floor a decider's read must reach.
    Dead-marked peers fast-fail inside the fan-out (they cannot hold
    a write the failure detector hasn't already handed to hints), so
    they are excluded from the floor; every live-marked peer must
    actually answer or the conditional write refuses retryably."""
    if number_of_nodes <= 0:
        return 0
    peers = my_shard._replica_connections(
        number_of_nodes, key_hash
    )
    return sum(
        1
        for name, _c in peers
        if name not in my_shard.dead_nodes
    )


async def _atomic_read_current(
    my_shard: MyShard,
    collection_name: str,
    col,
    key: bytes,
    consistency: int,
    number_of_nodes: int,
    deadline: float,
    request: dict,
    timeout_ms: int,
    op_status: dict,
    ctx,
):
    """The decider's merged view of one key: local entry + a read of
    EVERY live replica on the arc.  A first-ack quorum read is not
    enough here: after a decider handover the newest committed write
    may live on exactly one surviving replica, and deciding against
    any view that might exclude it mints a NEWER timestamp on stale
    state — a silent lost update.  So the read demands an answer from
    every walk peer not marked Dead and raises TimeoutError (mapped
    to a retryable quorum refusal by the caller) when one is missing.
    Returns the max-timestamp (value_bytes, ts) — tombstones included
    — or None when no consulted replica has an entry."""
    local = col.tree.get_entry(
        key, suspect_guard=consistency == 1
    )
    budget = max(
        0.001, deadline - asyncio.get_event_loop().time()
    )
    live = _live_arc_peers(
        my_shard, number_of_nodes, hash_bytes(key)
    )
    if live > 0:
        remote = my_shard.send_request_to_replicas(
            ShardRequest.get(
                collection_name,
                key,
                deadline_ms=_wall_deadline_ms(request, timeout_ms),
                trace_id=_trace_id_for_peers(ctx),
                qos=_qos_for_peers(request),
            ),
            live,
            number_of_nodes,
            ShardResponse.GET,
            op_status=op_status,
            key_hash=hash_bytes(key),
        )
        local_value, values = await asyncio.wait_for(
            asyncio.gather(local, remote), budget
        )
        if len(values) < live:
            raise asyncio.TimeoutError(
                "atomic read: live replica did not answer"
            )
    else:
        local_value = await asyncio.wait_for(local, budget)
        values = []
    entries = [
        (bytes(v[0]), v[1]) for v in values if v is not None
    ]
    if local_value is not None:
        entries.append((bytes(local_value[0]), local_value[1]))
    if not entries:
        return None
    return max(entries, key=lambda e: e[1])


async def _replicate_decided(
    my_shard: MyShard,
    collection_name: str,
    col,
    request: dict,
    key: bytes,
    value: bytes,
    is_delete: bool,
    decided_ts: int,
    consistency: int,
    number_of_nodes: int,
    deadline: float,
    timeout_ms: int,
    op_status: dict,
    opname: str,
    ctx,
) -> None:
    """Commit + replicate one DECIDED conditional write exactly like
    an ordinary set/delete: the local LWW apply overlapped with plain
    SET/DELETE peer frames, so hinted handoff and anti-entropy
    converge replicas with no new peer verbs.  A quorum timeout HERE
    leaves the op ambiguous to the client (decided but unacked), the
    same contract as a timed-out plain set — clients resolve by
    re-reading.  Unlike a plain set, the remote ack count is
    ENFORCED: the fan-out resolves with whatever acks it got when
    replicas run out, and acking a conditional write held by the
    decider alone would let a later decider (after this node dies)
    rebuild the chain from a state that never saw it."""

    async def local_write():
        if not await col.tree.set_with_timestamp(
            key, value, decided_ts, stale_abort=True
        ):
            await my_shard.apply_if_newer(
                col.tree, key, value, decided_ts
            )

    budget = max(
        0.001, deadline - asyncio.get_event_loop().time()
    )
    if number_of_nodes > 0:
        peer_deadline = _wall_deadline_ms(request, timeout_ms)
        peer_qos = _qos_for_peers(request)
        remote_request = (
            ShardRequest.delete(
                collection_name, key, decided_ts,
                deadline_ms=peer_deadline,
                trace_id=_trace_id_for_peers(ctx),
                qos=peer_qos,
            )
            if is_delete
            else ShardRequest.set(
                collection_name, key, value, decided_ts,
                deadline_ms=peer_deadline,
                trace_id=_trace_id_for_peers(ctx),
                qos=peer_qos,
            )
        )
        expected = (
            ShardResponse.DELETE if is_delete else ShardResponse.SET
        )
        need_remote = min(consistency - 1, number_of_nodes)
        remote = my_shard.send_request_to_replicas(
            remote_request,
            need_remote,
            number_of_nodes,
            expected,
            op_status=op_status,
            key_hash=hash_bytes(key),
        )
        try:
            _local, acks = await asyncio.wait_for(
                asyncio.gather(local_write(), remote), budget
            )
            if len(acks) < need_remote:
                raise asyncio.TimeoutError(
                    f"{opname}: {len(acks)}/{need_remote} "
                    "replica acks"
                )
        except asyncio.TimeoutError as e:
            # POST-decide failure: always a plain Timeout, never the
            # richer _quorum_error kinds.  Clients key retry safety
            # off the kind — Overloaded/PeerDead/not-owned are only
            # ever raised BEFORE a decide (safe to replay), Timeout
            # after a conditional op means decided-but-unacked: the
            # client must surface ambiguity, not blindly replay
            # expectations its own (possibly applied) decide already
            # invalidated.
            raise Timeout(opname) from e
        finally:
            if ctx is not None:
                ctx.mark("quorum")
    else:
        try:
            await asyncio.wait_for(local_write(), budget)
        except asyncio.TimeoutError as e:
            raise Timeout(opname) from e
        finally:
            if ctx is not None:
                ctx.mark("local")


async def _handle_atomic_batch(
    my_shard: MyShard, request: dict
) -> bytes:
    ctx = trace_mod.current()
    collection_name = _extract(request, "collection")
    ops = _extract(request, "ops")
    if not isinstance(ops, (list, tuple)) or not ops:
        raise BadFieldType("ops")
    if len(ops) > ATOMIC_BATCH_MAX_OPS:
        raise BadFieldType(
            f"ops: atomic batch above {ATOMIC_BATCH_MAX_OPS}"
        )
    timeout_ms = request.get("timeout") or DEFAULT_SET_TIMEOUT_MS
    replica_index = request.get("replica_index") or 0
    col = my_shard.get_collection(collection_name)
    _check_membership_epoch(my_shard, request)
    rf = col.replication_factor
    consistency = request.get("consistency")
    if not isinstance(consistency, int):
        consistency = rf
    consistency = min(consistency, rf)
    number_of_nodes = rf - replica_index - 1

    parsed: list = []  # (key_bytes, value_bytes, op_map)
    for i, op in enumerate(ops):
        if not isinstance(op, dict):
            raise BadFieldType("ops")
        if i == 0:
            # Ownership is anchored on ops[0] — the key the client
            # routed the whole batch by.
            key = extract_key(my_shard, op, replica_index)
        else:
            # The other keys are validated by the arc-span check
            # below; an individual owns_key refusal here would turn
            # an unfixable key-choice error into a retryable
            # not-owned, and the client would resync forever.
            key = _encode_field(_extract(op, "key"))
        if op.get("delete"):
            value = TOMBSTONE
        elif "value" in op:
            value = _encode_field(op["value"])
        else:
            raise MissingField("value")
        parsed.append((key, value, op))
    # The commit unit is ONE ring arc: every key must resolve to the
    # same replica set (under vnodes, keys on different arcs fan to
    # different nodes — a spanning "atomic" batch would be two
    # independent commits wearing one name).  Refused as a client
    # error, not a conflict: no retry can fix the key choice.
    groups = _group_keyed_by_replica_set(
        my_shard,
        [(i, key) for i, (key, _v, _op) in enumerate(parsed)],
        number_of_nodes,
    )
    # Downstream-connection groups alone can collapse two distinct
    # arcs (walks (self, X) and (X, self) both fan to just X from
    # here) — those have DIFFERENT deciders, so also require every
    # key's walk prefix before this node to agree.
    walk_prefixes = {
        tuple(my_shard.preceding_replica_nodes(hash_bytes(key)))
        for key, _v, _op in parsed
    }
    if len(groups) > 1 or len(walk_prefixes) > 1:
        raise BadFieldType(
            "ops: atomic batch keys span multiple ring arcs"
        )
    anchor = groups[0][1]
    _atomic_decider_gate(my_shard, anchor, replica_index)
    deadline = asyncio.get_event_loop().time() + timeout_ms / 1000
    op_status: dict = {}
    if ctx is not None:
        ctx.mark("prep")
    keys = [key for key, _v, _op in parsed]
    async with my_shard.atomic_lock(collection_name, anchor):
        _check_membership_epoch(my_shard, request)
        local = col.tree.multi_get(
            keys, suspect_guard=consistency == 1
        )
        budget = max(
            0.001, deadline - asyncio.get_event_loop().time()
        )
        aligned: list = []
        live = _live_arc_peers(my_shard, number_of_nodes, anchor)
        try:
            if live > 0:
                # Same full-live-arc read discipline as single-key
                # CAS: every walk peer not marked Dead must answer
                # (with a well-formed row list), else the whole batch
                # refuses retryably — conditions evaluated against a
                # partial view could approve an op a missed replica
                # already superseded.
                remote = my_shard.send_request_to_replicas(
                    ShardRequest.multi_get(
                        collection_name,
                        keys,
                        deadline_ms=_wall_deadline_ms(
                            request, timeout_ms
                        ),
                        trace_id=_trace_id_for_peers(ctx),
                        qos=_qos_for_peers(request),
                    ),
                    live,
                    number_of_nodes,
                    ShardResponse.MULTI_GET,
                    op_status=op_status,
                    key_hash=anchor,
                )
                local_map, replica_lists = await asyncio.wait_for(
                    asyncio.gather(local, remote), budget
                )
                aligned = [
                    r
                    for r in replica_lists
                    if isinstance(r, (list, tuple))
                    and len(r) == len(keys)
                ]
                if len(aligned) < live:
                    raise asyncio.TimeoutError(
                        "atomic batch read: live replica did "
                        "not answer"
                    )
            else:
                local_map = await asyncio.wait_for(local, budget)
        except asyncio.TimeoutError as e:
            raise _quorum_error(
                my_shard, "atomic_batch", op_status
            ) from e
        if ctx is not None:
            ctx.mark("read")
        # Evaluate EVERY condition against the merged view before
        # touching anything: the batch commits or refuses whole.
        max_ts = 0
        for j, (key, _value, op) in enumerate(parsed):
            entries = []
            lv = local_map.get(key)
            if lv is not None:
                entries.append((bytes(lv[0]), lv[1]))
            for r in aligned:
                v = r[j]
                if v is not None:
                    entries.append((bytes(v[0]), v[1]))
            current = (
                max(entries, key=lambda e: e[1])
                if entries
                else None
            )
            if current is not None:
                max_ts = max(max_ts, current[1])
            detail = _cas_mismatch(op, current, require=False)
            if detail is not None:
                my_shard.batches_refused += 1
                raise CasConflict(
                    f"atomic_batch op {j} on {key!r}: {detail}"
                )
        decided_ts = max(now_nanos(), max_ts + 1)
        entries = [
            (key, value, decided_ts)
            for key, value, _op in parsed
        ]

        async def local_batch():
            # One memtable set_batch application, one WAL
            # append_batch group-commit ticket per chunk — the same
            # commit unit the plain multi_set path rides.
            rejected = await col.tree.set_batch_with_timestamp(
                entries, stale_abort=True
            )
            for k, v, ts in rejected:
                await my_shard.apply_if_newer(col.tree, k, v, ts)

        budget = max(
            0.001, deadline - asyncio.get_event_loop().time()
        )
        try:
            if number_of_nodes > 0:
                # Enforced ack floor, like _replicate_decided: the
                # fan-out resolves with whatever it got, and a batch
                # durable only on the decider is invisible to the
                # next decider's full-live-arc read once this node
                # dies.
                need_remote = min(consistency - 1, number_of_nodes)
                remote = my_shard.send_request_to_replicas(
                    ShardRequest.multi_set(
                        collection_name,
                        [[k, v, decided_ts] for k, v, _t in entries],
                        deadline_ms=_wall_deadline_ms(
                            request, timeout_ms
                        ),
                        trace_id=_trace_id_for_peers(ctx),
                        qos=_qos_for_peers(request),
                    ),
                    need_remote,
                    number_of_nodes,
                    ShardResponse.MULTI_SET,
                    op_status=op_status,
                    key_hash=anchor,
                )
                _local, acks = await asyncio.wait_for(
                    asyncio.gather(local_batch(), remote), budget
                )
                if len(acks) < need_remote:
                    raise asyncio.TimeoutError(
                        f"atomic_batch: {len(acks)}/{need_remote}"
                        " replica acks"
                    )
            else:
                await asyncio.wait_for(local_batch(), budget)
        except asyncio.TimeoutError as e:
            # POST-decide: plain Timeout only (decided but unacked)
            # — see _replicate_decided for the retry-safety contract.
            raise Timeout("atomic_batch") from e
        finally:
            if ctx is not None:
                ctx.mark(
                    "quorum" if number_of_nodes > 0 else "local"
                )
    my_shard.batches_committed += 1
    return msgpack_codec.packb(
        {"ts": decided_ts, "applied": len(parsed)}
    )


def _digest_reads_enabled() -> bool:
    import os

    return os.environ.get("DBEEL_NO_DIGEST_READS", "0") in ("", "0")


async def _digest_quorum_round(
    my_shard: MyShard,
    collection_name: str,
    col,
    key: bytes,
    local_value,
    consistency: int,
    number_of_nodes: int,
    timeout_s: float,
    op_status: Optional[dict] = None,
    deadline_ms: Optional[int] = None,
    trace_id: Optional[int] = None,
    qos: Optional[int] = None,
):
    """Digest-read round for an RF>1 get (beyond the reference, which
    ships RF full entries — db_server.rs:318-370): replicas answer
    (timestamp, murmur3_32(value)) digests; the coordinator predicts
    the exact response bytes from its LOCAL entry, so an agreeing
    replica costs a byte-compare — which the native fan-out engine
    (QuorumFan) performs in C — instead of a value payload + unpack.

    Returns True when the local entry is authoritative (every
    consulted replica agreed or was stale; stale ones got read
    repair spawned) — the caller answers from ``local_value``.
    Returns False when some replica holds a NEWER version (or a
    same-timestamp divergent value): the caller must run the
    full-entry round, which merges by max timestamp and read-repairs
    as before.  Raises Timeout like the full round would."""
    digest = pack_message(
        ShardRequest.get_digest(
            collection_name, key, deadline_ms=deadline_ms,
            trace_id=trace_id, qos=qos,
        )
    )
    framed = struct.pack("<I", len(digest)) + digest
    expected = pack_message(ShardResponse.get_digest(local_value))
    local_ts = None if local_value is None else local_value[1]
    if op_status is None:
        op_status = {}
    try:
        results = await asyncio.wait_for(
            my_shard.send_packed_to_replicas(
                framed,
                consistency - 1,
                number_of_nodes,
                expected,
                ShardResponse.GET_DIGEST,
                op_status=op_status,
                key_hash=hash_bytes(key),
            ),
            timeout_s,
        )
    except asyncio.TimeoutError as e:
        raise _quorum_error(my_shard, "get", op_status) from e
    newer = False
    stale = 0
    # Lazy, computed at most once: only needed when a ts-equal
    # digest arrives UNPACKED (traced frames piggyback, so their
    # agreement misses the byte-compare).
    local_hash = None
    for r in results:
        if r is None:
            continue  # byte-matched ack: replica agrees exactly
        if not r:  # []: replica has no entry
            if local_value is not None:
                stale += 1
            continue
        r_ts = r[0]
        if local_ts is None or r_ts > local_ts:
            newer = True  # replica holds a newer version
        elif r_ts < local_ts:
            stale += 1
        else:
            if len(r) > 1 and local_value is not None:
                if local_hash is None:
                    local_hash = murmur3_32(bytes(local_value[0]))
                if r[1] == local_hash:
                    # Same (ts, hash) but the bytes didn't compare
                    # equal — traced frames piggyback a replica
                    # span, so agreement arrives unpacked instead
                    # of as the predicted ack.
                    continue
            # Same timestamp, different value hash: divergence the
            # LWW model says cannot happen — resolve via the full
            # round rather than guessing.
            newer = True
    if newer:
        return False
    if (
        stale
        and local_value is not None
        and my_shard.allow_read_repair()
    ):
        my_shard.spawn(
            _read_repair(
                my_shard,
                collection_name,
                col,
                key,
                bytes(local_value[0]),
                local_value[1],
                number_of_nodes,
            )
        )
    return True


def _merge_quorum_get(
    my_shard: MyShard,
    collection_name: str,
    col,
    key: bytes,
    local_value,
    values,
    number_of_nodes: int,
) -> bytes:
    """The RF>1 get merge brain, shared by the Python punt path and
    the coordinator-assist path so the two can never diverge.
    Conflict resolution: max server timestamp wins
    (db_server.rs:353-363).  Read repair (improvement over the
    reference, which has none — SURVEY §5): any replica that answered
    with a missing or older entry gets the winning version
    re-propagated in the background — rate-capped through the
    shard's token bucket (beyond it the repair is skipped and
    counted; anti-entropy owns the tail); idempotent, since replicas
    keep the newest timestamp and duplicates collapse at compaction.
    Returns the winning value or raises KeyNotFound
    (tombstone/absence)."""
    entries = [(bytes(v[0]), v[1]) for v in values if v is not None]
    stale_acks = sum(1 for v in values if v is None)
    if local_value is not None:
        entries.append((bytes(local_value[0]), local_value[1]))
    else:
        stale_acks += 1
    if entries:
        win_value, win_ts = max(entries, key=lambda e: e[1])
        if (
            stale_acks or any(ts != win_ts for _v, ts in entries)
        ) and my_shard.allow_read_repair():
            my_shard.spawn(
                _read_repair(
                    my_shard,
                    collection_name,
                    col,
                    key,
                    win_value,
                    win_ts,
                    number_of_nodes,
                )
            )
        if win_value != TOMBSTONE:
            return win_value
    if not values and local_value is None and col.tree.reads_suspect:
        # Local-only evidence (consistency=1) on a tree with a
        # quarantine pending repair: the key may have lived in the
        # dropped table, so absence is unproven — answer with a
        # RETRYABLE error and let the client walk to a clean replica
        # instead of asserting KeyNotFound.
        raise CorruptedFile(
            "local miss is suspect: quarantined table pending repair"
        )
    raise KeyNotFound(repr(key))


async def _read_repair(
    my_shard: MyShard,
    collection_name: str,
    col,
    key: bytes,
    value: bytes,
    ts: int,
    number_of_nodes: int,
) -> None:
    from ..flow_events import FlowEvent

    # Spawned from inside a (possibly traced) get: the task copied
    # that op's context, and without this reset the repair's own
    # replica fan-out would absorb its SET acks into the GET's span
    # as phantom replicas.  Background work is never part of the
    # requesting op's latency.
    trace_mod.CURRENT.set(None)
    try:
        # Read-guarded local apply: win_ts came from layer-ordered
        # quorum reads and can be OLDER than a flushed version — a
        # blind insert would recreate the stale-shadow state
        # (PARITY.md deviation #9).  apply_if_newer is also the
        # correct read-repair semantic.
        await my_shard.apply_if_newer(col.tree, key, value, ts)
        if number_of_nodes > 0:
            await my_shard.send_request_to_replicas(
                ShardRequest.set(collection_name, key, value, ts),
                number_of_acks=0,
                number_of_nodes=number_of_nodes,
                expected_kind=ShardResponse.SET,
                key_hash=hash_bytes(key),
            )
        my_shard.flow.notify(FlowEvent.READ_REPAIR)
    except Exception as e:
        log.warning("read repair for %r failed: %s", key, e)


def _frame_response(buf: bytes) -> bytes:
    """Wire envelope: u32-LE length + payload (incl. type byte)."""
    return struct.pack("<I", len(buf)) + buf


def install_native_overload_responses(my_shard: MyShard) -> None:
    """Arm the native hard-overload/deadline answers (all-native
    serving path): the C client plane returns these COMPLETE wire
    frames for shed and dead-on-arrival data verbs, so a flood being
    shed never touches the interpreter it is flooding.  Packed here
    with the same encoder and message text as the interpreted shed
    path (_dispatch) and the dispatcher's deadline drop
    (handle_request), so the two paths answer byte-identically."""
    dp = my_shard.dataplane
    if dp is None:
        return

    def pack(msg: str) -> bytes:
        e = Overloaded(msg)
        return _frame_response(
            msgpack_codec.packb(e.to_wire())
            + bytes([RESPONSE_ERR])
        )

    dp.set_overload_responses(
        pack(f"shard {my_shard.shard_name} shedding load"),
        pack("client deadline expired before dispatch"),
    )


def _get_timeout_ms(req: dict) -> int:
    """Per-op timeout field, defaulted/sanitized (wire input)."""
    t = req.get("timeout")
    if isinstance(t, int) and t > 0:
        return t
    return DEFAULT_GET_TIMEOUT_MS


KEEPALIVE_IDLE_TIMEOUT_S = 300.0  # reap idle keepalive connections
_REAP_PERIOD_S = 30.0


# Expected replica acks for the packed-fan-out byte compare (the
# native shard plane and the Python handler both produce exactly
# these canonical frames).
_ACK_SET = pack_message(["response", ShardResponse.SET])
_ACK_DELETE = pack_message(["response", ShardResponse.DELETE])


async def _serve_coord(my_shard: MyShard, coord: tuple):
    """Finish one RF>1 client op the native coordinator assist
    already started: the local half is done and ``coord`` carries the
    packed peer frame — fan it out, await the quorum acks (merging
    get results by max timestamp), and answer the client.  Mirrors
    handle_request's set/delete/get branches (timeout => Timeout
    error; results beyond the ack count drain in the background with
    hinted handoff; stale get replicas trigger read repair)."""
    started = time.monotonic()
    (
        op,
        peer_frame,
        keepalive,
        flush_tree,
        consistency,
        timeout_ms,
        col_name,
        local_entry,
        key,
        error_resp,
        defer,
        deadline_ms,
    ) = coord
    if flush_tree is not None:
        my_shard.spawn(flush_tree.flush())
    if error_resp is not None:
        # Entry applied but the WAL append failed: the C side built
        # the error response ("Internal", taxonomy class "other");
        # no fan-out, no re-run.  Count + capture it like the
        # interpreted path's errors — a bad disk under the coord
        # assist must be visible in trace_dump too.
        log.error(
            "native coord %s on %r: wal append failed", op, col_name
        )
        my_shard.metrics.record_error(ERROR_CLASS_OTHER)
        my_shard.metrics.record_request(
            op, started, error_kind=ERROR_CLASS_OTHER
        )
        return error_resp, keepalive
    try:
        col = my_shard.collections.get(col_name)
        if col is None:  # unreachable: registration keeps slots in sync
            raise MissingField(f"collection slot for {col_name!r}")
        rf = col.replication_factor
        consistency = (
            rf if consistency is None else min(consistency, rf)
        )
        if op == "get":
            buf = await _finish_coord_get(
                my_shard,
                col_name,
                col,
                peer_frame,
                local_entry,
                key,
                consistency,
                timeout_ms or DEFAULT_GET_TIMEOUT_MS,
                deadline_ms,
            )
        else:
            is_delete = op == "delete"
            op_status: dict = {}
            try:
                fan_out = my_shard.send_packed_to_replicas(
                    peer_frame,
                    consistency - 1,
                    rf - 1,
                    _ACK_DELETE if is_delete else _ACK_SET,
                    ShardResponse.DELETE
                    if is_delete
                    else ShardResponse.SET,
                    op_status=op_status,
                    key_hash=(
                        hash_bytes(key) if key else None
                    ),
                )
                if defer is not None:
                    # wal-sync: the coordinator's own replica-0 write
                    # only counts once its fdatasync completes — wait
                    # for it alongside the remote acks, inside the
                    # same timeout window (db_server.rs:230-257's
                    # try_join shape).
                    syncer, ticket = defer
                    fan_out = asyncio.gather(
                        fan_out, syncer.wait(ticket)
                    )
                await asyncio.wait_for(
                    fan_out,
                    (timeout_ms or DEFAULT_SET_TIMEOUT_MS) / 1000,
                )
            except asyncio.TimeoutError as e:
                raise _quorum_error(my_shard, op, op_status) from e
            buf = msgpack_codec.packb("OK") + bytes([RESPONSE_BYTES])
    except Exception as e:  # defensive: never kill the connection task
        err_kind = classify_error(e)
        my_shard.metrics.record_error(err_kind)
        buf = _error_response(e)
        my_shard.metrics.record_request(
            op, started, error_kind=err_kind
        )
        _note_completion(my_shard, op, started, timeout_ms, None)
        return buf, keepalive
    my_shard.metrics.record_request(op, started)
    _note_completion(my_shard, op, started, timeout_ms, None)
    return buf, keepalive


async def _finish_coord_get(
    my_shard: MyShard,
    col_name: str,
    col,
    peer_frame: bytes,
    local_entry,
    key: bytes,
    consistency: int,
    timeout_ms: int,
    deadline_ms: Optional[int] = None,
) -> bytes:
    """Quorum-merge for a coordinator-assisted get: digest round
    first (replicas answer (ts, hash); agreement = C byte-compare in
    the fan-out engine), full-entry round only when a replica holds a
    newer version.  The full round combines replica results with the
    native local lookup by max server timestamp (db_server.rs:353-363),
    spawns read repair for stale replicas, and builds the client
    response.  `key` arrives from the C trailer — no peer-frame
    unpack on this path."""
    local_value = (
        None
        if local_entry is None or local_entry[0] == "miss"
        else local_entry
    )
    deadline = (
        asyncio.get_event_loop().time() + timeout_ms / 1000
    )
    op_status: dict = {}
    if _digest_reads_enabled():
        if await _digest_quorum_round(
            my_shard,
            col_name,
            col,
            key,
            local_value,
            consistency,
            col.replication_factor - 1,
            timeout_ms / 1000,
            op_status=op_status,
            deadline_ms=deadline_ms,
        ):
            if (
                local_value is None
                or bytes(local_value[0]) == TOMBSTONE
            ):
                raise KeyNotFound(repr(key))
            return bytes(local_value[0]) + bytes([RESPONSE_OK])
    remote = my_shard.send_packed_to_replicas(
        peer_frame,
        consistency - 1,
        col.replication_factor - 1,
        b"",  # no constant ack for gets: always unpack
        ShardResponse.GET,
        op_status=op_status,
        key_hash=hash_bytes(key) if key else None,
    )
    try:
        values = await asyncio.wait_for(
            remote,
            max(0.001, deadline - asyncio.get_event_loop().time()),
        )
    except asyncio.TimeoutError as e:
        raise _quorum_error(my_shard, "get", op_status) from e
    win_value = _merge_quorum_get(
        my_shard,
        col_name,
        col,
        key,
        local_value,
        values,
        col.replication_factor - 1,
    )
    return win_value + bytes([RESPONSE_OK])


async def _serve_frame(
    my_shard: MyShard,
    request_buf: bytes,
    req: Optional[dict] = None,
    ctx=None,
):
    """One request frame → (response bytes incl. trailing type byte,
    keepalive?).  ``req`` may carry the already-unpacked request map
    (the pipelined dispatcher parses frames once for batching);
    ``ctx`` an active trace span (sampled / client-stamped op, its
    t0 already set to the frame's arrival stamp) — installed as the
    task-tree current trace so the storage and fan-out layers can
    attribute their stages to it."""
    started = time.monotonic()
    op = "invalid"
    keepalive = False
    err_kind = None
    lane_cls = None
    token = (
        trace_mod.CURRENT.set(ctx) if ctx is not None else None
    )
    try:
        if req is None:
            try:
                req = msgpack_codec.unpackb(request_buf)
            except Exception as e:
                raise BadFieldType(f"document: {e}") from e
        if not isinstance(req, dict):
            raise BadFieldType("document")
        op = str(req.get("type", "invalid"))
        keepalive = bool(req.get("keepalive"))
        if op in _SHEDDABLE_OPS:
            # QoS lane accounting: this op occupies its class's
            # admission share until it completes; the lane's AIMD
            # window ticks on the release (end pairs with this begin
            # through the except-all below).
            lane_cls = qos_mod.request_class(req)
            my_shard.qos.begin(lane_cls)
        if ctx is not None:
            ctx.op = op
            col = req.get("collection")
            ctx.collection = col if isinstance(col, str) else None
            # Queue wait + unpack + the spawn hop to this task.
            ctx.mark("dispatch")
        payload = await handle_request(my_shard, req)
        if payload is None:
            buf = msgpack_codec.packb("OK") + bytes([RESPONSE_BYTES])
        else:
            buf = payload + bytes([RESPONSE_OK])
    except Exception as e:  # defensive: never kill the connection task
        err_kind = classify_error(e)
        my_shard.metrics.record_error(err_kind)
        buf = _error_response(e)
    finally:
        if token is not None:
            trace_mod.CURRENT.reset(token)
        if lane_cls is not None:
            my_shard.qos.end(lane_cls)
    if ctx is not None:
        # Merge + response pack since the last stage mark; the span
        # then covers arrival → response bytes ready (the coalesced
        # transport write happens on the next loop tick).
        ctx.mark("respond")
        my_shard.trace_recorder.record_span(ctx, err_kind)
    my_shard.metrics.record_request(
        op, started, error_kind=err_kind, traced=ctx is not None
    )
    if isinstance(req, dict):
        _note_completion(
            my_shard,
            op,
            started,
            req.get("timeout"),
            req.get("deadline_ms"),
        )
        if op in ("get", "multi_get"):
            # Tenant byte quota, read side: point reads are billed by
            # their RESPONSE bytes (the request frame the dispatcher
            # billed carries only collection + keys — a tenant
            # streaming large documents out must pay for what it
            # reads, like scan chunks do).  Debt semantics: the real
            # size is only known now, the NEXT op pays.  Writes stay
            # billed by request bytes at dispatch.  Every tenant-
            # stamped frame serves on THIS interpreted path (the C
            # planes punt tenant frames; tenant gets skip the
            # coalesced batch), so this point covers them all.
            my_shard.qos.charge_bytes(
                qos_mod.request_tenant(req),
                req.get("collection"),
                len(buf),
            )
    return buf, keepalive


def _error_response(e: Exception) -> bytes:
    """The error wire envelope, shared by the slow path and the
    coordinator fast path so the two can never diverge.  Must be
    called from an except block (log.exception)."""
    if isinstance(e, DbeelError):
        if not isinstance(e, KeyNotFound):
            log.error("error handling request: %r", e)
        return msgpack_codec.packb(e.to_wire()) + bytes(
            [RESPONSE_ERR]
        )
    log.exception("unexpected error handling request")
    return msgpack_codec.packb(
        ["Internal", str(e)]
    ) + bytes([RESPONSE_ERR])


class _DbProtocol(framed.FramedServerProtocol):
    """Raw-protocol serving path (the latency pass):
    frame parsing happens in data_received with zero per-request
    timeout/stream machinery — the per-request `asyncio.wait_for` +
    two `readexactly` awaits of the stream version cost ~40µs/op on
    this class of host.  Idle keepalive connections are reaped by one
    per-shard timer instead of a timeout per request.  Wire format
    unchanged: u16-LE request frames; u32-LE response length +
    payload + trailing type byte (db_server.rs:395-428).  Framing and
    backpressure live in FramedServerProtocol, shared with the peer
    plane.

    Pipelined execution: up to ``window`` queued frames run
    CONCURRENTLY per connection — a head-of-line quorum fan-out or
    parked WAL ack no longer serializes the frames behind it — while
    responses are RELEASED strictly in arrival order through the
    parked queue (the same mechanism that already ordered wal-sync
    deferred acks), so the wire contract is unchanged: the N-th
    response always answers the N-th request.  Native-fast frames
    found behind a slow frame are answered synchronously at dispatch
    and take an in-order parked slot instead of waiting for the slow
    task.

    Overload control: the fixed 32-frame window became a
    per-connection AIMD window driven by the shard's load governor —
    multiplicative decrease toward --overload-window-min while the
    backlog signals read soft-overloaded (at most one halving per
    window of completions), additive recovery to
    --pipeline-window-max once they clear.  Past the governor's HARD
    limit, new data ops are shed at dispatch with the retryable
    ``Overloaded`` error (admin/observability frames always serve);
    frames whose client-supplied deadline already expired in the
    queue are dropped the same way instead of computing dead
    responses."""

    HEADER = 2
    MAX_FRAME = None  # u16 length is its own bound
    # Consecutive queued RF=1 gets coalesce into ONE internal
    # multi_get task (shared memtable/sstable probe setup) — the
    # drain-level mirror of the client's multi_get frames.
    GET_BATCH_MAX = 64

    __slots__ = (
        "last_active",
        "inflight",
        "_slot_free",
        "_get_batch",
        "_get_batch_col",
        "_sampled_next",
        "_ticked_next",
    )

    def __init__(self, my_shard: MyShard) -> None:
        super().__init__(my_shard)
        self.last_active = 0.0
        self.inflight: set = set()
        self._slot_free: "asyncio.Event | None" = None
        self._get_batch: list = []  # (park entry, request map, t0)
        self._get_batch_col: Optional[str] = None
        # Tracing plane: _try_fast drew the sampling tick for the
        # frame it just declined — _dispatch (which pops that same
        # frame first: the fast path is only consulted on an empty
        # queue) routes a fired sample through the interpreted path
        # with a span, and skips its own tick for a frame whose tick
        # was already drawn (_ticked_next) so no frame counts twice.
        self._sampled_next = False
        self._ticked_next = False
        # AIMD pipeline window (overload plane): starts at the max —
        # an idle shard gives new connections full pipelining; the
        # governor shrinks it the moment backlog builds.
        self.window = float(my_shard.config.pipeline_window_max)

    def _registry(self) -> set:
        return self.shard.db_connections

    def _on_connect(self) -> None:
        self.last_active = asyncio.get_event_loop().time()

    def _on_disconnect(self) -> None:
        # Client connections: nothing received is owed once the peer
        # hangs up — stop serving, drop the backlog, and cancel any
        # in-flight pipelined work (a quorum fan-out for a client
        # that left must not keep running detached).
        self.closing = True
        if self.task is not None:
            self.task.cancel()
        for t in list(self.inflight):
            t.cancel()
        if self._slot_free is not None:
            self._slot_free.set()

    def _on_data(self) -> None:
        self.last_active = asyncio.get_event_loop().time()
        self.shard.scheduler.fg_mark()

    def _try_fast(self, frame: bytes) -> int:
        rec = self.shard.trace_recorder
        if rec.sampling:
            # One sampling tick per client frame, drawn HERE for
            # frames the fast path sees.  On every FAST_MISS path
            # this exact frame is the next _dispatch pop (the fast
            # path is only consulted on an empty queue), so the
            # flags map one-to-one; a frame the fast path HANDLES
            # spends its tick (cleared below) — _dispatch ticks only
            # frames that queued without passing through here, so no
            # frame ever draws two ticks.
            self._ticked_next = True
            if rec.tick():
                # The 1-in-N trace sample: decline the fast path so
                # the interpreted dispatcher serves it with real
                # stage marks.
                self._sampled_next = True
                return framed.FAST_MISS
        verdict = self._try_fast_inner(frame)
        if verdict != framed.FAST_MISS:
            self._ticked_next = False
        return verdict

    def _try_fast_inner(self, frame: bytes) -> int:
        # A handled frame is answered synchronously right here — no
        # task hop, no interpreter dispatch.  Only consulted by
        # data_received when nothing is queued or in flight, so the
        # direct transport.write cannot overtake a parked response.
        dp = self.shard.dataplane
        if self.shard.governor.any_should_shed() and (
            dp is None or not dp.shed_armed
        ):
            # Hard overload without the native shed gate (no .so, or
            # a stale one): the native plane must not keep feeding
            # the backlogged memtable/WAL behind the governor's back
            # — queue the frame so _dispatch parses it and sheds
            # data ops (admin frames still serve there).  With the
            # gate armed, the governor's level is already mirrored
            # into C and try_handle answers data verbs with the
            # prebuilt retryable Overloaded response — the flood
            # being shed never reaches the interpreter.
            return framed.FAST_MISS
        if dp is None:
            return framed.FAST_MISS
        started = time.monotonic()
        fast = dp.try_handle(frame)
        if fast is None:
            return framed.FAST_MISS
        resp, keepalive, flush_tree, op, defer, extra = fast
        if extra is not None:
            self._note_native_extra(op, extra)
        if flush_tree is not None:
            self.shard.spawn(flush_tree.flush())
        if defer is not None:
            # wal-sync group commit: the OK leaves once a completed
            # fdatasync covers this append.
            syncer, ticket = defer
            entry = self.park_response(resp, keepalive, op, started)
            syncer.park(ticket, lambda e=entry: self.finish_park(e))
            if not keepalive:
                # Reference semantics: one request per non-keepalive
                # connection — stop applying any already-buffered
                # frames NOW (the parked ack still goes out; the
                # flush closes the transport after writing it).
                self.closing = True
                return framed.FAST_CLOSE
            return framed.FAST_HANDLED
        if self.parked:
            # Earlier responses on this connection still await their
            # sync: queue behind them to preserve order.
            self.park_response(resp, keepalive, op, started, done=True)
            if not keepalive:
                self.closing = True
                return framed.FAST_CLOSE
            return framed.FAST_HANDLED
        self.shard.metrics.record_request(op, started)
        if not keepalive:
            self.closing = True
            self._write_out(resp, close=True)
            return framed.FAST_CLOSE
        self._write_out(resp)
        return framed.FAST_HANDLED

    def _note_native_extra(self, op: str, extra: tuple) -> None:
        """Mirror the governor/metrics bookkeeping the Python path
        would have performed for a frame the C side answered: sheds
        and deadline drops count exactly like their interpreted twins
        (the stats schema cannot depend on which path answered), and
        multi frames record their batch-size histogram point."""
        shard = self.shard
        kind = extra[0]
        if kind == "multi":
            shard.metrics.record_batch_size(extra[1])
            return
        if kind == "shed":
            shard.governor.record_shed(op)
        else:  # "deadline": expired client budget dropped in C
            shard.governor.deadline_drops += 1
        shard.native_drops_by_op[op] = (
            shard.native_drops_by_op.get(op, 0) + 1
        )
        shard.metrics.record_error(ERROR_CLASS_OVERLOAD)
        # Flight recorder: native drops are error completions like
        # their interpreted twins (latency ~0 — the drop IS the
        # point; the ring records that it happened and why).
        shard.trace_recorder.note_op(op, 0, ERROR_CLASS_OVERLOAD)

    # -- pipelined drain --------------------------------------------

    async def _drain(self) -> None:
        try:
            while self.pending and not self.closing:
                # The window-full wait is bypassed only at STANDARD
                # hard (the classic global shed regime, where every
                # popped data frame is cheaply refused) — NOT when
                # merely the batch class reads hard: standard/
                # interactive frames would then pop past the AIMD
                # window and be ADMITTED, bypassing exactly the
                # backpressure the window exists for.
                # Batch frames behind a full window wait for a slot
                # and shed at dispatch like any popped frame.
                if len(self.inflight) >= max(
                    1, int(self.window)
                ) and not self.shard.governor.should_shed():
                    # Window full: stop popping (pending grows and
                    # the PENDING_HIGH read-pause backpressures the
                    # socket) until a task completes.  Don't sit on
                    # coalesced gets while waiting.  Under HARD
                    # overload the wait is skipped: queued data ops
                    # must shed NOW with a cheap retryable error, not
                    # rot behind a full window until the client's
                    # timeout turns them into opaque Timeouts.
                    self._flush_get_batch()
                    if self._slot_free is None:
                        self._slot_free = asyncio.Event()
                    self._slot_free.clear()
                    try:
                        # Bounded wait: a completion wakes us
                        # instantly; the timeout re-samples the
                        # governor so a backlog crossing the HARD
                        # limit starts shedding the queue even while
                        # every window slot is stuck on slow work.
                        # Keep the poll SHORT even at LEVEL_OK: the
                        # wal-sync plane parks acks behind fdatasync
                        # tickets, and a full window must re-check
                        # promptly or durable-ack pipelines stall a
                        # poll period per refill.
                        await asyncio.wait_for(
                            self._slot_free.wait(), 0.05
                        )
                    except asyncio.TimeoutError:
                        pass
                    continue
                frame, arrived = self.pending.popleft()
                if (
                    self.paused_reading
                    and len(self.pending) < self.PENDING_LOW
                    and not self.transport.is_closing()
                ):
                    self.paused_reading = False
                    self.transport.resume_reading()
                if not self._dispatch(frame, arrived):
                    return
        except asyncio.CancelledError:
            # Shard shutdown (or client disconnect) cancelled us:
            # suppress the finally-respawn, or the orphan drain would
            # outlive the cancellation snapshot and keep writing to
            # trees the shard is about to close.
            self.closing = True
            raise
        finally:
            # Coalesced gets still owe their responses — even on the
            # closing path (earlier in-order responses gate a parked
            # non-keepalive close).
            self._flush_get_batch()
            self.task = None
            # Frames may have arrived while we were finishing.
            if self.pending and not self.closing:
                self.task = self.shard.spawn(self._drain())

    def _dispatch(self, frame: bytes, arrived: float = 0.0) -> bool:
        """Start serving one queued frame without awaiting its result:
        natively-handled frames answer synchronously into an in-order
        parked slot; consecutive RF=1 gets coalesce into one internal
        multi_get task; everything else reserves its slot and runs as
        a windowed concurrent task.  Returns False to stop draining
        this connection.  ``arrived``: frame receipt stamp (queue-wait
        attribution for traced ops)."""
        gov = self.shard.governor
        # Any class at its hard limit (batch trips first): routing
        # gate — per-class decisions happen below once the frame's
        # class is known (interpreted path) or in C (native gate,
        # which holds the per-class levels).
        shedding = gov.any_should_shed()
        rec = self.shard.trace_recorder
        sampled = self._sampled_next
        ticked = self._ticked_next or sampled
        self._sampled_next = False
        self._ticked_next = False
        if not sampled and not ticked and rec.sampling and rec.tick():
            # Frames that queued behind others never consulted
            # _try_fast — the 1-in-N sample is drawn here instead
            # (frames _try_fast declined already drew theirs).
            sampled = True
        dp = self.shard.dataplane
        if sampled:
            # Sampled frame: the interpreted path end to end, so the
            # span gets real stage marks and the peer frames carry
            # the trace id.  1-in-N by construction — the slower path
            # for sampled ops IS the design.
            dp = None
        if shedding and (dp is None or not dp.shed_armed):
            # Hard overload without the native shed gate: only the
            # interpreted shed branch below may answer data ops.
            dp = None
        if dp is not None and (
            (
                self.writable.is_set()
                and len(self.parked) <= self.PENDING_HIGH
            )
            # Shedding with the gate armed bypasses the writability/
            # parked-depth bounds: every parseable data verb comes
            # back as the prebuilt tiny Overloaded frame, terminal
            # and parked in order like any response — the interpreted
            # branch would park the SAME bytes at ~30x the cost, and
            # memory stays bounded by the pending-queue watermark
            # either way.  Real (non-shed) serving keeps the bounds.
            or (shedding and dp.shed_armed)
        ):
            # Queued-frame native fast path: a cheap memtable get
            # behind a slow quorum op is answered NOW; the parked
            # slot keeps its response in arrival order.  Under hard
            # overload this is the native shed gate: data verbs come
            # back as prebuilt Overloaded responses.
            started = time.monotonic()
            fast = dp.try_handle(frame)
            if fast is not None:
                resp, keepalive, flush_tree, op, defer, extra = fast
                if extra is not None:
                    self._note_native_extra(op, extra)
                if flush_tree is not None:
                    self.shard.spawn(flush_tree.flush())
                if defer is not None:
                    syncer, ticket = defer
                    entry = self.park_response(
                        resp, keepalive, op, started
                    )
                    syncer.park(
                        ticket, lambda e=entry: self.finish_park(e)
                    )
                else:
                    self.park_response(
                        resp, keepalive, op, started, done=True
                    )
                if not keepalive:
                    self.closing = True
                    return False
                return True
        # Coordinator assist runs AT DISPATCH (synchronous C call):
        # the local write applies in frame-arrival order, so two
        # pipelined writes to one key keep their server-timestamp
        # order; only the fan-out/quorum wait runs concurrently.
        # Never while shedding — a frame the shed gate punted (admin,
        # exotic shape) must not sneak a data op past admission via
        # the assist; the interpreted branch below sheds it.
        coord = (
            dp.try_handle_coord(frame)
            if dp is not None and not shedding
            else None
        )
        req = None
        keepalive = True
        ctx = None
        if coord is not None:
            keepalive = bool(coord[2])
        else:
            try:
                req = msgpack_codec.unpackb(frame)
            except Exception:
                req = None  # _serve_frame re-raises the wire error
            keepalive = isinstance(req, dict) and bool(
                req.get("keepalive")
            )
            tid = (
                _client_trace_id(req)
                if isinstance(req, dict)
                else None
            )
            if tid is not None or sampled:
                # Span for this op: client-stamped ids force one;
                # server sampling assigns one.  t0 = frame arrival,
                # so queue wait is the first attributed stage.
                ctx = trace_mod.TraceCtx(
                    tid
                    if tid is not None
                    else trace_mod.new_trace_id(),
                    t0=arrived or time.monotonic(),
                    client_stamped=tid is not None,
                )
                ctx.mark("queue")
            refusal = None
            if (
                isinstance(req, dict)
                and req.get("type") in _SHEDDABLE_OPS
            ):
                # QoS admission (class-aware shed + tenant quota):
                # per-class hard limits and lane windows shed with
                # the retryable Overloaded; an exhausted tenant
                # bucket refuses with the retryable QuotaExceeded.
                # Cheap (dict lookups + int compares) and evaluated
                # for EVERY interpreted data op — a batch flood sheds
                # here while standard/interactive frames keep
                # serving.
                qp = self.shard.qos
                cls = qos_mod.request_class(req)
                if qp.should_shed(cls):
                    refusal = qp.shed_error(cls)
                    gov.record_shed(str(req.get("type")))
                    gov.python_sheds += 1
                else:
                    try:
                        ops_field = req.get("ops")
                        qp.charge_ops(
                            qos_mod.request_tenant(req),
                            req.get("collection"),
                            len(ops_field)
                            if isinstance(ops_field, (list, tuple))
                            else 1,
                        )
                        # Byte quota meters REQUEST bytes for WRITES
                        # (the frame carries the encoded key and
                        # value).  Reads are billed by their RESPONSE
                        # bytes in _serve_frame — charging their tiny
                        # request frame here too would double-bill
                        # them against the documented contract.
                        # Streamed chunk bytes are charged by the
                        # scan plane.
                        if req.get("type") not in (
                            "get",
                            "multi_get",
                        ):
                            qp.charge_bytes(
                                qos_mod.request_tenant(req),
                                req.get("collection"),
                                len(frame),
                            )
                    except DbeelError as e:  # QuotaExceeded
                        refusal = e
            if refusal is not None:
                # Hard-limit admission: answer a cheap retryable
                # error NOW instead of adding this op to the backlog
                # that made the shard overloaded (or letting a
                # tenant overdraft its bucket).  The error frame
                # takes an in-order parked slot like any response;
                # non-keepalive semantics are preserved.  With the
                # native shed gate armed only frames the C parser
                # punted land here — python_sheds measures exactly
                # that residue (the bench's zero-Python-dispatch
                # acceptance counter).
                op = str(req.get("type"))
                err = refusal
                err_kind = classify_error(err)
                self.shard.metrics.record_error(err_kind)
                # Flight recorder: sheds ARE the interesting tail —
                # always captured (full span when sampled).
                if ctx is not None:
                    ctx.op = op
                    ctx.mark("shed")
                    rec.record_span(ctx, err_kind)
                else:
                    rec.note_op(
                        op,
                        int(
                            (
                                time.monotonic()
                                - (arrived or time.monotonic())
                            )
                            * 1e6
                        ),
                        err_kind,
                    )
                self.park_response(
                    _frame_response(_error_response(err)),
                    keepalive,
                    op,
                    time.monotonic(),
                    done=True,
                )
                if not keepalive:
                    self.closing = True
                    return False
                return True
            if (
                keepalive
                and ctx is None
                and isinstance(req, dict)
                and self._batchable_get(req)
            ):
                # (Traced gets skip coalescing: the span belongs to
                # ONE frame, and sampling is rare enough that losing
                # one batch slot is noise.)
                if (
                    self._get_batch
                    and self._get_batch_col != req.get("collection")
                ):
                    self._flush_get_batch()
                self._get_batch_col = req.get("collection")
                self._get_batch.append(
                    (
                        self.park_response(None, True),
                        req,
                        time.monotonic(),
                    )
                )
                if len(self._get_batch) >= self.GET_BATCH_MAX:
                    self._flush_get_batch()
                return True
        entry = self.park_response(None, True)
        self.shard.metrics.record_pipeline_depth(
            len(self.inflight) + 1
        )
        task = self.shard.spawn(
            self._serve_pipelined(frame, coord, entry, req, ctx)
        )
        self.inflight.add(task)
        task.add_done_callback(self._pipelined_done)
        if not keepalive:
            # Reference semantics: one request per non-keepalive
            # connection — frames already buffered behind it are
            # DROPPED, never executed (the previous sequential drain
            # guaranteed this; the concurrent drain must too).  The
            # in-order parked release still closes the transport
            # right after this frame's own response.
            self.closing = True
            return False
        return True

    def _batchable_get(self, req: dict) -> bool:
        """Eligible for drain-level get coalescing: a keepalive get
        on an RF=1 collection (quorum gets keep their per-frame
        fan-out brain).  Dead-on-arrival gets (expired client
        deadline) are NOT batchable — they fall through to
        handle_request, whose dispatch check drops them with the
        counted retryable error; the batch path used to serve them,
        silently diverging from both the native plane and the
        unbatched path."""
        if req.get("type") != "get" or not req.get("keepalive"):
            return False
        if "tenant" in req or "qos" in req:
            # QoS-stamped gets keep their own frame task so the lane
            # inflight gauge and tenant byte accounting stay exact
            # (the coalesced batch path has no per-frame class walk).
            return False
        deadline_ms = req.get("deadline_ms")
        if (
            isinstance(deadline_ms, int)
            and deadline_ms > 0
            and time.time() * 1000.0 > deadline_ms
        ):
            return False
        col = self.shard.collections.get(req.get("collection"))
        return col is not None and col.replication_factor == 1

    def _flush_get_batch(self) -> None:
        if not self._get_batch:
            return
        items, self._get_batch = self._get_batch, []
        col_name, self._get_batch_col = self._get_batch_col, None
        self.shard.metrics.record_pipeline_depth(
            len(self.inflight) + 1
        )
        task = self.shard.spawn(
            self._serve_get_batch(col_name, items)
        )
        self.inflight.add(task)
        task.add_done_callback(self._pipelined_done)

    async def _serve_get_batch(
        self, col_name: str, items: list
    ) -> None:
        """Serve a run of coalesced pipelined gets with ONE
        LSMTree.multi_get (shared probe setup); each frame still gets
        its own in-order response and its own error surface
        (ownership, absence)."""
        my_shard = self.shard
        my_shard.metrics.record_batch_size(len(items))
        keyed: list = []
        try:
            col = my_shard.get_collection(col_name)
        except DbeelError as e:
            kind = classify_error(e)
            for entry, _req, started in items:
                my_shard.metrics.record_error(kind)
                my_shard.metrics.record_request(
                    "get", started, error_kind=kind
                )
                self.finish_park(
                    entry, _frame_response(_error_response(e))
                )
            return
        # Conservative shared bound: the smallest per-op timeout in
        # the batch — a frame must never wait LONGER because it
        # happened to coalesce with others.
        timeout_ms = min(
            _get_timeout_ms(req) for _entry, req, _started in items
        )
        for entry, req, started in items:
            try:
                key = extract_key(
                    my_shard, req, req.get("replica_index") or 0
                )
                keyed.append((entry, key, started))
            except DbeelError as e:
                kind = classify_error(e)
                my_shard.metrics.record_error(kind)
                my_shard.metrics.record_request(
                    "get", started, error_kind=kind
                )
                self.finish_park(
                    entry, _frame_response(_error_response(e))
                )
        if not keyed:
            return
        err: Optional[DbeelError] = None
        found: dict = {}
        try:
            found = await asyncio.wait_for(
                col.tree.multi_get(
                    [k for _e, k, _s in keyed], suspect_guard=True
                ),
                timeout_ms / 1000,
            )
        except asyncio.TimeoutError:
            err = Timeout("get")
        except Exception as e:  # defensive: entries must resolve
            err = DbeelError(f"Internal: {e}")
        for entry, key, started in keyed:
            hit = found.get(key)
            kind = None
            if err is not None:
                kind = classify_error(err)
                my_shard.metrics.record_error(kind)
                buf = _error_response(err)
            elif hit is None and col.tree.reads_suspect:
                # Quarantine pending repair: a miss is unproven —
                # answer retryably so the client walks replicas.
                bad = CorruptedFile(
                    "local miss is suspect: quarantined table "
                    "pending repair"
                )
                kind = classify_error(bad)
                my_shard.metrics.record_error(kind)
                buf = _error_response(bad)
            elif hit is None or bytes(hit[0]) == TOMBSTONE:
                buf = _error_response(KeyNotFound(repr(key)))
            else:
                buf = bytes(hit[0]) + bytes([RESPONSE_OK])
            my_shard.metrics.record_request(
                "get", started, error_kind=kind
            )
            self.finish_park(entry, _frame_response(buf))

    def _pipelined_done(self, task) -> None:
        self.inflight.discard(task)
        # One completed pipelined unit = one AIMD sample: shrink
        # while the governor reads backlog, recover toward the max
        # once it clears.
        cfg = self.shard.config
        self.aimd_tick(
            float(max(1, cfg.overload_window_min)),
            float(cfg.pipeline_window_max),
        )
        if self._slot_free is not None:
            self._slot_free.set()

    async def _serve_pipelined(
        self,
        frame: bytes,
        coord,
        entry,
        req: Optional[dict] = None,
        ctx=None,
    ) -> None:
        if coord is not None:
            buf, keepalive = await _serve_coord(self.shard, coord)
        else:
            buf, keepalive = await _serve_frame(
                self.shard, frame, req, ctx
            )
        if not keepalive:
            # Reference behavior: one request per connection unless
            # the client opted into keepalive — stop consuming
            # buffered frames now; the in-order parked release
            # closes the transport right after this response.
            self.closing = True
        entry[2] = keepalive
        self.finish_park(entry, _frame_response(buf))

    async def _serve_one(self, frame: bytes) -> bool:
        raise NotImplementedError  # _drain dispatches directly


async def reap_idle_db_connections(my_shard: MyShard) -> None:
    """Single per-shard reaper replacing per-request read timeouts:
    pooled clients that never close() can't pin fds forever."""
    while True:
        await asyncio.sleep(_REAP_PERIOD_S)
        now = asyncio.get_event_loop().time()
        for conn in list(my_shard.db_connections):
            if (
                now - conn.last_active > KEEPALIVE_IDLE_TIMEOUT_S
                and conn.task is None
                and not conn.inflight
                and conn.transport is not None
            ):
                conn.transport.close()


async def bind_db_server(my_shard: MyShard) -> asyncio.Server:
    port = my_shard.config.db_port(my_shard.id)
    server = await asyncio.get_event_loop().create_server(
        lambda: _DbProtocol(my_shard),
        my_shard.config.ip,
        port,
    )
    log.info("listening for clients on %s:%d", my_shard.config.ip, port)
    return server


async def run_db_server(
    my_shard: MyShard, server: Optional[asyncio.Server] = None
) -> None:
    if server is None:
        server = await bind_db_server(my_shard)
    async with server:
        await server.serve_forever()
