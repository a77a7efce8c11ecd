"""Shard message schema — the L4 wire vocabulary.

Role parity with reference src/messages.rs:11-121 and gossip.rs:
9-40: ``ShardMessage = Event | Request | Response`` plus NodeMetadata /
ClusterMetadata, and the four gossip events.  The reference serializes
with bincode; we use msgpack arrays with a leading tag string — self-
describing, language-neutral, and the natural fit for a msgpack document
database.  NodeMetadata keeps the reference's field order so the public
``get_cluster_metadata`` response matches what rmp-serde produces for
the reference's client (dbeel_client/src/lib.rs:85-152).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

from ..errors import DbeelError, ProtocolError, from_wire
from ..utils import msgpack_codec
from ..utils.murmur import murmur3_32

# create_collection frames (peer request and gossip event) carry this
# many optional trailing slots after the base arity: the tenant-quota
# override map, then the secondary-index field list
#.  A None quota placeholder keeps positions fixed when
# only the index is declared.  Pinned by analysis/wire_parity against
# both encoders' append counts and both shard.py handlers' slot reads.
DDL_TAIL_SLOTS = 2

# NodeMetadata carries this many optional trailing slots after its
# 6-element base arity: the per-shard vnode token lists,
# aligned with ``ids``.  Appended only when some shard owns more than
# one token, so a --vnodes 1 node's wire form stays byte-identical to
# the legacy dialect and old peers keep parsing it.  Pinned by
# analysis/wire_parity against to_wire's append count and the C
# client's slot index.
NODE_WIRE_TAIL_SLOTS = 1

# ClusterMetadata carries this many optional trailing slots after its
# 2-element base arity: the serving node's membership epoch —
# clients stamp it on writes so a migration can fence
# stale coordinators retryably.  Old arity decodes as epoch 0
# (= never fenced).
CLUSTER_WIRE_TAIL_SLOTS = 1


@dataclass(frozen=True)
class NodeMetadata:
    name: str
    ip: str
    remote_shard_base_port: int
    ids: List[int]
    gossip_port: int
    db_port: int
    # Vnode dialect: per-shard ring token lists aligned
    # with ``ids``.  None means the legacy single-token-per-shard
    # derivation (hash_string(f"{name}-{sid}")) — what every pre-vnode
    # peer implies by omitting the element.
    tokens: Optional[List[List[int]]] = None

    def to_wire(self) -> list:
        w = [
            self.name,
            self.ip,
            self.remote_shard_base_port,
            list(self.ids),
            self.gossip_port,
            self.db_port,
        ]
        # Optional trailing slot (NODE_WIRE_TAIL_SLOTS): appended only
        # when some shard owns more than one token, so single-token
        # nodes stay byte-identical to the legacy dialect.
        if self.tokens is not None and any(
            len(t) != 1 for t in self.tokens
        ):
            w.append([list(t) for t in self.tokens])
        return w

    @classmethod
    def from_wire(cls, w: list) -> "NodeMetadata":
        tokens = None
        if len(w) > 6 and w[6] is not None:
            tokens = [list(t) for t in w[6]]
        return cls(w[0], w[1], w[2], list(w[3]), w[4], w[5], tokens)

    def __hash__(self):
        return hash(self.name)


@dataclass
class ClusterMetadata:
    nodes: List[NodeMetadata]
    collections: List[Tuple[str, int]]  # (name, replication_factor)
    # Membership epoch of the serving node: optional
    # trailing slot (CLUSTER_WIRE_TAIL_SLOTS); 0 from old peers.
    epoch: int = 0

    def to_wire(self) -> list:
        w = [
            [n.to_wire() for n in self.nodes],
            [[name, rf] for name, rf in self.collections],
        ]
        if self.epoch:
            w.append(self.epoch)
        return w

    @classmethod
    def from_wire(cls, w: list) -> "ClusterMetadata":
        return cls(
            [NodeMetadata.from_wire(n) for n in w[0]],
            [(c[0], c[1]) for c in w[1]],
            w[2] if len(w) > 2 and w[2] is not None else 0,
        )


# ---------------------------------------------------------------------
# QoS wire vocabulary (QoS plane).  Lives HERE — the wire
# module both sides already share — so clients can stamp classes
# without importing the server package (server/qos.py re-exports
# these for the policy machinery).  The `qos` client-frame field and
# the trailing peer-frame dialect element carry the class id.
# ---------------------------------------------------------------------

QOS_INTERACTIVE = 0
QOS_STANDARD = 1
QOS_BATCH = 2
NCLASSES = 3
QOS_CLASS_NAMES = ("interactive", "standard", "batch")
_QOS_NAME_TO_CLASS = {n: i for i, n in enumerate(QOS_CLASS_NAMES)}


def qos_class_of(value) -> int:
    """Resolve a wire/user class stamp to a class index.  Accepts the
    wire int, a class name string, or None; anything else (or out of
    range) is STANDARD — an unknown stamp must degrade to the default
    lane, never to an error or a privilege."""
    if isinstance(value, bool):
        return QOS_STANDARD
    if isinstance(value, int):
        return value if 0 <= value < NCLASSES else QOS_STANDARD
    if isinstance(value, str):
        return _QOS_NAME_TO_CLASS.get(value, QOS_STANDARD)
    return QOS_STANDARD


# ---------------------------------------------------------------------
# Events / Requests / Responses as tagged msgpack arrays.
# Timestamps travel as int64 nanoseconds.
# ---------------------------------------------------------------------


class ShardEvent:
    GOSSIP = "gossip"
    SET = "set"

    @staticmethod
    def gossip(gossip_event: list) -> list:
        return ["event", ShardEvent.GOSSIP, gossip_event]

    @staticmethod
    def set(collection: str, key: bytes, value: bytes, ts: int) -> list:
        return ["event", ShardEvent.SET, collection, key, value, ts]


class ShardRequest:
    PING = "ping"
    GET_METADATA = "get_metadata"
    GET_COLLECTIONS = "get_collections"
    CREATE_COLLECTION = "create_collection"
    DROP_COLLECTION = "drop_collection"
    SET = "set"
    DELETE = "delete"
    GET = "get"
    GET_DIGEST = "get_digest"
    MULTI_SET = "multi_set"
    MULTI_GET = "multi_get"
    RANGE_DIGEST = "range_digest"
    RANGE_PULL = "range_pull"
    RANGE_PUSH = "range_push"
    SCAN = "scan"
    WATCH_FEED = "watch_feed"
    REARM = "rearm"
    TELEMETRY_DIGEST = "telemetry_digest"

    @staticmethod
    def ping() -> list:
        return ["request", ShardRequest.PING]

    @staticmethod
    def telemetry_digest() -> list:
        """Intra-node telemetry aggregation: the node-managing
        shard collects each sibling shard's compact health digest
        every telemetry interval and folds them into the per-node
        digest it gossips."""
        return ["request", ShardRequest.TELEMETRY_DIGEST]

    @staticmethod
    def rearm() -> list:
        """Admin: exit sticky degraded read-only mode after disk
        replacement — the shard re-runs its free-space/WAL-append
        pre-checks and re-registers the native write plane, or
        answers an error frame while the disk is still bad."""
        return ["request", ShardRequest.REARM]

    @staticmethod
    def get_metadata() -> list:
        return ["request", ShardRequest.GET_METADATA]

    @staticmethod
    def get_collections() -> list:
        return ["request", ShardRequest.GET_COLLECTIONS]

    @staticmethod
    def create_collection(
        name: str, rf: int, quotas=None, index=None
    ) -> list:
        # Optional trailing elements: per-collection tenant-quota
        # overrides ({"ops_per_sec", "bytes_per_sec"}) then the
        # secondary-index field list.
        # Each appears only AFTER the previous slot (a None quota
        # placeholder keeps position 4 fixed when only the index is
        # set), so plain DDL keeps the quota-free arity
        # byte-for-byte; old receivers index from the front and
        # ignore the tail.
        frame = ["request", ShardRequest.CREATE_COLLECTION, name, rf]
        if quotas or index:
            frame.append(quotas if quotas else None)
        if index:
            frame.append(list(index))
        return frame

    @staticmethod
    def drop_collection(name: str) -> list:
        return ["request", ShardRequest.DROP_COLLECTION, name]

    # Data-op peer frames optionally carry trailing elements beyond
    # the base arity: (1) the coordinator's absolute wall-clock
    # deadline in ms (overload plane) — a replica drops expired
    # work with a retryable Overloaded error instead of computing a
    # dead response; (2) the trace id of a sampled op (tracing plane)
    # — a replica serving a traced frame piggybacks its own
    # stage summary on the response; (3) the QoS traffic-class id
    # (QoS plane) — replicas account the class so a bulk
    # load's replica writes show up in the batch lane cluster-wide.
    # Each element only ever appears AFTER the previous slot (0
    # placeholders keep earlier slots fixed; all planes treat
    # non-positive deadline/trace as absent), so the four dialects
    # are base / base+1 (deadline) / base+2 (+trace) / base+3
    # (+qos).  Old-dialect consumers index from the front and simply
    # ignore the tail; the native parsers accept base, base+1 and
    # base+3 (qos with the 0-trace placeholder), and punt any frame
    # with a live trace id to Python, which owns sampled frames.
    # The qos element is only appended for NON-STANDARD classes, so
    # default traffic keeps the untraced dialects byte-for-byte.

    @staticmethod
    def _with_deadline(
        frame: list, deadline_ms, trace_id=None, qos=None
    ) -> list:
        has_deadline = isinstance(deadline_ms, int) and deadline_ms > 0
        has_trace = isinstance(trace_id, int) and trace_id > 0
        if isinstance(qos, int) and 0 <= qos:
            frame.append(deadline_ms if has_deadline else 0)
            frame.append(trace_id if has_trace else 0)
            frame.append(qos)
        elif has_trace:
            frame.append(deadline_ms if has_deadline else 0)
            frame.append(trace_id)
        elif has_deadline:
            frame.append(deadline_ms)
        return frame

    @staticmethod
    def set(
        collection: str, key: bytes, value: bytes, ts: int,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        return ShardRequest._with_deadline(
            ["request", ShardRequest.SET, collection, key, value, ts],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def delete(
        collection: str, key: bytes, ts: int,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        return ShardRequest._with_deadline(
            ["request", ShardRequest.DELETE, collection, key, ts],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def get(
        collection: str, key: bytes,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        return ShardRequest._with_deadline(
            ["request", ShardRequest.GET, collection, key],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def get_digest(
        collection: str, key: bytes,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        """Digest read (quorum-get fast path, beyond the reference —
        db_server.rs:318-370 ships RF full entries): the replica
        answers (timestamp, murmur3_32(value)) instead of the value,
        so agreeing replicas cost a byte-compare, not a payload."""
        return ShardRequest._with_deadline(
            ["request", ShardRequest.GET_DIGEST, collection, key],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def multi_set(
        collection: str, entries: list,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        """Batched replica mutation: ``entries`` is
        [[key, value, ts], ...] (tombstone value = delete).  ONE
        frame and ONE ack per peer per client batch, instead of one
        round trip per sub-op — the replica applies each entry under
        the same watermark guard as a single SET."""
        return ShardRequest._with_deadline(
            ["request", ShardRequest.MULTI_SET, collection, entries],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def multi_get(
        collection: str, keys: list,
        deadline_ms: "int | None" = None,
        trace_id: "int | None" = None,
        qos: "int | None" = None,
    ) -> list:
        """Batched replica read: the response carries one entry (or
        nil) per key, aligned with ``keys``."""
        return ShardRequest._with_deadline(
            ["request", ShardRequest.MULTI_GET, collection, keys],
            deadline_ms,
            trace_id,
            qos,
        )

    @staticmethod
    def range_digest(
        collection: str, start: int, end: int, buckets: int = 1
    ) -> list:
        """Anti-entropy probe: order-independent digests of (key, ts)
        pairs whose key hash falls in the half-open wrap range
        [start, end), split into ``buckets`` equal hash sub-ranges
        (merkle-bucket style — one diverged key then syncs only its
        ~range/buckets slice, not the whole range)."""
        return [
            "request",
            ShardRequest.RANGE_DIGEST,
            collection,
            start,
            end,
            buckets,
        ]

    @staticmethod
    def range_pull(
        collection: str,
        start: int,
        end: int,
        start_after: Optional[bytes],
        limit: int,
        buckets: Optional[list] = None,
        nbuckets: int = 0,
    ) -> list:
        """Anti-entropy page fetch: up to ``limit`` (key, value, ts)
        triples in the range, keys > start_after.  With ``buckets``
        (+ ``nbuckets``), only entries whose hash falls in one of the
        listed sub-range buckets are returned."""
        return [
            "request",
            ShardRequest.RANGE_PULL,
            collection,
            start,
            end,
            start_after,
            limit,
            buckets,
            nbuckets,
        ]

    @staticmethod
    def scan(
        collection: str,
        start: int,
        end: int,
        start_after: Optional[bytes],
        prefix: Optional[bytes],
        limit: int,
        max_bytes: int,
        with_values: bool,
        spec: Optional[bytes] = None,
        qos: int = 2,
    ) -> list:
        """Streaming scan page (scan plane): up to ``limit``
        entries / ``max_bytes`` emitted bytes of [key, value, ts]
        triples whose hash falls in the half-open wrap range
        [start, end), keys strictly > ``start_after`` (and starting
        with ``prefix`` when given), ascending by key.  Tombstones ARE
        included (value = b"") — the coordinator's newest-wins merge
        needs them to suppress older live values on other replicas.
        ``with_values=False`` elides live values as nil (count /
        keys-only pushdown: values never cross the wire).  The
        response's trailing ``more`` flag tells the coordinator
        whether this replica's stream has entries beyond the page.

        ``spec`` (query compute plane) is a packed peer
        filter/aggregate spec (query.pack_peer_spec): the replica
        evaluates the predicate over its staged columns and pages by
        bytes SCANNED — entry shape then depends on the spec's mode
        (see query.py), and the response trailer carries
        cover/scanned/partial fields.  Arity is lint-pinned
        (shard._SCAN_PEER_ARITY, native kScanPeerArity).

        ``qos`` (QoS plane) is the scan's traffic-class id
        — replicas account the page in that lane (batch by default),
        so an analytics stream's replica-side work is visible in the
        batch lane cluster-wide."""
        return [
            "request",
            ShardRequest.SCAN,
            collection,
            start,
            end,
            start_after,
            prefix,
            limit,
            max_bytes,
            with_values,
            spec,
            qos,
        ]

    @staticmethod
    def watch_feed(
        collection: str,
        boot_epoch: int,
        after_seq: int,
        ranges: list,
        limit: int,
        max_bytes: int,
        spec: Optional[bytes] = None,
        qos: int = 2,
    ) -> list:
        """Watch-plane feed page: up to ``limit`` change
        events / ``max_bytes`` emitted bytes from the replica's
        in-memory change ring, events strictly AFTER ``after_seq`` of
        ring boot ``boot_epoch``, filtered to ``collection``, to key
        hashes inside the half-open wrap ``ranges`` ([[start, end),
        ...] — the coordinator partitions the ring's arcs across its
        chosen replicas so feeds never systematically overlap), and
        optionally to a packed filter ``spec`` evaluated replica-side
        (query compute plane dialect).  The response's status flag
        tells the coordinator whether the position is still on the
        ring (0) or fell off / predates this boot (1: catch up from
        durable state via the scan machinery, dup-flagged).

        ``qos`` is the subscriber's traffic-class id (batch by
        default — a million watchers must not starve point ops).
        Arity is lint-pinned (shard._WATCH_PEER_ARITY)."""
        return [
            "request",
            ShardRequest.WATCH_FEED,
            collection,
            boot_epoch,
            after_seq,
            ranges,
            limit,
            max_bytes,
            spec,
            qos,
        ]

    @staticmethod
    def range_push(collection: str, entries: list) -> list:
        """Anti-entropy batch apply: the receiver applies each
        (key, value, ts) ONLY when newer than its own newest for that
        key — unlike plain Set events, an older pushed entry can never
        shadow a newer value already flushed to the receiver's
        sstables."""
        return ["request", ShardRequest.RANGE_PUSH, collection, entries]


class ShardResponse:
    PONG = "pong"
    GET_METADATA = "get_metadata"
    GET_COLLECTIONS = "get_collections"
    CREATE_COLLECTION = "create_collection"
    DROP_COLLECTION = "drop_collection"
    SET = "set"
    DELETE = "delete"
    GET = "get"
    GET_DIGEST = "get_digest"
    MULTI_SET = "multi_set"
    MULTI_GET = "multi_get"
    RANGE_DIGEST = "range_digest"
    RANGE_PULL = "range_pull"
    RANGE_PUSH = "range_push"
    SCAN = "scan"
    WATCH_FEED = "watch_feed"
    REARM = "rearm"
    TELEMETRY_DIGEST = "telemetry_digest"
    ERROR = "error"

    @staticmethod
    def pong() -> list:
        return ["response", ShardResponse.PONG]

    @staticmethod
    def telemetry_digest(digest: dict) -> list:
        # One shard's compact health digest (telemetry plane).
        return ["response", ShardResponse.TELEMETRY_DIGEST, digest]

    @staticmethod
    def get_metadata(nodes: List[NodeMetadata]) -> list:
        return [
            "response",
            ShardResponse.GET_METADATA,
            [n.to_wire() for n in nodes],
        ]

    @staticmethod
    def get_collections(cols) -> list:
        # Entries are [name, rf], [name, rf, quotas] or [name, rf,
        # quotas|nil, index] — the optional third element carries
        # per-collection quota overrides, the
        # optional fourth the secondary-index field list (a
        # nil quota placeholder keeps position 2 fixed); old
        # receivers index [0]/[1] and ignore the tail.
        return [
            "response",
            ShardResponse.GET_COLLECTIONS,
            [list(c) for c in cols],
        ]

    @staticmethod
    def empty(kind: str) -> list:
        return ["response", kind]

    @staticmethod
    def get(entry: Optional[Tuple[bytes, int]]) -> list:
        # entry = (value_bytes, timestamp_ns) including tombstones.
        return [
            "response",
            ShardResponse.GET,
            list(entry) if entry is not None else None,
        ]

    @staticmethod
    def get_digest(entry: Optional[Tuple[bytes, int]]) -> list:
        """Digest of a replica's entry: [timestamp, murmur3_32(value)]
        — or [] for authoritative absence (NOT nil: a byte-matched
        ack surfaces as None at the coordinator, so absence needs a
        distinct unpacked shape).  The encoding must stay canonical
        msgpack (minimal ints): the coordinator predicts these exact
        bytes from its local entry and the fan-out engine
        byte-compares them in C."""
        if entry is None:
            return ["response", ShardResponse.GET_DIGEST, []]
        value, ts = entry
        return [
            "response",
            ShardResponse.GET_DIGEST,
            [ts, murmur3_32(bytes(value))],
        ]

    @staticmethod
    def multi_get(entries: list) -> list:
        # One [value, ts] (or None) per requested key, same order.
        return [
            "response",
            ShardResponse.MULTI_GET,
            [list(e) if e is not None else None for e in entries],
        ]

    @staticmethod
    def range_digest(counts: list, digests: list) -> list:
        # Per-bucket (count, digest) vectors, index = bucket id.
        return [
            "response",
            ShardResponse.RANGE_DIGEST,
            counts,
            digests,
        ]

    @staticmethod
    def range_pull(entries: list) -> list:
        # entries: [[key, value, ts], ...] sorted by key
        return ["response", ShardResponse.RANGE_PULL, entries]

    @staticmethod
    def scan(
        entries: list,
        more: bool,
        cover: "Optional[bytes]" = None,
        scanned_rows: int = 0,
        scanned_bytes: int = 0,
        agg=None,
    ) -> list:
        # One scan page: [[key, value|nil, ts], ...] ascending by
        # key; ``more`` = entries remain beyond the page's last key.
        # Filtered pages (query compute plane) append the
        # resume trailer: ``cover`` = last key SCANNED (the window
        # may match nothing), scanned rows/bytes (what the
        # coordinator bills against --scan-bytes-per-slice), and the
        # drop-mode partial aggregate state.  The base 4-element
        # prefix is unchanged, so a spec-less parser still reads it.
        return [
            "response",
            ShardResponse.SCAN,
            entries,
            more,
            cover,
            scanned_rows,
            scanned_bytes,
            agg,
        ]

    @staticmethod
    def watch_feed(
        events: list,
        boot_epoch: int,
        tail_seq: int,
        status: int,
    ) -> list:
        # One watch feed page: [[key, value, ts, seq], ...] ascending
        # by seq; ``boot_epoch``/``tail_seq`` = the ring's current
        # position (the subscriber's next cursor), ``status`` 0 = the
        # requested position was served from the ring, 1 = it fell
        # off (or predates this boot) — the coordinator must catch up
        # from durable state with dup-flagging before tailing again.
        return [
            "response",
            ShardResponse.WATCH_FEED,
            events,
            boot_epoch,
            tail_seq,
            status,
        ]

    @staticmethod
    def error(err: DbeelError) -> list:
        return ["response", ShardResponse.ERROR, err.kind, str(err)]


def response_to_result(response: list, expected_kind: str) -> Any:
    """Reference's response_to_result! macros (messages.rs:60-84)."""
    if not isinstance(response, (list, tuple)) or response[0] != "response":
        raise ProtocolError(f"not a response: {response!r}")
    kind = response[1]
    if kind == ShardResponse.ERROR:
        raise from_wire(response[2:4])
    if kind != expected_kind:
        raise ProtocolError(
            f"expected {expected_kind} response, got {kind}"
        )
    return response[2] if len(response) > 2 else None


# Gossip events (gossip.rs:9-40).


class GossipEvent:
    ALIVE = "alive"
    DEAD = "dead"
    CREATE_COLLECTION = "create_collection"
    DROP_COLLECTION = "drop_collection"
    HEALTH = "health"

    @staticmethod
    def alive(node: NodeMetadata) -> list:
        return [GossipEvent.ALIVE, node.to_wire()]

    @staticmethod
    def health(node_name: str, seq: int, digest: dict) -> list:
        """Periodic per-node health digest (telemetry plane):
        re-announced every telemetry interval by the node-managing
        shard and propagated epidemically like every other event, so
        any node's ``cluster_stats`` view stays fresh.  ``seq`` salts
        the gossip dedup key — each interval's digest is a FRESH
        epidemic, not a re-seen copy of the last one."""
        return [GossipEvent.HEALTH, node_name, int(seq), digest]

    @staticmethod
    def dead(node_name: str) -> list:
        return [GossipEvent.DEAD, node_name]

    @staticmethod
    def create_collection(
        name: str, rf: int, quotas=None, index=None
    ) -> list:
        # Same optional quotas-then-index tail dialect as the
        # peer-request frame (None quota placeholder keeps slot 3
        # fixed when only the index is declared).
        event = [GossipEvent.CREATE_COLLECTION, name, rf]
        if quotas or index:
            event.append(quotas if quotas else None)
        if index:
            event.append(list(index))
        return event

    @staticmethod
    def drop_collection(name: str) -> list:
        return [GossipEvent.DROP_COLLECTION, name]


def serialize_gossip_message(
    source: str, event: list, digest: Optional[dict] = None
) -> bytes:
    """Gossip datagram: [source, event] — plus, when the sending node
    has one, its compact health digest piggybacked as a third element
    (telemetry plane).  Old receivers index [0]/[1] and ignore
    the tail; old senders simply lack it."""
    msg: list = [source, event]
    if digest is not None:
        msg.append(digest)
    return msgpack_codec.packb(msg)


def deserialize_gossip_message(
    buf: bytes,
) -> Tuple[str, list, Optional[dict]]:
    """(source, event, piggybacked health digest | None)."""
    msg = msgpack_codec.unpackb(buf)
    digest = msg[2] if len(msg) > 2 and isinstance(msg[2], dict) else None
    return msg[0], msg[1], digest


def pack_message(message: list) -> bytes:
    return msgpack_codec.packb(message)


def unpack_message(buf: bytes) -> list:
    return msgpack_codec.unpackb(buf)
