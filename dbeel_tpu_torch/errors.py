"""Error taxonomy.

Mirrors the reference's error system (reference src/error.rs:8-74 and
db_server.rs:34-48): every error has a stable *kind name* that crosses the
wire as ``ResponseError{name, message}`` so clients compare by kind, never
by message text.
"""

from __future__ import annotations

from typing import Any, List


class DbeelError(Exception):
    """Base error. ``kind`` is the stable wire name."""

    kind = "Internal"

    def to_wire(self) -> List[Any]:
        # rmp-serde encodes the reference's ResponseError struct as a
        # 2-array [name, message]; keep that shape for client parity.
        return [self.kind, str(self)]


def _mk(kind_name: str, doc: str) -> type:
    return type(
        kind_name, (DbeelError,), {"kind": kind_name, "__doc__": doc}
    )


ShardStopped = _mk("ShardStopped", "The shard is shutting down.")
CollectionNotFound = _mk("CollectionNotFound", "No such collection.")
CollectionAlreadyExists = _mk(
    "CollectionAlreadyExists", "Collection already exists."
)
KeyNotFound = _mk("KeyNotFound", "No live entry for key (or tombstoned).")
KeyNotOwnedByShard = _mk(
    "KeyNotOwnedByShard",
    "This shard is not an owner of the key's hash ring range.",
)
MissingField = _mk("MissingField", "Required request field is missing.")
BadFieldType = _mk("BadFieldType", "Request field has the wrong type.")
UnsupportedField = _mk("UnsupportedField", "Unknown request type.")
MemtableCapacityReached = _mk(
    "MemtableCapacityReached", "Arena memtable is at capacity."
)
Timeout = _mk("Timeout", "Operation timed out.")
ConnectionError_ = _mk("ConnectionError", "Network failure talking to shard.")
ProtocolError = _mk("ProtocolError", "Malformed frame or message.")
CorruptedFile = _mk("CorruptedFile", "On-disk structure failed validation.")
NoRemoteShardsFound = _mk(
    "NoRemoteShardsFound", "Not enough distinct nodes for replication."
)
TooManyWalFiles = _mk(
    "TooManyWalFiles", "More than two WAL files found on open."
)
PeerDead = _mk(
    "PeerDead",
    "A replica needed for this op is marked Dead by the failure "
    "detector.",
)
ShardDegraded = _mk(
    "ShardDegraded",
    "The shard's disk failed (EIO/ENOSPC on the WAL); it is serving "
    "reads only — retry the write on another replica.",
)
Overloaded = _mk(
    "Overloaded",
    "The shard (or a peer's outbound queue) is past its hard load "
    "limit and shed this request; retry after backoff — the backlog "
    "drains, this is a transient condition, not a failure.",
)
QuotaExceeded = _mk(
    "QuotaExceeded",
    "The tenant's token bucket for this collection is exhausted; "
    "retry after backoff — tokens refill continuously at the "
    "configured per-tenant rate (QoS plane).",
)
CasConflict = _mk(
    "CasConflict",
    "A conditional write's expectation did not match the key's "
    "current state at the arc owner (atomic plane); re-read and "
    "retry with fresh expectations — the decided state is intact.",
)

_BY_KIND = {
    cls.kind: cls
    for cls in list(globals().values())
    if isinstance(cls, type) and issubclass(cls, DbeelError)
}


# ---------------------------------------------------------------------
# Failure taxonomy: every client-visible FAILURE maps to one stable
# class, shared by server metrics, the smart clients, and the chaos
# soak report, so an error rate can always be broken down the same way
# on both sides of the wire.
# ---------------------------------------------------------------------

ERROR_CLASS_COORDINATOR_DEAD = "coordinator-dead"
ERROR_CLASS_QUORUM_TIMEOUT = "quorum-timeout"
ERROR_CLASS_PEER_DEAD = "peer-dead"
ERROR_CLASS_NOT_OWNED = "not-owned"
# Disk plane: a read hit a checksum failure / quarantined range
# on this replica, or the shard is in read-only degraded mode after a
# WAL EIO/ENOSPC — both retryable, the client walks to a healthy
# replica.
ERROR_CLASS_CORRUPTION = "data-corruption"
ERROR_CLASS_DEGRADED = "degraded"
# Overload-control plane: the shard's load governor shed this
# request past its hard limits (or a peer's capped outbound queue
# refused it).  Retryable after backoff — shedding IS the mechanism
# that keeps the node alive, so clients must treat it as "try again
# shortly", never as data loss.
ERROR_CLASS_OVERLOAD = "overload"
# Multi-tenant QoS plane: the tenant's token bucket for
# the target collection is exhausted.  Retryable after backoff —
# tokens refill continuously, so "try again shortly" is the contract;
# distinct from `overload` because the SHARD is healthy: only this
# tenant is over its configured rate.
ERROR_CLASS_QUOTA = "quota"
# Atomic plane: a cas/atomic_batch expectation lost the
# race against a concurrent decided write.  Retryable by CONTRACT —
# but unlike the infrastructure classes the client must re-read and
# recompute its expectations first (the rmw helper does exactly
# that); blind resubmission would just lose again.
ERROR_CLASS_CONFLICT = "conflict"
ERROR_CLASS_OTHER = "other"
ERROR_CLASSES = (
    ERROR_CLASS_COORDINATOR_DEAD,
    ERROR_CLASS_QUORUM_TIMEOUT,
    ERROR_CLASS_PEER_DEAD,
    ERROR_CLASS_NOT_OWNED,
    ERROR_CLASS_CORRUPTION,
    ERROR_CLASS_DEGRADED,
    ERROR_CLASS_OVERLOAD,
    ERROR_CLASS_QUOTA,
    ERROR_CLASS_CONFLICT,
    ERROR_CLASS_OTHER,
)

# Application OUTCOMES, not failures: a get of an absent key or a
# duplicate create_collection is the protocol working as designed.
_BENIGN_KINDS = frozenset(
    {
        "KeyNotFound",
        "CollectionNotFound",
        "CollectionAlreadyExists",
    }
)

# Errors whose cause is the coordinator (or the path to it) being
# unreachable: the client should walk to the next replica.
_CONNECTION_KINDS = frozenset({"ConnectionError", "ProtocolError"})


def classify_error(exc: BaseException) -> "str | None":
    """Taxonomy class of a client-visible failure, or None for benign
    application outcomes (KeyNotFound et al.) that are not failures."""
    import asyncio

    if isinstance(exc, DbeelError):
        kind = exc.kind
        if kind in _BENIGN_KINDS:
            return None
        if kind == "KeyNotOwnedByShard":
            return ERROR_CLASS_NOT_OWNED
        if kind == "Timeout":
            return ERROR_CLASS_QUORUM_TIMEOUT
        if kind == "PeerDead":
            return ERROR_CLASS_PEER_DEAD
        if kind == "CorruptedFile":
            return ERROR_CLASS_CORRUPTION
        if kind == "ShardDegraded":
            return ERROR_CLASS_DEGRADED
        if kind == "Overloaded":
            return ERROR_CLASS_OVERLOAD
        if kind == "QuotaExceeded":
            return ERROR_CLASS_QUOTA
        if kind == "CasConflict":
            return ERROR_CLASS_CONFLICT
        if kind in _CONNECTION_KINDS:
            return ERROR_CLASS_COORDINATOR_DEAD
        return ERROR_CLASS_OTHER
    if isinstance(exc, asyncio.TimeoutError):
        return ERROR_CLASS_QUORUM_TIMEOUT
    if isinstance(
        exc, (OSError, asyncio.IncompleteReadError, EOFError)
    ):
        # Connect refused/reset, half-closed stream: the coordinator
        # (or the node being dialed) is gone.
        return ERROR_CLASS_COORDINATOR_DEAD
    return ERROR_CLASS_OTHER


def is_retryable_class(error_class: "str | None") -> bool:
    """Should a smart client walk to the next replica / retry after
    backoff for this failure class?  Benign outcomes and application
    errors are final; infrastructure failures are not."""
    return error_class in (
        ERROR_CLASS_COORDINATOR_DEAD,
        ERROR_CLASS_QUORUM_TIMEOUT,
        ERROR_CLASS_PEER_DEAD,
        ERROR_CLASS_NOT_OWNED,
        # Another replica may hold a clean copy (corruption) or a
        # writable WAL (degraded): always worth the walk.
        ERROR_CLASS_CORRUPTION,
        ERROR_CLASS_DEGRADED,
        # Shedding is transient by design: back off and retry (walk
        # too — another replica may be below its limits).
        ERROR_CLASS_OVERLOAD,
        # Quota refusals refill with time: back off and retry — the
        # same transient contract as shedding, scoped to one tenant.
        ERROR_CLASS_QUOTA,
        # A lost CAS race is retryable AFTER a re-read: the rmw
        # helper recomputes expectations; generic retry loops must
        # not replay the same expectation blindly.
        ERROR_CLASS_CONFLICT,
    )


def from_wire(payload: Any) -> DbeelError:
    """Rebuild a typed error from a wire ``[name, message]`` payload."""
    try:
        name, message = payload[0], payload[1]
    except Exception:
        return DbeelError(f"unparseable error payload: {payload!r}")
    cls = _BY_KIND.get(name)
    if cls is None:
        err = DbeelError(message)
        err.kind = name
        return err
    return cls(message)
