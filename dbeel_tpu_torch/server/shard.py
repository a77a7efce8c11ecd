"""MyShard — the per-core cluster state hub.

Role parity with the reference's shards.rs: one instance per shard
holding config, the consistent hash ring (rotated so this shard sees
itself as origin), known nodes, collections (one LSM tree per
(collection, shard)), the page cache, and gossip dedup counts; plus the
ownership math, replica fan-out with early-ack, gossip send, membership
handling and hash-range migration planning.

A shard's trees compact on ``device`` (``MyShard(..., device=...)``):
the card unless the caller passes ``"cpu"``, which runs the kernels'
plain PyTorch versions.  Without a card and without ``"cpu"``,
building a collection raises, as ``get_strategy`` does.
"""

from __future__ import annotations

import asyncio
import bisect
import json
import logging
import os
import re
import secrets
import socket
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

from .. import flow_events
from ..config import Config
from ..errors import (
    CollectionAlreadyExists,
    CollectionNotFound,
    ConnectionError_,
    CorruptedFile,
    DbeelError,
    Overloaded,
    Timeout,
)
from ..flow_events import FlowEvent
from ..storage import DEFAULT_TREE_CAPACITY
from ..storage.compaction import get_strategy
from ..storage.lsm_tree import LSMTree, TOMBSTONE
from ..storage.page_cache import PageCache, PartitionPageCache
from ..storage.secondary_index import index_stats, sanitize_index_fields
from ..utils import msgpack_codec
from ..utils.event import LocalEvent
from ..utils.murmur import hash_bytes, hash_string
from ..cluster import messages as msgs
from ..cluster.local_comm import LocalShardConnection
from ..cluster.messages import (
    ClusterMetadata,
    GossipEvent,
    NodeMetadata,
    ShardEvent,
    ShardRequest,
    ShardResponse,
)
from ..cluster.remote_comm import RemoteShardConnection
from . import trace as trace_mod

log = logging.getLogger(__name__)

# Grace period before migrating to a newly-announced node
# (shards.rs:64-65, NEW_NODE_MIGARTION_DELAY = 500ms).
NEW_NODE_MIGRATION_DELAY_S = 0.5


def _coalescer_stats(device=None):
    """Device-compaction coalescer counters of ``device`` for
    get_stats.  Peeks sys.modules instead of importing: the coalescer
    pulls in torch and the kernel wrappers, and get_stats runs on the
    serving loop — a server that never device-merged reports None for
    free.  The name is this package's own coalescer, never another
    package's."""
    import sys

    mod = sys.modules.get(f"{__package__}.coalescer")
    return mod.stats(device) if mod is not None else None


def _strategy_label(strategy) -> str:
    """A tree's merge as get_stats names it: the strategy, and the
    device it runs on where it has one ("device on cuda:0")."""
    device = getattr(strategy, "device", None)
    name = getattr(strategy, "name", type(strategy).__name__)
    return name if device is None else f"{name} on {device}"


def _compaction_stats_block():
    """Single-pass compaction counters for get_stats —
    storage/compaction.py is always imported by the time a shard
    serves (the tree construction pulls it), so this is a straight
    read of the process-wide accounting object."""
    from ..storage.compaction import compaction_stats

    return compaction_stats.stats()


def is_between(item: int, start: int, end: int) -> bool:
    """Half-open wrap-around ring range [start, end)
    (shards.rs:103-109)."""
    if end < start:
        return item >= start or item < end
    return start <= item < end


def vnode_tokens(shard_name: str, vnodes: int) -> List[int]:
    """Ring tokens for one shard under the virtual-node ring
   .  Token 0 is the legacy ``hash_string(shard_name)`` so
    a vnode node keeps its old primary position and a --vnodes 1 ring
    is bit-identical to the reference's; token k >= 1 salts the shard
    name, so any two cluster members derive the same token list from
    the (name, vnodes) pair alone."""
    tokens = [hash_string(shard_name)]
    for k in range(1, max(1, vnodes)):
        tokens.append(hash_string(f"{shard_name}#v{k}"))
    return tokens


ShardConnection = Union[LocalShardConnection, RemoteShardConnection]


@dataclass
class Shard:
    """Ring entry (shards.rs:80-92)."""

    node_name: str
    name: str
    connection: ShardConnection
    hash: int = -1

    def __post_init__(self):
        if self.hash < 0:
            self.hash = hash_string(self.name)

    @property
    def is_local(self) -> bool:
        return isinstance(self.connection, LocalShardConnection)


@dataclass
class Collection:
    tree: LSMTree
    replication_factor: int
    # Per-collection tenant-quota overrides:
    # DDL-carried {"ops_per_sec": int, "bytes_per_sec": int} rates
    # that beat the --tenant-* flag defaults for THIS collection
    # (None / missing key = use the flag default; 0 disables).
    # Round-tripped through the collection metadata file.
    quotas: "Optional[dict]" = None
    # Secondary-index DDL: value fields whose per-SSTable
    # index runs the flush/compaction writers maintain inline and the
    # scan planner consults.  Round-tripped through the metadata file
    # and the create_collection gossip/peer frames like quotas.
    index_fields: "Optional[list]" = None


def _sanitize_quotas(quotas) -> "Optional[dict]":
    """Normalize a DDL-carried quota override map: only the two known
    rate keys survive, as non-negative ints.  Anything malformed (the
    map crosses the wire from clients and gossip) degrades to None —
    the flag defaults — rather than poisoning admission."""
    if not isinstance(quotas, dict):
        return None
    out = {}
    for k in ("ops_per_sec", "bytes_per_sec"):
        v = quotas.get(k)
        if isinstance(v, int) and not isinstance(v, bool) and v >= 0:
            out[k] = v
    return out or None


class MigrationAction:
    SEND = "send"
    DELETE = "delete"


@dataclass
class RangeAndAction:
    start: int
    end: int
    action: str  # MigrationAction
    connection: Optional[ShardConnection] = None


class MyShard:
    def __init__(
        self,
        config: Config,
        shard_id: int,
        shards: List[Shard],
        cache: PageCache,
        local_connection: LocalShardConnection,
        device=None,
    ) -> None:
        self.config = config
        # Where this shard's trees merge and sort: the card unless the
        # caller names "cpu" (the kernels' plain versions).
        self.device = device
        self.id = shard_id
        self.shard_name = f"{config.name}-{shard_id}"
        self.hash = hash_string(self.shard_name)
        self.shards: List[Shard] = list(shards)
        self.nodes: Dict[str, NodeMetadata] = {}
        self.gossip_requests: Dict[Tuple[str, str], int] = {}
        self.collections: Dict[str, Collection] = {}
        self.collections_change_event = LocalEvent()
        # Hinted handoff (improvement over the reference, which has
        # none — SURVEY §5): (collection, key, ts) of mutations whose
        # replica fan-out skipped or failed a node, keyed by that
        # node, replayed on its next Alive (and by the periodic drain
        # loop).  WAL-backed per shard — hints survive a restart.
        from .hints import HintLog

        self.hint_log = HintLog(
            os.path.join(config.dir, f"hints-{shard_id}.log")
            if config.dir and config.hint_ttl_ms > 0
            else None,
            max_per_node=config.hint_max_per_node,
            ttl_s=config.hint_ttl_ms / 1000.0,
        )
        # Ring entries of nodes the failure detector removed: a
        # write's NATURAL replica set does not shrink because a node
        # is down — departed nodes that would have been in the
        # distinct-node walk get hints instead of frames.  Entries
        # leave on the node's next Alive, or when the hint-drain
        # sweep closes their TTL window (a node gone longer than
        # --hint-ttl gets anti-entropy backfill, not hints — and a
        # permanently decommissioned node stops costing a hint per
        # write).
        self.departed_shards: Dict[str, List[Shard]] = {}
        self.departed_at: Dict[str, float] = {}
        # Hash-sorted live+departed ring + its hash list, rebuilt
        # lazily on ring or departed-set changes: _hint_departed runs
        # on EVERY fan-out while a node is down and must not pay a
        # sort per request.
        self._merged_walk_cache: Optional[tuple] = None
        # Failure-aware request plane: nodes the failure detector (or
        # Dead gossip) declared dead.  Fan-outs treat these peers as
        # immediately failed instead of stalling into connect/read
        # timeouts; cleared on Alive.
        self.dead_nodes: set = set()
        # In-flight replica fan-out futures by target node: a death
        # mark cancels them on the spot, so a client op blocked on a
        # black-holed peer unblocks the moment detection fires (the
        # blind window is bounded by the detector, not the timeouts).
        self._inflight_by_node: Dict[str, set] = {}
        # peers.json write serialization: a
        # monotonic snapshot version + lock so an older snapshot can
        # never os.replace a newer one when two executor writes race.
        self._peers_version = 0
        self._peers_written_version = 0
        self._peers_write_lock = threading.Lock()
        self.cache = cache
        # Shares discipline (glommio task-queue parity): serving marks
        # foreground activity; compaction/migration/hint-replay units
        # run under scheduler.bg_slice().
        from .scheduler import ShareScheduler

        self.scheduler = ShareScheduler(
            config.foreground_tasks_shares,
            config.background_tasks_shares,
        )
        from .metrics import ShardMetrics

        self.metrics = ShardMetrics()
        # Tracing plane: the per-shard flight recorder.  Full
        # spans for sampled / client-stamped ops, minimal records for
        # every slow or errored op; queried via the admin trace_dump
        # verb.  The metrics hub holds a reference so its completion
        # points feed the slow/error capture.
        from .trace import FlightRecorder

        self.trace_recorder = FlightRecorder(
            sample_every=config.trace_sample,
            slow_op_us=config.slow_op_us,
            capacity=config.trace_ring,
        )
        self.metrics.recorder = self.trace_recorder
        self.metrics.slow_op_us = self.trace_recorder.slow_op_us
        # Overload-control plane: one governor per shard folds
        # the backlog signals (admitted work, memtable fill, flush/
        # compaction debt) into an OK/soft/hard level.  Soft delays
        # background units (installed as the scheduler's gate) and
        # shrinks the AIMD connection windows; hard sheds new public
        # data ops with the retryable Overloaded error.
        from .governor import LoadGovernor

        self.governor = LoadGovernor(self, config)
        self.scheduler.overload_gate = self.governor.bg_gate
        # Multi-tenant QoS plane: class lanes (weighted
        # admission shares, per-class AIMD windows over the
        # governor's per-class levels) + per-tenant token-bucket
        # quotas enforced at dispatch.
        from .qos import QosPlane

        self.qos = QosPlane(self, config)
        # Streaming scan/range query plane: chunked, cursor-
        # resumable scans merged across every ring arc's replicas,
        # admitted chunk-by-chunk through the governor.
        from .scan import ScanPlane

        self.scan_plane = ScanPlane(self, config)
        # Watch/CDC streaming plane: bounded per-shard
        # change ring fed at the WAL group-commit release point +
        # resumable coordinator fan-out with durable-state catch-up.
        from .watch import WatchPlane

        self.watch_plane = WatchPlane(self, config)
        # Continuous telemetry plane: per-shard time-series
        # ring + health watchdog.  Constructed unconditionally so the
        # get_stats schema never depends on the knob; sampling only
        # arms (riding the governor heartbeat) when
        # --telemetry-interval > 0.
        from .telemetry import ShardTelemetry

        self.telemetry = ShardTelemetry(config)
        # Cluster health view: node name -> freshest per-node health
        # digest (gossip piggybacks + periodic `health` events).
        # Served by the always-on cluster_stats admin verb.
        self.cluster_view: Dict[str, dict] = {}
        # This node's own folded digest (set by the node-managing
        # shard's announce; piggybacked on outgoing gossip frames).
        self.last_node_digest: Optional[dict] = None
        # Snapshot stamps (offline rate derivation from dump pairs):
        # wall/monotonic start anchors + a per-shard monotonic
        # get_stats sequence.
        self.started_at_ms = int(time.time() * 1000)
        self._started_mono = time.monotonic()
        self.stats_seq = 0
        # Anti-entropy transfer counters (observability + the
        # sub-range proportionality test: one diverged key must move
        # ~range/buckets entries, not the whole range).
        self.ae_entries_pushed = 0
        self.ae_entries_fetched = 0
        # Convergence-plane counters (get_stats.convergence).
        self.ae_rounds = 0
        # Local applies performed by convergence machinery (RANGE_PUSH
        # receipts — hint replay and AE pushes land here — plus
        # RANGE_PULL applies): every healed key on THIS shard counts
        # exactly once.
        self.keys_healed = 0
        self.read_repairs = 0
        self.read_repairs_skipped = 0
        # Read-repair token bucket (opportunistic rate cap).
        self._rr_tokens = float(config.read_repair_max_per_sec)
        self._rr_refill_at: Optional[float] = None
        # Native serving data plane (SURVEY §7: compiled hot path,
        # Python keeps the cluster/replication brain).  None when the
        # native library is unavailable — everything then runs the
        # Python path.
        from .dataplane import create_dataplane

        self.dataplane = create_dataplane()
        # Native drops by verb (hard-overload sheds + expired-client-
        # deadline drops the C plane answered): the Python-side half
        # of the native_served_frac accounting — the C counters are
        # totals, the verb split only exists at the mirror point.
        self.native_drops_by_op: Dict[str, int] = {}
        if self.dataplane is not None:
            # Arm the native shed/deadline answers with wire frames
            # byte-identical to the interpreted path's (all-native
            # serving path): the governor mirrors its level in, and
            # at LEVEL_HARD data verbs are answered entirely in C.
            from .db_server import install_native_overload_responses

            install_native_overload_responses(self)
            if config.trace_sample > 0:
                # Native-plane timing (tracing plane): arm the coarse
                # per-verb stage counters (parse/work/reply monotonic
                # deltas) so natively-served ops stay visible to
                # latency accounting.  Off by default — the clock
                # reads cost ~0 but the acceptance bar is "within
                # noise", so unsampled deployments pay literally
                # nothing.
                self.dataplane.set_trace(True)
        # Native quorum fan-out engine: the packed
        # peer frame goes out on persistent raw sockets and acks are
        # byte-compared in C; Python keeps quorum counting/merge/
        # repair.  None when the native library lacks it — the
        # asyncio fan-out below is always the fallback.
        from ..cluster.native_fanout import create_quorum_fanout

        self.quorum_fanout = create_quorum_fanout(self)
        self.local_connection = local_connection
        self.stop_event = local_connection.stop_event
        # Live public-API connections (protocol objects) for the
        # per-shard idle reaper.
        self.db_connections: set = set()
        self.remote_connections: set = set()  # peer-plane protocols
        self.flow = flow_events.FlowEventNotifier()
        self._background_tasks: set = set()
        # Set by crash-simulating harnesses: suppresses graceful-stop
        # side effects (death gossip) so a "crash" really is silent.
        self.crashed = False
        # Durability plane: WAL EIO/ENOSPC flips the shard into
        # explicit read-only degraded mode — writes answer
        # ShardDegraded (clients walk to healthy replicas), reads keep
        # serving.  Sticky until restart: a disk that errored once is
        # not trusted again on a timer.
        self.degraded = False
        self.degraded_reason: Optional[str] = None
        # Collections with a replica repair pull in flight (quarantine
        # recovery) — dedup so a burst of checksum failures on one
        # table spawns one repair; a quarantine arriving MID-repair
        # marks a rerun instead of being dropped.
        self._repairs_running: set = set()
        self._repairs_rerun: set = set()
        # Background scrub counters (tasks.run_scrub_loop).
        self.scrub_bytes_verified = 0
        self.scrub_cycles = 0
        # Per-boot nonce salted into the gossip source: a restarted
        # node's announcements are a FRESH epidemic, so the seen-count
        # dedup can never suppress a rejoin (the reference's
        # name-keyed dedup silently eats re-announcements from nodes
        # that crash and come back).
        self.boot_id = secrets.token_hex(4)
        # Elastic membership plane: this shard's virtual-
        # node ring tokens, the per-node ownership epoch every arc is
        # fenced under (any ring change bumps it; a migration plan
        # stamped with an older epoch aborts between batches, and a
        # write stamped with an older epoch is refused retryably while
        # a migration is live), the in-flight migration task set the
        # fence cancels, and the get_stats.membership counters.
        self.tokens = vnode_tokens(self.shard_name, config.vnodes)
        self.membership_epoch = 1
        self._migration_tasks: set = set()
        self.migrations_started = 0
        self.migrations_resumed = 0
        self.migrations_cancelled = 0
        self.keys_migrated = 0
        self.bytes_migrated = 0
        self.fence_refusals = 0
        # Atomic plane: per-arc serialization locks for
        # conditional writes (cas / atomic_batch), keyed by
        # (collection, replica-set tuple) — arcs are finite, so the
        # dict is bounded; plain LWW sets never take them.  The boot
        # barrier refuses to DECIDE conditional writes for a short
        # window after restart (split-decider race: a fallback decider
        # may still be serving this arc until the Alive edge
        # propagates).  Counters feed get_stats.atomic.
        self._atomic_locks: dict = {}
        self._atomic_barrier_until = (
            time.monotonic() + config.cas_boot_barrier_ms / 1000.0
        )
        self.cas_served = 0
        self.cas_conflicts = 0
        self.batches_committed = 0
        self.batches_refused = 0
        if config.vnodes > 1:
            self._expand_vnode_ring()
        self.sort_consistent_hash_ring()

    # ------------------------------------------------------------------
    # Ring (shards.rs:657-670)
    # ------------------------------------------------------------------

    def _expand_vnode_ring(self) -> None:
        """Expand THIS node's ring entries to --vnodes tokens each
        (__init__ receives one entry per local shard).  The extra
        entries share the physical shard's name and connection —
        identity on the ring is by NAME; the hash is just a token.
        Remote nodes' entries are expanded by add_shards_of_nodes from
        their gossiped token lists instead."""
        expanded: List[Shard] = []
        for s in self.shards:
            if s.node_name != self.config.name:
                expanded.append(s)
                continue
            for tok in vnode_tokens(s.name, self.config.vnodes):
                expanded.append(
                    Shard(s.node_name, s.name, s.connection, hash=tok)
                )
        self.shards = expanded

    def sort_consistent_hash_ring(self) -> None:
        """Ascending by hash, rotated so hashes >= self.hash come first —
        shards[0] is this shard, shards[-1] its ring predecessor."""
        threshold = self.hash
        self.shards.sort(
            key=lambda s: (s.hash < threshold, s.hash)
        )
        self._hash_sorted = sorted(self.shards, key=lambda s: s.hash)
        self._sorted_hashes = [s.hash for s in self._hash_sorted]
        # getattr: sort runs once from __init__ before the cache
        # attribute exists.
        if getattr(self, "_merged_walk_cache", None) is not None:
            self._merged_walk_cache = None
        self._refresh_dataplane_ownership()

    def _refresh_dataplane_ownership(self) -> None:
        """Push the replica-0 ownership range down to the native fast
        path.  owns_key(h, 0) == "I am the first shard with hash >= h
        on the wrapping ring", i.e. the cyclic range
        (predecessor_hash, my_hash]."""
        dp = getattr(self, "dataplane", None)
        if dp is None:
            return
        if len(getattr(self, "tokens", ()) or ()) > 1:
            # Vnodes: this shard's ownership is a UNION of arcs the
            # native single-range check can't express — keyed-op
            # ownership gates run in Python (the C plane punts with
            # own_mode 0).
            dp.set_ownership(0)
            return
        if getattr(self, "_migration_tasks", None):
            # Epoch fence engaged: a live migration means stale-epoch
            # writes must be refused at the Python dispatcher — the C
            # plane doesn't read the epoch field, so it punts keyed
            # ops while the fence is up (restored when the last
            # migration task drains).
            dp.set_ownership(0)
            return
        ring = self._sorted_hashes
        if len(ring) < 2:
            dp.set_ownership(1)
            return
        if len(set(ring)) != len(ring):
            # Hash collisions on the ring: bisect tie-breaks get
            # subtle — serve ownership checks from Python only.
            dp.set_ownership(0)
            return
        idx = ring.index(self.hash)
        prev_hash = ring[idx - 1]  # cyclic: idx 0 -> last entry
        dp.set_ownership(2, prev_hash, self.hash)

    def add_shards_of_nodes(self, nodes: List[NodeMetadata]) -> None:
        for node in nodes:
            # Vnode dialect: a peer that gossips token lists gets one
            # ring entry per token, all sharing the shard's pooled
            # connection; a legacy (or --vnodes 1) peer omits them and
            # keeps the single derived token — mixed clusters agree
            # on ownership because every member walks the same union
            # of advertised tokens.
            tokens_by_sid = {}
            if node.tokens is not None and len(node.tokens) == len(
                node.ids
            ):
                tokens_by_sid = dict(zip(node.ids, node.tokens))
            for sid in node.ids:
                address = f"{node.ip}:{node.remote_shard_base_port + sid}"
                name = f"{node.name}-{sid}"
                # Ring entries are long-lived: pool their request
                # streams (replication fan-out latency).
                connection = RemoteShardConnection.from_config(
                    address, self.config, pooled=True
                )
                for tok in tokens_by_sid.get(sid) or [
                    hash_string(name)
                ]:
                    self.shards.append(
                        Shard(
                            node_name=node.name,
                            name=name,
                            connection=connection,
                            hash=int(tok),
                        )
                    )
        self.sort_consistent_hash_ring()

    def owns_key(self, key_hash: int, replica_index: int = 0) -> bool:
        """Am I the replica_index-th distinct-node owner of this hash?

        Deliberate deviation: the reference's owns_key
        (shards.rs:586-618) walks the rotated ring BACKWARD collecting
        distinct nodes, which disagrees with the client's FORWARD
        replica walk (dbeel_client/src/lib.rs:343-395) whenever a node
        has multiple shards interleaved on the ring — correctly-routed
        replica requests then bounce with KeyNotOwnedByShard and the
        client resyncs forever (latent upstream: its tests run one
        shard per node).  We define ownership as the exact mirror of
        the client walk: start at the first shard with hash >= key_hash
        and take the replica_index-th shard on a distinct-node walk.
        Held equal to dbeel_tpu's under hypothesis in
        tests/test_torch_shard.py."""
        ring = self._hash_sorted
        if len(ring) < 2:
            return True
        import bisect

        start = bisect.bisect_left(
            self._sorted_hashes, key_hash
        ) % len(ring)
        nodes: set = set()
        found = 0
        for off in range(len(ring)):
            s = ring[(start + off) % len(ring)]
            if s.node_name in nodes:
                continue
            if found == replica_index:
                # Identity by NAME, not token: under vnodes this
                # shard appears once per token and any of its entries
                # selected by the walk means ownership.
                return s.name == self.shard_name
            found += 1
            nodes.add(s.node_name)
        return False

    # ------------------------------------------------------------------
    # Atomic plane: decider election + per-arc locks
    # ------------------------------------------------------------------

    def preceding_replica_nodes(self, key_hash: int) -> List[str]:
        """Distinct-node walk order BEFORE this node for a key's hash
        (the exact mirror of owns_key's forward walk).  The CAS
        fallback-decider gate: a coordinator may DECIDE a conditional
        write at replica_index>0 only when every node ahead of it on
        the key's walk is marked Dead — otherwise two live deciders
        could serialize the same key independently (split brain)."""
        ring = self._hash_sorted
        if len(ring) < 2:
            return []
        start = bisect.bisect_left(
            self._sorted_hashes, key_hash
        ) % len(ring)
        seen: set = set()
        preceding: List[str] = []
        for off in range(len(ring)):
            s = ring[(start + off) % len(ring)]
            if s.node_name in seen:
                continue
            if s.name == self.shard_name:
                return preceding
            seen.add(s.node_name)
            preceding.append(s.node_name)
        return preceding

    def atomic_barrier_remaining_s(self) -> float:
        """Seconds left in the post-boot conditional-write refusal
        window (0 when expired or disabled)."""
        return max(
            0.0, self._atomic_barrier_until - time.monotonic()
        )

    def atomic_lock(self, collection_name: str, key_hash: int):
        """The per-arc serialization lock for conditional writes:
        every cas/atomic_batch whose key(s) land on the same
        (collection, replica-set) arc decides under ONE asyncio.Lock,
        so read-compare-decide sequences on a key can never
        interleave on this decider.  Keyed by the DISTINCT-NODE
        replica set (not the raw token) so two tokens of one arc
        share a lock."""
        names = tuple(
            n
            for n, _c in self._replica_connections(
                len(self.nodes) or 1, key_hash
            )
        )
        lock_key = (collection_name, names)
        lock = self._atomic_locks.get(lock_key)
        if lock is None:
            lock = self._atomic_locks[lock_key] = asyncio.Lock()
        return lock

    def _atomic_stats(self) -> dict:
        """get_stats.atomic: conditional-write counters.  The numeric
        leaves flatten into the telemetry ring (cas_conflicts_per_s
        and the cas_conflict_storm watchdog read them)."""
        return {
            "cas_served": self.cas_served,
            "cas_conflicts": self.cas_conflicts,
            "batches_committed": self.batches_committed,
            "batches_refused": self.batches_refused,
            "barrier_remaining_ms": int(
                self.atomic_barrier_remaining_s() * 1000
            ),
        }

    @staticmethod
    def get_last_owning_shard(
        shards: List[Shard], start_shard_hash: int, replication_factor: int
    ) -> Optional[Shard]:
        """shards.rs:1074-1101: walk the ring from the first shard with
        hash >= start, collecting distinct nodes; the RF-th is the last
        owner of this range."""
        if not shards:
            return None
        start = next(
            (
                i
                for i, s in enumerate(shards)
                if s.hash >= start_shard_hash
            ),
            0,
        )
        nodes = set()
        found = 0
        i = 0
        index = start % len(shards)
        while i == 0 or index != start:
            shard = shards[index]
            if shard.node_name not in nodes:
                found += 1
                if found == replication_factor:
                    return shard
                nodes.add(shard.node_name)
            i += 1
            index = (start + i) % len(shards)
        return None

    def is_owning_shard(
        self, start_shard_index: int, replication_factor: int
    ) -> bool:
        """shards.rs:1103-1129: is this shard among the RF distinct-node
        owners of the range starting at ring position start_shard_index?"""
        shards = self.shards
        nodes = set()
        found = 0
        i = 0
        index = start_shard_index % len(shards)
        while i == 0 or index != start_shard_index:
            shard = shards[index]
            if shard.node_name not in nodes:
                if shard.name == self.shard_name:
                    return True
                found += 1
                if found == replication_factor:
                    break
                nodes.add(shard.node_name)
            i += 1
            index = (start_shard_index + i) % len(shards)
        return False

    # ------------------------------------------------------------------
    # Node metadata
    # ------------------------------------------------------------------

    def persist_peers(self) -> None:
        """Write the known OTHER nodes to ``{dir}/peers.json`` (wire
        form, tmp+rename) — the system.peers pattern the reference
        lacks: its ring lives only in memory, so a node restarted
        after every OTHER node forgot it (failure detection removed
        it) and whose configured seeds are dead or itself stays
        PARTITIONED ALONE FOREVER — found by chaos_soak.py
        --scale-churn, where the self-seeded restart of the seed node
        split the cluster and 145 acked writes became unreadable
        through it.  Discovery (run.py discover_nodes) merges these
        persisted peers with the configured seeds, so a restart can
        always re-announce to someone who remembers the rest.

        Only the node-managing view (shard 0) writes; every
        membership change (discovery, Alive-add, death) refreshes."""
        if self.id != 0 or not self.config.dir:
            return
        # Snapshot on the loop, write OFF-loop (this fires inside the
        # gossip Alive / dead-node handlers; a slow disk must not
        # stall every shard's request handling — same discipline as
        # the off-loop WAL disposal).
        wire = [n.to_wire() for n in self.nodes.values()]
        # Version assignment happens on the loop thread (serialized);
        # the write-side lock + version check order the executor
        # writes so an older snapshot can never replace a newer one.
        self._peers_version += 1
        version = self._peers_version
        try:
            asyncio.get_running_loop().run_in_executor(
                None, self._persist_peers_write, wire, version
            )
        except RuntimeError:
            # No loop (direct construction in tests).
            self._persist_peers_write(wire, version)

    def _persist_peers_write(self, wire: list, version: int) -> None:
        """Executor-side peers.json write, serialized by version: a
        snapshot older than what's already on disk is a no-op
        (two racing pool threads must never os.replace a newer
        peers.json with a stale one)."""
        try:
            with self._peers_write_lock:
                if version <= self._peers_written_version:
                    return  # a newer snapshot already landed
                dir_path = self.config.dir
                os.makedirs(dir_path, exist_ok=True)
                path = os.path.join(dir_path, "peers.json")
                # Unique tmp per write: two queued executor writes
                # must not interleave in one tmp file.
                tmp = f"{path}.tmp{os.getpid()}-{version}"
                with open(tmp, "w") as f:
                    json.dump(wire, f)
                os.replace(tmp, path)
                self._peers_written_version = version
        except OSError:
            log.warning("peers.json write failed", exc_info=True)

    def get_node_metadata(self) -> NodeMetadata:
        # All shards of THIS node — local queues in single-process mode,
        # same-node remote entries in the per-core process launcher.
        # Under vnodes a shard appears once per ring token: dedup to
        # physical shard ids and advertise the per-shard token lists
        # (an optional trailing wire slot old peers ignore).
        mine: Dict[int, set] = {}
        for s in self.shards:
            if s.node_name == self.config.name:
                sid = int(s.name.rsplit("-", 1)[1])
                mine.setdefault(sid, set()).add(s.hash)
        ids = sorted(mine)
        return NodeMetadata(
            name=self.config.name,
            ip=self.config.ip,
            remote_shard_base_port=self.config.remote_shard_port,
            ids=ids,
            gossip_port=self.config.gossip_port,
            db_port=self.config.port,
            tokens=[sorted(mine[sid]) for sid in ids],
        )

    def get_nodes(self) -> List[NodeMetadata]:
        nodes = list(self.nodes.values())
        nodes.append(self.get_node_metadata())
        return nodes

    def get_cluster_metadata(self) -> ClusterMetadata:
        return ClusterMetadata(
            nodes=self.get_nodes(),
            collections=[
                (name, c.replication_factor)
                for name, c in self.collections.items()
            ],
            # Clients stamp this epoch on writes; a migration-time
            # fence refuses older stamps retryably (the refused
            # client resyncs metadata — picking up the new epoch AND
            # the new ring — and retries).
            epoch=self.membership_epoch,
        )

    # ------------------------------------------------------------------
    # Collections (shards.rs:259-381)
    # ------------------------------------------------------------------

    def _collection_metadata_path(self, name: str) -> str:
        return os.path.join(self.config.dir, f"{name}.metadata")

    def _collection_dir(self, name: str) -> str:
        return os.path.join(self.config.dir, f"{name}-{self.id}")

    def get_collection(self, name: str) -> Collection:
        col = self.collections.get(name)
        if col is None:
            raise CollectionNotFound(name)
        return col

    def _create_lsm_tree(
        self, name: str, index_fields: "Optional[list]" = None
    ) -> LSMTree:
        capacity = self.config.memtable_capacity or DEFAULT_TREE_CAPACITY
        strategy = get_strategy(
            self.config.compaction_backend, device=self.device
        )
        # Intra-merge latency class: the merge worker thread yields CPU
        # to serving between bounded quanta (scheduler.BgThrottle).
        strategy.throttle = self.scheduler.thread_throttle()
        tree = LSMTree.open_or_create(
            self._collection_dir(name),
            cache=PartitionPageCache(name, self.cache),
            capacity=capacity,
            wal_sync=self.config.wal_sync,
            wal_sync_delay_us=self.config.wal_sync_delay_us,
            bloom_min_size=self.config.sstable_bloom_min_size,
            strategy=strategy,
            memtable_kind=self.config.memtable_kind,
            gc_grace_s=self.config.gc_grace_s(),
            index_fields=index_fields,
            device=self.device,
        )
        # Durability-plane escalation hooks: disk errors degrade the
        # whole shard; a corruption quarantine pulls the lost range
        # back from replicas.
        tree.on_disk_error = self._on_tree_disk_error
        tree.on_quarantine = (
            lambda _tree, n=name: self._on_tree_quarantine(n)
        )
        # Watch/CDC plane: every acked mutation — client
        # writes, replica applies, decided CAS outcomes, RANGE_PUSH
        # and hint replays — releases through the tree's commit
        # chokepoints, so this one hook is the complete change feed.
        tree.on_commit = (
            lambda key, value, ts, n=name: self.watch_plane.publish(
                n, key, value, ts
            )
        )
        if self.degraded:
            tree.read_only = True
        return tree

    # -- degraded mode + quarantine repair (durability plane) ----------

    def _on_tree_disk_error(self, exc: BaseException) -> None:
        self.enter_degraded(exc)

    def enter_degraded(self, reason) -> None:
        """Flip this shard read-only after a disk failure: every
        tree rejects writes with ShardDegraded (a retryable class —
        coordinators keep quorum via the other replicas, smart clients
        walk), the native write fast path is suspended so the guard
        cannot be bypassed in C, and reads keep serving.  Sticky until
        operator restart."""
        for col in self.collections.values():
            col.tree.read_only = True
        if self.degraded:
            return
        self.degraded = True
        self.degraded_reason = str(reason)
        log.error(
            "shard %s entering DEGRADED read-only mode: %s",
            self.shard_name,
            reason,
        )
        if self.dataplane is not None:
            # The C client/replica planes answer writes without Python
            # in the loop: unhook them (listener first, or the next
            # write-state notify would re-register) so every request
            # funnels through the guarded Python path.
            for name, col in list(self.collections.items()):
                col.tree.write_state_listener = None
                try:
                    self.dataplane.unregister(name)
                except Exception:
                    log.exception(
                        "dataplane unregister(%s) failed", name
                    )
        self.flow.notify(FlowEvent.SHARD_DEGRADED)

    def _on_tree_quarantine(self, name: str) -> None:
        """A table was quarantined: suspend the collection's native
        fast path (a C miss during the suspect window would read as a
        confident absence) and spawn one replica repair pull."""
        col = self.collections.get(name)
        if col is not None and self.dataplane is not None:
            col.tree.write_state_listener = None
            try:
                self.dataplane.unregister(name)
            except Exception:
                log.exception("dataplane unregister(%s) failed", name)
        if name in self._repairs_running:
            # A repair is mid-pull: its `covered` snapshot doesn't
            # include THIS quarantine — request a follow-up run, or
            # the new quarantine would stay suspect forever.
            self._repairs_rerun.add(name)
            return
        self._repairs_running.add(name)

        async def run(n=name):
            from .tasks import repair_collection

            try:
                while True:
                    self._repairs_rerun.discard(n)
                    await repair_collection(self, n)
                    if n not in self._repairs_rerun:
                        break
            except Exception:
                log.exception("replica repair for %s failed", n)
            finally:
                self._repairs_running.discard(n)
                self._resume_dataplane(n)

        self.spawn(run())

    def _resume_dataplane(self, name: str) -> None:
        col = self.collections.get(name)
        if (
            col is None
            or self.dataplane is None
            or self.degraded
            or col.tree.reads_suspect
        ):
            return
        try:
            self.dataplane.register_tree(
                name,
                col.tree,
                client_plane=col.replication_factor == 1,
            )
        except Exception:
            log.exception("dataplane re-register(%s) failed", name)

    async def rearm(self) -> None:
        """Operator-initiated exit from sticky degraded mode (the
        ROADMAP "re-arm after disk replacement" item): re-run the
        free-space and WAL-append pre-checks on every collection's
        store, clear read-only, and re-register the native write
        plane — no restart.  Raises ShardDegraded (shard STAYS
        degraded) when any pre-check still fails."""
        if not self.degraded and not any(
            col.tree.read_only for col in self.collections.values()
        ):
            return  # already armed: idempotent no-op
        # Probe every tree BEFORE clearing anything: a node with one
        # replaced disk and one still-dead disk must stay degraded.
        for name, col in list(self.collections.items()):
            await col.tree.rearm_precheck()
        for col in self.collections.values():
            col.tree.read_only = False
        self.degraded = False
        self.degraded_reason = None
        log.info("shard %s re-armed: degraded mode cleared",
                 self.shard_name)
        for name, col in list(self.collections.items()):
            # Retry any flush the degraded window refused (frees the
            # memtable) and re-register the native write plane.
            self.spawn(col.tree.flush())
            self._resume_dataplane(name)
        self.flow.notify(FlowEvent.SHARD_REARMED)

    def allow_read_repair(self) -> bool:
        """Token-bucket admission for quorum read-repair pushes:
        beyond the configured rate the repair is skipped (counted;
        anti-entropy owns the tail) so a stale-replica hot spot
        cannot turn every read into a write storm."""
        rate = self.config.read_repair_max_per_sec
        if rate <= 0:
            self.read_repairs += 1
            return True
        now = asyncio.get_event_loop().time()
        if self._rr_refill_at is None:
            self._rr_refill_at = now
        self._rr_tokens = min(
            float(rate),
            self._rr_tokens + (now - self._rr_refill_at) * rate,
        )
        self._rr_refill_at = now
        if self._rr_tokens >= 1.0:
            self._rr_tokens -= 1.0
            self.read_repairs += 1
            return True
        self.read_repairs_skipped += 1
        return False

    def get_stats(self) -> dict:
        """Per-shard observability snapshot (no reference analog —
        SURVEY.md §5 marks tracing/metrics as a gap to improve on)."""
        collections = {}
        for name, col in self.collections.items():
            tree = col.tree
            collections[name] = {
                "memtable_entries": tree.memtable_entries,
                "sstables": tree.sstable_indices_and_sizes(),
                "replication_factor": col.replication_factor,
                # The port's one key beyond the reference's: which
                # merge this tree compacts with, and on which device.
                "strategy": _strategy_label(tree.strategy),
            }
        from ..storage.wal import group_commit_stats, hub_fsync_errors

        durability = {
            "checksum_failures": 0,
            "quarantined_tables": 0,
            "repairs_completed": 0,
        }
        repairs_pending = 0
        for col in self.collections.values():
            for k in durability:
                durability[k] += col.tree.durability.get(k, 0)
            repairs_pending += col.tree._quarantine_pending
        from ..storage import native as native_mod

        durability.update(
            repairs_pending=repairs_pending,
            scrub_bytes_verified=self.scrub_bytes_verified,
            scrub_cycles=self.scrub_cycles,
            degraded_mode=int(self.degraded),
            degraded_reason=self.degraded_reason,
            # Silent O_DIRECT → buffered degradations in the C
            # streamers (process-wide; unaligned buffers or a
            # filesystem refusing O_DIRECT).  Previously invisible —
            # the only symptom was a throughput cliff.
            odirect_fallbacks=native_mod.odirect_fallbacks(),
        )

        # Overload-control block: governor level/signals, shed
        # and deadline-drop counters, AIMD window shape, and the
        # slow-peer outbound-queue sheds summed over ring peers.
        overload = self.governor.stats()
        # One term per physical connection: vnode entries share their
        # shard's connection and must not multiply the sums.
        peer_conns = {
            id(s.connection): s.connection for s in self.shards
        }.values()
        overload["peer_queue_sheds"] = sum(
            getattr(c, "shed_count", 0) for c in peer_conns
        )
        overload["peer_pipelined_ops"] = sum(
            getattr(c, "pipelined_ops", 0) for c in peer_conns
        )
        windows = [
            conn.window
            for conn in self.db_connections
            if getattr(conn, "window", None) is not None
        ]
        overload["window_cur"] = (
            round(sum(windows) / len(windows), 2) if windows else None
        )

        self.stats_seq += 1
        return {
            "shard": self.shard_name,
            # Snapshot stamps (telemetry plane): wall time, process
            # uptime and a monotonic per-shard sequence, so offline
            # tooling can derive rates from any dump PAIR without
            # guessing wall-clock or ordering.
            "ts_ms": int(time.time() * 1000),
            "uptime_s": round(
                time.monotonic() - self._started_mono, 1
            ),
            "stats_seq": self.stats_seq,
            "started_at_ms": self.started_at_ms,
            "durability": durability,
            "overload": overload,
            "nodes_known": len(self.nodes),
            "ring_size": len(self.shards),
            "dead_nodes": sorted(self.dead_nodes),
            # Elastic membership plane: ownership epoch
            # (stamped per owned arc below — every arc shares the
            # node epoch by construction, any ring change bumps all),
            # migration lifecycle counters and the fence refusals.
            "membership": self._membership_stats(),
            # Atomic plane: conditional-write counters —
            # cas decides/conflicts, batch commits/refusals, and the
            # post-boot decider barrier's remaining window.
            "atomic": self._atomic_stats(),
            "hints_queued": self.hint_log.queued_by_node(),
            # Replica-convergence plane: hinted handoff,
            # quorum read-repair, background anti-entropy.
            "convergence": {
                "hints_queued": self.hint_log.queued_total(),
                "hints_recorded": self.hint_log.recorded,
                "hints_replayed": self.hint_log.replayed,
                "hints_expired": self.hint_log.expired,
                "hints_dropped_capacity": (
                    self.hint_log.dropped_capacity
                ),
                "read_repairs": self.read_repairs,
                "read_repairs_skipped": self.read_repairs_skipped,
                "anti_entropy_rounds": self.ae_rounds,
                "keys_healed": self.keys_healed,
            },
            "wal_fsync_errors": hub_fsync_errors(),
            # Group-commit shape: durable acks released per completed
            # fdatasync (process-wide; the batching win of pipelined
            # connections + multi-ops, observable in production).
            "wal_group_commit": group_commit_stats(),
            "cache": {
                "pages": len(self.cache),
                "hits": self.cache.hits,
                "misses": self.cache.misses,
            },
            "scheduler": self.scheduler.stats(),
            "anti_entropy": {
                "entries_pushed": self.ae_entries_pushed,
                "entries_fetched": self.ae_entries_fetched,
            },
            "metrics": self.metrics.snapshot(),
            # Tracing plane: flight-recorder counters + the
            # native plane's coarse per-verb stage attribution, so
            # C-served ops are no longer invisible to latency
            # accounting.  Ring CONTENTS come back via trace_dump.
            "trace": {
                "sample_every": self.trace_recorder.sample_every,
                "slow_op_us": self.trace_recorder.slow_op_us,
                "capacity": self.trace_recorder.capacity,
                **self.trace_recorder.stats(),
                "native": (
                    self.dataplane.trace_stats()
                    if self.dataplane is not None
                    else None
                ),
            },
            # Streaming scan plane: chunk/byte/cursor/shed
            # counters + the active-chunks gauge.
            "scan": self.scan_plane.stats(),
            "watch": self.watch_plane.stats(),
            # Multi-tenant QoS plane: per-class admitted/
            # shed/window/level lanes + per-tenant token balances and
            # throttle counters — reachable through BOTH clients like
            # every other block.
            "qos": self.qos.stats(),
            # Single-pass compaction plane: bytes
            # read/written per background pass, inline vs post-hoc
            # sidecar counts, and the read-amplification ratio the
            # design claims (~1.0 single-pass, ~2.0 when outputs
            # are re-read for their sidecar).  Process-wide, like the
            # device-coalescer counters.
            "compaction": _compaction_stats_block(),
            # Secondary-index plane: runs built/merged at
            # flush/compaction time, planner hit/miss counters, and
            # quarantines.  The maintenance-cost ratio lives under
            # "compaction" (index_maintenance_amplification) next to
            # the read-amplification claim it rides on.
            "index": index_stats.stats(),
            "device_coalescer": _coalescer_stats(self.device),
            "dataplane": (
                self.dataplane.stats()
                if self.dataplane is not None
                else None
            ),
            # All-native serving path: the measurable claim — what
            # fraction of client data frames were answered without
            # entering the Python dispatcher, by verb group.
            "native_path": self._native_path_stats(),
            "quorum_fanout": (
                self.quorum_fanout.stats()
                if self.quorum_fanout is not None
                else None
            ),
            # Continuous telemetry plane: ring/rate summary +
            # the watchdog's machine-readable health verdict.  Ring
            # CONTENTS come back via the telemetry_dump verb; the
            # cluster-wide rollup via cluster_stats.
            "telemetry": self.telemetry.stats_block(),
            "health": self.telemetry.health_block(),
            "collections": collections,
        }

    def _membership_stats(self) -> dict:
        """get_stats.membership: the elastic-membership block.  The
        numeric leaves flatten into the telemetry ring (rates like
        keys_migrated_per_s and the migration_stall watchdog read
        them); arc_epochs is a list (dropped by flatten_stats) —
        observability for humans and the churn soak, not a trend."""
        max_rf = max(
            (
                c.replication_factor
                for c in self.collections.values()
            ),
            default=1,
        )
        try:
            arc_epochs = [
                [start, end, self.membership_epoch]
                for start, end, _peers in self.replica_arcs(max_rf)
            ]
        except Exception:  # pragma: no cover - stats must not raise
            arc_epochs = []
        return {
            "epoch": self.membership_epoch,
            "vnodes": self.config.vnodes,
            "tokens_self": len(self.tokens),
            "ring_tokens": len(self.shards),
            "arcs_owned": len(arc_epochs),
            "arc_epochs": arc_epochs,
            "migrations_started": self.migrations_started,
            "migrations_resumed": self.migrations_resumed,
            "migrations_cancelled": self.migrations_cancelled,
            "migrations_active": len(self._migration_tasks),
            "keys_migrated": self.keys_migrated,
            "bytes_migrated": self.bytes_migrated,
            "fence_refusals": self.fence_refusals,
        }

    def absorb_health_digest(self, digest) -> None:
        """Fold one per-node health digest (gossip piggyback, the
        periodic ``health`` event, or our own announce) into the
        cluster view — freshest (ts_ms, seq) wins, so re-propagated
        epidemic copies can never roll a node's entry backward."""
        if not isinstance(digest, dict):
            return
        node = digest.get("node")
        if not isinstance(node, str) or not node:
            return
        cur = self.cluster_view.get(node)
        if cur is not None:
            if cur.get("boot") and cur.get("boot") == digest.get(
                "boot"
            ):
                # Same incarnation: order by announce seq — a wall
                # clock stepping backwards on the sender must not pin
                # its stale digest cluster-wide until time catches up.
                if (cur.get("seq") or 0) >= (digest.get("seq") or 0):
                    return
            elif (cur.get("ts_ms") or 0, cur.get("seq") or 0) >= (
                (digest.get("ts_ms") or 0, digest.get("seq") or 0)
            ):
                # Cross-boot (restart): wall clock is the only shared
                # ordering left.
                return
        self.cluster_view[node] = digest
        if node == self.config.name:
            # Our own node's folded digest arriving via the local
            # gossip broadcast: sibling shards adopt it, so THEIR
            # cluster_stats (and their outgoing gossip piggybacks)
            # report the whole node, not just themselves.
            self.last_node_digest = digest

    def cluster_stats(self) -> dict:
        """The always-served ``cluster_stats`` admin verb: this
        node's view of every node's health digest (gossip-aggregated)
        — one call to ANY node answers for the whole cluster.  Nodes
        known to the ring but not yet heard from are listed under
        ``missing`` (telemetry off, old version, or just booted)."""
        view = dict(self.cluster_view)
        own = self.last_node_digest
        if own is not None:
            if (self.config.name not in view) or (
                (own.get("ts_ms") or 0)
                > (view[self.config.name].get("ts_ms") or 0)
            ):
                view[self.config.name] = own
        elif self.config.name not in view:
            # Telemetry disabled, or the first announce hasn't
            # reached this shard yet: answer with THIS shard's
            # on-demand digest so the caller always sees at least the
            # node it asked.  Never shadows an absorbed NODE digest —
            # an on-demand single-shard view would under-report the
            # node's other shards with an always-fresher ts_ms.
            view[self.config.name] = self.telemetry.merge_digests(
                self.config.name,
                [self.telemetry.shard_digest(self)],
                boot=self.boot_id,
            )
        known = {self.config.name} | set(self.nodes)
        return {
            "source": self.shard_name,
            "ts_ms": int(time.time() * 1000),
            "nodes": view,
            "nodes_known": len(known),
            "nodes_reporting": len(view),
            "missing": sorted(known - set(view)),
            "dead_nodes": sorted(self.dead_nodes),
        }

    def _native_path_stats(self) -> Optional[dict]:
        """Frames answered entirely in C vs everything this shard
        served, by verb group (set+delete share one C counter).
        Numerators: the C fast-path counters plus the native
        shed/deadline drops mirrored per verb; denominators: the
        request histograms, which count every client frame exactly
        once whichever path answered it.  RF>1 coordinator-assist ops
        are NOT in the numerator — their fan-out await runs in
        Python, so counting them would overstate the claim."""
        if self.dataplane is None:
            return None
        dp = self.dataplane.stats()
        drops = self.native_drops_by_op
        req = self.metrics.requests

        def total(*ops: str) -> int:
            return sum(req[o].count for o in ops if o in req)

        served = {
            "write": dp.get("fast_sets", 0)
            + drops.get("set", 0)
            + drops.get("delete", 0),
            "get": dp.get("fast_gets", 0)
            + dp.get("fast_table_gets", 0)
            + drops.get("get", 0),
            "multi_set": dp.get("fast_multi_sets", 0)
            + drops.get("multi_set", 0),
            "multi_get": dp.get("fast_multi_gets", 0)
            + drops.get("multi_get", 0),
        }
        totals = {
            "write": total("set", "delete"),
            "get": total("get"),
            "multi_set": total("multi_set"),
            "multi_get": total("multi_get"),
        }
        sum_served = sum(served.values())
        sum_total = sum(totals.values())
        return {
            "served": served,
            "totals": totals,
            "by_verb": {
                verb: (
                    round(min(1.0, served[verb] / totals[verb]), 4)
                    if totals[verb]
                    else None
                )
                for verb in served
            },
            "native_served_frac": (
                round(min(1.0, sum_served / sum_total), 4)
                if sum_total
                else None
            ),
            "native_sheds": dp.get("native_sheds", 0),
            "native_deadline_drops": dp.get(
                "native_deadline_drops", 0
            ),
            "python_sheds": self.governor.python_sheds,
            "crc_failures": dp.get("crc_failures", 0),
        }

    async def create_collection(
        self,
        name: str,
        replication_factor: int,
        quotas: "Optional[dict]" = None,
        index: "Optional[list]" = None,
    ) -> None:
        if name in self.collections:
            raise CollectionAlreadyExists(name)
        quotas = _sanitize_quotas(quotas)
        index = sanitize_index_fields(index)
        # Audited sync I/O: DDL is rare (operator-rate, gossiped once)
        # and the metadata file is tens of bytes — an executor hop
        # would cost more than the write.  The fsync CAN stall the
        # loop ~ms-scale on a slow disk; acceptable on this path.
        os.makedirs(self.config.dir, exist_ok=True)  # lint: allow(async-blocking)
        tree = self._create_lsm_tree(name, index_fields=index)
        path = self._collection_metadata_path(name)
        if not os.path.exists(path):
            meta = {"replication_factor": replication_factor}
            if quotas:
                # Per-collection quota overrides ride the same
                # metadata file, so a restart rediscovers them.
                meta["quotas"] = quotas
            if index:
                # Indexed-field DDL persists the same way
                # so a restart keeps maintaining the same runs.
                meta["index"] = index
            # lint: allow(async-blocking)
            with open(path, "wb") as f:
                f.write(msgpack_codec.packb(meta))
                f.flush()
                os.fsync(f.fileno())  # lint: allow(async-blocking)
        self.collections[name] = Collection(
            tree, replication_factor, quotas, index
        )
        if self.dataplane is not None:
            # RF=1: full client-plane fast path.  RF>1: replica plane
            # + coordinator assist; the client plane punts so Python
            # keeps the replication/consistency brain.  (register_tree
            # itself refuses replica-plane registration on a stale
            # .so without the client_ok ABI.)
            self.dataplane.register_tree(
                name, tree, client_plane=replication_factor == 1
            )
        self.collections_change_event.notify()
        self.flow.notify(FlowEvent.COLLECTION_CREATED)

    async def drop_collection(self, name: str) -> None:
        try:
            # Audited sync I/O: one unlink on the operator-rate DDL
            # path (see create_collection).
            os.unlink(self._collection_metadata_path(name))  # lint: allow(async-blocking)
        except OSError:
            pass
        col = self.collections.pop(name, None)
        if col is None:
            raise CollectionNotFound(name)
        if self.dataplane is not None:
            self.dataplane.unregister(name)
        await col.tree.purge()
        self.collections_change_event.notify()
        self.flow.notify(FlowEvent.COLLECTION_DROPPED)

    def get_collections_from_disk(
        self,
    ) -> List[Tuple[str, int, Optional[dict], Optional[list]]]:
        """Disk discovery by '<name>-<id>' directory scan
        (shards.rs:265-311); the third element is the DDL-carried
        per-collection quota override map (or None), the fourth the
        secondary-index field list (or None)."""
        if not os.path.isdir(self.config.dir):
            return []
        pattern = re.compile(rf"^(.*?)\-{self.id}$")
        out = []
        for entry in os.listdir(self.config.dir):
            m = pattern.match(entry)
            if not m or not os.path.isdir(
                os.path.join(self.config.dir, entry)
            ):
                continue
            name = m.group(1)
            meta_path = self._collection_metadata_path(name)
            try:
                with open(meta_path, "rb") as f:
                    meta = msgpack_codec.unpackb(f.read())
                out.append(
                    (
                        name,
                        meta["replication_factor"],
                        meta.get("quotas"),
                        meta.get("index"),
                    )
                )
            except FileNotFoundError:
                log.error(
                    "collection %r has no metadata file on disk", name
                )
        return out

    # ------------------------------------------------------------------
    # Local shard comm (shards.rs:398-460)
    # ------------------------------------------------------------------

    def sibling_connections(self) -> List[ShardConnection]:
        """Other shards of this node: asyncio queues when co-located in
        one process, loopback TCP in the per-core process launcher.
        One connection per PHYSICAL shard (vnode entries share it)."""
        seen: set = set()
        out: List[ShardConnection] = []
        for s in self.shards:
            if (
                s.node_name == self.config.name
                and s.name != self.shard_name
                and s.name not in seen
            ):
                seen.add(s.name)
                out.append(s.connection)
        return out

    async def _send_sibling_message(self, conn, message: list) -> None:
        if isinstance(conn, LocalShardConnection):
            await conn.send_message(self.id, message)
        else:
            await conn.send_event(message)

    async def _send_sibling_request(self, conn, request: list):
        if isinstance(conn, LocalShardConnection):
            return await conn.send_request(self.id, request)
        # Loopback TCP sibling (per-core process mode): tolerate the
        # startup bind race with brief retries before surfacing.
        last: Optional[Exception] = None
        for attempt in range(3):
            try:
                return await conn.send_request(request)
            except DbeelError as e:
                last = e
                await asyncio.sleep(0.2 * (attempt + 1))
        assert last is not None
        raise last

    async def broadcast_message_to_local_shards(self, message: list):
        # Per-sibling failures must not abort the whole broadcast (in
        # per-core process mode a sibling may still be binding).
        results = await asyncio.gather(
            *[
                self._send_sibling_message(c, message)
                for c in self.sibling_connections()
            ],
            return_exceptions=True,
        )
        for r in results:
            if isinstance(r, Exception):
                log.warning("sibling broadcast failed: %s", r)

    async def send_request_to_local_shards(
        self, request: list, expected_kind: str
    ) -> List:
        results = await asyncio.gather(
            *[
                self._send_sibling_request(c, request)
                for c in self.sibling_connections()
            ]
        )
        return [
            msgs.response_to_result(r, expected_kind) for r in results
        ]

    # ------------------------------------------------------------------
    # Replica fan-out (shards.rs:463-543)
    # ------------------------------------------------------------------

    # Hints per RANGE_PUSH frame during a drain (one bg_slice each).
    HINT_REPLAY_PAGE = 256

    def _record_hint(self, node_name: str, request: list) -> None:
        """Queue the (collection, key, ts) of a failed replica
        mutation for replay when the node returns.  Values are NOT
        stored: replay pushes this shard's CURRENT newest entry, so
        repeated overwrites dedup to one hint (newest ts kept) and
        one transfer."""
        if self.config.hint_ttl_ms <= 0:
            return
        kind = request[1] if len(request) > 1 else None
        changed = False
        if kind in (ShardRequest.SET, ShardRequest.DELETE):
            changed = self.hint_log.record(
                node_name,
                request[2],
                bytes(request[3]),
                int(request[5] if kind == ShardRequest.SET else request[4]),
            )
        elif kind == ShardRequest.MULTI_SET:
            col = request[2]
            for key, _value, ts in request[3]:
                changed |= self.hint_log.record(
                    node_name, col, bytes(key), int(ts)
                )
        else:
            return
        if changed:
            self.flow.notify(FlowEvent.HINT_RECORDED)

    def _node_shard_for_key(
        self, key_hash: int, node_name: str
    ) -> Optional[Shard]:
        """The shard of ``node_name`` that serves ``key_hash`` — the
        first shard of that node on the distinct-node replica walk
        (the same walk the client and owns_key use), i.e. the first
        of its shards at/after the hash on the sorted ring."""
        ring = self._hash_sorted
        if not ring:
            return None
        import bisect

        start = bisect.bisect_left(
            self._sorted_hashes, key_hash
        ) % len(ring)
        for off in range(len(ring)):
            s = ring[(start + off) % len(ring)]
            if s.node_name == node_name:
                return s
        return None

    async def replay_hints(self, node_name: str) -> None:
        """Drain this shard's queued hints for ``node_name``: page
        them out oldest-first, resolve each key to its CURRENT local
        newest entry, and push per-target-shard RANGE_PUSH batches
        (applied strictly-newer on the peer).  Bounded rate: each
        page runs under a bg_slice and the configured keys/sec
        ceiling paces consecutive pages."""
        if not self.hint_log.has(node_name):
            return
        rate = max(1, self.config.hint_drain_keys_per_sec)
        replayed = 0
        failed = False
        while not failed:
            page = self.hint_log.take_page(
                node_name, self.HINT_REPLAY_PAGE
            )
            if not page:
                break
            # Resolve hints to current entries, grouped by the target
            # node's serving shard for each key (multi-shard nodes:
            # the replica walk picks a specific shard per key).
            # Each batch keeps its source hints so a failed push can
            # requeue exactly what it owed.
            batches: Dict[str, list] = {}  # -> [shard, col, entries, hints]
            async with self.scheduler.bg_slice():
                for hint in page:
                    col_name, key, _ts, _created = hint
                    col = self.collections.get(col_name)
                    if col is None:
                        continue  # collection dropped: hint is moot
                    try:
                        entry = await col.tree.get_entry(bytes(key))
                    except DbeelError:
                        # Suspect local read (quarantine pending):
                        # keep the hint for a later drain.
                        self.hint_log.requeue(node_name, [hint])
                        failed = True
                        continue
                    if entry is None:
                        # Nothing to push (tombstone GC'd before the
                        # drain): anti-entropy owns the remainder.
                        self.hint_log.expired += 1
                        continue
                    shard = self._node_shard_for_key(
                        hash_bytes(bytes(key)), node_name
                    )
                    if shard is None:
                        failed = True  # node left the ring again
                        self.hint_log.requeue(node_name, [hint])
                        continue
                    value, local_ts = entry
                    batch = batches.setdefault(
                        f"{shard.name}/{col_name}",
                        [shard, col_name, [], []],
                    )
                    batch[2].append(
                        [bytes(key), bytes(value), int(local_ts)]
                    )
                    batch[3].append(hint)
            for shard, col_name, entries, hints in batches.values():
                if failed:
                    self.hint_log.requeue(node_name, hints)
                    continue
                try:
                    msgs.response_to_result(
                        await shard.connection.send_request(
                            ShardRequest.range_push(col_name, entries)
                        ),
                        ShardResponse.RANGE_PUSH,
                    )
                    replayed += len(entries)
                except (DbeelError, OSError) as e:
                    log.warning(
                        "hint replay to %s stopped after %d: %s",
                        node_name,
                        replayed,
                        e,
                    )
                    failed = True
                    # Untried/failed hints go back on the queue (node
                    # raced back down etc.) — never dropped.
                    self.hint_log.requeue(node_name, hints)
            if failed:
                break
            # Bounded drain rate.
            await asyncio.sleep(len(page) / rate)
        if replayed or not failed:
            # A COMPLETE drain persists the drop marker even when it
            # replayed nothing (everything TTL-expired / resolved to
            # absent entries) — without it, a restart resurrects the
            # dead records from the log.  Partial (failed) drains
            # skip the marker: its watermark would erase the
            # requeued survivors across a restart.
            self.hint_log.mark_drained(
                node_name, replayed, drop_marker=not failed
            )
        if replayed:
            log.info(
                "replayed %d hints to %s", replayed, node_name
            )
        self.flow.notify(FlowEvent.HINTS_REPLAYED)

    async def send_request_to_replicas(
        self,
        request: list,
        number_of_acks: int,
        number_of_nodes: int,
        expected_kind: str,
        op_status: Optional[dict] = None,
        key_hash: Optional[int] = None,
    ) -> List:
        """Send to the first ``number_of_nodes`` distinct-node remote
        shards on the ring (anchored at ``key_hash`` when given — see
        ``_replica_connections``); return after ``number_of_acks``
        successes, drain the rest in the background.  Failed mutations
        become hints for the unreachable node.  ``op_status`` (when
        given) collects failure context for the caller's error frame:
        ``peer_dead`` / ``peer_unreachable`` flags."""
        self._hint_departed(number_of_nodes, lambda: request)
        return await self._fan_out_to_replicas(
            lambda c: c.send_request(request),
            lambda resp: msgs.response_to_result(
                resp, expected_kind
            ),
            lambda: request,
            number_of_acks,
            number_of_nodes,
            connections=self._replica_connections(
                number_of_nodes, key_hash
            ),
            op_status=op_status,
        )

    async def send_packed_to_replicas(
        self,
        framed: bytes,
        number_of_acks: int,
        number_of_nodes: int,
        expected_ack: bytes,
        expected_kind: str,
        op_status: Optional[dict] = None,
        key_hash: Optional[int] = None,
    ) -> List:
        """send_request_to_replicas for a PRE-PACKED peer frame (the
        native coordinator's output): the frame bytes go out verbatim
        on each replica stream, and each raw response payload is
        byte-compared against ``expected_ack`` — msgpack unpacking
        happens only on mismatch (error responses) or when a failed
        replica's hint needs the request as a list.  When the native
        fan-out engine has live streams to every replica, the whole
        mechanism (socket writes, response reads, ack compare) runs
        in C (shards.rs:463-543 parity); the asyncio fan-out below is
        the always-available fallback."""
        hint_request_fn = lambda: msgs.unpack_message(framed[4:])  # noqa: E731
        self._hint_departed(number_of_nodes, hint_request_fn)
        connections = self._replica_connections(
            number_of_nodes, key_hash
        )
        if op_status is not None:
            # The walk targets, for PeerDead-vs-Timeout attribution
            # at the op deadline (db_server._quorum_error) — recorded
            # here so the native fan-out path carries them too.
            op_status["targets"] = [n for n, _c in connections]
        qf = self.quorum_fanout
        if (
            qf is not None
            # Traced ops keep the asyncio fan-out: the span needs
            # per-replica RTTs and the piggybacked replica stage
            # summaries, which the C engine's byte-compare path
            # doesn't surface.  Sampling is 1-in-N — the slow path
            # for sampled ops is the design, not a regression.
            and trace_mod.current() is None
            and all(
                not isinstance(c, LocalShardConnection)
                for _n, c in connections
            )
        ):
            fut = qf.try_submit(
                framed,
                connections,
                number_of_acks,
                expected_ack,
                expected_kind,
                hint_request_fn,
            )
            if fut is not None:
                return await fut

        def interpret(payload):
            # Traced fan-outs absorb the replica's piggybacked span
            # before interpretation and hand back an already-unpacked
            # list — accept both forms.
            if isinstance(payload, (bytes, bytearray)):
                if payload == expected_ack:
                    return None
                payload = msgs.unpack_message(payload)
            return msgs.response_to_result(payload, expected_kind)

        return await self._fan_out_to_replicas(
            lambda c: c.send_packed(framed),
            interpret,
            hint_request_fn,
            number_of_acks,
            number_of_nodes,
            connections=connections,
            op_status=op_status,
        )

    def _hint_departed(
        self, number_of_nodes: int, hint_request_fn
    ) -> None:
        """Record hints for departed (detector-removed) nodes that
        would sit in this mutation's replica set had they been alive.
        The live fan-out walks the SHRUNK ring (availability: the
        next distinct node genuinely owns the slot now), but the
        down node's copy must not silently stay stale until
        anti-entropy — the write's natural owner gets a hint, and the
        Alive-edge drain replays it the moment the node returns.

        Walk budget: ``number_of_nodes`` live slots PLUS one slot per
        departed node — a departed node occupies a replica slot
        without consuming the live budget, so a coordinator serving
        at replica_index>0 BECAUSE the primary is down (its remaining
        live fan-out may be zero nodes) still hints that primary.
        Slightly over-hints when a departed node sits just past the
        natural set (harmless: replay is an idempotent strictly-newer
        push, and cap+TTL bound it).  The walk is anchored at each
        KEY's hash (bisect into the merged ring), not at this
        coordinator's rotation front — under vnodes a departed node's
        many arcs each resolve to their true per-arc replica slots."""
        if (
            not self.departed_shards
            or self.config.hint_ttl_ms <= 0
        ):
            return
        request = hint_request_fn()
        kind = request[1] if len(request) > 1 else None
        if kind in (ShardRequest.SET, ShardRequest.DELETE):
            keys = [bytes(request[3])]
        elif kind == ShardRequest.MULTI_SET:
            keys = [bytes(k) for k, _v, _t in request[3]]
        else:
            return  # reads never hint
        # The merged ring: live + departed token entries, hash-sorted
        # with a parallel hash list for per-key bisect — the replica
        # walk of the UNSHRUNK ring, anchored at each key's own hash
        # (under vnodes a departed node owns many small arcs, and the
        # coordinator's rotation order says nothing about which arc a
        # key lands in).  Cached: rebuilt only when the ring or the
        # departed set changes.
        merged = self._merged_walk_cache
        if merged is None:
            entries = list(self.shards)
            for shards in self.departed_shards.values():
                entries.extend(shards)
            entries.sort(key=lambda s: (s.hash, s.name))
            merged = (entries, [s.hash for s in entries])
            self._merged_walk_cache = merged
        entries, hashes = merged
        if not entries:
            return
        budget = number_of_nodes + len(self.departed_shards)
        targets: set = set()
        for key in keys:
            start = bisect.bisect_left(
                hashes, hash_bytes(key)
            ) % len(entries)
            nodes: set = set()
            for off in range(len(entries)):
                if len(nodes) >= budget:
                    break
                s = entries[(start + off) % len(entries)]
                if (
                    s.node_name == self.config.name
                    or s.node_name in nodes
                ):
                    continue
                nodes.add(s.node_name)
                if s.node_name in self.departed_shards:
                    targets.add(s.node_name)
        # Deliberately NOT op_status["peer_dead"]: the live fan-out
        # may satisfy the quorum fine — a later deadline expiry on a
        # merely-slow LIVE peer must report Timeout, not PeerDead
        # (the flag is set only where a requested target actually
        # failed).  MULTI_SET hints the whole batch to every departed
        # target its keys touch (harmless over-hint: replay is an
        # idempotent strictly-newer push).
        for name in sorted(targets):
            self._record_hint(name, request)

    def _replica_connections(
        self,
        number_of_nodes: int,
        key_hash: Optional[int] = None,
    ) -> List[tuple]:
        """First ``number_of_nodes`` distinct-OTHER-node shards on the
        ring (the replica walk, shards.rs:463-497).  With ``key_hash``
        the walk is anchored at the key's own ring position (bisect
        into the hash-sorted ring) — required under vnodes, where a
        key may route to this shard via a secondary token and the
        rotation front (anchored at the PRIMARY token) would pick the
        wrong replica set.  Without it, the legacy rotation-front walk
        (identical to the anchored walk when every shard has one
        token and the key landed on this shard's own arc).

        The anchored walk collects the key's full distinct-node order
        and rotates PAST this node before truncating: a coordinator
        serving at replica_index>0 must fan to the replicas AFTER it
        in ring order (the earlier ones already failed the client),
        exactly what the rotation-front walk did for one token."""
        nodes: set = set()
        connections: List[tuple] = []
        if key_hash is None:
            for s in self.shards:
                # Replicas live on OTHER nodes (same-node shards may
                # be remote connections under the per-core process
                # launcher).
                if (
                    s.node_name == self.config.name
                    or s.node_name in nodes
                ):
                    continue
                nodes.add(s.node_name)
                connections.append((s.node_name, s.connection))
                if len(connections) >= number_of_nodes:
                    break
            return connections
        ring = self._hash_sorted
        if not ring:
            return connections
        start = bisect.bisect_left(
            self._sorted_hashes, key_hash
        ) % len(ring)
        ordered: List[tuple] = []  # full distinct-node walk order
        self_idx = None
        for off in range(len(ring)):
            s = ring[(start + off) % len(ring)]
            if s.node_name in nodes:
                continue
            nodes.add(s.node_name)
            if s.node_name == self.config.name:
                self_idx = len(ordered)
            ordered.append((s.node_name, s.connection))
        if self_idx is not None:
            ordered = (
                ordered[self_idx + 1:] + ordered[:self_idx]
            )
        return [
            (n, c)
            for n, c in ordered[:number_of_nodes]
            if n != self.config.name
        ]

    def _register_inflight(self, name: str, fut) -> None:
        self._inflight_by_node.setdefault(name, set()).add(fut)

    def _unregister_inflight(self, name: str, fut) -> None:
        futs = self._inflight_by_node.get(name)
        if futs is not None:
            futs.discard(fut)
            if not futs:
                self._inflight_by_node.pop(name, None)

    async def _fan_out_to_replicas(
        self,
        send_fn,
        interpret_fn,
        hint_request_fn,
        number_of_acks: int,
        number_of_nodes: int,
        connections: Optional[List[tuple]] = None,
        op_status: Optional[dict] = None,
    ) -> List:
        if connections is None:
            connections = self._replica_connections(number_of_nodes)
        if op_status is not None:
            op_status.setdefault(
                "targets", [name for name, _c in connections]
            )
        # Tracing plane: captured HERE (the caller's context) — the
        # fan-out body runs as a spawned task and must attribute its
        # per-replica RTTs / piggybacked spans to the op that asked.
        trace_ctx = trace_mod.current()

        result_future: asyncio.Future = (
            asyncio.get_event_loop().create_future()
        )

        async def fan_out():
            # A peer already marked Dead is failed on the spot: hint
            # and skip the dial — never a connect/read-timeout stall
            # (the detector-bounded blind window, failure_detector.rs
            # parity).  Normally ring removal keeps dead peers out of
            # the walk; this guard covers the race where the
            # connection list was snapshotted before the death mark.
            live = []
            for name, c in connections:
                if name in self.dead_nodes:
                    if op_status is not None:
                        op_status["peer_dead"] = True
                    log.warning(
                        "replica %s marked Dead: fast-fail", name
                    )
                    self._record_hint(name, hint_request_fn())
                else:
                    live.append((name, c))
            fut_node = {}
            fut_sent = {}
            for name, c in live:
                fut = asyncio.ensure_future(send_fn(c))
                fut_node[fut] = name
                fut_sent[fut] = time.monotonic()
                self._register_inflight(name, fut)
            pending = set(fut_node)

            def settle(fut) -> bool:
                """Interpret one finished future; True on ack."""
                name = fut_node[fut]
                self._unregister_inflight(name, fut)
                try:
                    payload = fut.result()
                    if trace_ctx is not None:
                        # Per-replica attribution: send→settle RTT
                        # plus the stage summary the replica
                        # piggybacked (stripped before interpret so
                        # the quorum brain sees the base frame).
                        payload = trace_ctx.absorb_peer(
                            name,
                            int(
                                (time.monotonic() - fut_sent[fut])
                                * 1e6
                            ),
                            payload,
                        )
                    results.append(interpret_fn(payload))
                    return True
                except asyncio.CancelledError:
                    # Cancelled by a mid-flight death mark
                    # (handle_dead_node): treat like unreachable.
                    if op_status is not None:
                        op_status["peer_dead"] = True
                    log.error(
                        "replica %s died mid-request: cancelled", name
                    )
                    self._record_hint(name, hint_request_fn())
                except (Timeout, ConnectionError_, Overloaded) as e:
                    # Unreachable replica — or one that SHED the
                    # request (its governor past the hard limit, its
                    # deadline check found the work already dead, or
                    # OUR capped outbound queue to it refused the
                    # send): either way the mutation did not land
                    # there, so it hands off to the hint path and the
                    # drain/anti-entropy converge it later.
                    if op_status is not None:
                        if isinstance(e, Overloaded):
                            op_status["peer_overloaded"] = True
                        else:
                            op_status["peer_unreachable"] = True
                    log.error("unreachable replica: %s", e)
                    self._record_hint(name, hint_request_fn())
                except DbeelError as e:
                    # Application-level error from a LIVE replica
                    # (e.g. CollectionNotFound during gossip
                    # propagation) — not a handoff case.
                    log.error(
                        "failed response from replica: %s", e
                    )
                except Exception as e:
                    # Anything else (garbled pooled-stream payload
                    # blowing up interpret_fn, etc.): log and keep
                    # settling — one bad response must not abort the
                    # drain and strand the other stragglers unhinted.
                    log.error("replica response failed: %s", e)
                return False

            results: List = []
            acks = 0
            try:
                # Like the reference (shards.rs:500-528): gather up to
                # number_of_acks successes; when replicas run out early,
                # return what we have rather than erroring.
                while pending and acks < number_of_acks:
                    done, pending = await asyncio.wait(
                        pending, return_when=asyncio.FIRST_COMPLETED
                    )
                    for fut in done:
                        if settle(fut):
                            acks += 1
            finally:
                if not result_future.done():
                    result_future.set_result(results)
            # Drain stragglers in the background (shards.rs:530-539).
            for fut in pending:
                try:
                    await asyncio.wait({fut})
                except asyncio.CancelledError:
                    # The fan-out TASK itself is being cancelled
                    # (shard shutdown): stop draining.
                    raise
                settle(fut)

        self.spawn(fan_out())
        return await result_future

    def spawn(self, coro) -> asyncio.Task:
        """Detached background task tied to this shard."""
        task = asyncio.ensure_future(coro)
        self._background_tasks.add(task)
        task.add_done_callback(self._background_tasks.discard)
        return task

    # ------------------------------------------------------------------
    # Message dispatch (shards.rs:695-790)
    # ------------------------------------------------------------------

    async def handle_shard_message(
        self, message: list
    ) -> Optional[list]:
        tag = message[0]
        if tag == "event":
            await self.handle_shard_event(message)
            return None
        if tag == "request":
            try:
                return await self.handle_shard_request(message)
            except DbeelError as e:
                return ShardResponse.error(e)
        return None

    async def handle_shard_event(self, event: list) -> None:
        kind = event[1]
        if kind == ShardEvent.GOSSIP:
            await self.handle_gossip_event(event[2])
        elif kind == ShardEvent.SET:
            _, _, collection, key, value, ts = event
            await self.handle_shard_set_message(
                collection, bytes(key), bytes(value), ts
            )

    async def handle_shard_set_message(
        self, collection: str, key: bytes, value: bytes, ts: int
    ) -> None:
        col = self.get_collection(collection)
        if ts <= col.tree.max_flushed_ts or not (
            await col.tree.set_with_timestamp(
                key, value, ts, stale_abort=True
            )
        ):
            # A delayed/replayed write (hint replay, late replica
            # frame, migration stream) no newer than the flushed
            # layers: blind memtable insert would put the OLDER ts in
            # a NEWER layer and first-match point reads would serve
            # it — apply read-guarded instead.  stale_abort closes
            # the race where a capacity wait spans a flush swap that
            # advances the watermark past ts.
            await self.apply_if_newer(col.tree, key, value, ts)
        self.flow.notify(FlowEvent.ITEM_SET_FROM_SHARD_MESSAGE)

    # Position of the OPTIONAL trailing wall-clock deadline (ms) a
    # coordinator appends to data-op peer frames (deadline
    # propagation).  Old-dialect frames simply lack the element.
    _PEER_DEADLINE_INDEX = {
        ShardRequest.SET: 6,
        ShardRequest.DELETE: 5,
        ShardRequest.GET: 4,
        ShardRequest.GET_DIGEST: 4,
        ShardRequest.MULTI_SET: 4,
        ShardRequest.MULTI_GET: 4,
    }

    # Position of the OPTIONAL trailing trace id (tracing plane,): always exactly one slot past the deadline (a sampled
    # frame with no real budget carries a 0 deadline placeholder, so
    # the trace slot never shifts).  The wire-parity lint pins each
    # entry to deadline_index + 1 and checks the C parser's
    # trace-dialect (`want + 2`) handling in lockstep.
    _PEER_TRACE_INDEX = {
        ShardRequest.SET: 7,
        ShardRequest.DELETE: 6,
        ShardRequest.GET: 5,
        ShardRequest.GET_DIGEST: 5,
        ShardRequest.MULTI_SET: 5,
        ShardRequest.MULTI_GET: 5,
    }

    # Position of the OPTIONAL trailing QoS class id (QoS plane):
    # always exactly one slot past the trace id (frames
    # with a qos element carry 0 placeholders for an absent deadline
    # and trace, so the slot never shifts).  The wire-parity lint
    # pins each entry to trace_index + 1 and checks the C parser's
    # qos-dialect (`want + 3`) recognition in lockstep.  Old-dialect
    # frames simply lack the element (class = standard).
    _PEER_QOS_INDEX = {
        ShardRequest.SET: 8,
        ShardRequest.DELETE: 7,
        ShardRequest.GET: 6,
        ShardRequest.GET_DIGEST: 6,
        ShardRequest.MULTI_SET: 6,
        ShardRequest.MULTI_GET: 6,
    }

    # Fixed arity of the SCAN peer frame (scan plane; spec
    # element appended by the query compute plane; qos class
    # appended by the QoS plane):
    # ["request","scan",collection,start,end,start_after,prefix,
    #  limit,max_bytes,with_values,spec,qos].  No trailing deadline/
    # trace dialects — scan pages ride pooled round trips like the
    # RANGE_* family (the chunk-level deadline lives on the CLIENT
    # frame); old-arity frames (no spec and/or no qos) are accepted.
    # Lint-pinned against the encoder and both C sources
    # (analysis/wire_parity.py; native kScanPeerArity).
    _SCAN_PEER_ARITY = 12

    # WATCH_FEED peer frame arity (watch/CDC plane):
    # [request, watch_feed, collection, boot_epoch, after_seq,
    #  ranges, limit, max_bytes, spec, qos].  Feed pages ride pooled
    # round trips like SCAN.  Lint-pinned against the encoder
    # (analysis/wire_parity.py); the C planes have no watch tokens —
    # an old .so falls through to this interpreted branch.
    _WATCH_PEER_ARITY = 10

    @classmethod
    def peer_qos_class(cls, request) -> int:
        """QoS class a coordinator stamped on this data-op peer frame
        (QoS plane); STANDARD when absent (old dialect) or
        malformed — an unknown stamp degrades to the default lane."""
        from . import qos as qos_mod

        if (
            not isinstance(request, (list, tuple))
            or len(request) < 2
            or request[0] != "request"
        ):
            return qos_mod.QOS_STANDARD
        idx = cls._PEER_QOS_INDEX.get(request[1])
        if idx is None or len(request) <= idx:
            return qos_mod.QOS_STANDARD
        return qos_mod.class_of(request[idx])

    @classmethod
    def peer_trace_id(cls, request) -> Optional[int]:
        """Trace id a coordinator stamped on this peer frame, or None.
        A replica serving a traced frame piggybacks its own stage
        summary (a few u32 micros) on the response so the
        coordinator's span decomposes end to end."""
        if (
            not isinstance(request, (list, tuple))
            or len(request) < 2
            or request[0] != "request"
        ):
            return None
        idx = cls._PEER_TRACE_INDEX.get(request[1])
        if idx is None or len(request) <= idx:
            return None
        tid = request[idx]
        if isinstance(tid, int) and tid > 0:
            return tid
        return None

    def _peer_deadline_expired(self, request: list) -> bool:
        """True when the frame carries a propagated deadline that has
        already passed: the coordinator's client gave up — computing
        the response would burn replica CPU on a dead answer.  Wall
        clock, like the LWW timestamps (same loose-sync caveat)."""
        idx = self._PEER_DEADLINE_INDEX.get(request[1])
        if idx is None or len(request) <= idx:
            return False
        deadline_ms = request[idx]
        if not isinstance(deadline_ms, int) or deadline_ms <= 0:
            return False
        import time as _time

        if _time.time() * 1000.0 <= deadline_ms:
            return False
        self.governor.replica_deadline_drops += 1
        return True

    async def handle_shard_request(self, request: list) -> list:
        kind = request[1]
        if kind in self._PEER_DEADLINE_INDEX:
            # QoS plane: account the propagated class so a bulk
            # load's replica-side writes are visible in the batch
            # lane cluster-wide.  Accounting only — the peer plane
            # never sheds (replica work keeps quorums alive).
            self.qos.note_peer(self.peer_qos_class(request))
        if kind in self._PEER_DEADLINE_INDEX and (
            self._peer_deadline_expired(request)
        ):
            # Deadline propagation: drop dead work instead of
            # computing it.  The error is retryable; for mutations the
            # coordinator's fan-out records a hint, so convergence
            # still owns the write (settle() treats Overloaded like an
            # unreachable replica).
            raise Overloaded(
                "deadline expired before the replica served it"
            )
        if kind == ShardRequest.PING:
            return ShardResponse.pong()
        if kind == ShardRequest.TELEMETRY_DIGEST:
            # Telemetry plane: intra-node aggregation — the managing
            # shard folds sibling digests into the per-node digest it
            # gossips.  Cheap (ring reads only), never sheds.
            return ShardResponse.telemetry_digest(
                self.telemetry.shard_digest(self)
            )
        if kind == ShardRequest.REARM:
            await self.rearm()
            return ShardResponse.empty(ShardResponse.REARM)
        if kind == ShardRequest.GET_METADATA:
            return ShardResponse.get_metadata(self.get_nodes())
        if kind == ShardRequest.GET_COLLECTIONS:
            # Tail dialect mirrors the CREATE_COLLECTION frame: quotas
            # at slot 2 (None placeholder when only an index is set),
            # index field list at slot 3.  Short entries stay short so
            # older peers parse them unchanged.
            entries = []
            for n, c in self.collections.items():
                e = [n, c.replication_factor]
                if c.quotas or c.index_fields:
                    e.append(c.quotas if c.quotas else None)
                if c.index_fields:
                    e.append(c.index_fields)
                entries.append(tuple(e))
            return ShardResponse.get_collections(entries)
        if kind == ShardRequest.CREATE_COLLECTION:
            # Optional 5th element: per-collection quota overrides
            # (old-arity frames from older peers are accepted);
            # optional 6th: secondary-index field list.
            await self.create_collection(
                request[2],
                request[3],
                request[4] if len(request) > 4 else None,
                request[5] if len(request) > 5 else None,
            )
            return ShardResponse.empty(ShardResponse.CREATE_COLLECTION)
        if kind == ShardRequest.DROP_COLLECTION:
            await self.drop_collection(request[2])
            return ShardResponse.empty(ShardResponse.DROP_COLLECTION)
        if kind == ShardRequest.SET:
            await self.handle_shard_set_message(
                request[2], bytes(request[3]), bytes(request[4]), request[5]
            )
            return ShardResponse.empty(ShardResponse.SET)
        if kind == ShardRequest.DELETE:
            col = self.collections.get(request[2])
            if col is not None:
                ts = request[4]
                if ts <= col.tree.max_flushed_ts or not (
                    await col.tree.set_with_timestamp(
                        bytes(request[3]), TOMBSTONE, ts,
                        stale_abort=True,
                    )
                ):
                    await self.apply_if_newer(
                        col.tree, bytes(request[3]), TOMBSTONE, ts
                    )
            return ShardResponse.empty(ShardResponse.DELETE)
        if kind == ShardRequest.MULTI_SET:
            # Batched replica mutations (one peer frame per client
            # batch): apply under the same watermark discipline as
            # single SETs — fresh entries batch-insert (one WAL
            # append_batch / one sync ticket), stale or race-rejected
            # ones fall back to the read-guarded apply.
            col = self.get_collection(request[2])
            entries = [
                (bytes(k), bytes(v), int(ts))
                for k, v, ts in request[3]
            ]
            wm = col.tree.max_flushed_ts
            fresh = [e for e in entries if e[2] > wm]
            stale = [e for e in entries if e[2] <= wm]
            if fresh:
                stale.extend(
                    await col.tree.set_batch_with_timestamp(
                        fresh, stale_abort=True
                    )
                )
            for k, v, ts in stale:
                await self.apply_if_newer(col.tree, k, v, ts)
            if entries:
                self.flow.notify(FlowEvent.ITEM_SET_FROM_SHARD_MESSAGE)
            return ShardResponse.empty(ShardResponse.MULTI_SET)
        if kind == ShardRequest.MULTI_GET:
            col = self.collections.get(request[2])
            keys = [bytes(k) for k in request[3]]
            if col is None:
                return ShardResponse.multi_get([None] * len(keys))
            found = await col.tree.multi_get(keys)
            if col.tree.reads_suspect and any(
                found.get(k) is None for k in keys
            ):
                self._raise_suspect_miss()
            return ShardResponse.multi_get(
                [found.get(k) for k in keys]
            )
        if kind == ShardRequest.GET:
            col = self.collections.get(request[2])
            entry = None
            if col is not None:
                entry = await col.tree.get_entry(bytes(request[3]))
                if entry is None and col.tree.reads_suspect:
                    self._raise_suspect_miss()
            return ShardResponse.get(entry)
        if kind == ShardRequest.GET_DIGEST:
            # Digest read (quorum-get fast path): answer (ts, value
            # hash) only — canonical bytes, so an agreeing replica's
            # response byte-matches the coordinator's prediction and
            # never needs unpacking (fan-out engine compares in C).
            col = self.collections.get(request[2])
            entry = None
            if col is not None:
                entry = await col.tree.get_entry(bytes(request[3]))
                if entry is None and col.tree.reads_suspect:
                    self._raise_suspect_miss()
            return ShardResponse.get_digest(entry)
        if kind == ShardRequest.RANGE_DIGEST:
            col = self.collections.get(request[2])
            # Clamp both sides: nb sizes two local allocations, so an
            # unbounded peer-supplied count would be an OOM lever on
            # the network-facing port.
            nb = int(request[5]) if len(request) > 5 else 1
            nb = max(1, min(nb, 65536))
            counts, digests = [0] * nb, [0] * nb
            if col is not None:
                # Peer-side anti-entropy scans are background work too:
                # they must defer to this shard's own serving traffic.
                async with self.scheduler.bg_slice():
                    counts, digests = await self.compute_range_digests(
                        col.tree, request[3], request[4], nb
                    )
            return ShardResponse.range_digest(counts, digests)
        if kind == ShardRequest.RANGE_PULL:
            col = self.collections.get(request[2])
            entries: list = []
            if col is not None:
                buckets = None
                nb = 0
                if len(request) > 8 and request[7] is not None:
                    buckets = {int(b) for b in request[7]}
                    nb = int(request[8])
                async with self.scheduler.bg_slice():
                    entries = await self.collect_range_page(
                        col.tree,
                        request[3],
                        request[4],
                        bytes(request[5])
                        if request[5] is not None
                        else None,
                        int(request[6]),
                        buckets,
                        nb,
                    )
            return ShardResponse.range_pull(entries)
        if kind == ShardRequest.SCAN:
            # Streaming scan page (scan plane): one ordered,
            # byte-bounded page of this shard's entries in the arc —
            # served by the vectorized ScanStage (per-entry fallback),
            # tombstones included so the coordinator merge can
            # suppress stale live values.  Deliberately NOT under
            # scheduler.bg_slice: the chunk was already admitted and
            # paced by the COORDINATOR's governor (shed at hard, park
            # at soft, byte-budgeted slices), and the unit payback would
            # throttle the scan against its own chunk frames' fg
            # marks (measured: 4x idle per page).  Page cost is
            # bounded by the byte clamp + cooperative yields inside
            # scan_page.  Clamps mirror RANGE_PULL's: peer-supplied
            # sizes must not become allocation levers.
            col = self.collections.get(request[2])
            entries: list = []
            more = False
            if col is None:
                return ShardResponse.scan(entries, more)
            start_after = (
                bytes(request[5])
                if request[5] is not None
                else None
            )
            prefix = bytes(request[6]) if request[6] else None
            limit = max(1, min(int(request[7]), 65536))
            max_bytes = max(
                4096, min(int(request[8]), 16 << 20)
            )
            spec = request[10] if len(request) > 10 else None
            # QoS plane: scan pages account in the stamped lane
            # (batch by default — old-arity frames lack the element).
            from . import qos as qos_mod

            self.qos.note_peer(
                qos_mod.class_of(request[11])
                if len(request) > 11
                else qos_mod.QOS_BATCH
            )
            if spec is not None:
                # Query compute plane: predicate/aggregate
                # pushdown over the staged columns.  The peer spec
                # is re-validated HERE — it crossed a network — and
                # a malformed one raises the clean BadFieldType the
                # coordinator relays, never a shard death.
                from .. import query as Q

                where, agg, mode = Q.unpack_peer_spec(spec)
                (
                    entries,
                    more,
                    cover,
                    scanned_rows,
                    scanned_bytes,
                    partial,
                    eval_path,
                ) = await col.tree.scan_filter_page(
                    int(request[3]),
                    int(request[4]),
                    start_after,
                    prefix,
                    limit,
                    max_bytes,
                    bool(request[9]),
                    where,
                    agg,
                    mode,
                )
                if eval_path == "device":
                    self.scan_plane.device_evals += 1
                elif eval_path == "indexed":
                    self.scan_plane.indexed_evals += 1
                elif eval_path in ("numpy", "golden"):
                    self.scan_plane.fallback_evals += 1
                if partial is not None:
                    self.scan_plane.agg_partials += 1
                return ShardResponse.scan(
                    entries,
                    more,
                    cover,
                    scanned_rows,
                    scanned_bytes,
                    partial,
                )
            entries, more = await col.tree.scan_page(
                int(request[3]),
                int(request[4]),
                start_after,
                prefix,
                limit,
                max_bytes,
                bool(request[9]),
            )
            return ShardResponse.scan(entries, more)
        if kind == ShardRequest.WATCH_FEED:
            # Watch/CDC plane: one change-ring page —
            # events strictly after the coordinator's (boot, seq)
            # position, filtered to the collection / hash ranges /
            # optional spec.  Served off the in-memory ring with an
            # O(1) empty fast path (no storage I/O, no bg_slice);
            # clamps mirror SCAN's so peer-supplied sizes never
            # become allocation levers.  An unknown collection is
            # answered as an empty at-tail page (status 0): watch
            # interest can reach a replica before the collection's
            # create gossip does.
            from . import qos as qos_mod

            self.qos.note_peer(
                qos_mod.class_of(request[9])
                if len(request) > 9
                else qos_mod.QOS_BATCH
            )
            # Watched collections must not serve writes natively:
            # sticky-suspend this replica's fast path the moment
            # feed interest lands (see WatchPlane.suspend_native).
            self.watch_plane.suspend_native(request[2])
            ranges = (
                [[int(r[0]), int(r[1])] for r in request[5]]
                if request[5]
                else None
            )
            limit = max(1, min(int(request[6]), 65536))
            max_bytes = max(
                4096, min(int(request[7]), 16 << 20)
            )
            spec = request[8] if len(request) > 8 else None
            events, boot_epoch, tail_seq, status = (
                self.watch_plane.feed_page(
                    request[2],
                    int(request[3]),
                    int(request[4]),
                    ranges,
                    limit,
                    max_bytes,
                    bytes(spec) if spec is not None else None,
                )
            )
            return ShardResponse.watch_feed(
                events, boot_epoch, tail_seq, status
            )
        if kind == ShardRequest.RANGE_PUSH:
            col = self.collections.get(request[2])
            if col is None:
                raise CollectionNotFound(request[2])
            pushed_any = False
            async with self.scheduler.bg_slice():
                for key, value, ts in request[3]:
                    if await self.apply_if_newer(
                        col.tree, bytes(key), bytes(value), int(ts)
                    ):
                        # Convergence accounting: hint replays and AE
                        # pushes land here — every key this shard was
                        # missing (or held stale) counts once.
                        self.keys_healed += 1
                        pushed_any = True
            if pushed_any:
                # The items WERE set from a shard message: fire the
                # same milestone the Set-frame path fires, so tests
                # waiting on replicated writes stay event-driven.
                self.flow.notify(FlowEvent.ITEM_SET_FROM_SHARD_MESSAGE)
            return ShardResponse.empty(ShardResponse.RANGE_PUSH)
        raise DbeelError(f"unknown shard request {kind!r}")

    @staticmethod
    def _raise_suspect_miss() -> None:
        """A replica-plane miss on a tree with a quarantine pending
        repair is unproven (the key may have lived in the dropped
        table): answer the coordinator with a retryable error frame
        instead of a confident absence it would merge as truth."""
        from ..errors import CorruptedFile

        raise CorruptedFile(
            "replica miss is suspect: quarantined table pending repair"
        )

    # ------------------------------------------------------------------
    # Anti-entropy primitives (no reference analog — SURVEY §5 lists
    # anti-entropy as a gap in the reference's replication design,
    # alongside hinted handoff and read repair, both also added here)
    # ------------------------------------------------------------------

    @staticmethod
    def _merge_adjacent_arcs(
        arcs: List[list],
    ) -> List[Tuple[int, int, List[Shard]]]:
        """Merge ring-adjacent arcs with identical shard-name sets
        (arcs arrive in sorted-ring order, so arc i's end is arc
        i+1's start; the (last, first) pair wraps)."""
        merged: List[list] = []
        for arc in arcs:
            if (
                merged
                and merged[-1][1] == arc[0]
                and {s.name for s in merged[-1][2]}
                == {s.name for s in arc[2]}
            ):
                merged[-1][1] = arc[1]
            else:
                merged.append(arc)
        if (
            len(merged) > 1
            and merged[-1][1] == merged[0][0]
            and {s.name for s in merged[-1][2]}
            == {s.name for s in merged[0][2]}
        ):
            merged[0][0] = merged[-1][0]
            merged.pop()
        return [(s, e, p) for s, e, p in merged]

    def all_arcs(
        self, rf: int
    ) -> List[Tuple[int, int, List[Shard]]]:
        """EVERY ring arc with its full rf-distinct-node replica
        shard set, as (start, end, selected_shards) — the whole-ring
        generalization of ``replica_arcs`` the streaming scan plane
        merges across: for every arc, ``selected_shards`` are the
        shards (possibly including THIS one) the distinct-node walk
        from the arc's owning ring point selects.  Bounds are
        +1-shifted half-open [start, end); start == end means the
        whole ring.  Adjacent arcs with identical shard sets merge."""
        ring = self._hash_sorted
        n = len(ring)
        if n == 0:
            return []
        shifted = (ring[0].hash + 1) & 0xFFFFFFFF
        if n == 1:
            return [(shifted, shifted, [ring[0]])]
        arcs: List[list] = []
        for i in range(n):
            # Arc (ring[i-1].hash, ring[i].hash]: the walk starts at
            # ring[i] (first shard at/after every hash in the arc).
            nodes: set = set()
            selected: List[Shard] = []
            for off in range(n):
                s = ring[(i + off) % n]
                if s.node_name in nodes:
                    continue
                nodes.add(s.node_name)
                selected.append(s)
                if len(nodes) >= rf:
                    break
            arcs.append(
                [
                    (ring[i - 1].hash + 1) & 0xFFFFFFFF,
                    (ring[i].hash + 1) & 0xFFFFFFFF,
                    selected,
                ]
            )
        return self._merge_adjacent_arcs(arcs)

    def replica_arcs(
        self, rf: int
    ) -> List[Tuple[int, int, List[Shard]]]:
        """The EXACT owned-range union for this shard under the
        distinct-node replica walk, as (start, end, peer_shards)
        arcs: for every ring arc, the walk from the arc's owning
        ring point selects one shard per distinct node until ``rf``
        nodes; arcs where THIS shard is selected are owned, and
        ``peer_shards`` are the other selected shards (the replicas
        that must agree with us over that arc).

        Bounds come back +1-shifted into the half-open [start, end)
        form the anti-entropy filters take; start == end means the
        whole ring.  Adjacent arcs with identical peer sets merge,
        so the common single-shard-per-node ring costs ~rf arcs.

        Replaces the (rf-th-distinct-predecessor, self] arc, which
        under interleaved multi-shard nodes over-approximates the
        union (ROADMAP open item) — importing ranges this shard can
        never serve and missing none, but paying transfer for them.
        Shared by quarantine repair, the background anti-entropy
        loop, and (via ``all_arcs``) the scan plane's merge, so their
        notion of "what a shard stores" can never diverge.
        Held equal to dbeel_tpu's under hypothesis in
        tests/test_torch_shard.py."""
        ring = self._hash_sorted
        n = len(ring)
        shifted_self = (self.hash + 1) & 0xFFFFFFFF
        if n < 2:
            return [(shifted_self, shifted_self, [])]
        arcs: List[list] = []
        for start, end, selected in self.all_arcs(rf):
            if not any(s.name == self.shard_name for s in selected):
                continue
            peers = [
                s
                for s in selected
                if s.name != self.shard_name
                and s.node_name != self.config.name
            ]
            arcs.append([start, end, peers])
        return self._merge_adjacent_arcs(arcs)

    @staticmethod
    async def apply_if_newer(
        tree, key: bytes, value: bytes, ts: int
    ) -> bool:
        """Write (key, value, ts) only if strictly newer than the local
        newest for that key (checks sstables too, not just the
        memtable).  The anti-entropy apply primitive: a replayed old
        entry must never shadow a newer value that was already flushed
        out of the memtable."""
        while True:
            local = await tree.get_entry(key)
            if local is not None and local[1] >= ts:
                return False
            # Close the probe/write race: a concurrent client write
            # may have landed during get_entry's awaits (and even been
            # swapped to the flushing memtable).  Re-probe the
            # memtables with NO awaits between this check and
            # set_with_timestamp's synchronous memtable insert.
            watermark = tree.max_flushed_ts
            newest = tree.newest_memtable_ts(key)
            if newest is not None and newest >= ts:
                return False
            if await tree.set_with_timestamp(
                key, value, ts, stale_abort_from=watermark
            ):
                return True
            # A capacity wait inside the insert spanned a flush swap
            # that advanced the watermark past ts (the last
            # stale-shadow window): the probe above
            # is stale — re-probe against the newly flushed layers
            # and retry.  Terminates: each extra round requires a NEW
            # swap during the insert.

    @staticmethod
    def _in_ae_range(h: int, start: int, end: int) -> bool:
        """Anti-entropy range membership.  ``start``/``end`` are the
        primary ownership range (prev, self] pre-shifted by +1 into
        half-open [start, end) form; start == end means the shard's
        single ring point covers the whole ring."""
        from .migration import _between

        return start == end or _between(h, start, end)

    @staticmethod
    def _ae_bucket_of(h: int, start: int, end: int, nbuckets: int) -> int:
        """Sub-range bucket (0..nbuckets-1) of an in-range hash: the
        wrap range [start, end) is split into nbuckets equal slices.
        Both digest sides and the pull filter use THIS function, so
        bucket membership can never disagree across peers."""
        width = (end - start) & 0xFFFFFFFF
        if width == 0:
            width = 1 << 32  # single ring point: the whole ring
        d = (h - start) & 0xFFFFFFFF
        return min(nbuckets - 1, (d * nbuckets) // width)

    @staticmethod
    async def compute_range_digests(
        tree, start: int, end: int, nbuckets: int = 1
    ) -> Tuple[list, list]:
        """Order-independent 64-bit digests over (key, newest-ts) pairs
        in the anti-entropy range, one per hash sub-range bucket (a
        flat merkle layer: ONE scan fills all buckets).  Tombstones
        count (their deletions must converge too).

        Big trees take the vectorized path (storage/range_digest.py):
        bulk column reads + native murmur batches on an executor
        thread, ~20× cheaper than this method's per-entry fallback
        and golden-tested equal."""
        from ..storage import range_digest as rd

        total = tree.memtable_entries + tree.sstable_entry_count()
        if total >= rd.MIN_VECTORIZED_ENTRIES:
            snap = tree.scan_snapshot()
            try:
                res = await asyncio.get_event_loop().run_in_executor(
                    None,
                    rd.vectorized_range_digests,
                    snap.memtable_items,
                    snap.tables,
                    start,
                    end,
                    nbuckets,
                )
            except CorruptedFile as e:
                # Bulk-scan corruption: quarantine the source table
                # (the .path-attribution pattern of the compaction
                # merge) so repair starts NOW, then re-raise — the
                # AE loop skips this arc for the round.
                tree.quarantine_by_exception(e, snap.tables)
                raise
            finally:
                snap.release()
            if res is not None:
                return res

        from ..utils.murmur import murmur3_32

        newest: Dict[bytes, Tuple[int, int]] = {}  # key -> (ts, hash)
        # One hash per entry: range membership is checked in the loop
        # body (the filter lambda would hash a second time) and the
        # hash is carried into aggregation for the bucket derivation.
        async for key, _value, ts in tree.iter_filter(None):
            h = hash_bytes(key)
            if not MyShard._in_ae_range(h, start, end):
                continue
            prev = newest.get(key)
            if prev is None or ts > prev[0]:
                newest[key] = (ts, h)
        counts = [0] * nbuckets
        digests = [0] * nbuckets
        for key, (ts, h) in newest.items():
            b = MyShard._ae_bucket_of(h, start, end, nbuckets)
            blob = key + ts.to_bytes(8, "little", signed=True)
            counts[b] += 1
            digests[b] ^= murmur3_32(blob, 0x0A57E4A1) | (
                murmur3_32(blob, 0x51C6E57A) << 32
            )
        return counts, digests

    @staticmethod
    async def collect_range_entries(
        tree,
        start: int,
        end: int,
        start_after: Optional[bytes] = None,
        buckets: Optional[set] = None,
        nbuckets: int = 0,
    ) -> list:
        """ALL (key, value, newest-ts) triples in the anti-entropy
        range with key > start_after, ascending by key; with
        ``buckets``, only entries in those hash sub-range buckets.
        The push side calls this once and pages from the result; the
        stateless RANGE_PULL server pays one scan per page (keys <=
        start_after are filtered during the scan, so later pages dedup
        less)."""
        newest: Dict[bytes, Tuple[bytes, int]] = {}
        async for key, value, ts in tree.iter_filter(None):
            if start_after is not None and key <= start_after:
                continue
            h = hash_bytes(key)  # once per entry: range AND bucket
            if not MyShard._in_ae_range(h, start, end):
                continue
            if buckets is not None and (
                MyShard._ae_bucket_of(h, start, end, nbuckets)
                not in buckets
            ):
                continue
            prev = newest.get(key)
            if prev is None or ts > prev[1]:
                newest[key] = (value, ts)
        return [
            [k, v, ts] for k, (v, ts) in sorted(newest.items())
        ]

    @staticmethod
    async def collect_range_page(
        tree,
        start: int,
        end: int,
        start_after: Optional[bytes],
        limit: int,
        buckets: Optional[set] = None,
        nbuckets: int = 0,
    ) -> list:
        """Up to ``limit`` entries with key > start_after (the
        stateless remote paging entry point)."""
        entries = await MyShard.collect_range_entries(
            tree, start, end, start_after, buckets, nbuckets
        )
        return entries[:limit]

    # ------------------------------------------------------------------
    # Gossip (shards.rs:791-827, 1131-1200)
    # ------------------------------------------------------------------

    async def gossip(self, event: list) -> None:
        await self.broadcast_message_to_local_shards(
            ShardEvent.gossip(event)
        )
        buf = msgs.serialize_gossip_message(
            f"{self.config.name}#{self.boot_id}",
            event,
            # Telemetry plane: every outgoing gossip frame carries
            # this node's freshest health digest — membership/DDL
            # traffic keeps remote cluster_stats views warm for free.
            self.last_node_digest,
        )
        await self.gossip_buffer(buf)

    async def gossip_buffer(self, buf: bytes) -> None:
        """Fire-and-forget UDP to gossip_fanout random nodes."""
        import random

        nodes = list(self.nodes.values())
        random.shuffle(nodes)
        targets = nodes[: self.config.gossip_fanout]
        for node in targets:
            await self._gossip_send(buf, node)

    async def _gossip_send(self, buf: bytes, node) -> None:
        loop = asyncio.get_event_loop()
        try:
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.setblocking(False)
            if hasattr(loop, "sock_sendto"):
                await loop.sock_sendto(
                    sock, buf, (node.ip, node.gossip_port)
                )
            else:
                # py3.10: loop.sock_sendto doesn't exist.  A UDP
                # sendto on a non-blocking socket never blocks —
                # it either queues the datagram or drops it
                # (EAGAIN), and gossip is fire-and-forget.
                sock.sendto(buf, (node.ip, node.gossip_port))
            sock.close()
        except OSError as e:
            log.error("gossip send to %s failed: %s", node.name, e)

    async def gossip_to_node(self, event: list, node) -> None:
        """Unicast a gossip frame straight at one node, bypassing the
        random epidemic fanout.  The one caller that needs this is the
        DEAD path: ``handle_dead_node`` pops the victim from
        ``self.nodes`` BEFORE the event is gossiped, so the normal
        fanout can never select the accused — a falsely-removed (but
        alive) node would otherwise never hear its own death
        certificate, never fire the self-defense ALIVE re-announce,
        and the asymmetric membership split would be permanent."""
        buf = msgs.serialize_gossip_message(
            f"{self.config.name}#{self.boot_id}",
            event,
            self.last_node_digest,
        )
        await self._gossip_send(buf, node)

    async def handle_gossip_event(self, event: list) -> bool:
        """Returns True when the event should continue propagating
        (shards.rs:1131-1200 returns !another_gossip_sent)."""
        kind = event[0]
        another_gossip_sent = False
        if kind == GossipEvent.ALIVE:
            node = NodeMetadata.from_wire(event[1])
            if node.name != self.config.name:
                self.dead_nodes.discard(node.name)
                self.departed_shards.pop(node.name, None)
                self.departed_at.pop(node.name, None)
                newly_added = node.name not in self.nodes
                if newly_added:
                    self.nodes[node.name] = node
                    self.add_shards_of_nodes([node])
                    self.persist_peers()
                    # Membership changed: bump the epoch and cancel
                    # any in-flight migration (it re-plans below from
                    # the NEW ring).
                    self._fence_membership_change()
                # State transition resets the opposite epidemic
                # counters (sources are name#boot_id salted).
                self._reset_gossip_counters(
                    node.name, GossipEvent.DEAD
                )
                if self.hint_log.has(node.name):
                    self.spawn(self.replay_hints(node.name))
                self.flow.notify(FlowEvent.ALIVE_NODE_GOSSIP)
                if newly_added:
                    # Migrate ONLY on the add transition (shards.rs:
                    # 1139-1152 — the ring didn't change on a duplicate
                    # Alive, so re-streaming every owned range per
                    # gossip re-receipt is pure waste and hides real
                    # repair mechanisms behind accidental migrations).
                    self.migrate_data_on_node_addition(
                        [
                            s
                            for s in self.shards
                            if s.node_name == node.name
                        ]
                    )
        elif kind == GossipEvent.DEAD:
            node_name = event[1]
            if node_name == self.config.name:
                # Self-defense: we're alive — re-announce (1165-1172).
                await self.gossip(
                    GossipEvent.alive(self.get_node_metadata())
                )
                another_gossip_sent = True
            else:
                # Grab the victim's address BEFORE removal: every
                # processor forwards the accusation straight to the
                # accused so a false positive can self-defend (the
                # epidemic fanout only targets ``self.nodes``, which
                # no longer contains it).
                victim = self.nodes.get(node_name)
                await self.handle_dead_node(node_name)
                if victim is not None:
                    self.spawn(self.gossip_to_node(event, victim))
        elif kind == GossipEvent.CREATE_COLLECTION:
            try:
                await self.create_collection(
                    event[1],
                    event[2],
                    event[3] if len(event) > 3 else None,
                    event[4] if len(event) > 4 else None,
                )
            except CollectionAlreadyExists:
                pass
        elif kind == GossipEvent.DROP_COLLECTION:
            try:
                await self.drop_collection(event[1])
            except CollectionNotFound:
                pass
        elif kind == GossipEvent.HEALTH:
            # Telemetry plane: absorb the node's periodic health
            # digest into this shard's cluster view (freshest wins)
            # and keep propagating — the epidemic is what makes
            # cluster_stats answer from ANY node.
            if len(event) > 3:
                self.absorb_health_digest(event[3])
        return not another_gossip_sent

    def _reset_gossip_counters(self, node_name: str, kind: str) -> None:
        """Drop dedup counters of ``kind`` for every boot of a node
        (gossip sources are '<name>#<boot_id>')."""
        dead_keys = [
            key
            for key in self.gossip_requests
            if key[1] == kind
            and key[0].split("#", 1)[0] == node_name
        ]
        for key in dead_keys:
            del self.gossip_requests[key]

    async def handle_dead_node(self, node_name: str) -> None:
        if self.nodes.pop(node_name, None) is None:
            return
        # Failure-aware request plane: mark first, THEN cancel any
        # replica request already in flight to the dead peer — a
        # client op blocked on a black-holed socket unblocks now (and
        # the mutation is hinted), instead of riding the 15 s read
        # timeout.  The mark makes new fan-outs fast-fail during the
        # removal race, and handle_request uses it to answer PeerDead
        # instead of a bare quorum Timeout.
        self.dead_nodes.add(node_name)
        for fut in list(self._inflight_by_node.get(node_name, ())):
            fut.cancel()
        if self.quorum_fanout is not None:
            # The native fan-out plane holds its own streams: drop
            # them too, so its in-flight ops dead-event (hint +
            # release) now instead of riding the C read timeout.
            self.quorum_fanout.drop_node(
                sorted(
                    {
                        s.connection.address
                        for s in self.shards
                        if s.node_name == node_name
                        and isinstance(
                            s.connection, RemoteShardConnection
                        )
                    }
                )
            )
        # Allow the node's next Alive announcement through the gossip
        # dedup immediately (see the matching reset in
        # handle_gossip_event).
        self._reset_gossip_counters(node_name, GossipEvent.ALIVE)
        removed = [s for s in self.shards if s.node_name == node_name]
        if removed and self.config.hint_ttl_ms > 0:
            # Keep the dead node's ring entries for hint targeting:
            # mutations keep hinting its natural replica slots until
            # it re-announces or its TTL window closes.
            import time as _time

            self.departed_shards[node_name] = removed
            self.departed_at[node_name] = _time.time()
        self.shards = [
            s for s in self.shards if s.node_name != node_name
        ]
        self.sort_consistent_hash_ring()
        # Membership changed: bump the epoch and cancel any in-flight
        # migration before re-planning from the shrunk ring below.
        self._fence_membership_change()
        closed: set = set()
        for s in removed:
            # Vnode rings carry one entry per token sharing ONE
            # pooled connection: close it once.
            if isinstance(
                s.connection, RemoteShardConnection
            ) and id(s.connection) not in closed:
                closed.add(id(s.connection))
                s.connection.close_pool()
        log.info(
            "after death of %s: %d nodes, %d shards",
            node_name,
            len(self.nodes),
            len(self.shards),
        )
        self.persist_peers()
        self.flow.notify(FlowEvent.DEAD_NODE_REMOVED)
        await self.migrate_data_on_node_removal(removed)

    # ------------------------------------------------------------------
    # Migration planning (shards.rs:853-1072)
    # ------------------------------------------------------------------

    async def migrate_data_on_node_removal(
        self, removed_shards: List[Shard]
    ) -> None:
        assert removed_shards
        old_ring = list(self.shards) + list(removed_shards)
        self.spawn_migration_tasks(
            self._plan_collection_actions(
                old_ring, list(self.shards)
            ),
            delay=None,
        )

    def migrate_data_on_node_addition(
        self, added_shards: List[Shard]
    ) -> None:
        assert added_shards
        added_names = {s.name for s in added_shards}
        old_ring = [
            s for s in self.shards if s.name not in added_names
        ]
        self.spawn_migration_tasks(
            self._plan_collection_actions(
                old_ring, list(self.shards)
            ),
            delay=NEW_NODE_MIGRATION_DELAY_S,
        )

    def _plan_collection_actions(
        self,
        old_ring: List[Shard],
        new_ring: List[Shard],
    ) -> List[Tuple[str, List[RangeAndAction]]]:
        """Per-collection migration plans for one ring transition.
        Plans depend only on the replication factor, so collections
        sharing an rf share one RangeAndAction list (the executor
        treats it read-only).  Per-collection skips use `continue`,
        not `return`: the reference returns out of the whole planning
        loop (shards.rs:869-876), silently aborting every collection
        after an rf=1 one — a durability hole with mixed-RF
        collections, fixed deliberately (PARITY.md)."""
        actions: List[Tuple[str, List[RangeAndAction]]] = []
        plans: Dict[int, List[RangeAndAction]] = {}
        for name, collection in list(self.collections.items()):
            rf = collection.replication_factor
            if rf <= 1:
                # rf=1 data lives only at its primary: no replica set
                # to rebuild.
                continue
            if rf not in plans:
                plans[rf] = self._plan_arc_diff(
                    old_ring, new_ring, rf
                )
            if plans[rf]:
                actions.append((name, plans[rf]))
        return actions

    @staticmethod
    def _ring_walk(
        ring: List[Shard],
        hashes: List[int],
        point: int,
        rf: int,
    ) -> List[Shard]:
        """Distinct-node replica walk of a hash-sorted ``ring`` (with
        its parallel ``hashes`` list) anchored at ``point``: the first
        shard of each of the first min(rf, n_nodes) distinct nodes
        at/after the point on the wrapping ring — the same walk
        owns_key, the clients, and anti-entropy derive ownership
        from."""
        n = len(ring)
        if n == 0:
            return []
        start = bisect.bisect_left(hashes, point) % n
        nodes: set = set()
        out: List[Shard] = []
        for off in range(n):
            s = ring[(start + off) % n]
            if s.node_name in nodes:
                continue
            nodes.add(s.node_name)
            out.append(s)
            if len(out) >= rf:
                break
        return out

    def _plan_arc_diff(
        self,
        old_ring: List[Shard],
        new_ring: List[Shard],
        rf: int,
    ) -> List[RangeAndAction]:
        """This shard's migration plan for the ring transition
        old_ring -> new_ring at replication factor ``rf``, as the
        arc-by-arc ownership diff (supersedes the hand-derived
        one-token special cases that accumulated four documented
        reference-bug fixes — the general form IS the fix, and it is
        what makes vnode rings plannable at all).

        The union of both rings' token hashes partitions the ring
        into arcs (U[i-1], U[i]]; no token of either ring lies
        strictly inside an arc, so each arc's replica walk is
        constant across the arc and can be evaluated once at its end
        point.  Per arc, diff the old and new distinct-node replica
        sets:

        - SEND: exactly one view streams each gained node its copy —
          the DESIGNATED SENDER, the first shard in the old walk
          whose node survives into the new set (deterministic across
          views: every node computes the same walks from the same
          membership).  This view emits only when that sender is
          itself.
        - DELETE: a view evacuates an arc its node lost only when its
          own entry was the node's serving shard for that arc in the
          old ring (other shards of the node never held the data).

        One membership event changes one node, so per arc per view at
        most ONE action fires (a designated sender's node survives,
        hence never deletes the same arc) — the executor's
        first-match dispatch over disjoint arcs stays exact.
        Consecutive arcs with identical actions merge (never across
        an actionless gap — widening a SEND range would plant
        unowned slices on the target; never across the wrap)."""
        old_sorted = sorted(old_ring, key=lambda s: (s.hash, s.name))
        new_sorted = sorted(new_ring, key=lambda s: (s.hash, s.name))
        old_hashes = [s.hash for s in old_sorted]
        new_hashes = [s.hash for s in new_sorted]
        union = sorted(set(old_hashes) | set(new_hashes))
        if len(union) < 2:
            return []  # single-point ring: no ownership to move
        arcs: List[tuple] = []  # (start, end, sig) per union arc
        for i, point in enumerate(union):
            start = union[i - 1]  # i=0 wraps: (U[-1], U[0]]
            old_sel = self._ring_walk(
                old_sorted, old_hashes, point, rf
            )
            new_sel = self._ring_walk(
                new_sorted, new_hashes, point, rf
            )
            old_nodes = {s.node_name for s in old_sel}
            new_nodes = {s.node_name for s in new_sel}
            sig: List[tuple] = []
            sender = next(
                (s for s in old_sel if s.node_name in new_nodes),
                None,
            )
            if sender is not None and sender.name == self.shard_name:
                for tgt_node in sorted(new_nodes - old_nodes):
                    tgt = next(
                        s
                        for s in new_sel
                        if s.node_name == tgt_node
                    )
                    sig.append((MigrationAction.SEND, tgt))
            if self.config.name in old_nodes - new_nodes:
                mine = next(
                    (
                        s
                        for s in old_sel
                        if s.node_name == self.config.name
                    ),
                    None,
                )
                if mine is not None and mine.name == self.shard_name:
                    sig.append((MigrationAction.DELETE, None))
            arcs.append((start, point, sig))
        # Merge runs of consecutive arcs with the same non-empty
        # signature (compare by action + target NAME: the same node's
        # serving entry is one object across arcs).
        merged: List[tuple] = []
        for start, end, sig in arcs:
            if (
                sig
                and merged
                and merged[-1][2]
                and merged[-1][1] == start
                and [
                    (a, t.name if t is not None else None)
                    for a, t in merged[-1][2]
                ]
                == [
                    (a, t.name if t is not None else None)
                    for a, t in sig
                ]
            ):
                merged[-1] = (merged[-1][0], end, sig)
            else:
                merged.append((start, end, sig))
        plan: List[RangeAndAction] = []
        for start, end, sig in merged:
            for action, tgt in sig:
                if action == MigrationAction.SEND:
                    plan.append(
                        RangeAndAction(
                            start, end, action, tgt.connection
                        )
                    )
                else:
                    plan.append(RangeAndAction(start, end, action))
        return plan

    def _fence_membership_change(self) -> None:
        """A membership change landed: bump the epoch (writes stamped
        with the previous ring view refuse retryably while migration
        is live) and cancel any in-flight migration plans — they were
        computed against a ring that no longer exists, and finishing
        them would double-stream arcs the caller is about to re-plan
        from the CURRENT ring."""
        self.membership_epoch += 1
        for task in list(self._migration_tasks):
            if not task.done():
                task.cancel()
                self.migrations_cancelled += 1
        self._migration_tasks.clear()

    def _migration_task_done(self, task) -> None:
        self._migration_tasks.discard(task)
        if not self._migration_tasks:
            # Last migration drained: lift the epoch fence and restore
            # the native ownership fast path (punted to Python while
            # the fence was up).
            self._refresh_dataplane_ownership()

    def spawn_migration_tasks(
        self,
        actions: List[Tuple[str, List[RangeAndAction]]],
        delay: Optional[float],
    ) -> None:
        from .migration import migrate_actions

        epoch = self.membership_epoch
        spawned = False
        for collection_name, ranges in actions:
            col = self.collections.get(collection_name)
            if col is None:
                continue
            self.migrations_started += 1

            async def run(name=collection_name, tree=col.tree, r=ranges):
                if delay:
                    await asyncio.sleep(delay)
                try:
                    await migrate_actions(
                        self, name, tree, r, plan_epoch=epoch
                    )
                except asyncio.CancelledError:
                    # Fenced by a newer membership change — counted
                    # there; the replacement plan owns the arcs now.
                    pass
                except Exception as e:
                    log.error("error migrating %s: %s", name, e)
                self.flow.notify(FlowEvent.DONE_MIGRATION)

            task = self.spawn(run())
            self._migration_tasks.add(task)
            task.add_done_callback(self._migration_task_done)
            spawned = True
        if spawned:
            # Epoch fence up: punt keyed ops to the Python dispatcher
            # (which reads the epoch stamp) for the migration window.
            self._refresh_dataplane_ownership()

    # ------------------------------------------------------------------

    async def stop(self) -> None:
        self.local_connection.send_stop()

    def try_to_stop_local_shards(self) -> None:
        for s in self.shards:
            if s.is_local:
                s.connection.send_stop()

    def close_db_connections(self) -> None:
        """Close live client AND peer transports so Server.wait_closed()
        (which waits on them in py3.12) can finish during shutdown."""
        for conn in (
            *list(self.db_connections),
            *list(self.remote_connections),
        ):
            conn.closing = True
            if conn.transport is not None:
                conn.transport.close()
        self.db_connections.clear()
        self.remote_connections.clear()

    def close(self) -> None:
        self.close_db_connections()
        if self.quorum_fanout is not None:
            self.quorum_fanout.close()
        self.hint_log.close()
        for col in self.collections.values():
            col.tree.close()
