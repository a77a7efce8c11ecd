"""Node configuration.

Mirrors the reference's flag surface (reference src/args.rs:5-186):
same knobs, same defaults, same per-shard port arithmetic
(db/remote/gossip port bases, each +shard_id).  Parsed once per process
and shared (read-only) by every shard.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

# Reference defaults (args.rs:36-172).
DEFAULT_DB_PORT = 10000
DEFAULT_REMOTE_SHARD_PORT = 20000
DEFAULT_GOSSIP_PORT = 30000


@dataclass
class Config:
    name: str = "dbeel"
    seed_nodes: List[str] = field(default_factory=list)
    ip: str = "127.0.0.1"
    port: int = DEFAULT_DB_PORT
    dir: str = "/tmp/dbeel_tpu"
    default_replication_factor: int = 1
    remote_shard_port: int = DEFAULT_REMOTE_SHARD_PORT
    remote_shard_connect_timeout_ms: int = 5000
    remote_shard_write_timeout_ms: int = 15000
    remote_shard_read_timeout_ms: int = 15000
    gossip_port: int = DEFAULT_GOSSIP_PORT
    gossip_fanout: int = 3
    gossip_max_seen_count: int = 3
    failure_detection_interval_ms: int = 500
    compaction_factor: int = 2
    page_cache_size: int = 1 << 30
    wal_sync_delay_us: int = 0
    wal_sync: bool = False
    sstable_bloom_min_size: int = 1 << 20
    foreground_tasks_shares: int = 1000
    background_tasks_shares: int = 250
    # Anti-entropy digest-compare interval per shard; 0 disables.
    # (Beyond-reference: the reference has no anti-entropy.)
    anti_entropy_interval_ms: int = 60_000
    # Hash sub-range buckets per digest scan (flat merkle layer): one
    # diverged key syncs ~range/buckets entries, not the whole range.
    anti_entropy_buckets: int = 64
    # Background checksum scrub (durability plane): cold sstable
    # blocks re-verify against the .sums sidecar every interval, at a
    # bounded byte rate under the share scheduler.  0 disables.
    scrub_interval_ms: int = 600_000
    scrub_bytes_per_sec: int = 8 << 20
    # Replica-convergence plane (hinted handoff).  A hint older than
    # the TTL is dropped at drain time (anti-entropy backfills nodes
    # gone longer); 0 disables hinted handoff entirely.
    hint_ttl_ms: int = 3 * 3600 * 1000
    hint_max_per_node: int = 10_000
    # Periodic hint-drain retry cadence (the Alive-gossip edge also
    # triggers a drain immediately) and the replay rate ceiling.
    hint_drain_interval_ms: int = 5_000
    hint_drain_keys_per_sec: int = 8192
    # Quorum read-repair pushes per second per shard (opportunistic:
    # beyond the cap the repair is skipped and anti-entropy catches
    # the divergence).  0 = uncapped.
    read_repair_max_per_sec: int = 256
    # ---- Elastic membership plane ----------------------------
    # Ring tokens per shard (virtual nodes).  1 keeps the reference's
    # one-token-per-shard ring (and the legacy gossip/peers arity);
    # higher values split each shard's ownership into many small arcs
    # so a join/leave migrates many bounded ranges and per-shard load
    # evens out for QoS.
    vnodes: int = 1
    # Migration streaming rate ceiling in keys/sec per shard, applied
    # per batch on top of the governor's bg gate; 0 = unpaced.
    migration_keys_per_sec: int = 0
    # ---- Atomic plane -------------------------------------
    # Post-restart refusal window for conditional writes (cas /
    # atomic_batch): a freshly-booted shard refuses to DECIDE them
    # (retryably, `overload` class) until the window expires, so a
    # decider that died and came back before the failure detector's
    # Alive edge propagated cannot race a fallback decider that is
    # still serving on its behalf.  0 disables the barrier.
    cas_boot_barrier_ms: int = 3_000

    # ---- Overload-control plane -------------------------------
    # Per-shard load governor thresholds on the admitted-work total
    # (in-flight + queued + sync-parked ops across connections): past
    # soft, background loops (anti-entropy, scrub, hint drain,
    # migration) are delayed and the AIMD connection window shrinks;
    # past hard, new data ops are shed with the retryable `Overloaded`
    # error.  0 disables that limit.
    overload_soft_ops: int = 192
    overload_hard_ops: int = 768
    # Soft signal: sstable count on any collection beyond this means
    # compaction is behind — shrink windows / delay background work
    # before the read path degrades.  0 disables.
    overload_compaction_debt: int = 16
    # Upper bound of the per-connection AIMD pipeline window (the old
    # fixed PIPELINE_WINDOW=32); the governor drives the window
    # between overload_window_min and this.
    pipeline_window_max: int = 32
    overload_window_min: int = 2
    # Slow-peer isolation: per-peer outbound caps — ops in flight and
    # (for pre-packed frames) bytes in flight to one peer.  Over the
    # cap the NEW send is shed (LIFO-over-limit: in-flight work keeps
    # its place) with `Overloaded`; shed replica mutations feed the
    # hint path.  0 disables.
    peer_queue_max_ops: int = 128
    peer_queue_max_bytes: int = 8 << 20
    # ---- Tracing / observability plane ------------------------
    # Server-side span sampling: every Nth client frame dispatched by
    # a shard gets a full per-stage span in the flight recorder (and
    # its peer fan-out frames carry the trace id so replicas piggyback
    # their own stage summary).  0 disables sampling — client-stamped
    # traces (a `trace` id on the request frame) still record, and
    # slow/error ops are always captured regardless.
    trace_sample: int = 0
    # Ops slower than this (µs) are always captured in the flight
    # recorder and counted/logged as slow (the log line itself is
    # rate-limited to 1/s per op type).
    slow_op_us: int = 100_000
    # Flight-recorder ring capacity per shard (oldest entries evict).
    trace_ring: int = 512

    # ---- Continuous telemetry plane --------------------------
    # Per-shard time-series sampling interval in ms: every interval
    # the governor-heartbeat hook walks get_stats into the telemetry
    # ring (rates, health watchdog, gossip health digests).  0
    # disables the entire plane — the heartbeat hook is never
    # installed and the serving path executes zero telemetry code.
    telemetry_interval_ms: int = 0
    # Telemetry ring capacity per shard (flattened samples; oldest
    # evict).  360 samples at the 5s production interval = 30 min of
    # history.
    telemetry_ring: int = 360
    # Prometheus text-exposition listener base port (per-shard:
    # metrics_port + shard_id, the db/remote/gossip port arithmetic).
    # 0 disables the endpoint.
    metrics_port: int = 0

    # ---- Streaming scan/range query plane --------------------
    # Byte budget per scan chunk (one SCAN/SCAN_NEXT response frame):
    # the governor-paced slice size.  A client may ask for LESS via
    # max_bytes on the scan op but never for more — one analytics
    # scan drains the keyspace in byte-bounded, individually-admitted
    # slices instead of one unbounded burst.
    scan_bytes_per_slice: int = 256 << 10
    # Concurrent scan chunks in flight per shard; beyond it new scan
    # chunks shed with the retryable Overloaded error (the cursor
    # survives, the client backs off and resumes).  0 disables the cap.
    scan_max_concurrent: int = 4

    # ---- Watch/CDC streaming plane ------------------------
    # Per-shard change-feed ring capacity (events; oldest evict).  A
    # subscriber whose cursor falls off the ring catches up from
    # durable state via the scan machinery with every replayed event
    # dup-flagged.
    watch_ring: int = 4096
    # Active watch subscribers per shard before new watch chunks shed
    # with the retryable Overloaded error (the cursor survives, the
    # client backs off and resumes).  0 disables the cap.
    watch_max_subscribers: int = 1024
    # Byte budget per watch chunk (one WATCH/WATCH_NEXT response
    # frame) — also the refill rate of each subscriber's per-second
    # byte bucket, so one slow-but-greedy watcher sheds instead of
    # wedging the shard.
    watch_bytes_per_slice: int = 256 << 10

    # ---- Multi-tenant QoS plane ---------------------------
    # Per-tenant token-bucket quotas, enforced at dispatch with the
    # retryable QuotaExceeded error.  The rate is the DEFAULT each
    # tenant gets PER COLLECTION (buckets are keyed
    # (tenant, collection), so a tenant's bulk load into one
    # collection cannot drain its budget for another).  0 disables
    # that limit.  Traffic without a tenant stamp is not quota'd.
    tenant_ops_per_sec: int = 0
    tenant_bytes_per_sec: int = 0

    # Tombstone GC grace (the delete-resurrection hazard): compaction
    # refuses to drop a tombstone younger than this, so a replica that
    # missed the delete cannot resurrect the old value through hint
    # replay / anti-entropy after the tombstone would have been GC'd.
    # -1 = auto: max(hint_ttl, 2 x anti-entropy interval).  0 disables
    # (reference behavior: drop all tombstones at the bottom level).
    gc_grace_ms: int = -1

    # Rebuild-specific knobs (no reference analog).
    shards: int = 0  # 0 = one shard per online CPU core.
    # auto | device | distributed | coalesced | device_full | cpu |
    # heap | native.  auto → distributed when more than one card is
    # visible, device on one card; with no card it raises.
    compaction_backend: str = "auto"
    memtable_capacity: int = 0  # 0 = storage.DEFAULT_TREE_CAPACITY
    # sorted | hash (device flush sort) | arena (C++ rbtree arena)
    memtable_kind: str = "auto"
    processes: bool = False  # one pinned OS process per shard

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def gc_grace_s(self) -> float:
        """Resolved tombstone-GC grace in seconds (auto = the widest
        window a delete needs to out-live its laggard replicas:
        hints replay within hint_ttl, anti-entropy converges within
        ~2 intervals)."""
        ms = self.gc_grace_ms
        if ms < 0:
            ms = max(
                self.hint_ttl_ms, 2 * self.anti_entropy_interval_ms
            )
        return ms / 1000.0

    def db_port(self, shard_id: int) -> int:
        return self.port + shard_id

    def remote_port(self, shard_id: int) -> int:
        return self.remote_shard_port + shard_id


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dbeel_tpu_torch",
        description="A distributed document DB with a CUDA storage engine.",
    )
    d = Config()
    p.add_argument("--name", default=d.name, help="Unique node name.")
    p.add_argument(
        "--seed-nodes",
        nargs="*",
        default=[],
        help="Seed nodes (<host>:<remote_shard_port>) for discovery.",
    )
    p.add_argument("--ip", default=d.ip)
    p.add_argument("--port", type=int, default=d.port)
    p.add_argument("--dir", default=d.dir)
    p.add_argument(
        "--default-replication-factor", type=int,
        default=d.default_replication_factor,
    )
    p.add_argument(
        "--remote-shard-port", type=int, default=d.remote_shard_port
    )
    p.add_argument(
        "--remote-shard-connect-timeout", type=int,
        default=d.remote_shard_connect_timeout_ms,
    )
    p.add_argument(
        "--remote-shard-write-timeout", type=int,
        default=d.remote_shard_write_timeout_ms,
    )
    p.add_argument(
        "--remote-shard-read-timeout", type=int,
        default=d.remote_shard_read_timeout_ms,
    )
    p.add_argument("--gossip-port", type=int, default=d.gossip_port)
    p.add_argument("--gossip-fanout", type=int, default=d.gossip_fanout)
    p.add_argument(
        "--gossip-max-seen-count", type=int, default=d.gossip_max_seen_count
    )
    p.add_argument(
        "--failure-detection-interval", type=int,
        default=d.failure_detection_interval_ms,
    )
    p.add_argument(
        "--compaction-factor", type=int, default=d.compaction_factor
    )
    p.add_argument("--page-cache-size", type=int, default=d.page_cache_size)
    p.add_argument("--wal-sync-delay", type=int, default=d.wal_sync_delay_us)
    p.add_argument("--wal-sync", action="store_true", default=d.wal_sync)
    p.add_argument(
        "--sstable-bloom-min-size", type=int, default=d.sstable_bloom_min_size
    )
    p.add_argument(
        "--foreground-tasks-shares", type=int,
        default=d.foreground_tasks_shares,
    )
    p.add_argument(
        "--background-tasks-shares", type=int,
        default=d.background_tasks_shares,
    )
    p.add_argument(
        "--anti-entropy-interval",
        type=int,
        dest="anti_entropy_interval_ms",
        default=d.anti_entropy_interval_ms,
        help="anti-entropy digest-compare interval in ms (0 disables)",
    )
    p.add_argument(
        "--anti-entropy-buckets",
        type=int,
        default=d.anti_entropy_buckets,
        help="hash sub-range buckets per anti-entropy digest scan",
    )
    p.add_argument(
        "--scrub-interval",
        type=int,
        dest="scrub_interval_ms",
        default=d.scrub_interval_ms,
        help="background checksum-scrub interval in ms (0 disables)",
    )
    p.add_argument(
        "--scrub-bytes-per-sec",
        type=int,
        default=d.scrub_bytes_per_sec,
        help="scrub read-rate ceiling in bytes/sec",
    )
    p.add_argument(
        "--hint-ttl",
        type=int,
        dest="hint_ttl_ms",
        default=d.hint_ttl_ms,
        help="hinted-handoff TTL in ms (0 disables hints)",
    )
    p.add_argument(
        "--hint-max-per-node",
        type=int,
        default=d.hint_max_per_node,
        help="cap on queued hints per target node (oldest drop first)",
    )
    p.add_argument(
        "--hint-drain-interval",
        type=int,
        dest="hint_drain_interval_ms",
        default=d.hint_drain_interval_ms,
        help="periodic hint-drain retry cadence in ms",
    )
    p.add_argument(
        "--hint-drain-keys-per-sec",
        type=int,
        default=d.hint_drain_keys_per_sec,
        help="hint replay rate ceiling in keys/sec",
    )
    p.add_argument(
        "--read-repair-max-per-sec",
        type=int,
        default=d.read_repair_max_per_sec,
        help="quorum read-repair pushes per second per shard "
        "(0 = uncapped)",
    )
    p.add_argument(
        "--vnodes",
        type=int,
        default=d.vnodes,
        help="ring tokens per shard (virtual nodes); 1 = the legacy "
        "one-token-per-shard ring and wire arity",
    )
    p.add_argument(
        "--migration-keys-per-sec",
        type=int,
        default=d.migration_keys_per_sec,
        help="migration streaming rate ceiling in keys/sec per shard "
        "(0 = unpaced; the governor bg gate still applies)",
    )
    p.add_argument(
        "--cas-boot-barrier-ms",
        type=int,
        dest="cas_boot_barrier_ms",
        default=d.cas_boot_barrier_ms,
        help="post-restart window during which conditional writes "
        "(cas/atomic_batch) are refused retryably, closing the "
        "split-decider race with a fallback decider (0 disables)",
    )
    p.add_argument(
        "--overload-soft-ops",
        type=int,
        default=d.overload_soft_ops,
        help="admitted-work soft limit per shard: beyond it "
        "background loops delay and AIMD windows shrink (0 disables)",
    )
    p.add_argument(
        "--overload-hard-ops",
        type=int,
        default=d.overload_hard_ops,
        help="admitted-work hard limit per shard: beyond it new data "
        "ops are shed with the retryable Overloaded error "
        "(0 disables)",
    )
    p.add_argument(
        "--overload-compaction-debt",
        type=int,
        default=d.overload_compaction_debt,
        help="sstable count per collection that counts as soft "
        "overload (compaction behind; 0 disables)",
    )
    p.add_argument(
        "--pipeline-window-max",
        type=int,
        default=d.pipeline_window_max,
        help="upper bound of the per-connection AIMD pipeline window",
    )
    p.add_argument(
        "--overload-window-min",
        type=int,
        default=d.overload_window_min,
        help="lower bound the AIMD window shrinks to under overload",
    )
    p.add_argument(
        "--peer-queue-max-ops",
        type=int,
        default=d.peer_queue_max_ops,
        help="per-peer outbound in-flight op cap; over it new sends "
        "are shed (writes fall back to hints; 0 disables)",
    )
    p.add_argument(
        "--peer-queue-max-bytes",
        type=int,
        default=d.peer_queue_max_bytes,
        help="per-peer outbound in-flight byte cap for pre-packed "
        "frames (0 disables)",
    )
    p.add_argument(
        "--trace-sample",
        type=int,
        default=d.trace_sample,
        help="full-span sampling rate: every Nth client frame gets a "
        "per-stage trace in the flight recorder (0 disables; "
        "slow/error ops are always captured)",
    )
    p.add_argument(
        "--slow-op-us",
        type=int,
        dest="slow_op_us",
        default=d.slow_op_us,
        help="ops slower than this (µs) always land in the flight "
        "recorder and count as slow",
    )
    p.add_argument(
        "--trace-ring",
        type=int,
        default=d.trace_ring,
        help="flight-recorder ring capacity per shard",
    )
    p.add_argument(
        "--telemetry-interval",
        type=int,
        dest="telemetry_interval_ms",
        default=d.telemetry_interval_ms,
        help="telemetry time-series sampling interval in ms (0 "
        "disables the plane entirely — zero serving-path cost)",
    )
    p.add_argument(
        "--telemetry-ring",
        type=int,
        default=d.telemetry_ring,
        help="telemetry ring capacity per shard (samples; oldest "
        "evict)",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=d.metrics_port,
        help="Prometheus /metrics base port (per-shard listener at "
        "metrics_port + shard_id; 0 disables)",
    )
    p.add_argument(
        "--scan-bytes-per-slice",
        type=int,
        default=d.scan_bytes_per_slice,
        help="byte budget per streaming-scan chunk (one response "
        "frame; the governor-paced slice size)",
    )
    p.add_argument(
        "--scan-max-concurrent",
        type=int,
        default=d.scan_max_concurrent,
        help="concurrent scan chunks per shard before new ones shed "
        "with the retryable Overloaded error (0 disables the cap)",
    )
    p.add_argument(
        "--watch-ring",
        type=int,
        default=d.watch_ring,
        help="per-shard change-feed ring capacity (events; oldest "
        "evict — a cursor off the ring catches up from durable state "
        "with dup-flagging)",
    )
    p.add_argument(
        "--watch-max-subscribers",
        type=int,
        default=d.watch_max_subscribers,
        help="active watch subscribers per shard before new watch "
        "chunks shed with the retryable Overloaded error (0 disables "
        "the cap)",
    )
    p.add_argument(
        "--watch-bytes-per-slice",
        type=int,
        default=d.watch_bytes_per_slice,
        help="byte budget per watch chunk and per-subscriber "
        "per-second byte-bucket refill (slow watchers shed instead "
        "of wedging the shard)",
    )
    p.add_argument(
        "--tenant-ops-per-sec",
        type=int,
        default=d.tenant_ops_per_sec,
        help="per-tenant per-collection op-rate quota (token bucket; "
        "over it ops refuse with the retryable QuotaExceeded; "
        "0 disables)",
    )
    p.add_argument(
        "--tenant-bytes-per-sec",
        type=int,
        default=d.tenant_bytes_per_sec,
        help="per-tenant per-collection byte-rate quota (charged as "
        "debt once the op's real size is known; 0 disables)",
    )
    p.add_argument(
        "--gc-grace",
        type=int,
        dest="gc_grace_ms",
        default=d.gc_grace_ms,
        help="tombstone GC grace in ms: compaction keeps tombstones "
        "younger than this (-1 = auto: max(hint-ttl, 2x anti-entropy "
        "interval); 0 = drop all, reference behavior)",
    )
    p.add_argument("--shards", type=int, default=d.shards)
    p.add_argument(
        "--compaction-backend",
        choices=(
            "auto",
            "device",
            "device_full",
            "coalesced",
            "distributed",
            "cpu",
            "native",
            "heap",
        ),
        default=d.compaction_backend,
    )
    p.add_argument(
        "--memtable-capacity", type=int, default=d.memtable_capacity
    )
    p.add_argument(
        "--memtable-kind",
        choices=("auto", "sorted", "hash", "arena"),
        default=d.memtable_kind,
        help="Memtable implementation. 'auto' resolves to the native "
        "C++ arena RB-tree when built (the default and the fast "
        "path). NOTE: the entire native serving data plane — "
        "one-C-call writes AND sstable point reads, on every plane "
        "(client, replica, coordinator) — requires the arena "
        "memtable; choosing 'sorted' or 'hash' forfeits it and "
        "every request runs the interpreted path (roughly an order "
        "of magnitude slower at the RF=1 throughput benchmarks).",
    )
    p.add_argument(
        "--processes",
        action="store_true",
        default=d.processes,
        help="One pinned OS process per shard (thread-per-core shape).",
    )
    return p


def parse_args(argv: Optional[Sequence[str]] = None) -> Config:
    ns = build_parser().parse_args(argv)
    return Config(
        name=ns.name,
        seed_nodes=list(ns.seed_nodes),
        ip=ns.ip,
        port=ns.port,
        dir=ns.dir,
        default_replication_factor=ns.default_replication_factor,
        remote_shard_port=ns.remote_shard_port,
        remote_shard_connect_timeout_ms=ns.remote_shard_connect_timeout,
        remote_shard_write_timeout_ms=ns.remote_shard_write_timeout,
        remote_shard_read_timeout_ms=ns.remote_shard_read_timeout,
        gossip_port=ns.gossip_port,
        gossip_fanout=ns.gossip_fanout,
        gossip_max_seen_count=ns.gossip_max_seen_count,
        failure_detection_interval_ms=ns.failure_detection_interval,
        compaction_factor=ns.compaction_factor,
        page_cache_size=ns.page_cache_size,
        wal_sync_delay_us=ns.wal_sync_delay,
        wal_sync=ns.wal_sync,
        sstable_bloom_min_size=ns.sstable_bloom_min_size,
        foreground_tasks_shares=ns.foreground_tasks_shares,
        background_tasks_shares=ns.background_tasks_shares,
        anti_entropy_interval_ms=ns.anti_entropy_interval_ms,
        anti_entropy_buckets=ns.anti_entropy_buckets,
        scrub_interval_ms=ns.scrub_interval_ms,
        scrub_bytes_per_sec=ns.scrub_bytes_per_sec,
        hint_ttl_ms=ns.hint_ttl_ms,
        hint_max_per_node=ns.hint_max_per_node,
        hint_drain_interval_ms=ns.hint_drain_interval_ms,
        hint_drain_keys_per_sec=ns.hint_drain_keys_per_sec,
        read_repair_max_per_sec=ns.read_repair_max_per_sec,
        vnodes=ns.vnodes,
        migration_keys_per_sec=ns.migration_keys_per_sec,
        cas_boot_barrier_ms=ns.cas_boot_barrier_ms,
        overload_soft_ops=ns.overload_soft_ops,
        overload_hard_ops=ns.overload_hard_ops,
        overload_compaction_debt=ns.overload_compaction_debt,
        pipeline_window_max=ns.pipeline_window_max,
        overload_window_min=ns.overload_window_min,
        peer_queue_max_ops=ns.peer_queue_max_ops,
        peer_queue_max_bytes=ns.peer_queue_max_bytes,
        trace_sample=ns.trace_sample,
        slow_op_us=ns.slow_op_us,
        trace_ring=ns.trace_ring,
        telemetry_interval_ms=ns.telemetry_interval_ms,
        telemetry_ring=ns.telemetry_ring,
        metrics_port=ns.metrics_port,
        scan_bytes_per_slice=ns.scan_bytes_per_slice,
        scan_max_concurrent=ns.scan_max_concurrent,
        watch_ring=ns.watch_ring,
        watch_max_subscribers=ns.watch_max_subscribers,
        watch_bytes_per_slice=ns.watch_bytes_per_slice,
        tenant_ops_per_sec=ns.tenant_ops_per_sec,
        tenant_bytes_per_sec=ns.tenant_bytes_per_sec,
        gc_grace_ms=ns.gc_grace_ms,
        shards=ns.shards,
        compaction_backend=ns.compaction_backend,
        memtable_capacity=ns.memtable_capacity,
        memtable_kind=ns.memtable_kind,
        processes=ns.processes,
    )
