"""Per-shard background tasks.

Role parity with the reference's tasks/: local shard server
(local_shard_server.rs), remote shard server (remote_shard_server.rs),
compaction scheduler (compaction.rs), gossip server (gossip_server.rs),
failure detector (failure_detector.rs), and the stop-event waiter
(stop_event_waiter.rs).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time

from ..errors import DbeelError, ShardStopped
from ..flow_events import FlowEvent
from ..cluster import messages as msgs
from ..cluster.local_comm import ShardPacket
from ..cluster.messages import (
    ShardEvent,
    ShardResponse,
    pack_message,
    unpack_message,
)
from ..cluster.remote_comm import (
    MAX_MESSAGE,
    RemoteShardConnection,
)
from . import framed
from .shard import MyShard

log = logging.getLogger(__name__)

GOSSIP_REQUEST_EXPIRATION_S = 30.0  # gossip_server.rs:17
UDP_PACKET_BUFFER_SIZE = 65536
MIN_COMPACTION_FACTOR = 2  # compaction.rs:13


# ----------------------------------------------------------------------
# Local shard server (local_shard_server.rs:8-66)
# ----------------------------------------------------------------------


async def run_local_shard_server(my_shard: MyShard) -> None:
    queue = my_shard.local_connection.queue
    while True:
        packet: ShardPacket = await queue.get()
        try:
            response = await my_shard.handle_shard_message(packet.message)
        except DbeelError as e:
            response = msgs.ShardResponse.error(e)
        except Exception as e:
            log.exception("local shard message failed")
            response = ["response", ShardResponse.ERROR, "Internal", str(e)]
        if packet.response_future is not None:
            if not packet.response_future.done():
                packet.response_future.set_result(
                    response
                    if response is not None
                    else ShardResponse.pong()
                )


# ----------------------------------------------------------------------
# Remote shard server (remote_shard_server.rs:19-102)
# ----------------------------------------------------------------------


class _RemoteShardProtocol(framed.FramedServerProtocol):
    """Raw-protocol remote shard server (the db server's _DbProtocol
    treatment applied to the peer plane): 4-byte-LE-length msgpack
    frames parsed in data_received, replica-plane set/delete/get
    answered synchronously by the native data plane
    (dataplane.try_handle_shard), everything else drained in arrival
    order through the unchanged handle_shard_message path.  Wire
    format and error behavior identical to the stream version
    (remote_shard_server.rs:23-49 parity: persistent multi-message
    connections).

    Overload plane: the peer plane never SHEDS (replica
    work is what keeps quorums alive; its admission happened at the
    coordinator), but its read-pause watermark rides the same AIMD
    window the public plane uses — while this shard's governor reads
    backlog, frames pause earlier, pushing bytes back into the
    coordinator's capped outbound queue instead of buffering them
    here.  Expired-deadline peer frames are dropped by
    handle_shard_request (deadline propagation)."""

    HEADER = 4
    MAX_FRAME = MAX_MESSAGE
    WINDOW_MIN = 8.0

    __slots__ = ()

    def __init__(self, my_shard) -> None:
        super().__init__(my_shard)
        self.window = float(self.PENDING_HIGH)

    def _pending_high(self) -> int:
        return max(int(self.WINDOW_MIN), int(self.window))

    def _registry(self) -> set:
        # Tracked for shutdown: py3.12 Server.wait_closed() waits on
        # open protocol connections, and peer streams are persistent.
        return self.shard.remote_connections

    def _on_disconnect(self) -> None:
        # Fire-and-forget senders (send_event, migration streams)
        # write their last frames and close immediately: frames
        # already received MUST still be applied, exactly like the
        # stream server kept serving readexactly's buffer after EOF.
        # So the drain is NOT cancelled here — it finishes
        # self.pending (skipping response writes once the transport
        # is closing) and exits.  Shard shutdown cancels it via
        # _background_tasks; the base drain suppresses its respawn on
        # cancellation.
        pass

    def _try_fast(self, frame: bytes) -> int:
        dp = self.shard.dataplane
        if dp is None:
            return framed.FAST_MISS
        fast = dp.try_handle_shard(frame)
        if fast is None:
            return framed.FAST_MISS
        # Replica-side serving is foreground work (set/delete/get/
        # multi only on this path; the anti-entropy exemption applies
        # to RANGE_* messages, which always punt).
        self.shard.scheduler.fg_mark()
        resp, flush_tree, notify_set, defer, deadline_dropped = fast
        if deadline_dropped:
            # Expired propagated budget answered natively with the
            # retryable Overloaded frame: count it exactly like the
            # interpreted drop (handle_shard_request parity).
            self.shard.governor.replica_deadline_drops += 1
        if flush_tree is not None:
            self.shard.spawn(flush_tree.flush())
        if defer is not None:
            # wal-sync: a replica ack is a durability promise to the
            # coordinator — park it (and the flow notification, which
            # the Python handler also fires only after the synced
            # write) until the fdatasync watermark covers the ticket.
            syncer, ticket = defer
            entry = self.park_response(resp)
            shard = self.shard

            def _release(e=entry, notify=notify_set):
                self.finish_park(e)
                if notify:
                    shard.flow.notify(
                        FlowEvent.ITEM_SET_FROM_SHARD_MESSAGE
                    )

            syncer.park(ticket, _release)
            return framed.FAST_HANDLED
        if resp is not None:
            if self.parked:
                self.park_response(resp, done=True)
            else:
                self._write_out(resp)
        if notify_set:
            self.shard.flow.notify(
                FlowEvent.ITEM_SET_FROM_SHARD_MESSAGE
            )
        return framed.FAST_HANDLED

    async def _serve_one(self, frame: bytes, arrived: float = 0.0) -> bool:
        my_shard = self.shard
        try:
            message = unpack_message(frame)
        except Exception:
            # Malformed msgpack: stop talking to this peer, but the
            # remaining length-delimited frames were received intact
            # — keep applying them (writes skipped, transport
            # closing).
            self.transport.close()
            return True
        # Replica-side serving (quorum writes/reads from peers) is
        # foreground work too.  Anti-entropy's own requests must NOT
        # mark: they are background traffic, and marking would make
        # the peer-side bg_slice throttle against the very request it
        # serves.
        if not (
            isinstance(message, (list, tuple))
            and len(message) > 1
            and message[0] == "request"
            and message[1]
            in (
                msgs.ShardRequest.RANGE_DIGEST,
                msgs.ShardRequest.RANGE_PULL,
                msgs.ShardRequest.RANGE_PUSH,
                # Scan pages are governed background work too: the
                # coordinator admitted the chunk; the replica-side
                # page must not mark foreground activity or the
                # bg_slice it runs under would throttle against the
                # very request it serves.
                msgs.ShardRequest.SCAN,
            )
        ):
            my_shard.scheduler.fg_mark()
        # Tracing plane: a coordinator stamped a trace id on this
        # peer frame — measure our own stages and piggyback the
        # summary on the response, so an RF>1 op's span decomposes
        # into coordinator + per-replica time.  The native replica
        # plane punts traced frames (want+2 dialect), so every
        # sampled frame lands here.
        trace_id = MyShard.peer_trace_id(message)
        t_serve = time.monotonic()
        try:
            response = await my_shard.handle_shard_message(message)
        except DbeelError as e:
            response = msgs.ShardResponse.error(e)
        except Exception as e:
            log.exception("remote shard message failed")
            response = [
                "response",
                ShardResponse.ERROR,
                "Internal",
                str(e),
            ]
        if (
            trace_id is not None
            and isinstance(response, list)
            and len(response) >= 2
            and response[0] == "response"
            and response[1] != ShardResponse.ERROR
        ):
            # Replica stage summary (u32 micros): [queue_us,
            # serve_us] — frame receipt → dispatch, and the storage
            # work itself.  One extra trailing element past the base
            # arity; the coordinator's fan-out strips it before the
            # quorum interpret (trace.split_peer_span).
            now = time.monotonic()
            queue_us = int(
                max(0.0, t_serve - (arrived or t_serve)) * 1e6
            )
            response = response + [
                [queue_us, int((now - t_serve) * 1e6)]
            ]
        if (
            response is not None
            and not self.closing
            and not self.transport.is_closing()
        ):
            # Ack order per stream: queue behind parked fast-path
            # acks still awaiting their WAL sync.
            await self._wait_parked_drained()
            await self.writable.wait()
            if self.closing or self.transport.is_closing():
                return True  # keep applying buffered frames
            payload = pack_message(response)
            self._write_out(
                len(payload).to_bytes(4, "little") + payload
            )
        self.aimd_tick(self.WINDOW_MIN, float(self.PENDING_HIGH))
        return True


async def bind_remote_shard_server(my_shard: MyShard) -> asyncio.Server:
    port = my_shard.config.remote_port(my_shard.id)
    server = await asyncio.get_event_loop().create_server(
        lambda: _RemoteShardProtocol(my_shard),
        my_shard.config.ip,
        port,
    )
    log.info(
        "listening for distributed messages on %s:%d",
        my_shard.config.ip,
        port,
    )
    return server


async def run_remote_shard_server(my_shard: MyShard, server=None) -> None:
    if server is None:
        server = await bind_remote_shard_server(my_shard)
    async with server:
        await server.serve_forever()


# ----------------------------------------------------------------------
# Compaction scheduler (compaction.rs:13-153)
# ----------------------------------------------------------------------


def _leading_zeros64(n: int) -> int:
    return 64 - n.bit_length() if n else 64


async def compact_tree(
    tree, compaction_factor: int, scheduler=None
) -> None:
    """Size-tiered grouping by size order (leading_zeros) with cascade
    merge of adjacent orders (compaction.rs:35-102).  Each merge is one
    background unit under the share scheduler: while serving is busy,
    consecutive merges are spaced to the fg/bg share ratio."""
    indices_and_sizes = tree.sstable_indices_and_sizes()

    odd = [i for i, _ in indices_and_sizes if i % 2 != 0]
    index_to_compact = (max(odd) + 2) if odd else 1

    groups: dict = {}
    for i, size in indices_and_sizes:
        groups.setdefault(_leading_zeros64(size), []).append((i, size))

    # Largest sstables first (smallest leading_zeros first).
    ordered = sorted(groups.items())
    optimized: dict = {}
    for size_order, items in ordered:
        if size_order in optimized:
            items = items + optimized.pop(size_order)
        estimated = _leading_zeros64(sum(s for _, s in items))
        target = min(estimated, size_order)
        optimized.setdefault(target, []).extend(items)

    for i, items in enumerate(optimized.values()):
        if len(items) < MIN_COMPACTION_FACTOR or len(
            items
        ) < compaction_factor:
            continue
        indices = [idx for idx, _ in items]
        # Drop tombstones only on the final (largest) level
        # (compaction.rs:90-92).
        keep_tombstones = i > 0
        try:
            if scheduler is not None:
                async with scheduler.bg_slice():
                    await tree.compact(
                        indices, index_to_compact, keep_tombstones
                    )
            else:
                await tree.compact(
                    indices, index_to_compact, keep_tombstones
                )
        except Exception as e:
            log.error("failed to compact files: %s", e)
        index_to_compact += 2


async def run_compaction_loop(my_shard: MyShard) -> None:
    compaction_factor = my_shard.config.compaction_factor
    if compaction_factor < MIN_COMPACTION_FACTOR:
        return

    async def trees_and_listeners():
        while not my_shard.collections:
            await my_shard.collections_change_event.listen()
        trees = [c.tree for c in my_shard.collections.values()]
        listeners = [t.flush_done_event.listen() for t in trees]
        return trees, listeners

    trees, listeners = await trees_and_listeners()

    # Compact once on startup (crash may have left ungrouped files).
    await asyncio.gather(
        *[
            compact_tree(t, compaction_factor, my_shard.scheduler)
            for t in trees
        ]
    )

    change = None
    try:
        while True:
            change = asyncio.ensure_future(
                my_shard.collections_change_event.wait()
            )
            done, _pending = await asyncio.wait(
                [change, *listeners], return_when=asyncio.FIRST_COMPLETED
            )
            if change.done():
                for fut in listeners:
                    fut.cancel()
                trees, listeners = await trees_and_listeners()
                continue
            change.cancel()
            for i, fut in enumerate(listeners):
                if fut.done():
                    listeners[i] = trees[i].flush_done_event.listen()
                    await compact_tree(
                        trees[i], compaction_factor, my_shard.scheduler
                    )
    finally:
        # Cancelled with the shard: the waiters this loop started must
        # not outlive it (a pending change waiter would keep the loop
        # it belongs to from closing cleanly).
        if change is not None:
            change.cancel()
        for fut in listeners:
            fut.cancel()


# ----------------------------------------------------------------------
# Anti-entropy (beyond-reference: SURVEY §5 lists anti-entropy as a gap
# in the reference's replication design).  Each shard periodically
# compares per-bucket digests of every arc in its EXACT owned-range
# union (MyShard.replica_arcs: primary range + the replicated
# predecessor slices, exact under interleaved multi-shard nodes) with
# that arc's replica shards — successors AND predecessors; on
# mismatch it pushes its entries (batched RANGE_PUSH, applied on the
# peer only when strictly newer than the peer's newest — never through
# raw Set events, which could shadow newer flushed values) and pulls
# the peer's (same strictly-newer guard locally), so both sides
# converge on the union.  Every unit runs under the share scheduler.
#
# Known caveats (documented, Cassandra has the same fundamentals):
#  * Granularity is the whole primary range: one diverged key
#    transfers the range's entries (the strictly-newer guard makes the
#    applies no-ops, but the bytes still cross).  Sub-range/merkle
#    digests are the refinement path.
#  * Bottom-level compaction drops tombstones (reference parity); a
#    replica that GC'd a delete before every peer saw it can have the
#    old value resurrected by a later sync — the classic
#    tombstone-GC-before-repair window (Cassandra's gc_grace).  Keep
#    the anti-entropy interval well below compaction churn.
# ----------------------------------------------------------------------

ANTI_ENTROPY_PAGE = 2048


async def _sync_range_with_peer(
    my_shard, name, tree, peer, start, end, counts, digests
):
    """Compare per-bucket digests with one peer; push+pull ONLY the
    diverged hash sub-ranges.  A single diverged key now transfers
    ~range/nbuckets entries instead of the whole primary range (the
    earlier whole-range caveat, resolved with a flat merkle layer)."""
    from ..cluster.messages import ShardRequest, ShardResponse

    nb = len(counts)
    resp = await peer.connection.send_request(
        ShardRequest.range_digest(name, start, end, nb)
    )
    msgs.response_to_result(resp, ShardResponse.RANGE_DIGEST)
    diverged = _diverged_buckets(counts, digests, resp, nb)
    if not diverged:
        return False
    bucket_set = set(diverged)

    # Push ours in batched pages from ONE materialized snapshot of the
    # diverged buckets; the peer applies strictly-newer only.
    async with my_shard.scheduler.bg_slice():
        mine = await my_shard.collect_range_entries(
            tree, start, end, None, bucket_set, nb
        )
    pushed = 0
    for off in range(0, len(mine), ANTI_ENTROPY_PAGE):
        page = mine[off : off + ANTI_ENTROPY_PAGE]
        # Counter stamped at SEND: the peer applies the page before
        # its ack travels back, so an observer who sees the data
        # converge must also see the transfer counted — stamping
        # after the await left a window where convergence was
        # visible with ae_entries_pushed still 0.
        my_shard.ae_entries_pushed += len(page)
        async with my_shard.scheduler.bg_slice():
            msgs.response_to_result(
                await peer.connection.send_request(
                    ShardRequest.range_push(name, page)
                ),
                ShardResponse.RANGE_PUSH,
            )
        pushed += len(page)
    # ...and pull theirs (same diverged buckets), applying only
    # strictly-newer entries.
    fetched, pulled = await _pull_buckets_from_peer(
        my_shard, name, tree, peer, start, end, diverged, nb
    )
    if pushed or pulled:
        log.info(
            "anti-entropy %s with %s: %d/%d buckets diverged, "
            "pushed %d, fetched %d, applied %d pulled",
            name,
            peer.name,
            len(diverged),
            nb,
            pushed,
            fetched,
            pulled,
        )
    my_shard.flow.notify(FlowEvent.ANTI_ENTROPY_SYNCED)
    # Local state changed only if a pull applied — the caller
    # recomputes the shared digest exactly then.
    return pulled > 0


async def run_anti_entropy(my_shard: MyShard) -> None:
    """Background anti-entropy — the convergence backstop that fires
    with no reads and no hints (expired TTL, capacity drops, crashed
    coordinators): every interval, exchange per-bucket range digests
    with the replicas of each arc in this shard's EXACT owned-range
    union (MyShard.replica_arcs — the same helper the quarantine
    repair scopes its pulls with) and push/pull only the diverged
    buckets.  Every unit runs under the share scheduler, a sibling of
    the scrub loop: continuous maintenance priced like compaction."""
    interval = my_shard.config.anti_entropy_interval_ms / 1000.0
    if interval <= 0:
        return
    nb = max(1, my_shard.config.anti_entropy_buckets)
    while True:
        await asyncio.sleep(interval)
        for name, col in list(my_shard.collections.items()):
            rf = col.replication_factor
            if rf <= 1:
                continue
            # The owned-range union, one entry per merged arc with
            # the peer shards that replicate that arc.  On the common
            # single-shard-per-node ring with nodes <= rf the arcs
            # collapse to ONE whole-ring range; interleaved
            # multi-shard nodes get their exact slices.
            for start, end, peers in my_shard.replica_arcs(rf):
                if not peers:
                    continue
                try:
                    # One digest scan per arc fills ALL sub-range
                    # buckets, shared by that arc's peer comparisons.
                    # The LOCAL scans sit inside the same guard as
                    # the peer exchanges: a corrupted page raises
                    # CorruptedFile right here (quarantining the
                    # table as a side effect), and before this guard
                    # that exception escaped the task set and took
                    # the whole shard down (observed in the chaos
                    # soak when the disk-fault bit-flip landed on the
                    # partition victim) — quarantine repair owns the
                    # heal; AE just skips the arc this round.
                    async with my_shard.scheduler.bg_slice():
                        counts, digests = (
                            await my_shard.compute_range_digests(
                                col.tree, start, end, nb
                            )
                        )
                    for peer in peers:
                        try:
                            pulled_any = await _sync_range_with_peer(
                                my_shard,
                                name,
                                col.tree,
                                peer,
                                start,
                                end,
                                counts,
                                digests,
                            )
                            if pulled_any:
                                # A pull changed our range: later
                                # peers must compare against the
                                # CURRENT digests or every one of
                                # them re-syncs.
                                async with my_shard.scheduler.bg_slice():
                                    counts, digests = (
                                        await my_shard.compute_range_digests(
                                            col.tree, start, end, nb
                                        )
                                    )
                        except (DbeelError, OSError) as e:
                            log.warning(
                                "anti-entropy %s with %s failed: %s",
                                name,
                                peer.name,
                                e,
                            )
                except (DbeelError, OSError) as e:
                    log.warning(
                        "anti-entropy %s local digest scan failed "
                        "(skipping arc this round): %s",
                        name,
                        e,
                    )
        my_shard.ae_rounds += 1
        my_shard.flow.notify(FlowEvent.ANTI_ENTROPY_DONE)


# ----------------------------------------------------------------------
# Hint drain (replica-convergence plane): the periodic retry leg
# of hinted handoff.  The Alive-gossip edge replays immediately; this
# loop covers everything the edge misses — hints reloaded from the WAL
# after a restart (the target was discovered at boot, no Alive edge
# fires), a replay that failed midway, a target that bounced.  Skips
# nodes still believed down; every page runs under the share scheduler
# at the configured keys/sec ceiling (MyShard.replay_hints).
# ----------------------------------------------------------------------


async def run_hint_drain(my_shard: MyShard) -> None:
    import time as _time

    interval = my_shard.config.hint_drain_interval_ms / 1000.0
    ttl_s = my_shard.config.hint_ttl_ms / 1000.0
    if interval <= 0 or my_shard.config.hint_ttl_ms <= 0:
        return
    while True:
        await asyncio.sleep(interval)
        # Close the TTL window of nodes that never came back: stop
        # hinting them (every write was paying a hint-log append),
        # expire their queued hints, and hand their backfill to
        # anti-entropy.  A node decommissioned via the detector-Dead
        # path stops costing anything after one TTL.
        now = _time.time()
        for node, since in list(my_shard.departed_at.items()):
            if now - since > ttl_s:
                my_shard.departed_shards.pop(node, None)
                my_shard.departed_at.pop(node, None)
                my_shard._merged_walk_cache = None
                dropped = my_shard.hint_log.expire_node(node)
                log.info(
                    "hint TTL window for %s closed: %d hints "
                    "expired; anti-entropy owns its backfill",
                    node,
                    dropped,
                )
        for node in my_shard.hint_log.nodes_with_hints():
            if (
                node in my_shard.dead_nodes
                or node not in my_shard.nodes
            ):
                # Still down/unknown: keep queued, but the TTL clock
                # runs regardless — expiry cannot depend on a drain
                # that may never happen (a coordinator restart also
                # loses departed_at, so log-reloaded hints for a
                # never-rediscovered node expire HERE).
                my_shard.hint_log.expire_ttl_dead(node)
                continue
            try:
                await my_shard.replay_hints(node)
            except (DbeelError, OSError) as e:
                log.warning(
                    "hint drain to %s failed: %s", node, e
                )


# ----------------------------------------------------------------------
# Quarantine repair + background scrub (durability plane — no
# reference analog: the reference trusts every byte it reads back).
#
# Repair: when a checksum failure quarantines an sstable, the shard
# pulls the lost range back from its replicas THROUGH the existing
# anti-entropy machinery — per-bucket range digests gate the transfer,
# so only the buckets the quarantine actually diverged move, and
# apply_if_newer keeps the pulls LWW-safe.  The pull covers the EXACT
# owned-range union (MyShard.replica_arcs), one pull per arc per
# replica of that arc, and buckets that agree cost one digest frame.  Only after the pull
# completes are the quarantined files retired (tree.finish_repair)
# and suspect-miss reads re-enabled.
#
# Scrub: a background pass re-reads cold blocks directly (no page-
# cache pollution) at a bounded byte rate under the share scheduler,
# verifying them against the checksum sidecar — bit rot is found in
# weeks-old tables BEFORE a client read trips over it; a mismatch
# funnels into the exact same quarantine → repair path.
# ----------------------------------------------------------------------


async def _pull_buckets_from_peer(
    my_shard, name, tree, peer, start, end, buckets, nb
) -> "tuple[int, int]":
    """Paged RANGE_PULL of ``buckets`` from one peer, applying each
    entry strictly-newer — the pull half shared by the anti-entropy
    exchange and the quarantine repair (one implementation, so paging
    or dialect fixes can never diverge between them).  Returns
    (entries fetched, entries applied)."""
    from ..cluster.messages import ShardRequest, ShardResponse

    fetched = applied = 0
    page_after = None
    while True:
        resp = await peer.connection.send_request(
            ShardRequest.range_pull(
                name,
                start,
                end,
                page_after,
                ANTI_ENTROPY_PAGE,
                buckets,
                nb,
            )
        )
        entries = msgs.response_to_result(
            resp, ShardResponse.RANGE_PULL
        )
        if not entries:
            break
        fetched += len(entries)
        my_shard.ae_entries_fetched += len(entries)
        async with my_shard.scheduler.bg_slice():
            for key, value, ts in entries:
                if await my_shard.apply_if_newer(
                    tree, bytes(key), bytes(value), int(ts)
                ):
                    applied += 1
                    # Convergence accounting (get_stats.convergence):
                    # AE and repair pulls heal keys locally here.
                    my_shard.keys_healed += 1
        if len(entries) < ANTI_ENTROPY_PAGE:
            break
        page_after = bytes(entries[-1][0])
    return fetched, applied


def _diverged_buckets(counts, digests, resp, nb) -> list:
    """Bucket indices where our (count, digest) disagrees with a
    peer's RANGE_DIGEST response; defensive about old-dialect/junk
    shapes (everything diverged → whole-range sync, never a crash)."""
    try:
        p_counts, p_digests = list(resp[2]), list(resp[3])
    except TypeError:
        p_counts, p_digests = [], []
    if len(p_counts) != nb or len(p_digests) != nb:
        p_counts = [-1] * nb
        p_digests = [0] * nb
    return [
        b
        for b in range(nb)
        if (counts[b], digests[b]) != (p_counts[b], p_digests[b])
    ]


async def _pull_diverged_from_peer(
    my_shard, name, tree, peer, start, end, nb
) -> int:
    """Pull-only half of the anti-entropy exchange: compare per-bucket
    digests with one peer and apply (strictly-newer) everything in the
    diverged buckets.  Returns entries applied."""
    from ..cluster.messages import ShardRequest, ShardResponse

    async with my_shard.scheduler.bg_slice():
        counts, digests = await my_shard.compute_range_digests(
            tree, start, end, nb
        )
    resp = await peer.connection.send_request(
        ShardRequest.range_digest(name, start, end, nb)
    )
    msgs.response_to_result(resp, ShardResponse.RANGE_DIGEST)
    diverged = _diverged_buckets(counts, digests, resp, nb)
    if not diverged:
        return 0
    _fetched, applied = await _pull_buckets_from_peer(
        my_shard, name, tree, peer, start, end, diverged, nb
    )
    return applied


async def repair_collection(my_shard: MyShard, name: str) -> None:
    """Re-fetch whatever a quarantined table lost from this
    collection's replicas, then retire the quarantined files.

    Scope: the EXACT owned-range union (MyShard.replica_arcs — the
    same helper the anti-entropy loop walks), one digest-gated pull
    per (arc, replica-of-that-arc).  The old
    (rf-th-distinct-predecessor, self] arc over-approximated the
    union under interleaved multi-shard nodes, importing ranges this
    shard can never serve (ROADMAP open item, now closed); the exact
    arcs also pick each arc's TRUE replicas instead of a blanket
    both-directions node walk.  RF=1 (or a ring with no other node)
    has NO peer holding our data: the honest outcome is the
    lost-data branch, never a pull from a non-replica."""
    col = my_shard.collections.get(name)
    if col is None:
        return
    tree = col.tree
    covered = tree._quarantine_pending
    rf = col.replication_factor
    nb = max(1, my_shard.config.anti_entropy_buckets)
    arcs = my_shard.replica_arcs(rf) if rf > 1 else []
    arcs = [a for a in arcs if a[2]]  # only arcs with live peers
    if not arcs:
        log.warning(
            "repair of %s: no replica holds this shard's data — "
            "whatever only the quarantined table held is LOST; "
            "clearing the suspect state so reads answer again",
            name,
        )
        tree.finish_repair(covered, recovered=False)
        my_shard.flow.notify(FlowEvent.REPAIR_DONE)
        return
    applied = 0
    ok = 0
    for start, end, peers in arcs:
        arc_ok = 0
        for peer in peers:
            try:
                applied += await _pull_diverged_from_peer(
                    my_shard, name, tree, peer, start, end, nb
                )
                arc_ok += 1
            except (DbeelError, OSError) as e:
                log.warning(
                    "repair pull of %s from %s failed: %s",
                    name,
                    peer.name,
                    e,
                )
        if arc_ok == 0:
            # Every replica of this arc failed: the arc's lost range
            # is NOT yet recovered — keep the suspect state (reads
            # keep walking to replicas) and retry on a later
            # quarantine/scrub trigger rather than declaring a
            # repair that left a hole.
            log.error(
                "repair of %s: no peer reachable for arc "
                "[%d, %d); will retry",
                name,
                start,
                end,
            )
            return
        ok += arc_ok
    log.info(
        "repair of %s complete: %d entries re-applied over %d arcs "
        "(%d peer pulls)",
        name,
        applied,
        len(arcs),
        ok,
    )
    tree.finish_repair(covered)
    my_shard.flow.notify(FlowEvent.REPAIR_DONE)


SCRUB_CHUNK_PAGES = 64


def _scrub_read_chunk(fd: int, first_page: int, n: int, page_size: int):
    out = []
    for i in range(n):
        raw = os.pread(fd, page_size, (first_page + i) * page_size)
        if len(raw) < page_size:
            raw = raw + b"\x00" * (page_size - len(raw))
        out.append(raw)
    return out


async def _scrub_table(my_shard, tree, table, rate: int) -> None:
    import zlib

    from ..errors import CorruptedFile
    from ..storage.entry import PAGE_SIZE

    for reader, crcs in (
        (table._data, table.sums.data_crcs),
        (table._index, table.sums.index_crcs),
    ):
        page = 0
        npages = len(crcs)
        while page < npages:
            chunk = min(SCRUB_CHUNK_PAGES, npages - page)
            # Short acquire windows per chunk: holding the list
            # refcount for a whole rate-limited table would stall
            # compaction's reader-drain for minutes.
            lst = tree._sstables
            if (
                table not in lst.tables
                or table.index in tree._quarantined_indices
                or reader._fd < 0
            ):
                return  # compacted away / quarantined mid-scrub
            lst.acquire()
            try:
                async with my_shard.scheduler.bg_slice():
                    try:
                        raws = await asyncio.get_event_loop().run_in_executor(
                            None,
                            _scrub_read_chunk,
                            reader._fd,
                            page,
                            chunk,
                            PAGE_SIZE,
                        )
                    except OSError:
                        return  # fd closed under us: table retired
                for j, raw in enumerate(raws):
                    if zlib.crc32(raw) != crcs[page + j]:
                        exc = CorruptedFile(
                            f"{reader.path}: scrub found page "
                            f"{page + j} failing its CRC"
                        )
                        exc.path = reader.path
                        tree._handle_table_corruption(table, exc)
                        return
            finally:
                lst.release()
            my_shard.scrub_bytes_verified += chunk * PAGE_SIZE
            page += chunk
            # Bounded byte rate: cold-block verification must never
            # compete with foreground I/O (Pome's lesson: overlap is
            # where LSM throughput lives).
            await asyncio.sleep(chunk * PAGE_SIZE / rate)


async def run_scrub_loop(my_shard: MyShard) -> None:
    interval = my_shard.config.scrub_interval_ms / 1000.0
    if interval <= 0:
        return
    rate = max(1, my_shard.config.scrub_bytes_per_sec)
    while True:
        await asyncio.sleep(interval)
        from ..storage import checksums

        if not checksums.verification_enabled():
            # DBEEL_NO_CHECKSUMS=1 is the whole-plane kill switch
            # (distrusted sidecars / emergency): the scrub must not
            # keep quarantining behind the operator's back.
            continue
        for _name, col in list(my_shard.collections.items()):
            tables = list(col.tree._sstables.tables)
            for table in tables:
                if table.sums is None:
                    continue  # legacy table: nothing to verify against
                await _scrub_table(my_shard, col.tree, table, rate)
        my_shard.scrub_cycles += 1
        my_shard.flow.notify(FlowEvent.SCRUB_PASS_DONE)


# ----------------------------------------------------------------------
# Gossip server (gossip_server.rs:16-112) — node-managing shard only
# ----------------------------------------------------------------------


class _GossipProtocol(asyncio.DatagramProtocol):
    def __init__(self, my_shard: MyShard) -> None:
        self.my_shard = my_shard

    def datagram_received(self, data: bytes, addr) -> None:
        self.my_shard.spawn(handle_gossip_packet(self.my_shard, data))


async def handle_gossip_packet(my_shard: MyShard, buf: bytes) -> None:
    try:
        source, event, digest = msgs.deserialize_gossip_message(buf)
    except Exception as e:
        log.error("bad gossip packet: %s", e)
        return
    if digest is not None:
        # Telemetry plane: the sender piggybacked its node
        # health digest — absorb it regardless of the event's dedup
        # fate (a re-seen event can still carry a fresher digest).
        my_shard.absorb_health_digest(digest)

    kind = event[0]
    if kind == msgs.GossipEvent.HEALTH and len(event) > 2:
        # Each interval's health digest is a FRESH epidemic: salt the
        # dedup key with the announce seq so the seen-count dedup
        # suppresses copies of ONE announce, not all future ones.
        kind = f"{kind}#{event[2]}"
    key = (source, kind)
    seen = my_shard.gossip_requests.get(key, 0)
    if seen == 0:
        # Every key expires eventually (not only ones that reach the
        # max-seen count): boot-id-salted sources would otherwise
        # accumulate one entry per boot per kind forever.
        async def expire_new():
            await asyncio.sleep(GOSSIP_REQUEST_EXPIRATION_S * 2)
            my_shard.gossip_requests.pop(key, None)

        my_shard.spawn(expire_new())
    if seen >= my_shard.config.gossip_max_seen_count:
        if seen == my_shard.config.gossip_max_seen_count:
            my_shard.gossip_requests[key] = seen + 1

            async def expire():
                await asyncio.sleep(GOSSIP_REQUEST_EXPIRATION_S)
                my_shard.gossip_requests.pop(key, None)

            my_shard.spawn(expire())
        return
    my_shard.gossip_requests[key] = seen + 1
    seen_first_time = seen == 0

    continue_with_gossip = True
    if seen_first_time:
        log.debug("gossip: %r from %s", event, source)
        await my_shard.broadcast_message_to_local_shards(
            ShardEvent.gossip(event)
        )
        continue_with_gossip = await my_shard.handle_gossip_event(event)

    if continue_with_gossip:
        await my_shard.gossip_buffer(buf)


async def run_gossip_server(my_shard: MyShard) -> None:
    loop = asyncio.get_event_loop()
    transport, _ = await loop.create_datagram_endpoint(
        lambda: _GossipProtocol(my_shard),
        local_addr=(my_shard.config.ip, my_shard.config.gossip_port),
    )
    log.info(
        "listening for gossip on %s:%d",
        my_shard.config.ip,
        my_shard.config.gossip_port,
    )
    try:
        await asyncio.Event().wait()  # runs until cancelled
    finally:
        transport.close()


# ----------------------------------------------------------------------
# Failure detector (failure_detector.rs:17-105) — managing shard only
# ----------------------------------------------------------------------


async def run_failure_detector(my_shard: MyShard) -> None:
    interval = my_shard.config.failure_detection_interval_ms / 1000
    while True:
        await asyncio.sleep(interval)
        # Membership anti-entropy: periodically re-gossip our own
        # ALIVE.  A peer that falsely removed us (CPU-starved ping
        # timeout, UDP loss) reset our ALIVE dedup counter inside
        # handle_dead_node, so the next re-announce is accepted and
        # re-adds us — without this, an asymmetric removal only heals
        # if the DEAD accusation happens to reach us (self-defense),
        # and a lost datagram makes the split permanent.  Healthy
        # peers absorb the duplicate through the gossip dedup.
        try:
            await my_shard.gossip(
                msgs.GossipEvent.alive(my_shard.get_node_metadata())
            )
        except Exception as e:
            log.error("alive re-announce failed: %s", e)
        candidates = [
            n for n in my_shard.nodes.values() if n.ids
        ]
        if not candidates:
            continue
        node = random.choice(candidates)
        await asyncio.sleep(interval)
        port = node.remote_shard_base_port + random.choice(node.ids)
        # Detection probes get TIGHT timeouts (bounded blind window):
        # with the config's serving timeouts (5 s connect / 15 s
        # read), a black-holed peer would stay undetected for 15+ s
        # while client ops stall against it.  A ping is tiny — cap
        # its round trip at ~4 detection intervals (floor 1 s), so
        # the worst-case blind window tracks the detector cadence.
        probe_ms = max(1000, int(interval * 4000))
        connection = RemoteShardConnection(
            f"{node.ip}:{port}",
            connect_timeout_ms=min(
                probe_ms,
                my_shard.config.remote_shard_connect_timeout_ms,
            ),
            read_timeout_ms=min(
                probe_ms, my_shard.config.remote_shard_read_timeout_ms
            ),
            write_timeout_ms=min(
                probe_ms,
                my_shard.config.remote_shard_write_timeout_ms,
            ),
        )
        try:
            await connection.ping()
        except DbeelError as e:
            log.info(
                "failed to ping %s (%s): %s",
                node.name,
                connection.address,
                e,
            )
            await my_shard.handle_dead_node(node.name)
            event = msgs.GossipEvent.dead(node.name)
            try:
                await my_shard.broadcast_message_to_local_shards(
                    ShardEvent.gossip(event)
                )
                await my_shard.gossip(event)
                # The accusation must reach the accused: the victim
                # was just popped from my_shard.nodes, so the fanout
                # above can never select it.  Unicast the death
                # certificate so a false positive can self-defend
                # with an ALIVE re-announce.
                await my_shard.gossip_to_node(event, node)
            except Exception as e2:
                log.error("failed to gossip node death: %s", e2)


# ----------------------------------------------------------------------
# Stop event waiter (stop_event_waiter.rs:11-27)
# ----------------------------------------------------------------------


async def wait_for_stop(my_shard: MyShard) -> None:
    await my_shard.stop_event.wait()
    raise ShardStopped(my_shard.shard_name)
