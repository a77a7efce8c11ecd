"""Watch/CDC streaming plane — change feeds that survive kill,
partition, and churn.

The document API was strictly request/response; this module adds a
resumable, loss-free change stream on top of the planes that already
exist:

* **Per-shard change feed** — every acked mutation (client writes,
  replica SET/DELETE/MULTI_SET applies, decided CAS outcomes,
  migration RANGE_PUSH applies, hint replays) funnels through
  ``LSMTree.set_with_timestamp``/``set_batch_with_timestamp``, whose
  ``on_commit`` hook fires at the WAL group-commit release point.
  The hook feeds a bounded in-memory ring stamped with a monotonic
  per-shard ``(boot_epoch, seq)`` cursor.  Evicted history is NOT
  lost: a subscriber whose cursor fell off the ring (or predates the
  current boot) catches up from durable state via the scan plane's
  machinery — every replayed event explicitly dup-flagged, never
  silent.
* **Coordinator fan-out** — ``watch``/``watch_next`` client verbs
  serve CHUNKED event frames.  The coordinator assigns every ring
  arc (``all_arcs``) to one live replica, grouped per replica shard
  (one WATCH_FEED peer page per distinct replica per chunk, ranges
  partitioning the keyspace so feeds never systematically overlap),
  dedups newest-wins per key inside the chunk, and stamps a fully
  self-contained cursor token into EVERY chunk — the stream resumes
  on ANY node, across coordinator death, Overloaded sheds, and
  membership churn.
* **Failure handling** — the cursor carries the membership epoch; a
  stale one refuses retryably as ``not-owned`` mid-migration (the
  migration fence discipline) and the client resyncs.  An arc whose
  replica died or whose bounds changed restarts from durable state
  (``handoff_resumes``), flagged.  Subscribers are admitted through
  the governor in the batch lane with per-subscriber byte budgets:
  slow or greedy watchers shed with the retryable ``Overloaded``
  instead of wedging the shard — the pull model means a stalled
  subscriber holds zero server-side buffer.

Delivery semantics are STATE delivery (etcd-style compaction): for
every acked write ``(k, ts)`` the stream delivers some event
``(k, ts' >= ts)`` after the ack — exactly once, or flagged as a
possible duplicate during catch-up/handoff windows.  Tombstones
arrive as empty values (deletes).  A filter spec (the query dialect)
is evaluated replica-side on the tail path; under a spec, deletes
and non-matching versions are elided — the stream is then a filtered
view, not a full ledger.
"""

from __future__ import annotations

import asyncio
import secrets
import time
from collections import deque
from itertools import islice
from typing import Dict, List, Optional, Tuple

from .. import query as Q
from ..cluster.local_comm import LocalShardConnection
from ..cluster.messages import ShardRequest, ShardResponse
from ..errors import (
    BadFieldType,
    KeyNotOwnedByShard,
    Overloaded,
    PeerDead,
    ProtocolError,
    from_wire,
)
from ..utils import msgpack_codec
from ..utils.murmur import hash_bytes
from . import qos as qos_mod
from . import trace as trace_mod

# w1: the self-contained watch cursor.  Arity lint-pinned
# (analysis/wire_parity.py) against encode_cursor/decode_cursor —
# [version, collection, spec, membership_epoch, sub_id, groups];
# each group [shard_name, ranges, boot, seq, flag_until, catchup,
# flag_ts],
# catchup nil or [range_idx, start_after, probe_boot, probe_seq].
CURSOR_VERSION = "w1"
_CURSOR_ARITY = 6
_GROUP_ARITY = 7
_CATCHUP_ARITY = 4

# Event flag bits (4th element of every delivered event).
FLAG_DUP = 1  # may have been delivered before (catch-up/handoff)

# Commit-lag flag threshold: every state-transfer re-commit (hinted
# handoff replay, anti-entropy heal, read repair, migration ingest)
# applies entries with their ORIGINAL mint timestamp, so it reaches
# the ring well behind the wall clock — and a subscriber may already
# have received that key from a previously-tailed replica before a
# handoff, with the catch-up flag window long closed.  Flagging any
# commit this far behind the clock at the SOURCE keeps the "exactly
# once or explicitly dup-flagged" contract through hint drain.  A
# fresh quorum write commits within milliseconds of minting; a false
# flag (slow legitimate write) is safe — the flag only ever means
# "MAY have been delivered before".
LATE_COMMIT_FLAG_S = 2.0

# The per-group wall-clock flag window (``_FeedGroup.flag_ts``) can
# retire once every event minted inside it would be flagged at the
# source by the commit-lag rule anyway; 2x the threshold leaves no
# boundary gap between the two.
_FLAG_TS_GRACE_NS = int(2 * LATE_COMMIT_FLAG_S * 1e9)

# Per-feed page bounds (the scan plane's discipline).
PAGE_MAX_EVENTS = 4096
PAGE_MIN_BYTES = 4 << 10
ENTRY_OVERHEAD = 24

# Long-poll clamp: an empty chunk parks at most this long on the
# LOCAL ring before answering empty (remote-arc events surface on
# the next poll — the client's backoff is the latency bound there).
WAIT_MAX_S = 2.0

# Subscriber registry TTL: a sub_id not seen for this long stops
# counting toward the subscribers gauge and frees its byte bucket.
SUB_TTL_S = 60.0

# Soft-level pacing (scan.py's bounded-park discipline).
PACE_SLICE_S = 0.05
PACE_MAX_S = 2.0

# after_seq sentinel: position probe — no events, just the ring's
# current (boot_epoch, seq).
_PROBE = -1

# Per-subscriber byte bucket burst: seconds of the refill rate
# (--watch-bytes-per-slice per second) a subscriber may consume at
# once before shedding.
_BUCKET_BURST_S = 2.0

# Unpacked client filter specs, keyed by the raw blob (the tail path
# re-evaluates the same spec on every event — validate once).
_spec_cache: dict = {}


def _spec_where(spec_raw: bytes):
    w = _spec_cache.get(spec_raw)
    if w is None:
        if len(_spec_cache) > 256:
            _spec_cache.clear()
        try:
            where, agg = Q.unpack_spec(spec_raw)
        except BadFieldType:
            raise
        except Exception as e:
            raise BadFieldType(f"spec: {e}") from e
        if agg is not None:
            raise BadFieldType("spec: aggregate with a watch")
        w = _spec_cache[spec_raw] = where
    return w


def encode_cursor(
    collection: str,
    spec: Optional[bytes],
    epoch: int,
    sub_id: str,
    groups: List["_FeedGroup"],
) -> bytes:
    """Opaque resumable cursor: self-contained, so ANY node can
    continue the stream — across coordinator death, sheds, and
    fail-over.  Re-stamped with the CURRENT membership epoch every
    chunk, so a long-lived subscriber never goes stale-fenced while
    it keeps polling."""
    return msgpack_codec.packb(
        [
            CURSOR_VERSION,
            collection,
            spec,
            epoch,
            sub_id,
            [
                [
                    g.shard_name,
                    g.ranges,
                    g.boot,
                    g.seq,
                    g.flag_until,
                    g.catchup,
                    g.flag_ts,
                ]
                for g in groups
            ],
        ]
    )


def decode_cursor(raw) -> dict:
    if not isinstance(raw, (bytes, bytearray)):
        raise BadFieldType("cursor")
    try:
        w = msgpack_codec.unpackb(bytes(raw))
    except Exception as e:
        raise BadFieldType(f"cursor: {e}") from e
    if (
        not isinstance(w, list)
        or len(w) != _CURSOR_ARITY
        or w[0] != CURSOR_VERSION
        or not isinstance(w[1], str)
        or not isinstance(w[3], int)
        or not isinstance(w[4], str)
        or not isinstance(w[5], list)
    ):
        raise BadFieldType("cursor: unknown version or shape")
    groups = []
    for g in w[5]:
        if not isinstance(g, (list, tuple)) or len(g) != _GROUP_ARITY:
            raise BadFieldType("cursor: group shape")
        name, ranges, boot, seq, flag_until, catchup, flag_ts = g
        if not isinstance(name, str) or not isinstance(ranges, list):
            raise BadFieldType("cursor: group shape")
        try:
            ranges = [[int(r[0]), int(r[1])] for r in ranges]
        except Exception as e:
            raise BadFieldType(f"cursor: ranges ({e})") from e
        if catchup is not None:
            if (
                not isinstance(catchup, (list, tuple))
                or len(catchup) != _CATCHUP_ARITY
            ):
                raise BadFieldType("cursor: catchup shape")
            catchup = [
                int(catchup[0]),
                bytes(catchup[1]) if catchup[1] is not None else None,
                int(catchup[2]),
                int(catchup[3]),
            ]
        groups.append(
            {
                "shard_name": name,
                "ranges": ranges,
                "boot": int(boot),
                "seq": int(seq),
                "flag_until": int(flag_until),
                "catchup": catchup,
                "flag_ts": int(flag_ts),
            }
        )
    return {
        "collection": w[1],
        "spec": bytes(w[2]) if w[2] is not None else None,
        "epoch": w[3],
        "sub_id": w[4],
        "groups": groups,
    }


class _FeedGroup:
    """One replica shard's tail feed over its assigned ring arcs."""

    __slots__ = (
        "shard_name",
        "ranges",
        "boot",  # -1 = fresh group, init-probe to start at the tail
        "seq",
        "flag_until",  # tail events with seq <= this are dup-flagged
        "catchup",  # [range_idx, start_after, probe_boot, probe_seq]
        # Wall-clock flag window: tail events MINTED at or before
        # this (ns) are dup-flagged too.  Closes the replication-lag
        # gap the seq window cannot: a write the subscriber already
        # received from the PREVIOUS replica may still be in flight
        # to this one when the catch-up's closing probe runs, so it
        # lands past flag_until with a fresh-looking seq.  Events
        # minted before the catch-up completed are exactly the ones
        # that could have been delivered elsewhere first.
        "flag_ts",
        "shard",  # ring entry; None = serve locally
    )

    def __init__(self, shard_name, ranges, shard):
        self.shard_name = shard_name
        self.ranges = ranges
        self.boot = -1
        self.seq = 0
        self.flag_until = 0
        self.catchup = None
        self.flag_ts = 0
        self.shard = shard


def _feed_result(resp) -> tuple:
    """(events, boot_epoch, tail_seq, status) out of a WATCH_FEED
    peer response list."""
    if (
        not isinstance(resp, (list, tuple))
        or len(resp) < 2
        or resp[0] != "response"
    ):
        raise ProtocolError(f"not a response: {resp!r}")
    if resp[1] == ShardResponse.ERROR:
        raise from_wire(resp[2:4])
    if resp[1] != ShardResponse.WATCH_FEED or len(resp) < 6:
        raise ProtocolError(
            f"expected watch_feed response, got {resp[1]!r}"
        )
    events = resp[2] if isinstance(resp[2], (list, tuple)) else []
    return events, int(resp[3]), int(resp[4]), int(resp[5])


class WatchPlane:
    """Per-shard change ring (replica role) + watch fan-out
    (coordinator role) + counters (exported as ``get_stats.watch``)."""

    def __init__(self, shard, config) -> None:
        self.shard = shard
        self.config = config
        # ---- replica role: the change ring -------------------------
        # boot_epoch makes (boot_epoch, seq) monotonic ACROSS process
        # restarts under the same loosely-synced wall clock the LWW
        # timestamps already assume: a restarted shard's ring starts
        # a new epoch, and any cursor from the old one catches up
        # from durable state.
        self.boot_epoch = int(time.time() * 1000)
        self.seq = 0
        self.ring: deque = deque(maxlen=max(16, config.watch_ring))
        self._ring_events: Dict[str, asyncio.Event] = {}
        # ---- counters (stats-schema lint: all exported below) ------
        self.watches_started = 0
        self.chunks = 0
        self.events_delivered = 0
        self.bytes_streamed = 0
        self.cursor_resumes = 0
        self.catchup_replays = 0
        self.ring_evictions = 0
        self.handoff_resumes = 0
        self.dup_flagged = 0
        self.late_commit_flags = 0
        self.sheds = 0
        self.fence_refusals = 0
        self.feed_pages = 0
        self.pages_pulled = 0
        self.paced = 0
        self.paced_s = 0.0
        self.native_suspends = 0
        self.active_chunks = 0
        # Chunks currently parked in an empty-ring long-poll wait.
        # The governor subtracts this from its admitted-ops signal:
        # a park holds an event-wait and some registry bytes, not a
        # CPU queue slot, and counting it as work would let a big
        # idle-subscriber pool push the shard to hard overload and
        # shed REAL traffic.  Watch admission is the subscriber cap
        # + per-subscriber byte buckets, not the ops ledger.
        self.parked_chunks = 0
        # sub_id -> [last_seen_mono, bucket_tokens, refill_mono,
        #            last_local_tail_seq|None] (the lag gauge compares
        # local tails against this ring's head).
        self._subs: Dict[str, list] = {}
        self._native_suspended: set = set()

    def stats(self) -> dict:
        self._prune_subs()
        lag = 0
        for e in self._subs.values():
            if e[3] is not None:
                lag = max(lag, self.seq - e[3])
        return {
            "subscribers": len(self._subs),
            "watches_started": self.watches_started,
            "chunks": self.chunks,
            "events_delivered": self.events_delivered,
            "bytes_streamed": self.bytes_streamed,
            "cursor_resumes": self.cursor_resumes,
            "catchup_replays": self.catchup_replays,
            "ring_evictions": self.ring_evictions,
            "handoff_resumes": self.handoff_resumes,
            "dup_flagged": self.dup_flagged,
            "late_commit_flags": self.late_commit_flags,
            "sheds": self.sheds,
            "fence_refusals": self.fence_refusals,
            "feed_pages": self.feed_pages,
            "pages_pulled": self.pages_pulled,
            "paced": self.paced,
            "paced_s": round(self.paced_s, 3),
            "native_suspends": self.native_suspends,
            "active_chunks": self.active_chunks,
            "parked_chunks": self.parked_chunks,
            "ring_seq": self.seq,
            "ring_len": len(self.ring),
            "lag_events": lag,
            "ring_capacity": self.config.watch_ring,
            "max_subscribers": self.config.watch_max_subscribers,
            "bytes_per_slice": self.config.watch_bytes_per_slice,
        }

    # -- replica role: feed + publish ----------------------------------

    def publish(self, collection: str, key, value, ts: int) -> None:
        """The LSMTree ``on_commit`` hook target: one acked mutation
        enters the ring at the WAL group-commit release point.  A
        commit whose timestamp lags the wall clock by more than
        LATE_COMMIT_FLAG_S is a state-transfer re-apply (hint
        replay, anti-entropy, read repair, migration) and is
        dup-flagged at the source — see the constant's comment."""
        ts = int(ts)
        flags = 0
        if ts < int((time.time() - LATE_COMMIT_FLAG_S) * 1e9):
            flags = FLAG_DUP
            self.late_commit_flags += 1
        if len(self.ring) == self.ring.maxlen:
            self.ring_evictions += 1
        self.seq += 1
        self.ring.append(
            (self.seq, collection, bytes(key), bytes(value), ts,
             flags)
        )
        evt = self._ring_events.get(collection)
        if evt is not None and not evt.is_set():
            evt.set()

    def _listen(self, collection: str) -> asyncio.Event:
        """Current-publish event for ONE collection: set once on its
        next publish (the flush_start_event.listen() idiom — publish
        swaps a fresh Event in so late listeners never miss a set).
        Per-collection so a thousand idle watchers parked on a quiet
        collection do not wake (and re-poll) on every write to a hot
        one — publish pays one dict probe either way."""
        evt = self._ring_events.get(collection)
        if evt is None or evt.is_set():
            self._ring_events[collection] = evt = asyncio.Event()
        return evt

    def suspend_native(self, name: str) -> None:
        """First watch interest in a collection suspends its native
        fast path (sticky, like a quarantine suspension): writes the
        C plane serves never cross the Python commit hook, so a
        watched collection must route every write through the
        interpreted path or the ring would silently miss events.
        Writes already served in C before suspension are durable —
        the catch-up scan covers them."""
        if name in self._native_suspended:
            return
        self._native_suspended.add(name)
        shard = self.shard
        if getattr(shard, "dataplane", None) is not None:
            try:
                shard.dataplane.unregister(name)
                self.native_suspends += 1
            except Exception:
                # Not registered / stale .so: the interpreted path
                # already owns the collection's writes.
                pass

    def feed_page(
        self,
        collection: str,
        boot_epoch: int,
        after_seq: int,
        ranges,
        limit: int,
        max_bytes: int,
        spec: Optional[bytes],
    ) -> Tuple[list, int, int, int]:
        """One WATCH_FEED page off the local ring: events strictly
        after ``after_seq`` of ``boot_epoch``, ascending by seq,
        filtered to the collection, the key-hash ranges, and the
        optional spec.  Status 1 = the position is not servable from
        the ring (older boot, or evicted) — the coordinator must
        catch up from durable state.  The O(1) empty fast path is
        the idle-watcher scalability hinge: a thousand idle polls
        cost a thousand integer compares, not a thousand ring
        walks."""
        self.feed_pages += 1
        if after_seq == _PROBE:
            return [], self.boot_epoch, self.seq, 0
        first = self.seq - len(self.ring)
        if boot_epoch != self.boot_epoch or after_seq < first:
            return [], self.boot_epoch, self.seq, 1
        if after_seq >= self.seq:
            return [], self.boot_epoch, self.seq, 0
        where = _spec_where(bytes(spec)) if spec is not None else None
        in_range = self.shard._in_ae_range
        events: list = []
        out = 0
        tail = after_seq
        for ev in islice(self.ring, after_seq - first, None):
            seq, col, key, value, ts, fl = ev
            tail = seq
            if col != collection:
                continue
            if ranges:
                h = hash_bytes(key)
                if not any(
                    in_range(h, r[0], r[1]) for r in ranges
                ):
                    continue
            if spec is not None and not Q.match_entry(
                where, key, value
            ):
                continue
            events.append([key, value, ts, seq, fl])
            out += len(key) + len(value) + ENTRY_OVERHEAD
            if len(events) >= limit or out >= max_bytes:
                break
        return events, self.boot_epoch, tail, 0

    # -- subscriber registry / byte buckets ----------------------------

    def _prune_subs(self) -> None:
        now = time.monotonic()
        dead = [
            k
            for k, e in self._subs.items()
            if now - e[0] > SUB_TTL_S
        ]
        for k in dead:
            del self._subs[k]

    def _bucket_admit(self, sub_id: str) -> bool:
        """Refill-and-check the subscriber's byte bucket (capacity =
        burst seconds of --watch-bytes-per-slice per second).  The
        bucket may go negative on a served chunk (a chunk is never
        truncated for it); the NEXT chunk sheds until it refills."""
        now = time.monotonic()
        rate = float(max(1, self.config.watch_bytes_per_slice))
        cap = _BUCKET_BURST_S * rate
        e = self._subs.get(sub_id)
        if e is None:
            self._subs[sub_id] = [now, cap, now, None]
            return True
        e[1] = min(cap, e[1] + (now - e[2]) * rate)
        e[2] = now
        e[0] = now
        return e[1] > 0

    def _bucket_charge(self, sub_id: str, n: int) -> None:
        e = self._subs.get(sub_id)
        if e is not None:
            e[1] -= n

    def _note_local_tail(self, sub_id: str, tail: int) -> None:
        e = self._subs.get(sub_id)
        if e is not None:
            e[3] = tail

    # -- admission -----------------------------------------------------

    def _shed(self, why: str, cls: Optional[int] = None):
        self.sheds += 1
        if cls is not None:
            self.shard.qos.note_shed(cls)
        return Overloaded(f"watch chunk shed: {why}")

    async def _admit(self, ctx, cls: int = qos_mod.QOS_BATCH) -> None:
        from .governor import LEVEL_HARD, LEVEL_SOFT

        gov = self.shard.governor
        if gov.class_level(cls) >= LEVEL_HARD:
            raise self._shed(
                f"shard {self.shard.shard_name} at hard overload "
                f"for {qos_mod.CLASS_NAMES[cls]}-class work",
                cls,
            )
        if gov.class_level(cls) >= LEVEL_SOFT:
            if gov.memtable_only_soft(cls):
                self.paced += 1
                self.paced_s += PACE_SLICE_S
                await asyncio.sleep(PACE_SLICE_S)
            else:
                self.paced += 1
                waited = 0.0
                while (
                    waited < PACE_MAX_S
                    and gov.class_level(cls) >= LEVEL_SOFT
                    and not gov.memtable_only_soft(cls)
                ):
                    if gov.class_level(cls) >= LEVEL_HARD:
                        raise self._shed(
                            "hard overload during watch pacing", cls
                        )
                    await asyncio.sleep(PACE_SLICE_S)
                    waited += PACE_SLICE_S
                self.paced_s += waited
        if ctx is not None:
            ctx.mark("pace")

    # -- coordinator role: the chunk loop ------------------------------

    async def handle(self, request: dict, rtype: str) -> bytes:
        """One watch/watch_next client frame → one chunk payload
        {"events": [[key, value, ts, flags], ...], "cursor": bin}.
        The cursor is present in EVERY chunk; value b"" = delete."""
        my_shard = self.shard
        deadline_ms = request.get("deadline_ms")
        if (
            isinstance(deadline_ms, int)
            and deadline_ms > 0
            and time.time() * 1000.0 > deadline_ms
        ):
            my_shard.governor.deadline_drops += 1
            raise Overloaded(
                "client deadline expired before the watch chunk ran"
            )
        if rtype == "watch":
            collection = request.get("collection")
            if not isinstance(collection, str):
                raise BadFieldType("collection")
            spec_raw = request.get("spec")
            if spec_raw is not None:
                spec_raw = bytes(spec_raw)
                _spec_where(spec_raw)  # validate before first use
            sub_id = request.get("sub_id")
            if not isinstance(sub_id, str) or not sub_id:
                sub_id = secrets.token_hex(8)
            groups_wire = None
            self.watches_started += 1
        else:  # watch_next
            cur = decode_cursor(request.get("cursor"))
            collection = cur["collection"]
            spec_raw = cur["spec"]
            sub_id = cur["sub_id"]
            # Membership-epoch fence (the migration fence discipline): a
            # cursor stamped before the current churn began may map
            # arcs that moved mid-migration — refuse retryably, the
            # client resyncs metadata and retries the SAME cursor
            # (which this node then re-stamps with the new epoch).
            epoch = cur["epoch"]
            if (
                isinstance(epoch, int)
                and epoch > 0
                and epoch < my_shard.membership_epoch
                and my_shard._migration_tasks
            ):
                my_shard.fence_refusals += 1
                self.fence_refusals += 1
                raise KeyNotOwnedByShard(
                    f"watch cursor epoch {epoch} predates membership "
                    f"epoch {my_shard.membership_epoch} mid-migration"
                )
            groups_wire = cur["groups"]
            self.cursor_resumes += 1

        ctx = trace_mod.current()
        q = request.get("qos")
        cls = (
            qos_mod.class_of(q) if q is not None else qos_mod.QOS_BATCH
        )
        tenant = qos_mod.request_tenant(request)
        col = my_shard.get_collection(collection)
        self.suspend_native(collection)
        my_shard.qos.charge_ops(tenant, collection, 1)
        self._prune_subs()
        cap = self.config.watch_max_subscribers
        if (
            cap > 0
            and sub_id not in self._subs
            and len(self._subs) >= cap
        ):
            raise self._shed(
                f"{len(self._subs)} watch subscribers already "
                "registered",
                cls,
            )
        if not self._bucket_admit(sub_id):
            raise self._shed(
                f"subscriber {sub_id} over its byte budget", cls
            )
        wait_ms = request.get("wait_ms")
        wait_s = (
            min(WAIT_MAX_S, wait_ms / 1000.0)
            if isinstance(wait_ms, int) and wait_ms > 0
            else 0.0
        )
        self.active_chunks += 1
        began = False
        try:
            await self._admit(ctx, cls)
            my_shard.qos.begin(cls)
            began = True
            payload = await self._chunk(
                col,
                collection,
                spec_raw,
                sub_id,
                groups_wire,
                cls,
                wait_s,
                ctx,
            )
            my_shard.qos.charge_bytes(tenant, collection, len(payload))
            self._bucket_charge(sub_id, len(payload))
            return payload
        finally:
            if began:
                my_shard.qos.end(cls)
            self.active_chunks -= 1

    def _reconcile_groups(
        self, col, groups_wire: Optional[list]
    ) -> List[_FeedGroup]:
        """Assign every current ring arc to one live replica shard
        and fold the assignment into feed groups (one per distinct
        replica).  Sticky: arcs prefer a replica the cursor already
        tails, so steady-state chunks keep their positions.  A group
        whose range set changed — churn moved an arc, or its replica
        died/handed off — restarts from durable state with every
        replayed event dup-flagged (state redelivery is correct and
        loss-free; only stale positions are discarded)."""
        my_shard = self.shard
        arcs = my_shard.all_arcs(col.replication_factor)
        old_by_shard = {}
        if groups_wire:
            for g in groups_wire:
                old_by_shard[g["shard_name"]] = g
        assign: Dict[str, list] = {}  # name -> [shard_entry, ranges]
        for start, end, selected in arcs:
            live = [
                s
                for s in selected
                if s.name == my_shard.shard_name
                or s.node_name not in my_shard.dead_nodes
            ]
            if not live:
                raise PeerDead(
                    f"watch: every replica of arc [{start}, {end}) "
                    "is marked Dead"
                )
            pick = next(
                (s for s in live if s.name in old_by_shard), None
            )
            if pick is None:
                pick = next(
                    (
                        s
                        for s in live
                        if s.name == my_shard.shard_name
                    ),
                    live[0],
                )
            entry = assign.get(pick.name)
            if entry is None:
                assign[pick.name] = entry = [
                    None
                    if pick.name == my_shard.shard_name
                    else pick,
                    [],
                ]
            entry[1].append([int(start), int(end)])
        groups: List[_FeedGroup] = []
        for name, (shard_entry, ranges) in assign.items():
            ranges.sort()
            g = _FeedGroup(name, ranges, shard_entry)
            old = old_by_shard.get(name)
            if old is not None and old["ranges"] == ranges:
                g.boot = old["boot"]
                g.seq = old["seq"]
                g.flag_until = old["flag_until"]
                g.catchup = old["catchup"]
                g.flag_ts = old["flag_ts"]
            elif groups_wire is not None:
                # Arc handoff / churn: the position (if any) no
                # longer covers this range set — replay durable
                # state, flagged, then re-tail.
                self.handoff_resumes += 1
                g.catchup = [0, None, 0, 0]  # probe pending
            # groups_wire None = fresh watch: boot stays -1 and the
            # init probe below starts the tail AT NOW (no replay).
            groups.append(g)
        return groups

    async def _peer_call(self, g: _FeedGroup, req: list):
        my_shard = self.shard
        if g.shard is None:
            return await my_shard.handle_shard_request(req)
        if isinstance(g.shard.connection, LocalShardConnection):
            return await g.shard.connection.send_request(
                my_shard.id, req
            )
        return await g.shard.connection.send_request(req)

    async def _fetch_feed(
        self,
        g: _FeedGroup,
        collection: str,
        spec: Optional[bytes],
        page_bytes: int,
        cls: int,
        after_seq: int,
        boot: int,
    ) -> tuple:
        req = ShardRequest.watch_feed(
            collection,
            boot,
            after_seq,
            g.ranges,
            PAGE_MAX_EVENTS,
            page_bytes,
            spec,
            cls,
        )
        resp = await self._peer_call(g, req)
        self.pages_pulled += 1
        return _feed_result(resp)

    async def _catchup_page(
        self,
        g: _FeedGroup,
        collection: str,
        spec: Optional[bytes],
        where,
        page_bytes: int,
        cls: int,
        out_events: list,
    ) -> None:
        """One durable-state page of this group's catch-up: scan peer
        frames over the assigned ranges (the scan plane's machinery), every
        entry dup-flagged.  When the last range drains, probe the
        feed once more: tail events at or before that probed seq may
        also be in the scanned state — the flag window — and events
        after it cannot be (the ring is ordered by commit)."""
        if g.catchup[2] == 0 and g.catchup[3] == 0:
            # Start of catch-up: probe the feed position FIRST — the
            # scan view includes everything committed before this
            # point, so the tail resumes here.
            _e, boot, tail, _s = await self._fetch_feed(
                g, collection, spec, page_bytes, cls, _PROBE, 0
            )
            g.catchup[2] = boot
            g.catchup[3] = tail
            self.catchup_replays += 1
        range_idx = g.catchup[0]
        if range_idx < len(g.ranges):
            start, end = g.ranges[range_idx]
            req = ShardRequest.scan(
                collection,
                start,
                end,
                g.catchup[1],
                None,
                PAGE_MAX_EVENTS,
                page_bytes,
                True,
                None,
                cls,
            )
            resp = await self._peer_call(g, req)
            self.pages_pulled += 1
            if (
                not isinstance(resp, (list, tuple))
                or len(resp) < 4
                or resp[0] != "response"
            ):
                raise ProtocolError(f"not a response: {resp!r}")
            if resp[1] == ShardResponse.ERROR:
                raise from_wire(resp[2:4])
            if resp[1] != ShardResponse.SCAN:
                raise ProtocolError(
                    f"expected scan response, got {resp[1]!r}"
                )
            entries = resp[2] or []
            more = bool(resp[3])
            for key, value, ts in entries:
                key = bytes(key)
                value = bytes(value) if value is not None else b""
                if spec is not None:
                    if not Q.match_entry(where, key, value):
                        continue
                out_events.append([key, value, int(ts), FLAG_DUP])
                self.dup_flagged += 1
            if entries:
                g.catchup[1] = bytes(entries[-1][0])
            if not more:
                g.catchup[0] = range_idx + 1
                g.catchup[1] = None
            return
        # Every range drained: close the flag window with a second
        # probe and resume the tail from the FIRST probe's position.
        _e, boot, tail, _s = await self._fetch_feed(
            g, collection, spec, page_bytes, cls, _PROBE, 0
        )
        g.boot = g.catchup[2]
        g.seq = g.catchup[3]
        g.flag_until = tail if boot == g.catchup[2] else 0
        g.flag_ts = time.time_ns()
        g.catchup = None

    async def _serve_groups(
        self,
        groups: List[_FeedGroup],
        collection: str,
        spec: Optional[bytes],
        where,
        sub_id: str,
        page_bytes: int,
        cls: int,
        out_events: list,
    ) -> None:
        for g in groups:
            if g.catchup is not None:
                await self._catchup_page(
                    g,
                    collection,
                    spec,
                    where,
                    page_bytes,
                    cls,
                    out_events,
                )
                continue
            if g.boot == -1:
                # Fresh group: start the tail at the ring's head —
                # a new watch observes from NOW.
                _e, boot, tail, _s = await self._fetch_feed(
                    g, collection, spec, page_bytes, cls, _PROBE, 0
                )
                g.boot = boot
                g.seq = tail
                if g.shard is None:
                    self._note_local_tail(sub_id, tail)
                continue
            events, boot, tail, status = await self._fetch_feed(
                g,
                collection,
                spec,
                page_bytes,
                cls,
                g.seq,
                g.boot,
            )
            if status != 0:
                # The position fell off the ring (or the replica
                # rebooted): replay durable state, flagged.
                g.catchup = [0, None, 0, 0]
                continue
            if g.flag_ts and (
                time.time_ns() - g.flag_ts > _FLAG_TS_GRACE_NS
            ):
                # Anything minted before flag_ts now publishes at
                # least LATE_COMMIT_FLAG_S behind the clock, so the
                # source-side flag takes over — drop the window.
                g.flag_ts = 0
            for key, value, ts, seq, fl in events:
                flags = int(fl)
                if g.flag_until and seq <= g.flag_until:
                    flags |= FLAG_DUP
                if g.flag_ts and int(ts) <= g.flag_ts:
                    flags |= FLAG_DUP
                if flags:
                    self.dup_flagged += 1
                out_events.append(
                    [bytes(key), bytes(value), int(ts), flags]
                )
            g.boot = boot
            g.seq = tail
            if g.flag_until and tail >= g.flag_until:
                g.flag_until = 0
            if g.shard is None:
                self._note_local_tail(sub_id, tail)

    async def _chunk(
        self,
        col,
        collection: str,
        spec_raw: Optional[bytes],
        sub_id: str,
        groups_wire: Optional[list],
        cls: int,
        wait_s: float,
        ctx,
    ) -> bytes:
        my_shard = self.shard
        where = (
            _spec_where(spec_raw) if spec_raw is not None else None
        )
        groups = self._reconcile_groups(col, groups_wire)
        budget = self.config.watch_bytes_per_slice
        page_bytes = max(
            PAGE_MIN_BYTES, budget // max(1, len(groups))
        )
        events: list = []
        await self._serve_groups(
            groups,
            collection,
            spec_raw,
            where,
            sub_id,
            page_bytes,
            cls,
            events,
        )
        if ctx is not None:
            ctx.mark("iterate")
        if not events and wait_s > 0 and all(
            g.catchup is None for g in groups
        ):
            # Long-poll: park on the LOCAL ring (bounded) — a local
            # publish wakes the chunk for one more serve round;
            # remote-arc events surface on the client's next poll.
            evt = self._listen(collection)
            self.parked_chunks += 1
            try:
                await asyncio.wait_for(evt.wait(), wait_s)
            except asyncio.TimeoutError:
                pass
            finally:
                self.parked_chunks -= 1
            await self._serve_groups(
                groups,
                collection,
                spec_raw,
                where,
                sub_id,
                page_bytes,
                cls,
                events,
            )
        if len(events) > 1:
            # Newest-wins per-key dedup inside the chunk (state
            # delivery): keep each key's newest version, preserving
            # the dup flag if ANY occurrence carried it.
            newest: dict = {}
            for ev in events:
                cur = newest.get(ev[0])
                if cur is None:
                    newest[ev[0]] = ev
                else:
                    if ev[2] >= cur[2]:
                        ev[3] |= cur[3]
                        newest[ev[0]] = ev
                    else:
                        cur[3] |= ev[3]
            events = list(newest.values())
        cursor = encode_cursor(
            collection,
            spec_raw,
            my_shard.membership_epoch,
            sub_id,
            groups,
        )
        payload = msgpack_codec.packb(
            {"events": events, "cursor": cursor}
        )
        self.chunks += 1
        self.events_delivered += len(events)
        self.bytes_streamed += len(payload)
        if ctx is not None:
            ctx.mark("merge")
        return payload
