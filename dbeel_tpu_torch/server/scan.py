"""Streaming scan/range query plane — coordinator side.

The storage layer has had ordered iteration and exact range machinery
since the anti-entropy plane, but the only client-visible reads were
point/multi gets: an analytics-shaped workload paid one request round
trip per key.  This module turns the range machinery into a public,
governed, resumable streaming query:

* ``scan`` / ``scan_next`` client verbs produce CHUNKED responses —
  one byte-budgeted chunk per request frame, with an opaque resumable
  cursor token in the trailer (nil cursor = scan complete).  The
  cursor is fully self-contained (collection, position, filters,
  remaining limit), so it survives a coordinator restart, an
  ``Overloaded`` shed, and a client fail-over to a different node.
* The coordinator merges per-arc replica streams: for every ring arc
  (``MyShard.all_arcs``) it pages SCAN peer frames from EVERY replica
  of that arc (RANGE_PULL-style stateless pages, served storage-side
  by the vectorized ScanStage), dedups equal keys newest-timestamp-
  wins — so a healed-but-stale replica can never resurrect an old
  value into the stream — and drops tombstone winners.  Peer pages
  ride the pooled round-trip streams, NOT the pipelined per-op stream
  (the same head-of-line exclusion RANGE_* has: a 256 KiB page parked
  in front of quorum acks would stall point ops).
* Every chunk is admitted through the governor: shed with the
  retryable ``Overloaded`` at the hard level or past
  ``--scan-max-concurrent``, parked (bounded) at the soft level
  before any byte moves, and capped at ``--scan-bytes-per-slice``
  emitted bytes — one analytics scan cannot starve point ops.
* ``count`` / key-prefix pushdown: keys-only peer pages (live values
  elided replica-side) mean a count or filtered key listing never
  materializes a value anywhere.

Ordering is raw encoded-key byte order (the storage order).  Chunks
are independently-admitted point-in-time pages, not one global
snapshot: a scan concurrent with writes sees each key's newest value
as of the chunk that covered it.
"""

from __future__ import annotations

import asyncio
import contextvars
import time
from bisect import bisect_left as _bisect_left
from itertools import accumulate as _accumulate
from operator import itemgetter
from typing import List, Optional, Tuple

from .. import query as Q
from ..cluster.local_comm import LocalShardConnection
from ..cluster.messages import ShardRequest, ShardResponse
from ..errors import (
    BadFieldType,
    DbeelError,
    Overloaded,
    PeerDead,
    ProtocolError,
    from_wire,
)
from ..utils import msgpack_codec
from . import qos as qos_mod
from . import trace as trace_mod

# The QoS class of the chunk currently being served in this task tree
# (QoS plane): set by handle(), read by _fetch_page so every
# peer page of the chunk is stamped with the same lane — asyncio tasks
# copy the context, so concurrent chunks of different classes cannot
# cross-stamp.  Scans default to the BATCH lane (analytics must not
# starve interactive point ops); an operator may stamp a scan
# interactive/standard via the client `qos` field.
_CHUNK_QOS: contextvars.ContextVar = contextvars.ContextVar(
    "dbeel_scan_qos", default=None
)

_key0 = itemgetter(0)

# s2 (query compute plane): the cursor grew the packed
# filter/aggregate spec and the partial-aggregate state, keeping it
# self-contained — a filtered scan resumes on ANY node with its
# predicate and its running aggregates intact.  Arity is lint-pinned
# (analysis/wire_parity.py) against encode_cursor/decode_cursor.
CURSOR_VERSION = "s2"
_CURSOR_ARITY = 10

# Spec dialect this coordinator parses (query.py owns the grammar).
# Lint-pinned three ways against query.SPEC_VERSION (the encoder)
# and the C client's kSpecVersion (the pass-through emit).
SPEC_WIRE_VERSION = "q1"

# Per-stream page bounds: entries per SCAN peer frame, and the floor
# of the per-stream byte budget (the chunk budget splits across arcs;
# tiny splits would turn one chunk into dozens of round trips).
PAGE_MAX_ENTRIES = 4096
PAGE_MIN_BYTES = 16 << 10

# Soft-level pacing: scans park in these slices (bounded) while the
# governor reads soft overload — point ops drain first, the scan
# resumes the moment pressure lifts (bg_gate's discipline with
# scan-plane accounting).
PACE_SLICE_S = 0.05
PACE_MAX_S = 2.0

# Share pacing (the bg_slice discipline at CHUNK granularity): while
# POINT data ops completed within this window, each served chunk pays
# back ``elapsed * fg/bg`` of idle before the next chunk is admitted
# — scans get the background share of the CPU while point traffic is
# live and the whole CPU when the shard is otherwise idle.  Keyed off
# metrics.last_point_op_mono, NOT the scheduler's fg window: the
# scan's own chunk frames mark that window, and using it would make
# scans throttle themselves on an idle shard (measured 4-5x).
PACE_POINT_WINDOW_S = 0.25
PACE_PAYBACK_MAX_S = 0.5

# Wire overhead charged per emitted entry (mirrors the storage-side
# budget accounting).
ENTRY_OVERHEAD = 16

_NO_LIMIT = -1

# Packed peer specs, keyed by (client spec blob, mode): one scan
# re-packs the same peer spec for every page of every stream —
# cache the two possible encodings instead.
_peer_spec_cache: dict = {}


def pack_peer_spec_cached(
    spec_raw: bytes, where, agg, mode: str
) -> bytes:
    k = (spec_raw, mode)
    v = _peer_spec_cache.get(k)
    if v is None:
        if len(_peer_spec_cache) > 256:
            _peer_spec_cache.clear()
        v = _peer_spec_cache[k] = Q.pack_peer_spec(
            where, agg, mode
        )
    return v


def iter_winners(batch: list):
    """Newest-wins dedup over one merged batch: sorts by (key, ts
    desc) IN PLACE, then yields ``(key, winner_row)`` once per
    equal-key run — the winner is the highest-timestamp row.  Shared
    by the filtered merge and the aggregate fold so their tie/ts
    semantics can never diverge."""
    batch.sort(key=lambda e: (e[0], -e[2]))
    i = 0
    n = len(batch)
    while i < n:
        key = batch[i][0]
        best = batch[i]
        i += 1
        while i < n and batch[i][0] == key:
            if batch[i][2] > best[2]:
                best = batch[i]
            i += 1
        yield key, best


def _mp_array_header(n: int) -> bytes:
    if n <= 15:
        return bytes([0x90 | n])
    if n <= 0xFFFF:
        return b"\xdc" + n.to_bytes(2, "big")
    return b"\xdd" + n.to_bytes(4, "big")


def pack_chunk(
    entry_parts: list,
    n_entries: int,
    cursor,
    count: int,
    agg=None,
    has_agg: bool = False,
) -> bytes:
    """The chunk payload {"entries": [[key, value], ...], "cursor":
    bin|nil, "count": n} — built by SPLICING the stored key/value
    encodings directly into the stream (they already ARE msgpack
    documents), so the client's single unpack of the chunk decodes
    every document in one C call instead of paying two per-entry
    unpackb round trips.  ``entry_parts`` arrives as the merge
    loop's pre-built fragment list (fixarray(2) marker + key bytes +
    value bytes per entry) so packing is one join, not a second
    per-entry pass.  Byte-identical to what packb would produce for
    the decoded structure.  An aggregate's FINAL chunk carries the
    combined result under "agg" (fixmap grows to 4)."""
    parts = [
        b"\x84" if has_agg else b"\x83",
        b"\xa7entries",
        _mp_array_header(n_entries),
    ]
    parts += entry_parts
    parts.append(b"\xa6cursor")
    parts.append(msgpack_codec.packb(cursor))
    parts.append(b"\xa5count")
    parts.append(msgpack_codec.packb(int(count)))
    if has_agg:
        parts.append(b"\xa3agg")
        parts.append(msgpack_codec.packb(agg))
    return b"".join(parts)


def encode_cursor(
    collection: str,
    last_key: Optional[bytes],
    prefix: Optional[bytes],
    remaining: int,
    count_mode: bool,
    acc_count: int,
    max_bytes: int,
    spec: Optional[bytes] = None,
    agg_state=None,
) -> bytes:
    """Opaque resumable cursor: self-contained, so ANY node can
    continue the scan — across coordinator restarts and Overloaded
    retries.  Filtered scans carry their packed spec and their
    partial-aggregate state inside, so the predicate and the running
    totals survive the same failures the position does."""
    return msgpack_codec.packb(
        [
            CURSOR_VERSION,
            collection,
            last_key,
            prefix,
            remaining,
            count_mode,
            acc_count,
            max_bytes,
            spec,
            agg_state,
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
    ):
        raise BadFieldType("cursor: unknown version or shape")
    return {
        "collection": w[1],
        "last_key": bytes(w[2]) if w[2] is not None else None,
        "prefix": bytes(w[3]) if w[3] else None,
        "remaining": int(w[4]),
        "count": bool(w[5]),
        "acc": int(w[6]),
        "max_bytes": int(w[7]),
        "spec": bytes(w[8]) if w[8] is not None else None,
        "agg_state": w[9],
    }


class _ArcStream:
    """One replica's paged stream over one ring arc."""

    __slots__ = (
        "arc_id",
        "start",
        "end",
        "shard",
        "node_name",
        "buffer",
        "more",
        "cover",
        "start_after",
        "dead",
        "error",
        # Query compute plane: drop-mode aggregate partials
        # parked until the merge bound covers their page (folding
        # early would double-count rows a budget-cut cursor re-pulls)
        "pending",
    )

    def __init__(self, arc_id, start, end, shard, start_after):
        self.arc_id = arc_id
        self.start = start
        self.end = end
        self.shard = shard  # Shard ring entry; None = serve locally
        self.node_name = shard.node_name if shard is not None else None
        self.buffer: list = []
        self.more = True
        self.cover: Optional[bytes] = None
        self.start_after = start_after
        self.dead = False
        self.error: Optional[Exception] = None
        self.pending: list = []  # [(cover, partial_state), ...]


def _scan_result(resp) -> tuple:
    """(entries, more, cover, scanned_rows, scanned_bytes, partial)
    out of a SCAN peer response list.  The trailer fields exist only
    on filtered pages (query compute plane); the base prefix
    is the unfiltered page's shape."""
    if (
        not isinstance(resp, (list, tuple))
        or len(resp) < 2
        or resp[0] != "response"
    ):
        raise ProtocolError(f"not a response: {resp!r}")
    if resp[1] == ShardResponse.ERROR:
        raise from_wire(resp[2:4])
    if resp[1] != ShardResponse.SCAN or len(resp) < 4:
        raise ProtocolError(f"expected scan response, got {resp[1]!r}")
    entries = resp[2] if isinstance(resp[2], (list, tuple)) else []
    if len(resp) >= 8:
        cover = bytes(resp[4]) if resp[4] is not None else None
        return (
            entries,
            bool(resp[3]),
            cover,
            int(resp[5] or 0),
            int(resp[6] or 0),
            resp[7],
        )
    return entries, bool(resp[3]), None, 0, 0, None


class ScanPlane:
    """Per-shard scan admission, pacing, merge, and counters
    (exported as ``get_stats.scan``)."""

    def __init__(self, shard, config) -> None:
        self.shard = shard
        self.config = config
        self.scans_started = 0
        self.chunks = 0
        self.entries_streamed = 0
        self.bytes_streamed = 0
        self.cursor_resumes = 0
        self.sheds = 0
        self.paced = 0
        self.paced_s = 0.0
        self.active_scans = 0
        self.replica_errors = 0
        self.pages_pulled = 0
        self.counts_served = 0
        # Query compute plane: pushdown accounting.
        # rows_scanned counts every arc-member row the predicate
        # examined; rows_returned what survived merge + predicate;
        # bytes_saved = scanned-but-not-shipped value bytes (what
        # client-side filtering would have paid on the wire).
        self.specs_served = 0
        self.rows_scanned = 0
        self.rows_returned = 0
        self.bytes_saved = 0
        self.agg_partials = 0
        self.device_evals = 0
        self.fallback_evals = 0
        # Pages answered via the secondary-index planner —
        # candidate set came from persisted fidx runs, not a full scan.
        self.indexed_evals = 0

    def stats(self) -> dict:
        return {
            "scans_started": self.scans_started,
            "chunks": self.chunks,
            "entries_streamed": self.entries_streamed,
            "bytes_streamed": self.bytes_streamed,
            "cursor_resumes": self.cursor_resumes,
            "sheds": self.sheds,
            "paced": self.paced,
            "paced_s": round(self.paced_s, 3),
            "active_scans": self.active_scans,
            "replica_errors": self.replica_errors,
            "pages_pulled": self.pages_pulled,
            "counts_served": self.counts_served,
            "max_concurrent": self.config.scan_max_concurrent,
            "bytes_per_slice": self.config.scan_bytes_per_slice,
            "filter": {
                "specs_served": self.specs_served,
                "rows_scanned": self.rows_scanned,
                "rows_returned": self.rows_returned,
                "bytes_saved": self.bytes_saved,
                "agg_partials": self.agg_partials,
                "device_evals": self.device_evals,
                "fallback_evals": self.fallback_evals,
                "indexed_evals": self.indexed_evals,
            },
        }

    # -- admission -----------------------------------------------------

    def _shed(self, why: str, cls: Optional[int] = None):
        self.sheds += 1
        if cls is not None:
            # The refused chunk counts in its CLASS's shed column
            # too — the class_starvation watchdog needs scan sheds
            # visible in the lane, not only in scan.sheds.
            self.shard.qos.note_shed(cls)
        return Overloaded(f"scan chunk shed: {why}")

    async def _admit(self, ctx, cls: int = qos_mod.QOS_BATCH) -> None:
        from .governor import LEVEL_HARD, LEVEL_SOFT

        gov = self.shard.governor
        if gov.class_level(cls) >= LEVEL_HARD:
            raise self._shed(
                f"shard {self.shard.shard_name} at hard overload "
                f"for {qos_mod.CLASS_NAMES[cls]}-class work",
                cls,
            )
        cap = self.config.scan_max_concurrent
        # The caller already incremented active_scans (so chunks
        # PARKED in the pacing wait below still hold a slot — a soft
        # window must not let an unbounded backlog of chunks through
        # the cap when pressure lifts): shed when we are the cap+1th.
        if cap > 0 and self.active_scans > cap:
            raise self._shed(
                f"{self.active_scans - 1} scan chunks already in "
                "flight",
                cls,
            )
        if gov.class_level(cls) >= LEVEL_SOFT:
            if gov.memtable_only_soft(cls):
                # A RESTING shard whose arena sits near capacity with
                # no queue/lag/debt pressure (an 88%-fill idle
                # shard parked EVERY chunk the full 2s): pace one
                # slice so the flush keeps priority, then serve —
                # pacing, not parking.  Real backlog (ops, lag, dead
                # completions) keeps the bounded park below.
                self.paced += 1
                self.paced_s += PACE_SLICE_S
                await asyncio.sleep(PACE_SLICE_S)
            else:
                # Park first: scans are the lowest lane.  Bounded —
                # the scan resumes (slower) under sustained soft
                # pressure rather than starving outright.
                self.paced += 1
                waited = 0.0
                while (
                    waited < PACE_MAX_S
                    and gov.class_level(cls) >= LEVEL_SOFT
                    and not gov.memtable_only_soft(cls)
                ):
                    if gov.class_level(cls) >= LEVEL_HARD:
                        raise self._shed(
                            "hard overload during scan pacing", cls
                        )
                    await asyncio.sleep(PACE_SLICE_S)
                    waited += PACE_SLICE_S
                self.paced_s += waited
        if ctx is not None:
            ctx.mark("pace")

    # -- entry point ---------------------------------------------------

    async def handle(self, request: dict, rtype: str) -> bytes:
        """One scan/scan_next client frame → one chunk payload."""
        my_shard = self.shard
        deadline_ms = request.get("deadline_ms")
        if (
            isinstance(deadline_ms, int)
            and deadline_ms > 0
            and time.time() * 1000.0 > deadline_ms
        ):
            my_shard.governor.deadline_drops += 1
            raise Overloaded(
                "client deadline expired before the scan chunk ran"
            )
        agg_state_wire = None
        if rtype == "scan":
            collection = request.get("collection")
            if not isinstance(collection, str):
                raise BadFieldType("collection")
            prefix = request.get("prefix")
            prefix = bytes(prefix) if prefix else None
            limit = request.get("limit")
            remaining = (
                int(limit)
                if isinstance(limit, int) and limit > 0
                else _NO_LIMIT
            )
            count_mode = bool(request.get("count"))
            mb = request.get("max_bytes")
            max_bytes = int(mb) if isinstance(mb, int) and mb > 0 else 0
            last_key = None
            acc = 0
            spec_raw = request.get("spec")
            if spec_raw is not None:
                spec_raw = bytes(spec_raw)
            self.scans_started += 1
            if spec_raw is not None:
                self.specs_served += 1
        else:  # scan_next
            cur = decode_cursor(request.get("cursor"))
            collection = cur["collection"]
            prefix = cur["prefix"]
            remaining = cur["remaining"]
            count_mode = cur["count"]
            max_bytes = cur["max_bytes"]
            last_key = cur["last_key"]
            acc = cur["acc"]
            spec_raw = cur["spec"]
            agg_state_wire = cur["agg_state"]
            self.cursor_resumes += 1

        where = agg = None
        if spec_raw is not None:
            # Validate EVERY time (the spec arrives from the network
            # or a client-held cursor — nothing about it is trusted;
            # a malformed one is a clean classified error, never a
            # shard death) after the cheap version pin.
            if spec_raw[1:4] != b"\xa2" + SPEC_WIRE_VERSION.encode():
                raise BadFieldType("spec: unknown version")
            where, agg = Q.unpack_spec(spec_raw)
            if agg is not None and remaining != _NO_LIMIT:
                raise BadFieldType("spec: limit with an aggregate")
            if agg is not None and count_mode:
                raise BadFieldType(
                    "spec: count mode with an aggregate"
                )

        ctx = trace_mod.current()
        # QoS plane: scans consume the BATCH lane's budget
        # unless the client stamped a class — one analytics stream
        # cannot starve interactive point ops.  The class rides every
        # peer page of the chunk (_CHUNK_QOS → _fetch_page) and the
        # tenant pays one op per chunk plus the chunk's streamed
        # bytes.
        q = request.get("qos")
        cls = (
            qos_mod.class_of(q) if q is not None else qos_mod.QOS_BATCH
        )
        tenant = qos_mod.request_tenant(request)
        col = my_shard.get_collection(collection)
        my_shard.qos.charge_ops(tenant, collection, 1)
        # Hold the concurrency slot across BOTH admission (incl. the
        # soft-level park) and the chunk itself: _admit's cap check
        # counts this increment, so parked chunks cannot pile past
        # the cap and stampede when pressure lifts.
        self.active_scans += 1
        qtok = _CHUNK_QOS.set(cls)
        # Lane accounting begins only once the chunk is ADMITTED —
        # a shed chunk must count in the lane's shed column, never
        # as admitted work (the class_starvation watchdog compares
        # exactly those two rates).
        began = False
        try:
            await self._admit(ctx, cls)
            my_shard.qos.begin(cls)
            began = True
            if spec_raw is not None:
                payload = await self._chunk_filtered(
                    col,
                    collection,
                    last_key,
                    prefix,
                    remaining,
                    count_mode,
                    acc,
                    max_bytes,
                    spec_raw,
                    where,
                    agg,
                    agg_state_wire,
                    ctx,
                )
            else:
                payload = await self._chunk(
                    col,
                    collection,
                    last_key,
                    prefix,
                    remaining,
                    count_mode,
                    acc,
                    max_bytes,
                    ctx,
                )
            my_shard.qos.charge_bytes(tenant, collection, len(payload))
            return payload
        finally:
            # Pacing happens per merge round inside _chunk.
            _CHUNK_QOS.reset(qtok)
            if began:
                my_shard.qos.end(cls)
            self.active_scans -= 1

    async def _pay_share(self, elapsed: float, ctx) -> None:
        """Share payback at merge-ROUND granularity (the bg_slice
        discipline): while point ops are live, each round of scan
        work idles ``elapsed * fg/bg`` before the next — scans get
        the background CPU share under point traffic and the whole
        CPU when the shard is otherwise idle, and the loop occupancy
        between paybacks stays one round (~a page), not one chunk,
        so queued point ops interleave at page cadence."""
        sched = self.shard.scheduler
        if (
            time.monotonic()
            - self.shard.metrics.last_point_op_mono
            > PACE_POINT_WINDOW_S
        ):
            return
        pause = min(
            elapsed * (sched.fg_shares / sched.bg_shares),
            PACE_PAYBACK_MAX_S,
        )
        if pause <= 0:
            return
        self.paced += 1
        self.paced_s += pause
        await asyncio.sleep(pause)
        if ctx is not None:
            ctx.mark("pace")

    # -- peer paging ---------------------------------------------------

    async def _fetch_page(
        self,
        s: _ArcStream,
        collection: str,
        page_bytes: int,
        prefix,
        with_values,
        spec: Optional[bytes] = None,
    ) -> int:
        my_shard = self.shard
        qos_cls = _CHUNK_QOS.get()
        req = ShardRequest.scan(
            collection,
            s.start,
            s.end,
            s.start_after,
            prefix,
            PAGE_MAX_ENTRIES,
            page_bytes,
            with_values,
            spec,
            qos_mod.QOS_BATCH if qos_cls is None else qos_cls,
        )
        if s.shard is None:
            resp = await my_shard.handle_shard_request(req)
        elif isinstance(s.shard.connection, LocalShardConnection):
            resp = await s.shard.connection.send_request(
                my_shard.id, req
            )
        else:
            resp = await s.shard.connection.send_request(req)
        (
            entries, more, cover, srows, sbytes, partial,
        ) = _scan_result(resp)
        if spec is not None and len(resp) < 8:
            # A peer that ignored the spec element (an unfiltered scan
            # handler) would hand back UNFILTERED rows that the
            # merge would accept as matches, with zero scanned-byte
            # billing — fail the stream loudly instead.  (Classified
            # error responses already raised inside _scan_result.)
            raise ProtocolError(
                "filtered scan page missing the spec trailer — "
                "replica does not speak the query compute plane"
            )
        self.pages_pulled += 1
        # Entries arrive as [key, value|nil, ts] lists with bytes
        # keys/values both over the wire (msgpack bin) and from the
        # in-process local path — no per-entry normalization.
        s.buffer = (
            entries if isinstance(entries, list) else list(entries)
        )
        if spec is None:
            s.more = more and bool(s.buffer)
            if s.buffer:
                s.cover = s.buffer[-1][0]
                s.start_after = s.cover
            if not s.buffer:
                s.more = False
            return 0
        # Filtered page: the window advances by SCANNED keys, so the
        # resume point is the response cover even when nothing in
        # the window matched.
        s.more = more
        if cover is not None:
            s.cover = cover
            s.start_after = cover
        elif not s.buffer:
            s.more = False
        self.rows_scanned += srows
        if partial is not None:
            s.pending.append((cover, partial))
        return sbytes

    def _build_streams(
        self, col, last_key
    ) -> Tuple[list, List[_ArcStream]]:
        """(arcs, streams): one _ArcStream per replica per ring arc,
        detector-Dead replicas pre-marked (shared by the plain,
        filtered and aggregate chunk loops)."""
        my_shard = self.shard
        arcs = my_shard.all_arcs(col.replication_factor)
        streams: List[_ArcStream] = []
        for arc_id, (start, end, selected) in enumerate(arcs):
            for shard in selected:
                s = _ArcStream(
                    arc_id,
                    start,
                    end,
                    None
                    if shard.name == my_shard.shard_name
                    else shard,
                    last_key,
                )
                if (
                    s.node_name is not None
                    and s.node_name in my_shard.dead_nodes
                ):
                    s.dead = True
                    s.error = PeerDead(
                        f"scan replica {s.node_name} marked Dead"
                    )
                streams.append(s)
        return arcs, streams

    def _check_arc_liveness(
        self, arcs, streams: List[_ArcStream], skip=()
    ) -> None:
        """A chunk is only correct when at least one replica of
        EVERY (unfinished) arc is still streaming."""
        for arc_id in range(len(arcs)):
            if arc_id in skip:
                continue
            arc_streams = [
                s for s in streams if s.arc_id == arc_id
            ]
            if arc_streams and all(s.dead for s in arc_streams):
                err = next(
                    (
                        s.error
                        for s in arc_streams
                        if s.error is not None
                    ),
                    None,
                )
                if isinstance(err, DbeelError):
                    raise err
                raise PeerDead(
                    f"scan: every replica of arc {arc_id} "
                    f"failed: {err!r}"
                )

    async def _gather_pages(
        self,
        need: List[_ArcStream],
        collection: str,
        page_bytes: int,
        prefix,
        with_values,
        specs: Optional[dict] = None,
    ) -> int:
        """Fetch one page for every stream in ``need`` (specs maps
        arc_id -> packed peer spec); returns total scanned bytes."""
        results = await asyncio.gather(
            *(
                self._fetch_page(
                    s,
                    collection,
                    page_bytes,
                    prefix,
                    with_values,
                    None if specs is None else specs[s.arc_id],
                )
                for s in need
            ),
            return_exceptions=True,
        )
        scanned = 0
        for s, r in zip(need, results):
            if isinstance(r, BaseException):
                if isinstance(r, asyncio.CancelledError):
                    raise r
                s.dead = True
                s.error = r
                self.replica_errors += 1
            else:
                scanned += int(r)
        return scanned

    # -- filtered chunk (query compute plane) ------------------------

    async def _chunk_filtered(
        self,
        col,
        collection: str,
        last_key: Optional[bytes],
        prefix: Optional[bytes],
        remaining: int,
        count_mode: bool,
        acc: int,
        max_bytes: int,
        spec_raw: bytes,
        where,
        agg,
        agg_state_wire,
        ctx,
    ) -> bytes:
        """One chunk of a predicate-pushdown scan/count: replicas
        evaluate the predicate over their staged columns and page by
        bytes SCANNED; this merge dedups newest-wins across every
        arc's replicas BEFORE acceptance is final — a newer tombstone
        or newer non-matching version on any replica suppresses an
        older match — and the chunk budget bills the scanned bytes
        (the work), not the returned bytes (the residue)."""
        if agg is not None:
            return await self._chunk_agg(
                col, collection, prefix, max_bytes, spec_raw,
                where, agg, agg_state_wire, ctx,
            )
        cfg = self.config
        budget = cfg.scan_bytes_per_slice
        if max_bytes > 0:
            budget = min(budget, max_bytes)
        with_values = not count_mode
        arcs, streams = self._build_streams(col, last_key)
        page_bytes = max(PAGE_MIN_BYTES, budget // max(1, len(arcs)))

        emitted_parts: list = []
        emitted_n = 0
        emitted_cost = 0
        scanned_used = 0
        count = acc
        done = False
        limit_hit = False

        while (
            not done and not limit_hit and scanned_used < budget
        ):
            t_round = time.monotonic()
            live = [s for s in streams if not s.dead]
            arcs_live: dict = {}
            for s in live:
                arcs_live[s.arc_id] = arcs_live.get(s.arc_id, 0) + 1
            specs = {
                arc_id: pack_peer_spec_cached(
                    spec_raw,
                    where,
                    None,
                    Q.MODE_MARK if n_live > 1 else Q.MODE_DROP,
                )
                for arc_id, n_live in arcs_live.items()
            }
            need = [
                s
                for s in live
                if s.more and not s.buffer
            ]
            if need:
                scanned_used += await self._gather_pages(
                    need, collection, page_bytes, prefix,
                    with_values, specs,
                )
                self._check_arc_liveness(arcs, streams)
                if ctx is not None:
                    ctx.mark("iterate")
            live = [s for s in streams if not s.dead]
            bound: Optional[bytes] = None
            for s in live:
                if s.more and (bound is None or s.cover < bound):
                    bound = s.cover
            batch: list = []
            for s in live:
                buf = s.buffer
                if bound is None:
                    if buf:
                        batch.extend(buf)
                        s.buffer = []
                else:
                    i = 0
                    while i < len(buf) and buf[i][0] <= bound:
                        i += 1
                    if i:
                        batch.extend(buf[:i])
                        s.buffer = buf[i:]
            if not batch:
                if all(
                    not s.more and not s.buffer for s in live
                ):
                    done = True
                elif bound is not None:
                    # Nothing matched below the bound — the cursor
                    # still advances past the scanned-and-rejected
                    # keyspace.
                    last_key = bound
                await self._pay_share(
                    time.monotonic() - t_round, ctx
                )
                continue
            if max(arcs_live.values(), default=1) == 1 and all(
                len(e) == 3 for e in batch
            ):
                # Fast path — one live (drop-mode) stream per arc:
                # every row is a pre-filtered final match with a
                # unique key, so the round reduces to one C-level
                # sort plus sliced splice emits (the unfiltered
                # chunk loop's discipline; measured ~1.4x on a
                # 100%-selectivity sweep).
                batch.sort(key=_key0)
                idx = 0
                nb = len(batch)
                while idx < nb and not limit_hit:
                    sl = batch[idx : idx + 768]
                    idx += len(sl)
                    if remaining != _NO_LIMIT:
                        sl = sl[:remaining]
                    m = len(sl)
                    count += m
                    self.rows_returned += m
                    if not count_mode and m:
                        emitted_n += m
                        emitted_parts.extend(
                            x
                            for e in sl
                            for x in (b"\x92", e[0], e[1])
                        )
                        emitted_cost += sum(
                            len(e[0])
                            + len(e[1])
                            + ENTRY_OVERHEAD
                            for e in sl
                        )
                    if m:
                        last_key = sl[-1][0]
                    if remaining != _NO_LIMIT:
                        remaining -= m
                        if remaining <= 0:
                            limit_hit = True
                    await asyncio.sleep(0)
                if not limit_hit and bound is not None:
                    last_key = bound
                if ctx is not None:
                    ctx.mark("filter")
                await self._pay_share(
                    time.monotonic() - t_round, ctx
                )
                continue
            # Newest-wins dedup BEFORE predicate acceptance: only a
            # winner that MATCHED counts.
            processed = 0
            for key, best in iter_winners(batch):
                last_key = key
                processed += 1
                if processed % 768 == 0:
                    # Yield on every key run, matched or not: a
                    # low-selectivity mark-mode batch is almost all
                    # rejections and must still interleave point
                    # ops.
                    await asyncio.sleep(0)
                if len(best) >= 4:
                    accepted = bool(best[3])
                else:
                    accepted = True  # drop-mode rows ARE matches
                if not accepted:
                    continue
                count += 1
                self.rows_returned += 1
                if not count_mode:
                    value = best[1]
                    emitted_n += 1
                    emitted_parts.append(b"\x92")
                    emitted_parts.append(key)
                    emitted_parts.append(value)
                    emitted_cost += (
                        len(key)
                        + (len(value) if value is not None else 0)
                        + ENTRY_OVERHEAD
                    )
                if remaining != _NO_LIMIT:
                    remaining -= 1
                    if remaining <= 0:
                        limit_hit = True
                        break
            if not limit_hit and bound is not None:
                # Whole batch merged: everything scanned up to the
                # bound is resolved, matched or not.
                last_key = bound
            if ctx is not None:
                ctx.mark("filter")
            await asyncio.sleep(0)
            await self._pay_share(
                time.monotonic() - t_round, ctx
            )

        self.chunks += 1
        self.entries_streamed += emitted_n
        self.bytes_streamed += emitted_cost
        self.bytes_saved += max(0, scanned_used - emitted_cost)
        cursor = None
        if not done and not limit_hit:
            cursor = encode_cursor(
                collection,
                last_key,
                prefix,
                remaining,
                count_mode,
                count,
                max_bytes,
                spec_raw,
                None,
            )
        if cursor is None and count_mode:
            self.counts_served += 1
        return pack_chunk(emitted_parts, emitted_n, cursor, count)

    async def _chunk_agg(
        self,
        col,
        collection: str,
        prefix: Optional[bytes],
        max_bytes: int,
        spec_raw: bytes,
        where,
        agg,
        agg_state_wire,
        ctx,
    ) -> bytes:
        """One chunk of an aggregate pushdown: every arc progresses
        INDEPENDENTLY (aggregates impose no cross-arc emission
        order), so the cursor records a per-arc position instead of
        one merged key.  Single-live-stream arcs fold exact replica
        partials (no row crosses the wire); replicated arcs under
        possible divergence fold newest-wins winners of mark-mode
        rows — the per-arc partials combine exactly because arcs are
        disjoint key ranges and in-arc replica overlap is resolved
        by dedup before any fold (the overlap rules pinned by
        tests_scan_plane).  A ring-topology change between chunks
        resets the aggregate (correct, merely slower) — partial
        states cannot be mapped across a re-arced keyspace."""
        cfg = self.config
        budget = cfg.scan_bytes_per_slice
        if max_bytes > 0:
            budget = min(budget, max_bytes)
        arcs, streams = self._build_streams(col, None)
        arc_ranges = [[int(a[0]), int(a[1])] for a in arcs]
        # [pos|None, done] per arc, resumed from the cursor when the
        # ring still matches.
        arc_pos: List[list] = [[None, False] for _ in arcs]
        state = Q.AggState(agg)
        if agg_state_wire is not None:
            # The cursor is client-held, untrusted input: every
            # shape/type violation must surface as the classified
            # BadFieldType, never a raw TypeError mid-chunk.
            try:
                saved_ranges, saved_pos, saved_state = agg_state_wire
                ranges = [
                    [int(r[0]), int(r[1])] for r in saved_ranges
                ]
                resumed = [
                    [
                        bytes(p[0]) if p[0] is not None else None,
                        bool(p[1]),
                    ]
                    for p in saved_pos
                ]
            except Exception as e:
                raise BadFieldType(
                    f"cursor: aggregate state shape ({e})"
                ) from e
            if ranges == arc_ranges:
                if len(resumed) != len(arcs):
                    raise BadFieldType(
                        "cursor: aggregate position count drift"
                    )
                arc_pos = resumed
                state = Q.AggState.from_wire(agg, saved_state)
            # else: ring changed — restart clean (reset above).
        for s in streams:
            s.start_after = arc_pos[s.arc_id][0]
        page_bytes = max(PAGE_MIN_BYTES, budget // max(1, len(arcs)))
        scanned_used = 0

        def unfinished(arc_id: int) -> bool:
            return not arc_pos[arc_id][1]

        while scanned_used < budget and any(
            unfinished(a) for a in range(len(arcs))
        ):
            t_round = time.monotonic()
            live = [
                s
                for s in streams
                if not s.dead and unfinished(s.arc_id)
            ]
            arcs_live: dict = {}
            for s in live:
                arcs_live[s.arc_id] = arcs_live.get(s.arc_id, 0) + 1
            specs = {
                arc_id: pack_peer_spec_cached(
                    spec_raw,
                    where,
                    agg,
                    Q.MODE_MARK if n_live > 1 else Q.MODE_DROP,
                )
                for arc_id, n_live in arcs_live.items()
            }
            need = [
                s
                for s in live
                if s.more
                and not s.buffer
                and len(s.pending) < 4
            ]
            if need:
                scanned_used += await self._gather_pages(
                    need, collection, page_bytes, prefix, False,
                    specs,
                )
                self._check_arc_liveness(
                    arcs,
                    streams,
                    skip={
                        a
                        for a in range(len(arcs))
                        if not unfinished(a)
                    },
                )
                if ctx is not None:
                    ctx.mark("iterate")
            progressed = False
            for arc_id in range(len(arcs)):
                if not unfinished(arc_id):
                    continue
                arc_streams = [
                    s
                    for s in streams
                    if s.arc_id == arc_id and not s.dead
                ]
                if not arc_streams:
                    # Every replica of a still-unfinished arc is
                    # gone: the aggregate would silently omit the
                    # arc's rows — fail retryably instead (the
                    # cursor resumes when a replica returns).
                    self._check_arc_liveness(arcs, streams)
                    raise PeerDead(
                        f"aggregate scan: arc {arc_id} lost every "
                        "replica"
                    )
                if len(arc_streams) == 1:
                    s = arc_streams[0]
                    for cover, partial in s.pending:
                        state.fold_partial(partial)
                        if cover is not None:
                            arc_pos[arc_id][0] = cover
                        progressed = True
                    s.pending = []
                    # Mode may have been mark earlier (a replica
                    # died): drain any flagged rows it buffered.
                    if s.buffer:
                        self._fold_mark_rows(
                            state, s.buffer
                        )
                        if s.buffer:
                            arc_pos[arc_id][0] = s.buffer[-1][0]
                        s.buffer = []
                        progressed = True
                    if not s.more and not s.pending:
                        arc_pos[arc_id][1] = True
                else:
                    bound: Optional[bytes] = None
                    for s in arc_streams:
                        if s.more and (
                            bound is None or s.cover < bound
                        ):
                            bound = s.cover
                    batch: list = []
                    for s in arc_streams:
                        buf = s.buffer
                        if bound is None:
                            if buf:
                                batch.extend(buf)
                                s.buffer = []
                        else:
                            i = 0
                            while (
                                i < len(buf)
                                and buf[i][0] <= bound
                            ):
                                i += 1
                            if i:
                                batch.extend(buf[:i])
                                s.buffer = buf[i:]
                        # Drop-mode partials can also arrive here
                        # (the arc was briefly single-live): they
                        # are exact page folds.
                        for cover, partial in s.pending:
                            state.fold_partial(partial)
                            progressed = True
                        s.pending = []
                    if batch:
                        self._fold_mark_rows(state, batch)
                        progressed = True
                    if bound is not None:
                        arc_pos[arc_id][0] = bound
                        progressed = True
                    elif all(
                        not s.more and not s.buffer
                        for s in arc_streams
                    ):
                        arc_pos[arc_id][1] = True
            if ctx is not None:
                ctx.mark("filter")
            if not progressed and not need:
                # Nothing moved this round (all buffers parked past
                # their bounds): avoid a live-lock spin.
                if all(
                    not s.more and not s.buffer and not s.pending
                    for s in streams
                    if not s.dead and unfinished(s.arc_id)
                ):
                    for a in range(len(arcs)):
                        arc_pos[a][1] = True
            await asyncio.sleep(0)
            await self._pay_share(
                time.monotonic() - t_round, ctx
            )

        self.chunks += 1
        self.bytes_saved += scanned_used
        if all(not unfinished(a) for a in range(len(arcs))):
            self.counts_served += 1
            return pack_chunk(
                [], 0, None, 0, state.result(), has_agg=True
            )
        wire = [
            arc_ranges,
            [[p[0], p[1]] for p in arc_pos],
            state.to_wire(),
        ]
        cursor = encode_cursor(
            collection,
            None,
            prefix,
            _NO_LIMIT,
            False,
            0,
            max_bytes,
            spec_raw,
            wire,
        )
        return pack_chunk([], 0, cursor, 0)

    def _fold_mark_rows(self, state, batch: list) -> None:
        """Newest-wins dedup of mark-mode rows, folding accepted
        winners' field payloads."""
        for key, best in iter_winners(batch):
            if len(best) >= 4 and bool(best[3]):
                self.rows_returned += 1
                state.fold_row(bytes(key), best[1])
            elif len(best) < 4 and (
                best[1] is None or len(best[1]) != 0
            ):
                # Drop-shape row (flagless): a match by contract.
                self.rows_returned += 1
                state.fold_row(bytes(key), best[1])

    # -- chunk assembly ------------------------------------------------

    async def _chunk(
        self,
        col,
        collection: str,
        last_key: Optional[bytes],
        prefix: Optional[bytes],
        remaining: int,
        count_mode: bool,
        acc: int,
        max_bytes: int,
        ctx,
    ) -> bytes:
        cfg = self.config
        budget = cfg.scan_bytes_per_slice
        if max_bytes > 0:
            budget = min(budget, max_bytes)
        with_values = not count_mode

        arcs, streams = self._build_streams(col, last_key)
        page_bytes = max(PAGE_MIN_BYTES, budget // max(1, len(arcs)))

        # Emitted entries accumulate directly as splice fragments
        # (fixarray(2) + key + value per entry) — pack_chunk joins
        # them without a second per-entry pass.
        emitted_parts: list = []
        emitted_n = 0
        out_bytes = 0
        count = acc
        done = False
        limit_hit = False

        while not done and not limit_hit and out_bytes < budget:
            t_round = time.monotonic()
            need = [
                s
                for s in streams
                if not s.dead and s.more and not s.buffer
            ]
            if need:
                await self._gather_pages(
                    need, collection, page_bytes, prefix,
                    with_values,
                )
                # Arc liveness: a chunk is only correct when at least
                # one replica of EVERY arc is still streaming.
                self._check_arc_liveness(arcs, streams)
                if ctx is not None:
                    ctx.mark("iterate")
            live = [s for s in streams if not s.dead]
            # Coverage bound: keys <= bound are COMPLETE across every
            # stream (a stream with more entries has produced all of
            # its keys up to its cover).  None = every stream drained.
            bound: Optional[bytes] = None
            for s in live:
                if s.more and (bound is None or s.cover < bound):
                    bound = s.cover
            batch: list = []
            for s in live:
                buf = s.buffer
                if bound is None:
                    if buf:
                        batch.extend(buf)
                        s.buffer = []
                else:
                    i = 0
                    while i < len(buf) and buf[i][0] <= bound:
                        i += 1
                    if i:
                        batch.extend(buf[:i])
                        s.buffer = buf[i:]
            if not batch:
                if all(
                    not s.more and not s.buffer for s in live
                ):
                    done = True
                await self._pay_share(
                    time.monotonic() - t_round, ctx
                )
                continue
            arcs_live: dict = {}
            for s in live:
                arcs_live[s.arc_id] = arcs_live.get(s.arc_id, 0) + 1
            if max(arcs_live.values()) == 1:
                # Fast path — one live stream per arc (the RF=1
                # shape): every key appears in exactly one stream, so
                # no cross-stream dedup — the round reduces to one
                # C-level sort plus sliced tombstone-filter /
                # cumulative-size emits.  The 768-entry slices bound
                # loop occupancy between yields (the isolation gate)
                # while per-entry cost stays at C speed (the
                # throughput gate).
                batch.sort(key=_key0)
                cut = False
                idx = 0
                nb = len(batch)
                while idx < nb and not cut and not limit_hit:
                    sl = batch[idx : idx + 768]
                    idx += len(sl)
                    live_entries = [
                        e
                        for e in sl
                        if e[1] is None or len(e[1]) != 0
                    ]
                    if live_entries:
                        if count_mode:
                            sizes = [
                                len(e[0]) + ENTRY_OVERHEAD
                                for e in live_entries
                            ]
                        else:
                            sizes = [
                                len(e[0])
                                + ENTRY_OVERHEAD
                                + (
                                    len(e[1])
                                    if e[1] is not None
                                    else 0
                                )
                                for e in live_entries
                            ]
                        cum = list(_accumulate(sizes))
                        m = (
                            _bisect_left(
                                cum, budget - out_bytes
                            )
                            + 1
                        )
                        m = min(m, len(live_entries))
                        if remaining != _NO_LIMIT:
                            m = min(m, remaining)
                        take = live_entries[:m]
                        count += m
                        if m:
                            out_bytes += cum[m - 1]
                            if not count_mode:
                                emitted_n += m
                                emitted_parts.extend(
                                    x
                                    for e in take
                                    for x in (
                                        b"\x92", e[0], e[1],
                                    )
                                )
                            last_key = take[-1][0]
                            if remaining != _NO_LIMIT:
                                remaining -= m
                                if remaining <= 0:
                                    limit_hit = True
                        if m < len(live_entries):
                            # Budget cut mid-slice: the cursor must
                            # not skip the unemitted tail (the rest
                            # of the batch re-pulls next chunk).
                            cut = True
                    await asyncio.sleep(0)
                if not cut and not limit_hit and nb:
                    # Whole batch processed: the cursor covers any
                    # trailing tombstones too.
                    last_key = batch[-1][0]
            else:
                # Replicated arcs under divergence: per-key dedup,
                # newest timestamp wins, tombstone winners drop.
                batch.sort(key=lambda e: (e[0], -e[2]))
                i = 0
                n = len(batch)
                while i < n:
                    key = batch[i][0]
                    best = batch[i]
                    i += 1
                    while i < n and batch[i][0] == key:
                        if batch[i][2] > best[2]:
                            best = batch[i]
                        i += 1
                    last_key = key
                    value = best[1]
                    if value is not None and len(value) == 0:
                        continue  # tombstone wins: key is deleted
                    count += 1
                    if count_mode:
                        out_bytes += len(key) + ENTRY_OVERHEAD
                    else:
                        emitted_n += 1
                        emitted_parts.append(b"\x92")
                        emitted_parts.append(key)
                        emitted_parts.append(value)
                        out_bytes += (
                            len(key)
                            + (
                                len(value)
                                if value is not None
                                else 0
                            )
                            + ENTRY_OVERHEAD
                        )
                    if remaining != _NO_LIMIT:
                        remaining -= 1
                        if remaining <= 0:
                            limit_hit = True
                            break
                    if out_bytes >= budget:
                        break
            if ctx is not None:
                ctx.mark("merge")
            # Cooperative slice + share payback: one merge round can
            # touch thousands of entries — yield so queued point ops
            # interleave between rounds, and while point traffic is
            # live pay back the round's share debt before the next.
            await asyncio.sleep(0)
            await self._pay_share(
                time.monotonic() - t_round, ctx
            )

        self.chunks += 1
        self.entries_streamed += emitted_n
        self.bytes_streamed += out_bytes
        cursor = None
        if not done and not limit_hit:
            cursor = encode_cursor(
                collection,
                last_key,
                prefix,
                remaining,
                count_mode,
                count,
                max_bytes,
            )
        if cursor is None and count_mode:
            self.counts_served += 1
        # Splice-encoded: stored key/value encodings go into the
        # payload verbatim, so the client decodes the whole chunk in
        # ONE unpack call.
        return pack_chunk(emitted_parts, emitted_n, cursor, count)
