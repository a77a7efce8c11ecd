"""Per-request tracing plane: span contexts + the flight recorder.

Every plane so far was tuned against *aggregate* evidence — the
``get_stats`` histograms say a p99 spike exists, but not whether the
time went to queue wait, WAL fsync, the table probe, peer RTT, or the
quorum settle.  This module adds Dapper-style per-request attribution
(PAPERS.md related work on production LSM serving):

* ``TraceCtx`` — one sampled request's span: strictly sequential
  stage marks (they partition [t0, end], so the stage sum equals the
  total by construction), a ``detail`` side-channel for overlapping
  measurements (the local write that runs concurrently with the
  quorum fan-out), and per-replica entries carrying each peer's RTT
  plus the stage summary the replica piggybacked on its response
  frame.
* ``FlightRecorder`` — a bounded per-shard ring holding full spans
  for sampled ops (server-side 1-in-N via ``--trace-sample``, or any
  op whose client stamped a ``trace`` id on the request frame) plus a
  minimal record for EVERY op that finishes slow (>``--slow-op-us``)
  or with a taxonomy error — the always-sample-the-slow-tail rule, so
  the interesting ops are in the ring even at sample=0.  Queried over
  the wire via the admin ``trace_dump`` verb (always served, like
  ``get_stats``).

Sampling is deliberately routed through the interpreted path: a
sampled (or client-stamped) frame bypasses the native fast paths so
the span gets real stage marks, and the peer frames it fans out carry
the trace id so replicas punt their native plane and piggyback their
own stage summary.  Unsampled traffic pays nothing — the native plane
keeps serving it, and its latency shows up in the coarse per-verb
stage counters the C side stamps (``get_stats.trace.native``).
"""

from __future__ import annotations

import contextvars
import itertools
import time
from collections import deque
from typing import List, Optional

# The active span for the current task tree (the fan-out helpers in
# shard.py read it to time replicas without threading a parameter
# through every call site).
CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "dbeel_trace", default=None
)

_ids = itertools.count(1)


def current() -> "Optional[TraceCtx]":
    return CURRENT.get()


def new_trace_id() -> int:
    """Server-assigned trace ids: wall-ms prefix + counter, unique
    enough per process and sortable in a dump."""
    return (int(time.time() * 1000) << 20) | (next(_ids) & 0xFFFFF)


# Response base arities for piggyback stripping: a replica's stage
# summary rides as ONE extra trailing element on its response frame,
# so anything beyond the base arity that looks like a span is one.
# (Kept here, next to the absorb logic; the encoders in
# cluster/messages.py are the source of truth for the base shapes.)
_RESP_BASE = {
    "set": 2,
    "delete": 2,
    "multi_set": 2,
    "range_push": 2,
    "rearm": 2,
    "get": 3,
    "get_digest": 3,
    "multi_get": 3,
    "range_pull": 3,
}


def split_peer_span(resp):
    """(response, replica_span|None): pop a piggybacked stage summary
    off a peer response list.  A span is a list of non-negative ints
    sitting exactly one element beyond the verb's base arity; old-
    dialect responses simply lack it."""
    if not isinstance(resp, list) or len(resp) < 2:
        return resp, None
    base = _RESP_BASE.get(resp[1])
    if base is None or len(resp) != base + 1:
        return resp, None
    tail = resp[-1]
    if isinstance(tail, (list, tuple)) and all(
        isinstance(x, int) and x >= 0 for x in tail
    ):
        return resp[:base], list(tail)
    return resp, None


class TraceCtx:
    """One sampled request's span under construction."""

    __slots__ = (
        "trace_id",
        "op",
        "collection",
        "client_stamped",
        "t0",
        "_last",
        "stages",
        "detail",
        "replicas",
    )

    def __init__(
        self,
        trace_id: int,
        op: str = "?",
        collection: Optional[str] = None,
        t0: Optional[float] = None,
        client_stamped: bool = False,
    ) -> None:
        self.trace_id = trace_id
        self.op = op
        self.collection = collection
        self.client_stamped = client_stamped
        self.t0 = time.monotonic() if t0 is None else t0
        self._last = self.t0
        self.stages: List[list] = []  # [name, us] in wall order
        self.detail: dict = {}  # overlapping sub-measurements (us)
        self.replicas: List[dict] = []

    def mark(self, stage: str) -> None:
        """Close the wall segment since the previous mark under
        ``stage``.  Marks are strictly sequential, so
        sum(stage us) == total us by construction."""
        now = time.monotonic()
        us = int((now - self._last) * 1e6)
        self._last = now
        if self.stages and self.stages[-1][0] == stage:
            self.stages[-1][1] += us
        else:
            self.stages.append([stage, us])

    def note(self, key: str, us: int) -> None:
        """Overlapping measurement (e.g. the local write inside the
        quorum gather): attributed but NOT part of the stage sum."""
        self.detail[key] = self.detail.get(key, 0) + int(us)

    def replica(
        self, node: str, rtt_us: int, span: "Optional[list]"
    ) -> None:
        self.replicas.append(
            {
                "node": node,
                "rtt_us": int(rtt_us),
                # Replica stage summary (u32 micros piggybacked on
                # the peer response frame): [queue_us, serve_us].
                "stages": span,
            }
        )

    def absorb_peer(self, node: str, rtt_us: int, resp):
        """Record one replica's RTT (+ piggybacked span when present)
        and return the response with the piggyback stripped, so the
        quorum interpret path sees the base-arity frame.  Accepts the
        raw payload bytes of the packed fan-out path too (unpacked
        here; the interpreter tolerates pre-unpacked lists)."""
        if isinstance(resp, (bytes, bytearray)):
            from ..cluster import messages as msgs

            try:
                resp = msgs.unpack_message(bytes(resp))
            except Exception:
                self.replica(node, rtt_us, None)
                return resp
        resp, span = split_peer_span(resp)
        self.replica(node, rtt_us, span)
        return resp

    def finish(self, error_kind: Optional[str] = None) -> dict:
        total_us = int((time.monotonic() - self.t0) * 1e6)
        return {
            "trace_id": self.trace_id,
            "op": self.op,
            "collection": self.collection,
            "client_stamped": self.client_stamped,
            "sampled": True,
            "ts_ms": int(time.time() * 1000),
            "total_us": total_us,
            "stages": [list(s) for s in self.stages],
            "detail": dict(self.detail),
            "replicas": list(self.replicas),
            "error": error_kind,
        }


class FlightRecorder:
    """Bounded per-shard ring of trace records.

    ``sample_every`` = N means every Nth client frame dispatched by
    this shard gets a full span (0 disables server-side sampling;
    client-stamped traces always record).  Slow (> ``slow_op_us``)
    and taxonomy-error ops ALWAYS land in the ring — as their full
    span when they happened to be sampled, else as a minimal record —
    so the tail is diagnosable post-hoc at any sampling rate."""

    # Minimal (slow/error) records admitted per second: under a hard
    # overload EVERY op is slow or shed, and an unbounded capture
    # rate would churn the whole ring with homogeneous drop records
    # within milliseconds — evicting the sampled spans and
    # pre-overload evidence the dump exists to serve.  Full spans
    # (record_span) are never limited: sampling already bounds them.
    MINIMAL_PER_S = 200

    def __init__(
        self,
        sample_every: int = 0,
        slow_op_us: int = 100_000,
        capacity: int = 512,
    ) -> None:
        self.sample_every = max(0, int(sample_every))
        self.slow_op_us = max(1, int(slow_op_us))
        self.capacity = max(8, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self._tick = 0
        self._min_tokens = float(self.MINIMAL_PER_S)
        self._min_refill_at: "float | None" = None
        # Counters (exported via get_stats.trace).
        self.recorded = 0
        self.evicted = 0
        self.sampled = 0
        self.client_traced = 0
        self.slow_captured = 0
        self.error_captured = 0
        self.capture_suppressed = 0

    # -- sampling decisions -------------------------------------------

    @property
    def sampling(self) -> bool:
        return self.sample_every > 0

    def tick(self) -> bool:
        """One client frame considered: True when this one is the
        1-in-N sample.  A cheap counter compare on the serving path;
        never True while sampling is disabled."""
        if self.sample_every <= 0:
            return False
        self._tick += 1
        if self._tick >= self.sample_every:
            self._tick = 0
            return True
        return False

    # -- recording -----------------------------------------------------

    def _push(self, entry: dict) -> None:
        if len(self._ring) >= self.capacity:
            self.evicted += 1
        self._ring.append(entry)
        self.recorded += 1

    def record_span(
        self, ctx: TraceCtx, error_kind: Optional[str] = None
    ) -> dict:
        """Finalize and ring a full sampled span."""
        entry = ctx.finish(error_kind)
        self.sampled += 1
        if ctx.client_stamped:
            self.client_traced += 1
        if entry["total_us"] >= self.slow_op_us:
            entry["slow"] = True
            self.slow_captured += 1
        if error_kind is not None:
            self.error_captured += 1
        self._push(entry)
        return entry

    def _admit_minimal(self) -> bool:
        """Token bucket over minimal records; suppressed captures are
        counted (they remain visible in the error/shed counters of
        get_stats — the ring just stops churning on them)."""
        now = time.monotonic()
        if self._min_refill_at is None:
            self._min_refill_at = now
        self._min_tokens = min(
            float(self.MINIMAL_PER_S),
            self._min_tokens
            + (now - self._min_refill_at) * self.MINIMAL_PER_S,
        )
        self._min_refill_at = now
        if self._min_tokens >= 1.0:
            self._min_tokens -= 1.0
            return True
        self.capture_suppressed += 1
        return False

    def note_op(
        self, op: str, us: int, error_kind: Optional[str] = None
    ) -> None:
        """Unsampled completion: capture ONLY when slow or errored
        (minimal record — op, latency, error; no stages)."""
        slow = us >= self.slow_op_us
        if not slow and error_kind is None:
            return
        if not self._admit_minimal():
            return
        if slow:
            self.slow_captured += 1
        if error_kind is not None:
            self.error_captured += 1
        self._push(
            {
                "op": op,
                "sampled": False,
                "slow": slow,
                "ts_ms": int(time.time() * 1000),
                "total_us": int(us),
                "error": error_kind,
            }
        )

    # -- querying ------------------------------------------------------

    def dump(self) -> dict:
        """The ``trace_dump`` payload: ring contents (oldest first) +
        recorder counters.  Always served, like get_stats — an
        operator must be able to read the tail OF an overload DURING
        the overload."""
        return {
            "capacity": self.capacity,
            "sample_every": self.sample_every,
            "slow_op_us": self.slow_op_us,
            "entries": list(self._ring),
            **self.stats(),
        }

    def stats(self) -> dict:
        return {
            "recorded": self.recorded,
            "evicted": self.evicted,
            "sampled": self.sampled,
            "client_traced": self.client_traced,
            "slow_captured": self.slow_captured,
            "error_captured": self.error_captured,
            "capture_suppressed": self.capture_suppressed,
        }
