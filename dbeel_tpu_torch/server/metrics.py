"""Structured per-shard metrics: latency histograms + slow-op log.

Observability is an axis to improve on over the reference (it
has logs only; its latency visibility lives entirely in
blackbox_bench's client-side percentile report).  Here every served
request is recorded into a log-bucketed latency histogram per op type,
queryable over the wire via ``get_stats`` — so an operator reads
p50/p99/p999 per shard from the live system, no external bench needed.

Design: power-of-two microsecond buckets (1µs … ~67s, 27 buckets).
Recording is two integer ops (bit_length + increment) — nanoseconds of
overhead on the serving path.  Percentiles are reconstructed
server-side at query time from bucket counts (upper-bound estimate,
within 2× worst case, far tighter in the populated range).
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional

log = logging.getLogger(__name__)

_BUCKETS = 27  # 2^0 .. 2^26 µs (~67 s)


class LatencyHistogram:
    __slots__ = ("counts", "count", "total_us", "max_us")

    def __init__(self) -> None:
        self.counts = [0] * _BUCKETS
        self.count = 0
        self.total_us = 0
        self.max_us = 0

    def record_us(self, us: int) -> None:
        b = min(_BUCKETS - 1, max(0, int(us).bit_length() - 1))
        # raw buckets are internal; snapshot() exports them as
        # percentiles/mean/max.  lint: allow(stats-schema)
        self.counts[b] += 1
        self.count += 1
        self.total_us += us
        if us > self.max_us:
            self.max_us = us

    def percentile_us(self, q: float) -> Optional[int]:
        """Upper-bound estimate of the q-quantile in µs."""
        if self.count == 0:
            return None
        import math

        # Nearest-rank (ceil) convention; epsilon guards float fuzz
        # like 8 * 0.999 = 7.992000000000001.
        target = max(1, math.ceil(self.count * q - 1e-9))
        seen = 0
        for b, c in enumerate(self.counts):
            seen += c
            if seen >= target:
                return 1 << (b + 1)  # bucket upper bound
        return self.max_us

    def snapshot(self) -> dict:
        return {
            "count": self.count,
            "mean_us": (
                round(self.total_us / self.count, 1) if self.count else None
            ),
            "p50_us": self.percentile_us(0.50),
            "p90_us": self.percentile_us(0.90),
            "p99_us": self.percentile_us(0.99),
            "p999_us": self.percentile_us(0.999),
            "max_us": self.max_us,
        }


# Point data ops whose completions count as foreground activity for
# the scan plane's chunk pacing (scan/scan_next deliberately absent).
_POINT_DATA_OPS = frozenset(
    {"set", "get", "delete", "multi_set", "multi_get"}
)


class ShardMetrics:
    """Per-shard metrics hub: request histograms by op type, a slow-op
    threshold log, and background-stage counters."""

    SLOW_OP_US = 100_000  # default slow threshold (--slow-op-us)
    # Slow-op WARNING lines are rate-limited per op type: under
    # overload every op can cross the threshold and one line per op
    # floods (and further slows) the serving loop.  The structured
    # record still lands in the flight recorder for every slow op —
    # the log line is a human tap, not the evidence.
    SLOW_LOG_PERIOD_S = 1.0
    # Histograms are keyed by the CLIENT-supplied request type: cap the
    # key set so garbage types can't grow shard memory / stats output.
    # (Module-level twin lives below the class: _POINT_DATA_OPS.)
    KNOWN_OPS = frozenset(
        {
            "set",
            "get",
            "delete",
            "multi_set",
            "multi_get",
            "scan",
            "scan_next",
            "create_collection",
            "drop_collection",
            "get_collection",
            "get_cluster_metadata",
            "get_stats",
            "cluster_stats",
            "telemetry_dump",
            "trace_dump",
            "invalid",
        }
    )

    def __init__(self) -> None:
        self.requests: Dict[str, LatencyHistogram] = {}
        self.slow_ops = 0
        self.slow_op_us = self.SLOW_OP_US
        # Flight recorder (tracing plane): every slow/error op
        # is captured there; sampled ops record full spans at the
        # serving layer and pass traced=True so they are not
        # double-recorded here.  None until MyShard wires it.
        self.recorder = None
        self._slow_logged_at: Dict[str, float] = {}
        self._slow_suppressed: Dict[str, int] = {}
        # Pipelined-plane shape counters.  The two histograms reuse
        # the log-bucketed LatencyHistogram with a COUNT (not µs) as
        # the recorded value — bucket b covers [2^b, 2^{b+1}) items:
        #  * pipeline_depth: concurrent in-flight requests on a
        #    connection at each pipelined dispatch;
        #  * batch_sizes: sub-ops per multi_set/multi_get frame.
        self.pipeline_depth = LatencyHistogram()
        self.batch_sizes = LatencyHistogram()
        # Responses that were ready but had to wait for an earlier
        # (slower) response on the same connection before leaving —
        # the head-of-line pressure the in-order release rule costs.
        self.hol_waits = 0
        # Failure-taxonomy counters (errors.ERROR_CLASSES): every
        # client-visible failure this shard answered with an error
        # frame, by class — the server-side half of the soak report's
        # per-class breakdown.
        from ..errors import ERROR_CLASSES

        self.errors: Dict[str, int] = {c: 0 for c in ERROR_CLASSES}
        # Scan plane: when this shard last completed a POINT
        # data op — the foreground-activity signal the scan plane's
        # chunk pacing keys off (the scan's own frames must NOT count
        # as foreground, or scans would throttle themselves on an
        # otherwise idle shard).
        self.last_point_op_mono = 0.0

    def record_error(self, error_class: Optional[str]) -> None:
        """Count one client-visible failure by taxonomy class (None =
        benign application outcome, not counted)."""
        if error_class is None:
            return
        if error_class not in self.errors:
            error_class = "other"
        self.errors[error_class] += 1

    def record_pipeline_depth(self, depth: int) -> None:
        self.pipeline_depth.record_us(max(1, depth))

    def record_batch_size(self, n: int) -> None:
        self.batch_sizes.record_us(max(1, n))

    def record_hol_wait(self) -> None:
        self.hol_waits += 1

    def record_request(
        self,
        op: str,
        started: float,
        error_kind: "Optional[str]" = None,
        traced: bool = False,
    ) -> None:
        """``started`` from time.monotonic() at frame receipt.
        ``error_kind`` (taxonomy class, when the caller knows it) and
        ``traced`` (a full span was already recorded) feed the flight
        recorder's slow/error capture."""
        us = int((time.monotonic() - started) * 1e6)
        if op not in self.KNOWN_OPS:
            op = "other"
        if op in _POINT_DATA_OPS:
            self.last_point_op_mono = time.monotonic()
        hist = self.requests.get(op)
        if hist is None:
            hist = self.requests[op] = LatencyHistogram()
        hist.record_us(us)
        if self.recorder is not None and not traced:
            self.recorder.note_op(op, us, error_kind)
        if us >= self.slow_op_us:
            self.slow_ops += 1
            now = time.monotonic()
            last = self._slow_logged_at.get(op, 0.0)
            if now - last >= self.SLOW_LOG_PERIOD_S:
                self._slow_logged_at[op] = now
                muted = self._slow_suppressed.pop(op, 0)
                if muted:
                    log.warning(
                        "slow %s: %.1f ms (+%d slow %s in the last "
                        "%.0fs not logged; see trace_dump)",
                        op, us / 1e3, muted, op, now - last,
                    )
                else:
                    log.warning("slow %s: %.1f ms", op, us / 1e3)
            else:
                # lint: allow(stats-schema) — log suppression state,
                # not an operator counter.
                self._slow_suppressed[op] = (
                    self._slow_suppressed.get(op, 0) + 1
                )

    def snapshot(self) -> dict:
        return {
            "requests": {
                op: hist.snapshot()
                for op, hist in self.requests.items()
            },
            "slow_ops": self.slow_ops,
            "pipeline_depth": self.pipeline_depth.snapshot(),
            "batch_sizes": self.batch_sizes.snapshot(),
            "hol_waits": self.hol_waits,
            "errors": dict(self.errors),
        }
