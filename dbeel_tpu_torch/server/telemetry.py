"""Continuous telemetry plane: per-shard time-series, health watchdog,
Prometheus export, cluster health digests.

Every earlier observability plane answers a *point-in-time* question:
``get_stats`` is a snapshot, ``trace_dump`` a ring of individual ops.
Nothing answered "how is the system TRENDING" — a silent O_DIRECT
fallback, a hint backlog growing one node-outage at a time, or a shed
storm that started two minutes ago are only visible if an operator
happens to diff two snapshots by hand.  RESYSTANCE (PAPERS.md) makes
the same case for LSM stores generally: continuous low-overhead
runtime telemetry is what turns compaction/overload behavior from
anecdotes into tunable signals.

Four pieces, all riding existing counters (no new hot-path work):

* ``TelemetryRing`` — a bounded per-shard ring of flattened
  ``get_stats`` samples taken every ``--telemetry-interval`` ms.  The
  sampler RIDES THE GOVERNOR HEARTBEAT (the 50 ms loop-lag probe the
  overload plane already runs): each beat pays one monotonic compare,
  and every interval one ``get_stats`` walk — the serving path
  executes ZERO telemetry code, and with ``--telemetry-interval 0``
  the hook is never installed at all.  Rates (ops/s, sheds/s, hint
  backlog slope, ...) derive from counter deltas between samples.
* ``HealthWatchdog`` — a rule table evaluated over the ring, turning
  time-series into NAMED findings (shed_storm, sticky_degraded,
  hint_backlog_growing, odirect_fallback, wal_sync_errors,
  dead_completion_climb, trace_ring_churn) surfaced in
  ``get_stats.health``, the per-node gossip digest, ``cluster_stats``
  and the soak report.  Finding log lines are rate-limited to 1/s per
  kind with a suppressed-count rollup (the slow-op log discipline).
* Cluster aggregation — each node folds its shards' digests into one
  compact per-node health digest, piggybacked on every outgoing
  gossip frame and re-announced periodically as a ``health`` gossip
  event, so the always-served ``cluster_stats`` admin verb on ANY
  node answers with the whole cluster's view.
* Prometheus text exposition — a stdlib-only HTTP listener
  (``--metrics-port`` + shard_id, mirroring the db/remote/gossip port
  arithmetic) serving ``/metrics`` flattened from the same schema the
  stats-schema lint walks: path elements join with ``_`` under the
  ``dbeel_`` prefix, so standard scrapers work unmodified.

This module keeps ONLY stdlib imports at module scope: the
stats-schema lint loads it standalone (importlib, no package init) to
verify the Prometheus name-flattening map stays injective over the
exported schema.
"""

from __future__ import annotations

import asyncio
import logging
import re
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

# ---------------------------------------------------------------------
# Stats flattening + Prometheus naming (pure functions — the lint
# imports and executes these).
# ---------------------------------------------------------------------

# Top-level get_stats blocks the RING does not store: `telemetry` and
# `health` describe the ring itself (self-reference adds noise, not
# signal) and `cluster` is other nodes' data.  The PROMETHEUS export
# keeps telemetry/health (operators alert on them) and skips only the
# cluster block (scrape each node for its own series).
RING_SKIP_BLOCKS = frozenset({"telemetry", "health", "cluster"})
PROM_SKIP_BLOCKS = frozenset({"cluster"})

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_PROM_TOKEN = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def flatten_stats(
    stats: dict, skip: frozenset = frozenset()
) -> Dict[str, float]:
    """Flatten a (nested) get_stats tree to {dotted.path: number}.
    Bools export as 0/1; None, strings and lists are dropped (lists
    are shapes like sstable size vectors — per-element metrics would
    churn names).  ``skip`` drops top-level blocks."""
    out: Dict[str, float] = {}
    _flatten_into(stats, (), out, skip)
    return out


def _flatten_into(
    node, prefix: Tuple[str, ...], out: Dict[str, float], skip
) -> None:
    if not isinstance(node, dict):
        return
    for k, v in node.items():
        key = str(k)
        if not prefix and key in skip:
            continue
        path = prefix + (key,)
        if isinstance(v, dict):
            _flatten_into(v, path, out, frozenset())
        elif isinstance(v, bool):
            out[".".join(path)] = int(v)
        elif isinstance(v, (int, float)):
            out[".".join(path)] = v


def prom_name(path: str) -> str:
    """Prometheus metric name for one flattened stats path: the
    ``dbeel_`` prefix + path with every non-token character folded to
    ``_``.  MUST stay injective over the exported schema keys — the
    stats-schema lint walks every schema key through this exact
    function and fails on a collision or an invalid token."""
    return "dbeel_" + _PROM_SANITIZE.sub("_", path)


def prom_ok(name: str) -> bool:
    return _PROM_TOKEN.match(name) is not None


def render_prometheus(stats: dict, shard: str) -> str:
    """Text exposition (version 0.0.4) of one shard's stats tree.
    Everything exports as a gauge: counters ARE monotone gauges to a
    scraper, and rate() in PromQL treats them identically; emitting
    one honest type beats guessing wrong per leaf."""
    lines: List[str] = []
    flat = flatten_stats(stats, skip=PROM_SKIP_BLOCKS)
    for path in sorted(flat):
        name = prom_name(path)
        lines.append(f"# TYPE {name} gauge")
        value = flat[path]
        lines.append(f'{name}{{shard="{shard}"}} {value}')
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------
# Derived-rate paths (flattened get_stats keys the ring understands).
# ---------------------------------------------------------------------

# Counter paths summed into the headline ops/s rate (every served
# client data frame lands in exactly one of these histograms).
_OPS_COUNT_RE = re.compile(r"^metrics\.requests\.[^.]+\.count$")
_ERRORS_RE = re.compile(r"^metrics\.errors\.[^.]+$")

# Gauge paths read directly off the latest sample.
_GAUGES = {
    "loop_lag_ms": "overload.signals.loop_lag_ms",
    "dead_completion_frac": "overload.signals.dead_completion_frac",
    "memtable_fill": "overload.signals.memtable_fill",
    "compaction_debt": "overload.signals.sstable_debt",
    "level": "overload.level",
    "degraded": "durability.degraded_mode",
    "hint_backlog": "convergence.hints_queued",
    # Watch/CDC plane: how far the slowest live
    # subscriber's locally-served position trails this shard's
    # change ring head.
    "watch_lag_events": "watch.lag_events",
}

# Counter paths turned into per-second rates between the last two
# samples.
_RATES = {
    "sheds_per_s": ("overload.shed_ops",),
    "deadline_drops_per_s": ("overload.deadline_drops",),
    "hints_recorded_per_s": ("convergence.hints_recorded",),
    "keys_healed_per_s": ("convergence.keys_healed",),
    "wal_sync_errors_per_s": ("wal_fsync_errors",),
    # Scan plane: chunk/byte throughput and admission
    # refusals of the streaming query lane.
    "scan_chunks_per_s": ("scan.chunks",),
    "scan_bytes_per_s": ("scan.bytes_streamed",),
    "scan_sheds_per_s": ("scan.sheds",),
    # Query compute plane: predicate-pushdown examination
    # rate — rows the vectorized filter evaluated per second
    # (scanned, not returned; the work the governor bills).
    "scan_rows_filtered_per_s": ("scan.filter.rows_scanned",),
    # Watch/CDC plane: delivered change-event throughput
    # of the streaming fan-out.
    "watch_events_per_s": ("watch.events_delivered",),
    # QoS plane: per-class shed rates — under overload
    # batch's rate should lead and interactive's stay ~0 until a
    # strictly higher offered load (the class-priority contract).
    "qos_sheds_interactive_per_s": ("qos.classes.interactive.shed",),
    "qos_sheds_standard_per_s": ("qos.classes.standard.shed",),
    "qos_sheds_batch_per_s": ("qos.classes.batch.shed",),
    "qos_quota_refusals_per_s": ("qos.quota_refusals",),
    # Elastic membership: bulk-handoff throughput — how
    # fast migration streams keys to new owners (paced by bg_slice +
    # --migration-keys-per-sec).
    "keys_migrated_per_s": ("membership.keys_migrated",),
    # Atomic plane: conditional-write losses per second —
    # each one is a client whose expectation lost the race and must
    # re-read.  A sustained rate means hot-key contention (see the
    # cas_conflict_storm watchdog rule).
    "cas_conflicts_per_s": ("atomic.cas_conflicts",),
}

# QoS classes the class_starvation watchdog rule walks (mirrors
# qos.CLASS_NAMES; literal here because this module must stay
# stdlib-only importable for the stats-schema lint).
QOS_CLASS_NAMES = ("interactive", "standard", "batch")


class TelemetryRing:
    """Bounded ring of flattened stats samples + rate derivation.

    Samples are fixed-width in the ring sense: each entry is one flat
    {path: number} map stamped with (seq, ts_ms, uptime_s, monotonic);
    the ring holds at most ``capacity`` of them and evicts oldest
    (counted).  Zero serving-path cost: only ``maybe_sample`` — a
    monotonic compare — runs on the governor heartbeat; the actual
    stats walk runs once per interval."""

    def __init__(self, capacity: int = 360) -> None:
        self.capacity = max(4, int(capacity))
        self._ring: deque = deque(maxlen=self.capacity)
        self.seq = 0
        self.evicted = 0
        self.samples_taken = 0
        # rates() memo: the ring only changes once per interval, but
        # every reader (get_stats, each Prometheus scrape, digest
        # builds, watchdog evaluation) re-derives — cache per seq.
        self._rates_at = -1
        self._rates: Optional[dict] = None

    def __len__(self) -> int:
        return len(self._ring)

    def add_sample(
        self,
        flat: Dict[str, float],
        ts_ms: Optional[int] = None,
        mono: Optional[float] = None,
        uptime_s: float = 0.0,
    ) -> dict:
        """Append one flattened sample (tests feed synthetic counter
        sequences through here directly)."""
        if len(self._ring) >= self.capacity:
            self.evicted += 1
        self.seq += 1
        self.samples_taken += 1
        entry = {
            "seq": self.seq,
            "ts_ms": int(time.time() * 1000) if ts_ms is None else ts_ms,
            "mono": time.monotonic() if mono is None else mono,
            "uptime_s": round(uptime_s, 1),
            "values": flat,
        }
        self._ring.append(entry)
        return entry

    # -- series access -------------------------------------------------

    def last(self) -> Optional[dict]:
        return self._ring[-1] if self._ring else None

    def series(self, path: str, n: int = 0) -> List[float]:
        """Last ``n`` (0 = all ringed) values of one flattened path,
        oldest first; samples missing the path are skipped."""
        entries = list(self._ring)[-n:] if n else list(self._ring)
        return [
            e["values"][path]
            for e in entries
            if path in e["values"]
        ]

    def delta_per_s(self, path: str) -> Optional[float]:
        """Per-second rate of a counter path across the last two
        samples (None until two samples exist).  Negative deltas
        (process restart, counter reset) clamp to 0."""
        if len(self._ring) < 2:
            return None
        a, b = self._ring[-2], self._ring[-1]
        dt = b["mono"] - a["mono"]
        if dt <= 0:
            return None
        va = a["values"].get(path)
        vb = b["values"].get(path)
        if va is None or vb is None:
            return None
        return max(0.0, (vb - va) / dt)

    def _sum_rate(self, pattern: re.Pattern) -> Optional[float]:
        if len(self._ring) < 2:
            return None
        a, b = self._ring[-2], self._ring[-1]
        dt = b["mono"] - a["mono"]
        if dt <= 0:
            return None
        total = 0.0
        for path, vb in b["values"].items():
            if pattern.match(path):
                total += max(0.0, vb - a["values"].get(path, 0))
        return total / dt

    # -- derivation ----------------------------------------------------

    def rates(self) -> dict:
        """Headline derived rates + gauges off the newest window.
        Memoized per ring seq (callers get a shallow copy)."""
        if self._rates_at == self.seq and self._rates is not None:
            return dict(self._rates)
        out: dict = {
            "ops_per_s": _round(self._sum_rate(_OPS_COUNT_RE)),
            "errors_per_s": _round(self._sum_rate(_ERRORS_RE)),
        }
        for name, (path,) in _RATES.items():
            out[name] = _round(self.delta_per_s(path))
        last = self.last()
        values = last["values"] if last else {}
        for name, path in _GAUGES.items():
            out[name] = values.get(path)
        # Hint-backlog slope: queued-hints delta per second over the
        # newest window (the growth signal; the gauge above is the
        # absolute depth).
        slope = None
        if len(self._ring) >= 2:
            a, b = self._ring[-2], self._ring[-1]
            dt = b["mono"] - a["mono"]
            if dt > 0:
                pa = a["values"].get(_GAUGES["hint_backlog"])
                pb = b["values"].get(_GAUGES["hint_backlog"])
                if pa is not None and pb is not None:
                    slope = (pb - pa) / dt
        out["hint_backlog_slope_per_s"] = _round(slope)
        self._rates_at, self._rates = self.seq, out
        return dict(out)

    def stats(self) -> dict:
        return {
            "capacity": self.capacity,
            "len": len(self._ring),
            "seq": self.seq,
            "evicted": self.evicted,
            "samples_taken": self.samples_taken,
        }

    def dump(self) -> dict:
        """The ``telemetry_dump`` payload: full ring (oldest first) +
        derived rates — offline tooling derives anything else from
        the per-sample (seq, ts_ms, mono) stamps."""
        return {
            **self.stats(),
            "rates": self.rates(),
            "entries": [
                {
                    "seq": e["seq"],
                    "ts_ms": e["ts_ms"],
                    "uptime_s": e["uptime_s"],
                    "values": dict(e["values"]),
                }
                for e in self._ring
            ],
        }


def _round(v: Optional[float], digits: int = 2) -> Optional[float]:
    return None if v is None else round(v, digits)


# ---------------------------------------------------------------------
# Health watchdog
# ---------------------------------------------------------------------

# Rule thresholds (module constants so the rule table reads as a
# spec; see ARCHITECTURE "Continuous telemetry" for the prose table).
SHED_STORM_PER_S = 10.0  # sustained sheds/s in the newest window
HINT_GROWTH_WINDOWS = 3  # consecutive strictly-growing samples
# Watch lag: a subscriber's position falling strictly further behind
# the change ring head over N consecutive windows — the watcher is
# too slow (or stopped polling) and is heading for ring eviction +
# a durable-state catch-up replay.
WATCH_LAG_WINDOWS = 3
DEAD_FRAC_WARN = 0.2  # below the governor's soft bar: pre-warning
DEAD_CLIMB_WINDOWS = 3
STICKY_DEGRADED_WINDOWS = 2
# Ring churn: evictions within one window exceeding the trace ring's
# capacity means the flight recorder turned over completely between
# two telemetry samples — dumps no longer cover the window.
TRACE_CHURN_FACTOR = 1.0
# Scan storm: the scan lane refusing chunks at a sustained rate —
# analytics load exceeding --scan-max-concurrent / arriving during
# overload.  The point-op planes are protected by design (that is
# what the sheds mean); the finding tells the operator WHY their
# scans crawl.
SCAN_STORM_SHEDS_PER_S = 5.0
# Class starvation (QoS plane): a traffic class shedding at
# a sustained rate while admitting NOTHING over the same window —
# demand exists (the sheds prove it) but zero of it is served.  For
# batch under overload that is the design working (warn tells the
# operator why their bulk load stalled); for interactive it would be
# a priority inversion — severity escalates to crit.
CLASS_STARVATION_SHEDS_PER_S = 2.0
# Migration stall (elastic membership): migrations active
# but the keys_migrated counter flat for this many consecutive
# windows — a wedged target stream, a starved executor, or a
# mis-sized --migration-keys-per-sec holding the handoff at zero.
MIGRATION_STALL_WINDOWS = 3
# CAS conflict storm (atomic plane): conditional writes
# losing at a sustained rate — many writers fighting over one hot
# key.  Each conflict is a full re-read + retry round trip, so past
# this rate the rmw helpers burn most of their budget spinning; the
# fix is application-side (shard the counter, batch the updates),
# which is why this is a named finding and not a shed.
CAS_CONFLICT_STORM_PER_S = 10.0

_FINDING_LOG_PERIOD_S = 1.0


class HealthWatchdog:
    """Evaluates the rule table over a TelemetryRing into named
    findings.  ``evaluate`` is PURE — any reader (get_stats, every
    Prometheus scrape, digest builds) recomputes the same verdict
    with no side effects; only ``observe`` (called once per telemetry
    sample) advances the finding counters and the rate-limited log,
    so `findings_total` counts sampled occurrences, not how often
    somebody looked."""

    def __init__(self) -> None:
        self._logged_at: Dict[str, float] = {}
        self._suppressed: Dict[str, int] = {}
        self.findings_total = 0
        self.findings_by_kind: Dict[str, int] = {}

    # -- rule table ----------------------------------------------------

    def evaluate(self, ring: TelemetryRing) -> List[dict]:
        """All currently-firing findings, most severe first.  Each is
        {kind, severity, value, detail} — `value` is the measurement
        that fired the rule."""
        findings: List[dict] = []
        last = ring.last()
        if last is None:
            return findings
        values = last["values"]
        rates = ring.rates()

        def add(kind: str, severity: str, value, detail: str) -> None:
            findings.append(
                {
                    "kind": kind,
                    "severity": severity,
                    "value": value,
                    "detail": detail,
                }
            )

        # shed_storm: the governor is actively refusing data ops.
        sheds = rates.get("sheds_per_s")
        if sheds is not None and sheds > SHED_STORM_PER_S:
            add(
                "shed_storm",
                "crit",
                sheds,
                f"shedding {sheds:.0f} ops/s (> {SHED_STORM_PER_S:.0f})",
            )

        # sticky_degraded: read-only degraded mode held across
        # consecutive samples (one blip is the EIO itself; holding is
        # the operator-action signal).
        deg = ring.series(
            "durability.degraded_mode", STICKY_DEGRADED_WINDOWS
        )
        if len(deg) >= STICKY_DEGRADED_WINDOWS and all(
            v >= 1 for v in deg
        ):
            add(
                "sticky_degraded",
                "crit",
                len(deg),
                "shard read-only degraded for "
                f"{len(deg)} consecutive samples — rearm after disk "
                "replacement",
            )

        # hint_backlog_growing: queued hints strictly increased over
        # N consecutive windows — a replica is down (or too slow) and
        # the WAL-backed hint log is absorbing every write.
        hb = ring.series(
            "convergence.hints_queued", HINT_GROWTH_WINDOWS + 1
        )
        if len(hb) >= HINT_GROWTH_WINDOWS + 1 and all(
            b > a for a, b in zip(hb, hb[1:])
        ):
            add(
                "hint_backlog_growing",
                "warn",
                hb[-1],
                f"hint backlog grew {hb[0]:.0f} -> {hb[-1]:.0f} over "
                f"{len(hb) - 1} windows",
            )

        # watch_lag_growing: the slowest live subscriber's position
        # fell strictly further behind the change ring head over N
        # consecutive windows (watch/CDC plane) — it will
        # fall off the ring and pay a flagged catch-up replay unless
        # it speeds up (or its byte budget is raised).
        wl = ring.series("watch.lag_events", WATCH_LAG_WINDOWS + 1)
        if (
            len(wl) >= WATCH_LAG_WINDOWS + 1
            and wl[-1] > 0
            and all(b > a for a, b in zip(wl, wl[1:]))
        ):
            add(
                "watch_lag_growing",
                "warn",
                wl[-1],
                f"watch subscriber lag grew {wl[0]:.0f} -> "
                f"{wl[-1]:.0f} events over "
                f"{len(wl) - 1} windows",
            )

        # odirect_fallback: the C streamers silently degraded to
        # buffered I/O (sticky evidence; previously only visible as a
        # throughput cliff).
        od = values.get("durability.odirect_fallbacks", 0)
        if od and od > 0:
            add(
                "odirect_fallback",
                "warn",
                od,
                f"{od:.0f} O_DIRECT -> buffered fallbacks (see "
                "durability.odirect_fallbacks)",
            )

        # wal_sync_errors: any fdatasync CQE error ever — each one is
        # a durability promise this node could not keep.
        we = values.get("wal_fsync_errors", 0)
        if we and we > 0:
            add(
                "wal_sync_errors",
                "crit",
                we,
                f"{we:.0f} WAL fsync errors",
            )

        # dead_completion_climb: the served-past-deadline fraction is
        # rising toward the governor's soft bar — wall-time overload
        # building before any queue shows it.
        dead = ring.series(
            "overload.signals.dead_completion_frac",
            DEAD_CLIMB_WINDOWS,
        )
        if (
            len(dead) >= DEAD_CLIMB_WINDOWS
            and dead[-1] > DEAD_FRAC_WARN
            and all(b >= a for a, b in zip(dead, dead[1:]))
            and dead[-1] > dead[0]
        ):
            add(
                "dead_completion_climb",
                "warn",
                dead[-1],
                f"dead-completion fraction climbing: {dead[0]:.2f} -> "
                f"{dead[-1]:.2f}",
            )

        # scan_storm: the streaming-scan lane is refusing chunks at a
        # sustained rate — scans beyond the concurrency cap or
        # arriving into an overloaded shard.  Point ops are safe (the
        # shed IS the protection); the finding names the pressure.
        scan_sheds = rates.get("scan_sheds_per_s")
        if (
            scan_sheds is not None
            and scan_sheds > SCAN_STORM_SHEDS_PER_S
        ):
            add(
                "scan_storm",
                "warn",
                scan_sheds,
                f"scan lane shedding {scan_sheds:.0f} chunks/s (> "
                f"{SCAN_STORM_SHEDS_PER_S:.0f}) — analytics load "
                "exceeds the scan lanes",
            )

        # class_starvation (QoS plane): a class sheds at a sustained
        # rate while admitting zero ops over the same window — its
        # lane is fully squeezed out.  Expected for batch under
        # overload (warn: names why the bulk load stalled); a starved
        # INTERACTIVE lane is a priority inversion (crit).
        for cname in QOS_CLASS_NAMES:
            shed_rate = ring.delta_per_s(
                f"qos.classes.{cname}.shed"
            )
            admit_rate = ring.delta_per_s(
                f"qos.classes.{cname}.admitted"
            )
            if (
                shed_rate is not None
                and admit_rate is not None
                and shed_rate > CLASS_STARVATION_SHEDS_PER_S
                and admit_rate == 0.0
            ):
                add(
                    "class_starvation",
                    "crit" if cname == "interactive" else "warn",
                    shed_rate,
                    f"{cname} class starved: shedding "
                    f"{shed_rate:.0f}/s with zero admitted over the "
                    "window",
                )

        # cas_conflict_storm (atomic plane): conditional writes are
        # losing at a sustained rate — hot-key contention.  The
        # plane is healthy (every conflict is a correctly-refused
        # lost update), but clients are spinning on re-read/retry;
        # the finding names the contention so the operator fixes the
        # access pattern instead of suspecting the database.
        cas_conf = rates.get("cas_conflicts_per_s")
        if (
            cas_conf is not None
            and cas_conf > CAS_CONFLICT_STORM_PER_S
        ):
            add(
                "cas_conflict_storm",
                "warn",
                cas_conf,
                f"conditional writes losing {cas_conf:.0f}/s (> "
                f"{CAS_CONFLICT_STORM_PER_S:.0f}) — hot-key CAS "
                "contention; shard the key or batch the updates",
            )

        # migration_stall: a migration claims to be running but moved
        # zero keys across consecutive windows.  DELETE-only plans
        # legitimately move nothing, so the rule also requires that
        # nothing was migrated yet this boot OR something had been
        # moving before — both shapes mean "active and not
        # progressing".
        active = values.get("membership.migrations_active", 0)
        km = ring.series(
            "membership.keys_migrated", MIGRATION_STALL_WINDOWS + 1
        )
        if (
            active
            and active >= 1
            and len(km) >= MIGRATION_STALL_WINDOWS + 1
            and all(b == a for a, b in zip(km, km[1:]))
        ):
            add(
                "migration_stall",
                "warn",
                active,
                f"{active:.0f} migration task(s) active with "
                f"keys_migrated unmoved for {len(km) - 1} windows",
            )

        # trace_ring_churn: the flight recorder turned over completely
        # within one telemetry window — slow-tail evidence is being
        # evicted faster than anyone could dump it.
        churn = ring.delta_per_s("trace.evicted")
        cap = values.get("trace.capacity")
        if churn is not None and cap and len(ring._ring) >= 2:
            a, b = ring._ring[-2], ring._ring[-1]
            window_s = max(0.001, b["mono"] - a["mono"])
            if churn * window_s > cap * TRACE_CHURN_FACTOR:
                add(
                    "trace_ring_churn",
                    "warn",
                    churn,
                    f"flight recorder evicting {churn:.0f}/s — full "
                    "ring turnover within one telemetry window",
                )

        sev = {"crit": 0, "warn": 1}
        findings.sort(key=lambda f: sev.get(f["severity"], 2))
        return findings

    def observe(self, ring: TelemetryRing) -> List[dict]:
        """One telemetry sample's evaluation: the pure verdict plus
        the side effects (counters, rate-limited log)."""
        findings = self.evaluate(ring)
        self._note(findings)
        return findings

    # -- rate-limited finding log (the slow-op log discipline) ---------

    def _note(self, findings: List[dict]) -> None:
        now = time.monotonic()
        for f in findings:
            kind = f["kind"]
            self.findings_total += 1
            self.findings_by_kind[kind] = (
                self.findings_by_kind.get(kind, 0) + 1
            )
            last = self._logged_at.get(kind, 0.0)
            if now - last >= _FINDING_LOG_PERIOD_S:
                self._logged_at[kind] = now
                muted = self._suppressed.pop(kind, 0)
                if muted:
                    log.warning(
                        "health %s: %s (+%d %s findings in the last "
                        "%.0fs not logged)",
                        kind, f["detail"], muted, kind, now - last,
                    )
                else:
                    log.warning("health %s: %s", kind, f["detail"])
            else:
                # lint: allow(stats-schema) — log suppression state,
                # not an operator counter.
                self._suppressed[kind] = (
                    self._suppressed.get(kind, 0) + 1
                )

    def stats(self) -> dict:
        return {
            "findings_total": self.findings_total,
            "findings_by_kind": dict(self.findings_by_kind),
        }


# ---------------------------------------------------------------------
# Per-shard telemetry plane (ring + watchdog + digest + announce)
# ---------------------------------------------------------------------


class ShardTelemetry:
    """One shard's telemetry plane.  Constructed unconditionally (the
    get_stats schema must not depend on the knob); ``start`` installs
    the heartbeat hook only when --telemetry-interval > 0, so a
    disabled plane costs literally nothing anywhere."""

    def __init__(self, config) -> None:
        self.interval_s = (
            max(0, int(getattr(config, "telemetry_interval_ms", 0)))
            / 1000.0
        )
        self.ring = TelemetryRing(
            getattr(config, "telemetry_ring", 360)
        )
        self.watchdog = HealthWatchdog()
        self.enabled = self.interval_s > 0
        self._last_sample = 0.0
        self._shard = None
        self._announcing = False

    # -- startup -------------------------------------------------------

    def start(self, my_shard) -> None:
        """Arm sampling: the governor heartbeat (which start ensures
        is running) calls ``maybe_sample`` every beat — one float
        compare — and the due samples happen there, off the serving
        path.  No-op when the interval knob is 0."""
        if not self.enabled:
            return
        self._shard = my_shard
        gov = my_shard.governor
        gov.telemetry_hook = self.maybe_sample
        gov._ensure_heartbeat()

    # -- sampling ------------------------------------------------------

    def maybe_sample(self) -> bool:
        """Heartbeat hook: sample when an interval has elapsed."""
        now = time.monotonic()
        if now - self._last_sample < self.interval_s:
            return False
        self._last_sample = now
        try:
            self.sample()
        except Exception as e:  # sampling must never kill the beat
            log.warning("telemetry sample failed: %s", e)
        return True

    def sample(self) -> dict:
        """One full stats walk into the ring; the node-managing shard
        then kicks the async digest announce."""
        shard = self._shard
        stats = shard.get_stats()
        entry = self.ring.add_sample(
            flatten_stats(stats, skip=RING_SKIP_BLOCKS),
            ts_ms=stats.get("ts_ms"),
            uptime_s=stats.get("uptime_s") or 0.0,
        )
        # The ONE side-effecting evaluation per interval: counters +
        # the rate-limited finding log (readers re-evaluate purely).
        self.watchdog.observe(self.ring)
        if shard.id == 0 and not self._announcing:
            self._announcing = True
            shard.spawn(self._announce(shard))
        return entry

    # -- digests + cluster view ----------------------------------------

    def shard_digest(self, shard=None) -> dict:
        """This shard's compact health summary (intra-node
        aggregation unit).  level/degraded/hint_backlog read LIVE
        shard state when a shard reference is available — with
        telemetry disabled the ring is empty, and an on-demand digest
        claiming "healthy" for a degraded shard would be worse than
        no digest at all; rates and findings stay ring-derived
        (trends need samples)."""
        shard = shard if shard is not None else self._shard
        rates = self.ring.rates()
        findings = self.watchdog.evaluate(self.ring)
        last = self.ring.last()
        values = last["values"] if last else {}
        level = values.get("overload.level", 0)
        degraded = bool(values.get("durability.degraded_mode"))
        backlog = values.get("convergence.hints_queued", 0)
        if shard is not None:
            level = max(int(level), shard.governor.level())
            degraded = degraded or bool(shard.degraded)
            backlog = shard.hint_log.queued_total()
        return {
            "seq": self.ring.seq,
            "level": level,
            "ops_per_s": rates.get("ops_per_s"),
            "errors_per_s": rates.get("errors_per_s"),
            "sheds_per_s": rates.get("sheds_per_s"),
            "degraded": degraded,
            "hint_backlog": backlog,
            "findings": sorted({f["kind"] for f in findings}),
        }

    @staticmethod
    def merge_digests(
        node_name: str, digests: List[dict], boot: str = ""
    ) -> dict:
        """Fold per-shard digests into ONE per-node digest (the
        gossip payload): rates sum, level/degraded take the worst,
        finding kinds union.  ``boot`` (the gossip boot nonce) scopes
        the freshness compare on receivers: same-boot digests order
        by seq — immune to the sender's wall clock stepping."""
        out = {
            "node": node_name,
            "boot": boot,
            "ts_ms": int(time.time() * 1000),
            "seq": 0,
            "level": 0,
            "ops_per_s": 0.0,
            "errors_per_s": 0.0,
            "sheds_per_s": 0.0,
            "degraded": False,
            "hint_backlog": 0,
            "findings": [],
            "shards": len(digests),
        }
        kinds: set = set()
        for d in digests:
            if not isinstance(d, dict):
                continue
            out["seq"] = max(out["seq"], int(d.get("seq") or 0))
            out["level"] = max(out["level"], int(d.get("level") or 0))
            for k in ("ops_per_s", "errors_per_s", "sheds_per_s"):
                v = d.get(k)
                if v is not None:
                    out[k] = round(out[k] + v, 2)
            out["degraded"] = out["degraded"] or bool(
                d.get("degraded")
            )
            out["hint_backlog"] += int(d.get("hint_backlog") or 0)
            kinds.update(d.get("findings") or ())
        out["findings"] = sorted(kinds)
        return out

    async def _announce(self, shard) -> None:
        """Node-managing shard only: gather sibling shard digests,
        fold them into the node digest, absorb it locally and gossip
        it (the ``health`` event) so every node's cluster_stats view
        refreshes each interval."""
        try:
            from ..cluster import messages as msgs
            from ..cluster.messages import GossipEvent, ShardRequest
            from ..cluster.messages import ShardResponse

            digests = [self.shard_digest(shard)]
            # Per-SIBLING fault tolerance: one shard mid-boot or
            # answering an error must not drop every other sibling's
            # digest from the node rollup (the degraded shard being
            # reported might be exactly the one that answered).
            request = ShardRequest.telemetry_digest()
            results = await asyncio.gather(
                *[
                    shard._send_sibling_request(c, request)
                    for c in shard.sibling_connections()
                ],
                return_exceptions=True,
            )
            for r in results:
                if isinstance(r, BaseException):
                    log.debug("sibling telemetry digest failed: %s", r)
                    continue
                try:
                    d = msgs.response_to_result(
                        r, ShardResponse.TELEMETRY_DIGEST
                    )
                except Exception as e:
                    log.debug("sibling telemetry digest failed: %s", e)
                    continue
                if isinstance(d, dict):
                    digests.append(d)
            node_digest = self.merge_digests(
                shard.config.name, digests, boot=shard.boot_id
            )
            shard.last_node_digest = node_digest
            shard.absorb_health_digest(node_digest)
            await shard.gossip(
                GossipEvent.health(
                    shard.config.name,
                    node_digest["seq"],
                    node_digest,
                )
            )
        except Exception as e:
            log.warning("telemetry announce failed: %s", e)
        finally:
            self._announcing = False

    # -- exports -------------------------------------------------------

    def stats_block(self) -> dict:
        """The ``get_stats.telemetry`` block."""
        return {
            "enabled": self.enabled,
            "interval_ms": int(self.interval_s * 1000),
            "ring": self.ring.stats(),
            "rates": self.ring.rates(),
        }

    def health_block(self) -> dict:
        """The ``get_stats.health`` block: the watchdog's verdict
        over the ring — machine-readable, alertable."""
        findings = (
            self.watchdog.evaluate(self.ring) if self.enabled else []
        )
        return {
            "enabled": self.enabled,
            "ok": not any(
                f["severity"] == "crit" for f in findings
            ),
            "findings": findings,
            **self.watchdog.stats(),
        }

    def dump(self) -> dict:
        """The ``telemetry_dump`` admin-verb payload."""
        return {
            "enabled": self.enabled,
            "interval_ms": int(self.interval_s * 1000),
            **self.ring.dump(),
            "health": self.health_block(),
        }


# ---------------------------------------------------------------------
# Prometheus endpoint (stdlib-only HTTP/1.0)
# ---------------------------------------------------------------------

_HTTP_LIMIT = 8192


async def _serve_metrics_conn(my_shard, reader, writer) -> None:
    try:
        try:
            request = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), 10.0
            )
        except (
            asyncio.IncompleteReadError,
            asyncio.LimitOverrunError,
            asyncio.TimeoutError,
        ):
            return
        line = request.split(b"\r\n", 1)[0].decode(
            "latin-1", "replace"
        )
        parts = line.split(" ")
        path = parts[1] if len(parts) >= 2 else ""
        if parts and parts[0] == "GET" and (
            path == "/metrics" or path.startswith("/metrics?")
        ):
            body = render_prometheus(
                my_shard.get_stats(), my_shard.shard_name
            ).encode()
            head = (
                b"HTTP/1.0 200 OK\r\n"
                b"Content-Type: text/plain; version=0.0.4; "
                b"charset=utf-8\r\n"
                b"Content-Length: " + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n"
            )
        else:
            body = b"see /metrics\n"
            head = (
                b"HTTP/1.0 404 Not Found\r\n"
                b"Content-Type: text/plain\r\n"
                b"Content-Length: " + str(len(body)).encode()
                + b"\r\nConnection: close\r\n\r\n"
            )
        writer.write(head + body)
        await writer.drain()
    except (ConnectionError, OSError):
        pass
    finally:
        try:
            writer.close()
        except Exception:
            pass


async def run_metrics_server(my_shard) -> None:
    """Per-shard Prometheus listener at metrics_port + shard_id (the
    db/remote/gossip port arithmetic).  Admin plane: always serves,
    never touched by the governor — an overloaded shard must stay
    scrapeable."""
    port = my_shard.config.metrics_port + my_shard.id
    server = await asyncio.start_server(
        lambda r, w: _serve_metrics_conn(my_shard, r, w),
        my_shard.config.ip,
        port,
        limit=_HTTP_LIMIT,
    )
    log.info(
        "serving /metrics on %s:%d", my_shard.config.ip, port
    )
    async with server:
        await server.serve_forever()
