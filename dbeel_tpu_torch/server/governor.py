"""Per-shard load governor — the overload-control brain.

The serving plane survives dead peers, corrupt disks and partitions,
but nothing protected it from *too much traffic*: past the fixed
per-connection window, queues grew without bound, a flush/compaction
backlog silently inflated tail latency until the WAL or memtable path
fell over, and a slow replica could absorb a coordinator's memory.
The compaction design-space literature (PAPERS.md: "Constructing and
Analyzing the LSM Compaction Design Space"; RESYSTANCE) is blunt about
the fix: backlog-aware admission and write throttling are what keep an
LSM store stable under sustained load.

This governor samples the shard's backlog signals and folds them into
one of three levels:

  * ``LEVEL_OK`` (0)   — nothing to do.
  * ``LEVEL_SOFT`` (1) — backlog building: LOW-PRIORITY work yields
    first.  Background units (anti-entropy, scrub, hint drain,
    migration — everything already under ``scheduler.bg_slice``) are
    delayed before they start, and every connection's AIMD window
    shrinks multiplicatively, pushing queueing back into the clients.
  * ``LEVEL_HARD`` (2) — backlog past the point where admitting more
    work only converts latency into collapse: NEW data ops are shed
    with the retryable ``Overloaded`` error (cheap to produce, honest
    to the client, and the client's backoff walk spreads the retry),
    while admin/observability ops (``get_stats``, metadata, rearm)
    keep serving so an operator can always see in.

Signals (sampled at most once per SAMPLE_S — the serving path pays a
cached integer compare):

  * admitted work: queued + in-flight + sync-parked ops across every
    client connection (the parked count IS the WAL-sync backlog at
    the serving layer: acks waiting on fdatasync);
  * memtable fill: entries and appends-since-swap against capacity on
    the busiest collection (appends >> capacity means flushes cannot
    keep up — the WAL grows without bound);
  * flush/compaction debt: sstable count beyond
    ``overload_compaction_debt`` on any collection.  An unfinished
    flush swap is reported (``flush_backlog``) for observability but
    is not itself a level trigger: a wedged flush blocks the next
    swap, so the memtable fill/appends signals above cross their own
    thresholds within one memtable's worth of traffic — and with no
    traffic there is nothing to govern;
  * event-loop lag: EWMA overshoot of a 50ms heartbeat sleep.  The
    native data plane answers RF=1 ops synchronously inside
    data_received — overload there never shows up in any tracked
    queue; it shows up as the loop's callback queue stretching, which
    is exactly what the heartbeat measures.  (Found by the
    --overload-knee bench: without this signal, 3x offered load
    collapsed goodput 5x through pure queueing with every queue
    signal reading zero.)

Shedding never applies to the PEER plane (replica work keeps quorums
alive; its protection is deadline drops + the per-peer outbound caps
in remote_comm), and never to reads of the governor's own state.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

from .qos import (
    CLASS_HARD_FACTOR,
    CLASS_SOFT_FACTOR,
    NCLASSES,
    QOS_INTERACTIVE,
    QOS_STANDARD,
)

LEVEL_OK = 0
LEVEL_SOFT = 1
LEVEL_HARD = 2

# Memtable-fill thresholds (fractions of tree capacity).  Soft at 85%
# of either signal; hard only when appends since the last swap exceed
# TWICE capacity — the flush trigger fires at 1x, so 2x means the
# flush path is genuinely behind, not merely scheduled.
MEMTABLE_SOFT_FILL = 0.85
MEMTABLE_HARD_APPENDS = 2.0

# Background work delayed at soft overload waits in these slices, up
# to the cap — maintenance yields to serving but is never starved
# outright (anti-entropy owns correctness tails).
BG_DELAY_SLICE_S = 0.05
BG_DELAY_MAX_S = 5.0

# Event-loop lag heartbeat: sleep HB_S, measure the overshoot, EWMA
# it.  Lag thresholds are intentionally far above a healthy loop's
# jitter (this class of host shows tens of ms under legitimate full
# load) — soft/hard fire only when the callback queue is genuinely
# stretching into client-visible latency.
HB_S = 0.05
LAG_EWMA_ALPHA = 0.3
LAG_SOFT_S = 0.10
LAG_HARD_S = 0.40

# Dead-completion fraction: the EWMA share of served data ops that
# finished AFTER the budget their client gave them (the propagated
# deadline_ms, or the op's own timeout field) — i.e. responses nobody
# was still waiting for.  This is the signal that fires when overload
# lives in WALL TIME rather than any queue: a saturated quorum path
# (CPU contention, fdatasync storms, slow replicas) stretches every
# op past its deadline while pending/inflight counts stay small
# because clients give up and retry.  Sustained dead work means new
# admissions are hopeless too — shed them instead.  The EWMA needs
# ~log(0.5)/log(1-alpha) ≈ 7 consecutive dead completions to cross
# the hard bar, so one pathological op (a 15s blackhole timeout)
# cannot flip the shard.
DEAD_EWMA_ALPHA = 0.1
DEAD_FRAC_SOFT = 0.25
DEAD_FRAC_HARD = 0.5


class LoadGovernor:
    SAMPLE_S = 0.02  # signal cache lifetime

    __slots__ = (
        "shard",
        "config",
        "_level",
        "_sampled_at",
        "_signals",
        "_forced",
        "_lag_ewma",
        "_hb_task",
        "_dead_ewma",
        "_pushed_level",
        "_class_levels",
        "_pushed_class_levels",
        "_soft_reasons",
        "telemetry_hook",
        "dead_completions",
        # counters (get_stats.overload)
        "shed_ops",
        "shed_by_op",
        "python_sheds",
        "deadline_drops",
        "replica_deadline_drops",
        "bg_delays",
        "bg_delayed_s",
        "soft_transitions",
        "hard_transitions",
        "window_decreases",
        "window_min_seen",
    )

    def __init__(self, shard, config) -> None:
        self.shard = shard
        self.config = config
        self._level = LEVEL_OK
        self._sampled_at = 0.0
        self._signals: dict = {}
        # Test seam (the set_fault pattern): force a level regardless
        # of the sampled signals; None disarms.
        self._forced: Optional[int] = None
        self._lag_ewma = 0.0
        self._hb_task = None
        self._dead_ewma = 0.0
        self._pushed_level: Optional[int] = None
        # Per-class levels (QoS plane): the same sampled
        # signals compared against thresholds scaled by each class's
        # factors — batch trips first, interactive last; STANDARD is
        # exactly the classic scalar level.
        self._class_levels: Tuple[int, ...] = (0,) * NCLASSES
        self._pushed_class_levels: Optional[Tuple[int, ...]] = None
        # Which signal families fired each class's soft level on the
        # last sample ("ops"/"memtable"/"debt"/"lag"/"dead") — the
        # scan plane paces instead of hard-parking when a resting
        # shard's memtable fill is the ONLY pressure (BENCH r13).
        self._soft_reasons: Tuple[frozenset, ...] = (
            frozenset(),
        ) * NCLASSES
        # Telemetry plane: the continuous sampler rides THIS
        # heartbeat — one callable check per beat when armed, nothing
        # at all when --telemetry-interval is 0 (the hook stays None).
        self.telemetry_hook = None
        self.dead_completions = 0
        self.shed_ops = 0
        self.shed_by_op: dict = {}
        # Sheds that had to run through the Python dispatcher (frame
        # shapes the C parser punts).  With the native shed gate
        # armed this stays ~0 under a client flood — the measurable
        # claim of the all-native serving path.
        self.python_sheds = 0
        self.deadline_drops = 0
        self.replica_deadline_drops = 0
        self.bg_delays = 0
        self.bg_delayed_s = 0.0
        self.soft_transitions = 0
        self.hard_transitions = 0
        self.window_decreases = 0
        self.window_min_seen = float(config.pipeline_window_max)

    # -- test seam -----------------------------------------------------

    def force_level(self, level: Optional[int]) -> None:
        """Pin the governor to ``level`` (None disarms) — the
        deterministic fault seam tests drive shedding/AIMD through
        without constructing a real timing-dependent backlog."""
        self._forced = level
        self._sampled_at = 0.0  # next level() re-evaluates

    def note_completion(self, dead: bool) -> None:
        """One served data op finished; ``dead`` = after the budget
        its client gave it (the response fed nobody).  Called from
        the serving completion points — never from the shed path, so
        shedding itself cannot mask the signal it reacts to."""
        if dead:
            self.dead_completions += 1
        self._dead_ewma += DEAD_EWMA_ALPHA * (
            (1.0 if dead else 0.0) - self._dead_ewma
        )

    # -- event-loop lag heartbeat --------------------------------------

    def _ensure_heartbeat(self) -> None:
        if self._hb_task is not None and not self._hb_task.done():
            return
        import asyncio

        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop (direct construction in tests)
        self._hb_task = self.shard.spawn(self._heartbeat())

    async def _heartbeat(self) -> None:
        import asyncio

        loop = asyncio.get_event_loop()
        while True:
            t0 = loop.time()
            await asyncio.sleep(HB_S)
            lag = max(0.0, loop.time() - t0 - HB_S)
            e = self._lag_ewma
            self._lag_ewma = (
                lag if e == 0.0 else e + LAG_EWMA_ALPHA * (lag - e)
            )
            hook = self.telemetry_hook
            if hook is not None:
                # Telemetry sampling point: a monotonic compare per
                # beat; the due samples (one get_stats walk per
                # --telemetry-interval) happen here, never on the
                # serving path.  The hook swallows its own errors.
                hook()

    # -- sampling ------------------------------------------------------

    def _sample(self) -> int:
        shard = self.shard
        cfg = self.config
        ops = 0
        for conn in shard.db_connections:
            ops += len(conn.pending) + len(conn.parked)
            ops += len(getattr(conn, "inflight", ()))
        # Watch chunks parked in an empty-ring long-poll are idle
        # (an event-wait, not queued CPU work) but still count as
        # in-flight on their connections; exclude them so a large
        # idle-subscriber pool cannot read as hard overload and
        # shed real traffic.  Watch has its own admission: the
        # subscriber cap and per-subscriber byte buckets.
        wp = getattr(shard, "watch_plane", None)
        if wp is not None:
            ops = max(0, ops - wp.parked_chunks)
        mem_fill = 0.0
        appends_fill = 0.0
        flush_backlog = False
        debt = 0
        for col in shard.collections.values():
            tree = col.tree
            cap = max(1, tree.capacity)
            mem_fill = max(mem_fill, len(tree._active) / cap)
            appends_fill = max(
                appends_fill, tree._appends_since_swap / cap
            )
            if tree._pending_flush is not None:
                flush_backlog = True
            debt = max(debt, len(tree._sstables.tables))
        lag = self._lag_ewma
        dead = self._dead_ewma
        self._signals = {
            "ops": ops,
            "memtable_fill": round(max(mem_fill, appends_fill), 3),
            "flush_backlog": int(flush_backlog),
            "sstable_debt": debt,
            "loop_lag_ms": round(lag * 1000, 1),
            "dead_completion_frac": round(dead, 3),
        }
        # Per-class levels (QoS plane): the SAME signals against
        # thresholds scaled by each class's factors — factor < 1
        # trips earlier (batch sheds first), > 1 later (interactive's
        # knee moves to a strictly higher offered-load multiple).
        # STANDARD's factors are 1.0, so its level is exactly the
        # classic single-class scalar.
        levels = []
        all_reasons = []
        for cls in range(NCLASSES):
            fs = CLASS_SOFT_FACTOR[cls]
            fh = CLASS_HARD_FACTOR[cls]
            reasons = set()
            if cfg.overload_soft_ops and ops > cfg.overload_soft_ops * fs:
                reasons.add("ops")
            if max(mem_fill, appends_fill) > MEMTABLE_SOFT_FILL * fs:
                reasons.add("memtable")
            if (
                cfg.overload_compaction_debt
                and debt > cfg.overload_compaction_debt * fs
            ):
                reasons.add("debt")
            # Wall-time signals (loop lag, dead completions) keep the
            # UNSCALED soft thresholds for every class: they measure
            # the whole shard, not one lane's queue — halving them
            # for batch would pace analytics on any legitimately busy
            # host (this host class shows tens of ms of lag under
            # healthy full load).  The class factors still scale the
            # HARD bars below, which is what moves the shed knees.
            if lag > LAG_SOFT_S:
                reasons.add("lag")
            if dead > DEAD_FRAC_SOFT:
                reasons.add("dead")
            level = LEVEL_SOFT if reasons else LEVEL_OK
            if (
                (
                    cfg.overload_hard_ops
                    and ops > cfg.overload_hard_ops * fh
                )
                or appends_fill > MEMTABLE_HARD_APPENDS * fh
                or lag > LAG_HARD_S * fh
                or dead > DEAD_FRAC_HARD * fh
            ):
                level = LEVEL_HARD
            levels.append(level)
            all_reasons.append(frozenset(reasons))
        self._class_levels = tuple(levels)
        self._soft_reasons = tuple(all_reasons)
        return levels[QOS_STANDARD]

    def level(self) -> int:
        if self._forced is not None:
            self._push_level(self._forced)
            return self._forced
        self._ensure_heartbeat()
        now = time.monotonic()
        if now - self._sampled_at >= self.SAMPLE_S:
            self._sampled_at = now
            prev = self._level
            self._level = self._sample()
            if self._level > prev:
                if self._level >= LEVEL_HARD:
                    self.hard_transitions += 1
                else:
                    self.soft_transitions += 1
        self._push_level(self._level)
        return self._level

    def class_level(self, cls: int) -> int:
        """The QoS level of one traffic class (qos.QOS_*).  Under the
        forced test seam every class reads the forced level except
        INTERACTIVE, which reads one level lower — the deterministic
        mirror of its higher thresholds (a forced LEVEL_HARD sheds
        batch+standard while interactive keeps serving, the class-
        priority contract tests pin)."""
        level = self.level()
        if self._forced is not None:
            if cls == QOS_INTERACTIVE:
                return max(LEVEL_OK, level - 1)
            return level
        if 0 <= cls < NCLASSES:
            return self._class_levels[cls]
        return level

    def soft_reasons(self, cls: int = QOS_STANDARD) -> frozenset:
        """Signal families that fired this class's soft level on the
        last sample.  Empty under the forced seam (forcing has no
        attributable signal — consumers fall back to the classic
        behavior)."""
        if self._forced is not None or not 0 <= cls < NCLASSES:
            return frozenset()
        return self._soft_reasons[cls]

    def memtable_only_soft(self, cls: int = QOS_STANDARD) -> bool:
        """True when this class reads soft (not hard) and the ONLY
        pressure is memtable fill — a resting shard whose arena sits
        near capacity with no queue/lag/debt/dead-completion signal.
        Scan chunks PACE through this state instead of hard-parking
        (BENCH r13: an 88%-fill idle shard parked every chunk 2s);
        the memtable protection that matters (appends outrunning the
        flush) shows up as ops/lag pressure or the hard level."""
        if self._forced is not None or not 0 <= cls < NCLASSES:
            return False
        return (
            self.class_level(cls) == LEVEL_SOFT
            and self._soft_reasons[cls] == frozenset(("memtable",))
        )

    def _push_level(self, level: int) -> None:
        """Mirror the level into the native data plane (all-native
        serving path): at LEVEL_HARD the C client plane answers data
        verbs with the prebuilt retryable Overloaded response itself,
        so shed frames never reach the Python dispatcher whose
        backlog the governor is protecting.  The per-class levels ride
        along (QoS plane) so the native shed gate stays class-aware:
        a batch flood is refused in C while interactive frames keep
        serving natively."""
        if self._forced is not None:
            # The forced seam's class mapping, mirrored natively.
            class_levels = tuple(
                max(LEVEL_OK, level - 1)
                if cls == QOS_INTERACTIVE
                else level
                for cls in range(NCLASSES)
            )
        else:
            class_levels = self._class_levels
        if (
            level == self._pushed_level
            and class_levels == self._pushed_class_levels
        ):
            return
        self._pushed_level = level
        self._pushed_class_levels = class_levels
        dp = getattr(self.shard, "dataplane", None)
        if dp is not None:
            dp.set_overload(level)
            dp.set_class_levels(class_levels)

    # -- decision points ----------------------------------------------

    def should_shed(self) -> bool:
        """Hard-limit admission check for NEW public data ops of the
        STANDARD class (the classic single-class scalar; per-class decisions
        live on the QoS plane)."""
        return self.level() >= LEVEL_HARD

    def any_should_shed(self) -> bool:
        """True when ANY traffic class is at its hard limit (in
        practice batch first — its thresholds sit lowest).  The
        dispatcher's routing gate: while any class sheds and the
        native shed gate is unarmed, frames must take the interpreted
        path so Python can make the per-class decision."""
        level = self.level()
        if self._forced is not None:
            return level >= LEVEL_HARD
        return max(self._class_levels) >= LEVEL_HARD

    def soft_overloaded(self) -> bool:
        return self.level() >= LEVEL_SOFT

    def record_shed(self, op: str) -> None:
        self.shed_ops += 1
        self.shed_by_op[op] = self.shed_by_op.get(op, 0) + 1

    def note_window(self, window: float, decreased: bool) -> None:
        if decreased:
            self.window_decreases += 1
        if window < self.window_min_seen:
            self.window_min_seen = window

    async def bg_gate(self) -> None:
        """Delay point for low-priority work under soft overload:
        background units wait (bounded) for the backlog to ease
        before starting — serving latency recovers first, maintenance
        resumes the moment pressure lifts (and after BG_DELAY_MAX_S
        regardless: anti-entropy/scrub must never starve outright).

        Deliberately gated on the STANDARD level, not the batch
        lane's (QoS plane): the units behind this gate include the
        compaction/flush maintenance that CURES memtable-fill and
        debt pressure, and batch's half-scaled thresholds would hold
        them parked from ~43% fill — near-permanently on a
        write-heavy shard (measured: compaction-under-load p99 blew
        its bound).  The analytics lane that must not starve
        interactive point ops is the SCAN plane, whose chunk
        admission does consume the batch budget."""
        import asyncio

        if self.level() < LEVEL_SOFT:
            return
        self.bg_delays += 1
        waited = 0.0
        while waited < BG_DELAY_MAX_S and self.level() >= LEVEL_SOFT:
            await asyncio.sleep(BG_DELAY_SLICE_S)
            waited += BG_DELAY_SLICE_S
        self.bg_delayed_s += waited

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        level = self.level()
        return {
            "level": level,
            "signals": dict(self._signals),
            "shed_ops": self.shed_ops,
            "shed_by_op": dict(self.shed_by_op),
            "python_sheds": self.python_sheds,
            "deadline_drops": self.deadline_drops,
            "replica_deadline_drops": self.replica_deadline_drops,
            "dead_completions": self.dead_completions,
            "bg_delays": self.bg_delays,
            "bg_delayed_s": round(self.bg_delayed_s, 3),
            "soft_transitions": self.soft_transitions,
            "hard_transitions": self.hard_transitions,
            "window_decreases": self.window_decreases,
            "window_min_seen": round(self.window_min_seen, 2),
            "window_max": self.config.pipeline_window_max,
        }
