"""Share-weighted foreground/background scheduling on the shard loop.

Role parity with the reference's glommio task queues: serving runs in a
queue with ``foreground_tasks_shares`` (default 1000) and
``Latency::Matters(20ms)``, while compaction/migration run with
``background_tasks_shares`` (default 250), so background work gets
bg/(fg+bg) of the CPU while serving is busy and the whole CPU when it
isn't (reference src/tasks/db_server.rs:456-473,
reference src/args.rs:160-172).

asyncio has neither task priorities nor preemption, so the analog is
cooperative and work-conserving: every background *unit* (one
compaction merge, one migration batch, one hint replay) runs inside
``bg_slice()``, which measures the unit's wall time and then, for as
long as foreground work keeps arriving, idles ``elapsed * fg/bg``
seconds — converging on the glommio ratio under load and imposing zero
delay on an idle shard.

Units alone would be too coarse — one unit is a whole merge, and the
reference's merge yields between heap pops — so long merges are ALSO
sliced internally: every merge strategy carries a ``BgThrottle``
(thread-safe, usable from the executor thread the merge runs on) and
ticks it between bounded quanta (pipeline partitions, native heap-merge
entry blocks, columnar write chunks).  Each tick pays back
``quantum * fg/bg`` of idle time while serving stays busy, bounding how
long a compaction can monopolise the CPU against a latency-sensitive
request to roughly one quantum — the Latency::Matters(20ms) analog
(reference src/tasks/db_server.rs:466-471).
"""

from __future__ import annotations

import asyncio
import time
from contextlib import asynccontextmanager


class ShareScheduler:
    # A foreground op marks the shard "busy" for at least this long;
    # under any sustained load the window never expires between
    # requests.
    FG_WINDOW_S = 0.1
    # Sparse-but-steady traffic: the busy window
    # adapts to the measured request cadence — an EWMA of interarrival
    # gaps — so one op every 200ms still counts as a busy shard and
    # bounds background quanta.  The window is capped so a lone
    # straggler op can't pin throttling on for more than this long
    # after traffic actually stops (work conservation).
    FG_MAX_WINDOW_S = 2.0
    _GAP_ALPHA = 0.25  # EWMA blend for interarrival gaps
    # Throttle sleeps poll foreground activity at this period so an
    # idle shard releases background work promptly (work conservation).
    POLL_S = 0.05

    def __init__(self, fg_shares: int = 1000, bg_shares: int = 250):
        if fg_shares <= 0 or bg_shares <= 0:
            raise ValueError("task shares must be positive")
        self.fg_shares = fg_shares
        self.bg_shares = bg_shares
        # Overload-control hook: the shard's LoadGovernor
        # installs its bg_gate here — past the soft limit, background
        # units wait (bounded) BEFORE starting, so low-priority work
        # is the first thing an overloaded shard delays.  None (tests,
        # benches, unwired trees) is free.
        self.overload_gate = None
        self._ratio = fg_shares / bg_shares
        self._last_fg = float("-inf")
        self._fg_gap_ewma = 0.0
        self.fg_ops = 0
        self.bg_units = 0
        self.bg_busy_s = 0.0
        self.bg_throttled_s = 0.0
        # Busy time intra-merge ticks have already charged the share
        # ratio for — bg_slice subtracts it so a merge that throttled
        # itself internally is not charged a second time by the outer
        # unit payback.
        self.bg_precharged_s = 0.0

    # -- foreground side (serving path: one call per request) ----------
    def fg_mark(self) -> None:
        now = time.monotonic()
        last = self._last_fg
        if last != float("-inf"):
            # Clamp the gap so a burst after a long idle stretch does
            # not inflate the EWMA past the window cap anyway.
            gap = min(now - last, self.FG_MAX_WINDOW_S)
            ewma = self._fg_gap_ewma
            self._fg_gap_ewma = (
                gap
                if ewma == 0.0
                else ewma + self._GAP_ALPHA * (gap - ewma)
            )
        self._last_fg = now
        self.fg_ops += 1

    def fg_busy(self) -> bool:
        # Busy while within 2 EWMA-gaps of the last request (steady
        # sparse cadence stays "busy" between its own requests), never
        # less than FG_WINDOW_S nor more than FG_MAX_WINDOW_S.  Reads
        # two floats — safe from BgThrottle's worker threads.
        window = max(
            self.FG_WINDOW_S,
            min(2.0 * self._fg_gap_ewma, self.FG_MAX_WINDOW_S),
        )
        return time.monotonic() - self._last_fg < window

    # -- background side ----------------------------------------------
    @asynccontextmanager
    async def bg_slice(self, gated: bool = True):
        """Wrap one background unit of work; idles afterwards in
        proportion to the unit's duration while foreground stays busy.
        Work an attached BgThrottle already paid for mid-unit (its
        sleeps AND the quanta it charged) is excluded, otherwise a
        self-throttling merge pays the share ratio twice.  (Concurrent
        units on other trees can tick the same scheduler inside this
        window — the subtraction then errs toward less throttling,
        never more.)

        ``gated=False`` skips the overload-gate delay (not the payback
        throttle): for work that slices ONE logical job into many
        small units (migration pages), the gate is paid once by the
        first unit — re-paying the full bounded delay per page would
        multiply it by the page count and starve the job under a
        sustained soft-overload signal (e.g. a near-full memtable with
        no traffic to trigger the flush)."""
        gate = self.overload_gate
        if gated and gate is not None:
            # Soft-overload delay BEFORE the unit runs: shedding
            # order is background first, serving last.
            await gate()
        t0 = time.monotonic()
        thr0 = self.bg_throttled_s
        pre0 = self.bg_precharged_s
        try:
            yield
        finally:
            elapsed = time.monotonic() - t0
            covered = (self.bg_throttled_s - thr0) + (
                self.bg_precharged_s - pre0
            )
            self.bg_units += 1
            # Stats keep the full unit duration; only the payback debt
            # excludes already-covered time.
            self.bg_busy_s += elapsed
            await self._throttle(
                max(0.0, elapsed - covered) * self._ratio
            )

    async def _throttle(self, debt: float) -> None:
        while debt > 0 and self.fg_busy():
            step = min(self.POLL_S, debt)
            t0 = time.monotonic()
            await asyncio.sleep(step)
            slept = time.monotonic() - t0
            self.bg_throttled_s += slept
            debt -= slept

    def thread_throttle(self) -> "BgThrottle":
        """A throttle for background WORKER THREADS (merges run off-loop
        via run_in_executor): tick it between bounded work quanta."""
        return BgThrottle(self)

    def stats(self) -> dict:
        return {
            "foreground_shares": self.fg_shares,
            "background_shares": self.bg_shares,
            "foreground_ops": self.fg_ops,
            "background_units": self.bg_units,
            "background_busy_s": round(self.bg_busy_s, 6),
            "background_throttled_s": round(self.bg_throttled_s, 6),
            "background_precharged_s": round(self.bg_precharged_s, 6),
        }


class BgThrottle:
    """Cooperative intra-merge throttle, callable from any thread.

    Each ``tick()`` measures the quantum since the previous tick and
    sleeps ``quantum * fg/bg`` (in POLL_S steps, re-checking) for as
    long as foreground traffic keeps the shard busy; an idle shard pays
    nothing.  ``time.sleep`` releases the GIL, handing the CPU to the
    event-loop thread — which is the whole point on a one-core host.
    Quanta are clamped so a long un-ticked stretch (device kernel wait,
    big IO) can't convert into one giant stall afterwards.
    """

    MAX_QUANTUM_S = 0.5

    __slots__ = ("_sched", "_last")

    def __init__(self, scheduler: ShareScheduler) -> None:
        self._sched = scheduler
        self._last = time.monotonic()

    def reset(self) -> None:
        self._last = time.monotonic()

    def tick(self) -> None:
        s = self._sched
        now = time.monotonic()
        quantum = min(now - self._last, self.MAX_QUANTUM_S)
        s.bg_precharged_s += quantum
        debt = quantum * s._ratio
        while debt > 0 and s.fg_busy():
            step = min(s.POLL_S, debt)
            time.sleep(step)
            s.bg_throttled_s += step
            debt -= step
        self._last = time.monotonic()

    __call__ = tick
