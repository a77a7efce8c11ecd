"""Multi-tenant QoS plane — traffic classes, weighted admission,
per-tenant quotas.

The single-class governor treats all public traffic as ONE class: past the hard
limit it sheds a paid-tier point get and a bulk-load batch write with
the same hand, and one tenant's analytics stream inflates every
tenant's p99.  The LSM compaction design-space literature (PAPERS.md)
is explicit that foreground admission and background debt compete for
the same per-shard budget — without classes the cheapest work to shed
(batch) is shed no earlier than the most latency-sensitive.

This plane splits admission three ways:

* **Traffic classes** — ``interactive`` > ``standard`` > ``batch``,
  stamped by the client on the request frame (``qos`` field, wire ints
  below) and propagated on data-op peer frames as a trailing dialect
  element.  Each class gets:

  - a *shed threshold factor*: the governor's backlog signals are
    divided by the class factor before comparing against the single-class
    thresholds, so ``batch`` reads overload at half the pressure
    (sheds first) and ``interactive`` at 1.5x (its knee sits at a
    strictly higher offered-load multiple).  The per-class levels are
    pushed into the C data plane so native hard-shed answers stay
    class-aware (a batch flood is refused in C while interactive
    frames keep serving natively).
  - a *weighted admission share*: a per-shard, per-class AIMD window
    (multiplicative decrease while the class reads soft overload,
    additive recovery) whose ceiling is proportional to the class
    weight — under pressure ``batch`` is squeezed to a sliver of the
    admitted-work budget while ``interactive`` keeps most of it.
    The window only binds while the class is soft-overloaded: an
    idle shard serves any class at full speed.

* **Per-tenant token-bucket quotas** — ``--tenant-ops-per-sec`` /
  ``--tenant-bytes-per-sec`` (0 disables), keyed by the client-stamped
  ``tenant`` id with PER-COLLECTION buckets (the flag is the default
  rate each tenant gets in each collection, so one tenant's bulk load
  into ``logs`` cannot drain its own budget for ``users``).  Ops are
  charged at dispatch (an empty bucket refuses with the retryable
  ``QuotaExceeded``); bytes are charged as DEBT once the op's real
  size is known — the bucket may go negative and further ops are
  refused until the refill covers the overdraft (exact accounting
  without pre-reading payloads).

* **Scan integration** — scan-chunk admission consumes the BATCH
  lane's budget (the scan plane's default class), so one analytics
  stream cannot starve interactive point ops; a scan stamped
  ``interactive`` by an operator keeps its priority.  ``bg_gate``
  deliberately STAYS on the standard level — the units behind it
  include the compaction/flush maintenance that cures memtable/debt
  pressure, and batch's half-scaled fill bar would park them
  near-permanently on a write-heavy shard (governor.bg_gate
  documents the measured regression; tests/test_qos.py pins it).

The C planes serve every class natively below the shed thresholds
(QoS only costs anything under pressure); frames carrying a ``tenant``
id punt to the interpreted path, which owns the quota buckets — the
same division of labor as traced frames.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, Optional, Tuple

# Wire class ids + the stamp resolver live in cluster/messages.py
# (both sides of the wire share them; clients must not import server
# machinery to stamp a class) — re-exported here under the names the
# server-side policy machinery uses.
from ..cluster.messages import (
    NCLASSES,
    QOS_BATCH,
    QOS_CLASS_NAMES as CLASS_NAMES,
    QOS_INTERACTIVE,
    QOS_STANDARD,
    qos_class_of as class_of,
)
from ..errors import Overloaded, QuotaExceeded

# Per-class policy: (admission weight, soft factor, hard factor).
# Factors DIVIDE the sampled backlog signals before the single-class threshold
# compare — <1 trips earlier (sheds first), >1 later (knee moves to a
# strictly higher offered-load multiple).  STANDARD is exactly the
# single-class governor (factor 1.0), so untagged traffic behaves as before.
CLASS_WEIGHTS = (4, 2, 1)
CLASS_SOFT_FACTOR = (1.5, 1.0, 0.5)
CLASS_HARD_FACTOR = (1.5, 1.0, 0.75)

# Token-bucket burst: a tenant may spend this many seconds of its
# rate at once (refilled continuously).  >1 so a paced client that
# sleeps between batches is not punished for arriving in bursts.
BUCKET_BURST_S = 2.0


def request_class(request: dict) -> int:
    """Class index stamped on a client request map (``qos`` field)."""
    return class_of(request.get("qos"))


def request_tenant(request: dict) -> Optional[str]:
    """Tenant id stamped on a client request map, or None.  Only
    non-empty strings count (the quota key crosses the wire)."""
    t = request.get("tenant")
    if isinstance(t, str) and t:
        return t
    return None


class TokenBucket:
    """One (tenant, collection) quota bucket.  Continuous refill at
    ``rate``/s up to ``rate * BUCKET_BURST_S``; balance may go
    NEGATIVE via ``debit`` (bytes charged after the op's real size is
    known) — ``take`` refuses while the overdraft lasts."""

    __slots__ = ("rate", "burst", "tokens", "_at")

    def __init__(self, rate: float, now: Optional[float] = None) -> None:
        self.rate = float(rate)
        self.burst = max(1.0, self.rate * BUCKET_BURST_S)
        self.tokens = self.burst
        self._at = time.monotonic() if now is None else now

    def _refill(self, now: Optional[float]) -> None:
        t = time.monotonic() if now is None else now
        dt = t - self._at
        if dt > 0:
            self.tokens = min(self.burst, self.tokens + dt * self.rate)
        self._at = t

    def take(self, n: float, now: Optional[float] = None) -> bool:
        """Charge ``n`` tokens if the balance is positive (the charge
        itself may push it negative — multi-op batches are admitted
        whole or not at all).  False = refused, nothing charged."""
        self._refill(now)
        if self.tokens <= 0.0:
            return False
        self.tokens -= n
        return True

    def debit(self, n: float, now: Optional[float] = None) -> None:
        """Unconditional charge (byte debt after the fact)."""
        self._refill(now)
        self.tokens -= n


class _ClassLane:
    """Per-shard admission lane for one traffic class: inflight gauge,
    AIMD window, and the admitted/shed counters the stats block
    exports."""

    __slots__ = (
        "idx", "name", "wmin", "wmax", "window", "inflight",
        "admitted", "shed", "peer_ops", "_cooldown",
    )

    def __init__(self, idx: int, wmin: float, wmax: float) -> None:
        self.idx = idx
        self.name = CLASS_NAMES[idx]
        self.wmin = wmin
        self.wmax = wmax
        # Starts wide open: the window only matters under pressure.
        self.window = wmax
        self.inflight = 0
        self.admitted = 0
        self.shed = 0
        self.peer_ops = 0
        self._cooldown = 0

    def aimd(self, soft: bool) -> None:
        """One completed unit in this lane: multiplicative decrease
        while the CLASS reads soft overload (at most once per
        window's worth of completions — framed.aimd_tick's guard),
        additive recovery toward the class ceiling once it clears."""
        if self._cooldown > 0:
            self._cooldown -= 1
        if soft:
            if self._cooldown == 0:
                self.window = max(self.wmin, self.window / 2.0)
                self._cooldown = max(1, int(self.window))
        elif self.window < self.wmax:
            self.window = min(
                self.wmax, self.window + 1.0 / max(1.0, self.window)
            )


class QosPlane:
    """Per-shard QoS brain: class lanes + tenant buckets.  Owned by
    MyShard next to the governor; admission decisions combine the
    governor's per-class levels (signal thresholds scaled by the
    class factors) with the lane windows and the tenant buckets."""

    # Bound on distinct (tenant, collection) buckets kept live — the
    # tenant id arrives from the network; an adversarial id-per-op
    # stream must not grow this dict without bound.  Oldest-refill
    # eviction: a real tenant's bucket is touched constantly.
    MAX_BUCKETS = 4096

    def __init__(self, shard, config) -> None:
        self.shard = shard
        self.config = config
        wmin = float(max(1, config.overload_window_min))
        wmax_base = float(config.pipeline_window_max)
        max_w = max(CLASS_WEIGHTS)
        self.lanes = tuple(
            _ClassLane(
                i,
                wmin,
                max(wmin, wmax_base * CLASS_WEIGHTS[i] / max_w),
            )
            for i in range(NCLASSES)
        )
        # LRU by access (move_to_end on every touch): eviction is
        # O(1) — a min()-scan eviction would turn the adversarial
        # tenant-id-per-op stream this cap defends against into a
        # 4096-entry scan per op on the dispatch hot path.
        self._buckets: "OrderedDict[Tuple[str, str, str], TokenBucket]" = (
            OrderedDict()
        )
        # Per-tenant counters (stats): ops admitted / quota refusals.
        self.tenant_ops: Dict[str, int] = {}
        self.tenant_throttles: Dict[str, int] = {}
        self.quota_refusals = 0

    # -- class admission ----------------------------------------------

    def class_level(self, cls: int) -> int:
        return self.shard.governor.class_level(cls)

    def should_shed(self, cls: int) -> bool:
        """Hard-limit admission for NEW data ops of this class.

        Above STANDARD's floor the single-class contract holds unchanged:
        soft = backpressure (per-connection AIMD windows shrink),
        hard = shed.  Only the BATCH lane additionally sheds work
        beyond its weighted AIMD window while it reads soft — the
        admission-share squeeze that keeps one bulk load from
        occupying the backlog standard/interactive ops queue in
        (standard soft NEVER sheds, exactly as before this plane)."""
        from .governor import LEVEL_HARD, LEVEL_SOFT

        level = self.class_level(cls)
        if level >= LEVEL_HARD:
            return True
        if cls != QOS_BATCH:
            return False
        lane = self.lanes[cls]
        return level >= LEVEL_SOFT and lane.inflight >= lane.window

    def note_shed(self, cls: int) -> None:
        self.lanes[cls].shed += 1

    def begin(self, cls: int) -> None:
        lane = self.lanes[cls]
        lane.admitted += 1
        lane.inflight += 1

    def end(self, cls: int) -> None:
        from .governor import LEVEL_SOFT

        lane = self.lanes[cls]
        if lane.inflight > 0:
            lane.inflight -= 1
        lane.aimd(self.class_level(cls) >= LEVEL_SOFT)

    def note_peer(self, cls: int) -> None:
        """A replica-plane data frame carried this class (peer-frame
        dialect element): accounting only — the peer plane never
        sheds (replica work keeps quorums alive)."""
        self.lanes[cls].peer_ops += 1

    # -- tenant quotas -------------------------------------------------

    def _bucket(
        self, tenant: str, collection: str, kind: str, rate: int
    ) -> TokenBucket:
        key = (tenant, collection, kind)
        b = self._buckets.get(key)
        if b is None:
            if len(self._buckets) >= self.MAX_BUCKETS:
                self._buckets.popitem(last=False)  # LRU evict, O(1)
            b = self._buckets[key] = TokenBucket(rate)
        else:
            self._buckets.move_to_end(key)
            if b.rate != float(rate):
                # A per-collection override landed (or changed) after
                # this bucket was minted: adopt the new rate in place,
                # keeping the accumulated balance/debt.
                b.rate = float(rate)
                b.burst = max(1.0, b.rate * BUCKET_BURST_S)
        return b

    def quota_rates(self, collection) -> "Tuple[int, int]":
        """Effective (ops_per_sec, bytes_per_sec) for one collection:
        DDL-carried per-collection overrides (``create_collection``'s
        ``quotas`` metadata) beat the
        ``--tenant-*`` flag defaults; 0 disables a limit either way."""
        cfg = self.config
        ops, byts = cfg.tenant_ops_per_sec, cfg.tenant_bytes_per_sec
        cols = getattr(self.shard, "collections", None)
        col = (
            cols.get(collection)
            if cols is not None and isinstance(collection, str)
            else None
        )
        q = getattr(col, "quotas", None) if col is not None else None
        if q:
            if q.get("ops_per_sec") is not None:
                ops = int(q["ops_per_sec"])
            if q.get("bytes_per_sec") is not None:
                byts = int(q["bytes_per_sec"])
        return ops, byts

    def charge_ops(
        self, tenant: Optional[str], collection, n: int = 1
    ) -> None:
        """Admission-time op charge.  Raises the retryable
        ``QuotaExceeded`` when the tenant's op OR byte bucket for this
        collection is exhausted (byte debt blocks new ops until the
        refill covers it)."""
        if tenant is None:
            return
        col = collection if isinstance(collection, str) else ""
        ops_rate, bytes_rate = self.quota_rates(col)
        # Byte-debt check FIRST: it charges nothing, so an op refused
        # for byte debt must not burn ops tokens (a tenant retrying
        # through a byte overdraft would otherwise drain its ops
        # bucket on refusals and stay throttled past the byte quota).
        if bytes_rate > 0:
            b = self._bucket(tenant, col, "bytes", bytes_rate)
            b._refill(None)
            if b.tokens <= 0.0:
                self._refuse(tenant, "bytes")
        if ops_rate > 0:
            if not self._bucket(tenant, col, "ops", ops_rate).take(n):
                self._refuse(tenant, "ops")
        self._bump(self.tenant_ops, tenant, n)

    def charge_bytes(
        self, tenant: Optional[str], collection, nbytes: int
    ) -> None:
        """Post-op byte debt (the real payload size is only known
        after encode/serve).  Never raises — the NEXT op pays."""
        if tenant is None or nbytes <= 0:
            return
        col = collection if isinstance(collection, str) else ""
        rate = self.quota_rates(col)[1]
        if rate <= 0:
            return
        self._bucket(tenant, col, "bytes", rate).debit(nbytes)

    def _bump(self, d: Dict[str, int], tenant: str, n: int) -> None:
        """Bounded per-tenant counter bump: the tenant id arrives
        from the network, so these dicts carry the same adversarial-
        id-per-op exposure as the bucket table — past the cap an
        arbitrary existing entry is dropped (observability counters,
        not accounting state; real tenants are re-bumped constantly
        and every get_stats response stays bounded)."""
        if tenant not in d and len(d) >= self.MAX_BUCKETS:
            d.pop(next(iter(d)))
        d[tenant] = d.get(tenant, 0) + n

    def _refuse(self, tenant: str, which: str) -> None:
        self.quota_refusals += 1
        self._bump(self.tenant_throttles, tenant, 1)
        raise QuotaExceeded(
            f"tenant {tenant!r} over its {which} quota; retry after "
            "backoff — tokens refill continuously"
        )

    # -- errors shared with the dispatcher ----------------------------

    def shed_error(self, cls: int) -> Overloaded:
        """The interpreted shed error.  Message BYTE-IDENTICAL to the
        prebuilt native shed response (install_native_overload_
        responses packs the same text) — the two paths must answer
        the same bytes; which CLASS shed lives in the lane counters,
        not the message."""
        self.note_shed(cls)
        return Overloaded(
            f"shard {self.shard.shard_name} shedding load"
        )

    # -- observability -------------------------------------------------

    def stats(self) -> dict:
        classes = {}
        for lane in self.lanes:
            classes[lane.name] = {
                "admitted": lane.admitted,
                "shed": lane.shed,
                "inflight": lane.inflight,
                "window": round(lane.window, 2),
                "window_max": round(lane.wmax, 2),
                "peer_ops": lane.peer_ops,
                "level": self.class_level(lane.idx),
            }
        dp = getattr(self.shard, "dataplane", None)
        native_sheds = (
            dp.sheds_by_class() if dp is not None else None
        )
        if native_sheds is not None:
            for i, lane in enumerate(self.lanes):
                classes[lane.name]["native_sheds"] = native_sheds[i]
        # Native lane accounting: frames the C
        # planes served per class.  ``peer_ops`` counts interpreted
        # replica frames; ``peer_ops_native`` adds the C-served share
        # so replica-plane class accounting covers BOTH paths.
        native_admits = (
            dp.admits_by_class() if dp is not None else None
        )
        if native_admits is not None:
            client_adm, peer_adm = native_admits
            for i, lane in enumerate(self.lanes):
                classes[lane.name]["native_admits"] = client_adm[i]
                classes[lane.name]["peer_ops_native"] = peer_adm[i]
        tenants = {}
        for t in self.tenant_ops:
            tenants[t] = {
                "ops": self.tenant_ops.get(t, 0),
                "throttles": self.tenant_throttles.get(t, 0),
            }
        for t in self.tenant_throttles:
            if t not in tenants:
                tenants[t] = {
                    "ops": 0,
                    "throttles": self.tenant_throttles[t],
                }
        # Live token balances (rounded): the operator's "why is this
        # tenant throttled" answer.  Keyed tenant/collection/kind.
        tokens = {}
        for (t, col, kind), b in self._buckets.items():
            tokens.setdefault(t, {}).setdefault(col, {})[kind] = round(
                b.tokens, 1
            )
        return {
            "classes": classes,
            "tenants": tenants,
            "tenant_tokens": tokens,
            "quota_refusals": self.quota_refusals,
            "ops_per_sec_limit": self.config.tenant_ops_per_sec,
            "bytes_per_sec_limit": self.config.tenant_bytes_per_sec,
        }
