"""Persistent hinted handoff log — the first leg of the replica-
convergence plane (SURVEY §5: the reference has no hinted handoff at
all; an earlier in-memory deque that died with the process).

A hint is (collection, key, timestamp, created_at) queued under the
TARGET node whose replica write was skipped or failed.  The log does
NOT store values: replay reads the coordinator's own current newest
entry for the key and pushes it via RANGE_PUSH (applied strictly-newer
on the peer), so a burst of overwrites to one hot key costs ONE hint
and one transfer, and dedup-by-newer-timestamp is structural — the
per-(collection, key) map keeps only the max timestamp.

Durability: every mutation appends one record to a per-shard
``hints-<id>.log`` (u32-LE length + msgpack frame, the WAL framing
discipline), so hints survive a restart — the node that was DOWN when
its peer diverged is exactly the node likely to restart before the
drain finishes.  Appends are buffered-write-through (no fsync): a hint
lost to a power cut is re-healed by anti-entropy, the backstop
mechanism; what the log must survive is the ordinary restart.  Node
drains append a compact ``drop`` record; the file is rewritten from
memory when the garbage ratio grows.

Bounds: ``max_per_node`` hints per target (oldest drop first — read
repair and anti-entropy cover the remainder) and a TTL
(``hint_ttl_s``): a hint older than the TTL is dropped at drain time —
a node gone longer than the TTL gets its backfill from anti-entropy,
which moves only diverged buckets, instead of a blind multi-hour
replay (Cassandra's max_hint_window semantics).
"""

from __future__ import annotations

import logging
import os
import struct
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils import msgpack_codec

log = logging.getLogger(__name__)

_LEN = struct.Struct("<I")

# Rewrite the log when it holds this many records beyond the live set
# (and at least this many bytes) — bounds file growth under churn.
COMPACT_MIN_GARBAGE = 8192
COMPACT_MIN_BYTES = 1 << 20


class HintLog:
    """Per-shard hint store: in-memory index + append-only file.

    In-memory shape: ``{node: OrderedDict[(collection, key)] ->
    (timestamp, created_at_s)}`` — insertion-ordered so capacity
    eviction drops the OLDEST hint first.
    """

    def __init__(
        self,
        path: Optional[str],
        max_per_node: int = 10_000,
        ttl_s: float = 3 * 3600.0,
    ) -> None:
        self.path = path
        self.max_per_node = max(1, max_per_node)
        self.ttl_s = ttl_s
        self._by_node: Dict[str, OrderedDict] = {}
        self._fd: int = -1
        self._appended = 0  # records in the file since last rewrite
        # Counters (surfaced in get_stats.convergence).
        self.recorded = 0
        self.replayed = 0
        self.expired = 0
        self.dropped_capacity = 0
        if path is not None:
            self._load()

    # -- persistence ---------------------------------------------------

    def _load(self) -> None:
        """Rebuild the in-memory index from the on-disk log.  Torn
        tails (crash mid-append) stop the replay at the last whole
        record; junk records are skipped — a hint file must never
        block a shard boot."""
        try:
            with open(self.path, "rb") as f:
                buf = f.read()
        except OSError:
            return
        pos = 0
        loaded = 0
        records = 0
        while pos + _LEN.size <= len(buf):
            (size,) = _LEN.unpack_from(buf, pos)
            if size > 1 << 20 or pos + _LEN.size + size > len(buf):
                break  # torn/garbage tail
            frame = buf[pos : pos + _LEN.size + size][_LEN.size :]
            pos += _LEN.size + size
            records += 1
            try:
                rec = msgpack_codec.unpackb(frame)
                if rec[0] == "h":
                    _tag, node, col, key, ts, created = rec
                    self._insert(
                        node, col, bytes(key), int(ts), float(created)
                    )
                    loaded += 1
                elif rec[0] == "x":
                    # Node drain marker: hints for this node created
                    # at or before the watermark are gone.
                    _tag, node, upto = rec
                    q = self._by_node.get(node)
                    if q:
                        for k in [
                            k
                            for k, (_ts, c) in q.items()
                            if c <= upto
                        ]:
                            del q[k]
                        if not q:
                            self._by_node.pop(node, None)
            except Exception:
                continue  # junk record: skip, keep loading
        self._appended = records
        if loaded:
            log.info(
                "hint log %s: %d hints for %d nodes after replay",
                self.path,
                sum(len(q) for q in self._by_node.values()),
                len(self._by_node),
            )

    def _append(self, rec: list) -> None:
        if self.path is None:
            return
        try:
            if self._fd < 0:
                os.makedirs(
                    os.path.dirname(self.path), exist_ok=True
                )
                self._fd = os.open(
                    self.path,
                    os.O_WRONLY | os.O_CREAT | os.O_APPEND,
                    0o644,
                )
            frame = msgpack_codec.packb(rec)
            os.write(self._fd, _LEN.pack(len(frame)) + frame)
            self._appended += 1
        except OSError as e:
            # A failing hint disk must never fail the write path the
            # hint is recorded FOR: keep the in-memory hint, log once.
            log.warning("hint log append failed: %s", e)

    def _maybe_compact(self) -> None:
        live = sum(len(q) for q in self._by_node.values())
        if self._appended - live < COMPACT_MIN_GARBAGE:
            return
        try:
            if self._fd >= 0 and (
                os.fstat(self._fd).st_size < COMPACT_MIN_BYTES
            ):
                return
        except OSError:
            pass
        self.rewrite()

    def rewrite(self) -> None:
        """Rewrite the file from the live in-memory set (tmp+rename)."""
        if self.path is None:
            return
        tmp = f"{self.path}.tmp{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                for node, q in self._by_node.items():
                    for (col, key), (ts, created) in q.items():
                        frame = msgpack_codec.packb(
                            ["h", node, col, key, ts, created]
                        )
                        f.write(_LEN.pack(len(frame)) + frame)
            os.replace(tmp, self.path)
            # Drop the old fd BEFORE reopening: if the reopen fails,
            # _fd must read -1 (the lazy open in _append recovers),
            # never a closed — possibly recycled — descriptor.
            old_fd, self._fd = self._fd, -1
            if old_fd >= 0:
                os.close(old_fd)
            self._fd = os.open(
                self.path, os.O_WRONLY | os.O_APPEND
            )
            self._appended = sum(
                len(q) for q in self._by_node.values()
            )
        except OSError as e:
            log.warning("hint log rewrite failed: %s", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def close(self) -> None:
        if self._fd >= 0:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = -1

    # -- mutation ------------------------------------------------------

    def _insert(
        self, node: str, col: str, key: bytes, ts: int, created: float
    ) -> bool:
        q = self._by_node.setdefault(node, OrderedDict())
        prev = q.get((col, key))
        if prev is not None:
            if ts <= prev[0]:
                return False  # dedup-by-newer-timestamp
            q[(col, key)] = (ts, prev[1])
            return True
        while len(q) >= self.max_per_node:
            q.popitem(last=False)  # capped: oldest hint drops first
            self.dropped_capacity += 1
        q[(col, key)] = (ts, created)
        return True

    def record(
        self, node: str, col: str, key: bytes, ts: int
    ) -> bool:
        """Queue one hint; returns True when it changed the live set
        (False = an equal-or-newer hint already covers the key)."""
        created = time.time()
        if not self._insert(node, col, key, ts, created):
            return False
        self.recorded += 1
        self._append(["h", node, col, key, ts, created])
        self._maybe_compact()
        return True

    def take_page(
        self, node: str, limit: int
    ) -> List[Tuple[str, bytes, int, float]]:
        """Pop up to ``limit`` live (collection, key, ts, created)
        hints for ``node``, oldest first, expiring TTL-dead ones on
        the way.  The caller replays the page and either acknowledges
        the drain (mark_drained) or requeues survivors (requeue) —
        ``created`` rides along so a requeue can NEVER reset a
        hint's TTL clock (a target that stays unreachable would
        otherwise refresh its hints on every failed drain and the
        TTL bound would not exist)."""
        q = self._by_node.get(node)
        if not q:
            return []
        now = time.time()
        out: List[Tuple[str, bytes, int, float]] = []
        while q and len(out) < limit:
            (col, key), (ts, created) = q.popitem(last=False)
            if self.ttl_s > 0 and now - created > self.ttl_s:
                self.expired += 1
                continue
            out.append((col, key, ts, created))
        if not q:
            self._by_node.pop(node, None)
        return out

    def requeue(
        self, node: str, items: List[Tuple[str, bytes, int, float]]
    ) -> None:
        """Put un-replayed hints back (peer raced back down etc.) —
        never dropped, ORIGINAL created timestamps preserved (the
        TTL clock keeps running across failed drains).  Re-appended
        to the log too: an earlier drain's drop marker must not
        erase them across a restart."""
        for col, key, ts, created in items:
            if self._insert(
                node, col, bytes(key), int(ts), float(created)
            ):
                self._append(["h", node, col, key, ts, created])

    def expire_ttl_dead(self, node: str) -> int:
        """Expire ``node``'s TTL-dead hints NOW (without a drain —
        the node may never drain: still down, or reloaded from the
        log after a coordinator restart that lost the departed-window
        bookkeeping).  Persists as a drop marker at the TTL cutoff,
        so a restart cannot resurrect them.  Returns the number
        dropped."""
        if self.ttl_s <= 0:
            return 0
        q = self._by_node.get(node)
        if not q:
            return 0
        cutoff = time.time() - self.ttl_s
        dead = [k for k, (_ts, c) in q.items() if c <= cutoff]
        for k in dead:
            del q[k]
        if dead:
            self.expired += len(dead)
            self._append(["x", node, cutoff])
        if not q:
            self._by_node.pop(node, None)
        return len(dead)

    def expire_node(self, node: str) -> int:
        """Drop EVERY queued hint for ``node`` as expired (the node's
        TTL window closed without it returning — anti-entropy owns
        its backfill now).  Returns the number dropped."""
        q = self._by_node.pop(node, None)
        if not q:
            return 0
        self.expired += len(q)
        self._append(["x", node, time.time()])
        return len(q)

    def mark_drained(
        self, node: str, replayed: int, drop_marker: bool = True
    ) -> None:
        """A drain pass for ``node`` pushed ``replayed`` hints: count
        them and (for a FULL drain) append the compact drop marker so
        a restart doesn't replay the already-drained prefix.  Partial
        drains pass drop_marker=False — the marker's watermark would
        cover the requeued survivors too; re-replaying an
        already-drained prefix after a restart is harmless
        (strictly-newer applies), losing survivors is not."""
        self.replayed += replayed
        if drop_marker:
            self._append(["x", node, time.time()])
        self._maybe_compact()

    # -- queries -------------------------------------------------------

    def has(self, node: str) -> bool:
        return bool(self._by_node.get(node))

    def nodes_with_hints(self) -> List[str]:
        return [n for n, q in self._by_node.items() if q]

    def queued_by_node(self) -> Dict[str, int]:
        return {n: len(q) for n, q in self._by_node.items() if q}

    def queued_total(self) -> int:
        return sum(len(q) for q in self._by_node.values())
