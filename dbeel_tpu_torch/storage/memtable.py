"""Capacity-bounded sorted memtable.

Role parity with the reference's arena red-black tree
(reference rbtree_arena/src/lib.rs:308-649): sorted in-memory map with a
hard capacity that drives the flush trigger (set errors / waits at
capacity, lsm_tree.rs:747-755), in-order iteration, and a consuming
drain for flush.

Two implementations share one contract (and produce byte-identical
SSTables):

* ``Memtable`` — a ``SortedDict`` kept ordered per insert.
* ``HashMemtable`` — a plain dict (O(1) set/get, no per-insert
  ordering work) whose ordering debt is paid once at flush by the
  device sort (ops/sort.py, K5 on the card).

The arena (native) memtable of dbeel_tpu is a later slice of the port
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

try:
    from sortedcontainers import SortedDict
except ImportError:  # no wheel in the image: bisect-backed fallback
    from ..utils.sorteddict import SortedDict

from ..errors import MemtableCapacityReached

Item = Tuple[bytes, Tuple[bytes, int]]  # key -> (value, timestamp_ns)


class MemtableBase:
    """Shared capacity / conflict semantics; subclasses choose the map
    type and the ordering strategy."""

    def __init__(self, capacity: int) -> None:
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._map = self._new_map()
        self.data_bytes = 0  # approximate on-disk size of contents
        self.max_ts = 0  # newest timestamp ever inserted

    def _new_map(self):
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self._map)

    def is_full(self) -> bool:
        return len(self._map) >= self.capacity

    def set(self, key: bytes, value: bytes, timestamp: int) -> None:
        """Insert/overwrite; errors at capacity for *new* keys, mirroring
        the arena's capacity error (rbtree_arena/src/lib.rs:7-10)."""
        if timestamp > self.max_ts:
            self.max_ts = timestamp
        prev = self._map.get(key)
        if prev is None:
            if len(self._map) >= self.capacity:
                raise MemtableCapacityReached(
                    f"memtable at capacity {self.capacity}"
                )
            self._map[key] = (value, timestamp)
            self.data_bytes += 16 + len(key) + len(value)
        elif timestamp >= prev[1]:
            # Keep the newest timestamp (reference updates in place).
            self._map[key] = (value, timestamp)
            self.data_bytes += len(value) - len(prev[0])

    def set_batch(
        self, entries: List[Tuple[bytes, bytes, int]]
    ) -> int:
        """Insert entries in order until capacity; returns how many
        were applied.  When the whole batch fits under the CURRENT
        headroom the capacity predicate is evaluated ONCE up front
        (len + batch <= capacity is sufficient even if every key is
        new) and the per-entry insert skips it; otherwise entries
        apply one by one and the count stops at the first capacity
        refusal — the caller flush-waits and retries the remainder,
        exactly like the single-set path."""
        if len(self) + len(entries) > self.capacity:
            done = 0
            for key, value, ts in entries:
                try:
                    self.set(key, value, ts)
                except MemtableCapacityReached:
                    return done
                done += 1
            return done
        m = self._map
        for key, value, ts in entries:
            if ts > self.max_ts:
                self.max_ts = ts
            prev = m.get(key)
            if prev is None:
                m[key] = (value, ts)
                self.data_bytes += 16 + len(key) + len(value)
            elif ts >= prev[1]:
                m[key] = (value, ts)
                self.data_bytes += len(value) - len(prev[0])
        return len(entries)

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        return self._map.get(key)

    def items(self) -> Iterator[Item]:
        return iter(self._map.items())

    def sorted_items(self) -> List[Item]:
        raise NotImplementedError


class HashMemtable(MemtableBase):
    """``device`` is where the flush sort runs (ops/sort.py)."""

    def __init__(self, capacity: int, device=None) -> None:
        self.device = device
        super().__init__(capacity)

    def _new_map(self):
        self._sorted_cache: Optional[List[Item]] = None
        return {}

    def set(self, key: bytes, value: bytes, timestamp: int) -> None:
        self._sorted_cache = None
        super().set(key, value, timestamp)

    def set_batch(
        self, entries: List[Tuple[bytes, bytes, int]]
    ) -> int:
        self._sorted_cache = None
        return super().set_batch(entries)

    def sorted_items(self) -> List[Item]:
        if self._sorted_cache is None:
            from ..ops.sort import sort_items

            self._sorted_cache = sort_items(
                list(self._map.items()), self.device
            )
        return self._sorted_cache


class Memtable(MemtableBase):
    def _new_map(self):
        return SortedDict()

    def sorted_items(self) -> List[Item]:
        return list(self._map.items())

    def range(
        self, lo: Optional[bytes] = None, hi: Optional[bytes] = None
    ) -> Iterator[Item]:
        for key in self._map.irange(lo, hi):
            yield key, self._map[key]
