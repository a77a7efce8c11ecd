"""Capacity-bounded sorted memtable.

Role parity with the reference's arena red-black tree
(reference rbtree_arena/src/lib.rs:308-649): sorted in-memory map with a
hard capacity that drives the flush trigger (set errors / waits at
capacity, lsm_tree.rs:747-755), in-order iteration, and a consuming
drain for flush.

Three implementations share one contract (and produce byte-identical
SSTables):

* ``Memtable`` — a ``SortedDict`` kept ordered per insert.
* ``HashMemtable`` — a plain dict (O(1) set/get, no per-insert
  ordering work) whose ordering debt is paid once at flush by the
  device sort (ops/sort.py, K5 on the card).
* ``ArenaMemtable`` — the C++ arena red-black tree of ``native/``,
  which also writes its own flush in one GIL-free call.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, List, Optional, Tuple

try:
    from sortedcontainers import SortedDict
except ImportError:  # no wheel in the image: bisect-backed fallback
    from ..utils.sorteddict import SortedDict

from ..errors import MemtableCapacityReached
from .entry import PAGE_SIZE

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
        return len(self) >= self.capacity

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

    def range(
        self, lo: Optional[bytes] = None, hi: Optional[bytes] = None
    ) -> Iterator[Item]:
        """Items with ``lo <= key <= hi``: a linear filter over the
        sorted view (the sorted Memtable overrides it with irange)."""
        for key, val in self.sorted_items():
            if (lo is None or key >= lo) and (hi is None or key <= hi):
                yield key, val


class ArenaMemtable(MemtableBase):
    """The C++ arena red-black tree (native/): nodes in one
    pre-allocated array, capacity-bounded, sorted in-order iteration —
    the analog of the reference's rbtree_arena.  Same contract and
    byte-identical SSTables as the Python maps; ``max_ts`` is tracked on
    the C side.  Raises when the native library cannot be built."""

    def __init__(self, capacity: int) -> None:
        from . import native

        self._lib = native.require()
        self._handle = self._lib.dbeel_memtable_new(capacity)
        if not self._handle:
            raise MemoryError("arena memtable allocation failed")
        super().__init__(capacity)

    def _new_map(self):
        return None  # storage lives in the native arena

    def __len__(self) -> int:
        return int(self._lib.dbeel_memtable_len(self._handle))

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.dbeel_memtable_free(handle)
            self._handle = None

    @property
    def max_ts(self) -> int:
        return int(self._lib.dbeel_memtable_max_ts(self._handle))

    @max_ts.setter
    def max_ts(self, _v) -> None:
        pass  # the base __init__ assigns 0; the C counter is the truth

    def set(self, key: bytes, value: bytes, timestamp: int) -> None:
        old_len = ctypes.c_uint32(0)
        rc = self._lib.dbeel_memtable_set(
            self._handle, key, len(key), value, len(value), timestamp,
            ctypes.byref(old_len),
        )
        if rc == -1:
            raise MemtableCapacityReached(
                f"memtable at capacity {self.capacity}"
            )
        if rc == -2:
            raise MemoryError("arena memtable allocation failed")
        if rc == 0:  # a new key
            self.data_bytes += 16 + len(key) + len(value)
        elif rc == 1:  # replaced an older value
            self.data_bytes += len(value) - int(old_len.value)

    def get(self, key: bytes) -> Optional[Tuple[bytes, int]]:
        val = ctypes.POINTER(ctypes.c_uint8)()
        vlen = ctypes.c_uint32(0)
        ts = ctypes.c_int64(0)
        if not self._lib.dbeel_memtable_get(
            self._handle, key, len(key), ctypes.byref(val),
            ctypes.byref(vlen), ctypes.byref(ts),
        ):
            return None
        # Copy out: the pointer aliases the arena until the next set.
        return (
            ctypes.string_at(val, vlen.value) if vlen.value else b"",
            int(ts.value),
        )

    def set_batch(
        self, entries: List[Tuple[bytes, bytes, int]]
    ) -> int:
        # The arena enforces capacity per insert (its node pool is the
        # bound), so the base class's one up-front check cannot apply;
        # the count stops at the first refusal as there.
        done = 0
        for key, value, ts in entries:
            try:
                self.set(key, value, ts)
            except MemtableCapacityReached:
                return done
            done += 1
        return done

    def sorted_items(self) -> List[Item]:
        """The in-order dump: records of [u32 klen][u32 vlen][i64 ts]
        [key][value] — the data file's record layout."""
        size = int(self._lib.dbeel_memtable_dump_size(self._handle))
        buf = bytearray(max(1, size))
        n = int(self._lib.dbeel_memtable_dump(
            self._handle, (ctypes.c_uint8 * len(buf)).from_buffer(buf)
        ))
        raw = bytes(buf)
        items: List[Item] = []
        off = 0
        for _ in range(n):
            klen = int.from_bytes(raw[off: off + 4], "little")
            vlen = int.from_bytes(raw[off + 4: off + 8], "little")
            ts = int.from_bytes(raw[off + 8: off + 16], "little", signed=True)
            key = raw[off + 16: off + 16 + klen]
            value = raw[off + 16 + klen: off + 16 + klen + vlen]
            items.append((key, (value, ts)))
            off += 16 + klen + vlen
        return items

    def items(self) -> Iterator[Item]:
        return iter(self.sorted_items())

    # The LSMTree's flush dispatch keys on this capability.
    has_native_flush = True

    def flush_to_sstable(
        self, dir_path: str, index: int, bloom_min_size: int
    ) -> int:
        """Write the SSTable triplet (data, index, bloom when the data
        reaches ``bloom_min_size``) in one native call, byte-identical
        to the EntryWriter path; returns the entry count.  Raises on an
        I/O failure (partial outputs are unlinked natively)."""
        rc = int(self._lib.dbeel_memtable_flush_write(
            self._handle, dir_path.encode(), index, bloom_min_size
        ))
        if rc < 0:
            raise OSError(f"native memtable flush failed for index {index}")
        return rc

    def flush_to_sstable_with_sums(
        self, dir_path: str, index: int, bloom_min_size: int
    ) -> int:
        """The single-pass flush: the triplet and its ``.sums`` sidecar
        in one GIL-free call — the C writer page-CRCs every byte as it
        emits it, so the sidecar costs no re-read.  Returns the entry
        count."""
        lib = self._lib
        # The dump format is the data file's record format, so the dump
        # size is the data file's size; the index is 16 bytes an entry.
        # One page of slack each.
        data_bytes = int(lib.dbeel_memtable_dump_size(self._handle))
        n_entries = int(lib.dbeel_memtable_len(self._handle))
        data_cap = data_bytes // PAGE_SIZE + 2
        index_cap = (n_entries * 16) // PAGE_SIZE + 2
        data_crcs = (ctypes.c_uint32 * data_cap)()
        index_crcs = (ctypes.c_uint32 * index_cap)()
        n_data = ctypes.c_uint64(0)
        n_index = ctypes.c_uint64(0)
        bloom_crc = ctypes.c_uint32(0)
        wrote_bloom = ctypes.c_int32(0)
        rc = int(lib.dbeel_memtable_flush_write2(
            self._handle, dir_path.encode(), index, bloom_min_size,
            data_crcs, data_cap, index_crcs, index_cap,
            ctypes.byref(n_data), ctypes.byref(n_index),
            ctypes.byref(bloom_crc), ctypes.byref(wrote_bloom),
        ))
        if rc == -1:
            raise OSError(f"native memtable flush failed for index {index}")
        if rc < 0:
            # The CRC arrays were refused as too small: impossible with
            # the exact sizing above.
            raise RuntimeError(
                f"native flush of index {index} refused the page-CRC "
                f"arrays ({data_cap}, {index_cap})"
            )
        from . import checksums

        checksums.write_crcs(
            dir_path,
            index,
            list(data_crcs[: n_data.value]),
            list(index_crcs[: n_index.value]),
            data_bytes,
            int(bloom_crc.value),
            bool(wrote_bloom.value),
        )
        return rc


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
