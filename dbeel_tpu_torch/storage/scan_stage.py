"""Vectorized columnar scan staging (streaming scan plane).

The per-entry async tree walk (``LSMTree.iter_filter``) pays
interpreted-Python cost per entry — fine for anti-entropy's bounded
pages, hopeless as the serving path of a client-visible scan.  This
module reuses the columnar trick of the vectorized range digests
(storage/range_digest.py): one bulk index-column read per sstable, one
native murmur batch for the arc filter, and numpy sorting for the
newest-wins merge — then every scan PAGE is a couple of searchsorteds
plus a cumsum over precomputed size columns, with value bytes
materialized ONLY for the entries actually emitted (through the
CRC-verified read path).

Shape:

* ``build_stage(memtable_items, tables, device)`` — one point-in-time
  merge of every source into key-sorted, newest-wins-deduplicated
  columns (padded fixed-width key matrix, ts/hash/value-size columns).
  CPU heavy: run it off-loop on a scan snapshot; the owning tree caches
  the result until a write or table-list change invalidates it, so a
  multi-chunk scan stages once.  ``device`` is where the stage's
  filter kernels run (ops/query_kernels.py).
* ``ScanStage.select(...)`` — pure numpy page selection (arc/hash
  membership, key > start_after, key-prefix window, byte budget):
  returns the chosen positions without touching value bytes, so
  ``count`` and keys-only pushdown never materialize a value.
* ``ScanStage.select_window(...)`` — the filtered scan's window: the
  next run of arc members cut by bytes SCANNED, whatever the predicate
  says (storage/query_vec.py evaluates it over the stage's columns).
* ``ScanStage.entries_at(...)`` — loop-side value reads for ONE page
  out of the table mappings, each 4 KiB page verified once against the
  CRC sidecar (``_TableSrc.value_at``) before it serves.

Returns None (callers fall back to the per-entry path) when the native
murmur batch is unavailable, a table looks torn, keys are wider than
the padding cap, or any key ends in a NUL byte (numpy's fixed-width
bytes dtype strips trailing NULs, which would alias two distinct
keys).  Ordering is raw encoded-key byte order — the storage order —
and numpy 'S' comparison matches Python bytes comparison for
non-NUL-terminated keys (embedded NULs included).
"""

from __future__ import annotations

import zlib
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..errors import CorruptedFile

# Prefix-window upper bound: one definition, shared with the golden
# evaluator (query.py) so the staged window cut and the per-entry
# reference can never diverge on the all-0xff edge.
from ..query import increment_prefix  # noqa: F401  (re-exported)
from . import checksums
from . import native as native_mod
from .columnar import ranges_to_positions
from .entry import ENTRY_HEADER_SIZE, PAGE_SIZE
from .range_digest import _batch_hash, _Cols, range_members_mask

# Fallback guards: pathological key shapes take the per-entry path
# instead of an unbounded padded matrix.
MAX_KEY_WIDTH = 512
MAX_MATRIX_BYTES = 256 << 20
# Below this many total entries the stage build costs more than the
# per-entry loop it replaces.
MIN_VECTORIZED_ENTRIES = 512

# Per-entry wire overhead charged against the page byte budget (frame
# list headers + ts int), so budget accounting tracks what actually
# crosses the wire, not just raw key/value bytes.
ENTRY_OVERHEAD = 16




class _TableSrc:
    """One staged sstable's value-serving view: the data memmap the
    key columns were gathered from, plus lazy per-4KiB-page CRC
    verification against the .sums sidecar — each page verifies at
    most ONCE per stage lifetime, then values slice straight out of
    the mapping (the per-entry page-cache read_at measured ~6µs/value
    and dominated page cost; a one-shot crc32 per touched page is
    ~1µs/4KiB and upholds the verify-before-serve contract)."""

    __slots__ = ("table", "data", "mv", "crcs", "verified")

    def __init__(self, table, data: np.ndarray) -> None:
        self.table = table
        self.data = data
        # Values slice through a memoryview of the mapping: numpy
        # memmap __getitem__ constructs a fresh memmap object per
        # access (~4.6µs measured); a memoryview slice is ~0.1µs.
        self.mv = memoryview(data) if data.size else memoryview(b"")
        self.crcs = (
            table.sums.data_crcs
            if table.sums is not None
            and checksums.verification_enabled()
            else None
        )
        self.verified = (
            bytearray(
                (data.size + PAGE_SIZE - 1) // PAGE_SIZE
            )
            if self.crcs is not None
            else None
        )

    def _verify_page(self, i: int) -> None:
        start = i * PAGE_SIZE
        raw = bytes(self.mv[start : start + PAGE_SIZE])
        crc = zlib.crc32(raw)
        if len(raw) < PAGE_SIZE:
            crc = zlib.crc32(b"\x00" * (PAGE_SIZE - len(raw)), crc)
        if i >= len(self.crcs) or crc != self.crcs[i]:
            exc = CorruptedFile(
                f"{self.table.data_path}: scan-stage page {i} crc "
                "mismatch"
            )
            exc.path = self.table.data_path
            raise exc
        self.verified[i] = 1

    def value_at(self, off: int, ln: int) -> bytes:
        if self.verified is not None:
            first = off // PAGE_SIZE
            last = (off + ln - 1) // PAGE_SIZE
            for i in range(first, last + 1):
                if not self.verified[i]:
                    self._verify_page(i)
        return bytes(self.mv[off : off + ln])


class ScanStage:
    """Key-sorted, deduplicated columnar view of one tree snapshot."""

    __slots__ = (
        "keys",
        "klen",
        "ts",
        "hash",
        "vlen",
        "src",
        "off",
        "fsz",
        "sources",
        "n",
        "_hold",  # optional ScanSnapshot pinning table refs
        # Query compute plane: lazily-built per-field value
        # columns and per-predicate match masks, cached for the
        # stage lifetime like the key matrix (storage/query_vec.py).
        "_field_cols",
        "_mask_cache",
        # Where the numeric leaves' filter kernels run (the owning
        # tree's device: None = the card).
        "device",
    )

    def __init__(
        self, keys, klen, ts, h, vlen, src, off, fsz, sources,
        device=None,
    ) -> None:
        self.keys = keys  # S{w}, ascending
        self.klen = klen  # int64
        self.ts = ts  # int64
        self.hash = h  # uint32 (murmur3_32 of the key)
        self.vlen = vlen  # int64 (0 = tombstone)
        self.src = src  # int32 index into sources
        self.off = off  # int64: record offset (tables) / item index
        self.fsz = fsz  # int64: full record size (tables only)
        self.sources = sources  # SSTable objects; last = memtable items
        self.n = int(keys.size)
        self._hold = None
        self._field_cols: dict = {}
        self._mask_cache: dict = {}
        self.device = device

    # -- page selection (pure numpy; executor-safe) --------------------

    def select(
        self,
        start: int,
        end: int,
        start_after: Optional[bytes],
        prefix: Optional[bytes],
        limit: int,
        max_bytes: int,
        with_values: bool,
    ) -> Tuple[np.ndarray, bool]:
        """Positions of the next page (ascending by key) and whether
        more matching entries exist beyond it."""
        lo, hi = 0, self.n
        width = self.keys.dtype.itemsize
        if prefix:
            if len(prefix) > width:
                # Wider than any stored key: nothing can match.
                return np.zeros(0, dtype=np.int64), False
            lo = int(np.searchsorted(self.keys, prefix, side="left"))
            upper = increment_prefix(prefix)
            if upper is not None:
                hi = int(
                    np.searchsorted(self.keys, upper, side="left")
                )
        if start_after is not None:
            # Truncation to the column width keeps > exact: a stored
            # key exceeds a LONGER start_after iff it exceeds its
            # width-byte prefix (equality would make it a strict
            # prefix of start_after, i.e. smaller).
            lo = max(
                lo,
                int(
                    np.searchsorted(
                        self.keys,
                        start_after[:width],
                        side="right",
                    )
                ),
            )
        if lo >= hi:
            return np.zeros(0, dtype=np.int64), False
        member = range_members_mask(self.hash[lo:hi], start, end)
        pos = lo + np.flatnonzero(member)
        total = int(pos.size)
        if total == 0:
            return pos.astype(np.int64), False
        # Clip to the page entry limit BEFORE the size/cumsum work:
        # at most ``limit`` entries can be returned, and computing
        # sizes over every remaining matching entry would make a
        # full scan's total selection cost quadratic in stage size.
        pos = pos[: int(limit)]
        sz = self.klen[pos] + ENTRY_OVERHEAD
        if with_values:
            sz = sz + self.vlen[pos]
        cum = np.cumsum(sz)
        m = int(np.searchsorted(cum, max_bytes, side="left")) + 1
        m = max(1, min(m, int(limit), int(pos.size)))
        return pos[:m].astype(np.int64), m < total

    def select_window(
        self,
        start: int,
        end: int,
        start_after: Optional[bytes],
        prefix: Optional[bytes],
        limit: int,
        max_bytes: int,
    ) -> Tuple[np.ndarray, bool, int]:
        """Filtered-scan window (query compute plane): the
        next ``limit``/``max_bytes``-bounded run of arc-member
        positions REGARDLESS of predicate outcome, plus whether more
        exist and the SCANNED byte size of the window.  Unlike
        ``select`` the cut is on bytes *scanned* (key + value + wire
        overhead — the work the filter actually performs), not bytes
        returned: that is what the coordinator bills against
        ``--scan-bytes-per-slice``, and it keeps a 0.01%-selectivity
        page from degenerating into an unbounded walk for one
        matching row.  The window's last key is the resume cover
        even when nothing in it matches."""
        lo, hi = 0, self.n
        width = self.keys.dtype.itemsize
        if prefix:
            if len(prefix) > width:
                return np.zeros(0, dtype=np.int64), False, 0
            lo = int(np.searchsorted(self.keys, prefix, side="left"))
            upper = increment_prefix(prefix)
            if upper is not None:
                hi = int(
                    np.searchsorted(self.keys, upper, side="left")
                )
        if start_after is not None:
            lo = max(
                lo,
                int(
                    np.searchsorted(
                        self.keys,
                        start_after[:width],
                        side="right",
                    )
                ),
            )
        if lo >= hi:
            return np.zeros(0, dtype=np.int64), False, 0
        member = range_members_mask(self.hash[lo:hi], start, end)
        pos = lo + np.flatnonzero(member)
        total = int(pos.size)
        if total == 0:
            return pos.astype(np.int64), False, 0
        pos = pos[: int(limit)]
        sz = self.klen[pos] + ENTRY_OVERHEAD + self.vlen[pos]
        cum = np.cumsum(sz)
        m = int(np.searchsorted(cum, max_bytes, side="left")) + 1
        m = max(1, min(m, int(limit), int(pos.size)))
        return (
            pos[:m].astype(np.int64),
            m < total,
            int(cum[m - 1]),
        )

    # -- materialization (loop-side; verified reads) -------------------

    def key_at(self, p: int) -> bytes:
        # Item access strips trailing NULs — exact for the keys the
        # build guard admits (none end in NUL).
        return bytes(self.keys[p])

    def entries_at(
        self, pos: np.ndarray, with_values: bool
    ) -> list:
        """Wire entries [key, value|nil, ts] for a page's positions,
        column-at-a-time: one ``.tolist()`` per column instead of
        eight numpy scalar indexings per entry (the per-entry form
        measured ~4x slower and dominated page cost).  Live values
        read through the CRC-verified ``read_at`` path — value bytes
        only, no record re-copy; tombstones and keys-only pages read
        nothing."""
        keys = self.keys[pos].tolist()  # S dtype -> python bytes
        ts = self.ts[pos].tolist()
        vlen = self.vlen[pos].tolist()
        if not with_values:
            return [
                [k, b"" if v == 0 else None, t]
                for k, t, v in zip(keys, ts, vlen)
            ]
        src = self.src[pos].tolist()
        off = self.off[pos].tolist()
        klen = self.klen[pos].tolist()
        sources = self.sources
        out = []
        for i, k in enumerate(keys):
            v = vlen[i]
            if v == 0:
                out.append([k, b"", ts[i]])  # tombstone: explicit
                continue
            source = sources[src[i]]
            if isinstance(source, list):  # memtable items
                out.append([k, source[off[i]][1], ts[i]])
            else:
                out.append(
                    [
                        k,
                        source.value_at(
                            off[i] + ENTRY_HEADER_SIZE + klen[i],
                            v,
                        ),
                        ts[i],
                    ]
                )
        return out


def _table_columns(table):
    """(key_cols, entry_off, full_size, vlen) for one sstable, or None
    on a torn view."""
    offs, ks, fs = table.read_index_columns()
    n = offs.size
    empty = np.zeros(0, np.int64)
    if n == 0:
        cols = _Cols(
            np.zeros(0, np.uint8),
            empty,
            np.zeros(0, np.uint32),
            empty.copy(),
        )
        return cols, empty, empty.copy(), empty.copy()
    data = np.memmap(table.data_path, dtype=np.uint8, mode="r")
    if data.size < int(offs[-1]) + ENTRY_HEADER_SIZE + int(ks[-1]):
        return None
    off64 = offs.astype(np.int64)
    tpos = off64[:, None] + np.arange(8, 16, dtype=np.int64)[None, :]
    ts = (
        np.ascontiguousarray(data[tpos].reshape(n, 8))
        .view("<i8")
        .reshape(n)
        .astype(np.int64)
    )
    cols = _Cols(
        data, off64 + ENTRY_HEADER_SIZE, ks.astype(np.uint32), ts
    )
    vlen = (
        fs.astype(np.int64)
        - ENTRY_HEADER_SIZE
        - ks.astype(np.int64)
    )
    return cols, off64, fs.astype(np.int64), vlen


def build_stage(
    memtable_items: Sequence[Tuple[bytes, bytes, int]],
    tables: Sequence,
    device=None,
) -> Optional[ScanStage]:
    """Merge every source into one ScanStage, or None when a guard
    trips (caller falls back to the per-entry scan).  ``device`` is
    stored on the stage: its filter kernels run there (None = the
    card, ``"cpu"`` = their plain versions)."""
    lib = native_mod.load_if_built()
    if lib is None:
        return None

    cols_list: List[_Cols] = []
    off_list: List[np.ndarray] = []
    fsz_list: List[np.ndarray] = []
    vlen_list: List[np.ndarray] = []
    sources: List = []
    for t in tables:
        got = _table_columns(t)
        if got is None:
            return None
        cols, off, fsz, vlen = got
        cols_list.append(cols)
        off_list.append(off)
        fsz_list.append(fsz)
        vlen_list.append(vlen)
        sources.append(_TableSrc(t, cols.data))

    mem = list(memtable_items)
    if mem:
        keys = [k for k, _v, _ts in mem]
        lens = np.array([len(k) for k in keys], dtype=np.uint32)
        moffs = np.zeros(len(keys), dtype=np.int64)
        np.cumsum(lens[:-1], out=moffs[1:])
        blob = np.frombuffer(b"".join(keys), dtype=np.uint8)
        mts = np.array([t for _k, _v, t in mem], dtype=np.int64)
        cols_list.append(_Cols(blob, moffs, lens, mts))
        off_list.append(np.arange(len(mem), dtype=np.int64))
        fsz_list.append(np.zeros(len(mem), dtype=np.int64))
        vlen_list.append(
            np.array([len(v) for _k, v, _ts in mem], dtype=np.int64)
        )
    else:
        z = np.zeros(0, np.int64)
        cols_list.append(
            _Cols(
                np.zeros(0, np.uint8),
                z,
                np.zeros(0, np.uint32),
                z.copy(),
            )
        )
        off_list.append(z.copy())
        fsz_list.append(z.copy())
        vlen_list.append(z.copy())
    sources.append(mem)

    n_total = sum(int(c.key_off.size) for c in cols_list)
    klen_all = np.concatenate(
        [c.key_len.astype(np.int64) for c in cols_list]
    )
    width = int(klen_all.max()) if n_total else 1
    if width > MAX_KEY_WIDTH or n_total * max(1, width) > (
        MAX_MATRIX_BYTES
    ):
        return None

    if n_total == 0:
        z = np.zeros(0, np.int64)
        return ScanStage(
            np.zeros(0, dtype=f"S{max(1, width)}"),
            z,
            z.copy(),
            np.zeros(0, np.uint32),
            z.copy(),
            np.zeros(0, np.int32),
            z.copy(),
            z.copy(),
            sources,
            device,
        )

    # Padded key matrix: one gather per source into (n, width) uint8,
    # viewed as a fixed-width bytes column.
    flat = np.zeros(n_total * width, dtype=np.uint8)
    row0 = 0
    for c in cols_list:
        m = int(c.key_off.size)
        if m:
            lens = c.key_len.astype(np.int64)
            dst = ranges_to_positions(
                (row0 + np.arange(m, dtype=np.int64)) * width, lens
            )
            srcpos = ranges_to_positions(c.key_off, lens)
            flat[dst] = c.data[srcpos]
        row0 += m
    keys_all = flat.view(f"S{width}")

    # NUL-terminated keys alias under the S dtype: fall back.
    last = flat.reshape(n_total, width)[
        np.arange(n_total), klen_all - 1
    ]
    if bool((last == 0).any()):
        return None

    ts_all = np.concatenate([c.ts for c in cols_list])
    h_all = np.concatenate(
        [_batch_hash(lib, c, 0) for c in cols_list]
    )
    src_all = np.concatenate(
        [
            np.full(int(c.key_off.size), i, dtype=np.int32)
            for i, c in enumerate(cols_list)
        ]
    )
    off_all = np.concatenate(off_list)
    fsz_all = np.concatenate(fsz_list)
    vlen_all = np.concatenate(vlen_list)

    # Sort ascending by key with ties newest-first (ts desc), then
    # keep the first row of every equal-key run — the newest-wins
    # merge the quorum read path applies per key, done once for the
    # whole snapshot.
    o1 = np.argsort(-ts_all, kind="stable")
    o2 = np.argsort(keys_all[o1], kind="stable")
    order = o1[o2]
    keys_s = keys_all[order]
    first = np.ones(n_total, dtype=bool)
    first[1:] = keys_s[1:] != keys_s[:-1]
    sel = order[first]
    return ScanStage(
        keys_s[first],
        klen_all[sel],
        ts_all[sel],
        h_all[sel],
        vlen_all[sel],
        src_all[sel],
        off_all[sel],
        fsz_all[sel],
        sources,
        device,
    )
