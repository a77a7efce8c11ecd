"""Vectorized anti-entropy range digests.

A per-entry async scan pays interpreted-Python cost per entry —
multi-second background load per anti-entropy cycle on a big
collection.  This module computes
the SAME per-bucket (count, digest) vectors with numpy + the native
murmur batch: one bulk read per sstable, one batch hash call per seed,
hash-group duplicate resolution, and an XOR scatter — ~20× cheaper
constants, identical results (a copy of dbeel_tpu/storage/
range_digest.py, golden-tested there against the per-entry path).
The scan stage (storage/scan_stage.py) reuses its source columns, the
batch hash and the arc-membership mask.

Semantics (must match the shard's scalar path exactly):
  * every entry in every sstable + both memtables participates;
    tombstones count (deletions must converge);
  * per unique key, the NEWEST timestamp wins;
  * membership/bucket derive from murmur3_32(key) over the wrap range
    [start, end) split into ``nbuckets`` equal slices;
  * digest ^= murmur(key||ts_le8, SEED_A) | murmur(...SEED_B) << 32.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from . import native as native_mod
from .columnar import ranges_to_positions
from .entry import ENTRY_HEADER_SIZE

_SEED_A = 0x0A57E4A1
_SEED_B = 0x51C6E57A
_RING = 1 << 32
_MASK = _RING - 1

# Below this many total entries the executor hop + array setup costs
# more than the per-entry loop; callers should use the async path.
MIN_VECTORIZED_ENTRIES = 2048


@dataclass
class _Cols:
    """One scan source in columnar form: key bytes live in ``data`` at
    ``key_off``/``key_len``; ``ts`` is the entry timestamp."""

    data: np.ndarray  # uint8
    key_off: np.ndarray  # int64
    key_len: np.ndarray  # uint32
    ts: np.ndarray  # int64


def _sstable_cols(table) -> Optional[_Cols]:
    offs, ks, _fs = table.read_index_columns()
    n = offs.size
    if n == 0:
        return _Cols(
            np.zeros(0, np.uint8),
            np.zeros(0, np.int64),
            np.zeros(0, np.uint32),
            np.zeros(0, np.int64),
        )
    # memmap, not fromfile: the digest touches only header+key bytes,
    # so mapping keeps peak RAM at O(keys) instead of holding every
    # value byte of a (possibly ~GB) table in an anonymous buffer;
    # gathers and the native hash read through the OS page cache.
    data = np.memmap(table.data_path, dtype=np.uint8, mode="r")
    if data.size < int(offs[-1]) + ENTRY_HEADER_SIZE + int(ks[-1]):
        return None  # torn file view; let the caller fall back
    off64 = offs.astype(np.int64)
    # Timestamps: 8 LE bytes at offset+8.
    tpos = off64[:, None] + np.arange(8, 16, dtype=np.int64)[None, :]
    ts = (
        np.ascontiguousarray(data[tpos].reshape(n, 8))
        .view("<i8")
        .reshape(n)
        .astype(np.int64)
    )
    return _Cols(
        data, off64 + ENTRY_HEADER_SIZE, ks.astype(np.uint32), ts
    )


def _memtable_cols(items: Sequence[Tuple[bytes, bytes, int]]) -> _Cols:
    if not items:
        return _Cols(
            np.zeros(0, np.uint8),
            np.zeros(0, np.int64),
            np.zeros(0, np.uint32),
            np.zeros(0, np.int64),
        )
    keys = [k for k, _v, _ts in items]
    lens = np.array([len(k) for k in keys], dtype=np.uint32)
    offs = np.zeros(len(keys), dtype=np.int64)
    np.cumsum(lens[:-1], out=offs[1:])
    blob = np.frombuffer(b"".join(keys), dtype=np.uint8)
    ts = np.array([t for _k, _v, t in items], dtype=np.int64)
    return _Cols(blob, offs, lens, ts)


def _batch_hash(lib, cols: _Cols, seed: int) -> np.ndarray:
    out = np.empty(cols.key_off.size, dtype=np.uint32)
    if cols.key_off.size == 0:
        return out
    off_u64 = np.ascontiguousarray(cols.key_off.astype(np.uint64))
    lens = np.ascontiguousarray(cols.key_len)
    data = (
        cols.data
        if cols.data.flags["C_CONTIGUOUS"]
        else np.ascontiguousarray(cols.data)
    )
    lib.dbeel_murmur3_32_batch(
        # argtype is c_char_p: pass the buffer address via cast
        ctypes.cast(
            data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.c_char_p,
        ),
        off_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_uint64(cols.key_off.size),
        ctypes.c_uint32(seed),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return out


def range_members_mask(
    h: np.ndarray, start: int, end: int
) -> np.ndarray:
    """Vectorized _in_ae_range: half-open wrap [start, end); start ==
    end means the whole ring."""
    width = (end - start) & _MASK
    if width == 0:
        return np.ones(h.size, dtype=bool)
    d = (h.astype(np.uint64) - np.uint64(start)) & np.uint64(_MASK)
    return d < np.uint64(width)


def bucket_of(
    h: np.ndarray, start: int, end: int, nbuckets: int
) -> np.ndarray:
    """Vectorized MyShard._ae_bucket_of (same arithmetic, u64-safe:
    d * nbuckets stays < 2^48 for nbuckets <= 65536)."""
    width = (end - start) & _MASK
    if width == 0:
        width = _RING
    d = (h.astype(np.uint64) - np.uint64(start)) & np.uint64(_MASK)
    b = (d * np.uint64(nbuckets)) // np.uint64(width)
    return np.minimum(b, np.uint64(nbuckets - 1)).astype(np.int64)


def vectorized_range_digests(
    memtable_items: Sequence[Tuple[bytes, bytes, int]],
    tables: Sequence,
    start: int,
    end: int,
    nbuckets: int,
) -> Optional[Tuple[list, list]]:
    """Compute the per-bucket (counts, digests) vectors.  Returns None
    when the native murmur batch is unavailable or a table looks torn
    — the caller then uses the per-entry path.  CPU-heavy: run it
    off-loop on a scan snapshot (LSMTree.scan_snapshot)."""
    lib = native_mod.load_if_built()
    if lib is None:
        return None

    sources: List[_Cols] = []
    for t in tables:
        c = _sstable_cols(t)
        if c is None:
            return None
        sources.append(c)
    sources.append(_memtable_cols(memtable_items))

    hashes = [_batch_hash(lib, c, 0) for c in sources]
    n_total = sum(int(x.size) for x in hashes)
    counts = [0] * nbuckets
    digests = [0] * nbuckets
    if n_total == 0:
        return counts, digests

    h_all = np.concatenate(hashes)
    ts_all = np.concatenate([c.ts for c in sources])
    src_all = np.concatenate(
        [
            np.full(x.size, i, dtype=np.int32)
            for i, x in enumerate(hashes)
        ]
    )
    idx_all = np.concatenate(
        [np.arange(x.size, dtype=np.int64) for x in hashes]
    )

    member = range_members_mask(h_all, start, end)
    if not member.any():
        return counts, digests
    h = h_all[member]
    ts = ts_all[member]
    src = src_all[member]
    idx = idx_all[member]

    def key_bytes(s: int, i: int) -> bytes:
        c = sources[s]
        o = int(c.key_off[i])
        return c.data[o : o + int(c.key_len[i])].tobytes()

    # Resolve duplicates per unique KEY.  Sorting by (hash, ~ts) makes
    # every same-key cluster contiguous; singleton hashes (the vast
    # majority) are unique keys outright, and only multi-entry hash
    # groups — real duplicates plus rare 32-bit collisions — pay a
    # per-entry Python resolution.
    order = np.lexsort((-ts, h))
    h = h[order]
    ts = ts[order]
    src = src[order]
    idx = idx[order]
    boundary = np.empty(h.size, dtype=bool)
    boundary[0] = True
    boundary[1:] = h[1:] != h[:-1]
    group_id = np.cumsum(boundary) - 1
    group_sizes = np.bincount(group_id)
    singleton = group_sizes[group_id] == 1

    surv_src: List[int] = []
    surv_idx: List[int] = []
    surv_ts: List[int] = []
    surv_h: List[int] = []
    multi_groups = np.flatnonzero(group_sizes > 1)
    if multi_groups.size:
        starts_g = np.concatenate(
            [[0], np.cumsum(group_sizes)[:-1]]
        )
        for g in multi_groups:
            lo = int(starts_g[g])
            hi = lo + int(group_sizes[g])
            newest: dict = {}
            for j in range(lo, hi):  # already newest-first within h
                kb = key_bytes(int(src[j]), int(idx[j]))
                if kb not in newest:
                    newest[kb] = (int(ts[j]), int(h[j]), int(src[j]),
                                  int(idx[j]))
            for _kb, (t, hv, s, i) in newest.items():
                surv_ts.append(t)
                surv_h.append(hv)
                surv_src.append(s)
                surv_idx.append(i)

    fin_src = np.concatenate(
        [src[singleton], np.array(surv_src, dtype=np.int32)]
    )
    fin_idx = np.concatenate(
        [idx[singleton], np.array(surv_idx, dtype=np.int64)]
    )
    fin_ts = np.concatenate(
        [ts[singleton], np.array(surv_ts, dtype=np.int64)]
    )
    fin_h = np.concatenate(
        [h[singleton], np.array(surv_h, dtype=np.uint32)]
    )
    n = fin_src.size
    if n == 0:
        return counts, digests

    # Build the digest blobs (key || ts_le8) in one gather per source.
    lens = np.empty(n, dtype=np.uint32)
    for s, c in enumerate(sources):
        m = fin_src == s
        if m.any():
            lens[m] = c.key_len[fin_idx[m]]
    blob_lens = lens.astype(np.int64) + 8
    blob_offs = np.zeros(n, dtype=np.int64)
    np.cumsum(blob_lens[:-1], out=blob_offs[1:])
    blob = np.empty(int(blob_lens.sum()), dtype=np.uint8)
    for s, c in enumerate(sources):
        m = np.flatnonzero(fin_src == s)
        if m.size == 0:
            continue
        dst = ranges_to_positions(
            blob_offs[m], lens[m].astype(np.int64)
        )
        srcpos = ranges_to_positions(
            c.key_off[fin_idx[m]], lens[m].astype(np.int64)
        )
        blob[dst] = c.data[srcpos]
    ts_bytes = (
        np.ascontiguousarray(fin_ts.astype("<i8"))
        .view(np.uint8)
        .reshape(n, 8)
    )
    ts_dst = (blob_offs + lens)[:, None] + np.arange(
        8, dtype=np.int64
    )[None, :]
    blob[ts_dst.reshape(-1)] = ts_bytes.reshape(-1)

    bc = _Cols(
        blob, blob_offs, blob_lens.astype(np.uint32), fin_ts
    )
    d_lo = _batch_hash(lib, bc, _SEED_A).astype(np.uint64)
    d_hi = _batch_hash(lib, bc, _SEED_B).astype(np.uint64)
    d64 = d_lo | (d_hi << np.uint64(32))

    buckets = bucket_of(fin_h, start, end, nbuckets)
    cnt = np.bincount(buckets, minlength=nbuckets)
    dig = np.zeros(nbuckets, dtype=np.uint64)
    np.bitwise_xor.at(dig, buckets, d64)
    return (
        [int(x) for x in cnt[:nbuckets]],
        [int(x) for x in dig],
    )
