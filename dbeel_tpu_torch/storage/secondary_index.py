"""Persistent secondary index runs — first-class LSM artifacts
(the port of ``dbeel_tpu/storage/secondary_index.py``, byte for byte
the same run format).

A selective ``scan(filter=)`` on a value field would otherwise scan
every live row server-side: the query compute plane made the *wire*
cheap, but keys-matched/s stays bounded by raw scan bandwidth.  This
module gives each SSTable an optional ``.fidx`` *index run* for the
collection's declared index fields, built INLINE at flush/compaction
time from the writer's still-resident buffers (the single-pass
discipline: zero extra data-byte reads), and
a planner that turns an indexed cmp/prefix/range predicate into a
candidate-row mask so the scan path exact-evaluates only candidates
inside the unchanged ``select_window`` windows — covers, scanned
accounting and results stay byte-identical to the non-indexed path.

Run format (little-endian, self-checking)::

    [u32 magic][u16 version][u16 n_fields]
    per field:
        [u16 name_len][name utf-8]
        [u32 n_num][u32 n_bytes]
        [n_num f64 values, ascending]    [n_num u64 data offsets]
        [n_bytes S16 prefixes, ascending][n_bytes u64 data offsets]
    [u32 crc32 of everything before]

Two lanes per field mirror the golden evaluator's typing rules
(query._leaf_cmp): numeric operands compare only against numeric
values (NUM lane: float64, huge ints clamped to ±inf so one-sided
intervals still cover them; NaN never matches a plannable op and is
dropped), str/bytes operands compare bytewise (BYTES lane: the first
16 value bytes, NUL-padded — numpy 'S' order IS that padded bytewise
order).  Rows whose document lacks the field / holds a bool or
non-scalar live in NEITHER lane: they match no leaf, so excluding
them is sound.  Lane intervals are widened outward (nextafter /
prefix truncation slack), making every candidate set a SUPERSET of
the true matches — the planner re-checks candidates with the golden
``query.match_entry``, so a lossy lane can cost speed, never
correctness.

Crash safety / integrity: runs carry a ``.fidx_sums`` page-CRC
sidecar (checksums.py format, index lane empty), compaction outputs
are written as ``compact_fidx`` and renamed by the same action
journal as the data triplet, and ``SSTable.paths()`` includes the
run so it retires/quarantines in lockstep with its data.  A run that
fails verification is quarantined ALONE (moved aside, error raised
retryably) — the data triplet keeps serving and the retried scan
plans without the run.  A torn run with no valid sidecar demotes to
"absent" (legacy semantics), like a torn ``.sums``.
"""

from __future__ import annotations

import logging
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import query as Q
from ..errors import CorruptedFile
from . import checksums
from .entry import (
    COMPACT_FIDX_FILE_EXT,
    COMPACT_FIDX_SUMS_FILE_EXT,
    ENTRY_HEADER_SIZE,
    FIDX_FILE_EXT,
    FIDX_SUMS_FILE_EXT,
    file_name,
)

log = logging.getLogger(__name__)

_MAGIC = 0x5846_4449  # "IDFX" little-endian tag
_VERSION = 1
_HEADER = struct.Struct("<IHH")
_FIELD_HDR = struct.Struct("<II")  # n_num, n_bytes
_TRAILER = struct.Struct("<I")

# Byte-lane prefix width: 16 bytes covers realistic scalar values
# and keeps a 1M-entry lane at 24 MB; longer values fall back to
# prefix-interval candidates plus the exact re-check.
PREFIX_WIDTH = 16

# Numeric values beyond float64's finite range clamp to ±inf so
# one-sided intervals still capture them (float() would raise).
_F64_HUGE = 8.98846567431158e307 * 2  # ~max float64

# Planner decision rule: when more than this fraction of staged rows
# are candidates, a full vectorized evaluation is cheaper than
# per-candidate golden re-checks — decline (planner miss).
MAX_CANDIDATE_FRACTION = 0.25

# Bound per-field lane cardinality per run: a run is per-SSTable, so
# this is a sanity ceiling against a corrupt header, not a policy.
_MAX_LANE = 1 << 28


class IndexStats:
    """Process-wide secondary-index accounting (``get_stats.index``):
    build/merge emission, planner outcomes, and the quarantine
    counter the corruption tests assert on."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.runs_built = 0
        self.runs_merged = 0
        self.entries_indexed = 0
        self.bytes_written = 0
        self.planner_hits = 0
        self.planner_misses = 0
        self.intervals_emitted = 0
        self.runs_quarantined = 0

    def note_emit(
        self, compact: bool, entries: int, nbytes: int
    ) -> None:
        with self._lock:
            if compact:
                self.runs_merged += 1
            else:
                self.runs_built += 1
            self.entries_indexed += int(entries)
            self.bytes_written += int(nbytes)

    def note_plan(self, hit: bool, intervals: int = 0) -> None:
        with self._lock:
            if hit:
                self.planner_hits += 1
            else:
                self.planner_misses += 1
            self.intervals_emitted += int(intervals)

    def note_quarantine(self) -> None:
        with self._lock:
            self.runs_quarantined += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "runs_built": self.runs_built,
                "runs_merged": self.runs_merged,
                "entries_indexed": self.entries_indexed,
                "bytes_written": self.bytes_written,
                "planner_hits": self.planner_hits,
                "planner_misses": self.planner_misses,
                "intervals_emitted": self.intervals_emitted,
                "runs_quarantined": self.runs_quarantined,
            }


index_stats = IndexStats()


def sanitize_index_fields(raw) -> Optional[List[str]]:
    """Normalize a DDL/metadata/gossip index declaration into a
    sorted, deduplicated field-name list, or None (no indexes).
    Silently drops junk entries instead of erroring: declarations
    ride gossip frames from peers of any version."""
    if not isinstance(raw, (list, tuple)):
        return None
    out = []
    for f in raw:
        if isinstance(f, bytes):
            try:
                f = f.decode("utf-8")
            except UnicodeDecodeError:
                continue
        if (
            isinstance(f, str)
            and f
            and f != Q.KEY_FIELD
            and len(f) <= 256
        ):
            out.append(f)
    out = sorted(set(out))
    return out[:16] or None


# ---------------------------------------------------------------------
# Extraction + serialization (runs off-loop in flush/merge workers)
# ---------------------------------------------------------------------


def _pad_prefix(b: bytes) -> bytes:
    return b[:PREFIX_WIDTH].ljust(PREFIX_WIDTH, b"\x00")


def build_run_blob(
    fields: Sequence[str],
    rows: Sequence[Tuple[int, bytes]],
) -> Tuple[bytes, int]:
    """Serialize one index run from ``(data_offset, value_bytes)``
    rows (tombstones may be included; they are skipped).  The rows
    come from RAM-resident flush/merge buffers — this function never
    reads a data file.  Returns (blob, entries_indexed)."""
    per_field: Dict[str, tuple] = {
        f: ([], [], [], []) for f in fields
    }
    entries = 0
    for off, value in rows:
        if not value:
            continue  # tombstone: matches nothing
        doc = Q.decode_doc(value)
        if doc is None:
            continue
        for f in fields:
            x = Q.field_value(doc, f)
            if x is None:
                continue
            nv, no, bv, bo = per_field[f]
            if isinstance(x, (int, float)):
                try:
                    xf = float(x)
                except OverflowError:
                    xf = (
                        float("inf") if x > 0 else float("-inf")
                    )
                if xf != xf:  # NaN: matches no plannable op
                    continue
                if xf > _F64_HUGE:
                    xf = float("inf")
                elif xf < -_F64_HUGE:
                    xf = float("-inf")
                nv.append(xf)
                no.append(off)
            else:
                xb = (
                    x.encode("utf-8")
                    if isinstance(x, str)
                    else x
                )
                bv.append(_pad_prefix(xb))
                bo.append(off)
            entries += 1
    parts = [_HEADER.pack(_MAGIC, _VERSION, len(fields))]
    for f in fields:
        nv, no, bv, bo = per_field[f]
        name = f.encode("utf-8")
        parts.append(struct.pack("<H", len(name)))
        parts.append(name)
        parts.append(_FIELD_HDR.pack(len(nv), len(bv)))
        if nv:
            va = np.asarray(nv, dtype="<f8")
            oa = np.asarray(no, dtype="<u8")
            order = np.argsort(va, kind="stable")
            parts.append(va[order].tobytes())
            parts.append(oa[order].tobytes())
        if bv:
            va = np.array(bv, dtype=f"S{PREFIX_WIDTH}")
            oa = np.asarray(bo, dtype="<u8")
            order = np.argsort(va, kind="stable")
            parts.append(va[order].tobytes())
            parts.append(oa[order].tobytes())
    body = b"".join(parts)
    return body + _TRAILER.pack(zlib.crc32(body)), entries


def run_paths(
    dir_path: str, index: int, compact: bool = False
) -> Tuple[str, str]:
    """(run path, sidecar path) for a table index."""
    if compact:
        exts = (COMPACT_FIDX_FILE_EXT, COMPACT_FIDX_SUMS_FILE_EXT)
    else:
        exts = (FIDX_FILE_EXT, FIDX_SUMS_FILE_EXT)
    return (
        os.path.join(dir_path, file_name(index, exts[0])),
        os.path.join(dir_path, file_name(index, exts[1])),
    )


def emit_run(
    dir_path: str,
    index: int,
    fields: Sequence[str],
    rows: Sequence[Tuple[int, bytes]],
    compact: bool,
) -> int:
    """Build + write one index run and its CRC sidecar next to the
    (compact_) triplet at ``index``.  Returns bytes written.  Called
    from flush/merge workers with the output rows still in RAM —
    the single-pass contract: the sidecar CRCs are computed from the
    resident blob, never from a re-read."""
    blob, entries = build_run_blob(fields, rows)
    path, _sums = run_paths(dir_path, index, compact)
    with open(path, "wb") as f:
        f.write(blob)
    checksums.write(
        dir_path,
        index,
        checksums.page_crcs(blob),
        [],
        len(blob),
        None,
        ext=(
            COMPACT_FIDX_SUMS_FILE_EXT
            if compact
            else FIDX_SUMS_FILE_EXT
        ),
    )
    index_stats.note_emit(compact, entries, len(blob))
    return len(blob)


def rows_from_items(items) -> List[Tuple[int, bytes]]:
    """(offset, value) rows for the flush path from sorted memtable
    ``items`` ([(key, (value, ts)), ...]) — offsets are the running
    data-record offsets the EntryWriter/native writer produce for the
    same order, so no file is read back."""
    rows: List[Tuple[int, bytes]] = []
    off = 0
    for key, (value, _ts) in items:
        rows.append((off, value))
        off += 16 + len(key) + len(value)
    return rows


def rows_from_blob(data, records, n: int):
    """(offset, value) rows for a compaction output still resident in
    RAM: ``data`` holds the data file's bytes and ``records`` its first
    ``n`` index records (fields offset, key_size, full_size), so no
    file is read back."""
    view = memoryview(data)
    offs = records["offset"][:n].tolist()
    kss = records["key_size"][:n].tolist()
    fss = records["full_size"][:n].tolist()
    return (
        (off, bytes(view[off + ENTRY_HEADER_SIZE + ks : off + fs]))
        for off, ks, fs in zip(offs, kss, fss)
    )


# ---------------------------------------------------------------------
# Load + verify
# ---------------------------------------------------------------------


class IndexRun:
    """Parsed run: per field, the two sorted lanes + parallel data
    offsets."""

    __slots__ = ("fields",)

    def __init__(self, fields: dict) -> None:
        # {name: (num_vals f64, num_offs u64, byte_vals S16,
        #         byte_offs u64)}
        self.fields = fields


def _parse_run(blob: bytes, path: str) -> IndexRun:
    if len(blob) < _HEADER.size + _TRAILER.size:
        raise ValueError("fidx too short")
    (crc,) = _TRAILER.unpack_from(blob, len(blob) - 4)
    if zlib.crc32(blob[:-4]) != crc:
        raise ValueError("fidx failed its own checksum")
    magic, version, n_fields = _HEADER.unpack_from(blob, 0)
    if magic != _MAGIC:
        raise ValueError("bad fidx magic")
    if version != _VERSION:
        raise ValueError(f"unknown fidx version {version}")
    off = _HEADER.size
    end = len(blob) - 4
    fields: dict = {}
    for _ in range(n_fields):
        if off + 2 > end:
            raise ValueError("fidx truncated in field header")
        (nlen,) = struct.unpack_from("<H", blob, off)
        off += 2
        name = blob[off : off + nlen].decode("utf-8")
        off += nlen
        if off + _FIELD_HDR.size > end:
            raise ValueError("fidx truncated in lane counts")
        n_num, n_bytes = _FIELD_HDR.unpack_from(blob, off)
        off += _FIELD_HDR.size
        if n_num > _MAX_LANE or n_bytes > _MAX_LANE:
            raise ValueError("fidx lane count implausible")
        need = n_num * 16 + n_bytes * (PREFIX_WIDTH + 8)
        if off + need > end:
            raise ValueError("fidx truncated in lanes")
        nv = np.frombuffer(blob, dtype="<f8", count=n_num, offset=off)
        off += n_num * 8
        no = np.frombuffer(blob, dtype="<u8", count=n_num, offset=off)
        off += n_num * 8
        bv = np.frombuffer(
            blob, dtype=f"S{PREFIX_WIDTH}", count=n_bytes, offset=off
        )
        off += n_bytes * PREFIX_WIDTH
        bo = np.frombuffer(blob, dtype="<u8", count=n_bytes, offset=off)
        off += n_bytes * 8
        fields[name] = (nv, no, bv, bo)
    if off != end:
        raise ValueError("fidx trailing garbage")
    return IndexRun(fields)


def load_run(dir_path: str, index: int) -> Optional[IndexRun]:
    """Load + verify one table's index run.  Returns None when no
    run exists or a torn write demoted it (no valid sidecar AND a
    failed self-check); raises CorruptedFile (``.path`` stamped on
    the run file) when the run is present but PROVABLY corrupt — a
    valid sidecar disagrees with the bytes, or the sidecar validates
    while the body's trailer doesn't."""
    path, _sums_p = run_paths(dir_path, index)
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    sums = checksums.load(dir_path, index, FIDX_SUMS_FILE_EXT)
    verified = False
    if sums is not None and checksums.verification_enabled():
        got = checksums.page_crcs(blob)
        ok = len(blob) == sums.data_size and len(got) == len(
            sums.data_crcs
        ) and all(g == e for g, e in zip(got, sums.data_crcs))
        if not ok:
            exc = CorruptedFile(
                f"{path}: index run failed sidecar CRC verification"
            )
            exc.path = path
            raise exc
        verified = True
    try:
        return _parse_run(blob, path)
    except ValueError as e:
        if verified:
            # The bytes match their sidecar yet don't parse: the
            # run was written corrupt — same containment as a body
            # CRC failure.
            exc = CorruptedFile(f"{path}: {e}")
            exc.path = path
            raise exc from e
        # Torn write (crash between run and sidecar): demote to
        # absent, like a torn .sums — never an error.
        log.warning("ignoring torn index run %s: %s", path, e)
        return None


# ---------------------------------------------------------------------
# Planner: predicate tree -> candidate row mask over a ScanStage
# ---------------------------------------------------------------------


def _num_interval(lane: np.ndarray, lo, hi) -> Tuple[int, int]:
    """[i0, i1) slice of the sorted NUM lane covering every value in
    the CLOSED interval [lo, hi] (None = open end), pre-widened by
    one ulp each side so float64 rounding of stored ints can never
    exclude a true match."""
    i0 = 0
    i1 = lane.size
    if lo is not None:
        i0 = int(
            np.searchsorted(
                lane, np.nextafter(lo, -np.inf), side="left"
            )
        )
    if hi is not None:
        i1 = int(
            np.searchsorted(
                lane, np.nextafter(hi, np.inf), side="right"
            )
        )
    return i0, max(i0, i1)


def _bytes_interval(
    lane: np.ndarray, lo: Optional[bytes], hi: Optional[bytes]
) -> Tuple[int, int]:
    """[i0, i1) slice of the sorted BYTES lane covering every stored
    prefix in the CLOSED padded interval [lo, hi] (None = open
    end)."""
    i0 = 0
    i1 = lane.size
    if lo is not None:
        i0 = int(np.searchsorted(lane, lo, side="left"))
    if hi is not None:
        i1 = int(np.searchsorted(lane, hi, side="right"))
    return i0, max(i0, i1)


def _leaf_lane_offsets(run_field, node):
    """Candidate data offsets (unsorted u64 arrays) in one run for
    one plannable leaf, or None when the leaf cannot be narrowed
    (the caller treats every row of that source as a candidate).
    Returns (list_of_offset_arrays, intervals_count)."""
    nv, no, bv, bo = run_field
    kind = node[0]
    if kind == "cmp":
        op, operand = node[2], node[3]
        if op == "!=":
            return None
        if isinstance(operand, (int, float)):
            try:
                vf = float(operand)
            except OverflowError:
                return None
            if vf != vf:
                return [], 0  # NaN operand matches nothing
            if op == "==":
                i0, i1 = _num_interval(nv, vf, vf)
            elif op in ("<", "<="):
                i0, i1 = _num_interval(nv, None, vf)
            else:  # > >=
                i0, i1 = _num_interval(nv, vf, None)
            return [no[i0:i1]], 1
        xb = (
            operand.encode("utf-8")
            if isinstance(operand, str)
            else bytes(operand)
        )
        p = _pad_prefix(xb)
        if op == "==":
            i0, i1 = _bytes_interval(bv, p, p)
        elif op in ("<", "<="):
            i0, i1 = _bytes_interval(bv, None, p)
        else:
            i0, i1 = _bytes_interval(bv, p, None)
        return [bo[i0:i1]], 1
    if kind == "prefix":
        p = node[2]
        if len(p) > PREFIX_WIDTH:
            q = _pad_prefix(p)
            i0, i1 = _bytes_interval(bv, q, q)
            return [bo[i0:i1]], 1
        lo = _pad_prefix(p)
        upper = Q.increment_prefix(p)
        if upper is None:
            i0, i1 = _bytes_interval(bv, lo, None)
        else:
            i0 = int(np.searchsorted(bv, lo, side="left"))
            i1 = int(
                np.searchsorted(bv, _pad_prefix(upper), side="left")
            )
            i1 = max(i0, i1)
        return [bo[i0:i1]], 1
    if kind == "range":
        lo, hi = node[2], node[3]
        if lo is None and hi is None:
            # Matches any scalar-typed value: both full lanes.
            return [no, bo], 2
        if isinstance(lo, (int, float)) or isinstance(
            hi, (int, float)
        ):
            try:
                i0, i1 = _num_interval(
                    nv,
                    float(lo) if lo is not None else None,
                    float(hi) if hi is not None else None,
                )
            except OverflowError:
                return None
            return [no[i0:i1]], 1
        i0, i1 = _bytes_interval(
            bv,
            _pad_prefix(lo) if lo is not None else None,
            _pad_prefix(hi) if hi is not None else None,
        )
        return [bo[i0:i1]], 1
    return None


class _PlanCtx:
    __slots__ = ("intervals", "narrowed")

    def __init__(self) -> None:
        self.intervals = 0
        self.narrowed = False


def _leaf_mask(stage, node, runs_by_src, index_fields, ctx):
    """Candidate mask for one leaf, or None (no narrowing: the leaf
    is on $key / an unindexed field / an unplannable op — every row
    remains a candidate, which is always a sound superset)."""
    field = node[1]
    if field == Q.KEY_FIELD or field not in index_fields:
        return None
    mask = np.zeros(stage.n, dtype=bool)
    any_narrow = False
    for s, source in enumerate(stage.sources):
        rows = np.flatnonzero(stage.src == np.int32(s))
        if rows.size == 0:
            continue
        if isinstance(source, list):
            mask[rows] = True  # memtable rows: no run, exact-check
            continue
        run = runs_by_src.get(s)
        rf = run.fields.get(field) if run is not None else None
        if rf is None:
            mask[rows] = True  # no run / field absent from run
            continue
        got = _leaf_lane_offsets(rf, node)
        if got is None:
            mask[rows] = True
            continue
        lanes, n_iv = got
        ctx.intervals += n_iv
        any_narrow = True
        for offs in lanes:
            if offs.size == 0:
                continue
            cand = np.sort(offs)
            o = stage.off[rows].astype(np.uint64)
            j = np.searchsorted(cand, o)
            j = np.minimum(j, cand.size - 1)
            hit = cand[j] == o
            mask[rows[hit]] = True
    if not any_narrow:
        return None
    ctx.narrowed = True
    return mask


def _tree_mask(stage, where, runs_by_src, index_fields, ctx):
    kind = where[0]
    if kind == "and":
        m = None
        for c in where[1:]:
            cm = _tree_mask(
                stage, c, runs_by_src, index_fields, ctx
            )
            if cm is not None:
                m = cm if m is None else (m & cm)
        return m
    if kind == "or":
        m = None
        for c in where[1:]:
            cm = _tree_mask(
                stage, c, runs_by_src, index_fields, ctx
            )
            if cm is None:
                return None  # one unnarrowed branch floods the or
            m = cm.copy() if m is None else (m | cm)
        return m
    return _leaf_mask(stage, where, runs_by_src, index_fields, ctx)


def candidate_mask(
    stage, where, runs_by_src: dict, index_fields: Sequence[str]
):
    """Superset candidate mask over ``stage`` rows for ``where``,
    or None when the indexes cannot narrow the predicate (planner
    miss).  ``runs_by_src`` maps stage source position -> IndexRun
    (missing/None entries mean "no usable run": their rows stay
    candidates).  Every returned candidate set is a superset of the
    true matches — the caller must exact-evaluate candidates with
    query.match_entry."""
    if where is None or not index_fields:
        index_stats.note_plan(False)
        return None
    ctx = _PlanCtx()
    mask = _tree_mask(stage, where, runs_by_src, index_fields, ctx)
    if mask is None or not ctx.narrowed:
        index_stats.note_plan(False)
        return None
    frac = float(mask.mean()) if stage.n else 1.0
    if frac > MAX_CANDIDATE_FRACTION:
        index_stats.note_plan(False, ctx.intervals)
        return None
    index_stats.note_plan(True, ctx.intervals)
    return mask
