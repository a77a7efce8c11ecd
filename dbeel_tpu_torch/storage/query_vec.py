"""Vectorized filter/aggregate evaluation over ScanStage columns
(query compute plane; a copy of dbeel_tpu/storage/query_vec.py whose
numeric leaves run on the card).

``query.py`` defines the spec grammar and the golden per-entry
evaluator; this module evaluates the SAME semantics columnar over a
staged snapshot:

* ``field_column(stage, name)`` — batched decode of one value field
  into fixed-width columns (int64 + float64 numeric lanes, an
  ``S{w}`` byte lane), built lazily and cached on the stage exactly
  like the key matrix.  Value bytes read through the stage's lazy
  per-page CRC verify (``_TableSrc.value_at``) — the column build is
  the ONLY place a filtered scan touches non-matching values, once
  per stage, and corruption surfaces as the usual quarantine +
  retryable error.
* ``eval_where(stage, where)`` — numpy mask evaluation of the
  predicate tree: key leaves become searchsorted index intervals
  (the key matrix is sorted), field leaves become elementwise lane
  comparisons, AND/OR become logical reductions.  A tiny ``fix`` row
  set (ints beyond 2^53, byte values that the S dtype would alias)
  is re-evaluated through the golden scalar path, so the combined
  mask is byte-identical to the golden walk on EVERY input, not just
  typical ones.  Numeric float64 leaves of ``MIN_DEVICE_ROWS`` rows
  or more run on the filter kernels (ops/query_kernels.py, K8a/K8b)
  on the stage's ``device`` — the card unless it is ``cpu``, which
  runs their plain versions; there is no gate and no fallback.
* ``agg_partial_for(stage, positions, agg)`` — columnar aggregate
  reduction over accepted rows only: exact int-lane sums, exact
  Shewchuk float partials, first-achiever min/max, group-by-key-
  prefix folding.  Never materializes a value byte.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

import numpy as np

from .. import query as Q
from ..ops import query_kernels
from ..utils import msgpack_codec
from .entry import ENTRY_HEADER_SIZE

# Byte values wider than this leave the S lane (scalar fix-up): an
# unbounded padded matrix over a blob-ish field would be an
# allocation lever.
FIELD_WIDTH_CAP = 256

# Per-stage cache caps: the mask key includes predicate OPERANDS, so
# a client sweeping operand values (or field names) must not be able
# to pin one n-byte mask (or one whole decoded column) per distinct
# spec for the stage lifetime — an allocation lever on the
# network-facing port.  Clear-on-overflow like the peer-spec cache:
# the evaluator just rebuilds (cheap for masks; a column rebuild
# costs one decode pass, paid by the sweeping client's own scan).
MAX_CACHED_MASKS = 32
MAX_CACHED_FIELD_COLS = 8

_F53 = 1 << 53


class FieldCol:
    """One decoded value field in columnar lanes."""

    __slots__ = (
        "is_int",
        "is_float",
        "is_num",
        "is_bytes",
        "i64",
        "f64",
        "bval",
        "width",
        "fix",
        "fixvals",
        "valid",
    )

    def __init__(self, n: int, width: int) -> None:
        self.is_int = np.zeros(n, dtype=bool)
        self.is_float = np.zeros(n, dtype=bool)
        self.is_num = np.zeros(n, dtype=bool)
        self.is_bytes = np.zeros(n, dtype=bool)
        self.i64 = np.zeros(n, dtype=np.int64)
        self.f64 = np.zeros(n, dtype=np.float64)
        self.width = width
        self.bval = np.zeros(n, dtype=f"S{max(1, width)}")
        self.fix = np.zeros(n, dtype=bool)
        self.fixvals: dict = {}
        self.valid = np.zeros(n, dtype=bool)

    def typed_at(self, p: int) -> Any:
        """The exact typed value at row p (None = no comparable
        value) — the same value the golden evaluator would see."""
        if self.is_int[p]:
            return int(self.i64[p])
        if self.is_float[p]:
            return float(self.f64[p])
        if self.fix[p]:
            return self.fixvals.get(int(p))
        if self.is_bytes[p]:
            return bytes(self.bval[p])
        return None


def _value_bytes(stage, p: int) -> bytes:
    src = stage.sources[int(stage.src[p])]
    if isinstance(src, list):  # memtable items
        return src[int(stage.off[p])][1]
    return src.value_at(
        int(stage.off[p])
        + ENTRY_HEADER_SIZE
        + int(stage.klen[p]),
        int(stage.vlen[p]),
    )


def field_column(stage, name: str) -> FieldCol:
    """The cached column for one value field, building it on first
    use (one per-entry decode pass per stage lifetime — every later
    page and every later chunk of the scan reuses it)."""
    col = stage._field_cols.get(name)
    if col is not None:
        return col
    n = stage.n
    vlen = stage.vlen
    typed: List[Tuple[int, Any]] = []
    width = 1
    for p in range(n):
        if vlen[p] == 0:
            continue  # tombstones match nothing
        x = Q.field_value(
            Q.decode_doc(_value_bytes(stage, p)), name
        )
        if x is None:
            continue
        if isinstance(x, (str, bytes)):
            b = x.encode("utf-8") if isinstance(x, str) else x
            typed.append((p, ("b", b)))
            if len(b) <= FIELD_WIDTH_CAP:
                width = max(width, len(b))
        else:
            typed.append((p, ("n", x)))
    col = FieldCol(n, width)
    for p, (kind, x) in typed:
        col.valid[p] = True
        if kind == "n":
            if isinstance(x, int):
                if abs(x) > _F53:
                    # Beyond exact float64: the vector lanes would
                    # round — golden scalar owns these rows.
                    col.fix[p] = True
                    col.fixvals[p] = x
                else:
                    col.is_int[p] = True
                    col.is_num[p] = True
                    col.i64[p] = x
                    col.f64[p] = x
            else:
                col.is_float[p] = True
                col.is_num[p] = True
                col.f64[p] = x
        else:
            if len(x) > FIELD_WIDTH_CAP or x.endswith(b"\x00"):
                # Wider than the padded lane, or trailing-NUL (the
                # S dtype strips those, aliasing two values).
                col.fix[p] = True
                col.fixvals[p] = x
            else:
                col.is_bytes[p] = True
                col.bval[p] = x
    if len(stage._field_cols) >= MAX_CACHED_FIELD_COLS:
        stage._field_cols.clear()
    stage._field_cols[name] = col
    return col


# ---------------------------------------------------------------------
# Key leaves: index intervals over the sorted key matrix
# ---------------------------------------------------------------------


def _key_cuts(stage, b: bytes) -> Tuple[int, int]:
    """(first index >= b, first index > b) with exact semantics for
    operands wider than the column (stored keys are all <= width and
    never NUL-terminated, so a stored key exceeds a longer operand
    iff it exceeds its width-byte prefix; equality is impossible)."""
    keys = stage.keys
    width = keys.dtype.itemsize
    if len(b) <= width:
        lo = int(np.searchsorted(keys, b, side="left"))
        hi = int(np.searchsorted(keys, b, side="right"))
        return lo, hi
    t = int(np.searchsorted(keys, b[:width], side="right"))
    return t, t


def _key_leaf_mask(stage, node: list) -> np.ndarray:
    n = stage.n
    mask = np.zeros(n, dtype=bool)
    kind = node[0]
    if kind == "cmp":
        op, b = node[2], node[3]
        ge, gt = _key_cuts(stage, b)
        if op == "==":
            mask[ge:gt] = True
        elif op == "!=":
            mask[:] = True
            mask[ge:gt] = False
        elif op == "<":
            mask[:ge] = True
        elif op == "<=":
            mask[:gt] = True
        elif op == ">":
            mask[gt:] = True
        else:  # >=
            mask[ge:] = True
        return mask
    if kind == "prefix":
        p = node[2]
        width = stage.keys.dtype.itemsize
        if len(p) > width:
            return mask
        lo, _ = _key_cuts(stage, p)
        upper = Q.increment_prefix(p)
        hi = n if upper is None else _key_cuts(stage, upper)[0]
        mask[lo:hi] = True
        return mask
    # range: lo <= key < hi
    lo_b, hi_b = node[2], node[3]
    lo = 0 if lo_b is None else _key_cuts(stage, lo_b)[0]
    hi = n if hi_b is None else _key_cuts(stage, hi_b)[0]
    mask[lo:hi] = True
    return mask


# ---------------------------------------------------------------------
# Field leaves: elementwise lane comparisons
# ---------------------------------------------------------------------

_NP_CMP = {
    "==": np.equal,
    "!=": np.not_equal,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
}


def _scalar_overlay(
    mask: np.ndarray, col: FieldCol, node: list
) -> None:
    """Re-evaluate the fix rows through the golden scalar leaf and
    overwrite their mask bits (the vector lanes never saw them)."""
    if not col.fixvals:
        return
    for p, x in col.fixvals.items():
        kind = node[0]
        if kind == "cmp":
            mask[p] = Q._leaf_cmp(x, node[2], node[3])
        elif kind == "prefix":
            mask[p] = isinstance(x, bytes) and x.startswith(
                node[2]
            )
        else:  # range
            mask[p] = _scalar_range(x, node[2], node[3])


def _scalar_range(x: Any, lo: Any, hi: Any) -> bool:
    num_bounds = isinstance(lo, (int, float)) or isinstance(
        hi, (int, float)
    )
    if isinstance(x, (int, float)) != num_bounds and not (
        lo is None and hi is None
    ):
        return False
    if lo is not None and not (lo <= x):
        return False
    if hi is not None and not (x < hi):
        return False
    return True


def _bytes_scalar_leaf(
    col: FieldCol, node: list
) -> np.ndarray:
    """Byte-lane leaf evaluated per row (operand shapes the S lane
    cannot compare exactly: trailing-NUL or wider-than-lane
    operands).  Bounded by the byte-lane population."""
    n = col.is_bytes.size
    mask = np.zeros(n, dtype=bool)
    rows = np.flatnonzero(col.is_bytes)
    vals = col.bval[rows].tolist()
    kind = node[0]
    for r, v in zip(rows.tolist(), vals):
        if kind == "cmp":
            mask[r] = Q._leaf_cmp(v, node[2], node[3])
        elif kind == "prefix":
            mask[r] = v.startswith(node[2])
        else:
            mask[r] = _scalar_range(v, node[2], node[3])
    return mask


def _num_cmp_mask(
    col: FieldCol, op: str, operand, counters: dict, device
) -> np.ndarray:
    if isinstance(operand, int) and abs(operand) > _F53:
        # Operand beyond exact float64: scalar over the numeric
        # lanes (int rows compare exactly in Python).
        n = col.is_num.size
        mask = np.zeros(n, dtype=bool)
        rows = np.flatnonzero(col.is_num)
        for r in rows.tolist():
            x = (
                int(col.i64[r])
                if col.is_int[r]
                else float(col.f64[r])
            )
            mask[r] = Q._leaf_cmp(x, op, operand)
        return mask
    dev = query_kernels.eval_cmp_f64(
        col.f64, col.is_num, float(operand), op, device
    )
    if dev is not None:
        counters["device"] += 1
        return dev
    counters["host"] += 1
    return _NP_CMP[op](col.f64, float(operand)) & col.is_num


def _field_leaf_mask(
    stage, node: list, counters: dict
) -> np.ndarray:
    col = field_column(stage, node[1])
    kind = node[0]
    if kind == "cmp":
        operand = node[3]
        if isinstance(operand, (int, float)):
            mask = _num_cmp_mask(
                col, node[2], operand, counters, stage.device
            )
        else:
            nb = (
                operand.encode("utf-8")
                if isinstance(operand, str)
                else operand
            )
            if len(nb) > col.width or nb.endswith(b"\x00"):
                mask = _bytes_scalar_leaf(
                    col, ["cmp", node[1], node[2], nb]
                )
            else:
                counters["host"] += 1
                mask = (
                    _NP_CMP[node[2]](col.bval, nb) & col.is_bytes
                )
        _scalar_overlay(mask, col, node)
        return mask
    if kind == "prefix":
        p = node[2]
        if len(p) > col.width or p.endswith(b"\x00"):
            mask = _bytes_scalar_leaf(col, node)
        elif len(p) == 0:
            mask = col.is_bytes.copy()
        else:
            counters["host"] += 1
            upper = Q.increment_prefix(p)
            mask = (col.bval >= p) & col.is_bytes
            if upper is not None:
                mask &= col.bval < upper
        _scalar_overlay(mask, col, node)
        return mask
    # range
    lo, hi = node[2], node[3]
    if lo is None and hi is None:
        mask = col.valid.copy()
        return mask
    if isinstance(lo, (int, float)) or isinstance(
        hi, (int, float)
    ):
        big = (
            isinstance(lo, int) and abs(lo) > _F53
        ) or (isinstance(hi, int) and abs(hi) > _F53)
        dev = (
            None
            if big
            else query_kernels.eval_range_f64(
                col.f64,
                col.is_num,
                None if lo is None else float(lo),
                None if hi is None else float(hi),
                stage.device,
            )
        )
        if dev is not None:
            counters["device"] += 1
            mask = dev
        elif big:
            n = col.is_num.size
            mask = np.zeros(n, dtype=bool)
            for r in np.flatnonzero(col.is_num).tolist():
                x = (
                    int(col.i64[r])
                    if col.is_int[r]
                    else float(col.f64[r])
                )
                mask[r] = _scalar_range(x, lo, hi)
        else:
            counters["host"] += 1
            mask = col.is_num.copy()
            if lo is not None:
                mask &= col.f64 >= float(lo)
            if hi is not None:
                mask &= col.f64 < float(hi)
    else:
        bad = (
            lo is not None
            and (len(lo) > col.width or lo.endswith(b"\x00"))
        ) or (
            hi is not None
            and (len(hi) > col.width or hi.endswith(b"\x00"))
        )
        if bad:
            mask = _bytes_scalar_leaf(col, node)
        else:
            counters["host"] += 1
            mask = col.is_bytes.copy()
            if lo is not None:
                mask &= col.bval >= lo
            if hi is not None:
                mask &= col.bval < hi
    _scalar_overlay(mask, col, node)
    return mask


def _eval_node(stage, node: list, counters: dict) -> np.ndarray:
    kind = node[0]
    if kind == "and":
        return np.logical_and.reduce(
            [_eval_node(stage, c, counters) for c in node[1:]]
        )
    if kind == "or":
        return np.logical_or.reduce(
            [_eval_node(stage, c, counters) for c in node[1:]]
        )
    if node[1] == Q.KEY_FIELD:
        counters["host"] += 1
        return _key_leaf_mask(stage, node)
    return _field_leaf_mask(stage, node, counters)


def eval_where(
    stage, where: Optional[list]
) -> Tuple[np.ndarray, str]:
    """(match mask over the whole stage, eval path) — the mask is
    cached on the stage keyed by the packed tree, so every page and
    every chunk of a multi-chunk scan reuses one evaluation.  Path:
    "cached" | "device" (>=1 leaf ran a K8 entry: the kernel, or with
    device "cpu" its plain version) | "numpy".
    Tombstone rows are always False (suppressors, not matches)."""
    if where is None:
        return stage.vlen != 0, "numpy"
    key = msgpack_codec.packb(where)
    cached = stage._mask_cache.get(key)
    if cached is not None:
        return cached, "cached"
    counters = {"device": 0, "host": 0}
    mask = _eval_node(stage, where, counters)
    mask = mask & (stage.vlen != 0)
    if len(stage._mask_cache) >= MAX_CACHED_MASKS:
        stage._mask_cache.clear()
    stage._mask_cache[key] = mask
    return mask, ("device" if counters["device"] else "numpy")


# ---------------------------------------------------------------------
# Columnar aggregate reduction (exact; accepted rows only)
# ---------------------------------------------------------------------


def _exact_int_sum(arr: np.ndarray) -> int:
    """Exact sum of an int64 column (int64 accumulation when it
    provably cannot wrap, Python fold otherwise)."""
    if arr.size == 0:
        return 0
    m = int(np.abs(arr).max())
    if m and arr.size > (1 << 62) // m:
        return sum(int(v) for v in arr.tolist())
    return int(arr.sum())


def _first_pos(rows: np.ndarray, cond: np.ndarray) -> int:
    return int(rows[np.flatnonzero(cond)[0]])


def _lane_extreme(
    col: FieldCol, pos: np.ndarray, want_min: bool
) -> Optional[Tuple[Any, int]]:
    """(value, first achieving position) of the numeric-lane extreme
    over ``pos``, preserving the golden first-on-tie and NaN
    semantics.  None when no numeric rows."""
    ipos = pos[col.is_int[pos]]
    fpos = pos[col.is_float[pos]]
    xpos = [
        p for p in pos.tolist() if col.fix[p]
        and isinstance(col.fixvals.get(p), int)
    ]
    farr = col.f64[fpos]
    if farr.size and bool(np.isnan(farr).any()):
        # NaN poisons ordered folds in golden (strict-< never
        # replaces it): replicate sequentially.
        best = None
        bp = -1
        for p in sorted(
            ipos.tolist() + fpos.tolist() + xpos
        ):
            x = col.typed_at(p)
            if best is None:
                best, bp = x, p
            elif (x < best) if want_min else (x > best):
                best, bp = x, p
        return None if best is None else (best, bp)
    cands: List[Tuple[Any, int]] = []
    if ipos.size:
        arr = col.i64[ipos]
        v = int(arr.min() if want_min else arr.max())
        cands.append((v, _first_pos(ipos, arr == v)))
    if fpos.size:
        v = float(farr.min() if want_min else farr.max())
        cands.append((float(v), _first_pos(fpos, farr == v)))
    for p in xpos:
        cands.append((col.fixvals[p], p))
    if not cands:
        return None
    best, bp = cands[0]
    for v, p in cands[1:]:
        better = (v < best) if want_min else (v > best)
        if better or (v == best and p < bp):
            best, bp = v, p
    return best, bp


def agg_partial_for(
    stage, pos: np.ndarray, agg: dict
) -> Any:
    """Wire-form partial aggregate over accepted positions: the
    ungrouped state list, or [group_key, state] pairs (grouped).
    Exactly equal to folding the same rows through query.agg_fold in
    position order."""
    op = agg["op"]
    group = agg["group"]
    if group:
        # Grouped: fold per row (bounded by the page), columnar
        # typed extraction — group keys come from the key matrix.
        out: dict = {}
        col = (
            None
            if op == "count"
            else field_column(stage, agg["field"])
        )
        for p in pos.tolist():
            x = None if col is None else col.typed_at(p)
            if not Q.contributes(op, x):
                continue
            k = stage.key_at(p)[:group]
            st = out.get(k)
            if st is None:
                if len(out) >= Q.MAX_GROUPS:
                    from ..errors import BadFieldType

                    raise BadFieldType(
                        "spec: aggregate group cardinality too high"
                    )
                st = out[k] = Q.agg_new()
            Q.agg_fold(st, op, None if op == "count" else x)
        return [[k, st] for k, st in sorted(out.items())]

    state = Q.agg_new()
    if op == "count":
        state[0] = int(pos.size)
        return state
    col = field_column(stage, agg["field"])
    ipos = pos[col.is_int[pos]]
    fpos = pos[col.is_float[pos]]
    fix_num = [
        (p, col.fixvals[p])
        for p in pos.tolist()
        if col.fix[p] and isinstance(col.fixvals.get(p), int)
    ]
    state[0] = int(ipos.size + fpos.size) + len(fix_num)
    if op in ("sum", "avg"):
        state[1] = _exact_int_sum(col.i64[ipos]) + sum(
            x for _p, x in fix_num
        )
        for v in col.f64[fpos].tolist():
            Q.grow_partials(state[2], v)
    mn = _lane_extreme(col, pos, True)
    mx = _lane_extreme(col, pos, False)
    state[3] = None if mn is None else mn[0]
    state[4] = None if mx is None else mx[0]
    return state
